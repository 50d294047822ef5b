"""Quadratic SRP family: SimHash over the implicit expansion T(v)=vec(v vᵀ).

Collision probability is monotonic in (v·q)², matching the |⟨q, x⟩| of
the paper's optimal weight exactly.  A projection on T(v) is the
quadratic form vᵀ M v, so ``proj_kind = "quadratic"`` draws per-function
(d, d) matrices and hashing stays plain PyTorch (no single-matmul
structure for the fused simhash kernel).

    cos(T(x), T(q)) = (x·q)² / (‖x‖² ‖q‖²),   cp = 1 - arccos(cos)/π
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .base import LSHFamily


def quadratic_collision_prob(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Collision prob. of QuadraticSRP = SimHash cp between T(x), T(q)."""
    xn2 = torch.sum(x * x, dim=-1)
    qn2 = torch.sum(q * q, dim=-1)
    ip = torch.sum(x * q, dim=-1)
    cos = ip * ip / torch.clamp(xn2 * qn2, min=1e-30)
    cos = torch.clamp(cos, -1.0, 1.0)
    return 1.0 - torch.arccos(cos) / math.pi


@dataclasses.dataclass(frozen=True)
class QuadraticSRPFamily(LSHFamily):
    """Symmetric quadratic SRP: identity augmentation, (v·q)² law."""

    name: str = "quadratic"
    proj_kind: str = "quadratic"
    asymmetric: bool = False
    cp_law: str = "quadratic"

    def collision_prob(self, x_aug, q_aug):
        return quadratic_collision_prob(x_aug, q_aug)
