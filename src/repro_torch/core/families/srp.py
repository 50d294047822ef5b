"""Signed-random-projection (SimHash) family — the paper's workhorse.

    cp(x, q) = 1 - arccos(cos_sim(x, q)) / pi

``"dense"`` (Gaussian projections) and ``"sparse"`` (very-sparse
Rademacher projections) share this class; they differ only in the
projection tensor ``core.simhash.make_projections`` draws.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .base import LSHFamily, normalize_rows


def srp_collision_prob(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """SimHash collision probability cp(x,q) = 1 - arccos(cos)/pi.

    x: (..., d), q: (d,) or broadcastable.  Computed in float32."""
    xn = torch.linalg.vector_norm(x, dim=-1)
    qn = torch.linalg.vector_norm(q, dim=-1)
    cos = torch.sum(x * q, dim=-1) / torch.clamp(xn * qn, min=1e-30)
    cos = torch.clamp(cos, -1.0, 1.0)
    return 1.0 - torch.arccos(cos) / math.pi


@dataclasses.dataclass(frozen=True)
class SignedRPFamily(LSHFamily):
    """Symmetric SRP: identity augmentation, cosine collision law; the
    query is L2-normalised (cp is scale-invariant)."""

    name: str = "dense"
    proj_kind: str = "dense"
    asymmetric: bool = False
    cp_law: str = "angle"

    def augment_query(self, q: torch.Tensor) -> torch.Tensor:
        return normalize_rows(q)

    def collision_prob(self, x_aug, q_aug):
        return srp_collision_prob(x_aug, q_aug)
