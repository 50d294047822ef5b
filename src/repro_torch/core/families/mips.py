"""Asymmetric MIPS family: Simple-LSH augmentation + SRP (Neyshabur & Srebro).

    data:   S(x) = [x / M,  √(1 − ‖x/M‖²)]      M = max_i ‖x_i‖
    query:  Q(q) = [q / ‖q‖,  0]

⟨S(x), Q(q)⟩ = ⟨x, q⟩ / (M ‖q‖), so the SRP collision probability on the
augmented pair is exact AND monotone in the raw inner product: corpora
need no row normalisation.  ``data_scale`` captures M so partial
re-augmentations can replay it (``augment_data(x, scale=M)``).
"""

from __future__ import annotations

import dataclasses

import torch

from .base import LSHFamily, normalize_rows
from .srp import srp_collision_prob


@dataclasses.dataclass(frozen=True)
class SimpleLSHMIPSFamily(LSHFamily):
    """Asymmetric Simple-LSH MIPS: [x/M, √(1−‖x/M‖²)] vs [q/‖q‖, 0]."""

    name: str = "mips"
    proj_kind: str = "dense"
    asymmetric: bool = True
    cp_law: str = "angle"

    def data_scale(self, x: torch.Tensor):
        """M = max row norm (guarded): the augmentation's normaliser."""
        return torch.clamp(torch.linalg.vector_norm(x, dim=-1).max(),
                           min=1e-30)

    def augment_data(self, x: torch.Tensor, scale=None) -> torch.Tensor:
        scale = self.data_scale(x) if scale is None else scale
        xs = x / scale
        sq = torch.sum(xs * xs, dim=-1, keepdim=True)
        tail = torch.sqrt(torch.clamp(1.0 - sq, min=0.0))
        return torch.cat([xs, tail], dim=-1)

    def augment_query(self, q: torch.Tensor) -> torch.Tensor:
        qn = normalize_rows(q)
        return torch.cat([qn, torch.zeros_like(qn[..., :1])], dim=-1)

    def aug_dim(self, d: int) -> int:
        return d + 1

    def collision_prob(self, x_aug, q_aug):
        return srp_collision_prob(x_aug, q_aug)
