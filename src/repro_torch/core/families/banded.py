"""Norm-ranged MIPS family: banded Simple-LSH sub-indexes (Yan et al.).

PyTorch port of ``repro.core.families.banded``.  One global Simple-LSH
scale M = max_i ||x_i|| lets a single outlier of a heavy-tailed norm
distribution push every bulk row toward the augmentation pole, and the
1/(p·N) weights break.  Norm-ranging splits the corpus into ``n_bands``
bands at norm quantiles and runs Simple-LSH per band with the band's
own scale M_j = max { ||x_i|| : i in band j }.

The band id rides in the HIGH bits of every table code,

    code'(x) = (band(x) << K) | srp_code(S_j(x))          (K sign bits)

so each band is a contiguous region of every table's sorted order
(``tables.band_starts``), buckets never mix bands, and the hashing and
probe kernels run unchanged.  The augmented vector carries the band id
as a last coordinate whose projection row is zeroed
(``mask_projections``); ``code_tags`` reads it back at hash time.

A draw picks a band with probability n_j / n_live, then runs
Algorithm 1 inside it:

    p = (n_j / n_live) * q_r * (1 - Q)^(l-1) / |S_b|

with q_r at the band's scale: the angle law normalises internally, so
the collision probability is exact on the band-augmented pair.

``data_scale`` returns a ``BandedScale`` (quantile boundaries and the
band maxima), a NamedTuple of two tensors that the pipeline pins and
replays like the plain family's scalar M.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .base import normalize_rows
from .mips import SimpleLSHMIPSFamily
from .srp import srp_collision_prob


class BandedScale(NamedTuple):
    """Pinned norm-ranging state.

    boundaries: (n_bands - 1,) ascending norm quantile edges; a row whose
      norm equals ``boundaries[j]`` belongs to band j + 1 (the upper
      band: ``searchsorted(right=True)``).
    scales: (n_bands,) per-band maxima M_j (1e-30 guarded; an empty band
      carries the guard).
    """

    boundaries: torch.Tensor
    scales: torch.Tensor


@dataclasses.dataclass(frozen=True)
class NormRangedMIPSFamily(SimpleLSHMIPSFamily):
    """Banded Simple-LSH MIPS: per-band scales M_j + band-tagged codes."""

    name: str = "mips_banded"
    n_bands: int = 8

    def num_bands(self) -> int:
        return self.n_bands

    def band_bits(self) -> int:
        return (self.n_bands - 1).bit_length()

    def code_width(self, k: int) -> int:
        # the band tag occupies the bits above the K sign bits
        return k + self.band_bits()

    def aug_dim(self, d: int) -> int:
        return d + 2                     # Simple-LSH tail + band coordinate

    def law_dim(self, aug_d: int) -> int:
        return aug_d - 1                 # the band coordinate is layout

    def band_of_norms(self, norms: torch.Tensor,
                      boundaries: torch.Tensor) -> torch.Tensor:
        """Band id per norm under the pinned boundaries (tie -> upper)."""
        return torch.searchsorted(boundaries, norms.contiguous(),
                                  right=True).to(torch.int32)

    def data_scale(self, x: torch.Tensor) -> BandedScale:
        """Quantile boundaries over live (positive-norm) rows + band maxima.

        Dead rows (zeroed by the streaming pipeline before the scale is
        derived) have norm 0 and are left out of the quantiles."""
        if x.dim() != 2:
            raise ValueError(
                f"banded data_scale expects a (N, d) corpus, got "
                f"{tuple(x.shape)}")
        nb = self.n_bands
        norms = torch.linalg.vector_norm(x, dim=-1)              # (N,)
        live = norms > 1e-30
        n_live = live.sum()
        sorted_norms = torch.sort(torch.where(
            live, norms, torch.full_like(norms, float("inf")))).values
        js = torch.arange(1, nb, dtype=torch.int64, device=x.device)
        pos = torch.clamp((n_live * js) // nb, 0, norms.shape[0] - 1)
        boundaries = sorted_norms[pos]
        # all-dead corpus: no live norm to split on, every row joins the
        # top band
        boundaries = torch.where(torch.isfinite(boundaries), boundaries,
                                 torch.zeros_like(boundaries))
        bands = self.band_of_norms(norms, boundaries).to(torch.int64)
        scales = torch.full((nb,), 1e-30, dtype=norms.dtype,
                            device=x.device).scatter_reduce(
            0, bands, torch.where(live, norms, torch.zeros_like(norms)),
            "amax")
        return BandedScale(boundaries=boundaries,
                           scales=torch.clamp(scales, min=1e-30))

    def augment_data(self, x: torch.Tensor,
                     scale: Optional[BandedScale] = None) -> torch.Tensor:
        """[x/M_band, sqrt(1 - ||x/M_band||^2), band] per row."""
        scale = self.data_scale(x) if scale is None else scale
        norms = torch.linalg.vector_norm(x, dim=-1)
        bands = self.band_of_norms(norms, scale.boundaries)
        m = scale.scales[bands.to(torch.int64)]
        xs = x / m[..., None]
        sq = torch.sum(xs * xs, dim=-1, keepdim=True)
        tail = torch.sqrt(torch.clamp(1.0 - sq, min=0.0))
        return torch.cat([xs, tail, bands[..., None].to(x.dtype)], dim=-1)

    def augment_query(self, q: torch.Tensor) -> torch.Tensor:
        qn = normalize_rows(q)
        return torch.cat([qn, torch.zeros_like(qn[..., :2])], dim=-1)

    def code_tags(self, x_aug: torch.Tensor, k: int) -> torch.Tensor:
        """(N,) int64 high-bit band tags ORed into the packed codes."""
        return torch.round(x_aug[..., -1]).to(torch.int64) << k

    def mask_projections(self, proj: torch.Tensor) -> torch.Tensor:
        """Zero the band coordinate's projection row: hashing sees only
        the Simple-LSH geometry; the band reaches the code through
        ``code_tags``."""
        proj = proj.clone()
        proj[-1, :] = 0.0
        return proj

    def collision_prob(self, x_aug, q_aug):
        # the angle law on the Simple-LSH part only (the band coordinate
        # is code layout, not geometry)
        return srp_collision_prob(x_aug[..., :-1], q_aug[..., :-1])
