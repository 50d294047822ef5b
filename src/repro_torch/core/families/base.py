"""The LSH-family contract (PyTorch port of ``repro.core.families.base``).

Algorithm 1 needs ONE thing from its hash family: an exact closed-form
collision probability that is monotonic in the quantity the sampler
should favour.  The rest — augmentation of stored vectors and queries,
the per-probe-class probabilities of multi-probe querying, the packed
code width — is family detail the rest of the stack must not hard-wire.

The contract (all methods are functions of tensors; family objects are
frozen dataclass singletons):

* ``augment_data(x, scale=None)`` — raw stored vectors (N, d) to the
  vectors actually hashed (N, aug_dim(d)); ``scale`` pins a
  data-dependent normaliser (MIPS: the max row norm).
* ``data_scale(x)`` — the scale ``augment_data`` would derive from x.
* ``augment_query(q)`` — raw query (..., d) to the hashed query.
* ``collision_prob(x_aug, q_aug)`` — the exact per-hash collision
  probability on augmented vectors.
* ``probe_class_probs(cp, k, rs)`` — q_r = cp^(K-r) (1-cp)^r, the
  probability that a point lands in the bucket of a weight-r XOR mask.
* ``code_width(k)`` — packed bits per table code.
* ``cp_law`` — the name of the collision law ``collision_prob``
  computes, for kernels that evaluate it themselves (``draw_assemble``
  knows "angle" and "quadratic"); empty for a law no kernel knows.
  ``law_dim(aug_d)`` — how many leading coordinates of an augmented
  vector that law reads (all of them but a banded family's band id).
* ``num_bands()`` / ``code_tags(x_aug, k)`` / ``mask_projections(p)``
  — the multi-index (norm-ranging) hooks.  A banded family partitions
  the corpus into ``num_bands()`` sub-indexes that share ONE sorted-code
  index: ``code_tags`` returns per-row high-bit tags ORed into the
  packed codes at hash time (each band a contiguous slice of every
  table) and ``mask_projections`` zeroes the projection rows of
  coordinates that carry index layout rather than geometry.  Flat
  families return 1 / ``None`` / the projections unchanged, so they
  stay bitwise as they were.
* ``aug_dim(d)``, ``proj_kind`` ("dense" | "sparse" | "quadratic") and
  ``asymmetric``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LSHFamily:
    """Base contract; concrete families override the augment/cp methods."""

    name: str = "base"
    proj_kind: str = "dense"     # "dense" | "sparse" | "quadratic"
    asymmetric: bool = False
    cp_law: str = ""             # "angle" | "quadratic" | "" (no kernel)

    def augment_data(self, x: torch.Tensor, scale=None) -> torch.Tensor:
        """Raw stored vectors -> hashed vectors (identity by default)."""
        del scale
        return x

    def data_scale(self, x: torch.Tensor):
        """The scale ``augment_data`` derives from ``x`` (None = stateless)."""
        del x
        return None

    def augment_query(self, q: torch.Tensor) -> torch.Tensor:
        """Raw query -> hashed query (identity by default)."""
        return q

    def aug_dim(self, d: int) -> int:
        """Dimensionality of augmented vectors given raw dimension d."""
        return d

    def collision_prob(self, x_aug: torch.Tensor,
                       q_aug: torch.Tensor) -> torch.Tensor:
        """Exact per-hash collision probability on augmented vectors."""
        raise NotImplementedError

    def probe_class_probs(self, cp: torch.Tensor, k: int,
                          rs: torch.Tensor) -> torch.Tensor:
        """q_r = cp^(K-r) (1-cp)^r for mask popcounts ``rs`` (float tensor).

        Exact for i.i.d. per-bit collisions — every SRP-derived family."""
        return cp ** (k - rs) * (1.0 - cp) ** rs

    def code_width(self, k: int) -> int:
        """Packed bits per table code (k sign bits for SRP families)."""
        return k

    def law_dim(self, aug_d: int) -> int:
        """Leading coordinates of an augmented vector the law reads."""
        return aug_d

    def num_bands(self) -> int:
        """Number of norm bands (1 = flat family, no band routing)."""
        return 1

    def code_tags(self, x_aug: torch.Tensor, k: int):
        """Per-row int64 high-bit tags ORed into packed codes at hash
        time (``None`` = untagged; banded families return band << k)."""
        del x_aug, k
        return None

    def mask_projections(self, proj: torch.Tensor) -> torch.Tensor:
        """Post-draw projection adjustment (identity for flat families;
        banded families zero the band coordinate's row)."""
        return proj


def normalize_rows(v: torch.Tensor) -> torch.Tensor:
    """Row-L2 normalisation with the stack-wide 1e-30 guard."""
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-30)
