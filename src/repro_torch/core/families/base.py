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
* ``aug_dim(d)``, ``proj_kind`` ("dense" | "sparse" | "quadratic") and
  ``asymmetric``.

The norm-ranging hooks of the banded family (``num_bands``,
``code_tags``, ``mask_projections``) come with that family's port.
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


def normalize_rows(v: torch.Tensor) -> torch.Tensor:
    """Row-L2 normalisation with the stack-wide 1e-30 guard."""
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-30)
