"""SimHash parameters, projections, packed codes and probe masks.

PyTorch port of ``repro.core.simhash``.  ``LSHParams.family`` names a
registry entry of ``core.families``; this module draws the matching
projection tensor and packs codes.

Codes are held as int64 in [0, 2^32): PyTorch has no uint32
``searchsorted``, ``<`` or ``<<`` on the CPU, and int64 keeps the
``EMPTY_CODE`` sentinel (0xFFFFFFFF) sorting after every live code
without the biasing trick of the TPU kernels.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import require_full_fp32, resolve_device
from repro_torch.kernels.simhash.ref import pack_bits

from .families import (  # noqa: F401  (re-exported, as in the JAX package)
    get_family,
    quadratic_collision_prob as collision_probability_quadratic,
    srp_collision_prob as collision_probability,
)

MAX_K = 32  # sign bits packed per code

# Elements of the (rows, H, d) intermediate of one quadratic-hash chunk:
# 2^26 floats = 256 MiB.
_QUADRATIC_CHUNK_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class LSHParams:
    """Static hyper-parameters of the hash family."""

    k: int = 5          # bits (hash fns) per table    (paper: K=5 linear)
    l: int = 100        # number of hash tables        (paper: L=100 linear)
    dim: int = 0        # input dimensionality (of the *augmented* vector)
    family: str = "sparse"  # registry key: core.families.get_family
    sparsity: float = 1.0 / 30.0  # density of sparse projections

    def __post_init__(self):
        fam = get_family(self.family)   # raises on unknown family names
        if not (1 <= fam.code_width(self.k) <= MAX_K):
            raise ValueError(
                f"code width must be in [1,{MAX_K}], got "
                f"{fam.code_width(self.k)} (K={self.k})")
        if self.l < 1:
            raise ValueError(f"L must be >= 1, got {self.l}")


def make_projections(generator: torch.Generator, params: LSHParams,
                     device="cuda") -> torch.Tensor:
    """Draw the random projection tensor for the family.

    Returns (by the family's ``proj_kind``)
      dense/sparse:  (dim, L*K) float32
      quadratic:     (L*K, dim, dim) float32  (random M per hash function)

    ``generator`` must live on ``device``.  Torch's Philox stream is not
    JAX's threefry, so the draw matches the reference in distribution,
    not in bits.
    """
    device = resolve_device(device)
    fam = get_family(params.family)
    d, lk = params.dim, params.l * params.k
    if fam.proj_kind == "dense":
        # identity for flat families; the banded family zeroes the band
        # coordinate's row
        return fam.mask_projections(
            torch.randn((d, lk), generator=generator, device=device))
    if fam.proj_kind == "sparse":
        signs = torch.randint(0, 2, (d, lk), generator=generator,
                              device=device).to(torch.float32) * 2.0 - 1.0
        mask = torch.rand((d, lk), generator=generator,
                          device=device) < params.sparsity
        # Li et al. very-sparse projections: scale keeps inner products unbiased.
        return signs * mask / params.sparsity ** 0.5
    # quadratic: dense iid Gaussian M_h; hash = sign(v^T M v).
    return torch.randn((lk, d, d), generator=generator, device=device)


def quadratic_forms(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """proj[n, h] = x_n^T M_h x_n, chunked over rows.

    A one-shot einsum would contract x with M first into an (N, H, d)
    intermediate (84 GB at N = 463,715, H = 500, d = 91); chunks bound
    it by ``_QUADRATIC_CHUNK_ELEMS``."""
    h, d, _ = m.shape
    # a transposed VIEW of M, flat[e, h*d+a] = M[h,a,e]: the matmul takes
    # it as is, so no call copies the (H, d, d) tensor
    flat = m.reshape(h * d, d).T
    rows = max(1, _QUADRATIC_CHUNK_ELEMS // (h * d))
    out = torch.empty((x.shape[0], h), dtype=torch.float32, device=x.device)
    for s in range(0, x.shape[0], rows):
        xc = x[s:s + rows]
        t = (xc @ flat).view(-1, h, d)              # t[n,h,a] = (M_h x_n)_a
        out[s:s + rows] = torch.bmm(t, xc[:, :, None])[..., 0]
    return out


def compute_codes(x: torch.Tensor, projections: torch.Tensor, *, k: int,
                  l: int, quadratic: bool = False) -> torch.Tensor:
    """Hash a batch of vectors into packed per-table codes (plain PyTorch).

    x: (n, d) or (d,).  Returns (n, L) or (L,) int64.
    """
    require_full_fp32()
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    x = x.to(torch.float32)
    if quadratic:
        proj = quadratic_forms(x, projections)
    else:
        proj = x @ projections                      # (n, L*K)
    codes = pack_bits((proj >= 0).reshape(x.shape[0], l, k), k)
    return codes[0] if squeeze else codes


def probe_masks(k: int, n_codes: int) -> tuple:
    """Deterministic Hamming-ball probe sequence for multi-probe querying.

    ``n_codes`` XOR masks over the packed K-bit code: the exact bucket
    (mask 0), then all flip-1 masks (ascending bit), then all flip-2
    masks (lexicographic bit pairs); clamped to the radius-2 ball size
    ``1 + K + K(K-1)/2``.
    """
    if n_codes < 1:
        raise ValueError(f"n_codes must be >= 1, got {n_codes}")
    masks = [0]
    masks.extend(1 << i for i in range(k))
    masks.extend(
        (1 << i) | (1 << j) for i in range(k) for j in range(i + 1, k))
    return tuple(masks[:n_codes])


def augment_regression(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[x_i, y_i] augmentation for least squares (Eq. 4), L2-normalised rows."""
    v = torch.cat([x, y[..., None]], dim=-1)
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-30)


def regression_query(theta: torch.Tensor) -> torch.Tensor:
    """Query vector [theta, -1] for least squares."""
    return torch.cat([theta, -torch.ones_like(theta[..., :1])], dim=-1)


def augment_logistic(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y_i * x_i augmentation for logistic regression (Sec. 2.3), normalised."""
    v = x * y[..., None]
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-30)


def logistic_query(theta: torch.Tensor) -> torch.Tensor:
    """Query -theta for logistic regression (Eq. 20)."""
    return -theta

