"""Pluggable LSH families: registry + the contract (see ``base``).

Registered families:

  ``dense``      symmetric SRP, dense Gaussian projections
  ``sparse``     symmetric SRP, very-sparse Rademacher projections
  ``srp``        alias of ``dense`` (the user-facing CLI name)
  ``quadratic``  SRP over the implicit quadratic expansion T(v)
  ``mips``       asymmetric Simple-LSH MIPS (un-normalised corpora)
  ``mips_banded`` norm-ranged MIPS: banded sub-indexes with per-band
                 scales M_j (heavy-tailed norm distributions)
"""

from __future__ import annotations

from .banded import BandedScale, NormRangedMIPSFamily  # noqa: F401
from .base import LSHFamily, normalize_rows  # noqa: F401
from .mips import SimpleLSHMIPSFamily
from .quadratic import QuadraticSRPFamily, quadratic_collision_prob  # noqa: F401
from .srp import SignedRPFamily, srp_collision_prob  # noqa: F401

_DENSE = SignedRPFamily(name="dense", proj_kind="dense")
_SPARSE = SignedRPFamily(name="sparse", proj_kind="sparse")

FAMILIES = {
    "dense": _DENSE,
    "sparse": _SPARSE,
    "srp": _DENSE,            # CLI-facing alias
    "quadratic": QuadraticSRPFamily(),
    "mips": SimpleLSHMIPSFamily(),
    "mips_banded": NormRangedMIPSFamily(),
}


def get_family(name: str) -> LSHFamily:
    """Resolve a registry key to its family singleton."""
    try:
        return FAMILIES[name]
    except KeyError:
        raise ValueError(
            f"unknown LSH family {name!r}; registered: "
            f"{sorted(FAMILIES)}") from None


def family_names() -> tuple:
    return tuple(sorted(FAMILIES))
