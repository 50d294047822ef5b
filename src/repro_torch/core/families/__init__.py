"""Pluggable LSH families: registry + the contract (see ``base``).

Registered families:

  ``dense``      symmetric SRP, dense Gaussian projections
  ``sparse``     symmetric SRP, very-sparse Rademacher projections
  ``srp``        alias of ``dense`` (the user-facing CLI name)
  ``quadratic``  SRP over the implicit quadratic expansion T(v)
  ``mips``       asymmetric Simple-LSH MIPS (un-normalised corpora)

``mips_banded`` (norm-ranged MIPS) is not ported yet: ``get_family``
names the ROADMAP queue it waits in.
"""

from __future__ import annotations

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
}

NOT_PORTED = ("mips_banded",)


def get_family(name: str) -> LSHFamily:
    """Resolve a registry key to its family singleton."""
    try:
        return FAMILIES[name]
    except KeyError:
        if name in NOT_PORTED:
            raise ValueError(
                f"LSH family {name!r} is not ported to PyTorch yet; it is "
                "ROADMAP.md queue 1, item 2 (banded family)"
            ) from None
        raise ValueError(
            f"unknown LSH family {name!r}; registered: "
            f"{sorted(FAMILIES)}") from None
