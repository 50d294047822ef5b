"""The port imports neither JAX nor the JAX package.

Every module under src/repro_torch/ and chip_smoke.py is parsed with
``ast``; any ``import jax...`` / ``from jax... import`` / ``import
repro...`` / ``from repro... import`` fails the test (``repro_torch``
itself excepted), wherever it stands: at top level, inside a function,
or under a condition.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
FORBIDDEN = ("jax", "repro")


def _files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        out += [os.path.join(dirpath, f) for f in names if f.endswith(".py")]
    return sorted(out)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_the_port_has_modules():
    files = _files()
    assert len(files) > 20
    assert os.path.join(PORT, "models", "lm.py") in files


@pytest.mark.parametrize("path", _files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import(path):
    bad = [f"{os.path.relpath(path, ROOT)}:{line}: {mod}"
           for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, "the port imports JAX or the JAX package:\n" + "\n".join(
        bad)


@pytest.mark.parametrize("src,bad", [
    ("import jax.numpy as jnp", True),
    ("from jax import lax", True),
    ("def f():\n    from repro.core import sample", True),
    ("import repro", True),
    ("import repro_torch.kernels", False),
    ("from repro_torch.models import LM", False),
    ("from . import ops", False),
    ("import jaxtyping", False),
])
def test_checker_catches_imports(tmp_path, src, bad):
    path = tmp_path / "m.py"
    path.write_text(src)
    assert any(_forbidden(m) for _, m in _imports(str(path))) is bad
