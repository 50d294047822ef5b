"""Build the CUDA sources in ``repro_torch/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library.  The first call of
``library`` builds every source at once — one ``nvcc`` process per
source, all started together — into ``build/kernels/<hash>/`` at the
root of the checkout, where ``<hash>`` covers the sources and the
flags, so an edited source builds anew and an unchanged one is reused.
A source built with extra ``-D`` flags (a compile-time variant, such as
the probe's mask slots) goes into a directory of its own.  Nothing is
built when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("simhash", "bucket_probe", "flash_attention", "gather_weight")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _build_dir(defines: tuple = ()) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh", ".h"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all(names: tuple = SOURCES, defines: tuple = ()) -> dict:
    """Compile every missing library of ``names`` in parallel, with the
    extra ``-D`` flags ``defines`` (a build directory of their own);
    return name -> path."""
    out = _build_dir(defines)
    out.mkdir(parents=True, exist_ok=True)
    paths = {name: out / f"lib{name}.so" for name in names}
    todo = [n for n in names if not paths[n].exists()]
    nvcc = _nvcc() if todo else None
    procs = {}
    for name in todo:
        tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
        log = open(out / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *defines, "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}\n"
                          f"{(out / f'{name}.log').read_text()}")
            continue
        os.replace(tmp, paths[name])   # atomic: readers see whole files
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """The compiler's output (registers, spills) of the last build."""
    path = _build_dir() / f"{name}.log"
    return path.read_text() if path.exists() else ""


def ptxas_usage(log: str) -> dict:
    """Per kernel, what ``nvcc -Xptxas -v`` reported in ``log``: mangled
    name -> registers, spill_stores, spill_loads, stack and static smem
    bytes (dynamic shared memory is set at launch and not in the log)."""
    out: dict = {}
    name = None
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '([^']+)'", line)
        if hit:
            name = hit.group(1)
            out[name] = {"registers": None, "spill_stores": 0,
                         "spill_loads": 0, "stack": 0, "smem": 0}
            continue
        if name is None:
            continue
        for key, pat in (("stack", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("registers", r"Used (\d+) registers"),
                         ("smem", r"(\d+) bytes smem")):
            hit = re.search(pat, line)
            if hit:
                out[name][key] = int(hit.group(1))
    return out


def library(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built on first use:
    with every other source, or alone when built with ``defines`` (a
    variant measured against the default)."""
    key = (name, defines)
    if key not in _libs:
        path = build_all((name,) if defines else SOURCES, defines)[name]
        _libs[key] = ctypes.CDLL(str(path))
    return _libs[key]
