"""Hand-written Hopper kernels and their dispatch.

Each kernel package (``simhash``, ``bucket_probe``, ``flash_attention``,
``gather_weight``) is a triple:

  * ``kernel.py`` — the ctypes wrapper around the CUDA C++ entry point in
    ``repro_torch/csrc/``: checks device, dtype, shape and contiguity,
    launches on the current stream, raises on a CUDA error and counts
    the launch in ``launches``;
  * ``ref.py``    — the plain PyTorch version of the same function;
  * ``ops.py``    — the public function: a CUDA tensor goes to the
    kernel (which launches or raises — there is no fallback), a CPU
    tensor goes to the plain version.

Dispatch is by the tensor's device, the counterpart of the JAX
package's ``default_use_pallas()`` backend check.

Under a mesh an entry may receive DTensors.  No DTensor reaches a
kernel's ``data_ptr``: the entry first maps them to local tensors with
the placements its work needs (``repro_torch.dist.sharding``:
``local_map`` for attention, local per batch row and head;
``replicated_call`` for the LGD kernels, whose store and index are
replicated mesh-wide), runs on those, and returns DTensors.  On a CUDA
DTensor the kernel runs, or the call raises; ``on_cuda`` itself refuses
a DTensor.

One kernel has no ``ops.py`` entry of its own: ``draw_assemble``
(``gather_weight/kernel.py``), Algorithm 1 after the probe plus the
gather, whose plain version is the sampler's own composition; its
dispatch is ``core.sampler.draw_assemble``.
"""

from __future__ import annotations

import functools
import os

import torch

# Launch counts of the hand-written kernels, one per wrapper.  A wrapper
# adds one where it launches its kernel and nowhere else, so a run can
# show that its main path went through every kernel.
launches = {
    "simhash": 0,
    "bucket_probe": 0,
    "bucket_probe_multi": 0,
    "bucket_probe_codes": 0,
    "flash_attention": 0,
    "flash_decode": 0,
    "gather_weight": 0,
    "draw_assemble": 0,
}


# the arrival counts of kernels whose blocks meet (the probe's and
# flash_decode's last block, simhash's row tiles) per (device, stream): 0
# between launches
_arrived: dict = {}


def arrival_counts(device: torch.device, stream: int,
                   rows: int) -> torch.Tensor:
    """Zeroed int32 counts, kept per (device, stream), for a kernel whose
    blocks count their arrivals (the last one to arrive finishes the work,
    or all wait for the count): each launch leaves them at 0, so one fill
    serves every later call on that stream, whichever kernel made it
    (launches on one stream run one after another)."""
    key = (device.index, stream)
    buf = _arrived.get(key)
    if buf is None or buf.numel() < rows:
        buf = torch.zeros(rows, dtype=torch.int32, device=device)
        _arrived[key] = buf
    return buf


@functools.cache
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index`` (read once)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def round_up(a: int, b: int) -> int:
    """Round ``a`` up to the next multiple of ``b`` (block padding)."""
    return (a + b - 1) // b * b


def is_dtensor(t) -> bool:
    """True for a ``torch.distributed.tensor.DTensor``."""
    if type(t) is torch.Tensor or not isinstance(t, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def any_dtensor(*ts) -> bool:
    return any(is_dtensor(t) for t in ts)


def on_cuda(t: torch.Tensor) -> bool:
    """True when ``t`` takes the kernel path; False for the plain path.

    Only a CPU tensor takes the plain version.  Any other device raises,
    so no tensor silently leaves the kernel path, and so does a DTensor:
    an entry maps DTensors to local tensors before it dispatches."""
    if is_dtensor(t):
        raise TypeError(
            "a DTensor reached a kernel dispatch: the entry must map it to "
            "its local tensor first (repro_torch.dist.sharding.local_map "
            "or replicated_call)")
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}: use cuda or cpu")


def check_tensor(t: torch.Tensor, name: str, dtype, ndim: int,
                 device=None) -> None:
    """A kernel wrapper's input check: a contiguous CUDA tensor of the
    given dtype and rank (on ``device`` when given)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# what torchrun sets in each process it starts
JOB_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def in_job() -> bool:
    """True in a process that ``torchrun`` started (its environment holds
    ``JOB_ENV``); the one test of a job for the device and the group."""
    return all(k in os.environ for k in JOB_ENV)


def card_for(rank: int) -> int:
    """The card of process ``rank`` on this host: its own card when the
    host has one for it, else ``rank % device_count()`` (processes share
    the cards)."""
    return rank % torch.cuda.device_count()


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU, and an error (never a silent CPU run) when no card exists.

    A bare ``"cuda"`` is the process's own card: ``cuda:LOCAL_RANK``
    inside a ``torchrun`` job (``in_job``, ``card_for``), ``cuda:0``
    outside one, whatever ``LOCAL_RANK`` alone says."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", card_for(
            int(os.environ["LOCAL_RANK"])) if in_job() else 0)
    return dev


def require_full_fp32() -> None:
    """Turn TF32 off for matmuls and convolutions, and check that it is off.

    TF32 keeps ~10 mantissa bits: a TF32 projection flips the sign of
    near-zero projections and breaks code parity with the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        raise RuntimeError("TF32 must stay off for SimHash code parity")
