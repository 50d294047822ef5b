"""ctypes wrappers of the CUDA flash-attention kernels (``csrc/flash_attention.cu``).

Replace the TPU kernels ``flash_attention_pallas`` and
``flash_decode_pallas`` (src/repro/kernels/flash_attention/kernel.py:92
and :184), with their contracts: causal (or full) GQA attention over
q (B, Hkv, G, S, D) and k/v (B, Hkv, S, D), and one query per head
against a KV cache masked by ``kv_len``.  f32 or bf16 in, f32 sums
inside, the input type out; in bf16 both run on the tensor cores
(mma.sync) and carry P as two bf16 parts.  Prefill is bound by
operations.  Decode is bound by the bytes of the cache that ``kv_len``
makes valid (over 3.35 TB/s on an H100 SXM): it splits the cache along
S into chunks of whole 32-key tiles, sized here from S and the card's
SM count (``decode_chunk``), streams each chunk through a cp.async ring
in its input type, and the last block of a row to finish merges the
row's partials in the same launch.  ``kv_len`` stays on the card: the
host never waits for it.  The reasoning is at the top of the CUDA
source.

The wrappers take strided views: every tensor needs its last dimension
contiguous, its other strides a multiple of 16 bytes and a 16-byte
aligned base, so the model's (B, S, H, D) activations and its
(B, S_max, Hkv, D) cache go in as permuted views without a copy.  An
``out`` view, when given, is written in place.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import arrival_counts, launches, sm_count
from ..build import library

HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP_WIDTH = 2048   # decode: G * D per block
DECODE_TILE = 32         # decode: keys per cp.async stage (kDecTile)
DECODE_MAX_SPLITS = 64   # decode: splits of one row (kMaxSplits)
DECODE_BLOCKS_PER_SM = 2   # decode: blocks an SM when every row is full
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _fn(name: str):
    fn = getattr(library("flash_attention"), name)
    fn.argtypes = {
        "flash_attention_launch":
            [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
        "flash_decode_launch":
            [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
             _P],
        "flash_prefill_bf16_smem_bytes": [_I],
        "flash_decode_smem_bytes": [_I, _I, _I],
    }[name]
    fn.restype = ctypes.c_int
    return fn


def _check_view(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """A CUDA tensor of ``dtype`` and ``shape`` on ``device``, D contiguous,
    16-byte aligned base and row strides: the kernels' 16-byte loads and
    the bf16 prefill's cp.async copies (a bf16 stride is a multiple of 8
    elements).  Nothing falls back on a view that fails this."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    vec = 16 // t.element_size()
    if t.stride(-1) != 1 or any(st % vec for st in t.stride()[:-1]):
        raise ValueError(f"{name} needs a contiguous last dimension and "
                         f"16-byte row strides, got strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def _bf16_flag(q: torch.Tensor, d: int) -> int:
    """1 for bf16, 0 for f32 (the kernels' two types); checks D."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim D={d} must be one of {HEAD_DIMS}")
    return int(q.dtype == torch.bfloat16)


def _strides(*ts) -> ctypes.Array:
    flat = [st for t in ts for st in t.stride()[:-1]]
    return (ctypes.c_int64 * len(flat))(*flat)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, scale: float | None = None,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """(B, Hkv, G, S, D) attention of q (B, Hkv, G, S, D) over k/v
    (B, Hkv, S, D); written into ``out`` when given."""
    if q.dim() != 5:
        raise ValueError(f"q must be (B, Hkv, G, S, D), got {tuple(q.shape)}")
    b, hkv, g, s, d = q.shape
    is_bf16 = _bf16_flag(q, d)
    _check_view(q, "q", q.dtype, (b, hkv, g, s, d), q.device)
    _check_view(k, "k", q.dtype, (b, hkv, s, d), q.device)
    _check_view(v, "v", q.dtype, (b, hkv, s, d), q.device)
    if out is None:
        out = torch.empty((b, hkv, g, s, d), dtype=q.dtype, device=q.device)
    _check_view(out, "out", q.dtype, (b, hkv, g, s, d), q.device)
    if q.numel() == 0:
        return out
    scale = d ** -0.5 if scale is None else scale
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn("flash_attention_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _strides(q, k, v, out), b, hkv, g, s, d, is_bf16, scale, int(causal),
        stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err}")
    launches["flash_attention"] += 1
    return out


def prefill_bf16_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one bf16 (tensor-core) flash_attention
    block at head dim ``d``, from the CUDA source."""
    return _fn("flash_prefill_bf16_smem_bytes")(d)


def decode_chunk(s: int, rows: int, sms: int) -> int:
    """Keys per decode split for a cache of ``s`` positions and ``rows`` =
    B * Hkv: whole tiles, about DECODE_BLOCKS_PER_SM blocks per SM when
    every row is full, at most DECODE_MAX_SPLITS splits.  It depends on
    shapes alone, never on kv_len."""
    per = max(-(-s * rows // (DECODE_BLOCKS_PER_SM * sms)),
              -(-s // DECODE_MAX_SPLITS))
    return -(-per // DECODE_TILE) * DECODE_TILE


def decode_smem_bytes(g: int, d: int, bf16: bool) -> int:
    """Dynamic shared memory of one flash_decode block, from the CUDA
    source."""
    return _fn("flash_decode_smem_bytes")(g, d, int(bf16))


def flash_decode_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                      scale: float | None = None,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """(B, Hkv, G, D) attention of one query per head over the first
    ``kv_len[b]`` positions of the cache (B, Hkv, S, D); kv_len (B,)
    int32 on the same card."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, Hkv, G, D), got {tuple(q.shape)}")
    b, hkv, g, d = q.shape
    is_bf16 = _bf16_flag(q, d)
    if k_cache.dim() != 4:
        raise ValueError(f"k_cache must be (B, Hkv, S, D), got "
                         f"{tuple(k_cache.shape)}")
    s = k_cache.shape[2]
    if s == 0:
        raise ValueError("flash_decode needs a non-empty cache")
    if g * d > MAX_GROUP_WIDTH:
        raise ValueError(f"G*D={g * d} exceeds {MAX_GROUP_WIDTH}")
    _check_view(q, "q", q.dtype, (b, hkv, g, d), q.device)
    _check_view(k_cache, "k_cache", q.dtype, (b, hkv, s, d), q.device)
    _check_view(v_cache, "v_cache", q.dtype, (b, hkv, s, d), q.device)
    if not kv_len.is_cuda or kv_len.device != q.device:
        raise ValueError(f"kv_len must be on {q.device}, got {kv_len.device}")
    if kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (b,):
        raise ValueError(f"kv_len must be ({b},) int32, got "
                         f"{tuple(kv_len.shape)} {kv_len.dtype}")
    kv_len = kv_len.contiguous()
    if out is None:
        out = torch.empty((b, hkv, g, d), dtype=q.dtype, device=q.device)
    _check_view(out, "out", q.dtype, (b, hkv, g, d), q.device)
    if q.numel() == 0:
        return out
    scale = d ** -0.5 if scale is None else scale
    stream = torch.cuda.current_stream(q.device).cuda_stream
    chunk = decode_chunk(s, b * hkv, sm_count(q.device.index))
    n_split = -(-s // chunk)
    part = arrived = None
    if n_split > 1:
        part = torch.empty(b * hkv * n_split * g * (d + 2),
                           dtype=torch.float32, device=q.device)
        arrived = arrival_counts(q.device, stream, b * hkv)
    err = _fn("flash_decode_launch")(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        kv_len.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if arrived is None else arrived.data_ptr(),
        _strides(q, k_cache, v_cache, out), b, hkv, g, s, d, is_bf16, chunk,
        scale, stream)
    if err != 0:
        raise RuntimeError(
            f"flash_decode kernel launch failed: CUDA error {err}")
    launches["flash_decode"] += 1
    return out
