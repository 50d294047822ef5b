"""Shared layers: RMSNorm, RoPE, GQA attention (self-attention with a KV
cache, and cross-attention over a memory), the dense FFN, the
embedding, the LM head and the chunked LM loss.

The port of src/repro/models/layers.py, as ``nn.Module``s.  Parameters
keep the reference's names, shapes and dtypes (``wq`` (d, Hq, Dh),
``wo`` (Hq, Dh, d), norm scales in f32 whatever the model dtype), so
``repro_torch.convert`` maps a reference pytree across leaf for leaf.
Activations carry the reference's ``logical(...)`` annotations
(``repro_torch.dist.sharding.logical``) at the same places: no-ops
meshless; under ``use_mesh`` with DTensor parameters
(``dist.sharding.distribute_model``) they redistribute the activations
to the reference's placements.  The tensors a layer builds itself (RoPE
tables, positions, cache rows) meet DTensor operands as replicated
DTensors (``dist.sharding.replicate_like``).

The KV cache is a dict ``{"k", "v", "len"}`` per layer, with k/v
(B, S_max, Hkv, Dh) and len (B,) int32.  Unlike the reference, which
returns a new cache, the port updates the cache dict IN PLACE (new
keys and values written into its tensors, ``len`` replaced) and returns
it: a copy would cost 1.3 GB per layer stack at the phi4-mini serve
shapes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..dist.sharding import (from_batch_view, is_dtensor, kv_heads_like_q,
                             logical, merge_last, pinned_view,
                             replicate_like, to_batch_view, unflatten_last)
from ..kernels.flash_attention import gqa_attention, gqa_decode
from .attention_xla import chunked_gqa_attention
from .config import ModelConfig

ATTN_IMPLS = ("chunked", "ref", "pallas")


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


# elements above which ``normal_`` draws a parameter a slice at a time
NORMAL_SLICE = 1 << 30


@torch.no_grad()
def normal_(p: torch.Tensor, generator: torch.Generator, std: float) -> None:
    """The reference's init: a standard normal in f32, times ``std``,
    cast to the parameter's dtype.  A parameter of more than
    ``NORMAL_SLICE`` elements (an MoE layer's expert stack: 5.4 B at
    llama4's full width) is drawn a slice of its first dimension at a
    time, so its f32 draw never exists whole."""
    if p.numel() <= NORMAL_SLICE or p.dim() == 0:
        p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                            dtype=torch.float32).mul_(std))
        return
    step = max(1, NORMAL_SLICE // (p.numel() // p.shape[0]))
    for i in range(0, p.shape[0], step):
        part = p[i:i + step]
        part.copy_(torch.randn(part.shape, generator=generator,
                               device=p.device, dtype=torch.float32).mul_(std))


# ---------------------------------------------------------------------------
# norm
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 inside, the input's dtype out; ``scale`` stays f32."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, device):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d, device=device,
                                             dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale, self.eps)


# ---------------------------------------------------------------------------
# RoPE (half-split, f32 angles)
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, d: int, theta: float):
    """(cos, sin), each (B, S, 1, D/2) f32, for positions (B, S), or
    (1, S, 1, D/2) for positions (S,) (the same for every row).

    Every layer of a step rotates by the same positions, so a model
    computes the tables once per step and hands them to each layer."""
    half = d // 2
    freqs = replicate_like(
        theta ** (-torch.arange(0, half, dtype=torch.float32,
                                device=positions.device) / half), positions)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs                 # (B, S, half)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D) rotated by the tables of ``rope_tables``."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,)."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# self-attention with an optional KV cache
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        if cfg.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {cfg.attn_impl!r} is not one of "
                             f"{ATTN_IMPLS}")
        d, dh, hq, hkv = cfg.d_model, cfg.d_head, cfg.n_heads, cfg.n_kv_heads
        self.cfg = cfg
        self.norm = RMSNorm(d, cfg.norm_eps, device)
        self.wq = _param((d, hq, dh), device, dtype)
        self.wk = _param((d, hkv, dh), device, dtype)
        self.wv = _param((d, hkv, dh), device, dtype)
        self.wo = _param((hq, dh, d), device, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        std = self.cfg.d_model ** -0.5
        for w in (self.wq, self.wk, self.wv):
            normal_(w, generator, std)
        normal_(self.wo, generator, std * 0.5)

    def forward(self, x: torch.Tensor, rope_cs, cache: dict | None = None,
                *, kv: torch.Tensor | None = None, causal: bool = True):
        """x (B, S, d), rope_cs the step's ``rope_tables``.  Returns
        (x + attention, new cache or None).

        ``kv`` (B, S_mem, d): cross-attention over that memory (image
        patch embeddings): k and v are projected from it, unnormed and
        without RoPE, q is not rotated either, the attention is
        non-causal, and the cache is neither read nor written.  It takes
        the plain path on every device, as the reference chooses
        (src/repro/models/layers.py:101-103): the flash kernel needs
        S_q = S_kv.  ``causal=False`` without ``kv`` is full
        self-attention with RoPE on ``cfg.attn_impl``."""
        cfg = self.cfg
        b, s, d = x.shape
        hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        # one all-gather of the (seq-sharded) residual per attention
        # block, shared by the q/k/v projections
        h = logical(self.norm(x), "batch", None, None)
        src = h if kv is None else kv
        q = logical(unflatten_last(h @ pinned_view(self.wq, (d, hq * dh)),
                                   (hq, dh)), "batch", None, "heads", None)
        k = logical(unflatten_last(src @ pinned_view(self.wk, (d, hkv * dh)),
                                   (hkv, dh)), "batch", None, "heads", None)
        v = logical(unflatten_last(src @ pinned_view(self.wv, (d, hkv * dh)),
                                   (hkv, dh)), "batch", None, "heads", None)
        if kv is None:
            q, k = apply_rope(q, *rope_cs), apply_rope(k, *rope_cs)
            impl = cfg.attn_impl
        else:
            impl, cache, causal = "ref", None, False
        new_cache = None
        if cache is None or s > 1:
            # full sequence: training, or prefill writing the cache
            kq, vq = kv_heads_like_q(q, k), kv_heads_like_q(q, v)
            if impl == "chunked":
                out = chunked_gqa_attention(q, kq, vq, causal=causal,
                                            block_q=cfg.attn_block_q)
            else:
                out = gqa_attention(q, kq, vq, causal=causal,
                                    use_kernel=impl == "pallas")
            if cache is not None:
                write_prefix(cache["k"], k)
                write_prefix(cache["v"], v)
                cache["len"] = _like_batch(replicate_like(
                    torch.full((b,), s, dtype=torch.int32,
                               device=x.device), cache["k"]), cache["k"])
                new_cache = cache
        else:
            # one token: write it at each row's length, then attend over
            # len + 1 positions
            write_rows(cache["k"], cache["len"], k[:, 0])
            write_rows(cache["v"], cache["len"], v[:, 0])
            cache["len"] = cache["len"] + 1
            out = gqa_decode(q, cache["k"], cache["v"], cache["len"],
                             use_kernel=impl == "pallas")
            new_cache = cache
        out = logical(merge_last(out) @ pinned_view(self.wo, (hq * dh, d)),
                      "batch", None, None)
        return x + out, new_cache


def _like_batch(t: torch.Tensor, cache_t: torch.Tensor) -> torch.Tensor:
    """A (B,) tensor placed as the batch dim of the cache tensor
    ``cache_t`` (a no-op meshless)."""
    if not is_dtensor(cache_t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    want = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in cache_t.placements]
    return t.redistribute(cache_t.device_mesh, want)


def _local_window(cache_t: torch.Tensor, dim: int):
    """(the local tensor, [lo, hi) of dimension ``dim`` it holds) of a
    DTensor cache whose sharding splits ``dim`` evenly."""
    from torch.distributed.tensor import Shard
    coord = cache_t.device_mesh.get_coordinate()
    # the mesh dims that split ``dim`` do so in mesh order, outermost first
    lo, n = 0, cache_t.shape[dim]
    for i, p in enumerate(cache_t.placements):
        if isinstance(p, Shard) and p.dim == dim:
            size = cache_t.device_mesh.size(i)
            n //= size
            lo += coord[i] * n
    return cache_t.to_local(), lo, lo + n


def _value_on(value: torch.Tensor, cache_t: torch.Tensor) -> torch.Tensor:
    """``value`` (a DTensor) as this rank's local tensor, with its batch
    and head dims placed as the cache's and every other dim whole."""
    from torch.distributed.tensor import Replicate, Shard
    want = [p if isinstance(p, Shard) and p.dim in (0, value.dim() - 2)
            else Replicate() for p in cache_t.placements]
    return value.redistribute(cache_t.device_mesh, want).to_local()


def write_prefix(cache_t: torch.Tensor, value: torch.Tensor) -> None:
    """``cache_t[:, :S] = value`` (prefill), in place.  Under a mesh the
    cache may be sharded over its sequence dim (the dry run's decode
    sharding): each rank writes the part of the prefix its shard holds."""
    s = value.shape[1]
    if not is_dtensor(cache_t):
        cache_t[:, :s] = value
        return
    local, lo, hi = _local_window(cache_t, 1)
    val = _value_on(value, cache_t)
    if lo < s:
        local[:, :min(hi, s) - lo] = val[:, lo:min(hi, s)].to(local.dtype)


def write_rows(cache_t: torch.Tensor, lens: torch.Tensor,
               value: torch.Tensor) -> None:
    """``cache_t[b, lens[b]] = value[b]`` for every row b (a decode
    step), in place; under a mesh each rank writes the rows and the
    positions its shard holds."""
    if not is_dtensor(cache_t):
        rows = torch.arange(cache_t.shape[0], device=cache_t.device)
        cache_t[rows, lens.long()] = value.to(cache_t.dtype)
        return
    local, lo, hi = _local_window(cache_t, 1)
    val = _value_on(value[:, None], cache_t)[:, 0]
    idx = _like_batch(lens, cache_t).to_local().long()
    rows = torch.arange(local.shape[0], device=local.device)
    mine = (idx >= lo) & (idx < hi)
    # a row whose position another shard holds writes its own old value
    pos = torch.where(mine, idx - lo, torch.zeros_like(idx))
    old = local[rows, pos]
    local[rows, pos] = torch.where(mine[:, None, None], val.to(local.dtype),
                                   old)


def init_attention_cache(cfg: ModelConfig, batch: int, max_len: int, device,
                         dtype) -> dict:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# dense FFN
# ---------------------------------------------------------------------------

def activation(act: str, up: torch.Tensor, gate: torch.Tensor | None):
    if act == "swiglu":
        return F.silu(gate) * up
    if act == "squared_relu":
        r = F.relu(up)
        return r * r
    if act == "gelu":
        return F.gelu(up, approximate="tanh")   # jax.nn.gelu's default
    raise ValueError(f"unknown activation {act!r}")


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        self.cfg = cfg
        self.norm = RMSNorm(d, cfg.norm_eps, device)
        self.w_up = _param((d, ff), device, dtype)
        self.w_down = _param((ff, d), device, dtype)
        self.w_gate = (_param((d, ff), device, dtype)
                       if cfg.act == "swiglu" else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        s_in, s_out = self.cfg.d_model ** -0.5, self.cfg.d_ff ** -0.5
        if self.w_gate is not None:
            normal_(self.w_gate, generator, s_in)
        normal_(self.w_up, generator, s_in)
        normal_(self.w_down, generator, s_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # ``up`` is placed (batch, -, ff): the projections need the whole
        # sequence of the (seq-sharded) residual, gathered once on h
        h = logical(self.norm(x), "batch", None, None)
        up = logical(h @ self.w_up, "batch", None, "ff")
        gate = None if self.w_gate is None else h @ self.w_gate
        out = logical(activation(self.cfg.act, up, gate) @ self.w_down,
                      "batch", None, None)
        return x + out


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

class EmbedGroup(nn.Module):
    """The reference's ``embed_group``: token embedding, untied lm_head
    (d, V) and the final norm."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        self.cfg = cfg
        self.embed = _param((cfg.vocab, cfg.d_model), device, dtype)
        self.lm_head = _param((cfg.d_model, cfg.vocab), device, dtype)
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        std = self.cfg.d_model ** -0.5
        normal_(self.embed, generator, std)
        normal_(self.lm_head, generator, std)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return logical(embedding(self.embed, tokens), "batch", None, None)

    def lm_logits(self, h: torch.Tensor) -> torch.Tensor:
        h = logical(self.final_norm(h), "batch", None, None)
        return logical(h @ self.lm_head, "batch", None, "vocab")


def embedding(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  Under a mesh the lookup is vocab-parallel, the
    twin of ``_vocab_parallel_xent``, on local tensors: the table is
    gathered over the mesh dims that do not split its vocab (the data
    axes: a rank holds its (V / model, d) window, the whole (V, d) where
    the vocab does not divide ``model``), each rank looks up its ids that
    fall in its window (the others read zero), and the rows are summed
    across the ranks that split the vocab, placed as the ids.  The
    lookup's backward accumulates the rank's rows into its window's
    gradient, partial over the mesh dims the ids are split on and
    reduce-scattered into the table's shards.  No rank holds more of the
    table than its window (DTensor's own index rule, where a torch
    release has one, gathers the whole table, and its backward builds a
    zero table of the global shape).  On a mesh whose batch is split over
    ``("pod", "data")`` this runs on its batch view, so that the table is
    gathered over both data axes in one all-gather."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    ids = to_batch_view(replicate_like(tokens, table))
    table = to_batch_view(table)
    view = table.device_mesh
    vocab = [p.is_shard(0) for p in table.placements]
    # the ids whole over the mesh dims that split the vocab, as they are
    # (split over the batch, or whole) elsewhere
    ids = ids.redistribute(view, [Replicate() if v or p.is_partial() else p
                                  for v, p in zip(vocab, ids.placements)])
    local = table.redistribute(
        view, [Shard(0) if v else Replicate() for v in vocab]).to_local(
        grad_placements=[Shard(0) if v else Partial() if p.is_shard()
                         else Replicate()
                         for v, p in zip(vocab, ids.placements)])
    _, lo, hi = _local_window(table, 0)
    idx = ids.to_local()
    if hi - lo == table.shape[0]:
        out = local[idx]
    else:
        mine = (idx >= lo) & (idx < hi)
        out = local[torch.where(mine, idx - lo, torch.zeros_like(idx))]
        out = torch.where(mine[..., None], out, torch.zeros_like(out))
    rows = DTensor.from_local(out, view, [
        Partial() if v else p for v, p in zip(vocab, ids.placements)],
        run_check=False)
    return from_batch_view(rows.redistribute(view, ids.placements), mesh)


def _chunk_xent(hx: torch.Tensor, tx: torch.Tensor, head: torch.Tensor,
                w: torch.Tensor | None) -> torch.Tensor:
    """Summed next-token xent of one (B, c) chunk, f32 logits."""
    logits = logical(hx @ head, "batch", None, "vocab").float()  # (B, c, V)
    if _split(logits, 2) > 1:
        xent = _vocab_parallel_xent(logits, tx)
    else:
        xent = _local_rows_xent(logits, tx)
    if w is not None:
        xent = xent * w[:, None]                           # LGD weights
    return xent.sum()


def _split(t: torch.Tensor, dim: int) -> int:
    """The ranks a DTensor's ``dim`` is split over (1 meshless)."""
    if not is_dtensor(t):
        return 1
    n = 1
    for i, p in enumerate(t.placements):
        if p.is_shard(dim):
            n *= t.device_mesh.size(i)
    return n


def _xent(logits: torch.Tensor, tx: torch.Tensor) -> torch.Tensor:
    """``logsumexp - gold`` of whole-vocab logits (B, c, V) and targets
    (B, c)."""
    gold = logits.gather(-1, tx.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def _local_rows_xent(logits: torch.Tensor, tx: torch.Tensor) -> torch.Tensor:
    """``_xent`` of logits whose vocab dim is whole, on each rank's own
    rows: on a DTensor the gather's backward would build a zero tensor of
    the logits' GLOBAL shape, which DTensor replicates (the whole batch's
    chunk on every rank), so the op runs on the local rows and the
    result comes back placed over them."""
    if not is_dtensor(logits):
        return _xent(logits, tx)
    from torch.distributed.tensor import DTensor, Replicate
    mesh = logits.device_mesh
    rows = [p if p.is_shard(0) else Replicate() for p in logits.placements]
    local = logits.redistribute(mesh, rows).to_local()
    t = replicate_like(tx, logits).redistribute(mesh, rows).to_local()
    return DTensor.from_local(_xent(local, t), mesh, rows, run_check=False)


def _vocab_parallel_xent(logits: torch.Tensor,
                         tx: torch.Tensor) -> torch.Tensor:
    """``logsumexp - gold`` of logits whose vocab dim is split over ranks,
    without gathering it: each rank reduces its vocab shard (the max, the
    sum of exponentials, the gold logit where the target falls in its
    shard) and the shards' results are reduced across the ranks that
    split the vocab.  Written on local tensors and partial placements,
    not on DTensor's gather rule, whose masked partial differs between
    torch releases."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    b, c, v = logits.shape
    x = logits.reshape(b * c, v)
    mesh = x.device_mesh
    local, lo, _ = _local_window(x, 1)
    rows = [p if p.is_shard(0) else Replicate() for p in x.placements]

    def across_vocab(t, op):
        # (N_local,) shard results -> reduced over the vocab's ranks
        part = [Partial(op) if p.is_shard(1) else r
                for p, r in zip(x.placements, rows)]
        return DTensor.from_local(t, mesh, part, run_check=False) \
            .redistribute(mesh, rows)

    with torch.no_grad():
        m = across_vocab(local.amax(dim=-1), "max").to_local()
    s = across_vocab(torch.exp(local - m[:, None]).sum(dim=-1), "sum")
    t = replicate_like(tx, x).reshape(b * c).redistribute(
        mesh, rows).to_local() - lo
    hit = (t >= 0) & (t < local.shape[1])
    gold = local.gather(-1, torch.where(hit, t, 0)[:, None].long())[:, 0]
    gold = across_vocab(torch.where(hit, gold, 0.0), "sum")
    lse = torch.log(s) + DTensor.from_local(m, mesh, rows, run_check=False)
    return (lse - gold).reshape(b, c)


def chunked_cross_entropy(embed_group: EmbedGroup, cfg: ModelConfig,
                          h: torch.Tensor, targets: torch.Tensor,
                          weights: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Mean next-token xent without materialising (B, S, V) logits.

    The reference's ``layers.chunked_cross_entropy``: the final norm,
    then per ``loss_chunk`` positions the lm_head product, f32 logits,
    logsumexp minus the gold logit, times the per-example ``weights``
    (B,).  Each chunk runs under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint``), so backward keeps one chunk's
    logits at a time.  The sum is divided by B·S.
    """
    b, s, _ = h.shape
    # the chunks cut the sequence: gather the (seq-sharded) residual once
    h = logical(embed_group.final_norm(h), "batch", None, None)
    c = min(cfg.loss_chunk, s)
    if s % c != 0:
        c = s
    w = None if weights is None else replicate_like(
        weights.to(torch.float32), h)
    total = replicate_like(torch.zeros((), dtype=torch.float32,
                                       device=h.device), h)
    for i in range(0, s, c):
        args = (h[:, i:i + c], targets[:, i:i + c], embed_group.lm_head, w)
        total = total + (checkpoint(_chunk_xent, *args, use_reentrant=False)
                         if torch.is_grad_enabled() else _chunk_xent(*args))
    return total / (b * s)
