"""Shared layers: RMSNorm, RoPE, GQA attention (self-attention with a KV
cache, and cross-attention over a memory), the dense FFN, the
embedding, the LM head and the chunked LM loss.

The port of src/repro/models/layers.py, as ``nn.Module``s.  Parameters
keep the reference's names, shapes and dtypes (``wq`` (d, Hq, Dh),
``wo`` (Hq, Dh, d), norm scales in f32 whatever the model dtype), so
``repro_torch.convert`` maps a reference pytree across leaf for leaf.
There is no mesh in the port, so the reference's ``logical(...)``
sharding annotations have no counterpart.

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
    """(cos, sin), each (B, S, 1, D/2) f32, for positions (B, S) or (S,).

    Every layer of a step rotates by the same positions, so a model
    computes the tables once per step and hands them to each layer."""
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
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
        h = self.norm(x)
        src = h if kv is None else kv
        q = (h @ self.wq.view(d, hq * dh)).view(b, s, hq, dh)
        k = (src @ self.wk.view(d, hkv * dh)).view(b, -1, hkv, dh)
        v = (src @ self.wv.view(d, hkv * dh)).view(b, -1, hkv, dh)
        if kv is None:
            q, k = apply_rope(q, *rope_cs), apply_rope(k, *rope_cs)
            impl = cfg.attn_impl
        else:
            impl, cache, causal = "ref", None, False
        new_cache = None
        if cache is None or s > 1:
            # full sequence: training, or prefill writing the cache
            if impl == "chunked":
                out = chunked_gqa_attention(q, k, v, causal=causal,
                                            block_q=cfg.attn_block_q)
            else:
                out = gqa_attention(q, k, v, causal=causal,
                                    use_kernel=impl == "pallas")
            if cache is not None:
                cache["k"][:, :s] = k
                cache["v"][:, :s] = v
                cache["len"] = torch.full((b,), s, dtype=torch.int32,
                                          device=x.device)
                new_cache = cache
        else:
            # one token: write it at each row's length, then attend over
            # len + 1 positions
            idx = cache["len"].long()
            rows = torch.arange(b, device=x.device)
            cache["k"][rows, idx] = k[:, 0].to(cache["k"].dtype)
            cache["v"][rows, idx] = v[:, 0].to(cache["v"].dtype)
            cache["len"] = cache["len"] + 1
            out = gqa_decode(q, cache["k"], cache["v"], cache["len"],
                             use_kernel=impl == "pallas")
            new_cache = cache
        out = out.reshape(b, s, hq * dh) @ self.wo.view(hq * dh, d)
        return x + out, new_cache


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
        h = self.norm(x)
        gate = None if self.w_gate is None else h @ self.w_gate
        return x + activation(self.cfg.act, h @ self.w_up, gate) @ self.w_down


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
        return self.embed[tokens]

    def lm_logits(self, h: torch.Tensor) -> torch.Tensor:
        return self.final_norm(h) @ self.lm_head


def _chunk_xent(hx: torch.Tensor, tx: torch.Tensor, head: torch.Tensor,
                w: torch.Tensor | None) -> torch.Tensor:
    """Summed next-token xent of one (B, c) chunk, f32 logits."""
    logits = (hx @ head).float()                           # (B, c, V)
    gold = logits.gather(-1, tx.long()[..., None])[..., 0]
    xent = torch.logsumexp(logits, dim=-1) - gold          # (B, c)
    if w is not None:
        xent = xent * w[:, None]                           # LGD weights
    return xent.sum()


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
    h = embed_group.final_norm(h)
    c = min(cfg.loss_chunk, s)
    if s % c != 0:
        c = s
    w = None if weights is None else weights.to(torch.float32)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, c):
        args = (h[:, i:i + c], targets[:, i:i + c], embed_group.lm_head, w)
        total = total + (checkpoint(_chunk_xent, *args, use_reentrant=False)
                         if torch.is_grad_enabled() else _chunk_xent(*args))
    return total / (b * s)
