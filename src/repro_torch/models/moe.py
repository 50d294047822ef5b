"""Mixture-of-Experts FFN with sort-based capacity dispatch (GShard-style).

The port of src/repro/models/moe.py, which computes it in plain jnp
outside any Pallas kernel, so plain PyTorch is its port.  Every shape is
static: each batch row is a dispatch group whose tokens are routed to a
fixed (E, C, d) buffer by a stable sort and a rank within each expert,
with C = max(int(S * k / E * capacity_factor), 1).  Tokens beyond an
expert's capacity are dropped (their residual passes through).  The
router runs in f32; the top-k gates are softmaxed in f32 and cast to
the activations' dtype.  Expert weights are (E, d, ff) and (E, ff, d),
the router (d, E) f32.

The reference scatters dropped slots out of range (``mode="drop"``) and
gathers them as zeros (``mode="fill"``); torch has neither mode, so the
port sends the dropped entries to one extra row, discarded after the
scatter and zero for the gather.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..dist.sharding import is_dtensor, logical
from .config import ModelConfig
from .layers import RMSNorm, _param, normal_, rms_norm


def capacity(cfg: ModelConfig, s: int) -> int:
    """Slots an expert has in one group of ``s`` tokens."""
    return max(int(s * cfg.moe_top_k / cfg.moe_experts
                   * cfg.moe_capacity_factor), 1)


def dispatch_slots(logits: torch.Tensor, k: int, cap: int
                   ) -> Tuple[torch.Tensor, ...]:
    """Token dispatch of every group (batch row) at once.

    logits (B, T, E) f32 -> (slot, keep, gate), each (B, T * k) in the
    reference's flat order (token-major, then the top-k rank): ``slot``
    is expert * cap + the entry's rank among its expert's entries (E *
    cap where dropped), ``keep`` rank < cap, ``gate`` the softmaxed top-k
    logit, f32.  Ranks come from a STABLE argsort of the experts, so
    earlier tokens win an expert's slots, as in the reference."""
    b, t, e = logits.shape
    top, experts = torch.topk(logits, k, dim=-1)             # (B, T, k)
    gate = torch.softmax(top, dim=-1).reshape(b, t * k)
    flat_expert = experts.reshape(b, t * k)
    order = torch.argsort(flat_expert, dim=-1, stable=True)
    sorted_expert = torch.gather(flat_expert, 1, order)
    arange_e = torch.arange(e, device=logits.device).expand(b, e)
    seg_start = torch.searchsorted(sorted_expert, arange_e.contiguous())
    rank_sorted = (torch.arange(t * k, device=logits.device)
                   - torch.gather(seg_start, 1, sorted_expert))
    rank = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
    keep = rank < cap
    slot = torch.where(keep, flat_expert * cap + rank,
                       torch.full_like(rank, e * cap))
    return slot, keep, gate


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d, ffe, e = cfg.d_model, cfg.moe_d_ff, cfg.moe_experts
        self.cfg = cfg
        self.norm = RMSNorm(d, cfg.norm_eps, device)
        self.router = _param((d, e), device, torch.float32)
        self.experts_gate = _param((e, d, ffe), device, dtype)
        self.experts_up = _param((e, d, ffe), device, dtype)
        self.experts_down = _param((e, ffe, d), device, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        s_in, s_out = self.cfg.d_model ** -0.5, self.cfg.moe_d_ff ** -0.5
        normal_(self.router, generator, s_in)
        normal_(self.experts_gate, generator, s_in)
        normal_(self.experts_up, generator, s_in)
        normal_(self.experts_down, generator, s_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, S, d) -> x + moe(x).

        Under a mesh the dispatch and the combine run on each rank's own
        batch rows (a batch row is a dispatch group, so they never cross
        a mesh axis): ``h`` is pinned to batch-only placement, as the
        reference pins it, and the expert buffer is placed over
        ``("batch", "experts")`` for the expert products."""
        cfg = self.cfg
        b, s, d = x.shape
        e, k = cfg.moe_experts, cfg.moe_top_k
        cap = capacity(cfg, s)
        h = logical(self.norm(x), "batch", None, None)
        logits = h.float() @ self.router
        buf, dest, gate = dispatch_local(
            _local(h), _local(logical(logits, "batch", None, None)), k, cap)
        # (B, E, C, d) placed over batch and experts: the expert products,
        # batched over E, are (E, B * C, d) @ (E, d, ff)
        buf = logical(_as_batch_dtensor(buf, h), "batch", "experts", None,
                      None)
        buf = buf.transpose(0, 1).reshape(e, b * cap, d)
        act = (F.silu(torch.bmm(buf, self.experts_gate))
               * torch.bmm(buf, self.experts_up))
        out_buf = torch.bmm(act, self.experts_down)          # (E, B*C, d)
        out_buf = logical(out_buf.view(e, b, cap, d).transpose(0, 1),
                          "batch", "experts", None, None)
        out = combine_local(_local(logical(out_buf, "batch", None, None,
                                           None)), dest, gate, s, k)
        return x + logical(_as_batch_dtensor(out, h), "batch", None, None)


def _local(t: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a batch-placed DTensor (a plain tensor as
    it is)."""
    return t.to_local() if is_dtensor(t) else t


def _as_batch_dtensor(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's rows ``t`` as a DTensor placed as ``like`` (batch
    only); ``t`` itself meshless."""
    if not is_dtensor(like):
        return t
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, like.device_mesh, like.placements,
                              run_check=False)


def dispatch_local(h: torch.Tensor, logits: torch.Tensor, k: int, cap: int):
    """The dispatch of local rows: h (b, S, d), router logits (b, S, E)
    f32 -> (buf (b, E, C, d), dest, gate).

    Every entry's row in the b * E * C slots, and one row past them for
    the dropped entries: the reference scatters those out of range
    (dropped) and gathers zeros for them (the extra row of the combine).
    No boolean indexing, so no host sync, and no atomics: the combine
    sums each token's k entries in order."""
    b, s, d = h.shape
    e = logits.shape[-1]
    slot, keep, gate = dispatch_slots(logits, k, cap)
    row = torch.arange(b, device=h.device)[:, None]
    dest = torch.where(keep, row * (e * cap) + slot,
                       torch.full_like(slot, b * e * cap)).view(-1)
    token = (row * s + torch.arange(s * k, device=h.device) // k).view(-1)
    buf = h.new_zeros((b * e * cap + 1, d)).index_copy(
        0, dest, h.reshape(b * s, d)[token])[:-1]
    return buf.view(b, e, cap, d), dest, gate


def combine_local(out_buf: torch.Tensor, dest: torch.Tensor,
                  gate: torch.Tensor, s: int, k: int) -> torch.Tensor:
    """The combine of local rows: the expert outputs (b, E, C, d) ->
    (b, S, d), each token the gated sum of its k entries in order."""
    b, d = out_buf.shape[0], out_buf.shape[-1]
    out_flat = torch.cat([out_buf.reshape(-1, d), out_buf.new_zeros((1, d))])
    contrib = out_flat[dest] * gate.to(out_buf.dtype).view(-1, 1)
    return contrib.view(b, s, k, d).sum(dim=2)


def aux_load_balance_loss(moe: MoE, x: torch.Tensor) -> torch.Tensor:
    """Switch-style auxiliary loss, E * sum_e f_e * p_e, of ``moe``'s
    router on x (B, S, d): f_e the share of tokens whose top-1 is e, p_e
    the mean router probability."""
    cfg = moe.cfg
    h = rms_norm(x, moe.norm.scale, cfg.norm_eps).reshape(-1, cfg.d_model)
    probs = torch.softmax(h.float() @ moe.router, dim=-1)
    f = F.one_hot(probs.argmax(dim=-1), cfg.moe_experts).float().mean(dim=0)
    return cfg.moe_experts * torch.sum(f * probs.mean(dim=0))
