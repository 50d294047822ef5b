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

from ..dist.sharding import (from_batch_view, is_dtensor, logical,
                             to_batch_view)
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
        # batched over E, are (E, B * C, d) @ (E, d, ff), on the mesh's
        # batch view where the batch is split over (pod, data) (that
        # reshape would gather the buffer over both: ``to_batch_view``).
        # Each weight is placed where it is used, so that autograd, which
        # runs the node made last first, reduces each weight's gradient
        # as soon as its product's backward has made it.
        buf = logical(_as_batch_dtensor(buf, h), "batch", "experts", None,
                      None)
        rows = to_batch_view(buf).transpose(0, 1).reshape(e, b * cap, d)
        act = (F.silu(torch.bmm(rows, _weight_for(rows, self.experts_gate)))
               * torch.bmm(rows, _weight_for(rows, self.experts_up)))
        out_buf = torch.bmm(act, _weight_for(act, self.experts_down))
        out_buf = logical(from_batch_view(
            out_buf.view(e, b, cap, d).transpose(0, 1),
            getattr(buf, "device_mesh", None)), "batch", "experts", None,
            None)
        out = combine_local(_local(logical(out_buf, "batch", None, None,
                                           None)), dest, gate, s, k)
        return x + logical(_as_batch_dtensor(out, h), "batch", None, None)


def _weight_for(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The expert weight ``w`` (E, n, m) placed for ``rows @ w``: ``rows``
    (E, B * C, n) are split along B * C over the data axes, where ``w``'s
    n is split too (the d-FSDP placement), so one of the two moves.  ``w``
    is gathered over those axes, its gradient reduce-scattered back, where
    that moves fewer bytes than DTensor's own choice, which moves the rows
    and leaves a partial product of the whole batch to reduce
    (``gathers_weight``): a training batch gathers, a decode step does
    not."""
    w = to_batch_view(w)
    if not is_dtensor(rows):
        return w
    data = [i for i, q in enumerate(rows.placements) if q.is_shard(1)]
    p = 1
    for i in data:
        p *= rows.device_mesh.size(i)
    if not gathers_weight(*rows.to_local().shape, w.shape[2],
                          w.to_local().numel(), p):
        return w
    from torch.distributed.tensor import Replicate
    return w.redistribute(w.device_mesh, [
        Replicate() if i in data else q for i, q in enumerate(w.placements)])


def gathers_weight(e: int, bc: int, n: int, m: int, w_local: int,
                   p: int) -> bool:
    """Whether ``_weight_for`` gathers a weight of ``w_local`` elements a
    rank over ``p`` data ranks for the product of a rank's rows (e, bc, n)
    into m columns: (p - 1) shards of the weight against the rows and the
    (p - 1) local outputs of the partial product's reduce-scatter."""
    return p > 1 and (p - 1) * w_local < e * bc * n + (p - 1) * e * bc * m


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
    if is_dtensor(x):
        return _aux_loss_on_rows(moe, x)
    h = rms_norm(x, moe.norm.scale, cfg.norm_eps).reshape(-1, cfg.d_model)
    probs = torch.softmax(h.float() @ moe.router, dim=-1)
    f = F.one_hot(probs.argmax(dim=-1), cfg.moe_experts).float().mean(dim=0)
    return cfg.moe_experts * torch.sum(f * probs.mean(dim=0))


def _aux_loss_on_rows(moe: MoE, x: torch.Tensor) -> torch.Tensor:
    """``aux_load_balance_loss`` of a DTensor x: each rank sums the top-1
    counts and the router probabilities of its own rows, and the sums are
    reduced across the ranks that split the batch.  On DTensors the
    means' backward expands their gradient to the whole batch's (B·S, E)
    on every rank, and ``one_hot`` builds its zeros at the global shape."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    cfg, e = moe.cfg, moe.cfg.moe_experts
    h = logical(rms_norm(x, moe.norm.scale, cfg.norm_eps), "batch", None,
                None)
    logits = logical(h.float() @ moe.router, "batch", None, None)
    probs = torch.softmax(logits.to_local().reshape(-1, e), dim=-1)
    sums = torch.stack([F.one_hot(probs.argmax(dim=-1), e).float().sum(0),
                        probs.sum(dim=0)])                    # (2, E)
    mesh = logits.device_mesh
    sums = DTensor.from_local(
        sums, mesh, [Partial() if p.is_shard(0) else Replicate()
                     for p in logits.placements], run_check=False
    ).redistribute(mesh, [Replicate()] * mesh.ndim) / (x.shape[0]
                                                       * x.shape[1])
    return e * torch.sum(sums[0] * sums[1])
