"""Sub-quadratic sequence mixers: Mamba-2 (SSD) and xLSTM's mLSTM / sLSTM.

The port of src/repro/models/ssm.py.  The reference computes all of it
in plain jnp, outside any Pallas kernel, so plain PyTorch is its port.

Mamba-2 and mLSTM share one chunked gated linear-attention core,

    S_t = a_t * S_{t-1} + k_t^T v_t      (per-head matrix state, N x P)
    y_t = q_t S_t

computed chunk-parallel: within a chunk a small causal "attention"
matmul weighted by decay ratios, across chunks the carried state (a
Python loop over S / chunk, the reference's ``lax.scan``).  The core
runs in f32 and casts back to ``v``'s dtype.  sLSTM keeps a per-channel
scalar state; with input-only gates its stabiliser and its (c, n)
updates are associative, and the port runs them as log-depth doubling
scans with the reference's own combine operators.

Every mixer returns ``(x + mixer(x), new_state)``; decode is the O(1)
single-token state update (Mamba-2, mLSTM) or, for sLSTM, the same
layer at S = 1 with the carried state, as the reference does.  States:
Mamba-2 (B, H, N, P) f32, mLSTM (B, H, dh, dh + 1) f32 (the normaliser
is the last column), sLSTM a tuple (c, n, m), each (B, d) f32.
Parameters keep the reference's names, shapes and dtypes; ``a_log``,
``dt_bias``, ``d_skip``, ``gate_bias`` and the norm scales are f32
whatever the model dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..dist.sharding import (elementwise, local_map, logical, merge_last,
                             unflatten_last)
from .config import ModelConfig
from .layers import RMSNorm, _param, normal_

# (batch dim, head dim) of the chunked core's operands and results
_GLA_DIMS = ((0, 2), (0, 2), (0, 2), (0, 2), (0, 1))
_GLA_STEP_DIMS = ((0, 1), (0, 1), (0, 1), (0, 1), (0, 1))
_SLSTM_DIMS = ((0, 2),) * 4 + ((0, 1),)


# ---------------------------------------------------------------------------
# chunked gated linear attention core
# ---------------------------------------------------------------------------

def gla_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_a: torch.Tensor, chunk: int,
                state0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k (B, S, H, N), v (B, S, H, P), log_a (B, S, H) <= 0, state0
    (B, H, N, P) -> (y (B, S, H, P) in v's dtype, state (B, H, N, P) f32).

    S is padded to whole chunks with zero k / v and zero log-decay, so
    the state passes through the pads unchanged."""
    b, s, h, n = q.shape
    p = v.shape[-1]
    c = min(chunk, s)
    s_orig = s
    if s % c:
        pad = c - s % c
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        log_a = F.pad(log_a, (0, 0, 0, pad))
        s += pad
    nc = s // c

    def chunks(t, width):                                # (nc, B, H, c, w)
        return t.reshape(b, nc, c, h, width).permute(1, 0, 3, 2, 4).float()

    qc, kc, vc = chunks(q, n), chunks(k, n), chunks(v, p)
    la = log_a.reshape(b, nc, c, h).permute(1, 0, 3, 2).float()
    cum = torch.cumsum(la, dim=-1)                       # (nc, B, H, c)
    total = cum[..., -1:]
    state = (torch.zeros((b, h, n, p), dtype=torch.float32, device=q.device)
             if state0 is None else state0.float())
    causal = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    ys = []
    for i in range(nc):
        qi, ki, vi, cumi, toti = qc[i], kc[i], vc[i], cum[i], total[i]
        d_q = torch.exp(cumi)                # chunk start -> t, a_t included
        d_k = torch.exp(toti - cumi)         # t (exclusive) -> chunk end
        att = qi @ ki.transpose(-1, -2)                  # (B, H, c, c)
        # The decay ratio exp(cum_i - cum_j), masked in the EXPONENT: the
        # reference exponentiates the whole square and masks after, but
        # above the diagonal that reaches exp(c |log_a|) (exp(33) at
        # Mamba-2's init, chunk 256), which can overflow and turn the
        # backward's inf * 0 into NaN.  The kept entries are the same.
        expo = cumi[..., :, None] - cumi[..., None, :]
        att = att * torch.exp(expo.masked_fill(~causal, float("-inf")))
        y_intra = att @ vi
        y_state = (qi * d_q[..., None]) @ state
        state = (state * torch.exp(toti)[..., None]
                 + (ki * d_k[..., None]).transpose(-1, -2) @ vi)
        ys.append(y_intra + y_state)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(b, s, h, p)
    return y[:, :s_orig].to(v.dtype), state


def gla_core(q, k, v, log_a, chunk: int, state0=None):
    """``gla_chunked`` on each rank's batch rows and heads under a mesh
    (the core is local per row and per head); itself meshless.  A zero
    initial state is the core's own."""
    if state0 is None:
        return local_map(lambda *a: gla_chunked(*a, chunk), (q, k, v, log_a),
                         _GLA_DIMS[:4], ((0, 2), (0, 1)))
    return local_map(lambda *a: gla_chunked(*a[:4], chunk, a[4]),
                     (q, k, v, log_a, state0), _GLA_DIMS, ((0, 2), (0, 1)))


def gla_decode_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_a: torch.Tensor, state: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token: q, k (B, H, N), v (B, H, P), log_a (B, H), state
    (B, H, N, P) -> (y (B, H, P) in v's dtype, new state f32)."""
    a = torch.exp(log_a)[..., None, None].float()
    state = state * a + k.float()[..., :, None] * v.float()[..., None, :]
    y = (q.float()[..., None, :] @ state)[..., 0, :]
    return y.to(v.dtype), state


# ---------------------------------------------------------------------------
# Mamba-2 block
# ---------------------------------------------------------------------------

def mamba_dims(cfg: ModelConfig):
    """(d_inner, heads, state size N)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm_head_dim, cfg.ssm_state


class Mamba2(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d = cfg.d_model
        d_inner, nh, n = mamba_dims(cfg)
        self.cfg = cfg
        self.norm = RMSNorm(d, cfg.norm_eps, device)
        # in_proj emits [x (d_inner), z (d_inner), B (N), C (N), dt (nh)]
        self.in_proj = _param((d, 2 * d_inner + 2 * n + nh), device, dtype)
        f32 = dict(device=device, dtype=torch.float32)
        self.a_log = nn.Parameter(torch.zeros(nh, **f32))
        self.dt_bias = nn.Parameter(torch.full((nh,), -2.0, **f32))
        self.d_skip = nn.Parameter(torch.ones(nh, **f32))
        self.out_proj = _param((d_inner, d), device, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        d_inner = mamba_dims(self.cfg)[0]
        normal_(self.in_proj, generator, self.cfg.d_model ** -0.5)
        normal_(self.out_proj, generator, d_inner ** -0.5)

    def _project(self, x):
        cfg = self.cfg
        d_inner, nh, n = mamba_dims(cfg)
        b, s, _ = x.shape
        # the projection needs the whole sequence of the (seq-sharded)
        # residual, gathered once on its norm
        h = logical(self.norm(x), "batch", None, None)
        proj = logical(h @ self.in_proj, "batch", None, "ff")
        xin, z, bmat, cmat, dt_raw = torch.split(
            proj, [d_inner, d_inner, n, n, nh], dim=-1)
        xin = unflatten_last(xin, (nh, cfg.ssm_head_dim))
        # F.softplus returns its input above its threshold of 20, where
        # jax.nn.softplus computes log1p(exp(x)); they differ there by
        # less than e^-20
        dt = F.softplus(dt_raw.float() + self.dt_bias)
        log_a = -torch.exp(self.a_log) * dt                  # (B, S, nh) <= 0
        # B / C shared across heads (one group)
        k = bmat[:, :, None, :].expand(b, s, nh, n)
        q = cmat[:, :, None, :].expand(b, s, nh, n)
        v = xin * dt[..., None].to(xin.dtype)                # dt-scaled input
        return q, k, v, log_a, xin, z

    def _out(self, x, y, xin, z):
        y = y + xin * self.d_skip[:, None].to(xin.dtype)
        y = merge_last(y) * F.silu(z)
        return x + logical(y @ self.out_proj, "batch", None, None)

    def forward(self, x: torch.Tensor, state: Optional[torch.Tensor] = None):
        """x (B, S, d) -> (x + mamba(x), state (B, H, N, P))."""
        q, k, v, log_a, xin, z = self._project(x)
        y, state = gla_core(q, k, v, log_a, self.cfg.chunk, state)
        return self._out(x, y, xin, z), state

    def decode(self, x: torch.Tensor, state: torch.Tensor):
        """x (B, 1, d): the O(1) state update."""
        q, k, v, log_a, xin, z = self._project(x)
        y, state = local_map(gla_decode_step,
                             (q[:, 0], k[:, 0], v[:, 0], log_a[:, 0], state),
                             _GLA_STEP_DIMS, ((0, 1), (0, 1)))
        return self._out(x, y[:, None], xin, z), state


def init_mamba2_state(cfg: ModelConfig, batch: int, device) -> torch.Tensor:
    _, nh, n = mamba_dims(cfg)
    return torch.zeros((batch, nh, n, cfg.ssm_head_dim), dtype=torch.float32,
                       device=device)


# ---------------------------------------------------------------------------
# xLSTM mLSTM block (matrix memory, exponential gating)
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d, nh = cfg.d_model, cfg.n_heads
        self.cfg = cfg
        self.norm = RMSNorm(d, cfg.norm_eps, device)
        self.qkv_proj = _param((d, 3 * d), device, dtype)
        self.gate_proj = _param((d, 2 * nh), device, dtype)
        # input gates 0, forget gates 3 (sigmoid(3) = 0.95)
        self.gate_bias = nn.Parameter(torch.cat([
            torch.zeros(nh), torch.full((nh,), 3.0)]).to(device))
        self.out_proj = _param((d, d), device, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        std = self.cfg.d_model ** -0.5
        for w in (self.qkv_proj, self.gate_proj, self.out_proj):
            normal_(w, generator, std)

    def _project(self, x):
        cfg = self.cfg
        nh = cfg.n_heads
        dh = cfg.d_model // nh
        b, s, _ = x.shape
        h = logical(self.norm(x), "batch", None, None)
        qkv = logical(h @ self.qkv_proj, "batch", None, "ff")
        q, k, v = torch.chunk(qkv, 3, dim=-1)
        q = unflatten_last(q, (nh, dh)) * dh ** -0.5
        k = unflatten_last(k, (nh, dh)) * dh ** -0.5
        v = unflatten_last(v, (nh, dh))
        gates = (h @ self.gate_proj).float() + self.gate_bias
        i_gate, f_gate = torch.chunk(gates, 2, dim=-1)       # (B, S, nh)
        log_f = elementwise(F.logsigmoid, f_gate)            # <= 0
        i_scale = torch.exp(torch.clamp(i_gate, max=0.0))    # stabilised exp
        # the normaliser is the same recurrence with v = 1: a last column
        v_ext = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
        return q, k * i_scale[..., None].to(k.dtype), v_ext, log_f

    def _out(self, x, y_ext):
        dh = self.cfg.d_model // self.cfg.n_heads
        y, nrm = y_ext[..., :dh], y_ext[..., dh:]
        y = y / torch.clamp(nrm.abs(), min=1.0)
        out = merge_last(y) @ self.out_proj
        return x + logical(out, "batch", None, None)

    def forward(self, x: torch.Tensor, state: Optional[torch.Tensor] = None):
        """x (B, S, d) -> (x + mlstm(x), state (B, H, dh, dh + 1))."""
        q, k, v_ext, log_f = self._project(x)
        y_ext, state = gla_core(q, k, v_ext, log_f, self.cfg.chunk, state)
        return self._out(x, y_ext), state

    def decode(self, x: torch.Tensor, state: torch.Tensor):
        q, k, v_ext, log_f = self._project(x)
        y_ext, state = local_map(
            gla_decode_step, (q[:, 0], k[:, 0], v_ext[:, 0], log_f[:, 0],
                              state), _GLA_STEP_DIMS, ((0, 1), (0, 1)))
        return self._out(x, y_ext[:, None]), state


def init_mlstm_state(cfg: ModelConfig, batch: int, device) -> torch.Tensor:
    dh = cfg.d_model // cfg.n_heads
    return torch.zeros((batch, cfg.n_heads, dh, dh + 1), dtype=torch.float32,
                       device=device)


# ---------------------------------------------------------------------------
# xLSTM sLSTM block (scalar memory)
# ---------------------------------------------------------------------------

def mp_op(x, y):
    """Max-plus composition of m_t = max(a + m_{t-1}, b): x earlier."""
    a1, b1 = x
    a2, b2 = y
    return a1 + a2, torch.maximum(b1 + a2, b2)


def lin_op(x, y):
    """Composition of x_t = a x_{t-1} + b: x earlier."""
    a1, b1 = x
    a2, b2 = y
    return a1 * a2, b1 * a2 + b2


def associative_scan(op, elems, dim: int = 1):
    """Inclusive scan of the pair ``elems`` along ``dim`` under the
    associative ``op`` (earlier element first): log2(S) doubling rounds,
    each combining every position with the one 2^r before it.  Segment
    sums stay local, as in the reference's ``lax.associative_scan``; no
    closed form (a cumsum differenced) that cancels at long S."""
    elems = tuple(elems)
    s = elems[0].shape[dim]
    off = 1
    while off < s:
        early = tuple(e.narrow(dim, 0, s - off) for e in elems)
        late = tuple(e.narrow(dim, off, s - off) for e in elems)
        comb = op(early, late)
        elems = tuple(torch.cat([e.narrow(dim, 0, off), c], dim=dim)
                      for e, c in zip(elems, comb))
        off *= 2
    return elems


def slstm_scan(zi, ii, fi, oi, carry0):
    """The stabilised sLSTM recurrence over time in parallel form.

    Inputs (B, S, d) f32; carry0 = (c0, n0, m0), each (B, d).  Returns
    (h (B, S, d), (c, n, m) at the last step)."""
    c0, n0, m0 = carry0
    log_f = F.logsigmoid(fi)
    # 1) stabiliser m_t = max(log_f_t + m_{t-1}, i_t): a max-plus scan
    a_all, b_all = associative_scan(mp_op, (log_f, ii))
    m = torch.maximum(a_all + m0[:, None, :], b_all)
    m_prev = torch.cat([m0[:, None, :], m[:, :-1]], dim=1)
    i_p = torch.exp(ii - m)
    f_p = torch.exp(log_f + m_prev - m)

    # 2) linear recurrences x_t = f'_t x_{t-1} + u_t, for c and n
    def lin_scan(u, x0):
        aa, bb = associative_scan(lin_op, (f_p, u))
        return aa * x0[:, None, :] + bb

    c = lin_scan(i_p * torch.tanh(zi), c0)
    n = lin_scan(i_p, n0)
    h = torch.sigmoid(oi) * c / torch.clamp(n, min=1.0)
    return h, (c[:, -1], n[:, -1], m[:, -1])


class SLSTM(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.norm = RMSNorm(d, cfg.norm_eps, device)
        # fused projections of z (cell input) and the i, f, o gates
        self.in_proj = _param((d, 4 * d), device, dtype)
        self.out_proj = _param((d, d), device, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        std = self.cfg.d_model ** -0.5
        normal_(self.in_proj, generator, std)
        normal_(self.out_proj, generator, std)

    def forward(self, x: torch.Tensor, state=None):
        """x (B, S, d), state (c, n, m) or None -> (x + slstm(x), state).
        Decode is this call at S = 1 with the carried state."""
        h = logical(self.norm(x), "batch", None, None)
        proj = (h @ self.in_proj).float()
        z, i, f, o = torch.chunk(proj, 4, dim=-1)
        if state is None:
            state = init_slstm_state(self.cfg, x.shape[0], x.device)
        # per channel and per batch row: local under a mesh
        hs, c, n, m = local_map(
            lambda *a: _flat_scan(*a), (z, i, f, o, *state),
            _SLSTM_DIMS[:4] + ((0, 1),) * 3, ((0, 2),) + ((0, 1),) * 3)
        out = logical(hs.to(x.dtype) @ self.out_proj, "batch", None, None)
        return x + out, (c, n, m)


def _flat_scan(z, i, f, o, c0, n0, m0):
    hs, (c, n, m) = slstm_scan(z, i, f, o, (c0, n0, m0))
    return hs, c, n, m


def init_slstm_state(cfg: ModelConfig, batch: int, device):
    zeros = torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                        device=device)
    return (zeros, zeros.clone(), zeros.clone())
