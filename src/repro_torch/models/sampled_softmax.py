"""LSH-sampled softmax: the large-vocab head as an LGD problem.

PyTorch port of ``repro.models.sampled_softmax``.  The corpus is the
``lm_head`` table (rows = vocabulary), the query the final hidden state,
and Algorithm 1's exact inclusion probabilities keep the sampled
estimate unbiased.

TRAINING (``sampled_softmax_loss``).  The target logit stays exact; the
normaliser is estimated from m LSH-sampled negatives j with exact
probability p_j over the vocabulary,

    Zhat = (1/m) sum_j exp(l_j) / p_j          E[Zhat] = Z,

and the loss is ``logsumexp(l_j - log p_j) - log m - l_t``.  Gradients
reach ``lm_head`` only through the gathered columns; the probabilities
are detached (sampling-law constants, not model outputs).

INDEX OVER PARAMS (``LMHeadIndex``).  The indexed rows are trainable, so
the index refreshes by optimizer step: ``maybe_refresh`` every
``refresh_every`` steps, ``refresh_mode="delta"`` re-hashing the target
rows seen since the last refresh plus a seeded ``drift_sample`` of the
rest at the PINNED scale, and every ``full_every``-th refresh a full
warm refresh that re-pins it.  Probabilities are evaluated on the stored
``x_aug`` (the vectors the tables were built from), so staleness costs
variance, not bias.  ``wrap_batches`` marks each batch's targets and
injects the index, and ``step_hook`` is the trainer's attachment point
(``TrainerConfig(step_hook=head.step_hook)``); a hand-written loop calls
``note_targets`` / ``maybe_refresh`` / ``inject`` itself.

SERVING (``lsh_decode_step``).  The probe as an approximate top-k
shortlist: up to ``shortlist_per_table`` candidates from each probed
(band,) probe code and table — a static nb·J·L·c candidates a query —
then the masked argmax of the candidates' logits.  The logits read rows
of a (V, d) row-major copy of the head (``LMHeadIndex.rows``, made at
each build and refresh) and cast only the gathered rows to f32: the
values are the reference's ``lm_head.astype(f32)`` columns, and a column
gather of the (d, V) head would read a 32-byte sector per element.
Nothing in the head syncs with the host.  Approximate: when no probed
bucket holds the true argmax the token differs from the full head's.

RANDOM STREAMS.  Each ``torch.Generator`` is seeded from (seed, salt,
counter) with the reference's fold_in salts, so the build, per-step and
drift streams stay disjoint; the drift draw is the reference's own
seeded numpy draw, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.core.families import get_family
from repro_torch.core.sampler import sample_batched
from repro_torch.core.simhash import LSHParams, probe_masks
from repro_torch.core.tables import (
    IndexMutation,
    LSHIndex,
    bucket_bounds_banded,
    bucket_bounds_batched,
    bucket_bounds_multi,
    hash_points,
    mutate_index,
)
from repro_torch.data.lsh_pipeline import _stream_seed
from repro_torch.dist.sharding import is_dtensor, replicate_like

from .config import ModelConfig
from .layers import embedding
from .lm import LM

# the reference's fold_in salts of the head-index streams (disjoint from
# the data pipeline's 0x0B11D / 0x057E9 / 0x0F5E5)
_SALT_HEAD_BUILD = 0x5EAD0
_SALT_HEAD_STEP = 0x5EAD1
_SALT_HEAD_DRIFT = 0x5EAD2


@dataclasses.dataclass(frozen=True)
class SampledSoftmaxConfig:
    """Knobs of the LSH-sampled head (the reference's, less its kernel
    dispatch flags: the device of the tensors decides)."""

    k: int = 7                    # bits per table
    l: int = 10                   # tables
    n_samples: int = 32           # m: LSH-sampled negatives per token
    multiprobe: int = 2           # extra Hamming-ball codes per table
    family: str = "mips"          # core.families registry key
    refresh_every: int = 50       # optimizer steps between refreshes
    refresh_mode: str = "delta"   # "delta" | "full"
    full_every: int = 10          # every Nth refresh is full (re-pins the
    #                               scale); 0 = never force full
    drift_sample: float = 0.05    # share of clean rows re-hashed per delta
    p_floor: float = 1e-8         # probability floor inside log Zhat
    max_probes: Optional[int] = None   # cap on table draws
    shortlist_per_table: int = 8  # decode candidates per (probe, table)
    seed: int = 0

    def __post_init__(self):
        if self.refresh_mode not in ("delta", "full"):
            raise ValueError(
                f"refresh_mode must be 'delta' or 'full', "
                f"got {self.refresh_mode!r}")
        if self.n_samples < 1:
            raise ValueError(f"n_samples must be >= 1, got {self.n_samples}")


def head_lsh_params(cfg: ModelConfig, scfg: SampledSoftmaxConfig) -> LSHParams:
    """The hash-family parameters of the lm_head index (dim = aug_dim(d))."""
    fam = get_family(scfg.family)
    return LSHParams(k=scfg.k, l=scfg.l, dim=fam.aug_dim(cfg.d_model),
                     family=scfg.family)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _generator(device, seed: int, salt: int, counter: int):
    return torch.Generator(device=device).manual_seed(
        _stream_seed(seed, salt, counter))


# ---------------------------------------------------------------------------
# the head-level sampled cross entropy
# ---------------------------------------------------------------------------

def sampled_head_xent(q: torch.Tensor, lm_head: torch.Tensor,
                      targets: torch.Tensor, neg_ids: torch.Tensor,
                      neg_probs: torch.Tensor,
                      p_floor: float = 1e-8) -> torch.Tensor:
    """Per-token sampled softmax xent ``log Zhat - l_target``.

    q: (T, d) f32 queries (the logits are ``q @ lm_head``); lm_head:
    (d, V); targets: (T,) gold ids (their logits stay exact); neg_ids /
    neg_probs: (T, m) Algorithm-1 samples over the vocabulary and their
    probabilities (detached).  Only the gathered columns are cast to f32
    and reached by the gradient.  Returns (T,) losses."""
    t_, m = neg_ids.shape
    d = lm_head.shape[0]
    if is_dtensor(lm_head):
        l_neg, l_gold = _head_logits_on_mesh(q, lm_head, targets, neg_ids)
    else:
        w_neg = lm_head.index_select(1, neg_ids.reshape(-1)).float() \
            .reshape(d, t_, m)
        l_neg = torch.einsum("td,dtm->tm", q, w_neg)        # (T, m)
        w_gold = lm_head.index_select(1, targets.reshape(-1)).float()
        l_gold = torch.einsum("td,dt->t", q, w_gold)        # (T,)
    logp = torch.log(torch.clamp(neg_probs.detach(), min=p_floor))
    log_zhat = torch.logsumexp(l_neg - logp, dim=-1) - float(np.log(m))
    return log_zhat - l_gold


def _head_logits_on_mesh(q, lm_head, targets, neg_ids):
    """The sampled and gold logits of a DTensor head, on each rank's own
    rows: the ids placed as q's rows, the head's columns looked up
    vocab-parallel (``layers.embedding`` on the head's (V, d) view).
    DTensor's ``index_select`` gathers the whole head and its backward
    builds a zero head of the global shape, replicated."""
    from torch.distributed.tensor import Replicate
    rows = [p if p.is_shard(0) else Replicate() for p in q.placements]

    def on_rows(ids):
        return replicate_like(ids, q).redistribute(q.device_mesh, rows)

    w_neg = embedding(lm_head.t(), on_rows(neg_ids)).float()   # (T, m, d)
    w_gold = embedding(lm_head.t(), on_rows(targets.reshape(-1))).float()
    return (torch.einsum("td,tmd->tm", q, w_neg),
            torch.einsum("td,td->t", q, w_gold))


def sampled_softmax_loss(lm: LM, cfg: ModelConfig,
                         scfg: SampledSoftmaxConfig, batch) -> torch.Tensor:
    """Trainer-compatible LM loss with the LSH-sampled normaliser.

    The batch carries the head-index leaves (``LMHeadIndex.inject``):
    ``head_index`` (the ``LSHIndex``), ``head_x_aug`` (the hashed
    vectors, on which the probabilities are evaluated) and
    ``head_generator`` (this step's draws), or ``head_draws`` (explicit
    ``SampleDraws``, the parity tests' hook).  The sampling query is
    detached; the same hidden state flows into the sampled logits, so
    ``lm_head`` is reached only through the m + 1 gathered columns a
    token."""
    lsh = head_lsh_params(cfg, scfg)
    fam = get_family(scfg.family)
    h = lm.forward(batch)                                       # (B, S, d)
    hn = lm.embed_group.final_norm(h).float()
    b, s, d = hn.shape
    q = hn.reshape(b * s, d)
    q_aug = fam.augment_query(q.detach())
    res = sample_batched(
        batch.get("head_generator"), batch["head_index"],
        batch["head_x_aug"], q_aug, lsh, m=scfg.n_samples,
        max_probes=scfg.max_probes, multiprobe=scfg.multiprobe,
        draws=batch.get("head_draws"))                          # (BS, m)
    xent = sampled_head_xent(
        q, lm.embed_group.lm_head, batch["targets"].reshape(-1),
        res.indices, res.probs, p_floor=scfg.p_floor)           # (BS,)
    w = batch.get("loss_weights")
    if w is not None:
        xent = (xent.reshape(b, s) * w.float()[:, None]).reshape(-1)
    return xent.mean()


def make_sampled_loss(cfg: ModelConfig, scfg: SampledSoftmaxConfig):
    """``loss_fn(lm, batch)`` for ``Trainer(loss_fn=...)``."""
    return lambda lm, batch: sampled_softmax_loss(lm, cfg, scfg, batch)


# ---------------------------------------------------------------------------
# index-over-params lifecycle
# ---------------------------------------------------------------------------

class LMHeadIndex:
    """MIPS index over the TRAINABLE lm_head rows, refreshed by step.

    Every write goes through ``mutate_index``: ``op="build"`` once, then
    ``op="delta"`` merges of the dirty rows re-augmented at the pinned
    scale, with periodic full ``op="refresh"`` passes that re-pin it.
    ``x_aug`` changes in lockstep with the codes.  ``rows`` is a (V, d)
    row-major copy of the head in the model's dtype, made at every build
    and refresh, for the decode shortlist.

    ``projections`` (the build's, e.g. the reference's) replaces the
    seeded draw.  Attach it to a ``Trainer`` with ``wrap_batches`` and
    ``TrainerConfig(step_hook=head.step_hook)``.
    """

    def __init__(self, lm: LM, scfg: SampledSoftmaxConfig =
                 SampledSoftmaxConfig(), *,
                 projections: Optional[torch.Tensor] = None):
        self.cfg = lm.cfg
        self.scfg = scfg
        self.lsh = head_lsh_params(lm.cfg, scfg)
        self.device = lm.device
        self._fam = get_family(scfg.family)
        self._dirty = np.zeros((lm.cfg.vocab,), bool)
        self._step = 0
        self._last_refresh_step = 0
        self.refreshes = 0          # total refreshes applied
        self.delta_refreshes = 0
        self.full_refreshes = 0
        self.build(lm, projections=projections)

    def _rows(self, lm: LM) -> torch.Tensor:
        """(V, d) f32 head rows; keeps the row-major copy in ``rows``."""
        self.rows = lm.embed_group.lm_head.detach().T.contiguous()
        return self.rows.float()

    # -- writes (all through mutate_index) ----------------------------------

    @torch.no_grad()
    def build(self, lm: LM, projections: Optional[torch.Tensor] = None):
        """(Re)build from scratch: a fresh scale pin, a fresh sort."""
        rows = self._rows(lm)
        self.scale = self._fam.data_scale(rows)
        self.x_aug = self._fam.augment_data(rows, scale=self.scale)
        del rows
        if projections is None:
            mut = IndexMutation("build", x_aug=self.x_aug, generator=_generator(
                self.device, self.scfg.seed, _SALT_HEAD_BUILD, 0))
        else:
            mut = IndexMutation("build", x_aug=self.x_aug,
                                projections=projections.to(self.device))
        self.index: LSHIndex = mutate_index(None, mut, self.lsh)
        self._dirty[:] = False

    @torch.no_grad()
    def refresh(self, lm: LM, mode: Optional[str] = None,
                repin_scale: Optional[bool] = None) -> None:
        """One refresh pass; ``mode`` defaults to ``scfg.refresh_mode``,
        ``repin_scale`` to True for full and False for delta (a delta
        must re-augment at the pinned scale of the last full pass)."""
        mode = mode or self.scfg.refresh_mode
        rows = self._rows(lm)
        if mode == "full":
            if repin_scale is None or repin_scale:
                self.scale = self._fam.data_scale(rows)
            self.x_aug = self._fam.augment_data(rows, scale=self.scale)
            self.index = mutate_index(
                self.index,
                IndexMutation("refresh", x_aug=self.x_aug, warm_start=True),
                self.lsh)
            self.full_refreshes += 1
        else:
            ids = self._dirty_ids()
            if ids.size:
                ids_t = torch.from_numpy(ids.astype(np.int64)).to(
                    self.device)
                aug_d = self._fam.augment_data(rows.index_select(0, ids_t),
                                               scale=self.scale)
                codes = hash_points(aug_d, self.index.projections, self.lsh)
                self.index = mutate_index(
                    self.index,
                    IndexMutation("delta", ids=ids_t, codes=codes))
                self.x_aug = self.x_aug.index_copy(0, ids_t, aug_d)
            self.delta_refreshes += 1
        self._dirty[:] = False
        self.refreshes += 1

    def _dirty_ids(self) -> np.ndarray:
        """Dirty rows + a seeded drift sample of the clean ones, padded to
        a power of two by repeating the first id (a merge no-op): the
        reference's numpy draw, bit for bit."""
        dirty = np.nonzero(self._dirty)[0]
        clean = np.nonzero(~self._dirty)[0]
        n_extra = int(round(clean.size * self.scfg.drift_sample))
        if n_extra:
            rng = np.random.default_rng(
                (self.scfg.seed, _SALT_HEAD_DRIFT, self.refreshes))
            dirty = np.concatenate(
                [dirty, rng.choice(clean, size=n_extra, replace=False)])
        if dirty.size == 0:
            return dirty.astype(np.int32)
        pad = min(_next_pow2(dirty.size), self.cfg.vocab) - dirty.size
        if pad:
            dirty = np.concatenate([dirty, np.full(pad, dirty[0])])
        return dirty.astype(np.int32)

    # -- the step-keyed cadence ---------------------------------------------

    def note_targets(self, targets) -> None:
        """Mark this batch's target ids dirty (a host-side bitmap: a card
        tensor is read back)."""
        if isinstance(targets, torch.Tensor):
            targets = targets.detach().cpu().numpy()
        self._dirty[np.asarray(targets).reshape(-1)] = True

    def maybe_refresh(self, step: int, lm: LM) -> bool:
        """Refresh iff ``refresh_every`` optimizer steps have passed since
        the last one; every ``full_every``-th is full.  True if it ran."""
        self._step = step
        if step - self._last_refresh_step < self.scfg.refresh_every:
            return False
        force_full = (self.scfg.full_every > 0 and
                      (self.refreshes + 1) % self.scfg.full_every == 0)
        self.refresh(lm, mode="full" if force_full else None)
        self._last_refresh_step = step
        return True

    def step_hook(self, trainer) -> None:
        """``TrainerConfig.step_hook`` adapter (optimizer-step-keyed)."""
        self.maybe_refresh(trainer.step, trainer.params)

    # -- batch plumbing ------------------------------------------------------

    def inject(self, batch: dict, step: Optional[int] = None) -> dict:
        """``batch`` plus the head-index leaves the loss reads, with this
        step's generator from the per-step stream."""
        step = self._step if step is None else step
        out = dict(batch)
        out["head_index"] = self.index
        out["head_x_aug"] = self.x_aug
        out["head_generator"] = _generator(self.device, self.scfg.seed,
                                           _SALT_HEAD_STEP, step)
        return out

    def wrap_batches(self, batches: Iterator[dict]) -> Iterator[dict]:
        """Mark each batch's targets dirty and inject the current index."""
        for i, batch in enumerate(batches):
            if "targets" in batch:
                self.note_targets(batch["targets"])
            yield self.inject(batch, step=i)


# ---------------------------------------------------------------------------
# serving: the probe as an approximate top-k shortlist
# ---------------------------------------------------------------------------

def shortlist_candidates(index: LSHIndex, q_aug: torch.Tensor,
                         lsh: LSHParams, scfg: SampledSoftmaxConfig):
    """Static-shape candidate ids from the queries' probed buckets.

    For each query, (band,) probe code and table, up to
    ``shortlist_per_table`` slots of the bucket [lo, hi): nb·J·L·c ids a
    query whatever the bucket sizes.  q_aug: (B, aug_dim).  Returns
    (ids (B, nb·J·L·c) int64, valid bool of the same shape: the slots
    inside their bucket)."""
    masks = probe_masks(lsh.k, 1 + scfg.multiprobe)
    b = q_aug.shape[0]
    if get_family(lsh.family).num_bands() > 1:
        lo, hi = bucket_bounds_banded(index, q_aug, lsh,
                                      masks)              # (B, nb, J, L)
        lo = lo.reshape(b, -1, lo.shape[-1])
        hi = hi.reshape(b, -1, hi.shape[-1])
    elif len(masks) == 1:
        lo, hi = bucket_bounds_batched(index, q_aug, lsh)  # (B, L)
        lo, hi = lo[:, None, :], hi[:, None, :]
    else:
        lo, hi = bucket_bounds_multi(index, q_aug, lsh, masks)  # (B, J, L)
    offs = torch.arange(scfg.shortlist_per_table, dtype=torch.int64,
                        device=lo.device)
    lo = lo.to(torch.int64)
    slots = lo[..., None] + offs                           # (B, X, L, c)
    valid = offs < (hi.to(torch.int64) - lo)[..., None]
    slots = torch.clamp(slots, max=index.n_points - 1)
    t_idx = torch.arange(index.n_tables, device=lo.device)[None, None, :,
                                                           None]
    ids = index.order[t_idx, slots]                        # (B, X, L, c)
    return ids.reshape(b, -1), valid.reshape(b, -1)


def shortlist_logits(head_rows: torch.Tensor, q: torch.Tensor,
                     ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(B, C) candidate logits in f32, invalid slots -inf.  head_rows:
    (V, d) (``LMHeadIndex.rows``); only the gathered rows are cast."""
    b, c = ids.shape
    w = head_rows.index_select(0, ids.reshape(-1)).float().reshape(b, c, -1)
    logits = torch.bmm(w, q.float()[:, :, None])[..., 0]
    return torch.where(valid, logits, float("-inf"))


@torch.no_grad()
def lsh_head_tokens(lm: LM, h: torch.Tensor,
                    head: LMHeadIndex) -> torch.Tensor:
    """Greedy tokens (B, 1) of hidden states h (B, 1, d) through the LSH
    shortlist of ``head``: final norm, probe ``head.index``, gather the
    candidates' rows of ``head.rows``, masked argmax.  If every probed
    bucket is empty the argmax falls to candidate slot 0, as in the
    reference."""
    q = lm.embed_group.final_norm(h)[:, 0].float()           # (B, d)
    q_aug = get_family(head.lsh.family).augment_query(q)
    ids, valid = shortlist_candidates(head.index, q_aug, head.lsh,
                                      head.scfg)
    logits = shortlist_logits(head.rows, q, ids, valid)
    best = logits.argmax(dim=-1)
    return torch.gather(ids, 1, best[:, None])


@torch.no_grad()
def lsh_decode_step(lm: LM, batch, cache, head: LMHeadIndex):
    """One greedy decode step through the LSH-shortlisted head:
    ``decode_hidden`` runs the unchanged body, then ``lsh_head_tokens``.
    Returns (tokens (B, 1) int64, cache) — the cache updated in place."""
    h, cache = lm.decode_hidden(batch, cache)                 # (B, 1, d)
    return lsh_head_tokens(lm, h, head), cache
