"""LGD at deep-learning scale: the LSH-sampled data pipeline (paper Sec.
3.2 / App. E), PyTorch port of ``repro.data.lsh_pipeline``.

The paper's BERT recipe:

  * each training example owns a FEATURE VECTOR — the pooled last-layer
    representation (``models.lm.LM.pooled_features``) — hashed into the
    LSH index;
  * the QUERY at step t comes from the output layer (the mean lm_head
    column, ``LM.lm_head_query``), so it follows the model, while the
    tables are refreshed only every ``refresh_every`` steps;
  * each batch is drawn by Algorithm 1 (m independent samples), and the
    per-sample probabilities become importance weights 1/(p_i N) on the
    loss, so gradients stay unbiased.

DEVICE-RESIDENT STEP PATH: the token corpus is uploaded to the device
ONCE, as (N, S+1) int32 with no lane padding, and every ``next_batch``
is ``core.sampler.sample_gather`` on it: query hash and bucket search
(the ``bucket_probe`` kernel), then the candidate walk, the
within-bucket draw, the probability, the row gather and the 1/(p·N)
weights in one ``draw_assemble`` launch.  No step syncs with the host.

RANDOM STREAMS: every random number comes from a ``torch.Generator`` on
the pipeline's device, seeded by a fixed function of (``seed``, stream
salt, counter): the index build from ``_SALT_BUILD``, the draws of step
t from (``_SALT_STEP``, t).  So the same step always draws the same
batch, whatever else ran before it.  A full refresh draws nothing; the
refresh stream (``_SALT_REFRESH``) comes with the delta refresh's drift
draw.  Torch's Philox is not JAX's threefry: the port's batches match
the reference in distribution, not in bits (the parity tests inject the
reference's draws).

This slice ports the single-shard pipeline with the params-aware hooks
and the synchronous full refresh.  Not ported yet (ROADMAP.md queue 1):
delta and async refresh, ``restore_at``, streaming corpora, the health
ladder and its uniform fallback, the refresh watchdog, the legacy
closure hooks and ``ShardedLSHPipeline``.  One card is one shard, which
is what the reference's one-shard ``ShardedLSHPipeline`` computes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import time
import zlib
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core import (
    IndexMutation,
    LSHParams,
    get_family,
    mutate_index,
    sample_gather,
    sample_gather_batched,
)
from repro_torch.core.families import normalize_rows
from repro_torch.core.sampler import SampleDraws
from repro_torch.kernels import resolve_device

log = logging.getLogger("repro_torch.lgd")

# stream salts: one disjoint stream per random consumer, so a draw at
# (stream, counter) does not depend on how many draws other streams made
_SALT_BUILD = 0x0B11D
_SALT_STEP = 0x057E9

_LATER = "ROADMAP.md queue 1"


def _stream_seed(seed: int, salt: int, counter: int) -> int:
    """The 63-bit generator seed of (pipeline seed, stream, counter)."""
    digest = hashlib.blake2b(f"{seed}:{salt}:{counter}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


@dataclasses.dataclass
class LSHPipelineConfig:
    """The reference's config, field for field.  ``use_pallas`` and
    ``interpret`` are JAX kernel-dispatch knobs, kept so configs compare
    equal and ignored (the port dispatches by device).  Values the port
    does not run yet raise ``NotImplementedError``."""

    k: int = 7                   # paper BERT: K=7
    l: int = 10                  # paper BERT: L=10
    refresh_every: int = 200     # steps between feature re-hash
    minibatch: int = 32
    p_floor: float = 1e-8
    use_pallas: Optional[bool] = None   # JAX only: ignored
    interpret: bool = False             # JAX only: ignored
    refresh_async: bool = False
    refresh_lead: int = 1
    refresh_mode: str = "full"
    drift_frac: float = 0.05
    # normalise importance weights to mean 1 over the emitted batch
    normalize_weights: bool = True
    # ADDITIONAL Hamming-ball probe codes walked per table (0 = the
    # paper's single-probe Algorithm 1)
    multiprobe: int = 0
    # "srp": row-normalised features (cosine proxies the inner
    # product); "mips": un-normalised, Simple-LSH augmented
    family: str = "srp"
    # retries after a failed refresh attempt, with backoff
    # backoff * 2^(j-1) * (1 + jitter) before attempt j
    refresh_retries: int = 2
    refresh_backoff: float = 0.05
    refresh_timeout: Optional[float] = None
    health: Optional[Any] = None
    streaming: bool = False
    window: Optional[int] = None
    min_capacity: int = 64

    def __post_init__(self):
        if self.refresh_mode not in ("full", "delta"):
            raise ValueError(
                f"refresh_mode must be 'full' or 'delta', "
                f"got {self.refresh_mode!r}")
        if self.multiprobe < 0:
            raise ValueError(
                f"multiprobe must be >= 0, got {self.multiprobe}")
        if self.refresh_retries < 0:
            raise ValueError(
                f"refresh_retries must be >= 0, got {self.refresh_retries}")
        later = {
            "refresh_mode='delta'": self.refresh_mode == "delta",
            "refresh_async=True": self.refresh_async,
            "streaming / window": self.streaming or self.window is not None,
            "health": self.health is not None,
            "refresh_timeout": self.refresh_timeout is not None,
        }
        for what, asked in later.items():
            if asked:
                raise NotImplementedError(
                    f"LSHPipelineConfig {what} is not ported to PyTorch "
                    f"yet; see {_LATER}")
        get_family(self.family)   # raises on unknown family names


class LSHSampledPipeline:
    """Adaptive example sampler over a token corpus on one device.

    Args:
      seed: ALL pipeline randomness derives from it (module docstring).
      tokens: (N, S+1) int token rows, uploaded to ``device`` once.
      feature_fn / query_fn: params-aware hooks ``feature_fn(params,
        tokens)`` -> (n, d) and ``query_fn(params)`` -> (d,)
        (``mean_pool_feature_fn`` / ``lm_head_query_fn``); the trainer
        keeps ``params`` current through ``set_params``.
      config: ``LSHPipelineConfig``.
      feature_batch: rows per embed chunk of a corpus re-embed.  Each
        row is embedded on its own, so it sets memory, not features.
      params: the model the hooks read (an ``LM``); required.
      example_offset: lifts store-local row ids to global example ids.
      device: where the store, features, index and draws live — the
        card unless the caller asks for the CPU.
      projections: given projections instead of drawing them from the
        build stream (the hook the parity tests use).
    """

    def __init__(
        self,
        seed: int,
        tokens: np.ndarray,
        feature_fn: Callable,
        query_fn: Callable,
        config: LSHPipelineConfig,
        feature_batch: int = 512,
        params: Any = None,
        example_offset: int = 0,
        device="cuda",
        projections: Optional[torch.Tensor] = None,
    ):
        if params is None:
            raise NotImplementedError(
                "the legacy closure hooks feature_fn(tokens) / query_fn() "
                "are not ported; pass params= and the params-aware hooks")
        self.cfg = config
        self.family = get_family(config.family)
        self.device = resolve_device(device)
        self.seed = seed
        self.n, self.row_width = tokens.shape
        # the device-resident example store: uploaded exactly once
        self.store = torch.as_tensor(np.asarray(tokens),
                                     dtype=torch.int32).to(self.device)
        self.feature_fn = feature_fn
        self.query_fn = query_fn
        self.feature_batch = feature_batch
        self.params = params
        self.example_offset = example_offset
        self._gen = torch.Generator(device=self.device)
        self._step = 0
        self._refresh_count = 0
        # sampling diagnostics: device-side accumulators, read (synced)
        # only by sampler_stats()
        self._stat_draws = 0
        self._fallback_sum = torch.zeros((), dtype=torch.int64,
                                         device=self.device)
        self._primary_miss_sum = torch.zeros_like(self._fallback_sum)
        self._last_fallback = torch.zeros((), device=self.device)
        self.features = self._compute_features()
        # "srp" is the registry's dense SRP under its LSHParams name
        lsh_family = "dense" if config.family == "srp" else config.family
        self.lsh = LSHParams(k=config.k, l=config.l,
                             dim=self.features.shape[-1], family=lsh_family)
        build = (IndexMutation("build", projections=projections,
                               x_aug=self.features)
                 if projections is not None else
                 IndexMutation("build", generator=self._seeded(_SALT_BUILD, 0),
                               x_aug=self.features))
        self.index = mutate_index(None, build, self.lsh)

    def _seeded(self, salt: int, counter: int) -> torch.Generator:
        return self._gen.manual_seed(_stream_seed(self.seed, salt, counter))

    # -- params hook ---------------------------------------------------------

    def set_params(self, params: Any):
        """Point the feature/query hooks at fresh model params (cheap)."""
        self.params = params

    # -- features -----------------------------------------------------------

    @torch.no_grad()
    def _compute_features(self, params: Any = None) -> torch.Tensor:
        """Embed every example in ``feature_batch``-row chunks, for
        hashing: row-normalised for symmetric families, augmented under
        a scale derived from these features for asymmetric ones (MIPS).
        No attribute writes, so a failed refresh changes nothing.  (The
        reference also pins that scale for its delta refresh, which is
        not ported.)"""
        params = self.params if params is None else params
        w, fb = self.row_width, self.feature_batch
        raw = torch.cat([self.feature_fn(params, self.store[i:i + fb, :w - 1])
                         for i in range(0, self.n, fb)])
        if not self.family.asymmetric:
            return normalize_rows(raw)
        return self.family.augment_data(raw)

    # -- refresh ------------------------------------------------------------

    def _sleep_backoff(self, attempt: int):
        """Exponential backoff with jitter that is a pure function of
        (refresh count, attempt), as in the reference."""
        base = self.cfg.refresh_backoff
        if base <= 0 or attempt <= 0:
            return
        j = (zlib.crc32(f"{self._refresh_count}:{attempt}".encode())
             % 1000) / 1000.0
        time.sleep(base * (2 ** (attempt - 1)) * (1.0 + 0.5 * j))

    def refresh(self, full: Optional[bool] = None) -> bool:
        """Re-embed + re-hash every example synchronously, re-sorting
        through the previous order (warm start: unchanged codes keep
        their slots).  A failed attempt is retried with backoff; after
        ``1 + refresh_retries`` failures the last good (features, index)
        stays live and this returns False."""
        if full is False:
            raise NotImplementedError(
                f"the delta refresh is not ported to PyTorch yet; see "
                f"{_LATER}")
        attempts = 1 + self.cfg.refresh_retries
        err = None
        for attempt in range(attempts):
            self._sleep_backoff(attempt)
            try:
                feats = self._compute_features()
                index = mutate_index(
                    self.index, IndexMutation("refresh", x_aug=feats,
                                              warm_start=True), self.lsh)
            except Exception as e:   # noqa: BLE001 — any failure retries
                err = repr(e)     # not the exception: its frames hold tensors
                log.warning("refresh %d attempt %d failed",
                            self._refresh_count, attempt, exc_info=True)
                continue
            self.features, self.index = feats, index
            self._refresh_count += 1
            return True
        log.warning("refresh %d failed after %d attempt(s); keeping the "
                    "stale index (last error: %s)", self._refresh_count,
                    attempts, err)
        self._refresh_count += 1
        return False

    def _maybe_refresh(self):
        re = self.cfg.refresh_every
        s = self._step
        if re > 0 and s >= re and s % re == 0:
            self.refresh()

    def finalize(self):
        """Teardown hook of the trainer.  The synchronous refresh leaves
        no thread to join; the async refresh will (ROADMAP.md queue 1)."""

    # -- batches ------------------------------------------------------------

    def _tick(self) -> torch.Generator:
        """Refresh gate + the generator of this step's draws."""
        self._maybe_refresh()
        gen = self._seeded(_SALT_STEP, self._step)
        self._step += 1
        return gen

    @torch.no_grad()
    def _query(self) -> torch.Tensor:
        # SRP normalises the query, MIPS appends the zero coordinate
        return self.family.augment_query(self.query_fn(self.params))

    def _accum_stats(self, gb):
        """Accumulate per-step sampling diagnostics (device-lazy)."""
        fb = gb.fallback.reshape(-1)
        self._stat_draws += fb.shape[0]
        self._fallback_sum = self._fallback_sum + fb.sum()
        self._primary_miss_sum = (self._primary_miss_sum
                                  + (gb.probe_code.reshape(-1) != 0).sum())
        self._last_fallback = fb.to(torch.float32).mean()

    def sampler_stats(self) -> Dict[str, float]:
        """Cumulative sampling diagnostics (syncs; read at log cadence):
        ``draws``, ``fallback_rate`` (uniform 1/N fallbacks),
        ``primary_miss_rate`` (exact bucket empty) and
        ``last_fallback_rate`` (the latest batch)."""
        d = max(self._stat_draws, 1)
        return {
            "draws": self._stat_draws,
            "fallback_rate": float(self._fallback_sum) / d,
            "primary_miss_rate": float(self._primary_miss_sum) / d,
            "last_fallback_rate": float(self._last_fallback),
        }

    def _draw_args(self):
        return dict(m=self.cfg.minibatch, example_offset=self.example_offset,
                    multiprobe=self.cfg.multiprobe, p_floor=self.cfg.p_floor,
                    normalize=self.cfg.normalize_weights,
                    row_width=self.row_width)

    def next_batch(self, query: Optional[torch.Tensor] = None,
                   draws: Optional[SampleDraws] = None
                   ) -> Dict[str, torch.Tensor]:
        """Draw one batch on the device.  ``query`` (already augmented)
        replaces the hook's; ``draws`` replaces this step's generator
        draws (the parity tests' injection hook)."""
        gen = self._tick()
        q = self._query() if query is None else query
        gb = sample_gather(gen, self.index, self.features, q, self.store,
                           self.lsh, draws=draws, **self._draw_args())
        self._accum_stats(gb)
        return {
            "tokens": gb.tokens,
            "targets": gb.targets,
            "loss_weights": gb.loss_weights,
            "example_ids": gb.example_ids,
        }

    def next_batch_multi(self, queries: torch.Tensor,
                         draws: Optional[SampleDraws] = None) -> list:
        """One batch per query row (C, dim): all C queries are probed in
        one kernel launch and all C·m rows gathered in one, each chain
        with exact Algorithm-1 probabilities under its own query."""
        gen = self._tick()
        gb = sample_gather_batched(
            gen, self.index, self.features,
            self.family.augment_query(queries), self.store, self.lsh,
            draws=draws, **self._draw_args())           # fields (C, m, ...)
        self._accum_stats(gb)
        return [{
            "tokens": gb.tokens[c],
            "targets": gb.targets[c],
            "loss_weights": gb.loss_weights[c],
            "example_ids": gb.example_ids[c],
        } for c in range(queries.shape[0])]


def mean_pool_feature_fn(cfg):
    """Params-aware feature hook: the mean-pooled final hidden state of
    an ``LM`` built from ``cfg`` (the paper's BERT pooled-representation
    recipe)."""

    def fn(params, tokens: torch.Tensor) -> torch.Tensor:
        if params.cfg != cfg:
            raise ValueError(f"the hook is for {cfg.name}, the model is "
                             f"{params.cfg.name}")
        return params.pooled_features({"tokens": tokens})
    return fn


def lm_head_query_fn():
    """Params-aware query hook from the output layer: the mean lm_head
    column."""
    return lambda params: params.lm_head_query()
