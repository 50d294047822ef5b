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
ONCE, as (C, S+1) int32 with no lane padding, and every ``next_batch``
is ``core.sampler.sample_gather`` on it: query hash and bucket search
(the ``bucket_probe`` kernel), then the candidate walk, the
within-bucket draw, the probability, the row gather and the 1/(p·N)
weights in one ``draw_assemble`` launch.  No step syncs with the host.

RANDOM STREAMS: every random number comes from a ``torch.Generator`` on
the pipeline's device, seeded by a fixed function of (``seed``, stream
salt, counter): the index build from ``_SALT_BUILD``, the draws of step
t from (``_SALT_STEP``, t), the delta refresh's drift draw of refresh r
from (``_SALT_REFRESH``, r).  So the same step always draws the same
batch, whatever else ran before it.  Torch's Philox is not JAX's
threefry: the port's batches match the reference in distribution, not
in bits (the parity tests inject the reference's draws: ``draws=``,
``projections=`` and ``drift=``).

REFRESH MODES (``refresh_mode``): ``"full"`` re-embeds and re-hashes
every row; ``"delta"`` re-embeds only the rows drawn since the last
refresh (a device-side dirty mask every draw marks) plus a
``drift_frac`` sample, pads their count to a power-of-two bucket, and
merges their codes into the index through the previous order (the
``delta`` mutation: tie-stable, bitwise a full warm refresh when every
row is dirty).  Its cost follows the drift, not N.  The asymmetric
family's data scale (MIPS: the max feature norm) is pinned at every
full (re)build and replayed for delta subsets and appends.

OVERLAPPED REFRESH (``refresh_async``): the refresh is launched
``refresh_lead`` steps before its boundary on a worker thread, on the
launch-time (features, index, store, live mask) snapshot, and swapped
in at the fixed boundary, so the batch sequence does not depend on
thread timing.  The model's weights are NOT snapshotted: the trainer
updates them in place, and a copy of a full-width model would not fit
beside it.  The work is ordered instead.  On a card the worker runs on
its own CUDA stream, which waits for the launch point of the step's
stream; before the first in-place update after a launch the trainer
calls ``before_param_update``, which makes the step's stream wait for
the worker's last read of the weights (on the CPU it waits for that
read to finish).  So the refreshed features are those of the
launch-time weights, bitwise.  The delta refresh claims the dirty mask
at the launch.  Under a mesh of more than one rank the weights are
DTensors and the worker's forward issues collectives, which every rank
must issue in one order: the launch then waits for the worker's host
work (on a card its device work still overlaps the step's, on its own
stream), and raises if the worker outlasts ``refresh_timeout``.

SELF-HEALING (the degradation ladder, ``data.health``): a failed
refresh attempt is retried with backoff and deterministic jitter; a
hung one is abandoned by the ``refresh_timeout`` watchdog.  Exhausted
retries leave the last good buffer live (stale-index mode); past the
staleness bound, a fallback-rate spike or a non-finite-loss streak the
pipeline draws uniform batches with weight 1 and tries a canonical
rebuild every ``recover_after`` steps.  Faults are injected through
``set_fault_injector`` (any object with ``fire(event, **info)``).  A
retry at the swap boundary embeds with the weights current at the
boundary: the launch-time weights are gone after the in-place update.

STREAMING CORPORA (``streaming`` / ``window``): the store, features and
index hold a power-of-two CAPACITY of slots; dead slots hash to
``EMPTY_CODE`` and sort after every live code, so probes and the
uniform fallback see only live rows, and every weight is 1/(p·n_live)
with n_live passed by value from the host.  ``mutate`` (``append`` /
``evict`` / ``delta`` / ``refresh`` / ``build``), ``append_rows`` and
``evict_rows`` change membership; appends embed at the pinned scale and
merge tie-stably; a ``window`` evicts the oldest rows first; capacity
doubles when full and halves at a quarter.  Mutations during an async
refresh go to the live buffers and are merged into the refresh's
result at the swap.  Explicit mutations are logged
(``mutation_log`` / ``load_mutation_log``): ``restore_at(t)`` replays
the log's membership up to step t and rebuilds the index canonically,
so two restores at the same step draw bitwise the same batches.

SHARD-BY-EXAMPLE (``ShardedLSHPipeline``): S per-shard pipelines over
contiguous corpus shards in one process on one device, each with its own
stream, composed into one global batch with weights S/(p·N).  With
``owned_shards`` one process of a multi-process run draws its shards'
slice of that batch (``repro_torch.dist.multihost_worker``: process r
owns shard r, and survivors of a lost process ``adopt_shards``).  With
``mesh=`` (a ``DeviceMesh``) the stores are replicated mesh-wide, every
rank drawing every shard's sub-batch, and the global batch is a DTensor
split over the mesh's data axes, a rank's part adopted without a copy
where the shard count is the data-parallel degree
(``dist.sharding.compose_sharded_batch``).  Features and queries from a
model placed on the mesh are read whole on every rank
(``dist.sharding.to_local_replicated``): the index they build is
replicated too.

Not ported: the legacy closure hooks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import logging
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import (
    EMPTY_CODE,
    IndexMutation,
    LSHIndex,
    LSHParams,
    get_family,
    grow_index,
    hash_points,
    mutate_index,
    sample_gather,
    sample_gather_batched,
)
from repro_torch.core.families import normalize_rows
from repro_torch.core.sampler import SampleDraws
from repro_torch.dist.sharding import (
    compose_sharded_batch,
    to_local_replicated,
    example_shard_bounds,
    shard_store_device,
)
from repro_torch.kernels import is_dtensor, resolve_device

from .health import (
    HEALTHY,
    STALE_INDEX,
    UNIFORM_FALLBACK,
    HealthConfig,
    HealthMonitor,
)

log = logging.getLogger("repro_torch.lgd")

# stream salts: one disjoint stream per random consumer, so a draw at
# (stream, counter) does not depend on how many draws other streams made
_SALT_BUILD = 0x0B11D
_SALT_STEP = 0x057E9
_SALT_REFRESH = 0x0F5E5
_SALT_SHARD = 0x054AD      # shard s's pipeline seed, ShardedLSHPipeline

# streaming shards address global example ids by a fixed per-shard stride:
# gid // _SHARD_STRIDE is the owning shard, gid % _SHARD_STRIDE its slot
_SHARD_STRIDE = 1 << 20


def _reads_collectively(params: Any) -> bool:
    """Whether the hooks' reads of ``params`` issue collectives: a model
    whose parameters are DTensors on a mesh of more than one rank."""
    first = next(iter(getattr(params, "parameters", list)()), None)
    return is_dtensor(first) and first.device_mesh.size() > 1


def _stream_seed(seed: int, salt: int, counter: int) -> int:
    """The 63-bit generator seed of (pipeline seed, stream, counter)."""
    digest = hashlib.blake2b(f"{seed}:{salt}:{counter}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def _dirty_bucket(n: int) -> int:
    """Pad a dirty count to a power-of-two bucket, at least 64."""
    b = 64
    while b < n:
        b <<= 1
    return b


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _pad_mutation(ids: np.ndarray, codes: torch.Tensor, capacity: int):
    """Pad a mutation batch to a power-of-two id bucket by repeating the
    first (id, code column): a duplicate scatter of equal values, a merge
    no-op.  ``ids`` (D,) host ints, ``codes`` (L, D) on the device."""
    b = int(ids.shape[0])
    size = max(min(_dirty_bucket(b), capacity), b)
    ids_t = torch.as_tensor(np.asarray(ids, np.int64), device=codes.device)
    if size == b:
        return ids_t, codes
    pad = size - b
    return (torch.cat([ids_t, ids_t[:1].expand(pad)]),
            torch.cat([codes, codes[:, :1].expand(-1, pad)], dim=1))


@dataclasses.dataclass
class LSHPipelineConfig:
    """The reference's config, field for field.  ``use_pallas`` and
    ``interpret`` are JAX kernel-dispatch knobs, kept so configs compare
    equal and ignored (the port dispatches by device)."""

    k: int = 7                   # paper BERT: K=7
    l: int = 10                  # paper BERT: L=10
    refresh_every: int = 200     # steps between feature re-hash
    minibatch: int = 32
    p_floor: float = 1e-8
    use_pallas: Optional[bool] = None   # JAX only: ignored
    interpret: bool = False             # JAX only: ignored
    # launch the refresh ``refresh_lead`` steps before its boundary on a
    # worker thread (module docstring: OVERLAPPED REFRESH)
    refresh_async: bool = False
    refresh_lead: int = 1
    # "full": re-embed every row; "delta": the rows drawn since the last
    # refresh plus a ``drift_frac`` sample, merged through the old order
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
    # watchdog seconds for one refresh attempt (for an async refresh:
    # the extra wait at its swap boundary); None = no watchdog
    refresh_timeout: Optional[float] = None
    # degradation-ladder thresholds; None = HealthConfig() defaults
    health: Optional[HealthConfig] = None
    # capacity-managed store and the mutation API; ``window`` implies it
    streaming: bool = False
    # appends past ``window`` live rows evict the oldest rows first
    window: Optional[int] = None
    # smallest (power-of-two) store capacity
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
        if self.window is not None:
            if self.window < 1:
                raise ValueError(f"window must be >= 1, got {self.window}")
            self.streaming = True
        if self.streaming:
            cw = get_family(self.family).code_width(self.k)
            if cw > 31:
                # every live code must sort before EMPTY_CODE = 2^32 - 1
                raise ValueError(
                    f"streaming requires code_width(k) <= 31 (sentinel "
                    f"codes), got {cw} (k={self.k}, "
                    f"family={self.family!r})")
            if self.min_capacity < 1 or (
                    self.min_capacity & (self.min_capacity - 1)):
                raise ValueError(
                    f"min_capacity must be a power of two >= 1, "
                    f"got {self.min_capacity}")
        get_family(self.family)   # raises on unknown family names


class _Flight:
    """An async refresh in flight: its worker, its result box, the inputs
    it runs on (a boundary retry reruns them), its bookkeeping record,
    and on a card the stream and events that order it against the
    step's stream."""

    def __init__(self, snapshot: tuple, record: dict, stream):
        self.snapshot = snapshot
        self.record = record
        self.box: dict = {}
        self.stream = stream                    # None on the CPU
        self.reads_issued = threading.Event()   # the worker's last weight read
        self.reads_event = None                 # ... as a CUDA event
        self.held = False                       # the step stream waits for it
        self.thread: Optional[threading.Thread] = None


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
      drift: given drift masks instead of drawing them from the refresh
        stream: ``drift(refresh_count, capacity)`` -> (capacity,) bool
        (the parity tests' hook).

    Determinism: two pipelines built with the same (seed, tokens,
    config) draw bitwise the same batches, and ``restore_at(t)`` rewinds
    to step t's stream positions.
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
        drift: Optional[Callable] = None,
    ):
        if params is None:
            raise NotImplementedError(
                "the legacy closure hooks feature_fn(tokens) / query_fn() "
                "are not ported; pass params= and the params-aware hooks")
        self.cfg = config
        self.family = get_family(config.family)
        self.device = resolve_device(device)
        self.seed = seed
        self.tokens = np.asarray(tokens)
        self.n, self.row_width = self.tokens.shape
        self.streaming = config.streaming
        self._init_membership(self.tokens)
        self.feature_fn = feature_fn
        self.query_fn = query_fn
        self.feature_batch = feature_batch
        self.params = params
        self.example_offset = example_offset
        self._drift = drift
        self._gen = torch.Generator(device=self.device)
        self._step = 0
        self._refresh_count = 0
        self._flight: Optional[_Flight] = None
        self._side_stream = None          # the async refresh's CUDA stream
        # held by the async refresh's worker around its computation: the
        # pipelines of a ShardedLSHPipeline share one (and one stream),
        # so their refreshes run one after another
        self._refresh_lock: Optional[threading.Lock] = None
        self._health_cfg = config.health or HealthConfig()
        self.health = HealthMonitor(self._health_cfg)
        self.fault_injector = None
        self._track_dirty = (config.refresh_mode == "delta"
                             and config.refresh_every > 0)
        self._dirty = self._no_dirt()
        # streaming: the explicit-mutation log (restore_at replays it) and
        # the slots mutated during an async refresh (merged at its swap)
        self._mutlog: List[dict] = []
        self._touched: set = set()
        # one record a refresh: count, full, rows embedded, async, ok,
        # host seconds blocked on it; device ms from ``refresh_records``
        self._records: List[dict] = []
        # sampling diagnostics: device-side accumulators, read (synced)
        # only by sampler_stats()
        self._stat_draws = 0
        self._fallback_sum = torch.zeros((), dtype=torch.int64,
                                         device=self.device)
        self._primary_miss_sum = torch.zeros_like(self._fallback_sum)
        self._last_fallback = torch.zeros((), device=self.device)
        # the asymmetric family's data scale, pinned at each full build
        self._feat_scale = None
        # the build's span on the device between CUDA events (on a card)
        self._build_events = (tuple(torch.cuda.Event(enable_timing=True)
                                    for _ in range(2))
                              if self.device.type == "cuda" else None)
        if self._build_events is not None:
            self._build_events[0].record()
        self.features = self._compute_features()
        # "srp" is the registry's dense SRP under its LSHParams name
        lsh_family = "dense" if config.family == "srp" else config.family
        self.lsh = LSHParams(k=config.k, l=config.l,
                             dim=self.features.shape[-1], family=lsh_family)
        build = (IndexMutation("build", projections=projections,
                               x_aug=self.features, live_mask=self._live_dev)
                 if projections is not None else
                 IndexMutation("build", generator=self._seeded(_SALT_BUILD, 0),
                               x_aug=self.features, live_mask=self._live_dev))
        self.index = mutate_index(None, build, self.lsh)
        if self._build_events is not None:
            self._build_events[1].record()

    def build_device_ms(self) -> Optional[float]:
        """The construction's embed, hash and sort: its span on the
        device in ms (None on the CPU).  Syncs on the end event."""
        if self._build_events is None:
            return None
        self._build_events[1].synchronize()
        return self._build_events[0].elapsed_time(self._build_events[1])

    def _seeded(self, salt: int, counter: int) -> torch.Generator:
        return self._gen.manual_seed(_stream_seed(self.seed, salt, counter))

    def _no_dirt(self) -> torch.Tensor:
        return torch.zeros((self.capacity,), dtype=torch.bool,
                           device=self.device)

    # -- membership / capacity (streaming) -----------------------------------

    def _init_membership(self, tokens: np.ndarray):
        """(Re)initialise the store and membership from the construction
        corpus (``__init__`` and the ``restore_at`` replay)."""
        n0 = tokens.shape[0]
        cap = (max(_next_pow2(max(n0, 1)), self.cfg.min_capacity)
               if self.streaming else n0)
        store = torch.zeros((cap, self.row_width), dtype=torch.int32)
        store[:n0] = torch.as_tensor(tokens, dtype=torch.int32)
        self.capacity = cap
        self._n_live = n0
        self._next_arrival = n0
        if self.streaming:
            self._live_np = np.zeros((cap,), np.bool_)
            self._live_np[:n0] = True
            self._arrival = np.full((cap,), -1, np.int64)
            self._arrival[:n0] = np.arange(n0)
            self._free = list(range(n0, cap))
        else:
            self._live_np = self._arrival = None
            self._free = []
        self.store = store.to(self.device)
        self._sync_live_dev()

    def _sync_live_dev(self):
        """The device mirror of the live mask (None unless streaming)."""
        self._live_dev = (torch.from_numpy(self._live_np.copy()).to(
            self.device) if self.streaming else None)

    @property
    def n_live(self) -> int:
        """Live (indexed) example count — ``n`` unless streaming."""
        return self._n_live

    # -- params hook ---------------------------------------------------------

    def set_params(self, params: Any):
        """Point the feature/query hooks at fresh model params (cheap)."""
        self.params = params

    def before_param_update(self):
        """Call before updating the hooks' params IN PLACE (the trainer
        does, before each optimiser step): an async refresh in flight
        must have read the launch-time weights first.  On a card the
        current stream waits for the refresh's last read (no host
        wait beyond the worker issuing it); on the CPU this waits for
        the read itself."""
        fl = self._flight
        if fl is None or fl.held:
            return
        t0 = time.perf_counter()
        fl.reads_issued.wait(self.cfg.refresh_timeout)
        if fl.reads_event is not None and fl.reads_issued.is_set():
            torch.cuda.current_stream(self.device).wait_event(fl.reads_event)
        fl.held = True
        fl.record["wait_s"] += time.perf_counter() - t0

    # -- features -----------------------------------------------------------

    @torch.no_grad()
    def _compute_features_scaled(self, params: Any = None, store=None,
                                 live=None):
        """(features, scale) of a whole-store embed in ``feature_batch``
        chunks, with no attribute writes (an async worker runs it on the
        launch-time snapshot).  Dead rows (``live`` False) are zeroed
        before the scale is derived.  Symmetric families row-normalise
        and return scale None; asymmetric ones augment under a scale
        derived from these features and return it."""
        params = self.params if params is None else params
        store = self.store if store is None else store
        w, fb = self.row_width, self.feature_batch
        raw = torch.cat([to_local_replicated(
            self.feature_fn(params, store[i:i + fb, :w - 1]))
            for i in range(0, store.shape[0], fb)])
        if live is not None:
            raw = torch.where(live[:, None], raw, 0.0)
        if not self.family.asymmetric:
            return normalize_rows(raw), None
        scale = self.family.data_scale(raw)
        return self.family.augment_data(raw, scale=scale), scale

    def _compute_features(self, params: Any = None) -> torch.Tensor:
        """Embed every example for hashing, pinning the asymmetric
        family's scale (the build, synchronous and restore paths)."""
        feats, scale = self._compute_features_scaled(params,
                                                     live=self._live_dev)
        if self.family.asymmetric:
            self._feat_scale = scale
        return feats

    @torch.no_grad()
    def _embed_rows(self, ids: torch.Tensor, params: Any, scale=None,
                    store=None) -> torch.Tensor:
        """Embed a subset of rows (delta refresh, append, reconcile) in
        the same chunks as a whole-store embed, augmented at ``scale``
        (the pinned scale of the indexed vectors)."""
        store = self.store if store is None else store
        rows = store.index_select(0, ids)[:, :self.row_width - 1]
        fb = self.feature_batch
        raw = torch.cat([to_local_replicated(
            self.feature_fn(params, rows[i:i + fb]))
            for i in range(0, rows.shape[0], fb)])
        if not self.family.asymmetric:
            return normalize_rows(raw)
        return self.family.augment_data(raw, scale=scale)

    # -- refresh ------------------------------------------------------------

    def _take_dirty(self) -> torch.Tensor:
        """Claim the dirty mask (and start a fresh one)."""
        dirty, self._dirty = self._dirty, self._no_dirt()
        return dirty

    def _drift_mask(self, counter: int, cap: int) -> torch.Tensor:
        """Refresh ``counter``'s drift draw: each row with probability
        ``drift_frac``, from the refresh stream (its own generator: a
        worker thread may draw while the step draws)."""
        if self._drift is not None:
            return self._drift(counter, cap).to(self.device)
        g = torch.Generator(device=self.device).manual_seed(
            _stream_seed(self.seed, _SALT_REFRESH, counter))
        return torch.rand((cap,), generator=g,
                          device=self.device) < self.cfg.drift_frac

    def _delta_refresh_values(self, counter: int, params: Any,
                              dirty: torch.Tensor, features: torch.Tensor,
                              index: LSHIndex, scale, store, live,
                              record: dict, on_reads: Callable):
        """(features, index) after a delta refresh of the ``dirty`` rows,
        widened by the drift draw and narrowed to the live rows; pure in
        its inputs.  The dirty count is read on the host (the refresh's
        one sync) to pick its power-of-two id bucket; padding repeats the
        first dirty id (equal rows, equal codes: a merge no-op)."""
        cap = dirty.shape[0]
        if self.cfg.drift_frac > 0.0:
            dirty = dirty | self._drift_mask(counter, cap)
        if live is not None:
            dirty = dirty & live
        ids = torch.nonzero(dirty).flatten()
        nd = ids.shape[0]
        record["rows"] = 0
        if nd == 0:
            on_reads()
            return features, index
        size = min(_dirty_bucket(nd), cap)
        ids = torch.cat([ids, ids[:1].expand(size - nd)])
        feats_d = self._embed_rows(ids, params, scale=scale, store=store)
        on_reads()
        record["rows"] = size
        codes_d = hash_points(feats_d, index.projections, self.lsh)
        return (features.index_copy(0, ids, feats_d),
                mutate_index(index, IndexMutation("delta", ids=ids,
                                                  codes=codes_d)))

    # -- refresh resilience --------------------------------------------------

    def set_fault_injector(self, injector):
        """Install a fault injector (None clears): any object with
        ``fire(event, **info)``.  The pipeline fires ``refresh_compute``
        (each refresh attempt) and ``recover_rebuild`` (each recovery
        attempt)."""
        self.fault_injector = injector

    def _fault(self, event: str, **info):
        if self.fault_injector is not None:
            self.fault_injector.fire(event, **info)

    def _sleep_backoff(self, attempt: int):
        """Exponential backoff with jitter that is a pure function of
        (refresh count, attempt), as in the reference."""
        base = self.cfg.refresh_backoff
        if base <= 0 or attempt <= 0:
            return
        j = (zlib.crc32(f"{self._refresh_count}:{attempt}".encode())
             % 1000) / 1000.0
        time.sleep(base * (2 ** (attempt - 1)) * (1.0 + 0.5 * j))

    def _attempt_refresh(self, counter, full, dirty, params, features, index,
                         scale, store, live, attempt: int, record: dict,
                         on_reads: Callable = lambda: None):
        """ONE refresh attempt on explicit inputs -> (features, index,
        scale), with no attribute writes, so a failed attempt leaves
        nothing half committed.  ``on_reads`` runs after the last read of
        ``params``."""
        self._fault("refresh_compute", refresh=self._refresh_count,
                    attempt=attempt)
        if not full:
            feats, new_index = self._delta_refresh_values(
                counter, params, dirty, features, index, scale, store, live,
                record, on_reads)
            return feats, new_index, scale
        feats, new_scale = self._compute_features_scaled(
            params, store=store, live=live)
        on_reads()
        record["rows"] = store.shape[0]
        new_index = mutate_index(
            index, IndexMutation("refresh", x_aug=feats, live_mask=live,
                                 warm_start=True), self.lsh)
        return feats, new_index, new_scale

    @contextlib.contextmanager
    def _on_stream(self, stream):
        """Run on ``stream`` (a CUDA stream, in any thread) or as is."""
        if stream is None:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(stream):
            yield

    def _guarded(self, thunk):
        """Run ``thunk`` under the hang watchdog: with ``refresh_timeout``
        set it runs on a daemon thread (on the caller's stream) and a run
        past the timeout raises TimeoutError here; the abandoned worker
        only ever writes its private box."""
        if self.cfg.refresh_timeout is None:
            return thunk()
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        box: dict = {}

        def work():
            try:
                with self._on_stream(stream):
                    box["result"] = thunk()
            except BaseException as e:   # noqa: BLE001 — raised below
                box["error"] = e

        t = threading.Thread(target=work, daemon=True)
        t.start()
        t.join(self.cfg.refresh_timeout)
        if t.is_alive():
            raise TimeoutError(
                f"refresh attempt exceeded watchdog timeout "
                f"{self.cfg.refresh_timeout}s; worker abandoned")
        if "error" in box:
            raise box.pop("error")
        return box["result"]

    def _commit(self, feats, index, scale):
        self.features, self.index = feats, index
        if self.family.asymmetric:
            self._feat_scale = scale
        self.health.note_refresh_success(self._step)

    def _retry_refresh(self, counter, full, dirty, params, features, index,
                       scale, store, live, record: dict, first_error=None,
                       start_attempt=0) -> bool:
        """The retry loop around a refresh; commits (features, index,
        scale) together on success and returns True.  Exhausted retries
        keep the last good buffer (stale-index mode) and return False."""
        attempts = 1 + self.cfg.refresh_retries
        err = first_error
        for attempt in range(start_attempt, attempts):
            self._sleep_backoff(attempt)
            try:
                result = self._guarded(lambda: self._attempt_refresh(
                    counter, full, dirty, params, features, index, scale,
                    store, live, attempt, record))
            except Exception as e:       # noqa: BLE001 — any failure retries
                err = repr(e)     # not the exception: its frames hold tensors
                log.warning("refresh %d attempt %d failed",
                            self._refresh_count, attempt, exc_info=True)
                continue
            self._commit(*result)
            record["ok"] = True
            return True
        log.warning("refresh %d failed after %d attempt(s); keeping the "
                    "stale index (last error: %s)", self._refresh_count,
                    attempts - start_attempt, err)
        self.health.note_refresh_failure(self._step, str(err))
        record["ok"] = False
        return False

    def _record(self, full: bool, asynchronous: bool) -> dict:
        rec = {"refresh": self._refresh_count, "step": self._step,
               "full": full, "async": asynchronous, "rows": None,
               "ok": None, "wait_s": 0.0, "events": None, "timed": False}
        if self.device.type == "cuda":
            rec["events"] = tuple(torch.cuda.Event(enable_timing=True)
                                  for _ in range(2))
        self._records.append(rec)
        return rec

    def refresh(self, full: Optional[bool] = None) -> bool:
        """Re-embed and re-hash synchronously: ``full=None`` follows
        ``refresh_mode``, ``full=True`` forces the whole-store path.
        Both re-sort through the previous order (warm start / delta
        merge).  Failed attempts retry with backoff; on exhaustion the
        last good buffer stays live and this returns False."""
        full = (self.cfg.refresh_mode != "delta") if full is None else full
        rec = self._record(full, False)
        if rec["events"] is not None:
            rec["events"][0].record()
        dirty = self._take_dirty()
        ok = self._retry_refresh(self._refresh_count, full, dirty,
                                 self.params, self.features, self.index,
                                 self._feat_scale, self.store,
                                 self._live_dev, rec)
        if rec["events"] is not None:
            rec["events"][1].record()
            rec["timed"] = True
        self._refresh_count += 1
        return ok

    def _launch_refresh(self):
        """Start the double-buffered refresh on a worker thread."""
        if self._flight is not None:
            return
        full = self.cfg.refresh_mode != "delta"
        dirty = self._take_dirty()    # delta dirt is claimed at launch
        # the worker computes on the LAUNCH-time store and membership;
        # mutations during the flight replace the live buffers (never
        # in place) and are merged at the swap
        snap = (self._refresh_count, full, dirty, self.params,
                self.features, self.index, self._feat_scale, self.store,
                self._live_dev, self.capacity)
        stream = None
        if self.device.type == "cuda":
            if self._side_stream is None:
                self._side_stream = torch.cuda.Stream(self.device)
            stream = self._side_stream
        fl = _Flight(snap, self._record(full, True), stream)
        launched = None
        if stream is not None:
            launched = torch.cuda.current_stream(self.device).record_event()
            fl.reads_event = torch.cuda.Event()
        self._touched = set()

        def on_reads():
            if fl.reads_event is not None:
                fl.reads_event.record(stream)
            fl.reads_issued.set()

        def work():
            (counter, full_, dirty_, params, feats, index, scale, store,
             live, _) = snap
            try:
                with self._on_stream(stream), \
                        (self._refresh_lock or contextlib.nullcontext()):
                    if stream is not None:
                        stream.wait_event(launched)
                        # inputs made on the step's stream stay allocated
                        # until this stream's reads are done
                        for x in (dirty_, feats, store, *index) + (
                                () if live is None else (live,)):
                            x.record_stream(stream)
                        fl.record["events"][0].record(stream)
                    fl.box["result"] = self._attempt_refresh(
                        counter, full_, dirty_, params, feats, index, scale,
                        store, live, 0, fl.record, on_reads)
                    if stream is not None:
                        fl.record["events"][1].record(stream)
                        fl.record["timed"] = True
            except BaseException as e:   # noqa: BLE001 — handled at the swap
                fl.box["error"] = e
            finally:
                fl.reads_issued.set()

        fl.thread = threading.Thread(target=work, daemon=True)
        self._flight = fl
        fl.thread.start()
        if _reads_collectively(self.params):
            # the hooks' forward issues collectives, which every rank
            # must issue in one order: the worker's host work ends here,
            # before the step's (on a card its device work still runs on
            # its own stream).  A worker past the watchdog would issue
            # them beside the step's: that is a failure, not a retry
            fl.thread.join(self.cfg.refresh_timeout)
            if fl.thread.is_alive():
                raise RuntimeError(
                    f"async refresh of a model on a mesh still running "
                    f"after the watchdog ({self.cfg.refresh_timeout}s): its "
                    f"collectives would interleave with the step's")

    def _swap_refresh(self):
        """Join the in-flight refresh and swap buffers (fixed boundary).

        A worker that errored is retried synchronously on the same
        inputs, with backoff; one that hangs past ``refresh_timeout`` is
        abandoned and counts as a failed attempt.  Exhausted retries
        leave the last good buffer live (stale-index mode)."""
        fl = self._flight
        if fl is None:               # e.g. a fresh restore: the sync path
            self.refresh()
            return
        t0 = time.perf_counter()
        fl.thread.join(self.cfg.refresh_timeout)
        hung = fl.thread.is_alive()
        self._flight = None
        cur = (torch.cuda.current_stream(self.device)
               if fl.stream is not None else None)
        if cur is not None and not hung:
            cur.wait_stream(fl.stream)
        fl.record["wait_s"] += time.perf_counter() - t0
        (counter, full, dirty, params, features, index, scale, store, live,
         snap_capacity) = fl.snapshot
        rec = fl.record
        if self.streaming and snap_capacity != self.capacity:
            # a grow or compaction landed during the flight: the worker's
            # buffers have the wrong capacity (and compaction remapped
            # slots); refresh synchronously on CURRENT state, full path
            self._touched = set()
            self._retry_refresh(counter, True, self._no_dirt(), self.params,
                                self.features, self.index, self._feat_scale,
                                self.store, self._live_dev, rec)
            self._refresh_count += 1
            return
        if hung or "error" in fl.box:
            err = fl.box.pop("error", None)
            if hung:
                err = TimeoutError(
                    f"async refresh worker hung past the swap boundary "
                    f"(watchdog {self.cfg.refresh_timeout}s); abandoned")
                log.warning("%s", err)
            ok = self._retry_refresh(counter, full, dirty, self.params,
                                     features, index, scale, store, live,
                                     rec, first_error=repr(err),
                                     start_attempt=1)
        else:
            feats, new_index, new_scale = fl.box.pop("result")
            if cur is not None:     # made on the refresh's stream
                for x in (feats, *new_index):
                    x.record_stream(cur)
            self._commit(feats, new_index, new_scale)
            rec["ok"] = ok = True
        if self.streaming:
            if ok:
                # the committed buffers predate the flight's mutations
                self._reconcile_touched()
            else:
                # the live buffers already carry every mutation
                self._touched = set()
        self._refresh_count += 1

    def _reconcile_touched(self):
        """Merge the mutations made during a flight into its committed
        result: touched live slots are re-embedded from the CURRENT store
        at the committed scale, touched dead slots get the sentinel — one
        tie-stable merge for both."""
        touched = sorted(self._touched)
        self._touched = set()
        if not touched:
            return
        slots = np.asarray(touched, np.int64)
        live = self._live_np[slots]
        codes = torch.full((self.lsh.l, len(slots)), EMPTY_CODE,
                           dtype=torch.int64, device=self.device)
        if live.any():
            l_ids = torch.as_tensor(slots[live], device=self.device)
            feats = self._embed_rows(l_ids, self.params,
                                     scale=self._feat_scale)
            codes[:, torch.as_tensor(np.flatnonzero(live),
                                     device=self.device)] = hash_points(
                feats, self.index.projections, self.lsh)
            self.features = self.features.index_copy(0, l_ids, feats)
        ids_p, codes_p = _pad_mutation(slots, codes, self.capacity)
        self.index = mutate_index(
            self.index, IndexMutation("delta", ids=ids_p, codes=codes_p))

    def refresh_records(self) -> List[dict]:
        """One dict a refresh: ``refresh`` (its count), ``step``,
        ``full``, ``async``, ``rows`` (rows embedded; a delta's padded
        bucket), ``ok``, ``wait_s`` (host seconds the step path blocked
        on it: the parameter hook and the swap) and, on a card,
        ``device_ms``: its span on its stream between CUDA events.
        Syncs on the recorded events: read at log cadence."""
        out = []
        for rec in self._records:
            r = {k: v for k, v in rec.items() if k not in ("events", "timed")}
            ev = rec["events"]
            if rec["timed"]:
                ev[1].synchronize()
                r["device_ms"] = ev[0].elapsed_time(ev[1])
            out.append(r)
        return out

    def _canonical_build(self):
        """(features, index, scale) of a canonical rebuild: every row
        re-embedded, a fresh sort on the build's projections."""
        feats, scale = self._compute_features_scaled(self.params,
                                                     live=self._live_dev)
        return feats, self._build_index(feats), scale

    def _build_index(self, feats) -> LSHIndex:
        return mutate_index(None, IndexMutation(
            "build", projections=self.index.projections, x_aug=feats,
            live_mask=self._live_dev), self.lsh)

    def _attempt_recovery(self) -> bool:
        """Uniform-fallback -> healthy: a full CANONICAL rebuild (not the
        warm-start chain the failed refreshes broke).  A failure stays in
        uniform-fallback until the next ``recover_after`` boundary."""
        def build():
            self._fault("recover_rebuild", step=self._step)
            return self._canonical_build()

        try:
            feats, idx, scale = self._guarded(build)
        except Exception:                # noqa: BLE001
            log.warning("recovery rebuild failed at step %d", self._step,
                        exc_info=True)
            self.health.refresh_failures += 1
            return False
        self.features, self.index = feats, idx
        if self.family.asymmetric:
            self._feat_scale = scale
        self._dirty = self._no_dirt()
        self.health.note_recovered(self._step)
        log.info("recovered at step %d: index rebuilt", self._step)
        return True

    def _discard_refresh(self):
        """Abandon an in-flight refresh (it writes only its own box):
        uniform-fallback suspends the refresh schedule."""
        self._flight = None

    def note_loss(self, finite: bool):
        """Trainer hook: per-step loss finiteness feeds the ladder."""
        pre = self.health.state
        self.health.note_loss(self._step, finite)
        if self.health.state != pre and self.health.state == UNIFORM_FALLBACK:
            self._discard_refresh()

    def check_health(self):
        """Feed the latest batch's fallback rate into the ladder (syncs a
        device scalar: call at log cadence) and return the state."""
        pre = self.health.state
        if self._stat_draws > 0 and pre != UNIFORM_FALLBACK:
            self.health.note_fallback_rate(self._step,
                                           float(self._last_fallback))
            if self.health.state == UNIFORM_FALLBACK:
                self._discard_refresh()
        return self.health.state

    def health_state(self) -> str:
        return self.health.state

    def health_summary(self) -> dict:
        return self.health.summary()

    def finalize(self):
        """Join an in-flight refresh (the trainer's teardown hook).  A
        worker failure that had not reached its swap boundary is folded
        into the health state and logged, not raised."""
        fl = self._flight
        if fl is None:
            return
        fl.thread.join(self.cfg.refresh_timeout)
        self._discard_refresh()
        if "error" in fl.box:
            log.warning("in-flight refresh failed at teardown: %r",
                        fl.box["error"])
            self.health.note_refresh_failure(self._step,
                                             repr(fl.box.pop("error")))

    def _maybe_refresh(self):
        re = self.cfg.refresh_every
        if re <= 0:
            return
        s = self._step
        if self.cfg.refresh_async and self.cfg.refresh_lead > 0:
            lead = min(self.cfg.refresh_lead, re - 1)
            if s + lead >= re and (s + lead) % re == 0:
                self._launch_refresh()
            if s >= re and s % re == 0:
                self._swap_refresh()
        elif s >= re and s % re == 0:
            self.refresh()

    # -- batches ------------------------------------------------------------

    def _tick(self) -> torch.Generator:
        """Refresh gate (in uniform-fallback: the recovery cadence) and
        the generator of this step's draws, which advances the same way
        in every health state."""
        if self.health.state == UNIFORM_FALLBACK:
            if self.health.should_attempt_recovery(self._step):
                self._attempt_recovery()
        else:
            self._maybe_refresh()
        gen = self._seeded(_SALT_STEP, self._step)
        self._step += 1
        return gen

    def _uniform_batch(self, gen, m: int, draws: Optional[SampleDraws]):
        """Uniform-fallback draw: m uniform rows with weight 1, unbiased
        by construction.  Streaming: uniform over the live rows, slot u
        of table 0's live prefix.  ``draws.fallback`` replaces the
        uniform draw (the injection hook)."""
        n = self._n_live
        u = (torch.randint(0, n, (m,), generator=gen, device=self.device)
             if draws is None else draws.fallback.reshape(-1).to(self.device))
        idx = self.index.order[0, u] if self.streaming else u
        rows = self.store.index_select(0, idx)[:, :self.row_width]
        self._mark_dirty(idx)
        return {
            "tokens": rows[:, :-1],
            "targets": rows[:, 1:],
            "loss_weights": torch.ones((m,), device=self.device),
            "example_ids": idx + self.example_offset,
        }

    def restore_at(self, step: int, rebuild: bool = True):
        """Deterministic resume: rewind the counters to ``step`` and
        rebuild the index canonically (the build's projections, freshly
        embedded features, a fresh sort — not the history-dependent
        warm-start chain), with an empty dirty mask and a healthy ladder.
        Two restores at the same step are bitwise equal, and so are the
        batches they draw.

        ``rebuild=False`` skips the re-embed; valid only right after
        construction from the same params.  Streaming: the mutation log
        is truncated to entries with step <= ``step`` and its membership
        replayed (window evictions, growth and compaction re-derived, no
        embeds); a non-empty replay forces the rebuild."""
        self.finalize()
        if self.streaming:
            kept = [e for e in self._mutlog if e["step"] <= step]
            self._init_membership(self.tokens)
            for e in kept:
                if e["op"] == "append":
                    self._apply_append(e["tokens"], with_index=False)
                else:
                    self._apply_evict(
                        np.asarray(e["ids"], np.int64) - self.example_offset,
                        with_index=False)
            self._mutlog = kept
            self._touched = set()
            if kept:
                rebuild = True
        re = self.cfg.refresh_every
        self._step = step
        self._refresh_count = 0 if re <= 0 or step < 1 else (step - 1) // re
        self._dirty = self._no_dirt()
        self.health = HealthMonitor(self._health_cfg)
        if rebuild:
            self.features = self._compute_features()
            self.index = self._build_index(self.features)

    # -- index mutations (the unified entry point) ---------------------------

    def _require_streaming(self, what: str):
        if not self.streaming:
            raise ValueError(
                f"{what} requires streaming=True (or window=) in "
                f"LSHPipelineConfig")

    def mutate(self, mutation: IndexMutation):
        """THE index-mutation entry point (an explicit op):

          * ``append`` — ``tokens`` (B, S+1): add rows (streaming);
            returns the assigned global example ids;
          * ``evict`` — ``ids``: remove rows by global id (streaming);
          * ``delta`` — refresh the visited and drift rows
            (``refresh(full=False)``);
          * ``refresh`` — a full warm refresh (``refresh(full=True)``);
          * ``build`` — a canonical rebuild (what ``restore_at`` and the
            recovery do); discards an in-flight async refresh.

        ``build`` / ``refresh`` / ``delta`` run synchronously here; the
        periodic schedule is unchanged."""
        op = mutation.op
        if op == "append":
            if mutation.tokens is None:
                raise ValueError("mutate(append) needs tokens=")
            return self.append_rows(mutation.tokens)
        if op == "evict":
            if mutation.ids is None:
                raise ValueError("mutate(evict) needs ids=")
            return self.evict_rows(np.asarray(mutation.ids))
        if op == "refresh":
            return self.refresh(full=True)
        if op == "delta":
            return self.refresh(full=False)
        return self._canonical_rebuild()   # op == "build"

    def append_rows(self, tokens) -> np.ndarray:
        """Append token rows to the live window (streaming only): embedded
        at the pinned scale, hashed and merged tie-stably; with
        ``window`` the oldest live rows are evicted first.  Logged for
        ``restore_at``.  Returns the global example ids (slot +
        ``example_offset``; slots are reused after eviction)."""
        self._require_streaming("append_rows")
        tokens = np.asarray(tokens, np.int32)
        slots = self._apply_append(tokens, with_index=True)
        self._mutlog.append({"op": "append", "step": self._step,
                             "tokens": tokens.copy()})
        return slots + self.example_offset

    def evict_rows(self, ids) -> None:
        """Evict rows by global example id (streaming only): a sentinel
        merge moves their slots past every table's live prefix.  Logged
        for ``restore_at``."""
        self._require_streaming("evict_rows")
        ids = np.asarray(ids, np.int64).reshape(-1)
        self._apply_evict(ids - self.example_offset, with_index=True)
        self._mutlog.append({"op": "evict", "step": self._step,
                             "ids": ids.copy()})

    def _apply_append(self, tokens: np.ndarray,
                      with_index: bool) -> np.ndarray:
        """Membership append (and, ``with_index``, the index merge) —
        shared by the live path and the restore replay, so window
        evictions, growth and slot assignment re-derive identically."""
        if tokens.ndim != 2 or tokens.shape[1] != self.row_width:
            raise ValueError(
                f"append tokens must be (B, {self.row_width}), "
                f"got {tokens.shape}")
        b = tokens.shape[0]
        if b < 1:
            raise ValueError("append needs at least one row")
        w = self.cfg.window
        if w is not None:
            if b > w:
                raise ValueError(f"append batch {b} exceeds window {w}")
            over = self._n_live + b - w
            if over > 0:
                live_slots = np.flatnonzero(self._live_np)
                oldest = live_slots[np.argsort(
                    self._arrival[live_slots], kind="stable")][:over]
                self._apply_evict(oldest, with_index=with_index)
        if self._n_live + b > self.capacity:
            self._grow(_next_pow2(self._n_live + b), with_index)
        self._free.sort()
        slots = np.asarray(self._free[:b], np.int64)
        del self._free[:b]
        jslots = torch.as_tensor(slots, device=self.device)
        # out of place: an async refresh reads the launch-time store
        self.store = self.store.index_copy(
            0, jslots, torch.as_tensor(tokens).to(self.device))
        self._live_np[slots] = True
        self._arrival[slots] = np.arange(self._next_arrival,
                                         self._next_arrival + b)
        self._next_arrival += b
        self._n_live += b
        self._sync_live_dev()
        if with_index:
            feats = self._embed_rows(jslots, self.params,
                                     scale=self._feat_scale)
            codes = hash_points(feats, self.index.projections, self.lsh)
            self.features = self.features.index_copy(0, jslots, feats)
            ids_p, codes_p = _pad_mutation(slots, codes, self.capacity)
            self.index = mutate_index(
                self.index, IndexMutation("append", ids=ids_p,
                                          codes=codes_p))
            if self._flight is not None:
                self._touched.update(int(s) for s in slots)
        return slots

    def _apply_evict(self, slots: np.ndarray, with_index: bool):
        """Membership evict (and, ``with_index``, the sentinel merge) —
        the live path, the window's auto-evict and the restore replay."""
        slots = np.asarray(slots, np.int64).reshape(-1)
        if slots.size == 0:
            return
        if np.unique(slots).size != slots.size:
            raise ValueError("duplicate ids in evict batch")
        if ((slots < 0) | (slots >= self.capacity)).any() or \
                not self._live_np[slots].all():
            raise ValueError("evict of unknown or already-dead rows")
        self._live_np[slots] = False
        self._arrival[slots] = -1
        self._free.extend(int(s) for s in slots)
        self._n_live -= int(slots.size)
        self._sync_live_dev()
        if with_index:
            size = min(_dirty_bucket(int(slots.size)), self.capacity)
            ids_p = np.concatenate(
                [slots, np.full((size - slots.size,), slots[0])])
            self.index = mutate_index(self.index, IndexMutation(
                "evict", ids=torch.as_tensor(ids_p, device=self.device)))
            if self._flight is not None:
                self._touched.update(int(s) for s in slots)
        self._maybe_compact(with_index)

    def _grow(self, new_cap: int, with_index: bool):
        """Grow every capacity-sized buffer to ``new_cap`` (a power of
        two); existing slots keep their ids."""
        pad = new_cap - self.capacity
        self.store = torch.cat([self.store, self.store.new_zeros(
            (pad, self.store.shape[1]))])
        self._live_np = np.concatenate(
            [self._live_np, np.zeros((pad,), np.bool_)])
        self._arrival = np.concatenate(
            [self._arrival, np.full((pad,), -1, np.int64)])
        self._free.extend(range(self.capacity, new_cap))
        if with_index:
            self.features = torch.cat([self.features, self.features.new_zeros(
                (pad, self.features.shape[1]))])
            self._dirty = torch.cat([self._dirty,
                                     self._dirty.new_zeros((pad,))])
            self.index = grow_index(self.index, new_cap)
        self.capacity = new_cap
        self._sync_live_dev()

    def _maybe_compact(self, with_index: bool):
        """Halve capacity once live occupancy drops to a quarter (grow
        doubles at full, so the two never thrash).  Live rows are packed
        into the prefix in slot order — slot ids CHANGE — and the index
        is rebuilt canonically over the packed features."""
        if not (self._n_live <= self.capacity // 4
                and self.capacity > self.cfg.min_capacity):
            return
        new_cap = self.capacity // 2
        while (self._n_live <= new_cap // 4
               and new_cap > self.cfg.min_capacity):
            new_cap //= 2
        new_cap = max(new_cap, self.cfg.min_capacity)
        live_slots = np.flatnonzero(self._live_np)
        dead_slots = np.flatnonzero(~self._live_np)
        perm = torch.as_tensor(np.concatenate([live_slots, dead_slots])[
            :new_cap], device=self.device)
        nl = int(live_slots.size)
        self.store = self.store.index_select(0, perm)
        new_live = np.zeros((new_cap,), np.bool_)
        new_live[:nl] = True
        new_arrival = np.full((new_cap,), -1, np.int64)
        new_arrival[:nl] = self._arrival[live_slots]
        self._live_np, self._arrival = new_live, new_arrival
        self._free = list(range(nl, new_cap))
        self.capacity = new_cap
        self._sync_live_dev()
        if with_index:
            self.features = self.features.index_select(0, perm)
            self._dirty = self._dirty.index_select(0, perm) & self._live_dev
            self.index = self._build_index(self.features)

    def _canonical_rebuild(self) -> bool:
        """``mutate(build)``: re-embed everything and sort afresh on the
        build's projections (the restore / recovery construction)."""
        self._discard_refresh()
        self.features = self._compute_features()
        self.index = self._build_index(self.features)
        self._dirty = self._no_dirt()
        return True

    def mutation_log(self) -> list:
        """The explicit-mutation log as JSON-serialisable entries
        (``load_mutation_log`` + ``restore_at`` replay it)."""
        out = []
        for e in self._mutlog:
            if e["op"] == "append":
                out.append({"op": "append", "step": int(e["step"]),
                            "tokens": np.asarray(e["tokens"],
                                                 np.int32).tolist()})
            else:
                out.append({"op": "evict", "step": int(e["step"]),
                            "ids": [int(i) for i in e["ids"]]})
        return out

    def load_mutation_log(self, entries):
        """Install a mutation log; the next ``restore_at`` replays it
        (membership only) before the canonical rebuild."""
        self._require_streaming("load_mutation_log")
        norm = []
        for e in entries:
            if e["op"] == "append":
                norm.append({"op": "append", "step": int(e["step"]),
                             "tokens": np.asarray(e["tokens"], np.int32)})
            elif e["op"] == "evict":
                norm.append({"op": "evict", "step": int(e["step"]),
                             "ids": np.asarray(e["ids"], np.int64)})
            else:
                raise ValueError(f"unknown mutation-log op {e['op']!r}")
        self._mutlog = norm

    @torch.no_grad()
    def _query(self) -> torch.Tensor:
        # SRP normalises the query, MIPS appends the zero coordinate
        return self.family.augment_query(
            to_local_replicated(self.query_fn(self.params)))

    def _mark_dirty(self, indices: torch.Tensor):
        if self._track_dirty:
            self._dirty[indices.reshape(-1)] = True

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
        ``draws``, ``fallback_rate`` (uniform fallbacks),
        ``primary_miss_rate`` (exact bucket empty) and
        ``last_fallback_rate`` (the latest batch)."""
        d = max(self._stat_draws, 1)
        return {
            "draws": self._stat_draws,
            "fallback_rate": float(self._fallback_sum) / d,
            "primary_miss_rate": float(self._primary_miss_sum) / d,
            "last_fallback_rate": float(self._last_fallback),
        }

    @torch.no_grad()
    def index_stats(self) -> Dict[str, Any]:
        """The fallback diagnostics of the live index (syncs): the
        cumulative ``sampler_stats``, ``buckets_per_table`` (distinct
        codes among each table's live rows) and ``query_feature_cos``
        (the cosine of the current query to the mean live feature): a
        query drifting away from the features, into empty buckets, shows
        here before the fallback share rises."""
        st = self.sampler_stats()
        sc = self.index.sorted_codes
        n = self._n_live if self.streaming else sc.shape[1]
        live_sc = sc[:, :n]
        buckets = ((live_sc[:, 1:] != live_sc[:, :-1]).sum(1) + 1
                   if n else torch.zeros(sc.shape[0], dtype=torch.int64))
        feats = self.features.double()
        if self.streaming:
            feats = feats[self._live_dev]
        q = self._query().double()
        mean = feats.mean(0)
        cos = float(q @ mean / torch.clamp(q.norm() * mean.norm(),
                                           min=1e-30))
        return dict(st, buckets_per_table=[int(b) for b in buckets.cpu()],
                    query_feature_cos=cos)

    def _draw_args(self):
        return dict(m=self.cfg.minibatch, example_offset=self.example_offset,
                    multiprobe=self.cfg.multiprobe, p_floor=self.cfg.p_floor,
                    normalize=self.cfg.normalize_weights,
                    row_width=self.row_width,
                    n_live=self._n_live if self.streaming else None)

    def _check_window(self):
        if self.streaming and self._n_live == 0:
            raise RuntimeError("cannot draw a batch from an empty streaming "
                               "window (append rows first)")

    def next_batch(self, query: Optional[torch.Tensor] = None,
                   draws: Optional[SampleDraws] = None
                   ) -> Dict[str, torch.Tensor]:
        """Draw one batch on the device.  ``query`` (already augmented)
        replaces the hook's; ``draws`` replaces this step's generator
        draws (the parity tests' injection hook)."""
        self._check_window()
        gen = self._tick()
        if self.health.state == UNIFORM_FALLBACK:
            return self._uniform_batch(gen, self.cfg.minibatch, draws)
        q = self._query() if query is None else query
        gb = sample_gather(gen, self.index, self.features, q, self.store,
                           self.lsh, draws=draws, **self._draw_args())
        self._mark_dirty(gb.indices)
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
        self._check_window()
        gen = self._tick()
        c, m = queries.shape[0], self.cfg.minibatch
        if self.health.state == UNIFORM_FALLBACK:
            big = self._uniform_batch(gen, c * m, draws)
            return [{k: v[i * m:(i + 1) * m] for k, v in big.items()}
                    for i in range(c)]
        gb = sample_gather_batched(
            gen, self.index, self.features,
            self.family.augment_query(queries), self.store, self.lsh,
            draws=draws, **self._draw_args())           # fields (C, m, ...)
        self._mark_dirty(gb.indices)
        self._accum_stats(gb)
        return [{
            "tokens": gb.tokens[i],
            "targets": gb.targets[i],
            "loss_weights": gb.loss_weights[i],
            "example_ids": gb.example_ids[i],
        } for i in range(c)]


class ShardedLSHPipeline:
    """Shard-by-example LGD: one LSH index per corpus shard, in one
    process on one device (the reference's single-controller
    ``ShardedLSHPipeline`` with ``mesh=None``).

    The global corpus (N rows) is split into ``n_shards`` contiguous
    shards (``example_shard_bounds``); shard s owns an
    ``LSHSampledPipeline`` over its n_s rows whose seed is a function of
    (``seed``, s) alone.  Every global batch is the concatenation of
    equal per-shard sub-batches (``minibatch`` must divide by
    ``n_shards``): rows [s·m_s, (s+1)·m_s) are shard s's, and
    ``shard_ids`` says so.

    UNBIASEDNESS: shard s's local weight 1/(p·n_s) is rescaled by
    n_s·S/N, so w = S/(p·N) and the plain mean over the whole batch is
    the average of the shards' unbiased estimates of their shard means,
    an unbiased estimate of the corpus mean for any shard sizes.
    Streaming: n_s and N are the live counts at the draw.  With
    ``normalize_weights`` the composed weights are then scaled to mean 1
    over the global batch.

    Every shard refreshes on the shared schedule.  With
    ``refresh_async`` the S refreshes share one worker stream and a lock,
    so they run one after another: on one device that is what the
    reference's overlapping refreshes amount to, and S refreshes' embed
    activations never stand at once.  ``before_param_update`` orders
    every shard's refresh before the in-place update.

    Args:
      seed: shard s's pipeline seed is ``_stream_seed(seed, _SALT_SHARD,
        s)``, the counterpart of the reference's ``fold_in(key, s)``.
      tokens: (N, S+1) GLOBAL corpus.
      feature_fn / query_fn / config / feature_batch / params / device:
        as ``LSHSampledPipeline`` (``config.minibatch`` is the GLOBAL
        batch).
      n_shards: the number of per-shard indexes.
      mesh: a ``DeviceMesh``: the global batch is a DTensor under
        ``batch_sharding(mesh)`` (full ownership only; a partial owner's
        batch is its local slice).  None: a plain tensor on ``device``.
      owned_shards: the shard ids this pipeline builds and draws from
        (default all).  A partial owner's ``next_batch`` is its local
        slice of the global batch with the GLOBAL weights; partial
        ownership refuses ``streaming`` (the composition needs every
        shard's live count) and ``normalize_weights`` (a statistic of the
        global batch).  ``adopt_shards`` extends ownership.
      projections: given projections instead of the build streams'
        draws, indexed by GLOBAL shard id (the parity tests' hook).

    Determinism: shard s's draws depend only on (``seed``, s) and the
    params history, not on which shards a pipeline owns, so partial
    owners compose bitwise into full ownership.  A restore onto another
    ``n_shards`` goes through ``train.elastic.rebuild_sharded_pipeline``.
    """

    def __init__(
        self,
        seed: int,
        tokens: np.ndarray,
        feature_fn: Callable,
        query_fn: Callable,
        config: LSHPipelineConfig,
        n_shards: int = 1,
        feature_batch: int = 512,
        params: Any = None,
        owned_shards: Optional[Sequence[int]] = None,
        device="cuda",
        projections: Optional[Sequence[torch.Tensor]] = None,
        mesh=None,
    ):
        if config.minibatch % n_shards != 0:
            raise ValueError(
                f"minibatch={config.minibatch} must divide by "
                f"n_shards={n_shards}")
        if owned_shards is None:
            owned = list(range(n_shards))
        else:
            owned = sorted({int(s) for s in owned_shards})
            if not owned:
                raise ValueError("owned_shards must not be empty")
            bad = [s for s in owned if not 0 <= s < n_shards]
            if bad:
                raise ValueError(
                    f"owned_shards {bad} not in [0, {n_shards})")
        partial = len(owned) < n_shards
        if partial and config.streaming:
            raise ValueError(
                "owned_shards with streaming=True is unsupported: the "
                "sharded weight composition needs every shard's LIVE "
                "count, which a partial owner cannot observe — run "
                "streaming pipelines with full ownership per process "
                "group (n_shards == len(owned_shards))")
        if partial and config.normalize_weights:
            raise ValueError(
                "owned_shards with normalize_weights=True is "
                "unsupported: mean-1 normalisation is a statistic of "
                "the GLOBAL batch, which a partial owner never sees — "
                "normalise after the cross-process composition instead")
        self.cfg = config
        self.device = resolve_device(device)
        self.n = tokens.shape[0]
        self.n_shards = n_shards
        self.owned = owned
        self.mesh = mesh
        self.streaming = config.streaming
        self.feature_batch = feature_batch
        # adopt_shards rebuilds shards from the construction corpus
        self._seed = seed
        self._tokens = tokens
        self._feature_fn = feature_fn
        self._query_fn = query_fn
        self._projections = projections
        shard_window = None
        if config.streaming:
            if config.window is not None:
                if config.window % n_shards != 0:
                    raise ValueError(
                        f"window={config.window} must divide by "
                        f"n_shards={n_shards}")
                shard_window = config.window // n_shards
            if self.n // n_shards + 1 >= _SHARD_STRIDE:
                raise ValueError(
                    f"initial shard size {self.n // n_shards + 1} "
                    f"exceeds the streaming id stride {_SHARD_STRIDE}")
        self._shard_cfg = dataclasses.replace(
            config, minibatch=config.minibatch // n_shards,
            normalize_weights=False, window=shard_window)
        # one worker stream and one lock for every shard's async refresh
        self._refresh_lock = threading.Lock()
        self._side_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self.shards: List[LSHSampledPipeline] = [
            self._make_shard(s, params) for s in self.owned]

    def _make_shard(self, s: int, params: Any) -> LSHSampledPipeline:
        """Shard ``s``'s pipeline over its contiguous corpus slice, seeded
        by (seed, s) alone, alike on any owner."""
        lo, hi = example_shard_bounds(self.n, s, self.n_shards)
        # streaming shards address global ids by the fixed stride (ids
        # stay disjoint as windows advance); static shards keep the
        # contiguous bounds
        off = s * _SHARD_STRIDE if self.streaming else lo
        p = LSHSampledPipeline(
            _stream_seed(self._seed, _SALT_SHARD, s), self._tokens[lo:hi],
            self._feature_fn, self._query_fn, self._shard_cfg,
            feature_batch=self.feature_batch, params=params,
            example_offset=off,
            device=shard_store_device(self.device, s, self.n_shards,
                                      mesh=self.mesh),
            projections=(None if self._projections is None
                         else self._projections[s]))
        p._refresh_lock = self._refresh_lock
        p._side_stream = self._side_stream
        return p

    def adopt_shards(self, shard_ids: Sequence[int], step: int,
                     params: Any = None):
        """Take ownership of more shards (host-loss recovery): build each
        from the construction corpus with its own seed, embedded from
        ``params`` (default: the current params), and rewind it to
        ``step``.  ``n_shards`` and the bounds are unchanged, so the
        weights keep the exact S/(p·N) form; the adopted index is embedded
        from the current params, not the lost owner's refresh history,
        so mid-incident draws are not bit-reproducible (a rebuild from a
        checkpoint, ``rebuild_sharded_pipeline``, restores that)."""
        if self.streaming:
            raise ValueError(
                "adopt_shards requires a static corpus (streaming "
                "pipelines run fully-owned per process group)")
        params = self.params if params is None else params
        for s in sorted({int(x) for x in shard_ids}):
            if s in self.owned:
                raise ValueError(f"shard {s} is already owned")
            if not 0 <= s < self.n_shards:
                raise ValueError(
                    f"shard {s} not in [0, {self.n_shards})")
            p = self._make_shard(s, params)
            p.restore_at(step, rebuild=False)
            pos = int(np.searchsorted(np.asarray(self.owned), s))
            self.owned.insert(pos, s)
            self.shards.insert(pos, p)

    @property
    def params(self):
        return self.shards[0].params

    def set_params(self, params: Any):
        for p in self.shards:
            p.set_params(params)

    def before_param_update(self):
        """Every shard's in-flight refresh reads the launch-time weights
        before the in-place update (``LSHSampledPipeline``'s hook)."""
        for p in self.shards:
            p.before_param_update()

    def restore_at(self, step: int, rebuild: bool = True):
        """Rewind every owned shard to ``step`` (``restore_at`` each)."""
        for p in self.shards:
            p.restore_at(step, rebuild=rebuild)

    def finalize(self):
        for p in self.shards:
            p.finalize()

    def refresh(self, full: Optional[bool] = None):
        return [p.refresh(full=full) for p in self.shards]

    def refresh_records(self) -> List[dict]:
        """Every shard's ``refresh_records``, each with its ``shard``."""
        return [dict(r, shard=s) for s, p in zip(self.owned, self.shards)
                for r in p.refresh_records()]

    def build_device_ms(self) -> List[Optional[float]]:
        """Each owned shard's ``build_device_ms``."""
        return [p.build_device_ms() for p in self.shards]

    # -- index mutations (streaming) -----------------------------------------

    def mutate(self, mutation: IndexMutation):
        """``append`` / ``evict`` route across shards; the other ops
        apply to every shard."""
        op = mutation.op
        if op == "append":
            if mutation.tokens is None:
                raise ValueError("mutate(append) needs tokens=")
            return self.append_rows(mutation.tokens)
        if op == "evict":
            if mutation.ids is None:
                raise ValueError("mutate(evict) needs ids=")
            return self.evict_rows(np.asarray(mutation.ids))
        return [p.mutate(mutation) for p in self.shards]

    def append_rows(self, tokens) -> np.ndarray:
        """Append rows across shards (streaming): each row goes to the
        shard with the fewest live rows, ties to the lowest shard id, so
        the windows advance together.  Returns the global ids in row
        order."""
        if not self.streaming:
            raise ValueError(
                "append_rows requires streaming=True (or window=) in "
                "LSHPipelineConfig")
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim != 2:
            raise ValueError(f"append tokens must be 2-D, "
                             f"got {tokens.shape}")
        counts = [p.n_live for p in self.shards]
        owner = np.empty((tokens.shape[0],), np.int64)
        for i in range(tokens.shape[0]):
            s = int(np.argmin(counts))
            owner[i] = s
            counts[s] += 1
        gids = np.empty((tokens.shape[0],), np.int64)
        for s, p in enumerate(self.shards):
            rows = np.flatnonzero(owner == s)
            if rows.size:
                gids[rows] = p.append_rows(tokens[rows])
        return gids

    def evict_rows(self, ids) -> None:
        """Evict rows by global id (streaming), each routed to its shard
        by ``gid // stride``."""
        if not self.streaming:
            raise ValueError(
                "evict_rows requires streaming=True (or window=) in "
                "LSHPipelineConfig")
        ids = np.asarray(ids, np.int64).reshape(-1)
        owner = ids // _SHARD_STRIDE
        if ((owner < 0) | (owner >= self.n_shards)).any():
            raise ValueError("evict ids outside any shard's id range")
        for s, p in enumerate(self.shards):
            mine = ids[owner == s]
            if mine.size:
                p.evict_rows(mine)

    def mutation_log(self) -> dict:
        """The shards' mutation logs and the shard count they were routed
        under (a replay is valid only on the same ``n_shards``)."""
        return {"n_shards": self.n_shards,
                "shards": [p.mutation_log() for p in self.shards]}

    def load_mutation_log(self, entries: dict):
        if int(entries.get("n_shards", self.n_shards)) != self.n_shards:
            raise ValueError(
                f"mutation log was recorded under n_shards="
                f"{entries.get('n_shards')} but this pipeline has "
                f"n_shards={self.n_shards}; streaming elastic reshape "
                f"is not supported — restore on the recorded shard "
                f"count")
        for p, log_s in zip(self.shards, entries["shards"]):
            p.load_mutation_log(log_s)

    # -- health --------------------------------------------------------------

    def set_fault_injector(self, injector, shard: Optional[int] = None):
        """Install a fault injector on one shard, by GLOBAL shard id (it
        must be owned here), or on every owned shard (None)."""
        if shard is None:
            targets = self.shards
        else:
            if shard not in self.owned:
                raise ValueError(
                    f"shard {shard} is not owned here (owned: "
                    f"{self.owned})")
            targets = [self.shards[self.owned.index(shard)]]
        for p in targets:
            p.set_fault_injector(injector)

    def note_loss(self, finite: bool):
        for p in self.shards:
            p.note_loss(finite)

    def check_health(self) -> str:
        for p in self.shards:
            p.check_health()
        return self.health_state()

    def health_state(self) -> str:
        """The worst state across shards: one degraded shard degrades its
        share of every batch."""
        rank = {HEALTHY: 0, STALE_INDEX: 1, UNIFORM_FALLBACK: 2}
        worst = max(self.shards, key=lambda p: rank[p.health.state])
        return worst.health.state

    def health_summary(self) -> dict:
        per = [p.health_summary() for p in self.shards]
        return {
            "state": self.health_state(),
            "stale_refreshes": max(s["stale_refreshes"] for s in per),
            "refresh_failures": sum(s["refresh_failures"] for s in per),
            "recoveries": sum(s["recoveries"] for s in per),
            "transitions": [
                (shard_id,) + tuple(t)
                for shard_id, s in zip(self.owned, per)
                for t in s["transitions"]],
        }

    def sampler_stats(self) -> Dict[str, float]:
        """The shards' sampling diagnostics, weighted by their draws."""
        per = [p.sampler_stats() for p in self.shards]
        draws = sum(s["draws"] for s in per)
        d = max(draws, 1)
        return {
            "draws": draws,
            "fallback_rate": sum(
                s["fallback_rate"] * s["draws"] for s in per) / d,
            "primary_miss_rate": sum(
                s["primary_miss_rate"] * s["draws"] for s in per) / d,
            "last_fallback_rate": float(
                np.mean([s["last_fallback_rate"] for s in per])),
        }

    def index_stats(self) -> Dict[str, Any]:
        """The owned shards' ``index_stats``, under ``shards``, beside
        the composed ``sampler_stats``."""
        return dict(self.sampler_stats(),
                    shards=[dict(p.index_stats(), shard=s)
                            for s, p in zip(self.owned, self.shards)])

    # -- batches ------------------------------------------------------------

    def next_batch(self, query: Optional[torch.Tensor] = None,
                   draws: Optional[Sequence[SampleDraws]] = None
                   ) -> Dict[str, torch.Tensor]:
        """One global batch (the owned shards' slice of it).  The query
        is computed once and shared by every shard; ``query`` (already
        augmented) replaces the hook's, and ``draws`` (one an owned
        shard, in shard order) the shards' generator draws (the parity
        tests' hooks)."""
        q = self.shards[0]._query() if query is None else query
        subs = [p.next_batch(query=q,
                             draws=None if draws is None else draws[i])
                for i, p in enumerate(self.shards)]
        m_s = self.cfg.minibatch // self.n_shards
        batch = {k: self._compose([b[k] for b in subs])
                 for k in ("tokens", "targets", "example_ids")}
        # local 1/(p·n_s) -> global S/(p·N): each sample stands in for
        # N/S corpus rows under the batch mean; streaming takes the live
        # counts at this draw
        if self.streaming:
            total_live = sum(p.n_live for p in self.shards)
            scales = [p.n_live * self.n_shards / total_live
                      for p in self.shards]
        else:
            scales = [p.n * self.n_shards / self.n for p in self.shards]
        w = self._compose(
            [b["loss_weights"] * sc for b, sc in zip(subs, scales)])
        if self.cfg.normalize_weights:
            w = w / torch.clamp(w.mean(), min=1e-30)
        batch["loss_weights"] = w.to(torch.float32)
        batch["shard_ids"] = self._compose(
            [torch.full((m_s,), s, dtype=torch.int32, device=self.device)
             for s in self.owned])
        return batch

    def _compose(self, parts: list) -> torch.Tensor:
        # the mesh composition lays out the FULL global batch; a partial
        # owner's batch is its local slice, a plain concatenation
        mesh = self.mesh if len(self.owned) == self.n_shards else None
        return compose_sharded_batch(parts, self.device, mesh=mesh)


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
