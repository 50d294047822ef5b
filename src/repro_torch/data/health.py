"""Degradation ladder for the LGD pipeline (PyTorch port of
``repro.data.health``): a small health-state machine, pure Python, with
the reference's thresholds, arithmetic and transitions.

UNIFORM sampling with weight 1 is always an unbiased gradient estimator
(worse variance than a healthy LSH index, never wrong), so the ladder
degrades through states that trade variance for survival, and climbs
back when the index heals:

    healthy ──refresh failure──────────────▶ stale-index
    stale-index ──refresh success──────────▶ healthy        (recovered)
    stale-index ──staleness bound hit──────▶ uniform-fallback
    healthy/stale ──fallback-rate spike────▶ uniform-fallback
    healthy/stale ──non-finite loss streak─▶ uniform-fallback
    uniform-fallback ──rebuild succeeds────▶ healthy        (recovered)

STALE-INDEX: the periodic refresh failed (after retries), so draws keep
coming from the last good (features, index) buffer — still unbiased
w.r.t. the indexed vectors.  UNIFORM-FALLBACK: the index is unusable;
the pipeline emits uniform batches with weight 1 and attempts a full
canonical rebuild every ``recover_after`` steps.

``transitions`` records every edge as ``(step, from, to, reason)``,
surfaced into the trainer's ``metrics_history``.

``ClusterHealthMonitor`` is the cluster-level ladder of multi-process
runs (healthy, missing-host-degraded, reformed), pure bookkeeping like
``HealthMonitor``.  The process cluster that detects lost hosts
drives it (``repro_torch.dist.multihost.ElasticCluster``); the survivors'
recovery is ``ShardedLSHPipeline.adopt_shards`` and
``train.elastic.rebuild_sharded_pipeline``
(``repro_torch.dist.multihost_worker``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

HEALTHY = "healthy"
STALE_INDEX = "stale-index"
UNIFORM_FALLBACK = "uniform-fallback"

# the cluster-level ladder (multi-process runs)
CLUSTER_HEALTHY = "healthy"
CLUSTER_DEGRADED = "missing-host-degraded"
CLUSTER_REFORMED = "reformed"


@dataclasses.dataclass
class HealthConfig:
    """Thresholds driving the degradation ladder."""

    # consecutive FAILED refreshes tolerated in stale-index mode before
    # degrading to uniform-fallback (the bounded-staleness contract: the
    # index is never more than (1 + max_stale_refreshes) refresh
    # periods behind the model).
    max_stale_refreshes: int = 3
    # a batch whose uniform-fallback rate exceeds this counts as a
    # strike (the index resolved almost nothing); ``fallback_strikes``
    # consecutive strikes degrade to uniform-fallback.
    fallback_spike: float = 0.9
    fallback_strikes: int = 3
    # consecutive non-finite losses reported by the trainer before the
    # pipeline stops trusting its weighted batches.
    nonfinite_strikes: int = 3
    # steps between index-rebuild attempts while in uniform-fallback.
    recover_after: int = 25


class HealthMonitor:
    """Tracks one pipeline's position on the degradation ladder.

    Pure bookkeeping — the PIPELINE owns the behaviour (which buffer to
    draw from, when to attempt a rebuild); this object decides only the
    state, so the transition logic is testable without a tensor.
    """

    def __init__(self, cfg: HealthConfig = HealthConfig()):
        self.cfg = cfg
        self.state = HEALTHY
        self.stale_refreshes = 0       # consecutive failed refreshes
        self.refresh_failures = 0      # lifetime failed refresh attempts
        self.recoveries = 0            # lifetime degraded -> healthy edges
        self._fallback_strikes = 0
        self._nonfinite_strikes = 0
        self._entered_fallback_step = 0
        self.transitions: List[Tuple[int, str, str, str]] = []

    # -- transitions ---------------------------------------------------------

    def _move(self, step: int, to: str, reason: str):
        if to == self.state:
            return
        self.transitions.append((step, self.state, to, reason))
        if to == HEALTHY and self.state != HEALTHY:
            self.recoveries += 1
        self.state = to
        if to == UNIFORM_FALLBACK:
            self._entered_fallback_step = step
        if to == HEALTHY:
            self.stale_refreshes = 0
            self._fallback_strikes = 0
            self._nonfinite_strikes = 0

    # -- signals -------------------------------------------------------------

    def note_refresh_success(self, step: int):
        self.stale_refreshes = 0
        if self.state == STALE_INDEX:
            self._move(step, HEALTHY, "refresh recovered")

    def note_refresh_failure(self, step: int, reason: str = ""):
        """A refresh failed AFTER retries were exhausted."""
        self.refresh_failures += 1
        if self.state == UNIFORM_FALLBACK:
            return
        self.stale_refreshes += 1
        if self.stale_refreshes > self.cfg.max_stale_refreshes:
            self._move(step, UNIFORM_FALLBACK,
                       f"staleness bound exceeded "
                       f"({self.stale_refreshes} failed refreshes)")
        else:
            self._move(step, STALE_INDEX,
                       f"refresh failed: {reason}" if reason
                       else "refresh failed")

    def note_fallback_rate(self, step: int, rate: float):
        """Feed a recent batch's uniform-fallback fraction (sampler_stats
        path) — an index that mostly misses is pure overhead."""
        if self.state == UNIFORM_FALLBACK:
            return
        if rate >= self.cfg.fallback_spike:
            self._fallback_strikes += 1
            if self._fallback_strikes >= self.cfg.fallback_strikes:
                self._move(step, UNIFORM_FALLBACK,
                           f"fallback-rate spike ({rate:.2f} for "
                           f"{self._fallback_strikes} checks)")
        else:
            self._fallback_strikes = 0

    def note_loss(self, step: int, finite: bool):
        """Feed the trainer's per-step loss finiteness."""
        if not finite:
            self._nonfinite_strikes += 1
            if self.state != UNIFORM_FALLBACK and \
                    self._nonfinite_strikes >= self.cfg.nonfinite_strikes:
                self._move(step, UNIFORM_FALLBACK,
                           f"non-finite loss streak "
                           f"({self._nonfinite_strikes})")
        else:
            self._nonfinite_strikes = 0

    def note_recovered(self, step: int, reason: str = "index rebuilt"):
        self._move(step, HEALTHY, reason)

    # -- queries -------------------------------------------------------------

    @property
    def degraded(self) -> bool:
        return self.state != HEALTHY

    def should_attempt_recovery(self, step: int) -> bool:
        """In uniform-fallback, rebuild every ``recover_after`` steps."""
        if self.state != UNIFORM_FALLBACK:
            return False
        waited = step - self._entered_fallback_step
        return waited > 0 and waited % max(self.cfg.recover_after, 1) == 0

    def summary(self) -> dict:
        return {
            "state": self.state,
            "stale_refreshes": self.stale_refreshes,
            "refresh_failures": self.refresh_failures,
            "recoveries": self.recoveries,
            "transitions": list(self.transitions),
        }


class ClusterHealthMonitor:
    """The ladder one level up: the MEMBERSHIP of the training cluster.

        healthy ──host loss detected─────────▶ missing-host-degraded
        missing-host-degraded ──reform done──▶ reformed
        reformed ──host loss detected────────▶ missing-host-degraded

    MISSING-HOST-DEGRADED: a peer stopped heartbeating.  The survivors
    keep training and adopt its corpus shard
    (``ShardedLSHPipeline.adopt_shards``); the shard count and bounds are
    unchanged, so the composed S/(p·N) weights stay exactly unbiased.
    REFORMED: the survivors restored the newest verified checkpoint and
    rebuilt the pipeline on the surviving shard count
    (``rebuild_sharded_pipeline``), a deterministic state again; kept
    apart from healthy so ``transitions`` shows the membership history.

    Pure bookkeeping: the cluster owns detection and the reform; this
    only decides the state.  ``transitions`` records edges as ``(step,
    from, to, reason)``, ``events`` the incidents that are not edges
    (adoptions, losses) as ``(step, kind, detail)``.
    """

    def __init__(self):
        self.state = CLUSTER_HEALTHY
        self.lost_hosts: List[int] = []    # lifetime lost ranks
        self.reforms = 0                   # lifetime completed reforms
        self.transitions: List[Tuple[int, str, str, str]] = []
        self.events: List[Tuple[int, str, str]] = []

    def _move(self, step: int, to: str, reason: str):
        if to == self.state:
            return
        self.transitions.append((step, self.state, to, reason))
        self.state = to

    # -- signals -------------------------------------------------------------

    def note_host_lost(self, step: int, ranks, reason: str = ""):
        ranks = sorted(int(r) for r in ranks)
        self.lost_hosts.extend(ranks)
        detail = f"lost host(s) {ranks}" + (f": {reason}" if reason else "")
        self.events.append((step, "host-lost", detail))
        self._move(step, CLUSTER_DEGRADED, detail)

    def note_adopted(self, step: int, shard: int, by_rank: int):
        """A survivor took over a lost host's shard (not a state edge)."""
        self.events.append(
            (step, "shard-adopted",
             f"shard {shard} adopted by rank {by_rank}"))

    def note_reformed(self, step: int, n_shards: int):
        self.reforms += 1
        self._move(step, CLUSTER_REFORMED,
                   f"reformed on {n_shards} shard(s) from verified "
                   f"checkpoint at step {step}")

    # -- queries -------------------------------------------------------------

    @property
    def degraded(self) -> bool:
        return self.state == CLUSTER_DEGRADED

    def summary(self) -> dict:
        return {
            "state": self.state,
            "lost_hosts": list(self.lost_hosts),
            "reforms": self.reforms,
            "transitions": list(self.transitions),
            "events": list(self.events),
        }
