"""Deterministic fault injection for the self-healing LGD stack
(PyTorch port of ``repro.testing.faults``).

Every injector fires on an exact trigger (refresh cycle, draw index,
byte offset), never on wall clock or randomness, so a test that survives
a fault proves the recovery path and a failure replays exactly.

* REFRESH faults (``RefreshRaise``, ``RefreshHang``) hook the pipeline's
  ``set_fault_injector`` port and fire inside the refresh computation:
  retry and backoff, the hang watchdog, the stale-index and
  uniform-fallback ladder.
* CHECKPOINT corrupters (``truncate_arrays``, ``delete_leaf``,
  ``flip_manifest_byte``) damage on-disk state as real incidents do
  (truncated write, lost member, bit rot): ``verify()`` and the
  ``latest_valid_step`` fallback.  They act on the shared on-disk
  format, so they corrupt either package's checkpoints.
* GRADIENT poison (``NanLossWeights``) wraps a sampler and multiplies a
  window of batches' ``loss_weights`` by NaN: the trainer's skip guard
  and checkpoint rollback.
* PROCESS faults (``ProcKill``, ``ProcHang``, ``DropBarrier``) hook the
  elastic cluster's ``set_fault_injector`` port
  (``repro_torch.dist.multihost.ElasticCluster``) and fire on its
  ``cluster_step`` / ``sync_barrier`` events: host-loss detection (stale
  heartbeats), barrier retry and backoff, and the missing-host-degraded
  → reformed ladder.  ``ProcKill`` is the one NON-recoverable injector:
  it hard-exits the process as a dead host disappears (no atexit, no
  flush), and the SURVIVORS' recovery is what a drill proves
  (``repro_torch.dist.multihost_worker``, ``repro_torch.chaos --drill
  host-loss``).

Any refresh injector installs on one shard of a ``ShardedLSHPipeline`` by
its global shard id (``set_fault_injector(injector, shard=s)``).
"""

from __future__ import annotations

import os
import time
import zipfile


class FaultError(RuntimeError):
    """Raised by injectors — distinguishable from organic failures."""


class FaultInjector:
    """Base injector: ``fire(event, **info)`` is called by instrumented
    code at fault points.  The pipeline fires ``refresh_compute``
    (``refresh=<cycle>, attempt=<n>``) inside every refresh attempt and
    ``recover_rebuild`` (``step=<s>``) inside every uniform-fallback
    recovery rebuild."""

    def fire(self, event: str, **info):   # pragma: no cover - interface
        pass


class RefreshRaise(FaultInjector):
    """Fail the first ``cycles`` refresh cycles (every attempt of each,
    so retries are exhausted and the cycle genuinely fails);
    ``recovery_fails`` (or ``fail_recovery``) also fails that many
    uniform-fallback recovery rebuilds."""

    def __init__(self, cycles: int = 3, fail_recovery: bool = False,
                 recovery_fails: int = 0):
        self.cycles = cycles
        self._seen: set = set()
        self.fired = 0                 # total injected raises
        self._recovery_left = recovery_fails if fail_recovery or \
            recovery_fails else 0

    def fire(self, event: str, **info):
        if event == "recover_rebuild" and self._recovery_left > 0:
            self._recovery_left -= 1
            self.fired += 1
            raise FaultError(
                f"injected recovery failure at step {info.get('step')}")
        if event != "refresh_compute":
            return
        r = info.get("refresh")
        if r in self._seen or len(self._seen) < self.cycles:
            self._seen.add(r)
            self.fired += 1
            raise FaultError(
                f"injected refresh failure (cycle {r}, "
                f"attempt {info.get('attempt')})")


class RefreshHang(FaultInjector):
    """Hang the first ``cycles`` refresh cycles' attempts for ``seconds``
    — longer than the pipeline's ``refresh_timeout``, so the watchdog
    abandons the worker and counts the attempt as failed."""

    def __init__(self, seconds: float = 5.0, cycles: int = 1):
        self.seconds = seconds
        self.cycles = cycles
        self._seen: set = set()
        self.fired = 0

    def fire(self, event: str, **info):
        if event != "refresh_compute":
            return
        r = info.get("refresh")
        if r in self._seen or len(self._seen) < self.cycles:
            self._seen.add(r)
            self.fired += 1
            time.sleep(self.seconds)


class NanLossWeights:
    """Sampler proxy poisoning ``loss_weights`` with NaN for the draws
    serving steps ``[at_step, at_step + count)``.

    One-shot: the budget of ``count`` poisoned draws is spent once, so
    after a trainer rollback the replayed window comes through clean.
    The draw counter follows the wrapped pipeline's step (batch k trains
    step k) and rewinds on ``restore_at``.
    """

    def __init__(self, inner, at_step: int, count: int = 1):
        self._inner = inner
        self._at = at_step
        self._count = count
        self._draws = getattr(inner, "_step", 0)
        self.fired = 0                 # poisoned batches so far

    def __getattr__(self, name):
        # the rest of the sampler surface delegates to the pipeline
        return getattr(self._inner, name)

    def _poison(self, batch):
        batch = dict(batch)
        batch["loss_weights"] = batch["loss_weights"] * float("nan")
        self.fired += 1
        return batch

    def next_batch(self, *args, **kwargs):
        b = self._inner.next_batch(*args, **kwargs)
        s, self._draws = self._draws, self._draws + 1
        if self.fired < self._count and s >= self._at:
            return self._poison(b)
        return b

    def restore_at(self, step: int, **kwargs):
        self._inner.restore_at(step, **kwargs)
        self._draws = step             # batch k <-> step k realignment


# -- process-level faults (multi-process elastic protocol) -------------------
# Fired by ``ElasticCluster``: ``cluster_step`` (``step=, rank=``) on every
# heartbeat call, ``sync_barrier`` (``name=, attempt=, rank=``) before
# every barrier arrival.


class ProcKill(FaultInjector):
    """Hard-exit the process at step ``at_step``: a host loss.

    ``os._exit`` (not ``sys.exit``): a dead host runs no atexit hooks,
    flushes no buffers and never reaches a clean shutdown, and neither
    does this injector.  Exit code 17 marks the death as injected.
    """

    EXIT_CODE = 17

    def __init__(self, at_step: int):
        self.at_step = at_step

    def fire(self, event: str, **info):
        if event == "cluster_step" and info.get("step") == self.at_step:
            os._exit(self.EXIT_CODE)


class ProcHang(FaultInjector):
    """Stall the process for ``seconds`` at step ``at_step``: a slow,
    paused or partitioned host.  Shorter than the cluster's total barrier
    grace it costs one retry; longer, the host is declared lost even
    though it still lives (the ladder's slow == failed policy)."""

    def __init__(self, at_step: int, seconds: float):
        self.at_step = at_step
        self.seconds = seconds
        self.fired = 0

    def fire(self, event: str, **info):
        if event == "cluster_step" and info.get("step") == self.at_step:
            self.fired += 1
            time.sleep(self.seconds)


class DropBarrier(FaultInjector):
    """Fail this rank's first ``count`` arrivals at sync barriers whose
    name contains ``match``: a dropped collective.  The cluster counts the
    failed attempt and retries with backoff, so ``count <=
    barrier_retries`` heals transparently."""

    def __init__(self, match: str = "", count: int = 1):
        self.match = match
        self.count = count
        self.fired = 0

    def fire(self, event: str, **info):
        if event != "sync_barrier" or self.fired >= self.count:
            return
        if self.match in str(info.get("name", "")):
            self.fired += 1
            raise FaultError(
                f"injected dropped barrier {info.get('name')!r} "
                f"(attempt {info.get('attempt')})")


# -- checkpoint corrupters ---------------------------------------------------
# Each defeats a naive restore and is caught by verify().


def _ckpt_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def truncate_arrays(ckpt_dir: str, step: int, keep_bytes: int = 512):
    """Truncate ``arrays.npz`` to ``keep_bytes`` — a writer killed mid-
    flush: the zip's central directory is gone, so it does not open."""
    p = os.path.join(_ckpt_path(ckpt_dir, step), "arrays.npz")
    size = os.path.getsize(p)
    with open(p, "r+b") as f:
        f.truncate(min(keep_bytes, size))


def delete_leaf(ckpt_dir: str, step: int, index: int = 0):
    """Rewrite ``arrays.npz`` without its ``index``-th member — a lost
    object.  The zip stays VALID, so only the manifest cross-check
    catches it.  Returns the member's name."""
    p = os.path.join(_ckpt_path(ckpt_dir, step), "arrays.npz")
    with zipfile.ZipFile(p) as z:
        names = z.namelist()
        victim = names[index % len(names)]
        survivors = {n: z.read(n) for n in names if n != victim}
    with zipfile.ZipFile(p, "w", zipfile.ZIP_STORED) as z:
        for n, blob in survivors.items():
            z.writestr(n, blob)
    return victim


def flip_manifest_byte(ckpt_dir: str, step: int, offset: int = -2):
    """Flip one byte of ``manifest.json`` — bit rot.  The default lands
    inside the checksum's hex, so the manifest either stops parsing or
    fails its self-checksum."""
    p = os.path.join(_ckpt_path(ckpt_dir, step), "manifest.json")
    with open(p, "r+b") as f:
        data = bytearray(f.read())
        data[offset % len(data)] ^= 0xFF
        f.seek(0)
        f.write(data)
        f.truncate(len(data))
