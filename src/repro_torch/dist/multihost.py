"""Multi-process elastic LGD: membership, liveness and reform protocol
(PyTorch port of ``repro.dist.multihost``).

The multi-controller deployment of the sharded LGD pipeline: process r
owns corpus shard r and its LSH index (``ShardedLSHPipeline(...,
owned_shards=[r])``); embedding, hashing and refresh stay process-local,
and only parameters cross between processes.  This module is the
ROBUSTNESS layer that lets that deployment survive a lost process:

* HEARTBEATS: every process publishes ``hb/g<generation>/r<rank>`` beats
  through the coordination store (``StoreCoord``, a
  ``torch.distributed.TCPStore``) or a shared directory (``FileCoord``).
  Staleness is judged OBSERVER-SIDE: each process stamps, on its OWN
  clock, the moment it sees a peer's beat counter advance, and a peer is
  dead when no NEW beat has been seen for ``heartbeat_timeout_s``.  Peer
  wall timestamps are never compared across hosts, so clock skew can
  neither fake nor mask a host loss.
* BARRIER-GUARDED COLLECTIVES: the parameter average is only entered
  behind a passed ``sync_barrier``.  A barrier with a dead peer fails
  after ``barrier_timeout_s``, where a collective with a dead peer would
  wait for it.  Barriers retry ``barrier_retries`` times with the
  deterministic-jitter backoff of the pipeline's refresh retries
  (``backoff_delay``), so a hung but alive process gets bounded grace
  before it counts as lost: a process slow past the retry budget IS a
  failed one.  After a loss the process group STILL CONTAINS the dead
  rank, so its collectives are off the table for the rest of the
  process's life; degraded survivors all-gather through the store
  instead (``ElasticCluster.exchange_blobs``).
* MEMBERSHIP GENERATIONS: every detected loss bumps ``generation``;
  heartbeat keys are generation-scoped, so a re-formed cluster never
  reads a dead generation's beats.
* THE LADDER (``repro_torch.data.health.ClusterHealthMonitor``):

      healthy ──barrier timeout + stale beat──▶ missing-host-degraded
      missing-host-degraded ──reform──────────▶ reformed

  Mid-incident the survivors ADOPT the lost shards
  (``ShardedLSHPipeline.adopt_shards``: same shard count, same bounds,
  so w = S/(p·N) stays exactly unbiased) and keep training
  process-locally; the REFORM then restores the newest verified
  checkpoint (``restore_latest_valid_on_mesh``) and rebuilds the
  pipeline on the surviving shard count (``rebuild_sharded_pipeline``),
  bitwise a fresh restore of the same checkpoint.
* CLEAN DETACH: after an incident ``destroy_process_group`` and the
  store can wait forever for the dead rank, so ``finalize_and_exit``
  hard-exits the survivor once its results are flushed.  With the
  cluster intact every rank leaves normally, rank 0 last: it hosts the
  store its peers talk through.

The transport.  Rank 0 hosts a ``TCPStore`` at ``--coordinator
host:port``, the counterpart of the reference's coordination service;
``initialize`` connects every rank to it and opens a gloo process group
over it (gloo even on a card: several ranks may share one GPU, and NCCL
takes one rank a device).  Losing rank 0 takes the store with it:
survivors can neither barrier nor read beats, which on this ladder means
the JOB restarts from the newest verified checkpoint rather than
reforming in place; the loss of any other rank is the elastic path.

Store errors.  Every store call is bounded by the store's own timeout
(``STORE_TIMEOUT_S``; torch's default of 300 s would turn a stuck store
into a five-minute hang).  In torch 2.11 and 2.13 a call
that outlives it raises ``torch.distributed.DistStoreError`` whose
message says "timeout" ("wait timeout after ...ms"); a lost connection
raises ``DistNetworkError`` or another ``DistStoreError``.  Only the
first is mapped to ``BarrierTimeout``, and only inside a barrier;
everything else is a ``ClusterError``.

``ElasticCluster`` is transport-agnostic: it talks to a small KV +
barrier interface implemented by ``StoreCoord``, ``FileCoord`` and
``NullCoord`` (unit tests drive the whole protocol in one process with
threads).  ``repro_torch.dist.multihost_worker`` is the runnable
training worker.
"""

from __future__ import annotations

import base64
import dataclasses
import datetime
import json
import os
import sys
import tempfile
import time
import zlib
from typing import Dict, List, Optional, Sequence

import torch.distributed as dist

from repro_torch.data.health import ClusterHealthMonitor


class ClusterError(RuntimeError):
    """Coordination failure that is not a plain barrier timeout (lost
    store, broken connection, ...)."""


class BarrierTimeout(ClusterError):
    """A sync barrier did not clear within its bounded retries."""


class HostLossDetected(RuntimeError):
    """Raised (typically out of a trainer ``step_hook``) when the
    membership protocol declares peers lost; carries the incident."""

    def __init__(self, step: int, dead: Sequence[int]):
        self.step = int(step)
        self.dead = sorted(int(r) for r in dead)
        super().__init__(
            f"host loss at step {self.step}: dead ranks {self.dead}")


def backoff_delay(tag: str, attempt: int, base: float) -> float:
    """Exponential backoff with DETERMINISTIC jitter: the jitter is a pure
    CRC32 function of ``(tag, attempt)``, NOT of the rank, so every
    process sleeps the same and retry attempts stay aligned across the
    cluster without any extra coordination."""
    if base <= 0 or attempt <= 0:
        return 0.0
    j = (zlib.crc32(f"{tag}:{attempt}".encode()) % 1000) / 1000.0
    return base * (2 ** (attempt - 1)) * (1.0 + 0.5 * j)


def shard_adoption_map(n_shards: int, alive: Sequence[int]
                       ) -> Dict[int, int]:
    """Deterministic owner map after a loss: shard s stays with rank s
    when alive, otherwise round-robins over the sorted survivors; every
    process computes the same map from the same membership view, no
    election needed."""
    alive = sorted(set(int(r) for r in alive))
    if not alive:
        raise ValueError("no surviving ranks to adopt shards")
    out: Dict[int, int] = {}
    orphan = 0
    for s in range(n_shards):
        if s in alive:
            out[s] = s
        else:
            out[s] = alive[orphan % len(alive)]
            orphan += 1
    return out


@dataclasses.dataclass
class MultihostConfig:
    """Knobs of the elastic membership protocol."""

    rank: int = 0
    num_processes: int = 1
    coordinator: str = ""            # "host:port" of rank 0's TCPStore
    # steps between heartbeat publications (every step by default: one
    # small KV write, off the device path)
    heartbeat_every: int = 1
    # a peer whose last beat is older than this is DEAD (wall seconds)
    heartbeat_timeout_s: float = 10.0
    # one barrier attempt's timeout; total grace for a slow process is
    # roughly barrier_timeout_s * (1 + barrier_retries) + backoffs
    barrier_timeout_s: float = 5.0
    barrier_retries: int = 2
    barrier_backoff_s: float = 0.25
    # steps between barrier-guarded parameter syncs in the worker
    sync_every: int = 5


# bound on one store call once connected, and on reaching rank 0's store
# at start-up (ranks start in any order)
STORE_TIMEOUT_S = 30.0
CONNECT_TIMEOUT_S = 120.0
# how long rank 0 keeps the store up for its peers at a normal exit
EXIT_TIMEOUT_S = 300.0


def _store_timeout(e: BaseException) -> bool:
    """A store call that outlived the store's timeout (module docstring:
    Store errors)."""
    return isinstance(e, dist.DistStoreError) and \
        "timeout" in str(e).lower()


class NullCoord:
    """Transport for a cluster of ONE: no peers, so every KV write is
    unread, and every barrier passes trivially."""

    def kv_set(self, key: str, value: str):
        pass

    def kv_dir(self, prefix: str) -> Dict[str, str]:
        return {}

    def barrier(self, name: str, timeout_s: float,
                ranks: Optional[Sequence[int]] = None):
        pass


class FileCoord:
    """KV + barrier transport over a shared directory.

    KV entries are atomic tmp+rename writes under ``root/kv/<key>``; a
    barrier is an arrival marker per rank under ``root/barriers/<name>/``
    polled until every expected rank has arrived.  Used by the in-process
    unit tests (threads share one directory) and usable as a real
    transport on any shared filesystem.  A timed-out barrier id is
    POISONED: a rank that times out drops a ``FAILED`` tombstone into the
    barrier dir, so a slow rank arriving LATE at an abandoned attempt
    fails like its peers did instead of passing at once on their stale
    markers (which would leave it believing a sync succeeded that
    everyone else gave up on: divergent membership views).
    """

    def __init__(self, root: str, rank: int, num_processes: int,
                 poll_s: float = 0.01):
        self.root = root
        self.rank = int(rank)
        self.num_processes = int(num_processes)
        self.poll_s = poll_s
        os.makedirs(os.path.join(root, "kv"), exist_ok=True)
        os.makedirs(os.path.join(root, "barriers"), exist_ok=True)

    def _kv_path(self, key: str) -> str:
        safe = key.replace("/", "__")
        return os.path.join(self.root, "kv", safe)

    def kv_set(self, key: str, value: str):
        path = self._kv_path(key)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
        with os.fdopen(fd, "w") as f:
            f.write(value)
        os.replace(tmp, path)

    def kv_dir(self, prefix: str) -> Dict[str, str]:
        safe = prefix.replace("/", "__")
        kv = os.path.join(self.root, "kv")
        out = {}
        for name in os.listdir(kv):
            if name.startswith(safe):
                try:
                    with open(os.path.join(kv, name)) as f:
                        out[name.replace("__", "/")] = f.read()
                except OSError:
                    continue                  # mid-rename race
        return out

    def barrier(self, name: str, timeout_s: float,
                ranks: Optional[Sequence[int]] = None):
        ranks = list(range(self.num_processes)) if ranks is None \
            else sorted(int(r) for r in ranks)
        d = os.path.join(self.root, "barriers", name.replace("/", "__"))
        os.makedirs(d, exist_ok=True)
        poison = os.path.join(d, "FAILED")
        if os.path.exists(poison):
            # a peer already timed this id out and moved on: a late
            # arrival must fail too
            raise BarrierTimeout(
                f"barrier {name!r} was poisoned by a peer's timeout")
        with open(os.path.join(d, f"r{self.rank}"), "w") as f:
            f.write("1")
        deadline = time.monotonic() + timeout_s
        while True:
            if os.path.exists(poison):
                raise BarrierTimeout(
                    f"barrier {name!r} was poisoned by a peer's "
                    f"timeout")
            if all(os.path.exists(os.path.join(d, f"r{r}"))
                   for r in ranks):
                return
            if time.monotonic() >= deadline:
                # tombstone FIRST, then raise: whoever arrives after this
                # instant sees a failed attempt, not our stale markers
                tmp = os.path.join(d, f".failed.r{self.rank}")
                with open(tmp, "w") as f:
                    f.write(f"r{self.rank}")
                os.replace(tmp, poison)
                missing = [r for r in ranks if not os.path.exists(
                    os.path.join(d, f"r{r}"))]
                raise BarrierTimeout(
                    f"barrier {name!r} timed out after {timeout_s}s "
                    f"(missing ranks {missing})")
            time.sleep(self.poll_s)


class StoreCoord:
    """KV + barrier transport over a ``torch.distributed.TCPStore``.

    The wire contract of ``FileCoord`` on store keys: KV entries under
    ``kv/<key>``; a barrier is an arrival key per rank under
    ``bar/<name>/`` polled (``check``, which never blocks) until every
    expected rank has arrived, and a rank that times out sets
    ``bar/<name>/FAILED`` before it raises, so a late arrival at the
    abandoned id fails as its peers did.

    ``kv_dir(prefix)`` returns the keys ``prefix + "r<rank>"`` for the
    ranks ``0..num_processes-1``: the protocol's listed keys are all of
    that form (``hb/g<gen>/r<rank>``, ``xg/g<gen>/<tag>/r<rank>``), and a
    store need not be able to list its keys.

    ``connect`` builds the store: rank 0 hosts it, the others connect
    within ``CONNECT_TIMEOUT_S``; every later call is bounded by
    ``STORE_TIMEOUT_S``.
    """

    def __init__(self, store, rank: int, num_processes: int,
                 poll_s: float = 0.01):
        self.store = store
        self.rank = int(rank)
        self.num_processes = int(num_processes)
        self.poll_s = poll_s

    @classmethod
    def connect(cls, coordinator: str, rank: int,
                num_processes: int) -> "StoreCoord":
        host, port = coordinator.rsplit(":", 1)
        try:
            store = dist.TCPStore(
                host, int(port), num_processes, int(rank) == 0,
                timeout=datetime.timedelta(seconds=CONNECT_TIMEOUT_S),
                wait_for_workers=False)
            store.set_timeout(datetime.timedelta(seconds=STORE_TIMEOUT_S))
        except Exception as e:
            raise ClusterError(
                f"rank {rank} could not reach the store at "
                f"{coordinator}: {e}") from e
        return cls(store, rank, num_processes)

    def _has(self, key: str) -> bool:
        return bool(self.store.check([key]))

    def kv_set(self, key: str, value: str):
        try:
            self.store.set("kv/" + key, value)
        except Exception as e:
            raise ClusterError(f"kv_set({key!r}) failed: {e}") from e

    def kv_dir(self, prefix: str) -> Dict[str, str]:
        out = {}
        try:
            for r in range(self.num_processes):
                key = f"{prefix}r{r}"
                if self._has("kv/" + key):
                    out[key] = self.store.get("kv/" + key).decode()
        except Exception as e:
            raise ClusterError(f"kv_dir({prefix!r}) failed: {e}") from e
        return out

    def barrier(self, name: str, timeout_s: float,
                ranks: Optional[Sequence[int]] = None):
        ranks = list(range(self.num_processes)) if ranks is None \
            else sorted(int(r) for r in ranks)
        base = f"bar/{name}/"
        poison = base + "FAILED"
        arrivals = [f"{base}r{r}" for r in ranks]
        try:
            if self._has(poison):
                raise BarrierTimeout(
                    f"barrier {name!r} was poisoned by a peer's timeout")
            self.store.set(f"{base}r{self.rank}", "1")
            deadline = time.monotonic() + timeout_s
            while True:
                if self._has(poison):
                    raise BarrierTimeout(
                        f"barrier {name!r} was poisoned by a peer's "
                        f"timeout")
                if self.store.check(arrivals):
                    return
                if time.monotonic() >= deadline:
                    self.store.set(poison, f"r{self.rank}")
                    missing = [r for r, key in zip(ranks, arrivals)
                               if not self._has(key)]
                    raise BarrierTimeout(
                        f"barrier {name!r} timed out after {timeout_s}s "
                        f"(missing ranks {missing})")
                time.sleep(self.poll_s)
        except ClusterError:
            raise
        except Exception as e:
            if _store_timeout(e):
                raise BarrierTimeout(
                    f"barrier {name!r}: a store call timed out: {e}") from e
            raise ClusterError(f"barrier {name!r} failed: {e}") from e


def initialize(cfg: MultihostConfig):
    """Connect this process to the run: ``StoreCoord.connect`` to rank 0's
    store, then a gloo process group over that store (rank and world size
    given, nothing read from the environment).  Returns the transport;
    ``NullCoord`` (and no process group) for one process."""
    if cfg.num_processes <= 1:
        return NullCoord()
    coord = StoreCoord.connect(cfg.coordinator, cfg.rank, cfg.num_processes)
    dist.init_process_group(
        "gloo", store=dist.PrefixStore("pg/", coord.store),
        rank=cfg.rank, world_size=cfg.num_processes)
    return coord


class ElasticCluster:
    """Membership + liveness for one process of a multi-process LGD run.

    Wraps a coordination transport (``StoreCoord`` / ``FileCoord``) with
    the elastic protocol: generation-scoped heartbeats, retrying
    barriers, failure classification and the deterministic adoption map.
    Detection policy (either leg suffices; they cover different faults):

    * a ``sync_barrier`` that exhausts its bounded retries flags the
      incident (hung, slow or partitioned processes that still beat);
    * stale heartbeats then IDENTIFY the dead ranks (crashed processes,
      precisely); when every absent peer still beats, the
      barrier-blocking peers are treated as lost anyway: a process slow
      past the retry budget is a failed one.

    Every state transition lands in ``health`` (the cluster ladder), so
    the incident history is auditable like the per-pipeline ladder.
    """

    def __init__(self, cfg: MultihostConfig, coord,
                 clock=time.time, sleep=time.sleep):
        self.cfg = cfg
        self.coord = coord
        self.rank = cfg.rank
        self.generation = 0
        self.alive = set(range(cfg.num_processes))
        self.health = ClusterHealthMonitor()
        self.fault_injector = None
        self._beat = 0
        # rank -> (last beat counter seen, OBSERVER clock when it was
        # first seen): staleness never reads a peer's wall timestamp
        self._last_seen: Dict[int, tuple] = {}
        # generation-LOCAL counters: survivors unwind an incident at
        # divergent trainer steps, so sync cadence and barrier names must
        # come from state every survivor resets together
        self._steps_in_gen = 0
        self.sync_seq = 0
        self._clock = clock
        self._sleep = sleep

    # -- faults --------------------------------------------------------------

    def set_fault_injector(self, injector):
        """``repro_torch.testing.faults`` port: fires ``cluster_step``
        every heartbeat and ``sync_barrier`` before every barrier
        arrival."""
        self.fault_injector = injector

    def _fault(self, event: str, **info):
        if self.fault_injector is not None:
            self.fault_injector.fire(event, **info)

    # -- heartbeats ----------------------------------------------------------

    def heartbeat(self, step: int):
        """Publish this process's beat (generation-scoped) and refresh the
        observer-side view of every peer's."""
        self._fault("cluster_step", step=step, rank=self.rank)
        self._steps_in_gen += 1
        if step % max(self.cfg.heartbeat_every, 1) != 0:
            return
        self._beat += 1
        self.coord.kv_set(
            f"hb/g{self.generation}/r{self.rank}",
            json.dumps({"beat": self._beat, "step": int(step),
                        "t": self._clock()}))
        self.observe_peers()

    def peer_beats(self) -> Dict[int, dict]:
        """Latest published beat per rank in the current generation."""
        out = {}
        for key, val in self.coord.kv_dir(
                f"hb/g{self.generation}/").items():
            try:
                rank = int(key.rsplit("r", 1)[-1])
                out[rank] = json.loads(val)
            except (ValueError, json.JSONDecodeError):
                continue
        return out

    def observe_peers(self) -> Dict[int, dict]:
        """Refresh the observer-side receive stamps: a peer's staleness
        clock resets only when its BEAT COUNTER advances, timed on THIS
        process's clock."""
        beats = self.peer_beats()
        now = self._clock()
        for r, b in beats.items():
            beat = int(b.get("beat", 0))
            prev = self._last_seen.get(r)
            if prev is None or beat > prev[0]:
                self._last_seen[r] = (beat, now)
        return beats

    def dead_peers(self) -> List[int]:
        """Alive-set ranks with no fresh beat: never observed in this
        generation, or whose beat counter has not advanced within
        ``heartbeat_timeout_s`` of observer-local time."""
        self.observe_peers()
        now = self._clock()
        dead = []
        for r in sorted(self.alive):
            if r == self.rank:
                continue
            seen = self._last_seen.get(r)
            if seen is None or \
                    now - seen[1] > self.cfg.heartbeat_timeout_s:
                dead.append(r)
        return dead

    # -- barriers ------------------------------------------------------------

    def sync_barrier(self, name: str):
        """Collective guard: every alive rank must arrive.

        Retries with attempt-suffixed barrier ids (a timed-out id is
        poisoned, and late arrivals at a passed id would race) and the
        deterministic-jitter backoff, keyed by ``(name, attempt)`` only,
        so all ranks sleep the same and re-converge on the same attempt
        id.  Raises ``BarrierTimeout`` when the retry budget is
        exhausted; the caller then runs ``classify_failure``.
        """
        ranks = sorted(self.alive)
        if ranks == [self.rank]:
            return                            # a cluster of one
        attempts = self.cfg.barrier_retries + 1
        last: Optional[Exception] = None
        for attempt in range(1, attempts + 1):
            try:
                self._fault("sync_barrier", name=name, attempt=attempt,
                            rank=self.rank)
                self.coord.barrier(
                    f"g{self.generation}/{name}/a{attempt}",
                    self.cfg.barrier_timeout_s, ranks)
                return
            except BarrierTimeout as e:
                last = e                      # waited the full window
            except Exception as e:            # FaultError / transport
                last = e
                if attempt < attempts:
                    # this rank FAILED TO ARRIVE (dropped collective)
                    # while its peers sit in the attempt's window until
                    # its timeout: burn the same window locally, or the
                    # retry counters desync by one attempt and the ranks
                    # never meet at the same barrier id again
                    self._sleep(self.cfg.barrier_timeout_s)
            if attempt < attempts:
                self._sleep(backoff_delay(
                    name, attempt, self.cfg.barrier_backoff_s))
        raise BarrierTimeout(
            f"sync barrier {name!r} failed after {attempts} "
            f"attempt(s): {last}")

    def at_sync_boundary(self) -> bool:
        """True when the GENERATION-LOCAL step counter crosses a
        ``sync_every`` boundary: survivors that unwound an incident at
        divergent trainer steps keep meeting at the same barriers."""
        return (self._steps_in_gen > 0 and
                self._steps_in_gen % max(self.cfg.sync_every, 1) == 0)

    def next_sync_tag(self) -> str:
        """Survivor-agreed name for the next parameter sync: a
        per-generation sequence number, NOT the local trainer step
        (step-named barriers would time each other out after an incident
        and cascade into false host-loss classifications)."""
        self.sync_seq += 1
        return f"q{self.sync_seq}"

    def exchange_blobs(self, tag: str, payload: bytes
                       ) -> Dict[int, bytes]:
        """All-gather raw bytes across the CURRENT alive set through the
        coordination KV store (publish → survivor barrier → read).

        The degraded-mode collective: after a loss the process group
        still contains the dead rank, so its collectives would wait for
        it; the surviving subset exchanges through the store instead.
        Keys are generation- and tag-scoped, so epochs never mix.  Raises
        ``BarrierTimeout`` if a survivor dies mid-exchange and
        ``ClusterError`` if a blob is missing after the barrier passed."""
        prefix = f"xg/g{self.generation}/{tag}/"
        self.coord.kv_set(prefix + f"r{self.rank}",
                          base64.b64encode(payload).decode("ascii"))
        self.sync_barrier(f"xg-{tag}")
        out: Dict[int, bytes] = {}
        for key, val in self.coord.kv_dir(prefix).items():
            try:
                r = int(key.rsplit("r", 1)[-1])
            except ValueError:
                continue
            if r in self.alive:
                out[r] = base64.b64decode(val)
        missing = sorted(set(self.alive) - set(out))
        if missing:
            raise ClusterError(
                f"exchange {tag!r}: blobs missing from ranks "
                f"{missing} after the barrier passed")
        return out

    # -- membership ----------------------------------------------------------

    def classify_failure(self, step: int) -> List[int]:
        """Declare the incident after a failed ``sync_barrier``: remove the
        dead ranks from the membership, bump the generation (stale beats
        never leak into the new epoch) and move the ladder to
        missing-host-degraded.  Returns the dead ranks."""
        dead = self.dead_peers()
        reason = "stale heartbeat"
        if not dead:
            # every peer still beats, yet the barrier cannot clear past
            # its bounded retries: slow/partitioned == failed
            dead = sorted(self.alive - {self.rank})
            reason = "barrier retries exhausted (host alive but stuck)"
        for r in dead:
            self.alive.discard(r)
        self.generation += 1
        # generation-local state restarts with the epoch
        self._last_seen.clear()
        self._steps_in_gen = 0
        self.sync_seq = 0
        self.health.note_host_lost(step, dead, reason)
        return dead

    def adoption_map(self, n_shards: Optional[int] = None
                     ) -> Dict[int, int]:
        n = self.cfg.num_processes if n_shards is None else n_shards
        return shard_adoption_map(n, self.alive)

    def shards_to_adopt(self, n_shards: Optional[int] = None
                        ) -> List[int]:
        """Shard ids THIS rank must adopt under the deterministic map
        (beyond its own shard)."""
        return sorted(s for s, r in self.adoption_map(n_shards).items()
                      if r == self.rank and s != self.rank)

    def note_adopted(self, step: int, shards: Sequence[int]):
        for s in shards:
            self.health.note_adopted(step, int(s), self.rank)

    def note_reformed(self, step: int, n_shards: int):
        self.health.note_reformed(step, n_shards)

    @property
    def intact(self) -> bool:
        return len(self.alive) == self.cfg.num_processes

    def summary(self) -> dict:
        return {
            "rank": self.rank,
            "generation": self.generation,
            "alive": sorted(self.alive),
            **self.health.summary(),
        }


def claim_reform_writer(ckpt_dir: str, generation: int, rank: int,
                        alive: Sequence[int]) -> bool:
    """Single-writer election + generation fence for the reform path.

    Exactly ONE survivor may write checkpoints (and ``discard_after``)
    into the shared directory after a reform; concurrent writers would
    race tmp+rename saves and each other's ``discard_after``.  The writer
    is the LOWEST surviving rank, computable from the membership view.

    Under a symmetric split-brain (both sides of a partition declare each
    other dead, so BOTH are the minimum of their own alive set) the claim
    is also fenced through an atomically renamed marker in the checkpoint
    dir: a HIGHER generation beats a lower one (a stale writer from an
    older epoch is rejected), and ties break toward the lower rank.  The
    fence is best-effort (rename races have a window on real shared
    filesystems), but a losing or stale claimant that sees the fence
    abstains instead of writing.
    """
    alive = sorted(set(int(r) for r in alive))
    if not alive or int(rank) != alive[0]:
        return False
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, "reform_writer.json")
    mine = {"generation": int(generation), "rank": int(rank)}

    def read():
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError, ValueError):
            return None

    def priority(claim):                  # higher tuple wins the fence
        return (claim["generation"], -claim["rank"])

    for _ in range(3):
        cur = read()
        if cur is not None:
            if priority(cur) > priority(mine):
                return False
            if cur == mine:
                return True
        fd, tmp = tempfile.mkstemp(dir=ckpt_dir)
        with os.fdopen(fd, "w") as f:
            json.dump(mine, f)
        os.replace(tmp, path)
        time.sleep(0.05)                  # let a racing rename land
    return read() == mine


def finalize_and_exit(cluster: Optional[ElasticCluster], code: int = 0):
    """Exit a multi-process worker safely.

    After an incident ``destroy_process_group`` and the store can wait
    forever for the dead rank, so the survivor detaches with ``os._exit``
    once its results are flushed.  With the cluster INTACT every rank
    leaves normally: each rank but 0 marks itself done in the store and
    leaves; rank 0, whose process hosts the store, first waits (at most
    ``EXIT_TIMEOUT_S``) for every mark, so no peer loses the store in a
    last call.  A failed rendezvous detaches with ``os._exit``.
    """
    sys.stdout.flush()
    sys.stderr.flush()
    if cluster is not None and not cluster.intact:
        os._exit(code)
    if cluster is not None and isinstance(cluster.coord, StoreCoord):
        coord = cluster.coord
        try:
            if dist.is_initialized():
                dist.destroy_process_group()
            coord.store.set(f"exit/r{coord.rank}", "1")
            if coord.rank == 0:
                done = [f"exit/r{r}" for r in range(coord.num_processes)]
                deadline = time.monotonic() + EXIT_TIMEOUT_S
                while not coord.store.check(done):
                    if time.monotonic() >= deadline:
                        raise ClusterError("peers did not mark their exit")
                    time.sleep(coord.poll_s)
        except Exception as e:       # the exit boundary: report, detach
            print(f"rank {coord.rank}: exit rendezvous failed: {e}",
                  file=sys.stderr, flush=True)
            os._exit(code)
    sys.exit(code)
