"""The multi-process elastic protocol in the port against the JAX package,
on the CPU.

* PRIMITIVES: ``backoff_delay`` bitwise over a grid of tags, attempts and
  bases; ``shard_adoption_map`` equal for every alive subset of 1-6
  ranks; ``claim_reform_writer``'s outcomes in fresh directories (the
  lowest survivor, the split-brain tie, the stale generation).
* THE CLUSTER: ``ElasticCluster`` of both packages over ``FileCoord``
  with fake clocks and recorded sleeps, driven by the same scripted
  events (dead peer, dropped barrier healed within retries, exhausted
  retries, alive-but-stuck peer, clock skew, post-incident cadence,
  ``exchange_blobs`` over survivors): equal ``summary()``s, dead lists,
  generations, errors and backoff schedules.
* THE TRANSPORTS: the ``FileCoord`` contract tests of
  tests/test_multihost.py, run on ``FileCoord`` and on ``StoreCoord``
  (a ``TCPStore`` on a free port, ranks in threads).
* THE INJECTORS: ``ProcKill`` exits 17 in a ``python -c`` child;
  ``DropBarrier`` and ``ProcHang`` fire as the reference's do.
* THE WORKER: the degraded average never enters the process group (a
  patched ``torch.distributed.all_reduce`` that raises); then one run of
  three process pairs started together: the port's host-loss drill over
  gloo (rank 1 killed at step 12), the reference worker with the same
  flags, and a fault-free port pair.  The port's survivor walks the
  reference survivor's timeline (incident step, dead ranks, transitions,
  adoption, restore step, shards, writer, draw counts) and its
  post-reform digest and losses are bitwise a fresh
  ``replay_post_reform``; the fault-free pair's first batches compose
  bitwise into a one-process pipeline's.  Threefry and Philox give
  different bits, so digests are compared within each package only.
* THE TWINS: ``python -m repro_torch.chaos --fault none`` exits 0, and
  ``repro_torch.elastic_restart`` resumes and restores at 3 steps.
"""

import datetime
import hashlib
import itertools
import json
import logging
import os
import socket
import subprocess
import sys
import threading
import time
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.dist.multihost as JM
import repro.testing as JT
import repro_torch.dist.multihost as TM
import repro_torch.testing as TT
from repro_torch.dist import multihost_worker as TW
from repro_torch.models import LM

PKGS = {"reference": (JM, JT), "port": (TM, TT)}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
# every child process is waited on with this bound
CHILD_TIMEOUT_S = 240


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def test_backoff_delay_bitwise():
    grid = itertools.product(
        ("sync", "q1", "xg-avg3", "refresh", ""), range(-1, 8),
        (-1.0, 0.0, 0.05, 0.1, 0.25, 1.0, 3.7))
    for tag, attempt, base in grid:
        want = JM.backoff_delay(tag, attempt, base)
        got = TM.backoff_delay(tag, attempt, base)
        assert got == want and type(got) is type(want), (tag, attempt, base)


@pytest.mark.parametrize("n_ranks", range(1, 7))
def test_shard_adoption_map_equal_for_every_alive_subset(n_ranks):
    for size in range(1, n_ranks + 1):
        for alive in itertools.combinations(range(n_ranks), size):
            for n_shards in (n_ranks, n_ranks + 1, 2 * n_ranks):
                assert TM.shard_adoption_map(n_shards, alive) == \
                    JM.shard_adoption_map(n_shards, alive), (alive, n_shards)
            # input-order and duplicate invariance
            assert TM.shard_adoption_map(n_ranks, alive[::-1] + alive) == \
                JM.shard_adoption_map(n_ranks, alive)
    for m in (JM, TM):
        with pytest.raises(ValueError, match="no surviving ranks"):
            m.shard_adoption_map(n_ranks, [])


# each claim: (generation, rank, alive)
WRITER_SCENARIOS = {
    "lowest_survivor": [(1, 3, [2, 3]), (1, 2, [2, 3]), (1, 2, [2, 3])],
    "split_brain_tie": [(1, 1, [1]), (1, 0, [0]), (1, 1, [1])],
    "stale_generation": [(2, 1, [1]), (1, 0, [0]), (3, 0, [0]),
                         (2, 1, [1])],
}
WRITER_WANT = {
    "lowest_survivor": [False, True, True],
    "split_brain_tie": [True, True, False],
    "stale_generation": [True, False, True, False],
}


@pytest.mark.parametrize("scenario", sorted(WRITER_SCENARIOS))
def test_claim_reform_writer_outcomes(tmp_path, scenario):
    outcomes = {}
    for name, (m, _) in PKGS.items():
        d = str(tmp_path / name / "ckpt")
        outcomes[name] = [m.claim_reform_writer(d, g, r, alive)
                          for g, r, alive in WRITER_SCENARIOS[scenario]]
        with open(os.path.join(d, "reform_writer.json")) as f:
            outcomes[name].append(json.load(f))
    assert outcomes["port"] == outcomes["reference"]
    assert outcomes["port"][:-1] == WRITER_WANT[scenario]


# ---------------------------------------------------------------------------
# the cluster: one scripted sequence through both packages
# ---------------------------------------------------------------------------


def _cluster(m, root, rank, nprocs, clock=None, sleep=None, **kw):
    kw.setdefault("barrier_timeout_s", 0.3)
    kw.setdefault("barrier_retries", 1)
    kw.setdefault("barrier_backoff_s", 0.05)
    kw.setdefault("heartbeat_timeout_s", 5.0)
    cfg = m.MultihostConfig(rank=rank, num_processes=nprocs, **kw)
    coord = m.FileCoord(str(root), rank, nprocs)
    return m.ElasticCluster(cfg, coord, clock=clock or time.time,
                            sleep=sleep or (lambda s: None))


def _threads(*calls):
    """Run each (fn, args) in its own thread; (results, errors)."""
    out, errs = {}, []

    def go(i, fn, args):
        try:
            out[i] = fn(*args)
        except Exception as e:      # recorded, compared across packages
            errs.append(f"{type(e).__name__}: {e}")

    ts = [threading.Thread(target=go, args=(i, fn, args), daemon=True)
          for i, (fn, args) in enumerate(calls)]
    [t.start() for t in ts]
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive(), "a rank's call did not return"
    return [out.get(i) for i in range(len(calls))], sorted(errs)


def sc_dead_peer(m, faults, root):
    now, slept = [100.0], []
    a = _cluster(m, root, 0, 2, clock=lambda: now[0], sleep=slept.append)
    b = _cluster(m, root, 1, 2, clock=lambda: now[0])
    a.heartbeat(1)
    b.heartbeat(1)
    obs = [a.dead_peers()]
    a.heartbeat(2)               # a observes b's beat while it is fresh
    now[0] += 10.0               # b dies
    a.heartbeat(15)
    obs.append(a.dead_peers())
    with pytest.raises(m.BarrierTimeout) as e:
        a.sync_barrier("q1")
    obs += [str(e.value), slept, a.classify_failure(15), a.generation,
            sorted(a.alive), a.intact, a.shards_to_adopt(2),
            a.adoption_map(2)]
    a.sync_barrier("q2")         # a cluster of one barriers trivially
    a.note_adopted(15, a.shards_to_adopt(2))
    a.note_reformed(10, 1)
    obs.append(a.summary())
    return obs


def sc_dropped_barrier_heals(m, faults, root):
    # real sleeps: the faulting rank must burn the window its peer waits
    # in, or the attempt counters desync
    a = _cluster(m, root, 0, 2, barrier_timeout_s=0.5, sleep=time.sleep)
    b = _cluster(m, root, 1, 2, barrier_timeout_s=0.5, sleep=time.sleep)
    fault = faults.DropBarrier(match="s7", count=1)
    a.set_fault_injector(fault)
    _, errs = _threads((a.sync_barrier, ("s7",)), (b.sync_barrier, ("s7",)))
    return [errs, fault.fired, a.summary(), b.summary()]


def sc_exhausted_retries(m, faults, root):
    slept = []
    a = _cluster(m, root, 0, 2, sleep=slept.append, barrier_retries=2)
    with pytest.raises(m.BarrierTimeout) as e:
        a.sync_barrier("s9")             # rank 1 never arrives
    return [str(e.value), slept, a.summary()]


def sc_alive_but_stuck(m, faults, root):
    a = _cluster(m, root, 0, 2)
    b = _cluster(m, root, 1, 2)
    a.heartbeat(5)
    b.heartbeat(5)                       # b beats but never arrives
    with pytest.raises(m.BarrierTimeout):
        a.sync_barrier("s5")
    return [a.classify_failure(5), a.summary(), b.summary()]


def sc_clock_skew(m, faults, root):
    now_a, now_b = [100.0], [50.0]
    a = _cluster(m, root, 0, 2, clock=lambda: now_a[0])
    b = _cluster(m, root, 1, 2, clock=lambda: now_b[0])
    obs = []
    for step in range(1, 5):
        a.heartbeat(step)
        b.heartbeat(step)
        obs.append((a.dead_peers(), b.dead_peers()))
        now_a[0] += 1.0
        now_b[0] += 1.0
    now_a[0] += 10.0
    now_b[0] += 10.0
    a.heartbeat(9)
    obs.append(a.dead_peers())
    return obs


def sc_post_incident_cadence(m, faults, root):
    def walk(sub, pre_steps):
        now = [100.0]
        a = _cluster(m, root / sub, 0, 2, clock=lambda: now[0],
                     sync_every=5)
        b = _cluster(m, root / sub, 1, 2, clock=lambda: now[0],
                     sync_every=5)
        for s in range(1, pre_steps + 1):
            a.heartbeat(s)
            b.heartbeat(s)
        now[0] += 10.0                   # b dies
        a.heartbeat(pre_steps + 1)
        a.classify_failure(pre_steps + 1)
        tags = []
        for s in range(pre_steps + 2, pre_steps + 14):
            a.heartbeat(s)
            if a.at_sync_boundary():
                tags.append((a.generation, a.next_sync_tag()))
        return tags, a.summary()

    t20, s20 = walk("w20", 20)
    t23, s23 = walk("w23", 23)
    assert t20 and t20 == t23
    return [t20, s20, s23]


def sc_exchange_blobs(m, faults, root):
    a = _cluster(m, root, 0, 3, barrier_timeout_s=5.0)
    c = _cluster(m, root, 2, 3, barrier_timeout_s=5.0)
    for cl in (a, c):
        cl.alive = {0, 2}                # rank 1 is dead
        cl.generation = 1
    got, errs = _threads((a.exchange_blobs, ("avg1", b"pay-0")),
                         (c.exchange_blobs, ("avg1", b"pay-2")))
    # a survivor dying MID-EXCHANGE surfaces as BarrierTimeout
    lone = _cluster(m, root / "lone", 0, 3)
    lone.alive = {0, 2}
    with pytest.raises(m.BarrierTimeout) as e:
        lone.exchange_blobs("avg1", b"pay-0")
    return [got, errs, str(e.value)]


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_dead_peer, sc_dropped_barrier_heals, sc_exhausted_retries,
    sc_alive_but_stuck, sc_clock_skew, sc_post_incident_cadence,
    sc_exchange_blobs)}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_elastic_cluster_matches_reference(tmp_path, scenario):
    obs = {name: SCENARIOS[scenario](m, faults, tmp_path / name)
           for name, (m, faults) in PKGS.items()}
    assert obs["port"] == obs["reference"]


def test_dead_peer_walks_the_ladder(tmp_path):
    """The scripted incident's content, on the port alone."""
    obs = sc_dead_peer(TM, TT, tmp_path)
    assert obs[0] == [] and obs[1] == [1]
    assert "after 2 attempt(s)" in obs[2] and "missing ranks [1]" in obs[2]
    assert obs[3] == [0.05 * (1 + 0.5 * (zlib.crc32(b"q1:1") % 1000) / 1000)]
    assert obs[4:10] == [[1], 1, [0], False, [1], {0: 0, 1: 0}]
    s = obs[-1]
    assert s["state"] == "reformed" and s["reforms"] == 1
    assert "stale heartbeat" in s["transitions"][0][3]
    assert [e[1] for e in s["events"]] == ["host-lost", "shard-adopted"]


# ---------------------------------------------------------------------------
# the transports: FileCoord's contract, on FileCoord and StoreCoord
# ---------------------------------------------------------------------------


@pytest.fixture(params=["file", "store"])
def make_coord(request, tmp_path):
    """``make(rank, nprocs)`` -> a transport of one shared run."""
    if request.param == "file":
        yield lambda rank, n: TM.FileCoord(str(tmp_path), rank, n)
        return
    port = _free_port()
    timeout = datetime.timedelta(seconds=10)
    master = dist.TCPStore("127.0.0.1", port, 1, True, timeout=timeout,
                           wait_for_workers=False)
    clients = []

    def make(rank, n):
        st = dist.TCPStore("127.0.0.1", port, 1, False, timeout=timeout)
        clients.append(st)
        return TM.StoreCoord(st, rank, n)

    yield make
    del clients[:]
    del master


def test_kv_roundtrip_and_prefix(make_coord):
    c = make_coord(0, 2)
    c.kv_set("hb/g0/r0", "a")
    c.kv_set("hb/g0/r1", "b")
    c.kv_set("hb/g1/r0", "c")
    assert c.kv_dir("hb/g0/") == {"hb/g0/r0": "a", "hb/g0/r1": "b"}
    c.kv_set("hb/g0/r0", "a2")           # overwrite
    assert make_coord(1, 2).kv_dir("hb/g0/")["hb/g0/r0"] == "a2"
    assert c.kv_dir("hb/g7/") == {}


def test_barrier_passes_when_all_arrive(make_coord):
    coords = [make_coord(r, 3) for r in range(3)]
    _, errs = _threads(*[(c.barrier, ("b1", 5.0)) for c in coords])
    assert not errs


def test_barrier_timeout_names_missing_ranks(make_coord):
    c = make_coord(0, 2)
    with pytest.raises(TM.BarrierTimeout, match=r"missing ranks \[1\]"):
        c.barrier("b2", timeout_s=0.2)


def test_timed_out_barrier_is_poisoned_for_late_arrivals(make_coord):
    a, b = make_coord(0, 2), make_coord(1, 2)
    with pytest.raises(TM.BarrierTimeout, match="missing ranks"):
        a.barrier("p1", timeout_s=0.2)          # b never arrives
    with pytest.raises(TM.BarrierTimeout, match="poisoned"):
        b.barrier("p1", timeout_s=0.2)          # late arrival fails
    make_coord(0, 1).barrier("p2", timeout_s=0.2)   # a fresh id passes


def test_store_loss_is_a_cluster_error_not_a_timeout():
    """Rank 0's store gone (the coordinator lost): a barrier fails as a
    ClusterError, the job-restart path, never as a host-loss timeout."""
    port = _free_port()
    timeout = datetime.timedelta(seconds=5)
    master = dist.TCPStore("127.0.0.1", port, 1, True, timeout=timeout,
                           wait_for_workers=False)
    client = TM.StoreCoord(dist.TCPStore("127.0.0.1", port, 1, False,
                                         timeout=timeout), 1, 2)
    client.kv_set("hb/g0/r1", "x")
    del master
    with pytest.raises(TM.ClusterError) as e:
        client.barrier("gone", timeout_s=1.0)
    assert not isinstance(e.value, TM.BarrierTimeout)
    assert TM._store_timeout(dist.DistStoreError(
        "wait timeout after 300ms, keys: /x"))
    assert not TM._store_timeout(dist.DistNetworkError("Broken pipe"))


def test_elastic_cluster_over_store_coord():
    """The incident of sc_dead_peer's shape over the store transport,
    with real clocks: a healthy sync, then a peer that stops beating."""
    port = _free_port()
    timeout = datetime.timedelta(seconds=10)
    master = dist.TCPStore("127.0.0.1", port, 1, True, timeout=timeout,
                           wait_for_workers=False)
    mk = [TM.ElasticCluster(
        TM.MultihostConfig(rank=r, num_processes=2, barrier_timeout_s=0.3,
                           barrier_retries=1, barrier_backoff_s=0.0,
                           heartbeat_timeout_s=0.2),
        TM.StoreCoord(dist.TCPStore("127.0.0.1", port, 1, False,
                                    timeout=timeout), r, 2))
        for r in (0, 1)]
    a, b = mk
    a.heartbeat(1)
    b.heartbeat(1)
    _, errs = _threads((a.sync_barrier, ("q1",)), (b.sync_barrier, ("q1",)))
    assert not errs and a.dead_peers() == [] and b.dead_peers() == []
    _, errs = _threads((a.exchange_blobs, ("t", b"0")),
                       (b.exchange_blobs, ("t", b"1")))
    assert not errs
    with pytest.raises(TM.BarrierTimeout):
        a.sync_barrier("q2")             # b never arrives, nor beats
    assert a.classify_failure(2) == [1] and a.generation == 1
    assert "stale heartbeat" in a.health.transitions[-1][3]
    del master


# ---------------------------------------------------------------------------
# the injectors
# ---------------------------------------------------------------------------


def test_prockill_exits_17_in_a_child():
    code = ("from repro_torch.testing import ProcKill\n"
            "k = ProcKill(at_step=3)\n"
            "k.fire('cluster_step', step=2)\n"
            "print('alive at 2', flush=True)\n"
            "k.fire('sync_barrier', name='q1', attempt=1, step=3)\n"
            "k.fire('cluster_step', step=3)\n"
            "print('alive at 3', flush=True)\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=CHILD_TIMEOUT_S,
                       env=dict(os.environ, PYTHONPATH=SRC))
    assert p.returncode == TT.ProcKill.EXIT_CODE == 17, p.stderr
    assert p.stdout == "alive at 2\n"


def test_drop_barrier_and_proc_hang_fire_as_the_reference(monkeypatch):
    slept = []
    monkeypatch.setattr(time, "sleep", slept.append)
    events = [("sync_barrier", dict(name="q1", attempt=1)),
              ("sync_barrier", dict(name="xg-avg1", attempt=1)),
              ("cluster_step", dict(step=4)),
              ("sync_barrier", dict(name="q2", attempt=2)),
              ("cluster_step", dict(step=5)),
              ("sync_barrier", dict(name="q3", attempt=1))]
    obs = {}
    for name, (_, faults) in PKGS.items():
        drop = faults.DropBarrier(match="q", count=2)
        hang = faults.ProcHang(at_step=5, seconds=8.0)
        rec = []
        for ev, info in events:
            for inj in (drop, hang):
                try:
                    inj.fire(ev, **info)
                    rec.append("ok")
                except Exception as e:
                    rec.append(f"{type(e).__name__}: {e}")
        obs[name] = (rec, drop.fired, hang.fired)
    assert obs["port"][0] == obs["reference"][0]
    assert obs["port"][1:] == obs["reference"][1:] == (2, 1)
    assert slept == [8.0, 8.0]


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------


def test_degraded_average_never_enters_the_process_group(tmp_path,
                                                         monkeypatch):
    """With >= 3 processes the degraded survivors' barrier passes over
    the alive subset, but a process-group collective would wait for the
    dead rank: the degraded branch must average over the store only.
    ``all_reduce`` raises here, and no process group exists."""
    from repro.dist.multihost_worker import _average_params as j_average

    def no_collective(*a, **kw):
        raise AssertionError("the degraded average entered all_reduce")

    monkeypatch.setattr(dist, "all_reduce", no_collective)
    assert not dist.is_initialized()
    pa = {"w": np.arange(4.0, dtype=np.float32),
          "x": np.full((2, 3), 4.0, np.float32), "h": np.float32([3, -1])}
    pc = {"w": np.arange(4.0, dtype=np.float32) * 3,
          "x": np.zeros((2, 3), np.float32), "h": np.float32([0.5, 2])}

    def clusters(m, root):
        out = []
        for r in (0, 2):
            cl = _cluster(m, root, r, 3, barrier_timeout_s=5.0)
            cl.alive = {0, 2}            # rank 1 is dead
            cl.generation = 1
            cl.sync_seq = 4              # same sync tag on both
            assert not cl.intact
            out.append(cl)
        return out

    ta, tc = clusters(TM, tmp_path / "port")
    as_t = lambda p: {k: torch.from_numpy(v.copy()).to(   # noqa: E731
        torch.bfloat16 if k == "h" else torch.float32) for k, v in p.items()}
    (oa, oc), errs = _threads((TW._average_params, (as_t(pa), ta)),
                              (TW._average_params, (as_t(pc), tc)))
    assert not errs, errs
    ja, jc = clusters(JM, tmp_path / "reference")
    as_j = lambda p: {k: jnp.asarray(v) for k, v in p.items()}  # noqa: E731
    (wa, _), errs = _threads((j_average, (as_j(pa), ja)),
                             (j_average, (as_j(pc), jc)))
    assert not errs, errs
    for out in (oa, oc):
        assert out["h"].dtype == torch.bfloat16
        for k in pa:
            np.testing.assert_array_equal(out[k].float().numpy(),
                                          np.asarray(wa[k]), err_msg=k)
    np.testing.assert_array_equal(oa["w"].numpy(), np.arange(4.0) * 2)


def _worker_env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                 if p])
    env.update(extra)
    return env


def _pair(tmp_path, tag, module, steps, extra, env, kill_at=None):
    coord = f"127.0.0.1:{_free_port()}"
    d = tmp_path / tag
    common = [sys.executable, "-m", module, "--nprocs", "2",
              "--coordinator", coord, "--ckpt-dir", str(d / "ckpt"),
              "--steps", str(steps), "--sync-every", "5",
              "--ckpt-every", "10"] + extra
    d.mkdir(parents=True)
    procs = []
    for r in (0, 1):
        with open(d / f"log{r}.txt", "w") as log:
            procs.append(subprocess.Popen(
                common + ["--rank", str(r),
                          "--result", str(d / f"r{r}.json")]
                + (["--kill-at", str(kill_at)] if r == 1 and kill_at
                   else []),
                env=env, stdout=log, stderr=subprocess.STDOUT))
    return d, procs


def _finish(d, procs):
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=CHILD_TIMEOUT_S))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    logs = [open(d / f"log{r}.txt").read()[-3000:] for r in (0, 1)]
    return rcs, logs


def _load(path):
    with open(path) as f:
        return json.load(f)


def test_two_process_host_loss_matches_reference(tmp_path):
    """Kill rank 1 at step 12 of 20 (sync 5, checkpoint 10, 4 degraded
    and 6 post-reform steps): the port's survivor detects the loss,
    adopts shard 1, reforms on 1 shard from the step-10 checkpoint, and
    replays bitwise; its timeline is the reference survivor's.  A
    fault-free port pair runs beside it: both ranks stay healthy, and
    their first batches compose into a one-process pipeline's."""
    drill = ["--degraded-steps", "4", "--post-steps", "6"]
    port_env = _worker_env(OMP_NUM_THREADS="1")
    runs = {
        "port": _pair(tmp_path, "port", "repro_torch.dist.multihost_worker",
                      20, drill + ["--device", "cpu"], port_env, kill_at=12),
        "reference": _pair(tmp_path, "reference",
                           "repro.dist.multihost_worker", 20, drill,
                           _worker_env(JAX_PLATFORMS="cpu"), kill_at=12),
        # fault-free: a wide barrier window, so a loaded host cannot fake
        # an incident
        "intact": _pair(tmp_path, "intact",
                        "repro_torch.dist.multihost_worker", 10,
                        ["--device", "cpu", "--barrier-timeout", "30",
                         "--heartbeat-timeout", "60"], port_env),
    }
    done = {tag: _finish(*run) for tag, run in runs.items()}
    for tag in ("port", "reference"):
        rcs, logs = done[tag]
        assert rcs[1] == TT.ProcKill.EXIT_CODE, (tag, logs[1])
        assert rcs[0] == 0, (tag, logs[0])
    assert done["intact"][0] == [0, 0], done["intact"][1]

    r0 = _load(runs["port"][0] / "r0.json")
    j0 = _load(runs["reference"][0] / "r0.json")
    # the ladder, in order, with the audit trail (tests/test_multihost.py)
    assert r0["incident"] == {"step": 15, "dead": [1]}
    assert r0["cluster"]["state"] == "reformed"
    states = [t[2] for t in r0["cluster"]["transitions"]]
    assert states == ["missing-host-degraded", "reformed"]
    assert ["shard 1 adopted by rank 0" in e[2]
            for e in r0["cluster"]["events"]].count(True) == 1
    dm = np.asarray(r0["degraded_weight_means"])
    assert dm.shape == (4,) and np.isfinite(dm).all() and (dm > 0).all()
    assert r0["reform_shards"] == 1 and r0["reform_writer"] is True
    assert r0["restore_step"] <= r0["incident"]["step"] + 4
    assert all(np.isfinite(r0["losses_post"]))
    # the reference survivor's timeline, key for key
    for key in ("incident", "pre_steps", "restore_step", "reform_shards",
                "reform_writer", "post_draws"):
        assert r0[key] == j0[key], key
    for key in ("generation", "alive", "state", "lost_hosts", "reforms",
                "transitions", "events"):
        assert r0["cluster"][key] == j0["cluster"][key], key
    assert len(r0["degraded_weight_means"]) == \
        len(j0["degraded_weight_means"])
    assert len(r0["losses_post"]) == len(j0["losses_post"])
    # bit-determinism across the incident
    rep = TW.replay_post_reform(str(runs["port"][0] / "ckpt"),
                                r0["restore_step"], len(r0["losses_post"]),
                                n_shards=1, device="cpu")
    assert rep["restore_step"] == r0["restore_step"]
    assert rep["digest"] == r0["post_digest"]
    assert rep["losses"] == r0["losses_post"]

    # the fault-free pair: healthy, two syncs, and rank r's first batch is
    # shard r's rows of the one-process pipeline's first batch, bitwise
    full = TW.build_pipeline(LM.init(TW.model_cfg(), seed=TW.PARAM_KEY_SEED,
                                     device="cpu"), 2, device="cpu")
    b = full.next_batch()
    m_s = b["example_ids"].shape[0] // 2
    for r in (0, 1):
        res = _load(runs["intact"][0] / f"r{r}.json")
        assert res["incident"] is None and res["final_step"] == 10
        assert res["cluster"]["state"] == "healthy"
        assert res["cluster"]["generation"] == 0
        assert [s["step"] for s in res["timings"]["syncs"]] == [5, 10]
        rows = slice(r * m_s, (r + 1) * m_s)
        fb = res["first_batch"]
        assert fb["example_ids"] == b["example_ids"][rows].tolist()
        assert fb["loss_weights_hex"] == \
            b["loss_weights"][rows].numpy().tobytes().hex()
        assert fb["tokens_sha256"] == hashlib.sha256(
            b["tokens"][rows].numpy().tobytes()).hexdigest()


# ---------------------------------------------------------------------------
# the twins of tools/chaos.py and examples/elastic_restart.py
# ---------------------------------------------------------------------------


def test_chaos_twin_fault_free_drill_exits_0():
    from repro_torch import chaos
    try:
        assert chaos.main(["--fault", "none", "--steps", "6",
                           "--device", "cpu"]) == 0
    finally:
        # main() silences warnings process-wide, as the reference CLI does
        logging.disable(logging.NOTSET)


def test_elastic_restart_twin_resumes_and_restores():
    from repro_torch import elastic_restart
    out = elastic_restart.main(["--steps", "3", "--device", "cpu"])
    assert out["resumed_at"] == 3 and out["final_step"] == 5
    assert out["restored_step"] == 5 and out["params"] > 0
    assert out["plan"]["per_device_batch_new"] * 512 * \
        out["plan"]["grad_accum_steps"] == 512
