"""One process of a multi-process elastic LGD run (+ the replay harness),
PyTorch port of ``repro.dist.multihost_worker``.

Process r owns corpus shard r (``ShardedLSHPipeline(...,
owned_shards=[r])``), hashes and refreshes locally, and crosses to its
peers only for the barrier-guarded parameter average every
``sync_every`` steps.  The elastic story, end to end in one process's
life:

  1. HEALTHY: train on the local shard's draws; heartbeat each step; at
     sync boundaries pass ``sync_barrier``, then average the parameters
     over the process group (one flat f32 host buffer, a gloo
     ``all_reduce``, copied back into the live parameters).
  2. INCIDENT: a sync barrier exhausts its retries; the step hook
     classifies the failure (stale heartbeats name the dead) and raises
     ``HostLossDetected``, unwinding ``Trainer.run`` at a clean step
     boundary.
  3. DEGRADED: the survivors ADOPT the lost shards (``adopt_shards``:
     same shard count and bounds, so batch weights keep the exact
     w = S/(p·N) form) and keep training; with more than one survivor the
     parameter sync goes on through the store (``exchange_blobs``: the
     process group still contains the dead rank, so its collectives
     would wait for it), at a cadence and under names keyed by
     generation-local counters, so survivors that unwound at divergent
     steps still meet.
  4. REFORM: restore the newest verified checkpoint
     (``restore_latest_valid_on_mesh``) into the live model and rebuild
     the pipeline on the surviving shard count
     (``rebuild_sharded_pipeline``, n_shards = survivors); ONE fenced
     writer (the lowest surviving rank, ``claim_reform_writer``) owns the
     shared checkpoint dir from here; the post-reform batch stream is
     bitwise a fresh restore of the same checkpoint (``replay_post_reform``
     recomputes its digest to prove it).
  5. DETACH: results flushed, ``finalize_and_exit`` hard-exits (the
     process group and the store can wait forever for a dead peer).

The model and pipeline are a ``Stack``: the reference's tiny model and
corpus by default (a two-process CPU run finishes in seconds), or any
config a caller passes to ``run_worker`` / ``build_pipeline`` /
``replay_post_reform`` (``chip_smoke.py`` runs zamba2 whole).  Faults are
the deterministic injectors of ``repro_torch.testing`` (``ProcKill`` /
``ProcHang``), armed per rank from the command line.  Runs on the card
unless ``--device cpu``: process r on card r when the host has a card a
process, else on card ``r % device_count()`` (the processes share the
cards; ``worker_device``; each process prints its device first).  On
the card the result also carries the kernels' launch counts and the
peak memory at exit.

Usage (one line a process, one shared coordinator address):

    PYTHONPATH=src python -m repro_torch.dist.multihost_worker \\
        --rank 0 --nprocs 2 --coordinator 127.0.0.1:9876 \\
        --ckpt-dir /tmp/mh/ckpt --result /tmp/mh/r0.json --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import io
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .multihost import (
    BarrierTimeout,
    ElasticCluster,
    HostLossDetected,
    MultihostConfig,
    claim_reform_writer,
    finalize_and_exit,
    initialize,
)

# deterministic tiny-stack constants, shared by the worker AND the replay
# harness: the reform digest is only meaningful because both rebuild from
# the same (seed, corpus, config) triple
PIPE_KEY_SEED = 12
PARAM_KEY_SEED = 0
CORPUS = dict(seed=11, n_examples=256, seq_len=16, hard_frac=0.15)
LR = 1e-2


def model_cfg():
    from repro_torch.models import ModelConfig
    return ModelConfig(
        name="multihost-worker", n_layers=2, d_model=32, n_heads=4,
        n_kv_heads=2, d_ff=64, vocab=64, chunk=16, loss_chunk=16,
        dtype="float32", rope_theta=10000.0, lgd_enabled=True)


def pipe_cfg():
    from repro_torch.data import LSHPipelineConfig
    # synchronous refresh: the elastic protocol is the thing under test,
    # and an async refresh's worker would outlive an os._exit drill.  RAW
    # w = S/(p·N) weights (no mean-1 normalisation): a partial owner never
    # sees the global batch, and E[mean w] = 1 is only meaningful on
    # unnormalised weights.
    return LSHPipelineConfig(k=5, l=10, minibatch=16, refresh_every=10,
                             refresh_async=False, refresh_backoff=0.0,
                             normalize_weights=False)


@dataclasses.dataclass
class Stack:
    """What a run trains: the model config, the pipeline config (its
    ``minibatch`` is the GLOBAL batch), the token corpus (``CORPUS``'s
    keys), the Adam learning rate and the pipeline's feature batch.  The
    default is the reference's tiny stack."""

    model: Any = dataclasses.field(default_factory=model_cfg)
    pipe: Any = dataclasses.field(default_factory=pipe_cfg)
    corpus: dict = dataclasses.field(default_factory=lambda: dict(CORPUS))
    lr: float = LR
    feature_batch: int = 512

    def tokens(self) -> np.ndarray:
        from repro_torch.data import make_token_corpus
        c = self.corpus
        return make_token_corpus(c["seed"], c["n_examples"], c["seq_len"],
                                 self.model.vocab,
                                 hard_frac=c["hard_frac"]).tokens


def build_pipeline(params, n_shards: int,
                   owned_shards: Optional[List[int]] = None,
                   stack: Optional[Stack] = None, device="cuda"):
    """The deterministic worker pipeline (any shard layout): same seed,
    corpus and config on every process, so shard s's draw stream is the
    same whichever process owns it."""
    from repro_torch.data import (
        ShardedLSHPipeline, lm_head_query_fn, mean_pool_feature_fn)
    stack = Stack() if stack is None else stack
    return ShardedLSHPipeline(
        PIPE_KEY_SEED, stack.tokens(), mean_pool_feature_fn(stack.model),
        lm_head_query_fn(), dataclasses.replace(stack.pipe),
        n_shards=n_shards, feature_batch=stack.feature_batch,
        params=params, owned_shards=owned_shards, device=device)


def _rebuild_pipeline(params, step: int, n_shards: int, stack: Stack,
                      device):
    from repro_torch.data import lm_head_query_fn, mean_pool_feature_fn
    from repro_torch.train.elastic import rebuild_sharded_pipeline
    return rebuild_sharded_pipeline(
        PIPE_KEY_SEED, stack.tokens(), mean_pool_feature_fn(stack.model),
        lm_head_query_fn(), dataclasses.replace(stack.pipe), step,
        n_shards=n_shards, params=params,
        feature_batch=stack.feature_batch, device=device)


class RecordBatches:
    """Sampler proxy recording every draw's (example_ids, loss_weights):
    the raw material for the unbiasedness check (mean weight per batch)
    and the bit-determinism digest.  ``first`` keeps host copies of the
    first batch's ids, tokens and weights.  The rest of the sampler
    surface delegates to the wrapped pipeline."""

    def __init__(self, inner):
        self._inner = inner
        self.records: List[tuple] = []     # (ids bytes, weights bytes)
        self.weight_means: List[float] = []
        self.fallback_shares: List[float] = []   # each batch's uniform share
        self.first: Optional[dict] = None

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def next_batch(self, *args, **kwargs):
        b = self._inner.next_batch(*args, **kwargs)
        ids = b["example_ids"].to(torch.int64).cpu().numpy()
        w = b["loss_weights"].to(torch.float32).cpu().numpy()
        self.records.append((ids.tobytes(), w.tobytes()))
        self.weight_means.append(float(w.mean()))
        self.fallback_shares.append(
            self._inner.sampler_stats()["last_fallback_rate"])
        if self.first is None:
            self.first = {"example_ids": ids,
                          "tokens": b["tokens"].cpu().numpy(),
                          "loss_weights": w}
        return b


def batch_digest(records) -> str:
    """Order-sensitive digest over recorded draws: two streams agree iff
    every batch's ids AND weights agree bitwise, in order."""
    h = hashlib.sha256()
    for ids_bytes, w_bytes in records:
        h.update(ids_bytes)
        h.update(w_bytes)
    return h.hexdigest()


def _average_params(params: Dict[str, torch.Tensor], cluster: ElasticCluster,
                    stats: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """Cross-process parameter average over the CURRENT alive set
    (local-SGD sync), in f32: ``{name: tensor}`` -> new tensors, each on
    its parameter's device in its dtype.

    Intact cluster: one flat f32 host buffer of every parameter, a gloo
    ``all_reduce(SUM)`` over the process group, then / world.  Degraded
    cluster (survivors after a loss): the process group STILL CONTAINS
    the dead rank, so its collectives would wait for it whatever the
    survivor barrier says; the surviving subset all-gathers through the
    store instead (``exchange_blobs``, keyed by generation and sync
    sequence number) and sums the blobs in rank order.  ``stats`` gets
    the seconds of the collective (``allreduce_s`` or ``exchange_s``)."""
    names = list(params)
    if cluster.intact:
        total = sum(params[k].numel() for k in names)
        flat = torch.empty(total, dtype=torch.float32)
        off = 0
        for k in names:
            n = params[k].numel()
            flat[off:off + n].copy_(params[k].detach().reshape(-1))
            off += n
        t0 = time.perf_counter()
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        if stats is not None:
            stats["allreduce_s"] = time.perf_counter() - t0
        flat /= cluster.cfg.num_processes
        out, off = {}, 0
        for k in names:
            p = params[k]
            out[k] = flat[off:off + p.numel()].view(p.shape).to(
                device=p.device, dtype=p.dtype)
            off += p.numel()
        return out
    buf = io.BytesIO()
    np.savez(buf, *[params[k].detach().float().cpu().numpy()
                    for k in names])
    t0 = time.perf_counter()
    blobs = cluster.exchange_blobs(f"avg{cluster.sync_seq}", buf.getvalue())
    if stats is not None:
        stats["exchange_s"] = time.perf_counter() - t0
    acc = None
    for _, raw in sorted(blobs.items()):
        with np.load(io.BytesIO(raw)) as z:
            peer = [z[f"arr_{i}"] for i in range(len(names))]
        acc = peer if acc is None else [a + p for a, p in zip(acc, peer)]
    return {k: torch.from_numpy(a / np.float32(len(blobs))).to(
                device=params[k].device, dtype=params[k].dtype)
            for k, a in zip(names, acc)}


def _state_template(model, optimizer) -> dict:
    """The checkpoint tree of a trainer of ``model`` (``Trainer._state_
    tree``), restored in place: the live parameters and fresh slots."""
    named = dict(model.named_parameters())
    return {"params": named,
            "opt_state": optimizer.init(
                {k: p.detach() for k, p in named.items()})}


def replay_post_reform(ckpt_dir: str, restore_step: int, n_steps: int,
                       n_shards: int = 1, stack: Optional[Stack] = None,
                       device="cuda") -> Dict[str, Any]:
    """Fresh restore of the reform checkpoint → digest of its stream.

    The determinism oracle: rebuild EXACTLY what the survivor rebuilt
    (same checkpoint step, same shard count, same stack), run the same
    number of steps, and return the digest; bit-equality with the
    survivor's ``post_digest`` proves the reformed stream is a pure
    function of (checkpoint, shard count), not of the incident history.
    Restores READ-ONLY at ``restore_step`` (no ``discard_after``: the
    survivor's own post-reform checkpoints must outlive the replay).
    """
    from repro_torch.kernels import require_full_fp32, resolve_device
    from repro_torch.models import LM
    from repro_torch.optim import Adam
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train import checkpoint as ckpt

    stack = Stack() if stack is None else stack
    device = resolve_device(device)
    if device.type == "cuda":
        require_full_fp32()
    cfg = stack.model
    model = LM.init(cfg, seed=PARAM_KEY_SEED, device=device)
    optimizer = Adam(lr=stack.lr)
    state, extra = ckpt.restore(ckpt_dir, restore_step,
                                _state_template(model, optimizer),
                                in_place=True)
    step = extra.get("step", restore_step)
    rec = RecordBatches(_rebuild_pipeline(model, step, n_shards, stack,
                                          device))
    tr = Trainer(cfg, model, optimizer,
                 tcfg=TrainerConfig(ckpt_dir=None, log_every=1000),
                 resume=False, sampler=rec)
    tr.opt_state = state["opt_state"]
    tr.step = step
    out = tr.run(n_steps)
    tr.finalize()
    return {
        "digest": batch_digest(rec.records),
        "losses": out["losses"],
        "restore_step": tr.step - len(out["losses"]),
        "weight_means": rec.weight_means,
    }


def make_step_hook(cluster: ElasticCluster, timings: Optional[dict] = None):
    """The trainer attachment point: heartbeat every step; at sync
    boundaries (``cluster.at_sync_boundary``, generation-local cadence),
    barrier, then average the parameters over the alive set and copy the
    average into the live ones.  Raises ``HostLossDetected`` out of the
    trainer when the barrier exhausts its retries: the worker's incident
    handler takes over.  ``timings``: each hook's start on the host clock
    under ``hook_stamps`` (the beats), and each sync's barrier, average and
    collective seconds under ``syncs``."""

    def hook(tr):
        step = tr.step
        if timings is not None:
            timings.setdefault("hook_stamps", []).append(time.perf_counter())
        cluster.heartbeat(step)
        # boundary and barrier name both come from generation-LOCAL
        # counters, not tr.step: survivors unwind an incident at divergent
        # steps, and step-named barriers would time each other out
        if not cluster.at_sync_boundary():
            return
        if len(cluster.alive) <= 1:
            return                      # nothing to sync with
        stats = {"step": step}
        try:
            t0 = time.perf_counter()
            cluster.sync_barrier(cluster.next_sync_tag())
            t1 = time.perf_counter()
            # the average itself may barrier again (degraded exchange): a
            # survivor dying mid-exchange classifies like any other loss
            avg = _average_params(tr.named_params, cluster, stats)
        except BarrierTimeout:
            raise HostLossDetected(step, cluster.classify_failure(step))
        with torch.no_grad():
            for k, p in tr.named_params.items():
                p.copy_(avg[k])
        del avg
        tr.sampler.set_params(tr.params)
        if timings is not None:
            stats.update(barrier_s=t1 - t0,
                         average_s=time.perf_counter() - t1)
            timings.setdefault("syncs", []).append(stats)

    return hook


def worker_device(device, rank: int) -> torch.device:
    """Process ``rank``'s device, made the current card: a bare
    ``"cuda"`` is ``cuda:card_for(rank)``, card ``rank`` when the host
    has one for every process, else one that processes share; no card
    raises, never falls back to the CPU."""
    from repro_torch.kernels import card_for, resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        if torch.device(device).index is None:
            dev = torch.device("cuda", card_for(rank))
        torch.cuda.set_device(dev)
    return dev


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_worker(args, stack: Optional[Stack] = None) -> int:
    from repro_torch import kernels
    from repro_torch.kernels import require_full_fp32
    from repro_torch.models import LM
    from repro_torch.optim import Adam
    from repro_torch.testing import ProcHang, ProcKill
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.elastic import restore_latest_valid_on_mesh

    stack = Stack() if stack is None else stack
    device = worker_device(args.device, args.rank)
    print(f"worker rank {args.rank} on {device}", flush=True)
    if device.type == "cuda":
        require_full_fp32()
    mcfg = MultihostConfig(
        rank=args.rank, num_processes=args.nprocs,
        coordinator=args.coordinator,
        heartbeat_timeout_s=args.heartbeat_timeout,
        barrier_timeout_s=args.barrier_timeout,
        barrier_retries=args.barrier_retries,
        barrier_backoff_s=args.barrier_backoff,
        sync_every=args.sync_every)
    coord = initialize(mcfg)
    cluster = ElasticCluster(mcfg, coord)
    if args.kill_at is not None:
        cluster.set_fault_injector(ProcKill(at_step=args.kill_at))
    elif args.hang_at is not None:
        cluster.set_fault_injector(
            ProcHang(at_step=args.hang_at, seconds=args.hang_seconds))

    # per-step host clocks (one stamp per completed step, sync cost
    # included at sync boundaries)
    step_stamps: List[float] = []
    timings: Dict[str, Any] = {"step_stamps": step_stamps}

    cfg = stack.model
    model = LM.init(cfg, seed=PARAM_KEY_SEED, device=device)
    t0 = time.perf_counter()
    pipe = build_pipeline(model, n_shards=args.nprocs,
                          owned_shards=[args.rank], stack=stack,
                          device=device)
    _sync(device)
    timings["build_s"] = time.perf_counter() - t0
    # the index's fallback diagnostics after each build and refresh
    index_log: List[dict] = [dict(pipe.index_stats(), at="build", step=0)]
    seen_refreshes = [0]

    def log_refreshes(tr_, p_):
        n_ref = len(p_.refresh_records())
        if n_ref > seen_refreshes[0]:
            seen_refreshes[0] = n_ref
            index_log.append(dict(p_.index_stats(), at="refresh",
                                  step=tr_.step))

    rec = RecordBatches(pipe)
    # checkpoints: rank 0 writes (one writer); every rank knows the path
    # for the reform restore
    elastic_hook = make_step_hook(cluster, timings)

    def timed_hook(tr_):
        elastic_hook(tr_)               # may raise HostLossDetected
        step_stamps.append(time.perf_counter())
        log_refreshes(tr_, tr_.sampler)

    tcfg = TrainerConfig(
        ckpt_dir=args.ckpt_dir if args.rank == 0 else None,
        ckpt_every=args.ckpt_every, log_every=1000,
        step_hook=timed_hook)
    tr = Trainer(cfg, model, Adam(lr=stack.lr), tcfg=tcfg, resume=False,
                 sampler=rec)

    result: Dict[str, Any] = {"rank": args.rank, "incident": None}
    incident = None
    try:
        out = tr.run(args.steps)
        result["losses_pre"] = out["losses"]
    except HostLossDetected as e:
        incident = e
        timings["incident_wall_t"] = time.time()

    if incident is not None:
        result["incident"] = {"step": incident.step,
                              "dead": incident.dead}
        result["pre_steps"] = tr.step   # run() unwound; no losses list
        # -- DEGRADED: adopt the lost shards, keep training locally -------
        adopt = cluster.shards_to_adopt(args.nprocs)
        t0 = time.perf_counter()
        pipe.adopt_shards(adopt, step=tr.step)
        _sync(device)
        timings["adopt_s"] = time.perf_counter() - t0
        cluster.note_adopted(tr.step, adopt)
        index_log.append(dict(pipe.index_stats(), at="adoption",
                              step=tr.step))
        seen_refreshes[0] = len(pipe.refresh_records())
        # the raise unwound run() AFTER its prefetch draw: the old shards'
        # counters sit one draw ahead of tr.step.  Realign the whole
        # pipeline (counters only, no rebuild).
        pipe.restore_at(tr.step, rebuild=False)
        n_before = len(rec.records)
        out_deg = tr.run(args.degraded_steps)
        result["losses_degraded"] = out_deg["losses"]
        result["degraded_weight_means"] = rec.weight_means[n_before:]
        result["degraded_fallback_shares"] = rec.fallback_shares[n_before:]
        tr.finalize()
        result["pre_draws"] = n_before
        first = rec.first
        # the pre-incident trainer's slots go before the restore allocates
        del tr, pipe, rec

        # -- REFORM: newest verified checkpoint, surviving shards ---------
        n_surv = len(cluster.alive)
        # single writer: the lowest surviving rank claims the shared dir
        # through the generation fence; every other survivor (or a
        # split-brain loser) restores READ-ONLY
        writer = claim_reform_writer(
            args.ckpt_dir, cluster.generation, args.rank, cluster.alive)
        t_reform0 = time.perf_counter()
        optimizer = Adam(lr=stack.lr)
        step_r, state, extra = restore_latest_valid_on_mesh(
            args.ckpt_dir, _state_template(model, optimizer), in_place=True)
        step_r = extra.get("step", step_r)
        rec2 = RecordBatches(_rebuild_pipeline(model, step_r, n_surv, stack,
                                               device))
        index_log.append(dict(rec2.index_stats(), at="rebuild",
                              step=step_r))
        seen_refreshes[0] = len(rec2.refresh_records())

        def mark_first_post_step(tr_):
            # restore + rebuild + the first post-reform step, one number
            timings.setdefault(
                "reform_to_first_step_s",
                time.perf_counter() - t_reform0)
            log_refreshes(tr_, rec2)

        tr2 = Trainer(cfg, model, optimizer,
                      tcfg=TrainerConfig(
                          ckpt_dir=args.ckpt_dir if writer else None,
                          ckpt_every=args.ckpt_every,
                          log_every=1000,
                          step_hook=mark_first_post_step),
                      resume=False, sampler=rec2)
        tr2.opt_state = state["opt_state"]
        tr2.step = step_r
        del state
        if writer:
            # the incident timeline past the restore point is abandoned;
            # writer-only: a racing discard is exactly the corruption the
            # fence prevents
            ckpt.discard_after(args.ckpt_dir, tr2.step)
        cluster.note_reformed(tr2.step, n_surv)
        result["restore_step"] = tr2.step
        result["reform_shards"] = n_surv
        result["reform_writer"] = writer
        out_post = tr2.run(args.post_steps)
        tr2.finalize()
        result["losses_post"] = out_post["losses"]
        result["post_digest"] = batch_digest(rec2.records)
        result["post_draws"] = len(rec2.records)
    else:
        tr.finalize()
        result["final_step"] = tr.step
        result["weight_means"] = rec.weight_means
        result["digest"] = batch_digest(rec.records)
        first = rec.first

    result["cluster"] = cluster.summary()
    result["timings"] = timings
    result["index_stats"] = index_log
    if first is not None:
        result["first_batch"] = {
            "example_ids": first["example_ids"].tolist(),
            "tokens_sha256": hashlib.sha256(
                first["tokens"].tobytes()).hexdigest(),
            "loss_weights_hex": first["loss_weights"].tobytes().hex()}
    if device.type == "cuda":
        result["launches"] = dict(kernels.launches)
        result["max_memory_allocated"] = torch.cuda.max_memory_allocated(
            device)
    if args.result:
        os.makedirs(os.path.dirname(args.result) or ".", exist_ok=True)
        tmp = args.result + ".tmp"
        with open(tmp, "w") as f:
            json.dump(result, f)
        os.replace(tmp, args.result)
    finalize_and_exit(cluster, 0)


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--coordinator", default="127.0.0.1:9876",
                    help="host:port of the store rank 0 hosts")
    ap.add_argument("--ckpt-dir", required=True,
                    help="shared checkpoint dir (rank 0 writes pre-"
                         "incident; the fenced lowest survivor after)")
    ap.add_argument("--result", default="",
                    help="write this rank's result JSON here")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--sync-every", type=int, default=5)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--degraded-steps", type=int, default=6)
    ap.add_argument("--post-steps", type=int, default=10)
    ap.add_argument("--heartbeat-timeout", type=float, default=3.0)
    ap.add_argument("--barrier-timeout", type=float, default=2.0)
    ap.add_argument("--barrier-retries", type=int, default=1)
    ap.add_argument("--barrier-backoff", type=float, default=0.1)
    ap.add_argument("--kill-at", type=int, default=None,
                    help="hard-exit THIS rank at this step (ProcKill)")
    ap.add_argument("--hang-at", type=int, default=None,
                    help="stall THIS rank at this step (ProcHang)")
    ap.add_argument("--hang-seconds", type=float, default=8.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    return run_worker(build_arg_parser().parse_args(argv))


if __name__ == "__main__":
    main()
