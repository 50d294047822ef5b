"""Chaos drill CLI: inject one fault into a short LGD run of the port and
report the self-healing story (the PyTorch twin of ``tools/chaos.py``).

Each drill trains a tiny LM with the full ``Trainer`` +
``ShardedLSHPipeline`` stack while one deterministic fault from
``repro_torch.testing.faults`` fires, then checks the survival contract:
the run completes, the loss falls, and the health / skip bookkeeping
recorded what happened.  Exit 0 means the stack healed; exit 1 prints
which guarantee broke.  Runs on the card unless ``--device cpu``.

Usage:
    PYTHONPATH=src python -m repro_torch.chaos --fault refresh-raise
    PYTHONPATH=src python -m repro_torch.chaos --fault all --steps 60
    PYTHONPATH=src python -m repro_torch.chaos --drill host-loss

Faults: refresh-raise | refresh-hang | ckpt-truncate | nan-grad |
        none | all

The ``host-loss`` drill is the multi-process one: it spawns two
``repro_torch.dist.multihost_worker`` processes over a local store and a
gloo process group, hard-kills one mid-training, and checks the survivor
walked the whole elastic ladder: adopted the dead process's shard,
reformed from the newest verified checkpoint, and drew a post-reform
batch stream BITWISE a fresh restore of the same checkpoint.  It is not
part of ``--fault all``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np

from repro_torch.data import (
    HealthConfig,
    LSHPipelineConfig,
    ShardedLSHPipeline,
    lm_head_query_fn,
    make_token_corpus,
    mean_pool_feature_fn,
)
from repro_torch.kernels import resolve_device
from repro_torch.models import LM, ModelConfig
from repro_torch.optim import Adam
from repro_torch.testing import (NanLossWeights, RefreshHang, RefreshRaise,
                                 truncate_arrays)
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train import checkpoint as ckpt

FAULTS = ("refresh-raise", "refresh-hang", "ckpt-truncate", "nan-grad",
          "none")


def _cfg():
    return ModelConfig(
        name="chaos-drill", n_layers=2, d_model=32, n_heads=4,
        n_kv_heads=2, d_ff=64, vocab=64, chunk=16, loss_chunk=16,
        dtype="float32", rope_theta=10000.0, lgd_enabled=True)


def _stack(cfg, corpus, params, device, ckpt_dir=None, **pipe_kw):
    pipe_kw.setdefault("health", HealthConfig(fallback_spike=1.1))
    sampler = ShardedLSHPipeline(
        12, corpus.tokens, mean_pool_feature_fn(cfg), lm_head_query_fn(),
        LSHPipelineConfig(k=5, l=10, minibatch=16, refresh_every=10,
                          refresh_async=True, refresh_backoff=0.0,
                          **pipe_kw),
        n_shards=2, params=params, device=device)
    tcfg = TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=10, log_every=10,
                         rollback_after=3)
    return sampler, tcfg


def drill(fault: str, steps: int, device="cuda") -> dict:
    device = resolve_device(device)
    cfg = _cfg()
    corpus = make_token_corpus(11, 256, 16, cfg.vocab, hard_frac=0.15)

    def fresh_model():
        return LM.init(cfg, seed=0, device=device)

    with tempfile.TemporaryDirectory() as d:
        if fault == "ckpt-truncate":
            params = fresh_model()
            sampler, tcfg = _stack(cfg, corpus, params, device, ckpt_dir=d)
            t1 = Trainer(cfg, params, Adam(lr=1e-2), tcfg=tcfg,
                         resume=False, sampler=sampler)
            out1 = t1.run(steps // 2)
            t1.finalize()
            truncate_arrays(d, t1.step)          # corrupt the newest
            params2 = fresh_model()
            sampler2, tcfg2 = _stack(cfg, corpus, params2, device,
                                     ckpt_dir=d)
            tr = Trainer(cfg, params2, Adam(lr=1e-2), tcfg=tcfg2,
                         resume=True, sampler=sampler2)
            resumed_at = tr.step
            out = tr.run(steps - tr.step)
            tr.finalize()
            losses = out1["losses"][:resumed_at] + out["losses"]
            sampler = sampler2
        else:
            injector = None
            pipe_kw = {}
            if fault == "refresh-raise":
                injector = RefreshRaise(cycles=3)
                pipe_kw = {"refresh_retries": 1}
            elif fault == "refresh-hang":
                injector = RefreshHang(seconds=5.0, cycles=1)
                pipe_kw = {"refresh_retries": 0, "refresh_timeout": 0.25}
            params = fresh_model()
            sampler, tcfg = _stack(cfg, corpus, params, device,
                                   ckpt_dir=d, **pipe_kw)
            if injector is not None:
                sampler.set_fault_injector(injector, shard=0)
            if fault == "nan-grad":
                sampler = NanLossWeights(sampler, at_step=steps // 3,
                                         count=2)
            tr = Trainer(cfg, params, Adam(lr=1e-2), tcfg=tcfg,
                         resume=False, sampler=sampler)
            out = tr.run(steps)
            tr.finalize()
            losses = out["losses"]

        finite = [v for v in losses if np.isfinite(v)]
        report = {
            "fault": fault,
            "steps": len(losses),
            "loss_head": float(np.mean(finite[:5])),
            "loss_tail": float(np.mean(finite[-5:])),
            "skipped_steps": tr.skipped_steps,
            "rollbacks": tr.rollbacks,
            "health": sampler.health_state(),
            "transitions": sampler.health_summary()["transitions"],
            "valid_ckpt": ckpt.latest_valid_step(d),
        }
        report["survived"] = (
            len(losses) == steps
            and np.isfinite(report["loss_tail"])
            and report["loss_tail"] < report["loss_head"])
        return report


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def drill_host_loss(steps: int, verbose: bool = False,
                    device="cuda") -> dict:
    """The multi-process drill: 2 real OS processes, one dies.

    Spawns two ``multihost_worker`` processes over a local store, arms
    ``ProcKill`` on rank 1 at step 12, and checks the survival contract:

      * rank 1 exits with the injected death code (it really died);
      * rank 0 detected the loss, adopted shard 1, ran degraded, and
        REFORMED from the newest verified checkpoint on 1 shard;
      * the post-reform stream's digest equals a fresh restore of the
        same checkpoint in THIS process (``replay_post_reform``).
    """
    from repro_torch.dist.multihost_worker import replay_post_reform
    from repro_torch.testing import ProcKill

    device = resolve_device(device)
    steps = max(steps, 25)               # room for ckpt + sync + kill
    src = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                 if p])
    with tempfile.TemporaryDirectory() as d:
        coord = f"127.0.0.1:{_free_port()}"
        common = [sys.executable, "-m", "repro_torch.dist.multihost_worker",
                  "--nprocs", "2", "--coordinator", coord,
                  "--ckpt-dir", os.path.join(d, "ckpt"),
                  "--steps", str(steps), "--sync-every", "5",
                  "--ckpt-every", "10", "--device", device.type]
        procs = [subprocess.Popen(
            common + ["--rank", str(r),
                      "--result", os.path.join(d, f"r{r}.json")]
            + (["--kill-at", "12"] if r == 1 else []),
            env=env,
            stdout=None if verbose else subprocess.DEVNULL,
            stderr=None if verbose else subprocess.DEVNULL,
        ) for r in (0, 1)]
        rcs = [p.wait(timeout=600) for p in procs]

        report = {"fault": "host-loss", "steps": steps,
                  "exit_codes": rcs, "survived": False}
        res_path = os.path.join(d, "r0.json")
        if rcs[0] != 0 or rcs[1] != ProcKill.EXIT_CODE or \
                not os.path.exists(res_path):
            return report
        with open(res_path) as f:
            r0 = json.load(f)
        report.update(
            incident=r0.get("incident"),
            restore_step=r0.get("restore_step"),
            reform_shards=r0.get("reform_shards"),
            health=r0["cluster"]["state"],
            transitions=r0["cluster"]["transitions"],
        )
        rep = replay_post_reform(
            os.path.join(d, "ckpt"), r0["restore_step"],
            len(r0["losses_post"]), n_shards=r0["reform_shards"],
            device=device)
        report["digest_match"] = rep["digest"] == r0["post_digest"]
        report["survived"] = (
            r0.get("incident") is not None
            and r0["cluster"]["state"] == "reformed"
            and r0["reform_shards"] == 1
            and report["digest_match"]
            and all(np.isfinite(r0["losses_post"])))
        return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fault", default="all",
                    choices=FAULTS + ("all",))
    ap.add_argument("--drill", default=None, choices=("host-loss",),
                    help="multi-process drill (separate from --fault)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="show the health log as faults fire")
    args = ap.parse_args(argv)
    if not args.verbose:
        logging.disable(logging.WARNING)

    if args.drill == "host-loss":
        r = drill_host_loss(args.steps, verbose=args.verbose,
                            device=args.device)
        verdict = "SURVIVED" if r["survived"] else "DIED"
        print(f"[{verdict}] host-loss exit_codes={r['exit_codes']} "
              f"incident={r.get('incident')} "
              f"reform_shards={r.get('reform_shards')} "
              f"digest_match={r.get('digest_match')} "
              f"health={r.get('health')}")
        for t in r.get("transitions", []):
            print(f"    transition: {t}")
        return 0 if r["survived"] else 1

    faults = list(FAULTS) if args.fault == "all" else [args.fault]
    failed = []
    for f in faults:
        r = drill(f, args.steps, device=args.device)
        verdict = "SURVIVED" if r["survived"] else "DIED"
        print(f"[{verdict}] {f:14s} loss {r['loss_head']:.3f} -> "
              f"{r['loss_tail']:.3f}  skipped={r['skipped_steps']} "
              f"rollbacks={r['rollbacks']} health={r['health']}")
        for t in r["transitions"]:
            print(f"    transition: {t}")
        if not r["survived"]:
            failed.append(f)
    if failed:
        print(f"FAILED drills: {', '.join(failed)}")
        return 1
    print(f"all {len(faults)} drill(s) survived")
    return 0


if __name__ == "__main__":
    sys.exit(main())
