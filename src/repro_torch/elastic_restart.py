"""Fault-tolerance demo: train, crash, restart, then restore for a rescale
(the PyTorch twin of ``examples/elastic_restart.py``).

  1. trains ``--steps`` steps (60), checkpointing every third of them
  2. simulates a node failure (the trainer object is dropped)
  3. a fresh Trainer resumes from the last step deterministically and
     trains two thirds as many again
  4. the newest VERIFIED checkpoint is restored through
     ``restore_latest_valid_on_mesh`` onto ``make_host_mesh()`` (the
     job's ranks, (n, 1): 1 x 1 for a lone process, as the reference
     example restores onto a (1, 1) mesh), every leaf a DTensor placed
     by ``tree_param_shardings``, and ``rescale_plan`` prints the elastic
     rescale policy for 256 -> 512 devices at a global batch of 512 (the
     reference example asks for a batch of 256, which does not divide
     over 512 devices, so its ``rescale_plan`` raises).

Under ``torchrun`` (one process a card) rank 0 trains, crashes and
resumes (steps 1-3, printed as phases 1 and 2) in a directory every rank
reads, every rank restores its shards (step 4, printed as phase 3), and
only rank 0 prints.  Runs on the card unless ``--device cpu``.

Run:  PYTHONPATH=src python -m repro_torch.elastic_restart [--steps 60]
          [--device cpu]
      PYTHONPATH=src torchrun --nproc-per-node N -m \\
          repro_torch.elastic_restart
"""

from __future__ import annotations

import argparse
import shutil
import tempfile

import torch.distributed as dist

from repro_torch.data import make_token_corpus, uniform_batches
from repro_torch.dist.sharding import mesh_axes
from repro_torch.kernels import resolve_device
from repro_torch.launch.mesh import host_mesh_scope, job_scope
from repro_torch.models import LM, ModelConfig
from repro_torch.optim import Adam
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.elastic import (rescale_plan,
                                       restore_latest_valid_on_mesh)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60,
                    help="phase 1's steps (a multiple of 3)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    every = max(args.steps // 3, 1)

    cfg = ModelConfig(name="elastic-demo", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                      chunk=16, loss_chunk=32, dtype="float32",
                      rope_theta=10000.0)
    corpus = make_token_corpus(0, 512, 32, cfg.vocab)

    with job_scope(device.type):
        lead = dist.get_rank() == 0
        # rank 0 trains into a directory every rank restores from
        box = [tempfile.mkdtemp(prefix="elastic_restart_") if lead else None]
        dist.broadcast_object_list(box, src=0)
        d = box[0]
        try:
            box = [_train_and_resume(cfg, corpus, device, d, args.steps,
                                     every) if lead else None]
            dist.broadcast_object_list(box, src=0)
            out = box[0]
            out.update(_restore_on_host_mesh(cfg, device, d, lead))
        finally:
            dist.barrier()
            if lead:
                shutil.rmtree(d, ignore_errors=True)
    plan = rescale_plan(256, 512, global_batch=512)
    if lead:
        print("rescale plan 256->512 devices, global batch 512:", plan)
    out["plan"] = plan
    return out


def _train_and_resume(cfg, corpus, device, d, steps, every) -> dict:
    """Steps 1-3 in this process: train, drop the trainer, resume."""
    def fresh(resume):
        return Trainer(cfg, LM.init(cfg, seed=0, device=device),
                       Adam(lr=1e-2),
                       uniform_batches(corpus, 8, seed=1, device=device),
                       TrainerConfig(ckpt_dir=d, ckpt_every=every,
                                     log_every=every),
                       resume=resume)

    t1 = fresh(resume=False)
    t1.run(steps)
    t1.finalize()
    print(f"phase 1: trained to step {t1.step}, "
          f"latest ckpt = step {ckpt.latest_step(d)}")
    loss_before_crash = t1.metrics_history[-1]["loss"]
    del t1  # << node failure

    t2 = fresh(resume=True)
    resumed_at = t2.step
    print(f"phase 2: restarted at step {t2.step} (auto-resume)")
    t2.run(2 * steps // 3)
    t2.finalize()
    print(f"phase 2: continued to step {t2.step}, "
          f"loss {t2.metrics_history[-1]['loss']:.4f} "
          f"(pre-crash {loss_before_crash:.4f})")
    return {"resumed_at": resumed_at, "final_step": t2.step}


def _restore_on_host_mesh(cfg, device, d, lead: bool) -> dict:
    """Step 4 on every rank: the newest verified checkpoint of ``d``
    onto the host mesh with the placements of tree_param_shardings (on a
    fleet: the new device count's mesh)."""
    model = LM.init(cfg, seed=0, device=device)
    named = dict(model.named_parameters())
    template = {"params": named,
                "opt_state": Adam(lr=1e-2).init(
                    {k: p.detach() for k, p in named.items()})}
    with host_mesh_scope(device.type) as mesh:
        # integrity-checked selection: a checkpoint truncated by the
        # "failure" would be skipped for the newest VALID one
        step_v, state, extra = restore_latest_valid_on_mesh(
            d, template, mesh, cfg=cfg)
        n = sum(x.numel() for x in state["params"].values())
        placed = all(hasattr(x, "placements")
                     for x in state["params"].values())
        if lead:
            print(f"phase 3: restored step {extra['step']} onto mesh "
                  f"{mesh_axes(mesh)} ({n / 1e6:.2f}M params placed)")
    return {"restored_step": step_v, "params": n, "mesh": mesh_axes(mesh),
            "placed": placed}


if __name__ == "__main__":
    main()
