"""Fault-tolerance demo: train, crash, restart, then restore for a rescale
(the PyTorch twin of ``examples/elastic_restart.py``).

  1. trains ``--steps`` steps (60), checkpointing every third of them
  2. simulates a node failure (the trainer object is dropped)
  3. a fresh Trainer resumes from the last step deterministically and
     trains two thirds as many again
  4. the newest VERIFIED checkpoint is restored through
     ``restore_latest_valid_on_mesh`` onto the one device, and
     ``rescale_plan`` prints the elastic rescale policy for 256 -> 512
     devices at a global batch of 512 (the reference example asks for a
     batch of 256, which does not divide over 512 devices, so its
     ``rescale_plan`` raises).  The reference restores onto a mesh of
     several devices; placement over several devices is ROADMAP.md
     queue 1 item 6c.

Runs on the card unless ``--device cpu``.

Run:  PYTHONPATH=src python -m repro_torch.elastic_restart [--steps 60]
          [--device cpu]
"""

from __future__ import annotations

import argparse
import tempfile

from repro_torch.data import make_token_corpus, uniform_batches
from repro_torch.kernels import resolve_device
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

    with tempfile.TemporaryDirectory() as d:
        def fresh(resume):
            return Trainer(cfg, LM.init(cfg, seed=0, device=device),
                           Adam(lr=1e-2),
                           uniform_batches(corpus, 8, seed=1, device=device),
                           TrainerConfig(ckpt_dir=d, ckpt_every=every,
                                         log_every=every),
                           resume=resume)

        t1 = fresh(resume=False)
        t1.run(args.steps)
        t1.finalize()
        print(f"phase 1: trained to step {t1.step}, "
              f"latest ckpt = step {ckpt.latest_step(d)}")
        loss_before_crash = t1.metrics_history[-1]["loss"]
        del t1  # << node failure

        t2 = fresh(resume=True)
        resumed_at = t2.step
        print(f"phase 2: restarted at step {t2.step} (auto-resume)")
        t2.run(2 * args.steps // 3)
        t2.finalize()
        print(f"phase 2: continued to step {t2.step}, "
              f"loss {t2.metrics_history[-1]['loss']:.4f} "
              f"(pre-crash {loss_before_crash:.4f})")

        # elastic restore: the same checkpoint onto this process's one
        # device (on a fleet: the new device count's placement, item 6c)
        model = LM.init(cfg, seed=0, device=device)
        named = dict(model.named_parameters())
        template = {"params": named,
                    "opt_state": Adam(lr=1e-2).init(
                        {k: p.detach() for k, p in named.items()})}
        # integrity-checked selection: a checkpoint truncated by the
        # "failure" would be skipped for the newest VALID one
        step_v, state, extra = restore_latest_valid_on_mesh(d, template)
        n = sum(x.numel() for x in state["params"].values())
        print(f"phase 3: restored step {extra['step']} onto {device} "
              f"({n / 1e6:.2f}M params)")
        plan = rescale_plan(256, 512, global_batch=512)
        print("rescale plan 256->512 devices, global batch 512:", plan)
    return {"resumed_at": resumed_at, "final_step": t2.step,
            "restored_step": step_v, "params": n, "plan": plan}


if __name__ == "__main__":
    main()
