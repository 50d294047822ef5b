"""End-to-end driver: train a decoder LM with the LGD-sampled data pipeline.

The PyTorch twin of ``examples/train_lm.py``.

Presets:
  demo  (default)  ~1.2M params, a few hundred steps on a CPU in minutes —
                   compares the LSH-sampled pipeline against uniform.
  100m             ~100M-param config (d=768, 12L); the same code path,
                   bigger numbers.

Sampler (``--sampler {uniform,lgd}``):
  uniform          i.i.d. uniform batches (the SGD baseline).
  lgd              the paper's LSH-sampled adaptive batches: example
                   features (pooled last-layer states) are hashed into an
                   LSH index; each step queries it with the output-layer
                   direction and draws Algorithm-1 samples, de-biased by
                   1/(p_i N) importance weights inside the loss.  Batches
                   are drawn on the device from its resident token store;
                   the periodic index refresh runs on a worker thread
                   (on the card its own CUDA stream).

Refresh mode (``--refresh-mode {full,delta}``): re-embed and re-hash the
whole corpus every ``refresh_every`` steps, or only the rows visited
since the last refresh plus a drift sample, merged into the sorted index.

Shards (``--shards S``): shard-by-example LGD, a ``ShardedLSHPipeline``
of S per-shard indexes over contiguous corpus shards (one a
data-parallel group), composed into one batch with weights S/(p·N), in
one process on one device.  Several processes (one shard each) are
ROADMAP.md queue 1 item 6b.

Optimizer (``--optimizer``): LGD replaces only the gradient ESTIMATOR,
so any update rule's moments accumulate the unbiased estimate.  Besides
the reference's four names it takes ``adam8bit`` and ``adafactor``.

Multi-probe (``--multiprobe K``): K extra Hamming-ball probe codes per
table before a table counts as empty.

LSH family (``--family {srp,mips,mips_banded}``): row-normalised cosine
SimHash; un-normalised features through the asymmetric Simple-LSH
augmentation; or its norm-ranged (banded) form.

Head (``--head {full,lsh}``): ``lsh`` trains through the LSH-sampled
head (``repro_torch.models.sampled_softmax``): a MIPS index over the
lm_head rows, probed with each token's hidden state, the normaliser
estimated from ``n_samples`` Algorithm-1 negatives, the index refreshed
every ``--head-refresh-every`` optimizer steps through
``TrainerConfig(step_hook=head.step_hook)``.  The eval line always uses
the exact full-vocabulary loss.  ``--head lsh`` composes with
``--sampler uniform``.

``--ckpt DIR`` checkpoints every 100 steps and resumes from the newest
valid checkpoint in DIR.  Runs on the card unless ``--device cpu``.

Run:  PYTHONPATH=src python -m repro_torch.train_lm [--preset demo]
          [--steps 200] [--sampler lgd] [--shards 2] [--ckpt DIR]
          [--optimizer adam]
          [--multiprobe 2] [--family mips] [--head lsh] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.data import (
    LSHPipelineConfig,
    ShardedLSHPipeline,
    lm_head_query_fn,
    make_token_corpus,
    mean_pool_feature_fn,
    uniform_batches,
)
from repro_torch.kernels import resolve_device
from repro_torch.models import (
    LM,
    LMHeadIndex,
    ModelConfig,
    SampledSoftmaxConfig,
    make_sampled_loss,
)
from repro_torch.optim import make_optimizer, schedules
from repro_torch.train import Trainer, TrainerConfig

PRESETS = {
    "demo": dict(n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
                 d_ff=512, vocab=1024, seq=64, corpus=4096, batch=16),
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                 d_ff=3072, vocab=32768, seq=512, corpus=100_000,
                 batch=32),
}

OPTIMIZERS = ["sgd", "momentum", "adagrad", "adam", "adam8bit", "adafactor"]


def preset_config(preset: str, lgd: bool = True) -> ModelConfig:
    """The model config of ``preset`` (f32)."""
    p = PRESETS[preset]
    return ModelConfig(
        name=f"lm-{preset}", n_layers=p["n_layers"], d_model=p["d_model"],
        n_heads=p["n_heads"], n_kv_heads=p["n_kv_heads"], d_ff=p["d_ff"],
        vocab=p["vocab"], chunk=64, loss_chunk=128, dtype="float32",
        rope_theta=10000.0, lgd_enabled=lgd)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="demo", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--sampler", default="lgd", choices=["uniform", "lgd"],
                    help="uniform batches vs LSH-sampled LGD batches")
    ap.add_argument("--uniform", action="store_true",
                    help="deprecated alias for --sampler uniform")
    ap.add_argument("--shards", type=int, default=1,
                    help="shard-by-example LSH index count (one per DP "
                         "group); must divide the preset's batch")
    ap.add_argument("--refresh-mode", default="full",
                    choices=["full", "delta"])
    ap.add_argument("--optimizer", default="adam", choices=OPTIMIZERS)
    ap.add_argument("--multiprobe", type=int, default=0,
                    help="extra Hamming-ball probe codes per table")
    ap.add_argument("--family", default="srp",
                    choices=["srp", "mips", "mips_banded"])
    ap.add_argument("--head", default="full", choices=["full", "lsh"],
                    help="full: exact softmax normaliser; lsh: the "
                         "LSH-sampled normaliser over the lm_head rows")
    ap.add_argument("--head-refresh-every", type=int, default=25,
                    help="optimizer steps between head-index refreshes")
    ap.add_argument("--head-samples", type=int, default=64,
                    help="LSH-sampled negatives per token (--head lsh)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.uniform:
        args.sampler = "uniform"
    if args.head == "lsh" and args.sampler == "lgd":
        ap.error("--head lsh composes with --sampler uniform (the LGD "
                 "data sampler owns the batch stream in lgd mode)")
    return args


def main(argv=None) -> Trainer:
    args = parse_args(argv)
    device = resolve_device(args.device)
    p = PRESETS[args.preset]
    cfg = preset_config(args.preset, lgd=args.sampler == "lgd")
    lm = LM.init(cfg, seed=0, device=device)
    n_params = sum(x.numel() for x in lm.parameters())
    print(f"model: {n_params / 1e6:.1f}M params | sampler: {args.sampler}"
          f" | head: {args.head} | optimizer: {args.optimizer}"
          + (f" | shards: {args.shards} | multiprobe: {args.multiprobe}"
             f" | family: {args.family}" if cfg.lgd_enabled else ""))

    corpus = make_token_corpus(1, p["corpus"], p["seq"], cfg.vocab,
                               hard_frac=0.1)
    sampler = batches = None
    if cfg.lgd_enabled:
        sampler = ShardedLSHPipeline(
            2, corpus.tokens, mean_pool_feature_fn(cfg), lm_head_query_fn(),
            LSHPipelineConfig(k=cfg.lgd_k, l=cfg.lgd_l,
                              minibatch=p["batch"],
                              refresh_every=cfg.lgd_refresh_every,
                              refresh_async=True,
                              refresh_mode=args.refresh_mode,
                              multiprobe=args.multiprobe,
                              family=args.family),
            n_shards=args.shards, params=lm, device=device)
    else:
        batches = uniform_batches(corpus, p["batch"], seed=3, device=device)

    loss_fn = step_hook = None
    if args.head == "lsh":
        # k in the populated-bucket regime at this preset's V (occupancy
        # ~ V / 2^k stays >> 1), as the reference picks it
        scfg = SampledSoftmaxConfig(
            k=min(7, max(3, cfg.vocab.bit_length() - 6)), l=8,
            n_samples=args.head_samples, multiprobe=2,
            refresh_every=args.head_refresh_every, refresh_mode="delta")
        head = LMHeadIndex(lm, scfg)
        batches = head.wrap_batches(batches)
        loss_fn = make_sampled_loss(cfg, scfg)
        step_hook = head.step_hook
        print(f"head index: {head.index.n_points} rows x "
              f"{head.index.n_tables} tables | m={scfg.n_samples} "
              f"negatives/token | refresh every {scfg.refresh_every} steps")

    peak = 3e-3 if args.optimizer in ("adam", "adam8bit", "adafactor") \
        else 3e-2
    tr = Trainer(
        cfg, lm,
        make_optimizer(args.optimizer,
                       schedules.warmup_cosine(peak, 20, args.steps)),
        batches,
        TrainerConfig(ckpt_dir=args.ckpt, ckpt_every=100, log_every=20,
                      step_hook=step_hook),
        sampler=sampler, loss_fn=loss_fn)
    if tr.step:
        print(f"resumed at step {tr.step} from {args.ckpt}")

    rows = torch.from_numpy(corpus.tokens[:128]).to(device)
    eval_batch = {"tokens": rows[:, :-1], "targets": rows[:, 1:]}
    for chunk in range(0, args.steps, 50):
        n = min(50, args.steps - chunk)
        d0, w0 = tr.data_seconds, time.perf_counter()
        tr.run(n)
        wall = time.perf_counter() - w0
        # steps/s and the share of wall time blocked on batch draws
        sampler_frac = (tr.data_seconds - d0) / max(wall, 1e-12)
        last = tr.metrics_history[-1] if tr.metrics_history else {}
        fb = (f"  fallback {sampler.sampler_stats()['fallback_rate']:5.1%}"
              if sampler is not None else "")
        with torch.no_grad():
            ev = float(lm.loss(eval_batch))
        print(f"step {tr.step:5d}  train {last.get('loss', float('nan')):.4f}"
              f"  eval {ev:.4f}"
              f"  steps/s {n / max(wall, 1e-12):6.2f}"
              f"  sampler {sampler_frac:5.1%}{fb}"
              f"  stragglers {tr.straggler_steps}")
    tr.finalize()
    return tr


if __name__ == "__main__":
    main()
