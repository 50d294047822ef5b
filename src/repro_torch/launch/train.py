"""Training launcher: ``--arch <id>`` on one device, the twin of
``python -m repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch phi4_mini_3_8b \\
      --steps 50 [--full] [--lgd] [--ckpt DIR] [--batch 8] [--seq 64] \\
      [--device cuda]

Without ``--full`` it trains the arch's SMOKE config; every arch of
``repro_torch.configs`` builds, and an ``embed_stub`` arch (musicgen,
which takes precomputed embeddings, not a token corpus) is refused with
the reference launcher's message.  Weights are
random from seed 0 and the corpus is ``make_token_corpus(0, ...)``, as
in the reference.  With ``--lgd`` batches come from a
``ShardedLSHPipeline`` with one shard per data-parallel group, which is
one on one card, with the refresh asynchronous (``refresh_async=True``),
as the reference launcher builds it.  ``--ckpt DIR`` checkpoints every 50
steps into DIR and resumes from its newest valid checkpoint, as the
reference launcher does.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
from typing import Optional

from repro_torch import configs
from repro_torch.data import (
    LSHPipelineConfig,
    ShardedLSHPipeline,
    lm_head_query_fn,
    make_token_corpus,
    mean_pool_feature_fn,
    uniform_batches,
)
from repro_torch.kernels import resolve_device
from repro_torch.models import LM
from repro_torch.optim import Adam, schedules
from repro_torch.train import Trainer, TrainerConfig

# f32 attention scores one embed chunk may hold during a corpus re-embed
FEATURE_SCORE_BYTES = 2 << 30


def feature_batch_for(cfg, seq: int) -> int:
    """Rows per embed chunk: the largest power of two, at most the
    reference's 512, whose chunked-attention scores (rows × heads × seq
    × q-block f32) fit ``FEATURE_SCORE_BYTES``."""
    per_row = cfg.n_heads * seq * min(cfg.attn_block_q, seq) * 4
    rows = 1
    while rows < 512 and rows * 2 * per_row <= FEATURE_SCORE_BYTES:
        rows *= 2
    return rows


def load_model(arch: str, full: bool, device):
    """The arch's FULL or SMOKE config and its model, random from seed 0."""
    cfg = configs.get(arch) if full else configs.get_smoke(arch)
    return cfg, LM.init(cfg, seed=0, device=device)


def make_batches(cfg, model, *, lgd: bool, batch: int, seq: int, corpus: int,
                 device, refresh_every: int = 200, n_shards: int = 1):
    """(sampler, batches): the LGD pipeline with ``n_shards`` per-shard
    indexes (the data-parallel degree: 1 on one card), or uniform
    batches."""
    data = make_token_corpus(0, corpus, seq, cfg.vocab)
    if not lgd:
        return None, uniform_batches(data, batch, seed=1, device=device)
    sampler = ShardedLSHPipeline(
        2, data.tokens, mean_pool_feature_fn(cfg), lm_head_query_fn(),
        LSHPipelineConfig(minibatch=batch, refresh_every=refresh_every,
                          refresh_async=True),
        n_shards=n_shards, feature_batch=feature_batch_for(cfg, seq),
        params=model, device=device)
    return sampler, None


def make_trainer(cfg, model, *, steps: int, lr: float, sampler=None,
                 batches=None, log_every: int = 10, optimizer=None,
                 tcfg: Optional[TrainerConfig] = None,
                 resume: bool = True) -> Trainer:
    """The launcher's trainer: ``optimizer`` defaults to the reference's
    Adam under ``warmup_cosine(lr, 10, steps)``, ``tcfg`` to
    ``TrainerConfig(log_every=log_every)``."""
    if optimizer is None:
        optimizer = Adam(lr=schedules.warmup_cosine(lr, 10, steps))
    if tcfg is None:
        tcfg = TrainerConfig(log_every=log_every)
    return Trainer(cfg, model, optimizer, batches, tcfg, resume=resume,
                   sampler=sampler)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--corpus", type=int, default=2048)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full", action="store_true",
                    help="the FULL config (needs the card's memory)")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--lgd", action="store_true",
                    help="draw batches from the LSH-sampled pipeline")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.production_mesh or args.multi_pod:
        raise NotImplementedError(
            "meshes are not ported: parameter and batch placement over "
            "several devices is ROADMAP.md queue 1 item 6c; the port "
            "trains on one device, with one LSH shard")

    device = resolve_device(args.device)
    cfg, model = load_model(args.arch, args.full, device)
    n = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name}  device={device}")
    print(f"params: {n / 1e6:.1f}M")
    if cfg.frontend == "embed_stub":
        raise SystemExit(
            f"{cfg.name} takes precomputed embeddings; use "
            "examples/serve.py or the dryrun for this arch")
    sampler, batches = make_batches(
        cfg, model, lgd=args.lgd, batch=args.batch, seq=args.seq,
        corpus=args.corpus, device=device)
    tr = make_trainer(cfg, model, steps=args.steps, lr=args.lr,
                      sampler=sampler, batches=batches,
                      tcfg=TrainerConfig(ckpt_dir=args.ckpt, ckpt_every=50,
                                         log_every=10))
    if tr.step:
        print(f"resumed at step {tr.step} from {args.ckpt}")
    out = tr.run(args.steps)
    tr.finalize()
    for m in tr.metrics_history[-5:]:
        print(m)
    print(f"losses: first {out['losses'][0]:.4f}  last "
          f"{out['losses'][-1]:.4f}")
    return out


if __name__ == "__main__":
    main()
