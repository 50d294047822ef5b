"""Training launcher: ``--arch <id>`` on a mesh, the twin of
``python -m repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch phi4_mini_3_8b \\
      --steps 50 [--full] [--lgd] [--ckpt DIR] [--batch 8] [--seq 64] \\
      [--production-mesh [--multi-pod]] [--device cuda]
  PYTHONPATH=src torchrun --nproc-per-node N -m repro_torch.launch.train ...

As the reference launcher, it runs under ``make_host_mesh()``, (n, 1)
over the job's n ranks, or ``make_production_mesh()`` with
``--production-mesh`` (16 x 16; 2 x 16 x 16 with ``--multi-pod``), which
needs a job of that many ranks; ``launch.dryrun`` rehearses those meshes
without the devices.  Under ``torchrun`` (one process a card) every
process joins the job's group on its own card (``launch.mesh.
init_job_group``); a lone process is one rank on card 0, a 1 x 1 mesh,
and its ``mesh=`` line says how many cards it leaves idle.  The model's
parameters are DTensors placed by ``dist.sharding.distribute_model``;
uniform batches are cut to each rank's data-parallel rows when the
batch divides over the data axes.  Only rank 0 prints; its last line,
``ranks {...}``, holds every rank's device, peak memory, kernel launches
and losses.

Without ``--full`` it trains the arch's SMOKE config; every arch of
``repro_torch.configs`` builds, and an ``embed_stub`` arch (musicgen,
which takes precomputed embeddings, not a token corpus) is refused with
the reference launcher's message.  Weights are
random from seed 0 and the corpus is ``make_token_corpus(0, ...)``, as
in the reference.  With ``--lgd`` batches come from a
``ShardedLSHPipeline`` with one shard per data-parallel group, which is
one on one card, with the refresh asynchronous (``refresh_async=True``),
as the reference launcher builds it: one shard a data-parallel group
when the batch divides over the mesh's data axes, else one index and
plain batches.  ``--ckpt DIR`` checkpoints every 50 steps into DIR and
resumes from its newest valid checkpoint, as the reference launcher
does.  Runs on the card unless ``--device cpu``.

``load_model``, ``make_batches`` and ``make_trainer`` keep their meshless
behaviour when called without a mesh.
"""

from __future__ import annotations

import argparse
import contextlib
import json
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import configs, kernels
from repro_torch.data import (
    LSHPipelineConfig,
    ShardedLSHPipeline,
    lm_head_query_fn,
    make_token_corpus,
    mean_pool_feature_fn,
    uniform_batches,
)
from repro_torch.dist.sharding import (
    compose_sharded_batch,
    data_axis_size,
    distribute_model,
    mesh_axes,
    use_mesh,
)
from repro_torch.kernels import in_job, resolve_device
from repro_torch.launch.mesh import (
    job_scope,
    make_host_mesh,
    make_production_mesh,
)
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


def load_model(arch: str, full: bool, device, mesh=None):
    """The arch's FULL or SMOKE config and its model, random from seed 0,
    placed on ``mesh`` when one is given."""
    cfg = configs.get(arch) if full else configs.get_smoke(arch)
    return cfg, distribute_model(LM.init(cfg, seed=0, device=device), mesh)


def lgd_shards(mesh, batch: int) -> int:
    """The reference launcher's shard count: one index a data-parallel
    group when ``batch`` divides over the data axes, else one."""
    dp = data_axis_size(mesh)
    n_shards = dp if batch % dp == 0 else 1
    if n_shards != dp and mesh.get_rank() == 0:
        print(f"WARNING: the DP degree {dp} does not divide batch={batch}; "
              f"falling back to ONE global LSH index on plain batches "
              f"(per-shard indexing disabled: every rank re-embeds the full "
              f"corpus on refresh)")
    return n_shards


def placed_batches(batches, device, mesh):
    """Each batch of ``batches`` (the global batch, drawn alike on every
    rank) under ``batch_sharding(mesh)``: this rank's data-parallel rows
    (``compose_sharded_batch`` of one part)."""
    for b in batches:
        yield {k: compose_sharded_batch([v], device, mesh=mesh)
               for k, v in b.items()}


def make_batches(cfg, model, *, lgd: bool, batch: int, seq: int, corpus: int,
                 device, refresh_every: int = 200,
                 n_shards: Optional[int] = None, mesh=None):
    """(sampler, batches): the LGD pipeline with ``n_shards`` per-shard
    indexes, or uniform batches.  ``n_shards`` defaults to 1 without a
    mesh and to ``lgd_shards(mesh, batch)`` with one; the composed
    batches are placed on ``mesh`` when the shard count is its
    data-parallel degree, uniform ones when the batch divides over it."""
    data = make_token_corpus(0, corpus, seq, cfg.vocab)
    if not lgd:
        batches = uniform_batches(data, batch, seed=1, device=device)
        if mesh is not None and batch % data_axis_size(mesh) == 0:
            batches = placed_batches(batches, device, mesh)
        return None, batches
    if n_shards is None:
        n_shards = 1 if mesh is None else lgd_shards(mesh, batch)
    place = mesh if mesh is not None and \
        n_shards == data_axis_size(mesh) else None
    sampler = ShardedLSHPipeline(
        2, data.tokens, mean_pool_feature_fn(cfg), lm_head_query_fn(),
        LSHPipelineConfig(minibatch=batch, refresh_every=refresh_every,
                          refresh_async=True),
        n_shards=n_shards, feature_batch=feature_batch_for(cfg, seq),
        params=model, device=device, mesh=place)
    return sampler, None


@contextlib.contextmanager
def mesh_scope(args, device):
    """The launcher's mesh for the block, over the job's group
    (``job_scope``): the production mesh, else the host mesh.  A mesh
    that cannot be built raises; a process group made here is destroyed
    on the way out."""
    with job_scope(device.type):
        yield (make_production_mesh(multi_pod=args.multi_pod,
                                    device_type=device.type)
               if args.production_mesh or args.multi_pod
               else make_host_mesh(device.type))


def mesh_line(cfg, device, mesh) -> str:
    """The ``mesh=`` line; a lone process on a host of n > 1 cards says
    that it uses one of them and how to use them all."""
    line = f"arch={cfg.name}  device={device}  mesh={mesh_axes(mesh)}"
    if device.type == "cuda" and not in_job() and \
            torch.cuda.device_count() > 1:
        n = torch.cuda.device_count()
        line += (f"  (1 of {n} cards; `torchrun --nproc-per-node {n} -m "
                 f"repro_torch.launch.train ...` for the ({n}, 1) host "
                 f"mesh)")
    return line


def rank_reports(device, losses) -> list:
    """Every rank's device, current card, peak memory, kernel launches
    and losses (a collective: every rank calls it; all get the list)."""
    mine = {"rank": dist.get_rank(), "device": str(device),
            "launches": dict(kernels.launches), "losses": losses}
    if device.type == "cuda":
        mine.update(current_device=torch.cuda.current_device(),
                    peak_gb=torch.cuda.max_memory_allocated(device) / 1e9)
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, mine)
    return out


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
    ap.add_argument("--production-mesh", action="store_true",
                    help="make_production_mesh() instead of the host mesh")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--lgd", action="store_true",
                    help="draw batches from the LSH-sampled pipeline")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    with mesh_scope(args, device) as mesh, use_mesh(mesh):
        lead = mesh.get_rank() == 0
        cfg, model = load_model(args.arch, args.full, device, mesh)
        n = sum(p.numel() for p in model.parameters())
        if lead:
            print(mesh_line(cfg, device, mesh))
            print(f"params: {n / 1e6:.1f}M, placed over {mesh.size()} ranks")
        if cfg.frontend == "embed_stub":
            raise SystemExit(
                f"{cfg.name} takes precomputed embeddings; use "
                "examples/serve.py or the dryrun for this arch")
        sampler, batches = make_batches(
            cfg, model, lgd=args.lgd, batch=args.batch, seq=args.seq,
            corpus=args.corpus, device=device, mesh=mesh)
        tr = make_trainer(cfg, model, steps=args.steps, lr=args.lr,
                          sampler=sampler, batches=batches,
                          tcfg=TrainerConfig(ckpt_dir=args.ckpt,
                                             ckpt_every=50, log_every=10))
        if tr.step and lead:
            print(f"resumed at step {tr.step} from {args.ckpt}")
        out = tr.run(args.steps)
        tr.finalize()
        out["ranks"] = rank_reports(device, out["losses"])
    if lead:
        for m in tr.metrics_history[-5:]:
            print(m)
        print(f"losses: first {out['losses'][0]:.4f}  last "
              f"{out['losses'][-1]:.4f}")
        print("ranks " + json.dumps(out["ranks"]), flush=True)
    return out


if __name__ == "__main__":
    main()
