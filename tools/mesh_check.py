#!/usr/bin/env python3
"""The port on a mesh of several processes against the meshless run.

    python3 tools/mesh_check.py [--nprocs 4] [--device cuda|cpu]
        [--checks train,compress,serve,lgd,batch,optimizers,archs,restore,
                  entries,giants,placement]
        [--out DIR]
    python3 tools/mesh_check.py --host-mesh [--device cpu] [--out DIR]
    python3 tools/mesh_check.py --launcher uniform|lgd|production
        [--nprocs 4] [--device cuda|cpu] [--out DIR]

Starts ``--nprocs`` processes (NCCL on ``cuda``, one card a process;
gloo on ``cpu``), joined through a ``FileStore`` in a temporary
directory (no network).  Each runs the checks below beside the meshless
run of the same inputs in the same process, on every (data, model)
factorisation of the rank count (for 4: (4, 1), (2, 2), (1, 4)) or, for
the checks marked (1, n), on the mesh that splits only ``model``:

* train: one ``Trainer`` step with Adam (lr 1e-3) of the SMOKE
  phi4-mini (f32), with the gradient clipped (``grad_clip`` 0.05, below
  the step's norm: the check fails if it is not).  Before the step, the
  gradient of every leaf within ``GRAD_RTOL`` (1e-5) of the meshless
  one, relative to that leaf's largest meshless entry; the step's
  ``grad_norm`` (the clip's norm, reduced over every shard) within
  ``GRAD_RTOL``; the loss within ``LOSS_RTOL`` (1e-6); the parameters
  after the step within lr / 4 at most and 1e-6 on average (Adam's first
  update is lr · g / (|g| + eps), which a gradient at eps moves by up to
  lr / 4 when its reduction order changes: the gradient check is the one
  that sees a wrong scale);
* compress: the train check with ``grad_compress`` (int8 compression
  with error feedback of each leaf's whole gradient), against the
  meshless compressed step, at the train check's tolerances (a gradient
  that differs by 1e-6 may flip one int8 level; Adam's lr / 4 allows for
  it); the error-feedback residual placed as its parameter, the same on
  every rank (bitwise, whole), each element within one int8 level of its
  block (the meshless block scale, plus twice the gradient tolerance)
  of the meshless residual, and at most ``RESIDUAL_OFF_SHARE`` of its
  elements off by more than twice the gradient tolerance (a level flip
  is rare; a residual left unchanged is off almost everywhere);
  ``wire_bytes`` of the model's gradients compressed on the mesh the
  meshless count;
* serve: the dry run's prefill step (B 4) and 4 serve steps of
  phi4-mini with ``attn_impl="pallas"`` (on ``cuda`` at full width and 2
  of its 32 layers; on ``cpu`` the SMOKE config with 8 heads over 4 KV
  heads), teacher-forced by the meshless run's greedy tokens, in f32:
  every step's logits within a relative L2 of ``SERVE_TOL`` (1e-5) of
  the meshless ones, and on ``cuda`` the flash kernels' launches on the
  mesh (one prefill a layer, one decode a layer a step: with the heads
  split over ``model``, each rank's kernels run on its own heads).  On
  ``cuda`` the same in bf16 is reported, not gated: the mesh's and the
  meshless run's relative L2 to the f32 meshless logits;
* lgd: ``launch.train.make_batches(lgd=True, mesh=)`` and 2 trainer
  steps of the SMOKE phi4-mini: finite losses and, on ``cuda``, the LGD
  kernels' launches;
* batch: ``ShardedLSHPipeline(mesh=)``'s composed batch equal to the
  meshless pipeline's bitwise, each rank holding its data-parallel rows;
* optimizers (1, n): the train check with Adafactor, with Adam8bit, and
  with one KV head (the q heads split over ``model``, the KV head not);
* archs (1, n): the train check of the SMOKE qwen3-moe, llama4 and
  zamba2, the loss within 1e-5;
* restore (1, n): a meshless checkpoint restored by ``restore_on_mesh``
  equal bitwise after ``full_tensor()``, and a checkpoint a meshed
  trainer wrote (rank 0 writes) restored meshless, bitwise;
* entries (1, n): every kernel entry called with DTensor arguments (the
  attention entries with heads split over ``model``) equal bitwise to
  the call on plain arguments, a DTensor out; ``on_cuda`` refuses a
  DTensor;
* giants (every layout, (1, n) first): the MoE giants' training path,
  built from the launcher's own pieces: ``LM.init(cfg, seed=0)`` then
  ``distribute_model``; the loss and the clip's norm of one fixed
  uniform batch; ``launch.train.make_batches(lgd=True, mesh=)`` (one
  shard a data-parallel group) and ``make_trainer`` with the dry run's
  ``pick_optimizer`` (Adafactor); GIANT_STEPS (6) steps with an async
  refresh at step GIANT_REFRESH (3), the last step's collectives
  counted (``collectives()``: kind, bytes, call site), and the first
  MoE layer's forward and backward alone under the same count.  On
  ``cuda`` llama4 (2 of 48 layers, 34.41 B parameters) and qwen3-moe (8
  of 94, 20.86 B) at full width in bf16, batch 8 x 512 tokens, a corpus
  of 512 rows (4i's recipe); before each layout is built a rank's peak
  is predicted (``rank_memory``) and a layout that cannot fit the card
  is not run, its arithmetic printed.  Checked: every rank's losses
  equal bitwise and finite; the LGD kernels' launches on each rank
  (simhash twice a shard: its build and its refresh; bucket_probe and
  draw_assemble once a shard a step; every rank builds every shard);
  the batch-mean weight 1 +- 1e-5; the refresh swapped in with no
  health transition; on ``cuda`` the fixed batch's loss and clip norm
  alike on every layout within ``LAUNCHER_RTOL_BF16`` with every layout
  routed as the first (``_pinned_routes``: a bf16 logit that rounds
  another way flips a token's top-k, which moves the norm by more than
  a placement's rounding; the loss and norm as each layout routes are
  reported beside them, ``fixed_loss_rel_max`` and
  ``fixed_grad_norm_rel_max``), each rank's peak
  reported beside its prediction; on ``cpu`` (the SMOKE configs, 8 x 32
  tokens, 64 rows) against the meshless run of the same shards: losses
  within 1e-5, the fixed batch's gradient of every leaf within
  ``GRAD_RTOL`` of its largest meshless entry and its clip norm to rtol
  ``GRAD_RTOL``, and the local storages of weights, gradients and slots
  equal to the prediction's bytes; with the plain LGD entries counted
  (``_plain_counts``).

* placement: the three placements the dry run found over a shard, each
  against its yardstick in the same process, each row with the step's
  peak a rank (``max_memory_allocated`` on cards), the dry run's count
  of the same step (``collectives()``' live storages, the model and the
  batch included: ``counted_peak_gb``) and its collectives.  granite
  (its vocab, 49,155, does not divide ``model``: the loss runs on each
  rank's rows) on every (data, model) layout: the loss within
  ``LOSS_RTOL`` and every leaf's gradient within ``GRAD_RTOL`` of the
  meshless run; on cards (``PLACEMENT``: f32, 2 of 40 layers, 40 rows of
  4,096 tokens) the meshless run sums the gradients of 4 blocks of 10
  rows so that it fits one card, and each layout runs in the blocks that
  give each rank 10 rows a block, so that every GEMM sums the tokens the
  yardstick's does; beside the step, the chunked loss alone on a block
  of a random final hidden state (``head_peak_gb``), where the replicated
  logits zeros lived.  nemotron (the vocab-parallel embedding) serving on
  every layout, ``_serve``'s steps in f32 at 2 of 32 layers: every
  step's logits within ``SERVE_TOL`` of meshless.  qwen3-moe (8 x 512
  tokens) on the pod layout (``pod`` 2, ``data`` n / 2, ``model`` 1: the
  batch over two mesh axes) against (n, 1), the same data-parallel
  degree, routed as (n, 1) routed (``_pinned_routes``, the recompute
  too): the collective bytes and, on cards, the peak within
  ``PLACEMENT_SAME`` (5%); the loss within 1e-5 in f32 (3 of 94 layers
  on cards) and within ``LAUNCHER_RTOL_BF16`` in bf16 (the giants' 8 of
  94 layers; the giants check read 2.06e-5 between layouts routed
  alike on four H100s).  On
  ``cpu`` the SMOKE configs (granite's vocab 131), qwen3-moe also against
  meshless (loss and every gradient) on 8 x 32 tokens, where each expert
  product gathers its weight, and on 4 x 4, where DTensor moves the rows
  instead (``moe._weight_for``; each row says which: ``weights_gathered``
  a layout), and the MoE auxiliary loss and the
  LSH-sampled head on each rank's rows against meshless on every layout.

``--host-mesh`` (one process) runs ``python -m repro_torch.launch.train``
(a 1 x 1 host mesh on a one-rank group) and the same steps meshless,
with and without ``--lgd``, under ``torch.use_deterministic_algorithms``
(the CPU's accumulating index backward is otherwise not bitwise from run
to run): the losses equal bitwise.

``--launcher MODE`` runs the entry point as a user types it, a job of
``--nprocs`` processes, one card a process (``python -m
torch.distributed.run --standalone --nproc-per-node N -m
repro_torch.launch.train --arch phi4_mini_3_8b --steps 3``: on ``cuda``
``--full`` at the launcher's batch 8 x 64 tokens and corpus 2,048; on
``cpu`` the SMOKE config, batch 4 x 16, corpus 64), and one process
alone (on ``cuda`` after the job, on card 0): for ``uniform`` the same
command, for ``lgd`` the same run built in this process from
``launch.train``'s ``load_model``, ``make_batches(n_shards=N)`` and
``make_trainer``, meshless, so that it draws the job's batches from the
job's N shards.  ``uniform`` and ``lgd``: the job's rank 0 reports the
(N, 1) mesh over N ranks; every rank's losses equal; on ``cuda`` rank r
on card r and each rank's peak memory; every loss against the lone
run's within ``LAUNCHER_RTOL`` (f32) on ``cpu`` and
``LAUNCHER_RTOL_BF16`` on ``cuda``; with ``lgd`` on ``cuda`` each rank
launching simhash N times (every rank builds every shard's index) and
bucket_probe and draw_assemble N a draw, 3 draws.  ``production``: the job with
``--production-mesh`` fails with the world-size error, not the "no
process group" one.  Writes ``DIR/launcher-MODE.json``.

Rank 0 prints one ``mesh-check`` JSON line a mesh, one for the (1, n)
checks, one a giants layout and one a giant arch, and on ``cuda`` the
card's name and power limit; with ``--out``
every rank writes its results to ``DIR/rank<R>.json`` (``DIR/host.json``
for ``--host-mesh``).  The exit code is non-zero when a check fails.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
CLIP = 0.05
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5
PARAM_MAX, PARAM_MEAN = LR / 4, 1e-6
SERVE_TOL = 1e-5          # relative L2 of the f32 logits
SERVE_B, SERVE_PROMPT, SERVE_NEW, SERVE_LAYERS = 4, 256, 4, 2
CHECKS = ("train", "compress", "serve", "lgd", "batch", "optimizers",
          "archs", "restore", "entries", "giants", "placement")
# --launcher: the job's losses against the lone process's.  f32 (cpu):
# the reduction order of the data-parallel sums only.  bf16 (cuda, FULL):
# the same batches, but each rank's GEMMs run on a quarter of the rows
# and the loss is reduced across the ranks, so a bf16 logit rounds
# differently (this tool's bf16 serve rows: logits 1.5-1.8e-2 from f32
# on and off a mesh); the first loss, a mean over 512 tokens of random-init
# cross-entropy ~12.2, moves far less: 2e-3 relative, on every loss
LAUNCHER_RTOL, LAUNCHER_RTOL_BF16 = 1e-5, 2e-3
LAUNCHER_STEPS, LAUNCHER_LR = 3, 1e-3
# the launcher's config and batches: FULL at its defaults on cards, the
# SMOKE config on small batches on the CPU
LAUNCHER_SIZE = {"cuda": dict(full=True, batch=8, seq=64, corpus=2048),
                 "cpu": dict(full=False, batch=4, seq=16, corpus=64)}
# compress: the share of residual elements that may differ from the
# meshless residual by more than twice the gradient tolerance (an int8
# level flipped by a gradient 1e-6 away from a rounding edge)
RESIDUAL_OFF_SHARE = 1e-2
LAUNCHER_MODES = ("uniform", "lgd", "production")
PHI4 = "phi4_mini_3_8b"
# giants: the MoE giants at full width (bf16) on cards, cut to these
# layers (llama4 34.41 B parameters, 68.8 GB; qwen3 20.86 B, 41.7 GB:
# neither trains on one 80 GB card), the SMOKE configs on the CPU; 4i's
# recipe (srp, K 7, L 10, batch 8 x 512 tokens from a corpus of 512 rows,
# an async refresh at step GIANT_REFRESH, GIANT_STEPS steps), the CPU's
# on short rows of a small corpus
GIANT_LAYERS = {"llama4_maverick_400b_a17b": 2, "qwen3_moe_235b_a22b": 8}
GIANT_SIZE = {"cuda": dict(batch=8, seq=512, corpus=512),
              "cpu": dict(batch=8, seq=32, corpus=64)}
GIANT_STEPS, GIANT_REFRESH = 6, 3
GIANT_LOSS_RTOL = 1e-5       # the CPU's losses against meshless (f32)
LGD_KERNELS = ("simhash", "bucket_probe", "draw_assemble")
COLLECTIVE_TIMEOUT = 300     # s, on cards
# placement: on cards granite (f32, 2 of 40 layers) at 40 rows of 4,096
# tokens (its replicated logits zeros were 8.05 GB a rank), in blocks of
# 10 rows a rank; nemotron (f32, 2 of 32 layers); qwen3-moe at 8 x 512
# tokens in bf16 at 8 of 94 layers (the loss to the giants' bf16 layout
# tolerance: the giants check read 2.06e-5 between layouts routed alike
# on four H100s) and in f32 at 3 (the loss to 1e-5); on the CPU their
# SMOKE configs, granite's vocab odd (131: whole over any model axis)
# and 8 rows of 32 tokens, qwen3-moe also at 4 rows of 4 (one a rank of
# four), where its expert products move the rows, not the weights; each
# qwen3-moe variant: (name, config, loss tolerance, rows, tokens a row)
PLACEMENT = {
    "cuda": {"granite_3_8b": dict(cfg=dict(n_layers=2, dtype="float32"),
                                  batch=40, seq=4096, micro=4),
             "nemotron_4_15b": dict(cfg=dict(n_layers=2, dtype="float32")),
             "qwen3_moe_235b_a22b": dict(cfg=dict(), variants=(
                 ("bf16", dict(n_layers=8), LAUNCHER_RTOL_BF16, 8, 512),
                 ("f32", dict(n_layers=3, dtype="float32"), 1e-5, 8,
                  512)))},
    "cpu": {"granite_3_8b": dict(cfg=dict(vocab=131), batch=8, seq=32,
                                 micro=1),
            "nemotron_4_15b": dict(cfg=dict()),
            "qwen3_moe_235b_a22b": dict(cfg=dict(), variants=(
                ("f32", dict(), 1e-5, 8, 32),
                ("f32 short", dict(), 1e-5, 4, 4)))},
}
PLACEMENT_SAME = 0.05        # the pod layout's collective bytes and peak


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _placements(t):
    return [str(x) for x in t.placements] if hasattr(t, "placements") \
        else None


def _digest(tensors: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _meshes(n: int, device):
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    return [DeviceMesh(device.type, torch.arange(n).reshape(d, n // d),
                       mesh_dim_names=("data", "model"))
            for d in range(n, 0, -1) if n % d == 0]


def _lm_batch(device, vocab=128):
    import torch
    from repro_torch.data import make_token_corpus
    rows = torch.from_numpy(
        make_token_corpus(0, 8, 32, vocab).tokens).long().to(device)
    return {"tokens": rows[:, :-1], "targets": rows[:, 1:]}


# ---------------------------------------------------------------------------
# train: gradients, the clip's norm, one step
# ---------------------------------------------------------------------------

def _train(mesh, device, *, arch=PHI4, optimizer="adam", compress=False,
           **overrides):
    """The gradient of every leaf (whole), then one clipped step (with
    ``compress``, of the int8-compressed gradient): loss, grad_norm, the
    parameters after it (whole), their placements and the error-feedback
    residual."""
    from repro_torch import configs
    from repro_torch.dist.sharding import distribute_model, use_mesh
    from repro_torch.models import LM
    from repro_torch.optim import compression, make_optimizer
    from repro_torch.train import Trainer, TrainerConfig

    cfg = configs.get_smoke(arch).with_(**overrides)
    batch = _lm_batch(device, cfg.vocab)
    with use_mesh(mesh):
        model = distribute_model(LM.init(cfg, seed=0, device=device), mesh)
        model.loss(batch).backward()
        grads = {k: _whole(p.grad).detach().clone()
                 for k, p in model.named_parameters()}
        # what the compressed gradient puts on the wire (whole leaves)
        wire = compression.wire_bytes(compression.compress(
            {k: p.grad for k, p in model.named_parameters()}))
        model.zero_grad(set_to_none=True)
        tr = Trainer(cfg, model, make_optimizer(optimizer, lr=LR),
                     iter([batch]),
                     TrainerConfig(log_every=1, grad_clip=CLIP,
                                   grad_compress=compress),
                     resume=False)
        t0 = time.perf_counter()
        loss = tr.run(1)["losses"][0]
        dt = time.perf_counter() - t0
        params = {k: _whole(p).detach().clone()
                  for k, p in model.named_parameters()}
        placements = {k: _placements(p)
                      for k, p in model.named_parameters()}
    return {"loss": loss, "grad_norm": tr.metrics_history[-1]["grad_norm"],
            "grads": grads, "params": params, "placements": placements,
            "residual": {k: _whole(r).detach().clone()
                         for k, r in (tr._ef_residual or {}).items()},
            "residual_placed": all(
                _placements(r) == placements[k]
                for k, r in (tr._ef_residual or {}).items()),
            "wire_bytes": wire, "s": dt}


def _compare_train(got, ref, loss_rtol=LOSS_RTOL) -> dict:
    import torch
    grad_err, worst = 0.0, None
    for k, g0 in ref["grads"].items():
        scale = float(g0.abs().max())
        err = float((got["grads"][k] - g0).abs().max()) / max(scale, 1e-30)
        if err >= grad_err:
            grad_err, worst = err, k
    diffs = torch.cat([(got["params"][k] - v).abs().reshape(-1)
                       for k, v in ref["params"].items()])
    row = dict(
        loss=got["loss"], loss_meshless=ref["loss"],
        loss_rel=abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
        grad_norm=got["grad_norm"], grad_norm_meshless=ref["grad_norm"],
        grad_norm_rel=abs(got["grad_norm"] - ref["grad_norm"])
        / ref["grad_norm"],
        grad_rel_max=grad_err, grad_worst_leaf=worst,
        param_err_max=float(diffs.max()), param_err_mean=float(diffs.mean()),
        clipped=ref["grad_norm"] > CLIP, params_digest=_digest(got["params"]),
        placements={k: v for k, v in got["placements"].items() if v},
        s=got["s"], s_meshless=ref["s"])
    row["ok"] = bool(row["clipped"] and row["loss_rel"] <= loss_rtol
                     and row["grad_norm_rel"] <= GRAD_RTOL
                     and grad_err <= GRAD_RTOL
                     and row["param_err_max"] <= PARAM_MAX
                     and row["param_err_mean"] <= PARAM_MEAN)
    return row


def _residual_errors(res, ref) -> dict:
    """The mesh's residual against the meshless one, leaf by leaf: the
    largest difference, that difference over its allowance (one int8
    level of its block, the meshless block scale, plus twice the
    gradient tolerance of the leaf), and the share of elements off by
    more than twice the gradient tolerance.  The residual starts at 0,
    so a block's scale is the meshless gradient's."""
    import torch
    from repro_torch.optim.compression import BLOCK
    from repro_torch.optim.optimizers import _quantize_blockwise
    err_max = levels = 0.0
    off = total = 0
    for k, r0 in ref["residual"].items():
        g = ref["grads"][k].float()
        level = _quantize_blockwise(g, BLOCK).scale.repeat_interleave(
            BLOCK)[:g.numel()]
        tol = 2 * GRAD_RTOL * float(g.abs().max())
        d = (res[k] - r0).abs().reshape(-1)
        err_max = max(err_max, float(d.max()))
        levels = max(levels, float((d / (level + tol)).max()))
        off += int((d > tol).sum())
        total += d.numel()
    return dict(residual_err_max=err_max, residual_err_levels=levels,
                residual_off_share=off / total)


def _compare_compress(got, ref) -> dict:
    """The train check's row for the compressed step, plus the residual:
    placed as its parameter, whole the same on every rank, within one
    int8 level of the meshless residual and off it only where a level
    flipped (``_residual_errors``)."""
    import torch.distributed as dist
    row = _compare_train(got, ref)
    res = got["residual"]
    digest = _digest(res)
    digests = [None] * dist.get_world_size()
    dist.all_gather_object(digests, digest)
    row.update(
        residual_placed=got["residual_placed"],
        residual_same_on_ranks=len(set(digests)) == 1,
        residual_digest=digest, **_residual_errors(res, ref),
        wire_bytes=got["wire_bytes"], wire_bytes_meshless=ref["wire_bytes"])
    row["ok"] = bool(row["ok"] and row["residual_placed"]
                     and row["residual_same_on_ranks"]
                     and row["residual_err_levels"] <= 1.0
                     and row["residual_off_share"] <= RESIDUAL_OFF_SHARE
                     and row["wire_bytes"] == row["wire_bytes_meshless"])
    return row


# ---------------------------------------------------------------------------
# serve, LGD, the composed batch
# ---------------------------------------------------------------------------

def _serve_cfg(device, dtype="float32"):
    from repro_torch import configs
    if device.type == "cuda":
        return configs.get(PHI4).with_(
            n_layers=SERVE_LAYERS, attn_impl="pallas", dtype=dtype)
    return configs.get_smoke(PHI4).with_(
        n_heads=8, n_kv_heads=4, attn_impl="pallas", dtype=dtype)


def _serve(mesh, device, prompts, forced=None, dtype="float32", cfg=None):
    """The dry run's prefill step and SERVE_NEW serve steps of ``cfg``
    (``_serve_cfg``'s phi4-mini by default), teacher-forced by
    ``forced`` when given: each step's logits (on the host), the greedy
    tokens, the flash launches, the seconds, the q projection's and the
    embedding's placements, the steps' peak a rank (the placed model
    included; ``max_memory_allocated`` on cards), the dry run's count of
    it and their collectives."""
    import gc
    import torch
    from repro_torch import kernels
    from repro_torch.dist.sharding import distribute_model, use_mesh
    from repro_torch.launch import dryrun
    from repro_torch.models import LM

    cfg = cfg or _serve_cfg(device, dtype)
    kernels.reset_launch_counts()
    with use_mesh(mesh), torch.no_grad():
        model = distribute_model(LM.init(cfg, seed=0, device=device), mesh)
        b, s = prompts.shape
        counter = collectives()
        counter.track((dict(model.named_parameters()), prompts))

        def steps():
            cache = model.init_cache(b, s + SERVE_NEW)
            h, cache = dryrun.make_prefill_step(cfg)(
                model, {"tokens": prompts}, cache)
            nxt = _whole(model.embed_group.lm_logits(h[:, -1:])).argmax(-1)
            logits, toks = [], [nxt]
            step = dryrun.make_serve_step(cfg)
            for i in range(SERVE_NEW):
                inp = nxt if forced is None else forced[i]
                lg, cache = step(model, {
                    "tokens": inp.to(torch.int32),
                    "positions": torch.full((b, 1), s + i, dtype=torch.int32,
                                            device=device)}, cache)
                lg = _whole(lg).float()
                nxt = lg.argmax(-1)
                logits.append(lg.cpu())
                toks.append(nxt)
            return logits, toks

        t0 = time.perf_counter()
        with counter:
            (logits, toks), peak = _step_peak(device, steps)
        dt = time.perf_counter() - t0
        out = dict(logits=logits, toks=toks, s=dt, cfg=cfg, peak_gb=peak,
                   counted_peak_gb=counter.peak_bytes / 1e9,
                   heads=_placements(model.blocks[0].attn.wq),
                   embed=_placements(model.embed_group.embed),
                   launches={k: kernels.launches[k] for k in (
                       "flash_attention", "flash_decode")})
    del model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    summary = counter.summary()
    out.update(collectives=summary,
               collective_gb=sum(summary["bytes"].values()) / 1e9)
    return out


def _rel_l2(got, want):
    return max(float((a - b).norm() / b.norm()) for a, b in zip(got, want))


def _lgd(mesh, device):
    from repro_torch import kernels
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.launch import train as launch

    kernels.reset_launch_counts()
    with use_mesh(mesh):
        cfg, model = launch.load_model(PHI4, False, device, mesh)
        sampler, _ = launch.make_batches(cfg, model, lgd=True, batch=8,
                                         seq=32, corpus=64, device=device,
                                         mesh=mesh)
        tr = launch.make_trainer(cfg, model, steps=2, lr=LR,
                                 sampler=sampler)
        losses = tr.run(2)["losses"]
        tr.finalize()
    used = {k: kernels.launches[k] for k in ("simhash", "bucket_probe",
                                              "draw_assemble")}
    ok = all(map(math.isfinite, losses)) and \
        (device.type != "cuda" or min(used.values()) >= 1)
    return dict(losses=losses, launches=used, ok=bool(ok))


def _pipeline_batch(mesh, device, n_shards):
    """One composed batch of ``ShardedLSHPipeline(mesh=)`` over the same
    meshless model."""
    from repro_torch import configs
    from repro_torch.data import (LSHPipelineConfig, ShardedLSHPipeline,
                                  lm_head_query_fn, make_token_corpus,
                                  mean_pool_feature_fn)
    from repro_torch.models import LM

    cfg = configs.get_smoke(PHI4)
    corpus = make_token_corpus(0, 64, 32, cfg.vocab)
    model = LM.init(cfg, seed=0, device=device)
    return ShardedLSHPipeline(
        2, corpus.tokens, mean_pool_feature_fn(cfg), lm_head_query_fn(),
        LSHPipelineConfig(minibatch=8, k=3, l=8, refresh_every=1000),
        n_shards=n_shards, feature_batch=16, params=model, device=device,
        mesh=mesh).next_batch()


def _compare_batch(got, ref, data: int) -> dict:
    import torch
    row = dict(
        equal={k: bool(torch.equal(_whole(got[k]), v))
               for k, v in ref.items()},
        local_rows={k: v.to_local().shape[0] for k, v in got.items()},
        want_rows={k: v.shape[0] // data for k, v in ref.items()},
        placements={k: _placements(v) for k, v in got.items()})
    row["ok"] = bool(set(got) == set(ref) and all(row["equal"].values())
                     and row["local_rows"] == row["want_rows"])
    return row


# ---------------------------------------------------------------------------
# checkpoints and the kernel entries, on (1, n)
# ---------------------------------------------------------------------------

def _restore(mesh, device, root) -> dict:
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.dist.sharding import distribute_model, use_mesh
    from repro_torch.models import LM
    from repro_torch.optim import Adam
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.elastic import restore_on_mesh

    cfg = configs.get_smoke(PHI4)
    batch = _lm_batch(device, cfg.vocab)
    # a meshless checkpoint restored onto the mesh
    ck = os.path.join(root, "ckpt")
    tr = Trainer(cfg, LM.init(cfg, seed=0, device=device), Adam(lr=LR),
                 iter([batch] * 2), TrainerConfig(log_every=1000),
                 resume=False)
    tr.run(2)
    if dist.get_rank() == 0:
        ckpt.save(ck, 2, tr._state_tree())
    dist.barrier()
    template = tr._state_tree()
    plain, _ = ckpt.restore(ck, 2, template)
    placed, extra = restore_on_mesh(ck, 2, template, mesh, cfg=cfg)
    flat_p = dict(ckpt.flatten(plain))
    flat_m = dict(ckpt.flatten(placed))
    onto = {k: bool(torch.equal(v, _whole(flat_m[k])))
            for k, v in flat_p.items()}
    # the reverse: a checkpoint the meshed trainer wrote, restored meshless
    ck2 = os.path.join(root, "ckpt_mesh")
    with use_mesh(mesh):
        model = distribute_model(LM.init(cfg, seed=0, device=device), mesh)
        tr_m = Trainer(cfg, model, Adam(lr=LR), iter([batch] * 2),
                       TrainerConfig(ckpt_dir=ck2, ckpt_every=2,
                                     log_every=1000), resume=False)
        tr_m.run(2)
        tr_m.finalize()
        whole = {k: _whole(p) for k, p in model.named_parameters()}
    dist.barrier()
    meshless = Trainer(cfg, LM.init(cfg, seed=1, device=device),
                       Adam(lr=LR), iter([]), TrainerConfig(log_every=1000),
                       resume=False)
    back, _ = ckpt.restore(ck2, 2, meshless._state_tree())
    reverse = {k: bool(torch.equal(back["params"][k], v))
               for k, v in whole.items()}
    placements = {k: _placements(v) for k, v in flat_m.items()
                  if hasattr(v, "placements")}
    return dict(onto_mesh=onto, reverse=reverse, placements=placements,
                step=extra.get("step"),
                ok=bool(onto and all(onto.values()) and reverse
                        and all(reverse.values())))


def _entries(mesh, device) -> dict:
    """Each kernel entry with DTensor arguments on ``mesh`` against the
    same call on plain tensors: equal bitwise, a DTensor out; ``on_cuda``
    refuses a DTensor."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels import on_cuda
    from repro_torch.kernels.bucket_probe import (bucket_probe,
                                                  bucket_probe_codes,
                                                  bucket_probe_multi)
    from repro_torch.kernels.flash_attention import (gqa_attention,
                                                     gqa_decode)
    from repro_torch.kernels.gather_weight import gather_weight
    from repro_torch.kernels.simhash import simhash_codes

    g = torch.Generator().manual_seed(5)

    def put(t, *pl):
        return distribute_tensor(t, mesh, list(pl), src_data_rank=None)

    def rand(*shape):
        return torch.randn(*shape, generator=g).to(device)

    rep = (Replicate(), Replicate())
    x, w = rand(64, 12), rand(12, 4 * 3)
    codes = simhash_codes(x, w, k=3, l=4)
    sc = codes.T.sort(dim=1).values.contiguous()
    q = rand(5, 12)
    qa, ka, va = rand(2, 8, 4, 16), rand(2, 8, 2, 16), rand(2, 8, 2, 16)
    lens = torch.tensor([3, 8], dtype=torch.int32, device=device)
    store = torch.randint(0, 9, (64, 7), generator=g,
                          dtype=torch.int32).to(device)
    idx = torch.randint(0, 64, (6,), generator=g).to(device)
    probs = torch.rand(6, generator=g).to(device)
    heads = (Replicate(), Shard(2))
    cases = {
        "simhash": (simhash_codes(put(x, Shard(0), Replicate()),
                                  put(w, *rep), k=3, l=4), codes),
        "bucket_probe": (bucket_probe(put(q, *rep), put(w, *rep),
                                      put(sc, *rep), k=3, l=4),
                         bucket_probe(q, w, sc, k=3, l=4)),
        "bucket_probe_multi": (
            bucket_probe_multi(put(q, *rep), w, sc, (0, 1), k=3, l=4),
            bucket_probe_multi(q, w, sc, (0, 1), k=3, l=4)),
        "bucket_probe_codes": (bucket_probe_codes(put(codes[:5], *rep), sc),
                               bucket_probe_codes(codes[:5], sc)),
        "gather_weight": (gather_weight(put(store, *rep), idx, probs),
                          gather_weight(store, idx, probs)),
        "flash_attention": (gqa_attention(put(qa, *heads), put(ka, *heads),
                                          put(va, *heads)),
                            gqa_attention(qa, ka, va)),
        "flash_decode": (gqa_decode(put(qa[:, :1], *heads),
                                    put(ka, *heads), put(va, *heads),
                                    put(lens, *rep)),
                         gqa_decode(qa[:, :1], ka, va, lens)),
    }
    res = {}
    for name, (got, want) in cases.items():
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        res[name] = all(hasattr(a, "full_tensor")
                        and torch.equal(a.full_tensor(), b)
                        for a, b in zip(got, want))
    try:
        on_cuda(put(x, *rep))
        res["on_cuda_refuses"] = False
    except TypeError:
        res["on_cuda_refuses"] = True
    res["ok"] = all(res.values())
    return res


# ---------------------------------------------------------------------------
# giants: the MoE giants trained on LGD batches over every layout
# ---------------------------------------------------------------------------

def rank_memory(cfg, mesh, rows: int, seq: int) -> dict:
    """A rank's least memory for training ``cfg`` with Adafactor on
    ``mesh`` (None: one process), from the parameter shapes on the meta
    device and ``param_placements``: the init (the whole model drawn on
    the card, plus the larger of its f32 draw of one slice, ``normal_``,
    and one leaf's local shard cut before its whole leaf is freed) and
    the step (each leaf's local shard of weights, gradients and
    Adafactor's row and column slots, plus the clip's f32 copy of the
    largest local leaf, plus one MoE layer's expert weights gathered
    over the data axes where a step of ``rows`` rows of ``seq`` tokens
    gathers them: ``moe.gathers_weight``, each kept for its product's
    backward).  The whole leaves are freed before the first step, so the
    peak is the larger of the two; activations and the optimiser's
    temporaries come on top."""
    from repro_torch.dist.sharding import data_axis_size, param_placements
    from repro_torch.models import LM
    from repro_torch.models.layers import NORMAL_SLICE
    from repro_torch.models.moe import capacity, gathers_weight

    def local(name, shape, elem, slot=None):
        n = math.prod(shape)
        if mesh is None or n == 0:
            return n * elem
        sizes = tuple(mesh.mesh.shape)
        for i, p in enumerate(param_placements(name, shape, mesh, cfg,
                                               slot=slot)):
            if p.is_shard():
                n //= sizes[i]
        return n * elem

    named = dict(LM(cfg, device="meta").named_parameters())
    whole = sum(p.numel() * p.element_size() for p in named.values())
    w = slots = big = shard = draw = 0
    for k, p in named.items():
        shape = tuple(p.shape)
        lb = local(k, shape, p.element_size())
        w += lb
        shard = max(shard, lb)
        big = max(big, lb // p.element_size())
        if p.numel() <= NORMAL_SLICE or p.dim() == 0:
            draw = max(draw, 4 * p.numel())
        else:                   # a slice of whole rows of dim 0 at a time
            row = p.numel() // shape[0]
            draw = max(draw, 4 * row * min(shape[0],
                                           max(1, NORMAL_SLICE // row)))
        if p.dim() >= 2:
            slots += local(k, shape[:-1], 4, "vr") + \
                local(k, shape[:-2] + shape[-1:], 4, "vc")
        else:
            slots += local(k, shape, 4, "vr")
    gathered = 0
    if cfg.is_moe and mesh is not None:
        p = data_axis_size(mesh)
        sizes = tuple(mesh.mesh.shape)
        for k in [k for k in named if k.startswith("blocks.0.ffn.experts_")]:
            e, n, m = shape = tuple(named[k].shape)
            e //= math.prod(sizes[i] for i, q in enumerate(
                param_placements(k, shape, mesh, cfg)) if q.is_shard(0))
            if gathers_weight(e, rows // p * capacity(cfg, seq), n, m,
                              local(k, shape, 1), p):
                gathered += e * n * m * named[k].element_size()
    init = whole + max(draw, shard)
    step = 2 * w + slots + 4 * big + gathered
    return dict(whole_gb=whole / 1e9, init_gb=init / 1e9,
                weights_gb=w / 1e9, grads_gb=w / 1e9, slots_gb=slots / 1e9,
                clip_copy_gb=4 * big / 1e9, gathered_gb=gathered / 1e9,
                step_gb=step / 1e9,
                peak_gb=max(init, step) / 1e9,
                weights_bytes=w, grads_bytes=w, slots_bytes=slots)


def _storage_bytes(tensors) -> int:
    """The bytes of the local storages behind ``tensors`` (a DTensor's
    local shard), each storage once."""
    seen, n = set(), 0
    for t in tensors:
        if t is None:
            continue
        st = (t.to_local() if hasattr(t, "to_local") else t) \
            .untyped_storage()
        if st.nbytes() and st.data_ptr() not in seen:
            seen.add(st.data_ptr())
            n += st.nbytes()
    return n


def _plain_counts():
    """On the CPU, a count of each LGD kernel's plain version called
    through its public entry (a kernel's wrapper counts only on a card):
    the dict the counts go to, and a function that undoes the wrapping."""
    from repro_torch.core import sampler
    from repro_torch.kernels.bucket_probe import ops as probe_ops
    from repro_torch.kernels.simhash import ops as simhash_ops

    counts = dict.fromkeys(LGD_KERNELS, 0)
    sites = [(simhash_ops, "simhash_codes_ref", "simhash"),
             (probe_ops, "bucket_probe_ref", "bucket_probe"),
             (sampler, "draw_assemble_plain", "draw_assemble")]
    saved = []
    for mod, attr, name in sites:
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))

        def counted(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)
        setattr(mod, attr, counted)

    def undo():
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return counts, undo


def _giant_cfg(arch, device):
    from repro_torch import configs
    if device.type == "cuda":
        return configs.get(arch).with_(n_layers=GIANT_LAYERS[arch])
    return configs.get_smoke(arch)


def _giant_run(arch, mesh, device, n_shards, fixed, pin=None) -> dict:
    """One layout of the giants check: ``arch``'s model drawn whole
    (``LM.init``) and placed on ``mesh`` (``distribute_model``; None:
    meshless), the loss and the clip's norm of the ``fixed`` batch, then
    GIANT_STEPS trainer steps on the launcher's LGD batches
    (``make_batches`` with ``n_shards`` shards, ``make_trainer`` with the
    dry run's ``pick_optimizer``), one refresh at GIANT_REFRESH; the last
    step under ``collectives()``.  The fixed batch runs twice: as it
    routes on this layout, and with the routing ``pin`` (``_routes``'
    arrays of another layout; None: this layout's own)."""
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.dist.sharding import distribute_model, use_mesh
    from repro_torch.launch import train as launch
    from repro_torch.launch.dryrun import pick_optimizer
    from repro_torch.models import LM
    from repro_torch.train import TrainerConfig

    cuda = device.type == "cuda"
    size = GIANT_SIZE[device.type]
    cfg = _giant_cfg(arch, device)
    if cuda:
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    plain, undo = _plain_counts() if not cuda else (None, None)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    row = {}
    try:
        with use_mesh(mesh):
            t0 = time.perf_counter()
            model = distribute_model(LM.init(cfg, seed=0, device=device),
                                     mesh)
            sync()
            row["init_s"] = time.perf_counter() - t0
            named = dict(model.named_parameters())
            row["expert_placements"] = {
                k: _placements(p) for k, p in named.items()
                if ".ffn.experts_" in k}
            # the fixed batch: the first loss and the clip's norm, each
            # kind of leaf's share of its square, the experts each
            # token is routed to
            with _routes(mesh) as routes:
                loss = model.loss(fixed)
            loss.backward()
            grads = {k: p.grad for k, p in named.items()}
            row["fixed_loss"] = float(_whole(loss.detach()))
            sq = {k: _whole(g.float().square().sum())
                  for k, g in grads.items()}
            row["fixed_grad_norm"] = float(torch.sqrt(sum(sq.values())))
            row["fixed_grad_sq_by_leaf"] = {}
            for k, v in sq.items():
                leaf = k.rsplit(".", 1)[1]
                row["fixed_grad_sq_by_leaf"][leaf] = \
                    row["fixed_grad_sq_by_leaf"].get(leaf, 0.0) + float(v)
            row["routes"] = routes
            del grads, loss
            model.zero_grad(set_to_none=True)
            # again with the first layout's routing (this layout's on the
            # first), so that layouts compare with one routing
            with _pinned_routes(mesh, routes if pin is None else pin, model):
                loss = model.loss(fixed)
                loss.backward()
            grads = {k: p.grad for k, p in named.items()}
            row["fixed_loss_pinned"] = float(_whole(loss.detach()))
            row["fixed_grad_norm_pinned"] = float(torch.sqrt(sum(
                _whole(g.float().square().sum()) for g in grads.values())))
            row["grad_bytes"] = _storage_bytes(grads.values())
            if not cuda:
                row["grads"] = {k: _whole(g).detach().clone()
                                for k, g in grads.items()}
            del grads, loss
            model.zero_grad(set_to_none=True)
            row["weight_bytes"] = _storage_bytes(named.values())
            if mesh is not None:
                row["expert_products"] = _moe_collectives(model, mesh, size)
            t0 = time.perf_counter()
            sampler, _ = launch.make_batches(
                cfg, model, lgd=True, batch=size["batch"], seq=size["seq"],
                corpus=size["corpus"], device=device,
                refresh_every=GIANT_REFRESH, n_shards=n_shards, mesh=mesh)
            sync()
            row["build_s"] = time.perf_counter() - t0
            w_means, next_batch = [], sampler.next_batch

            def kept_batch(*a, **kw):
                b = next_batch(*a, **kw)
                w_means.append(_whole(b["loss_weights"]).float().mean())
                return b

            def one_refresh(tr):
                if tr.step == GIANT_REFRESH + 1:    # after the swap
                    for c in [sampler.cfg] + [s.cfg for s in sampler.shards]:
                        c.refresh_every = 0

            sampler.next_batch = kept_batch
            tr = launch.make_trainer(
                cfg, model, steps=GIANT_STEPS, lr=1e-3, sampler=sampler,
                optimizer=pick_optimizer(arch),
                tcfg=TrainerConfig(log_every=10 ** 9, step_hook=one_refresh))
            starts, train_step = [], tr.train_step
            counter = collectives()

            def timed_step(batch):
                starts.append(time.perf_counter())
                if len(starts) < GIANT_STEPS:
                    return train_step(batch)
                with counter:                     # the last step
                    return train_step(batch)

            tr.train_step = timed_step
            losses = tr.run(GIANT_STEPS)["losses"]
            sync()
            starts.append(time.perf_counter())
            tr.finalize()
            row["launches"] = dict(plain) if plain is not None else {
                k: kernels.launches[k] for k in LGD_KERNELS}
            row["slot_bytes"] = _storage_bytes(
                t for slots in tr.opt_state[1:] if slots is not None
                for t in slots.values())
            if cuda:
                peaks = [None] * dist.get_world_size()
                dist.all_gather_object(
                    peaks, torch.cuda.max_memory_allocated(device) / 1e9)
                row["peak_gb_ranks"] = peaks
            dts = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]
            # iteration k trains step k and draws batch k + 1: the refresh
            # launches in iteration GIANT_REFRESH - 2 and is swapped in
            # the next (``step_ms_refresh``, on a mesh of > 1 rank the
            # launch's forward is synchronous); the last step ran under
            # the counter
            steady = [d for i, d in enumerate(dts[:-1])
                      if i not in (GIANT_REFRESH - 2, GIANT_REFRESH - 1)]
            recs = sampler.refresh_records()
            hs = sampler.health_summary()
            done = [r for r in recs if r["ok"] is not None]
            ranks = [None] * dist.get_world_size()
            dist.all_gather_object(ranks, losses)
            row.update(
                losses=losses, ranks_equal=all(x == losses for x in ranks),
                step_ms=dts, step_ms_p10=_pct(steady, 10),
                step_ms_p50=_pct(steady, 50),
                step_ms_refresh=dts[GIANT_REFRESH - 2:GIANT_REFRESH],
                weight_mean_max_dev=float(
                    (torch.stack(w_means) - 1).abs().max()),
                fallback_rate=sampler.sampler_stats()["fallback_rate"],
                refreshes=len(done),
                refresh_ok=bool(len(done) == n_shards
                                and all(r["ok"] for r in done)
                                and not hs["transitions"]
                                and not hs["refresh_failures"]),
                step_collectives=counter.summary(),
                n_shards=n_shards)
            del tr, train_step, timed_step, kept_batch, one_refresh
            del sampler, next_batch, model, named
    finally:
        if undo is not None:
            undo()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return row


def collectives():
    """The dry run's counter (``dryrun.RankCounter``) without its
    DTensor-level FLOP and byte counts: the collectives this rank issues,
    the redistributions DTensor makes inside an op's sharding
    propagation among them, by kind (count and output bytes) and by call
    site ("backward" for autograd's), in ``summary()``."""
    from repro_torch.launch.dryrun import RankCounter

    return RankCounter(ops=False)


@contextlib.contextmanager
def _routes(mesh):
    """The experts the MoE layers route each token to within the block
    (``dispatch_slots``' top-k, a layer at a time), whole: a list of
    (B, T, k) arrays, this rank's rows gathered over the data axis."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.models import moe

    mine, dispatch = [], moe.dispatch_slots

    def recorded(logits, k, cap):
        with torch.no_grad():    # nothing saved: remat recomputes the layer
            mine.append(torch.topk(logits, k, dim=-1).indices.cpu().numpy())
        return dispatch(logits, k, cap)

    out = []
    moe.dispatch_slots = recorded
    try:
        yield out
    finally:
        moe.dispatch_slots = dispatch
    if mesh is None:
        out.extend(mine)
        return
    from repro_torch.dist.sharding import _data_index
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, (_data_index(mesh), mine))
    rows = dict(parts)                  # one part a data index
    out.extend(np.concatenate([rows[i][layer] for i in sorted(rows)])
               for layer in range(len(mine)))


@contextlib.contextmanager
def _pinned_routes(mesh, routes, model):
    """Within the block the MoE layers of ``model`` route each token as
    ``routes`` says (``_routes``' arrays, whole, one a layer in module
    order; this rank takes its data-parallel rows): every logit outside
    a token's pinned experts is -inf, so the top-k picks them with their
    own logits, and the gate, the ranks within an expert and the
    gradient are those of that routing.  Each MoE module takes its own
    layer's routing, so a backward's recompute (remat) is routed as its
    forward was."""
    import torch
    from repro_torch.dist.sharding import _data_index, data_axis_size
    from repro_torch.models import moe

    dispatch, forward, current = moe.dispatch_slots, moe.MoE.forward, [None]
    order = {id(m): i for i, m in enumerate(
        m for m in model.modules() if isinstance(m, moe.MoE))}

    def keyed(self, x):
        current[0] = order[id(self)]
        return forward(self, x)

    def pinned(logits, k, cap):
        rows = routes[current[0]]
        if mesh is not None:
            per = rows.shape[0] // data_axis_size(mesh)
            i = _data_index(mesh)
            rows = rows[i * per:(i + 1) * per]
        idx = torch.from_numpy(rows).to(logits.device)
        masked = torch.full_like(logits, -math.inf).scatter(
            -1, idx, logits.gather(-1, idx))
        return dispatch(masked, k, cap)

    moe.dispatch_slots, moe.MoE.forward = pinned, keyed
    try:
        yield
    finally:
        moe.dispatch_slots, moe.MoE.forward = dispatch, forward


def _moe_collectives(model, mesh, size) -> dict:
    """The collectives of the first layer's MoE FFN alone, its forward
    and backward on a batch-placed input of the training shape."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.dist.sharding import batch_sharding

    moe, cfg = model._layer(0).ffn, model.cfg
    g = torch.Generator(device=model.device).manual_seed(3)
    x = torch.randn((size["batch"], size["seq"], cfg.d_model), generator=g,
                    device=model.device).to(model.dtype)
    x = distribute_tensor(x, mesh, batch_sharding(mesh), src_data_rank=None)
    with collectives() as counter:
        y = moe(x)
        torch.autograd.backward(y, torch.ones_like(y))
    model.zero_grad(set_to_none=True)
    return counter.summary()


def _pct(xs, q):
    import numpy as np
    return float(np.percentile(xs, q)) if xs else None


def _giants(device, meshes, rank) -> dict:
    """``--checks giants``: each of GIANT_LAYERS' archs on every layout
    of ``meshes``, the layout that splits only ``model`` first (module
    docstring)."""
    import numpy as np
    import torch
    from repro_torch.data import make_token_corpus
    from repro_torch.dist.sharding import data_axis_size, mesh_axes

    cuda = device.type == "cuda"
    size = GIANT_SIZE[device.type]
    card_gb = torch.cuda.get_device_properties(device).total_memory / 1e9 \
        if cuda else None
    out, fixed, routes = {}, {}, {}
    for arch in GIANT_LAYERS:
        cfg = _giant_cfg(arch, device)
        rows = torch.from_numpy(make_token_corpus(
            7, size["batch"], size["seq"], cfg.vocab).tokens).long()
        fixed[arch] = {"tokens": rows[:, :-1].to(device),
                       "targets": rows[:, 1:].to(device)}
        out[arch] = {"layers": cfg.n_layers, "layouts": {}}
    for mesh in reversed(meshes):
        shape = mesh_axes(mesh)
        name = "x".join(map(str, shape.values()))
        dp = data_axis_size(mesh)
        for arch in GIANT_LAYERS:
            cfg = _giant_cfg(arch, device)
            pred = rank_memory(cfg, mesh, size["batch"], size["seq"])
            row = {"mesh": shape, "predicted": pred, "card_gb": card_gb}
            out[arch]["layouts"][name] = row
            if cuda and pred["peak_gb"] >= card_gb:
                row.update(run=False, ok=True)
                if rank == 0:
                    print(f"mesh-check giants {cfg.name} {name}: not run: a "
                          f"rank holds at least {pred['peak_gb']:.2f} GB "
                          f"({json.dumps(pred)}), beyond the card's "
                          f"{card_gb:.2f} GB", flush=True)
                continue
            got = _giant_run(arch, mesh, device, dp, fixed[arch],
                             pin=routes.get(arch))
            want = {"simhash": 2 * dp, "bucket_probe": GIANT_STEPS * dp,
                    "draw_assemble": GIANT_STEPS * dp}
            row.update(run=True, launches_want=want,
                       **{k: v for k, v in got.items()
                          if k not in ("grads", "routes")})
            routes.setdefault(arch, got["routes"])
            first = routes[arch]
            # the share of (layer, token) routed to another top-k set of
            # experts than on the first layout run
            row["routes_differ_share"] = float(np.mean([
                (np.sort(a, -1) != np.sort(b, -1)).any(-1).mean()
                for a, b in zip(got["routes"], first)]))
            ok = (got["ranks_equal"] and len(got["losses"]) == GIANT_STEPS
                  and all(map(math.isfinite, got["losses"]))
                  and got["launches"] == want
                  and got["weight_mean_max_dev"] <= 1e-5
                  and got["refresh_ok"])
            if cuda:
                row["peak_over_predicted"] = [
                    p / pred["peak_gb"] for p in got["peak_gb_ranks"]]
            else:
                # the meshless run of the same shards, batches and step
                ref = _giant_run(arch, None, device, dp, fixed[arch])
                grad_err = max(
                    float((got["grads"][k] - g).abs().max())
                    / max(float(g.abs().max()), 1e-30)
                    for k, g in ref["grads"].items())
                loss_rel = max(abs(a - b) / abs(b) for a, b in
                               zip(got["losses"], ref["losses"]))
                row.update(
                    losses_meshless=ref["losses"], loss_rel_max=loss_rel,
                    grad_rel_max=grad_err,
                    fixed_loss_meshless=ref["fixed_loss"],
                    grad_norm_rel=abs(got["fixed_grad_norm"]
                                      - ref["fixed_grad_norm"])
                    / ref["fixed_grad_norm"],
                    bytes_equal={k: got[f"{k}_bytes"] == pred[f"{k}s_bytes"]
                                 for k in ("weight", "grad", "slot")})
                ok &= (loss_rel <= GIANT_LOSS_RTOL and grad_err <= GRAD_RTOL
                       and row["grad_norm_rel"] <= GRAD_RTOL
                       and all(row["bytes_equal"].values()))
            row["ok"] = bool(ok)
            if rank == 0:
                print("mesh-check giants " + json.dumps(
                    {"arch": cfg.name, "layout": name, **row}), flush=True)
    for arch, res in out.items():
        ran = [r for r in res["layouts"].values() if r["run"]]
        if cuda and len(ran) > 1:
            # the same fixed batch on every layout: bf16 GEMMs split
            # another way, the loss reduced across ranks; as routed on
            # each layout, and with the first layout's routing
            for k in ("fixed_loss", "fixed_grad_norm", "fixed_loss_pinned",
                      "fixed_grad_norm_pinned"):
                base = ran[0][k]
                res[f"{k}_rel_max"] = max(abs(r[k] - base) / abs(base)
                                          for r in ran)
            # the layouts routed as the first gate; as each routes is
            # reported
            res["layouts_agree"] = bool(max(
                res["fixed_loss_pinned_rel_max"],
                res["fixed_grad_norm_pinned_rel_max"]) <= LAUNCHER_RTOL_BF16)
        res["ok"] = bool(ran and all(r["ok"] for r in res["layouts"].values())
                         and res.get("layouts_agree", True))
        if rank == 0:
            print("mesh-check giants " + json.dumps(
                {"arch": arch, **{k: v for k, v in res.items()
                                  if k != "layouts"}}), flush=True)
    return out


# ---------------------------------------------------------------------------
# placement: the three placements the dry run found over a shard
# ---------------------------------------------------------------------------

def _pod_mesh(n: int, device):
    """The (pod 2, data n / 2, model 1) mesh: the batch over two mesh
    axes, as on the multi-pod production mesh (with its batch view)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.dist.sharding import with_batch_view
    return with_batch_view(DeviceMesh(
        device.type, torch.arange(n).reshape(2, n // 2, 1),
        mesh_dim_names=("pod", "data", "model")))


def _placement_cfg(arch, device):
    from repro_torch import configs
    size = PLACEMENT[device.type][arch]
    if device.type == "cuda":
        return configs.get(arch).with_(**size["cfg"])
    return configs.get_smoke(arch).with_(**size["cfg"])


def _token_batch(cfg, rows, seq, device):
    import torch
    from repro_torch.data import make_token_corpus
    t = torch.from_numpy(make_token_corpus(   # rows of seq + 1 tokens
        11, rows, seq, cfg.vocab).tokens).long()
    return {"tokens": t[:, :-1].to(device), "targets": t[:, 1:].to(device)}


def _step_peak(device, fn):
    """``fn()`` and the most bytes allocated a rank while it ran, what
    was live before it included (``max_memory_allocated``, GB, on cards;
    None on the CPU)."""
    import torch
    if device.type != "cuda":
        return fn(), None
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn()
    torch.cuda.synchronize(device)
    return out, torch.cuda.max_memory_allocated(device) / 1e9


def _grad_step(cfg, mesh, device, batch, micro: int = 1, pin=None,
               record=None, grads: bool = True,
               loss_head: bool = False) -> dict:
    """The loss of ``batch`` and every leaf's gradient (whole, on the
    host) of ``cfg`` drawn with seed 0 and placed on ``mesh`` (None:
    meshless), in ``micro`` blocks of rows whose gradients are summed (a
    large batch's meshless yardstick fits one card so; a layout whose
    ranks each take a block's rows sums the same groups of tokens in one
    GEMM as the yardstick), with the step's peak a rank
    (``max_memory_allocated``, on cards) and the dry run's count of it
    (``collectives()``' live storages, the model and batch included),
    and its collectives (``grads=False``: no gradient read back).
    ``loss_head``: the chunked loss alone on one block's rows of a
    random final hidden state, its peak and count (``head_*``).
    ``record`` (a list) receives the MoE routing (``_routes``), ``pin``
    routes the layers as given (``_pinned_routes``)."""
    import gc
    import torch
    from repro_torch.dist.sharding import (batch_sharding, distribute_model,
                                           shard_of, use_mesh)
    from repro_torch.models import LM
    from repro_torch.models.layers import chunked_cross_entropy

    out = {}
    with use_mesh(mesh):
        model = distribute_model(LM.init(cfg, seed=0, device=device), mesh)
        named = dict(model.named_parameters())
        rows = batch["tokens"].shape[0] // micro
        blocks = [{k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                  for i in range(micro)]
        if mesh is not None:
            blocks = [{k: shard_of(v, mesh, batch_sharding(mesh))
                       for k, v in blk.items()} for blk in blocks]
        counter = collectives()
        counter.track((named, blocks))

        def step():
            total = 0.0
            for part in blocks:
                if record is not None:          # the forward's routing
                    with _routes(mesh) as got:
                        loss = model.loss(part) / micro
                    record.extend(got)
                    loss.backward()
                else:                           # the recompute's too
                    with (_pinned_routes(mesh, pin, model) if pin is not None
                          else contextlib.nullcontext()):
                        loss = model.loss(part) / micro
                        loss.backward()
                total += float(_whole(loss.detach()))
            return total

        with counter:
            out["loss"], out["peak_gb"] = _step_peak(device, step)
        out["counted_peak_gb"] = counter.peak_bytes / 1e9
        out["grads"] = {k: _whole(p.grad).detach().float().cpu()
                        for k, p in named.items()} if grads else None
        out["placements"] = {k: _placements(p) for k, p in named.items()}
        summary = counter.summary()
        out.update(collectives=summary,
                   collective_gb=sum(summary["bytes"].values()) / 1e9)
        model.zero_grad(set_to_none=True)
        if loss_head:
            g = torch.Generator(device=device).manual_seed(5)
            h = torch.randn((rows,) + tuple(batch["tokens"].shape[1:])
                            + (cfg.d_model,), generator=g, device=device,
                            dtype=getattr(torch, cfg.dtype))
            tgt = batch["targets"][:rows]
            if mesh is not None:
                h = shard_of(h, mesh, batch_sharding(mesh))
                tgt = shard_of(tgt, mesh, batch_sharding(mesh))
            h.requires_grad_(True)
            head = collectives()
            head.track((named, h, tgt))
            with head:
                _, out["head_peak_gb"] = _step_peak(device, lambda: (
                    chunked_cross_entropy(model.embed_group, cfg, h,
                                          tgt).backward()))
            out["head_counted_peak_gb"] = head.peak_bytes / 1e9
            del h, tgt
        del model, named, blocks
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _grad_errors(got, ref) -> dict:
    err, worst = 0.0, None
    for k, g0 in ref["grads"].items():
        e = float((got["grads"][k] - g0).abs().max()) / max(
            float(g0.abs().max()), 1e-30)
        if e >= err:
            err, worst = e, k
    return dict(loss=got["loss"], loss_meshless=ref["loss"],
                loss_rel=abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
                grad_rel_max=err, grad_worst_leaf=worst)


def _placement(device, meshes, rank) -> dict:
    """``--checks placement`` (module docstring): granite's loss with its
    vocab whole over ``model``, nemotron's embedding and qwen3-moe's
    expert products under a batch over two mesh axes, each against its
    yardstick."""
    import torch
    from repro_torch.dist.sharding import data_axis_size, mesh_axes

    cuda = device.type == "cuda"
    n = meshes[0].size()
    out = {}

    def show(name, row):
        if rank == 0:
            print("mesh-check placement " + json.dumps(
                {"case": name, **row}), flush=True)

    def layout(mesh):
        return "x".join(map(str, mesh_axes(mesh).values()))

    # granite: the loss chunk's logits whole over the vocab.  On cards the
    # meshless yardstick runs in blocks of rows (it fits one card so), and
    # each layout runs in the blocks that give each rank the same rows a
    # block: every GEMM sums the same tokens as the yardstick's, so the
    # gradients differ by a placement, not by another grouping of a
    # 163,840-token f32 sum (2.3e-5 of lm_head's largest entry on (1, 4)
    # in one block against four)
    size = PLACEMENT[device.type]["granite_3_8b"]
    cfg = _placement_cfg("granite_3_8b", device)
    batch = _token_batch(cfg, size["batch"], size["seq"], device)
    ref = _grad_step(cfg, None, device, batch, micro=size["micro"])
    rows = {}
    for mesh in meshes:
        micro = max(1, size["micro"] // data_axis_size(mesh))
        got = _grad_step(cfg, mesh, device, batch, micro=micro,
                         loss_head=True)
        row = dict(_grad_errors(got, ref), micro=micro,
                   embed=got["placements"]["embed_group.embed"],
                   **{k: got[k] for k in (
                       "peak_gb", "counted_peak_gb", "head_peak_gb",
                       "head_counted_peak_gb", "collective_gb")})
        row["ok"] = bool(row["loss_rel"] <= LOSS_RTOL
                         and row["grad_rel_max"] <= GRAD_RTOL)
        rows[layout(mesh)] = row
        show("granite " + layout(mesh), row)
    out["granite"] = dict(config=cfg.name, vocab=cfg.vocab,
                          layers=cfg.n_layers, batch=size["batch"],
                          seq=size["seq"], micro=size["micro"],
                          peak_gb_meshless=ref["peak_gb"], layouts=rows,
                          ok=all(r["ok"] for r in rows.values()))
    del ref

    # nemotron: the embedding's table, serving
    cfg = _placement_cfg("nemotron_4_15b", device)
    gen = torch.Generator().manual_seed(4)
    prompts = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_PROMPT),
                            generator=gen, dtype=torch.int32).to(device)
    ref = _serve(None, device, prompts, cfg=cfg)
    rows = {}
    for mesh in meshes:
        got = _serve(mesh, device, prompts, forced=ref["toks"], cfg=cfg)
        rel = _rel_l2(got["logits"], ref["logits"])
        row = dict(rel_l2=rel, tol=SERVE_TOL, peak_gb=got["peak_gb"],
                   counted_peak_gb=got["counted_peak_gb"],
                   collective_gb=got["collective_gb"], embed=got["embed"],
                   ok=bool(rel <= SERVE_TOL))
        rows[layout(mesh)] = row
        show("nemotron " + layout(mesh), row)
    out["nemotron"] = dict(config=cfg.name, vocab=cfg.vocab,
                           layers=cfg.n_layers, peak_gb_meshless=ref[
                               "peak_gb"], layouts=rows,
                           ok=all(r["ok"] for r in rows.values()))
    del ref

    # qwen3-moe: the batch over (pod, data) against over data alone, the
    # same data-parallel degree, routed alike; on cards at the giants'
    # bf16 (8 of 94 layers) and in f32 (3 of 94), the loss held to each
    # dtype's tolerance
    size = PLACEMENT[device.type]["qwen3_moe_235b_a22b"]
    flat, pod = meshes[0], _pod_mesh(n, device)
    rows = {}
    for name, over, loss_rtol, n_rows, seq in size["variants"]:
        cfg = _placement_cfg("qwen3_moe_235b_a22b", device).with_(**over)
        batch = _token_batch(cfg, n_rows, seq, device)
        routes = []
        a = _grad_step(cfg, flat, device, batch, record=routes,
                       grads=not cuda)
        b = _grad_step(cfg, pod, device, batch, pin=routes, grads=not cuda)
        row = dict(
            config=cfg.name, dtype=cfg.dtype, layers=cfg.n_layers,
            layouts=[layout(flat), layout(pod)],
            loss=[a["loss"], b["loss"]], loss_rtol=loss_rtol,
            loss_rel=abs(b["loss"] - a["loss"]) / abs(a["loss"]),
            collective_gb=[a["collective_gb"], b["collective_gb"]],
            peak_gb=[a["peak_gb"], b["peak_gb"]],
            counted_peak_gb=[a["counted_peak_gb"], b["counted_peak_gb"]],
            collectives=[a["collectives"], b["collectives"]],
            expert_placements=b["placements"]["blocks.0.ffn.experts_gate"],
            rows=n_rows, seq=seq, weights_gathered=[any(
                "_weight_for" in site for site in x["collectives"]["by_site"])
                for x in (a, b)])
        row["collective_ratio"] = b["collective_gb"] / a["collective_gb"]
        ok = row["loss_rel"] <= loss_rtol
        ok &= abs(row["collective_ratio"] - 1) <= PLACEMENT_SAME
        if cuda:
            row["peak_ratio"] = b["peak_gb"] / a["peak_gb"]
            ok &= abs(row["peak_ratio"] - 1) <= PLACEMENT_SAME
        else:
            row["grad_rel_max"] = _grad_errors(b, a)["grad_rel_max"]
            ok &= row["grad_rel_max"] <= GRAD_RTOL
            ref = _grad_step(cfg, None, device, batch)
            row["loss_rel_meshless"] = abs(b["loss"] - ref["loss"]) / abs(
                ref["loss"])
            row["grad_rel_max_meshless"] = _grad_errors(b, ref)[
                "grad_rel_max"]
            ok &= row["loss_rel_meshless"] <= loss_rtol and \
                row["grad_rel_max_meshless"] <= GRAD_RTOL
        row["ok"] = bool(ok)
        rows[name] = row
        show("qwen3-moe pod " + name, {k: v for k, v in row.items()
                                       if k != "collectives"})
    out["qwen3_moe"] = dict(variants=rows,
                            ok=all(r["ok"] for r in rows.values()))
    if not cuda:
        out["local_rows"] = _local_rows_losses(device, meshes)
        show("local rows", out["local_rows"])
    out["ok"] = all(v["ok"] for v in out.values())
    return out


def _local_rows_losses(device, meshes) -> dict:
    """The other training ops that now run on each rank's rows (the MoE
    auxiliary loss, the LSH-sampled head's column lookups), on every
    layout against meshless: the loss to ``LOSS_RTOL`` and each
    gradient to ``GRAD_RTOL`` of its largest meshless entry."""
    import torch
    from repro_torch import configs
    from repro_torch.dist.sharding import (batch_sharding, distribute_model,
                                           mesh_axes, shard_of, use_mesh)
    from repro_torch.models import LM
    from repro_torch.models.moe import aux_load_balance_loss
    from repro_torch.models.sampled_softmax import (LMHeadIndex,
                                                    SampledSoftmaxConfig,
                                                    sampled_softmax_loss)

    moe_cfg = configs.get_smoke("qwen3_moe_235b_a22b")
    x = torch.randn((8, 32, moe_cfg.d_model),
                    generator=torch.Generator().manual_seed(5)).to(device)
    head_cfg = configs.get_smoke(PHI4)
    scfg = SampledSoftmaxConfig(k=3, l=6, n_samples=16, multiprobe=1)
    batch = _token_batch(head_cfg, 8, 32, device)
    head = LMHeadIndex(LM.init(head_cfg, seed=0, device=device), scfg)

    def run(mesh):
        got = {}
        with use_mesh(mesh):
            model = distribute_model(LM.init(moe_cfg, seed=0, device=device),
                                     mesh)
            moe = model._layer(0).ffn
            xin = x if mesh is None else shard_of(x, mesh,
                                                  batch_sharding(mesh))
            loss = aux_load_balance_loss(moe, xin)
            loss.backward()
            got["aux"] = (float(_whole(loss.detach())),
                          {k: _whole(p.grad).detach().clone()
                           for k, p in moe.named_parameters()
                           if p.grad is not None})
            model = distribute_model(LM.init(head_cfg, seed=0, device=device),
                                     mesh)
            b = dict(batch) if mesh is None else {
                k: shard_of(v, mesh, batch_sharding(mesh))
                for k, v in batch.items()}
            loss = sampled_softmax_loss(model, head_cfg, scfg,
                                        head.inject(b, step=1))
            loss.backward()
            got["head"] = (float(_whole(loss.detach())),
                           {k: _whole(p.grad).detach().clone()
                            for k, p in model.named_parameters()
                            if p.grad is not None})
        return got

    ref = run(None)
    rows = {}
    for mesh in meshes:
        got = run(mesh)
        row = {}
        for name, (loss, grads) in got.items():
            loss0, grads0 = ref[name]
            err = max(float((grads[k] - g).abs().max())
                      / max(float(g.abs().max()), 1e-30)
                      for k, g in grads0.items())
            row[name] = dict(loss_rel=abs(loss - loss0) / abs(loss0),
                             grad_rel_max=err,
                             same_leaves=set(grads) == set(grads0))
        row["ok"] = all(r["loss_rel"] <= LOSS_RTOL
                        and r["grad_rel_max"] <= GRAD_RTOL
                        and r["same_leaves"] for r in row.values())
        rows["x".join(map(str, mesh_axes(mesh).values()))] = row
    return dict(layouts=rows, ok=all(r["ok"] for r in rows.values()))


# ---------------------------------------------------------------------------
# the processes
# ---------------------------------------------------------------------------

def _warm_collectives(device, n: int) -> None:
    """One small collective of each kind DTensor issues (all-gather,
    reduce-scatter, all-reduce, all-to-all), while the card is empty:
    NCCL allocates its buffers outside PyTorch's cache on a kind's first
    use, which a card filled by a model can refuse ("unhandled cuda
    error")."""
    import torch
    import torch.distributed as dist
    x = torch.ones(n * 1024, device=device)
    out = torch.empty_like(x)
    dist.all_gather_into_tensor(torch.empty(n * x.numel(), device=device), x)
    dist.reduce_scatter_tensor(torch.empty(1024, device=device), x)
    dist.all_reduce(x)
    dist.all_to_all_single(out, x)
    torch.cuda.synchronize(device)


def child(args) -> int:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch import kernels
    from repro_torch.dist.sharding import mesh_axes

    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.set_device(args.rank)
        kernels.require_full_fp32()
        device = torch.device("cuda", args.rank)
    else:
        torch.set_num_threads(1)
        device = torch.device("cpu")
    # on cards a collective that waits past COLLECTIVE_TIMEOUT aborts the
    # process (no step of these checks waits that long for a peer), and
    # the parent then ends the others
    dist.init_process_group(
        "nccl" if cuda else "gloo",
        store=dist.FileStore(os.path.join(args.dir, "store"), args.nprocs),
        rank=args.rank, world_size=args.nprocs,
        **({"timeout": datetime.timedelta(seconds=COLLECTIVE_TIMEOUT)}
           if cuda else {}))
    if cuda:
        _warm_collectives(device, args.nprocs)
    checks = set(args.checks.split(","))
    res = {"meshes": {}}
    ref = _train(None, device) if "train" in checks else None
    ref_c = _train(None, device, compress=True) \
        if "compress" in checks else None
    if "serve" in checks:
        gen = torch.Generator().manual_seed(4)
        prompts = torch.randint(0, _serve_cfg(device).vocab,
                                (SERVE_B, SERVE_PROMPT), generator=gen,
                                dtype=torch.int32).to(device)
        serve0 = _serve(None, device, prompts)
        lg0, tok0, cfg_s = serve0["logits"], serve0["toks"], serve0["cfg"]
        bf0 = _serve(None, device, prompts, forced=tok0,
                     dtype="bfloat16")["logits"] if cuda else None
    if "batch" in checks:
        batch0 = _pipeline_batch(None, device, args.nprocs)
    meshes = _meshes(args.nprocs, device)
    for mesh in meshes:
        shape = mesh_axes(mesh)
        row = {"mesh": shape}
        if "train" in checks:
            row["train"] = _compare_train(_train(mesh, device), ref)
        if "compress" in checks:
            row["compress"] = _compare_compress(
                _train(mesh, device, compress=True), ref_c)
        if "serve" in checks:
            got = _serve(mesh, device, prompts, forced=tok0)
            rel, used = _rel_l2(got["logits"], lg0), got["launches"]
            want = {"flash_attention": cfg_s.n_layers,
                    "flash_decode": cfg_s.n_layers * SERVE_NEW} if cuda \
                else used
            row["serve"] = dict(
                rel_l2=rel, tol=SERVE_TOL,
                same_tokens=all(torch.equal(a, b)
                                for a, b in zip(got["toks"], tok0)),
                launches=used, wq_placements=got["heads"], s=got["s"],
                s_meshless=serve0["s"],
                ok=bool(rel <= SERVE_TOL and used == want))
            if cuda:
                bf = _serve(mesh, device, prompts, forced=tok0,
                            dtype="bfloat16")["logits"]
                row["serve_bf16"] = dict(
                    rel_l2_to_f32=_rel_l2(bf, lg0),
                    meshless_rel_l2_to_f32=_rel_l2(bf0, lg0))
        if "lgd" in checks:
            row["lgd"] = _lgd(mesh, device)
        if "batch" in checks:
            row["batch"] = _compare_batch(
                _pipeline_batch(mesh, device, args.nprocs), batch0,
                shape["data"])
        res["meshes"]["x".join(map(str, shape.values()))] = row
        if args.rank == 0:
            print("mesh-check " + json.dumps(row), flush=True)
        dist.barrier()
    model_mesh = meshes[-1]             # (1, n): only model splits
    one_n = {}
    if "optimizers" in checks or "archs" in checks:
        cases = {}
        if "optimizers" in checks:
            cases.update(adafactor=dict(optimizer="adafactor"),
                         adam8bit=dict(optimizer="adam8bit"),
                         one_kv_head=dict(n_kv_heads=1))
        if "archs" in checks:
            cases.update({a: dict(arch=a) for a in (
                "qwen3_moe_235b_a22b", "llama4_maverick_400b_a17b",
                "zamba2_1_2b")})
        for name, kw in cases.items():
            rtol = 1e-5 if "arch" in kw else LOSS_RTOL
            one_n[name] = _compare_train(_train(model_mesh, device, **kw),
                                         _train(None, device, **kw), rtol)
    if "restore" in checks:
        one_n["restore"] = _restore(model_mesh, device, args.dir)
    if "entries" in checks:
        one_n["entries"] = _entries(model_mesh, device)
    if one_n:
        res["1xn"] = one_n
        if args.rank == 0:
            print("mesh-check " + json.dumps(
                {"mesh": mesh_axes(model_mesh), **one_n}), flush=True)
    if "giants" in checks:
        res["giants"] = _giants(device, meshes, args.rank)
    if "placement" in checks:
        res["placement"] = _placement(device, meshes, args.rank)
    ok = all(c["ok"] for row in res["meshes"].values()
             for c in row.values() if isinstance(c, dict) and "ok" in c)
    ok &= all(c["ok"] for c in one_n.values())
    ok &= all(c["ok"] for c in res.get("giants", {}).values())
    ok &= res.get("placement", {}).get("ok", True)
    res["ok"] = ok
    if args.out:
        with open(os.path.join(args.out, f"rank{args.rank}.json"), "w") as f:
            json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0 if ok else 1


def host_mesh(args) -> int:
    """The launcher's 1 x 1 host mesh against its meshless steps."""
    import torch

    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.launch import train as launch

    torch.use_deterministic_algorithms(True)
    if args.device == "cpu":
        torch.set_num_threads(1)
    flags = ["--arch", PHI4, "--steps", "3", "--corpus", "256",
             "--device", args.device]
    res = {}
    for lgd in (False, True):
        cfg, model = launch.load_model(PHI4, False, args.device)
        sampler, batches = launch.make_batches(
            cfg, model, lgd=lgd, batch=8, seq=64, corpus=256,
            device=args.device)
        tr = launch.make_trainer(cfg, model, steps=3, lr=LR,
                                 sampler=sampler, batches=batches)
        meshless = tr.run(3)["losses"]
        tr.finalize()
        meshed = launch.main(flags + (["--lgd"] if lgd else []))["losses"]
        res["lgd" if lgd else "uniform"] = dict(
            meshless=meshless, mesh=meshed,
            ok=bool(meshed == meshless and len(meshed) == 3))
    print("mesh-check " + json.dumps(res), flush=True)
    if args.out:
        with open(os.path.join(args.out, "host.json"), "w") as f:
            json.dump(res, f)
    return 0 if all(r["ok"] for r in res.values()) else 1


def _launcher_run(cmd, env) -> dict:
    """One launcher process tree: its exit code, output, the rank
    reports of its ``ranks`` line, its ``mesh=`` and ``placed over``
    lines."""
    t0 = time.perf_counter()
    p = subprocess.run(cmd, env=env, cwd=HERE, capture_output=True,
                       text=True, timeout=1800)
    text = p.stdout + p.stderr
    ranks = [json.loads(ln[len("ranks "):]) for ln in p.stdout.splitlines()
             if ln.startswith("ranks ")]
    mesh = [ln for ln in p.stdout.splitlines() if ln.startswith("arch=")]
    placed = [ln for ln in p.stdout.splitlines()
              if ln.startswith("params:")]
    return dict(cmd=" ".join(cmd[1:]), rc=p.returncode,
                ranks=ranks[0] if ranks else None,
                mesh_line=mesh[0] if mesh else None,
                placed_line=placed[0] if placed else None,
                s=time.perf_counter() - t0, tail=text[-6000:])


def _lone_lgd(device: str, n: int) -> dict:
    """The lgd mode's lone run, in this process: the launcher's model,
    LSH batches from the job's ``n`` shards and trainer
    (``launch.train``'s ``load_model``, ``make_batches(n_shards=n)``,
    ``make_trainer``), meshless, on card 0 or the CPU; its report has
    the launcher's ``ranks`` form."""
    import gc
    import torch
    from repro_torch import kernels
    from repro_torch.launch import train as lt

    t0 = time.perf_counter()
    size = LAUNCHER_SIZE[device]
    dev = kernels.resolve_device(device)
    kernels.reset_launch_counts()
    cfg, model = lt.load_model(PHI4, size["full"], dev)
    sampler, batches = lt.make_batches(
        cfg, model, lgd=True, batch=size["batch"], seq=size["seq"],
        corpus=size["corpus"], device=dev, n_shards=n)
    tr = lt.make_trainer(cfg, model, steps=LAUNCHER_STEPS, lr=LAUNCHER_LR,
                         sampler=sampler, batches=batches)
    report = {"rank": 0, "device": str(dev),
              "losses": tr.run(LAUNCHER_STEPS)["losses"]}
    tr.finalize()
    report["launches"] = dict(kernels.launches)
    if dev.type == "cuda":      # this process used no card before
        report.update(current_device=torch.cuda.current_device(),
                      peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    del tr, sampler, batches, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return dict(cmd=f"in this process: launch.train.load_model, "
                    f"make_batches(n_shards={n}), make_trainer", rc=0,
                ranks=[report], mesh_line=None, placed_line=None,
                s=time.perf_counter() - t0, tail="")


def launcher(args) -> int:
    """``--launcher MODE``: the launcher as a job of ``--nprocs`` ranks
    against one process alone (see the module docstring)."""
    n, cuda, mode = args.nprocs, args.device == "cuda", args.launcher
    sys.path.insert(0, os.path.join(HERE, "src"))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "src")] + [x for x in env.get(
            "PYTHONPATH", "").split(os.pathsep) if x])
    env.setdefault("OMP_NUM_THREADS", "1")
    size = LAUNCHER_SIZE[args.device]
    flags = ["--arch", PHI4, "--steps", str(LAUNCHER_STEPS), "--lr",
             str(LAUNCHER_LR), "--batch", str(size["batch"]), "--seq",
             str(size["seq"]), "--corpus", str(size["corpus"]),
             "--device", args.device] + (["--full"] if size["full"] else [])
    if mode == "lgd":
        flags += ["--lgd"]
    if mode == "production":
        flags += ["--production-mesh"]
    entry = ["-m", "repro_torch.launch.train"]
    job_cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(n)] + entry + flags

    def alone_run():
        if mode == "lgd":
            return _lone_lgd(args.device, n)
        return _launcher_run([sys.executable] + entry + flags, env)

    if mode == "production":
        job = _launcher_run(job_cmd, env)
        want = (f"the production mesh (16, 16) needs 256 ranks, the "
                f"process group has {n}")
        res = dict(mode=mode, job=job, want=want, ok=bool(
            job["rc"] != 0 and want in job["tail"]
            and "in a process group" not in job["tail"]))
    else:
        if cuda:
            job = _launcher_run(job_cmd, env)
            alone = alone_run()
        else:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(1) as ex:
                pending = ex.submit(_launcher_run, job_cmd, env)
                alone = alone_run()
                job = pending.result()
        res = dict(mode=mode, job=job, alone=alone)
        reports = job["ranks"] or []
        ok = job["rc"] == 0 and alone["rc"] == 0 and len(reports) == n \
            and alone["ranks"] is not None
        if ok:
            want_mesh = f"mesh={{'data': {n}, 'model': 1}}"
            ok &= want_mesh in job["mesh_line"] and \
                f"placed over {n} ranks" in job["placed_line"]
            losses = [r["losses"] for r in reports]
            base = alone["ranks"][0]["losses"]
            rel = [abs(a - b) / abs(b) for a, b in zip(losses[0], base)]
            res.update(losses=losses[0], losses_alone=base, loss_rel=rel,
                       ranks_equal=all(x == losses[0] for x in losses))
            ok &= res["ranks_equal"] and len(base) == LAUNCHER_STEPS and \
                max(rel) <= (LAUNCHER_RTOL_BF16 if cuda else LAUNCHER_RTOL)
            if cuda:
                res["cards"] = [r["current_device"] for r in reports]
                res["peak_gb"] = [r["peak_gb"] for r in reports]
                res["peak_gb_alone"] = alone["ranks"][0]["peak_gb"]
                ok &= res["cards"] == list(range(n))
            if cuda and mode == "lgd":
                want = {"simhash": n, "bucket_probe": n * LAUNCHER_STEPS,
                        "draw_assemble": n * LAUNCHER_STEPS}
                res["launches"] = [{k: r["launches"][k] for k in want}
                                   for r in reports]
                res["launches_alone"] = {
                    k: alone["ranks"][0]["launches"][k] for k in want}
                res["launches_want"] = want
                ok &= all(x == want for x in res["launches"]) and \
                    res["launches_alone"] == want
        res["ok"] = bool(ok)
    row = {k: v for k, v in res.items() if k not in ("job", "alone")}
    row.update({k: {x: y for x, y in res[k].items() if x != "tail"}
                for k in ("job", "alone") if k in res})
    print("mesh-check " + json.dumps({"launcher": mode, **row}), flush=True)
    if not res["ok"]:
        for k in ("job", "alone"):
            if k in res:
                print(f"--- {k} output tail ---\n{res[k]['tail']}",
                      flush=True)
    if args.out:
        with open(os.path.join(args.out, f"launcher-{mode}.json"), "w") as f:
            json.dump(res, f)
    return 0 if res["ok"] else 1


def _wait_all(procs, grace: float = 60.0) -> list:
    """The exit codes of ``procs``; ``grace`` seconds after one has
    failed, the others are killed (they may wait for it in a collective
    for ever)."""
    failed_at = None
    while any(p.poll() is None for p in procs):
        if failed_at is None and any(p.poll() not in (None, 0)
                                     for p in procs):
            failed_at = time.monotonic()
        if failed_at is not None and time.monotonic() - failed_at > grace:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        time.sleep(0.5)
    return [p.returncode for p in procs]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nprocs", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--checks", default=",".join(CHECKS))
    ap.add_argument("--out", default=None)
    ap.add_argument("--host-mesh", action="store_true")
    ap.add_argument("--launcher", default=None, choices=LAUNCHER_MODES)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--dir", default=None)
    args = ap.parse_args(argv)
    unknown = set(args.checks.split(",")) - set(CHECKS)
    if unknown:
        ap.error(f"unknown checks {sorted(unknown)}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    if args.host_mesh:
        return host_mesh(args)
    if args.rank is not None:
        return child(args)
    if args.device == "cuda":
        import torch
        if torch.cuda.device_count() < args.nprocs:
            print(f"{args.nprocs} processes need {args.nprocs} cards, "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True)
        print(smi.stdout.strip(), flush=True)
        sys.path.insert(0, os.path.join(HERE, "src"))
        from repro_torch.kernels import build
        build.build_all()       # once, before the processes load them
    if args.launcher:
        return launcher(args)
    with tempfile.TemporaryDirectory() as d:
        extra = ["--out", args.out] if args.out else []
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--nprocs",
             str(args.nprocs), "--device", args.device, "--checks",
             args.checks, "--rank", str(r), "--dir", d] + extra)
            for r in range(args.nprocs)]
        rcs = _wait_all(procs)
    print(f"mesh-check exit codes {rcs}", flush=True)
    return 0 if all(rc == 0 for rc in rcs) else 1


if __name__ == "__main__":
    sys.exit(main())
