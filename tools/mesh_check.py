#!/usr/bin/env python3
"""The port on a mesh of several processes against the meshless run.

    python3 tools/mesh_check.py [--nprocs 4] [--device cuda|cpu]
        [--checks train,compress,serve,lgd,batch,optimizers,archs,restore,
                  entries]
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
* archs (1, n): the train check of the SMOKE qwen3-moe and zamba2, the
  loss within 1e-5;
* restore (1, n): a meshless checkpoint restored by ``restore_on_mesh``
  equal bitwise after ``full_tensor()``, and a checkpoint a meshed
  trainer wrote (rank 0 writes) restored meshless, bitwise;
* entries (1, n): every kernel entry called with DTensor arguments (the
  attention entries with heads split over ``model``) equal bitwise to
  the call on plain arguments, a DTensor out; ``on_cuda`` refuses a
  DTensor.

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

Rank 0 prints one ``mesh-check`` JSON line a mesh and one for the (1, n)
checks, and on ``cuda`` the card's name and power limit; with ``--out``
every rank writes its results to ``DIR/rank<R>.json`` (``DIR/host.json``
for ``--host-mesh``).  The exit code is non-zero when a check fails.
"""

from __future__ import annotations

import argparse
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
          "archs", "restore", "entries")
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


def _serve(mesh, device, prompts, forced=None, dtype="float32"):
    import torch
    from repro_torch import kernels
    from repro_torch.dist.sharding import distribute_model, use_mesh
    from repro_torch.launch import dryrun
    from repro_torch.models import LM

    cfg = _serve_cfg(device, dtype)
    kernels.reset_launch_counts()
    with use_mesh(mesh), torch.no_grad():
        model = distribute_model(LM.init(cfg, seed=0, device=device), mesh)
        b, s = prompts.shape
        cache = model.init_cache(b, s + SERVE_NEW)
        t0 = time.perf_counter()
        h, cache = dryrun.make_prefill_step(cfg)(
            model, {"tokens": prompts}, cache)
        nxt = _whole(model.embed_group.lm_logits(h[:, -1:])).argmax(-1)
        logits, toks = [], [nxt]
        step = dryrun.make_serve_step(cfg)
        for i in range(SERVE_NEW):
            # teacher-forced by the meshless run's tokens when given
            inp = nxt if forced is None else forced[i]
            lg, cache = step(model, {
                "tokens": inp.to(torch.int32),
                "positions": torch.full((b, 1), s + i, dtype=torch.int32,
                                        device=device)}, cache)
            lg = _whole(lg).float()
            nxt = lg.argmax(-1)
            logits.append(lg)
            toks.append(nxt)
        if device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        heads = _placements(model.blocks[0].attn.wq)
    used = {k: kernels.launches[k] for k in ("flash_attention",
                                              "flash_decode")}
    return logits, toks, used, dt, heads, cfg


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
# the processes
# ---------------------------------------------------------------------------

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
    dist.init_process_group(
        "nccl" if cuda else "gloo",
        store=dist.FileStore(os.path.join(args.dir, "store"), args.nprocs),
        rank=args.rank, world_size=args.nprocs)
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
        lg0, tok0, _, sdt0, _, cfg_s = _serve(None, device, prompts)
        bf0 = _serve(None, device, prompts, forced=tok0,
                     dtype="bfloat16")[0] if cuda else None
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
            lg, tok, used, sdt, heads, _ = _serve(mesh, device, prompts,
                                                  forced=tok0)
            rel = _rel_l2(lg, lg0)
            want = {"flash_attention": cfg_s.n_layers,
                    "flash_decode": cfg_s.n_layers * SERVE_NEW} if cuda \
                else used
            row["serve"] = dict(
                rel_l2=rel, tol=SERVE_TOL,
                same_tokens=all(torch.equal(a, b) for a, b in zip(tok, tok0)),
                launches=used, wq_placements=heads, s=sdt, s_meshless=sdt0,
                ok=bool(rel <= SERVE_TOL and used == want))
            if cuda:
                bf = _serve(mesh, device, prompts, forced=tok0,
                            dtype="bfloat16")[0]
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
            cases.update({a: dict(arch=a) for a in ("qwen3_moe_235b_a22b",
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
    ok = all(c["ok"] for row in res["meshes"].values()
             for c in row.values() if isinstance(c, dict) and "ok" in c)
    ok &= all(c["ok"] for c in one_n.values())
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
        rcs = [p.wait() for p in procs]
    print(f"mesh-check exit codes {rcs}", flush=True)
    return 0 if all(rc == 0 for rc in rcs) else 1


if __name__ == "__main__":
    sys.exit(main())
