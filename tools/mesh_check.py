#!/usr/bin/env python3
"""The port on a mesh of several processes against the meshless run.

    python3 tools/mesh_check.py [--nprocs 4] [--device cuda|cpu]
        [--checks train,serve,lgd,batch,optimizers,archs,restore,entries]
        [--out DIR]
    python3 tools/mesh_check.py --host-mesh [--device cpu] [--out DIR]

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
CHECKS = ("train", "serve", "lgd", "batch", "optimizers", "archs",
          "restore", "entries")
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

def _train(mesh, device, *, arch=PHI4, optimizer="adam", **overrides):
    """The gradient of every leaf (whole), then one clipped step: loss,
    grad_norm, the parameters after it (whole) and their placements."""
    from repro_torch import configs
    from repro_torch.dist.sharding import distribute_model, use_mesh
    from repro_torch.models import LM
    from repro_torch.optim import make_optimizer
    from repro_torch.train import Trainer, TrainerConfig

    cfg = configs.get_smoke(arch).with_(**overrides)
    batch = _lm_batch(device, cfg.vocab)
    with use_mesh(mesh):
        model = distribute_model(LM.init(cfg, seed=0, device=device), mesh)
        model.loss(batch).backward()
        grads = {k: _whole(p.grad).detach().clone()
                 for k, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        tr = Trainer(cfg, model, make_optimizer(optimizer, lr=LR),
                     iter([batch]),
                     TrainerConfig(log_every=1, grad_clip=CLIP),
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
            "s": dt}


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nprocs", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--checks", default=",".join(CHECKS))
    ap.add_argument("--out", default=None)
    ap.add_argument("--host-mesh", action="store_true")
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
