#!/usr/bin/env python3
"""Where the MoE giants' memory and collectives go, layer by layer,
without four cards.

    python3 tools/giants_probe.py fake [--out FILE]
    python3 tools/giants_probe.py place [--out FILE]
    python3 tools/giants_probe.py pod [--device cuda|cpu] [--out FILE]

``fake`` (CPU only): rank 0 of a ``fake`` four-rank group, the models
under ``FakeTensorMode`` at full width and one layer (llama4 and
qwen3-moe, bf16), on (1, 4), (2, 2) and (4, 1): for the first MoE
layer's forward, its backward, and Adafactor's update of its three
expert leaves, the collectives this rank issues (kind, output bytes,
call site: ``tools/mesh_check.py``'s ``collectives()``) and the largest
tensor it makes (not a view, not inside DTensor's sharding
propagation).  What DTensor chooses depends on the torch version, so
run it where the cards' torch is.

``place`` (one card): llama4 at full width and 2 of its 48 layers drawn
whole on card 0 (``LM.init``) and placed on a (1, 4) mesh of a fake
four-rank group (``distribute_model``; no data moves): the card's
allocated, reserved and peak memory after the draw and after each leaf
is placed, as the four-card run's ranks see them before their first
collective.

``pod`` (one card): qwen3-moe at full width, 3 of its 94 layers in f32,
one training step (loss and backward) on 8 rows of 512 tokens, on the
(4, 1) mesh and on the pod layout (``pod`` 2, ``data`` 2, ``model`` 1)
of a fake four-rank group (collectives move no data, but allocate as a
card's do): rank 0's peak allocated memory over the step, and the
count of ``tools/mesh_check.py``'s ``collectives()``: what
``tools/mesh_check.py --checks placement`` reads for the pod layout on
four cards, on one.  On ``--device cpu`` the SMOKE config (the count
only).

One JSON line a measurement, prefixed ``giants-probe``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(0, os.path.join(HERE, "tools"))

LAYOUTS = ((1, 4), (2, 2), (4, 1))
ARCHS = ("llama4_maverick_400b_a17b", "qwen3_moe_235b_a22b")
GiB = 1 << 30


def _biggest():
    """A dispatch mode keeping the bytes and the port's call site of the
    largest tensor made outside DTensor's sharding propagation."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class Biggest(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes, self.at = 0, None

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if isinstance(func, torch._ops.HigherOrderOperator):
                return func(*args, **(kwargs or {}))
            if any(t is DTensor for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            if func.is_view:
                return out
            stack = traceback.extract_stack()
            if any("_sharding_prop" in f.filename
                   or "_op_schema" in f.filename for f in stack):
                return out
            for t in (out if isinstance(out, (list, tuple)) else [out]):
                if isinstance(t, torch.Tensor) and \
                        t.numel() * t.element_size() > self.bytes:
                    self.bytes = t.numel() * t.element_size()
                    port = [f for f in stack if "repro_torch" in f.filename]
                    self.at = (f"{port[-1].filename.split('repro_torch/')[1]}"
                               f":{port[-1].lineno}" if port else str(func))
            return out

    return Biggest()


def fake(emit) -> None:
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor
    from mesh_check import collectives
    from repro_torch import configs
    from repro_torch.dist.sharding import (batch_sharding, distribute_model,
                                           distribute_state, use_mesh)
    from repro_torch.launch.mesh import init_fake_group
    from repro_torch.models import LM
    from repro_torch.optim import Adafactor, update_in_place

    init_fake_group(4)
    for arch in ARCHS:
        cfg = configs.get(arch).with_(n_layers=1)
        for d, m in LAYOUTS:
            mesh = DeviceMesh("cpu", torch.arange(4).reshape(d, m),
                              mesh_dim_names=("data", "model"))
            row = {"arch": arch, "layout": [d, m], "torch": torch.__version__}
            with FakeTensorMode(allow_non_fake_inputs=True), use_mesh(mesh):
                model = distribute_model(LM(cfg, device="cpu"), mesh)
                moe = model._layer(0).ffn
                x = distribute_tensor(
                    torch.zeros(8, 512, cfg.d_model, dtype=torch.bfloat16),
                    mesh, batch_sharding(mesh), src_data_rank=None)
                named = {f"blocks.0.ffn.{k}": p
                         for k, p in moe.named_parameters()}
                opt = Adafactor(lr=1e-2)
                state = distribute_state(opt.init(
                    {k: p.detach() for k, p in named.items()}), mesh, cfg)
                parts = {}
                with collectives() as c, _biggest() as b:
                    y = moe(x)
                parts["forward"] = (c, b)
                with collectives() as c, _biggest() as b:
                    torch.autograd.backward(y, torch.ones_like(y))
                parts["backward"] = (c, b)
                grads = {k: p.grad for k, p in named.items()}
                with collectives() as c, _biggest() as b:
                    update_in_place(opt, named, grads, state)
                parts["adafactor"] = (c, b)
                row["local_leaf_f32_gb"] = max(
                    p.to_local().numel() for p in named.values()) * 4 / 1e9
            for name, (c, b) in parts.items():
                row[name] = dict(c.summary(), biggest_gb=b.bytes / 1e9,
                                 biggest_at=b.at)
            emit(row)


def place(emit) -> None:
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch import configs
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import init_fake_group
    from repro_torch.models import LM

    def mem(**kw):
        emit(dict(kw, allocated_gib=torch.cuda.memory_allocated() / GiB,
                  reserved_gib=torch.cuda.memory_reserved() / GiB,
                  peak_gib=torch.cuda.max_memory_allocated() / GiB))

    init_fake_group(4)
    torch.cuda.set_device(0)
    mesh = DeviceMesh("cuda", torch.arange(4).reshape(1, 4),
                      mesh_dim_names=("data", "model"))
    cfg = configs.get("llama4_maverick_400b_a17b").with_(n_layers=2)
    lm = LM.init(cfg, seed=0, device="cuda:0")
    torch.cuda.synchronize()
    mem(at="drawn whole", torch=torch.__version__)
    names = iter([n for n, _ in lm.named_parameters()])
    shard_of = sharding.shard_of

    def placed(t, m, pl):
        out = shard_of(t, m, pl)
        # the leaf before this one has been replaced and freed
        mem(at=f"shard of {next(names)} cut")
        return out

    sharding.shard_of = placed
    try:
        sharding.distribute_model(lm, mesh)
    finally:
        sharding.shard_of = shard_of
    mem(at="placed")


def pod(emit, device: str) -> None:
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from mesh_check import _pod_mesh, _token_batch, collectives
    from repro_torch import configs
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import init_fake_group
    from repro_torch.models import LM

    cuda = device == "cuda"
    dev = torch.device("cuda:0" if cuda else "cpu")
    if cuda:
        torch.cuda.set_device(0)
    init_fake_group(4)
    arch = "qwen3_moe_235b_a22b"
    cfg = (configs.get(arch).with_(n_layers=3, dtype="float32") if cuda
           else configs.get_smoke(arch))
    batch = _token_batch(cfg, 8, 512 if cuda else 32, dev)

    flat = DeviceMesh(dev.type, torch.arange(4).reshape(4, 1),
                      mesh_dim_names=("data", "model"))
    for name, mesh in (("4x1", flat), ("2x2x1", _pod_mesh(4, dev))):
        with sharding.use_mesh(mesh):
            model = sharding.distribute_model(
                LM.init(cfg, seed=0, device=dev), mesh)
            part = {k: sharding.shard_of(v, mesh, sharding.batch_sharding(
                mesh)) for k, v in batch.items()}
            counter = collectives()
            counter.track((dict(model.named_parameters()), part))
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            with counter:
                model.loss(part).backward()
            row = {"layout": name, "config": cfg.name, "dtype": cfg.dtype,
                   "layers": cfg.n_layers, "torch": torch.__version__,
                   "counted_peak_gb": counter.peak_bytes / 1e9,
                   "collective_gb": sum(
                       counter.summary()["bytes"].values()) / 1e9}
            if cuda:
                torch.cuda.synchronize()
                row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            emit(row)
            del model, part
            if cuda:
                torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=("fake", "place", "pod"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sink = open(args.out, "w") if args.out else None

    def emit(row):
        line = "giants-probe " + json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")

    if args.what == "pod":
        pod(emit, args.device)
    else:
        (fake if args.what == "fake" else place)(emit)
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
