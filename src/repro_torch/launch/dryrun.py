"""Dry run over the production meshes: build and run one step of every
(arch x shape x mesh) cell without the devices (PyTorch port of
``repro.launch.dryrun``, which also does the work of the reference's
``launch/hlo_analysis.py``).

The reference lowers and compiles each cell on 512 placeholder devices
and reads the compiled HLO.  Here each cell runs one step in ONE process
as rank 0 of a ``fake`` process group of 256 (16 x 16) or 512
(2 x 16 x 16) ranks, under ``FakeTensorMode``: the production
``DeviceMesh``, DTensor parameters (``dist.sharding.distribute_model``),
optimiser state (``distribute_state``), batch (``batch_shardings``) and
cache (``cache_shardings``), and the port's eager step.  No byte is
allocated and no collective moves data, but every placement, every
redistribution and every local shape is the real one, so the counts
below are rank 0's of the production run:

* FLOPs a rank: the matmul FLOPs of ``torch.utils.flop_counter``'s
  formulas (the ones ``FlopCounterMode`` applies).  A dispatch mode sees
  a DTensor op at its GLOBAL shapes (the local op runs inside DTensor),
  so such an op counts its global FLOPs over the ranks that split its
  work (the mesh dims its output is sharded or partial on); an op on
  plain tensors (attention and the mixers' scans run per rank through
  ``local_map``) counts as it is.  ``FlopCounterMode`` itself is not
  run: its total mixes DTensor ops at their global shapes with local
  ops, which is no rank's count, and it costs a cell ~30% more time.
* Collectives: the count and the bytes of each kind's results a rank
  (all-gather: the gathered tensor; reduce-scatter: the shard;
  all-reduce: the tensor), as the reference sums the HLO result shapes,
  read off the functional collectives DTensor issues on local tensors,
  inside an op's sharding propagation too (what ``CommDebugMode``
  counts; its module tracker refuses a module called twice in a step,
  as zamba2's shared block is, so the counter does it).  The ops that
  issued the most bytes are named.  The fake mesh is a CPU one, so
  DTensor's ``shard_dim_alltoall`` takes its gloo fallback and counts
  as an all-gather.
* Memory: the parameter, gradient and optimiser bytes a rank (the local
  shards), and the peak of the live local storages a rank (the state,
  the batch and cache, and every local op's outputs, DTensor's
  temporaries among them, from their allocation until they are freed),
  held against the H100's 80 GB.  (``MemTracker`` refuses a module
  called twice in a step, as zamba2's shared block is.)
* Bytes accessed a rank: every non-view op's inputs and outputs, local.

``hlo_analysis.py`` has no torch counterpart: its job (loop-aware FLOPs,
bytes and collectives of the compiled program) is these counters, taken
on the eager step itself, so a Python loop over layers or chunks is
counted once an iteration with no loop analysis.

The counts are for the H100 mesh the production layout maps to, not
device times; ``launch.roofline`` turns them into bounds.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi4_mini_3_8b \\
      --shape train_4k [--multi-pod] [--smoke] [--out results.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out DIR/x.json
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import threading
import time
import weakref
from typing import Optional

import torch

from repro_torch import configs
from repro_torch.configs.shapes import (
    SHAPES,
    apply_vocab,
    batch_specs,
    cache_specs,
    shape_applicable,
)
from repro_torch.dist.sharding import (
    _data_axes,
    data_axis_size,
    distribute_cache,
    distribute_model,
    distribute_state,
    is_dtensor,
    mesh_axes,
    shard_of,
    spec_placements,
    use_mesh,
)
from repro_torch.launch.mesh import init_fake_group, make_production_mesh
from repro_torch.models import LM, ModelConfig
from repro_torch.optim import Adafactor, Adam, update_in_place

H100_HBM_BYTES = 80e9       # one H100 SXM's HBM3

# Architectures whose optimiser state must be factored to fit (params
# >= 100 B): Adafactor; the rest use Adam (f32 m and v)
GIANT_ARCHS = {"qwen3_moe_235b_a22b", "llama4_maverick_400b_a17b",
               "llama_3_2_vision_90b"}


def pick_optimizer(arch: str):
    if configs._canon(arch) in GIANT_ARCHS:
        return Adafactor(lr=1e-2)
    return Adam(lr=3e-4)


# ---------------------------------------------------------------------------
# steps (the model and its state are updated in place, as in training)
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, optimizer):
    def train_step(model, opt_state, batch):
        loss = model.loss(batch)
        loss.backward()
        named = dict(model.named_parameters())
        with torch.no_grad():
            # a parameter the loss does not reach (an embed_stub arch's
            # token table) gets a zero gradient, as jax.grad gives it
            grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
                     for k, p in named.items()}
            opt_state = update_in_place(optimizer, named, grads, opt_state)
        return opt_state, loss
    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(model, batch, cache):
        return model.prefill(batch, cache)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(model, batch, cache):
        return model.decode_step(batch, cache)
    return serve_step


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------

def _batch_spec(spec, mesh) -> tuple:
    """The reference's batch spec of one stand-in: dim 0 over the data
    axes when they divide it, else replicated."""
    data = _data_axes(mesh)
    if spec.shape and spec.shape[0] % data_axis_size(mesh) == 0:
        return (data,)
    return ()


def batch_shardings(specs: dict, mesh) -> dict:
    """{key: placements}: batch dim 0 over the data axes (replicated where
    they do not divide it)."""
    return {k: spec_placements(_batch_spec(s, mesh), mesh)
            for k, s in specs.items()}


def reference_cache_spec(shape: tuple, cfg: ModelConfig, mesh) -> tuple:
    """The reference's ``cache_shardings`` rule on one STACKED cache leaf
    (R, B, ...): batch on the data axes; an attention K/V (R, B, S, Hkv,
    D) sharded over ``model`` on its sequence (the long-context decode
    sharding), else on its heads; an SSM state (R, B, H, N, P) on its
    heads."""
    data = _data_axes(mesh)
    dn = data_axis_size(mesh)
    mn = mesh_axes(mesh)["model"]
    spec = [None] * len(shape)
    if len(shape) >= 2 and shape[1] % dn == 0:
        spec[1] = data
    if len(shape) == 5:
        if shape[3] in (cfg.n_kv_heads, cfg.n_heads):
            if shape[2] % mn == 0:
                spec[2] = "model"
            elif shape[3] % mn == 0:
                spec[3] = "model"
        elif shape[2] % mn == 0:
            spec[2] = "model"
    return tuple(spec)


def cache_shardings(specs: list, cfg: ModelConfig, mesh) -> list:
    """Placements of the port's per-layer cache (``cache_specs``): each
    tensor gets the reference's spec of the stacked leaf that holds it,
    (R,) + its shape, with the layer axis removed."""
    r = cfg.repeats

    def one(s):
        return spec_placements(
            reference_cache_spec((r,) + tuple(s.shape), cfg, mesh)[1:], mesh)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, tuple) and not hasattr(node, "dtype"):
            return tuple(walk(v) for v in node)
        return one(node)

    return [walk(c) for c in specs]


def _materialize(spec, mesh, placements):
    """A zero tensor of ``spec`` (under ``FakeTensorMode``: no memory) as
    this rank's shard under ``placements``."""
    return shard_of(torch.zeros(spec.shape, dtype=spec.dtype), mesh,
                    placements)


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",      # namespace _dtensor
}


def _local(t):
    return t._local_tensor if is_dtensor(t) else t


def _nbytes(t) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _split(t) -> int:
    """The ranks that split a DTensor's work: the mesh dims it is
    sharded or partial on."""
    n = 1
    for i, p in enumerate(t.placements):
        if not p.is_replicate():
            n *= t.device_mesh.size(i)
    return n


def _call_site() -> str:
    """The innermost frame of the port's model or optimiser code on the
    stack ("models/layers.py:231 write_rows"), outside the placement
    helpers; "backward" when autograd issued it."""
    import traceback
    for fr in reversed(traceback.extract_stack()):
        path = fr.filename.replace(os.sep, "/")
        if "/repro_torch/" in path and "/dist/sharding.py" not in path \
                and "/launch/dryrun.py" not in path:
            return (f"{path.split('/repro_torch/')[1]}:{fr.lineno} "
                    f"{fr.name}")
    return "backward"


class RankCounter:
    """Counts rank 0's step (module docstring) in two dispatch modes.

    The outer one sees a DTensor op at its global shapes and counts the
    matmul FLOPs and the bytes accessed (``ops=False`` leaves it out).
    The inner one declines DTensor ops, as ``CommDebugMode`` does, so it
    sees the local ops DTensor runs, the redistributions its sharding
    propagation makes inside an op among them: it counts the collectives
    (each named by its call site, ``_call_site``) and the live local
    storages.  A storage is counted from the op that allocates it until
    it is freed (a weakref callback on its storage object, which lives
    as long as the storage), and the peak is taken at every
    allocation.  DTensor's sharding propagation runs an op it has not
    seen on global-shaped fake tensors to learn its output's shape; those
    are no rank's memory and are not counted."""

    def __init__(self, ops: bool = True):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        counter = self

        class _Ops(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                counter._record_op(func, args, kwargs or {}, out)
                return out

        class _Local(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if isinstance(func, torch._ops.HigherOrderOperator):
                    return func(*args, **(kwargs or {}))
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **(kwargs or {}))
                counter._record_local(func, out)
                return out

        self._modes = [_Local()] + ([_Ops()] if ops else [])
        self._registry = flop_registry
        self._live: dict = {}     # storage key -> (weak ref, bytes)
        self._live_bytes = 0
        self._meta = 0            # > 0 inside sharding propagation
        self._unpatch = None
        self.peak_bytes = 0
        self.flops = 0.0
        self.bytes = 0
        self.collectives = collections.Counter()
        self.coll_counts = collections.Counter()
        self.coll_by_op = collections.Counter()

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP

        meta = SP._propagate_tensor_meta_non_cached
        mine = threading.get_ident()      # the modes are this thread's

        def counted(sp, *a, **kw):
            if threading.get_ident() != mine:
                return meta(sp, *a, **kw)
            self._meta += 1
            try:
                return meta(sp, *a, **kw)
            finally:
                self._meta -= 1

        SP._propagate_tensor_meta_non_cached = counted
        self._unpatch = lambda: setattr(
            SP, "_propagate_tensor_meta_non_cached", meta)
        for m in self._modes:
            m.__enter__()
        return self

    def __exit__(self, *exc):
        for m in reversed(self._modes):
            m.__exit__(*exc)
        self._unpatch()

    def summary(self) -> dict:
        """The collectives: bytes and count by kind, bytes by call site."""
        return dict(bytes=dict(self.collectives),
                    count=dict(self.coll_counts),
                    by_site=dict(self.coll_by_op))

    def track(self, tree) -> None:
        """Count the local storages of ``tree`` as live (the state that
        exists before the step)."""
        for t in _tensors(tree):
            self._add(t)

    def _add(self, t) -> None:
        st = _local(t).untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        nb = st.nbytes()
        self._live[key] = (weakref.ref(st, lambda _: self._free(key)), nb)
        self._live_bytes += nb
        self.peak_bytes = max(self.peak_bytes, self._live_bytes)

    def _free(self, key) -> None:
        self._live_bytes -= self._live.pop(key)[1]

    def _record_local(self, func, out) -> None:
        if not self._meta:
            for t in _tensors(out):
                self._add(t)
        name = func.overloadpacket.__name__
        kind = _COLLECTIVES.get(name) if func.namespace in (
            "_c10d_functional", "_dtensor") else None
        if kind is not None:
            b = sum(_nbytes(t) for t in _tensors(out))
            self.collectives[kind] += b
            self.coll_counts[kind] += 1
            self.coll_by_op[_call_site()] += b

    def _record_op(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        if func.namespace != "aten" or func.is_view or \
                name in ("detach", "alias"):
            return
        dt = any(is_dtensor(t) for t in _tensors(args))
        self.bytes += (sum(_nbytes(t) for t in _tensors(args))
                       + sum(_nbytes(t) for t in _tensors(out)))
        fn = self._registry.get(func.overloadpacket)
        if fn is None:
            return
        outs = list(_tensors(out))
        f = fn(*args, **kwargs, out_val=out)
        if dt and outs and is_dtensor(outs[0]):
            f /= _split(outs[0])
        self.flops += f


# ---------------------------------------------------------------------------
# cell runner
# ---------------------------------------------------------------------------

def _local_bytes(tree) -> int:
    return sum(_nbytes(t) for t in _tensors(tree))


def run_cell(arch: str, shape_name, *, multi_pod: bool = False,
             cfg_override: Optional[ModelConfig] = None,
             verbose: bool = True) -> dict:
    """One cell: rank 0's counts (module docstring), or ``skipped`` with
    ``shape_applicable``'s reason.  ``shape_name`` names one of
    ``SHAPES``, or is a ``ShapeSpec`` of its own (a cut-down cell)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = cfg_override or configs.get(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    shape_name = shape.name
    skip = shape_applicable(cfg, shape)
    if skip is not None:
        return {"arch": arch, "shape": shape_name, "skipped": skip}
    cfg = apply_vocab(cfg, shape)
    world = 512 if multi_pod else 256
    init_fake_group(world)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    optimizer = pick_optimizer(arch)
    t0 = time.time()
    counter = RankCounter()
    with FakeTensorMode(allow_non_fake_inputs=True), use_mesh(mesh):
        model = distribute_model(LM(cfg, device="cpu"), mesh)
        named = dict(model.named_parameters())
        n_params = sum(p.numel() for p in named.values())
        param_bytes = _local_bytes(named)
        b_specs = batch_specs(cfg, shape)
        b_place = batch_shardings(b_specs, mesh)
        batch = {k: _materialize(s, mesh, b_place[k])
                 for k, s in b_specs.items()}
        opt_bytes = grad_bytes = 0
        counter.track((named, batch))
        if shape.kind == "train":
            opt_state = distribute_state(optimizer.init(
                {k: p.detach() for k, p in named.items()}), mesh, cfg)
            opt_bytes = _local_bytes(tuple(opt_state))
            counter.track(tuple(opt_state))
            step = make_train_step(cfg, optimizer)
            with counter:
                _, loss = step(model, opt_state, batch)
            grad_bytes = _local_bytes(
                [p.grad for p in named.values() if p.grad is not None])
            out_shape = tuple(loss.shape)
        else:
            c_specs = cache_specs(cfg, shape)
            c_place = cache_shardings(c_specs, cfg, mesh)
            cache = distribute_cache(
                [_walk_zeros(c) for c in c_specs], model.embed_group.embed,
                c_place)
            counter.track(cache)
            step = (make_prefill_step(cfg) if shape.kind == "prefill"
                    else make_serve_step(cfg))
            with torch.no_grad(), counter:
                out, _ = step(model, batch, cache)
            out_shape = tuple(out.shape)
    peak_bytes = counter.peak_bytes
    n_dev = 512 if multi_pod else 256
    result = {
        "arch": arch,
        "shape": shape_name,
        "config": cfg.name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": n_dev,
        "n_params": n_params,
        "output_shape": out_shape,
        "flops_per_device": counter.flops,
        "bytes_per_device": counter.bytes,
        "collectives": dict(counter.collectives),
        "collective_counts": dict(counter.coll_counts),
        "top_collectives": counter.coll_by_op.most_common(8),
        "param_bytes_per_device": param_bytes,
        "grad_bytes_per_device": grad_bytes,
        "opt_bytes_per_device": opt_bytes,
        "peak_bytes_per_device": peak_bytes,
        "fits_80GB": bool(peak_bytes <= H100_HBM_BYTES),
        "wall_s": round(time.time() - t0, 1),
    }
    if verbose:
        print(json.dumps(result, default=str))
    return result


def _walk_zeros(node):
    if isinstance(node, dict):
        return {k: _walk_zeros(v) for k, v in node.items()}
    if isinstance(node, tuple) and not hasattr(node, "dtype"):
        return tuple(_walk_zeros(v) for v in node)
    return torch.zeros(node.shape, dtype=node.dtype)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) cell")
    ap.add_argument("--smoke", action="store_true",
                    help="the archs' SMOKE configs at the cell's shape")
    ap.add_argument("--out", default=None, help="JSON output path")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in configs.all_archs()
                 for s in ([args.shape] if args.shape else SHAPES)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    results = []
    for arch, shape in cells:
        override = configs.get_smoke(arch) if args.smoke else None
        try:
            results.append(run_cell(arch, shape, multi_pod=args.multi_pod,
                                    cfg_override=override))
        except Exception as e:
            results.append({"arch": arch, "shape": shape,
                            "error": repr(e)})
            print(f"FAILED {arch} x {shape}: {e!r}")
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=2, default=str)
    if args.out:
        print(f"wrote {args.out}")
    failed = [r for r in results if "error" in r]
    print(f"\n{len(results) - len(failed)}/{len(results)} cells OK")
    if failed:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
