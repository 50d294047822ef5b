"""Placement of parameters, activations and LGD batches (PyTorch port of
``repro.dist.sharding``).

The mesh half, on ``torch.distributed.device_mesh.DeviceMesh`` and
DTensor placements (``Shard``, ``Replicate``):

* ``use_mesh`` / ``current_mesh``: the active mesh for ``logical``.
* ``logical(x, *axes)`` names a tensor's dims by LOGICAL axes ("batch",
  "seq", "heads", "ff", "vocab", "experts") that resolve to mesh axes
  under ``use_mesh``: "batch" to the data axes (``("pod", "data")`` on a
  multi-pod mesh), the others to ``model``.  Outside a mesh it is a
  no-op, so every model runs unsharded unchanged.  Under a mesh it
  redistributes a DTensor to the resolved placements (a dim its axes do
  not divide stays replicated), which decides where the activations
  live and so which collectives a step issues.  A plain tensor passes
  through: it is this rank's own data, and it meets a DTensor operand
  only through ``replicate_like``.
* ``param_spec(name, shape, mesh)`` gives one of the port's leaves the
  reference's spec: tensor parallel over heads / experts / vocab on
  ``model``, FSDP over the feature dim on the data axes, norms and
  indivisible dims replicated.  The port keeps one leaf a layer where
  the reference stacks a pattern position's layers into one
  ``blocks/...`` leaf, so a layer's leaf gets the spec of the stacked
  leaf with its leading (scan) axis removed; the embed group's and the
  shared block's leaves get the reference's spec unchanged.  Optimiser
  slots (``slot="m"``, ...) take the spec the reference gives its
  optimiser-state leaf, whose path starts with the slot's field
  (``.m/blocks/...``), so the reference's stacked rule does not fire
  there and the scan axis counts as a feature axis; the port removes
  that axis's entry all the same.  Where the reference splits a slot's
  layer axis (over the data axes, when they divide the layer count:
  Adafactor's row statistics of llama4's 48 layers), the port's
  per-layer slot has no such axis and stays whole on those ranks.
* ``tree_param_shardings`` / ``param_placements`` turn specs into
  placements; ``distribute_model`` / ``distribute_state`` place an
  ``LM`` and its optimiser state; ``batch_sharding`` shards dim 0 over
  the data axes.
* ``host_local_mesh`` is the mesh over this host's ranks, None for
  fewer than two local devices, as in the reference.
* ``with_batch_view`` readies a multi-pod (``pod``, ``data``,
  ``model``) mesh where it is made: (``pod``, ``data``) flattened into
  one group, and the batch view, a (``pod`` · ``data``, ``model``) mesh
  over the same ranks, on which ``to_batch_view`` / ``from_batch_view``
  run the ops whose reshape merges the batch dim (the expert products,
  the embedding's lookup).

The mesh helpers touch only a mesh's axis names and sizes
(``mesh_axes``), so the spec tests pass stub meshes (an object with a
``shape`` dict and ``axis_names``) and need no devices.

The shard-by-example half:

* ``example_shard_bounds(n, s, S)``: the contiguous [lo, hi) of corpus
  shard s, sizes differing by at most 1 with the remainder to the lowest
  ids, bitwise the reference's.
* ``shard_store_device(device, s, S, mesh=)``: where shard s's token
  store and index live: the rank's device.  Under a mesh the store is
  replicated mesh-wide (every rank holds every shard's store), as the
  reference commits it under a single-controller mesh.
* ``compose_sharded_batch(parts, device, mesh=)``: the global batch as
  the concatenation of the per-shard sub-batches, shard s's rows at
  [s·m_s, (s+1)·m_s); under a mesh a DTensor under ``batch_sharding``
  whose local rows are this rank's data-parallel slice, a part that is
  exactly that slice adopted without a copy (``DTensor.from_local``).
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.kernels import is_dtensor, resolve_device

# ---------------------------------------------------------------------------
# mesh context
# ---------------------------------------------------------------------------

_MESH: list = []   # stack of active meshes


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate ``mesh`` for ``logical`` constraints within the block
    (``None`` activates no mesh: the meshless path)."""
    _MESH.append(mesh)
    try:
        yield mesh
    finally:
        _MESH.pop()


def current_mesh():
    return _MESH[-1] if _MESH else None


# ---------------------------------------------------------------------------
# axis resolution
# ---------------------------------------------------------------------------

def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size}, in mesh order, of a ``DeviceMesh`` or of a stub
    with ``shape`` (a dict) and ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        # ``size`` reads the layout; ``mesh.mesh`` builds a rank tensor
        return {a: mesh.size(i) for i, a in enumerate(names)}
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def _data_axes(mesh):
    return ("pod", "data") if "pod" in mesh_axes(mesh) else "data"


def _axis_size(mesh, axes) -> int:
    sizes = mesh_axes(mesh)
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= sizes[a]
    return n


def data_axis_size(mesh) -> int:
    """Total data-parallel degree of ``mesh`` (pod x data on multi-pod)."""
    return _axis_size(mesh, _data_axes(mesh))


def example_shard_bounds(n: int, shard_id: int, n_shards: int):
    """Contiguous [lo, hi) bounds of corpus shard ``shard_id``: a balanced
    split (sizes differ by at most 1, the remainder to the lowest ids)."""
    if not (0 <= shard_id < n_shards):
        raise ValueError(f"shard_id {shard_id} not in [0, {n_shards})")
    base, rem = divmod(n, n_shards)
    lo = shard_id * base + min(shard_id, rem)
    hi = lo + base + (1 if shard_id < rem else 0)
    return lo, hi


# logical activation axis -> mesh axis ("batch" -> the data axes, the
# model-parallel dims -> "model"; "seq" is the sequence-parallel residual
# sharding, also over "model")
_LOGICAL = {
    "batch": _data_axes,
    "seq": lambda mesh: "model",
    "heads": lambda mesh: "model",
    "ff": lambda mesh: "model",
    "vocab": lambda mesh: "model",
    "experts": lambda mesh: "model",
}


def logical_spec(shape: Sequence[int], axes: Sequence[Optional[str]],
                 mesh) -> tuple:
    """The spec ``logical`` resolves ``axes`` to for a tensor of
    ``shape``: one entry a dim (None, a mesh axis, or a tuple of them),
    None where the axes do not divide the dim."""
    if len(axes) != len(shape):
        raise ValueError(f"{len(axes)} logical axes for shape "
                         f"{tuple(shape)}")
    spec = []
    for dim, name in zip(shape, axes):
        phys = _LOGICAL[name](mesh) if name is not None else None
        if phys is not None and dim % _axis_size(mesh, phys) != 0:
            phys = None
        spec.append(phys)
    return tuple(spec)


def spec_placements(spec: Sequence, mesh) -> list:
    """DTensor placements (one a mesh dim) of a spec: ``Shard(d)`` on
    every mesh axis that tensor dim d names, ``Replicate()`` elsewhere.
    A tensor dim over several axes splits over them in the order named,
    the first outermost, as a JAX ``PartitionSpec`` does."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axes(mesh))
    out = [Replicate() for _ in names]
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            i = names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {a!r} named twice in {spec}")
            out[i] = Shard(d)
    return out


def replicated_call(fn, *args, **kwargs):
    """``fn`` on every rank's whole copy of its DTensor arguments (an
    all-gather where one is sharded), its tensor outputs back as
    replicated DTensors on the same mesh.  The LGD kernels' entries go
    through it: their store and index are replicated mesh-wide, and a
    draw reads all of them.  Tuples and named tuples of tensors (a draw's
    results) are mapped leaf by leaf."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = None

    def unwrap(a):
        nonlocal mesh
        if is_dtensor(a):
            mesh = a.device_mesh
            return a.full_tensor()
        if isinstance(a, tuple) and hasattr(a, "_fields"):
            return type(a)(*(unwrap(x) for x in a))
        if isinstance(a, tuple):
            return tuple(unwrap(x) for x in a)
        return a

    args = [unwrap(a) for a in args]
    kwargs = {k: unwrap(v) for k, v in kwargs.items()}
    out = fn(*args, **kwargs)

    def wrap(o):
        if isinstance(o, torch.Tensor):
            return DTensor.from_local(o, mesh, [Replicate()] * mesh.ndim,
                                      run_check=False)
        if isinstance(o, tuple) and hasattr(o, "_fields"):
            return type(o)(*(wrap(x) for x in o))
        if isinstance(o, tuple):
            return tuple(wrap(x) for x in o)
        return o

    return wrap(out)


def logical(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Place ``x`` by logical axis names (a no-op meshless).

    Under a mesh a DTensor is redistributed to the resolved placements;
    a plain tensor is returned unchanged."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    spec = logical_spec(x.shape, axes, mesh)
    # a redistribute even to the same placements: its backward places
    # the gradient as ``x`` was placed, so the constraint holds in the
    # backward too (as a sharding constraint does for its transpose)
    return x.redistribute(x.device_mesh, spec_placements(spec, mesh))


def pinned_view(t: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``t.view(shape)`` for a view that merges dims (heads x head dim ->
    features).  On a DTensor the view's gradient is placed as the view
    itself, so the backward's unflatten never meets a split of the merged
    dim that the heads do not divide."""
    out = t.view(tuple(shape))
    if not is_dtensor(out):
        return out
    return out.redistribute(out.device_mesh, out.placements)


def merge_last(t: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``t`` with its last ``n`` dims merged into one (``pinned_view``)."""
    return pinned_view(t.reshape(tuple(t.shape[:-n]) + (-1,)),
                       tuple(t.shape[:-n]) + (-1,))


def replicate_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t``, a tensor a layer builds itself (RoPE tables, masks,
    positions, index buffers), as an operand of ``ref``: replicated over
    ``ref``'s mesh when ``ref`` is a DTensor, else ``t`` unchanged.
    Every rank builds the same ``t``, so no data moves."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def to_local_replicated(x):
    """A DTensor as this rank's full copy (an all-gather where it is
    sharded, a reduction where it is partial); a plain tensor unchanged.
    The LGD pipeline's features and query go through it: its store and
    index are replicated mesh-wide."""
    if not is_dtensor(x):
        return x
    return x.full_tensor()


def unflatten_last(t: torch.Tensor, sizes: Sequence[int]) -> torch.Tensor:
    """``t`` with its last dim viewed as ``sizes`` (heads x head dim).  On
    a DTensor whose last dim is split over mesh dims that do not divide
    ``sizes[0]``, that split is gathered first: DTensor cannot unflatten
    an uneven split (4 heads of 16 over a 16-wide ``model`` axis)."""
    shape = tuple(t.shape[:-1]) + tuple(sizes)
    if not is_dtensor(t):
        return t.view(shape)
    from torch.distributed.tensor import Replicate, Shard
    last = t.dim() - 1
    split = [i for i, p in enumerate(t.placements)
             if isinstance(p, Shard) and p.dim == last]
    m = 1
    for i in split:
        m *= t.device_mesh.size(i)
    if m > 1 and sizes[0] % m:
        t = t.redistribute(t.device_mesh, [
            Replicate() if i in split else p
            for i, p in enumerate(t.placements)])
    return t.view(shape)


def elementwise(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` (elementwise) applied to ``x``; on a DTensor, to its local
    tensor, the result placed as ``x`` (a partial placement is reduced
    first).  For the ops DTensor has no sharding rule for (the backward
    of ``logsigmoid``)."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import DTensor, Replicate
    if any(p.is_partial() for p in x.placements):
        x = x.redistribute(x.device_mesh, [
            Replicate() if p.is_partial() else p for p in x.placements])
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, x.placements,
                              run_check=False)


def kv_heads_like_q(q: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
    """k or v (B, S, Hkv, D) split over heads where q (B, S, Hq, D) is.

    Where q's heads split over m ranks that do not split kv's Hkv heads
    (Hkv < m, as qwen3's 4 over a 16-wide ``model`` axis) and m is a
    multiple of Hkv, each KV head is repeated m / Hkv times and split:
    rank r gets KV head r·Hkv/m, the one its q heads [r·Hq/m, (r+1)·Hq/m)
    use, so attention stays local per head instead of gathering q.
    Otherwise (meshless, or the heads already split alike) ``kv``."""
    if not (is_dtensor(q) and is_dtensor(kv)):
        return kv
    from torch.distributed.tensor import Shard
    split = [i for i, (pq, pk) in enumerate(zip(q.placements,
                                                kv.placements))
             if pq.is_shard(2) and not pk.is_shard(2)]
    m = 1
    for i in split:
        m *= q.device_mesh.size(i)
    b, s, hkv, d = kv.shape
    if m == 1 or q.shape[2] % m or m % hkv or any(
            kv.placements[i].is_partial() for i in split):
        return kv
    rep = kv.unsqueeze(3).expand(b, s, hkv, m // hkv, d).reshape(b, s, m, d)
    return rep.redistribute(kv.device_mesh, [
        Shard(2) if i in split else p for i, p in enumerate(rep.placements)])


def local_map(fn, args: Sequence, dims: Sequence, out_dims: Sequence):
    """``fn`` on this rank's shards of ``args``, for a function that is
    local per batch row and per head (attention over heads, the mixers'
    scans, the LGD kernels' rows).

    ``dims[i]`` is ``(batch dim, head dim)`` of ``args[i]`` (None where it
    has none), ``out_dims`` the same for each output.  Meshless (no
    DTensor among ``args``) this is ``fn(*args)``.  Otherwise each mesh
    dim keeps the batch split where some argument is split on its batch
    dim there and every other argument with a batch dim is split the
    same way or whole and evenly divisible there (a whole one is cut
    locally: a zero initial state), else the head split by the same
    rule, else nothing: the
    arguments are redistributed to that (gathered where they disagree),
    ``fn`` runs on the local tensors, and its outputs come back as
    DTensors placed the same way.  No DTensor reaches ``fn``, so none
    reaches a kernel's ``data_ptr``."""
    ref = next((a for a in args if is_dtensor(a)), None)
    if ref is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = ref.device_mesh
    args = [replicate_like(a, ref) if isinstance(a, torch.Tensor) else a
            for a in args]
    kinds = []
    for i in range(mesh.ndim):
        kind = None
        size = mesh.size(i)
        for which in (0, 1):
            have = [(a.placements[i], d[which], a.shape[d[which]])
                    for a, d in zip(args, dims)
                    if is_dtensor(a) and d[which] is not None]
            split = [isinstance(p, Shard) and p.dim == dim
                     for p, dim, _ in have]
            # a whole argument follows only where the split divides it
            # evenly (GQA: q and k/v heads must split alike)
            if any(split) and all(
                    s_ or (p.is_replicate() and n % size == 0)
                    for s_, (p, _, n) in zip(split, have)):
                kind = which
                break
        kinds.append(kind)

    def placed(d):
        return [Shard(d[k]) if k is not None and d[k] is not None
                else Replicate() for k in kinds]

    local = [a.redistribute(mesh, placed(d)).to_local() if is_dtensor(a)
             else a for a, d in zip(args, dims)]
    out = fn(*local)
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    wrapped = tuple(
        o if not isinstance(o, torch.Tensor) else DTensor.from_local(
            o, mesh, placed(d), run_check=False)
        for o, d in zip(outs, out_dims))
    return wrapped[0] if single else wrapped


# the batch view of each mesh whose batch is split over ("pod", "data")
_BATCH_VIEWS: Dict[Any, Any] = {}


def with_batch_view(mesh):
    """``mesh``, made ready where its batch is split over ``("pod",
    "data")``: the two data axes flattened into one group, through which
    DTensor moves a tensor over both in one collective (a weight's FSDP
    gather, a reduction) where it would issue one a mesh dim, and its
    batch view, the ``("data", "model")`` mesh over the same ranks with
    the two data axes merged into one, pod-major (the order in which a
    ``Shard`` over pod and then data splits a dim: ``to_batch_view``).
    Both make process groups, so every rank calls this where it makes
    the mesh, and every step on the mesh sees the same groups."""
    if mesh.mesh_dim_names == ("pod", "data", "model"):
        from torch.distributed.device_mesh import DeviceMesh
        mesh["pod", "data"]._flatten()          # a group of this mesh's
        if mesh not in _BATCH_VIEWS:            # one view for equal meshes
            _BATCH_VIEWS[mesh] = DeviceMesh(
                mesh.device_type, mesh.mesh.reshape(-1, mesh.size(2)),
                mesh_dim_names=("data", "model"))
    return mesh


def to_batch_view(t: torch.Tensor) -> torch.Tensor:
    """A DTensor on a mesh that has a batch view (``with_batch_view``):
    the same local tensor on the view, its pod and data placements (which
    must agree) one data placement.  DTensor cannot keep a dim split over
    two mesh dims through an op that merges it with another dim (the
    expert products' reshape): it gathers the dim over both.  On the view
    one mesh dim splits it.  Any other tensor as it is."""
    view = _BATCH_VIEWS.get(t.device_mesh) if is_dtensor(t) else None
    if view is None:
        return t
    pod, data, model = t.placements
    if pod != data:
        raise ValueError(f"{t.placements}: the batch view needs the same "
                         "placement on pod and data")
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t.to_local(), view, [data, model],
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def from_batch_view(t: torch.Tensor, mesh) -> torch.Tensor:
    """``to_batch_view`` undone: ``t``, a DTensor on the batch view of
    ``mesh``, placed on ``mesh`` (its data placement on pod and data).
    Any other tensor as it is."""
    if not is_dtensor(t) or t.device_mesh == mesh:
        return t
    data, model = t.placements
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t.to_local(), mesh, [data, data, model],
                              run_check=False, shape=t.shape,
                              stride=t.stride())


# ---------------------------------------------------------------------------
# parameter placement
# ---------------------------------------------------------------------------

def _divisible(mesh, axes, dim: int):
    if axes is None or dim % _axis_size(mesh, axes) != 0:
        return None
    return axes


def reference_spec(path: str, shape: tuple, mesh) -> tuple:
    """The reference's ``param_spec`` rules, on its ``/``-joined tree
    path and the leaf's (stacked) shape: a tuple of mesh axes a dim.

      embed (V, d)            -> (model, data)
      lm_head (d, V)          -> (data, model)
      experts_* (E, d, ff)    -> (model, data, -)
      wq/wk/wv (d, H, Dh)     -> (data, model, -)
      wo (H, Dh, d)           -> (model, -, data)
      generic 2-D (din, dout) -> (data, model)
      norms / 1-D             -> replicated
    A path that starts with ``blocks`` is stacked over layers: its
    leading dim stays unsharded."""
    parts = path.split("/")
    leaf = parts[-1]
    data = _data_axes(mesh)
    stacked = parts[0] == "blocks"
    core = shape[1:] if stacked else shape
    if "norm" in parts or leaf in ("scale", "bias") or len(core) < 2:
        spec = [None] * len(core)
    elif leaf == "embed":
        spec = ["model", data]
    elif leaf == "lm_head":
        spec = [data, "model"]
    elif "experts" in leaf:
        spec = ["model", data] + [None] * (len(core) - 2)
    elif leaf in ("wq", "wk", "wv") and len(core) == 3:
        spec = [data, "model", None]
    elif leaf == "wo" and len(core) == 3:
        spec = ["model", None, data]
    elif len(core) == 2:
        spec = [data, "model"]
    else:
        spec = [None] * len(core)
    spec = [_divisible(mesh, s, d) for s, d in zip(spec, core)]
    if stacked:
        spec = [None] + spec
    return tuple(spec)


def reference_path(name: str, cfg) -> tuple:
    """(the reference's tree path of the port's parameter ``name``, its
    layer count R when the reference stacks it, else None)."""
    head, rest = name.split(".", 1)
    if head in ("embed_group", "shared"):
        return f"{head}/{rest.replace('.', '/')}", None
    i, dotted = rest.split(".", 1)
    j = int(i) % len(cfg.block_pattern)
    return (f"blocks/{j}/{dotted.replace('.', '/')}",
            cfg.n_layers // len(cfg.block_pattern))


def param_spec(name: str, shape: Sequence[int], mesh, cfg, *,
               slot: Optional[str] = None) -> tuple:
    """The spec of the port's leaf ``name`` (a parameter, or with
    ``slot`` the optimiser slot of that field, e.g. ``"m"`` or ``"vr"``)
    of ``shape`` under ``mesh``: the reference's spec of the leaf that
    holds it, with the stacked leaf's leading axis removed."""
    path, repeats = reference_path(name, cfg)
    if slot is not None:
        path = f".{slot}/{path}"
    shape = tuple(int(s) for s in shape)
    if repeats is None:
        return reference_spec(path, shape, mesh)
    return reference_spec(path, (repeats,) + shape, mesh)[1:]


def param_placements(name: str, shape, mesh, cfg, *,
                     slot: Optional[str] = None) -> list:
    return spec_placements(param_spec(name, shape, mesh, cfg, slot=slot),
                           mesh)


def tree_param_shardings(named: Dict[str, Any], mesh, cfg, *,
                         slot: Optional[str] = None) -> Dict[str, list]:
    """{name: placements} for a dict of the port's leaves keyed by
    parameter name (the parameters, or one optimiser slot's dict)."""
    return {k: param_placements(k, t.shape, mesh, cfg, slot=slot)
            for k, t in named.items()}


def batch_sharding(mesh) -> list:
    """Placements of a batch tensor: dim 0 over the data axes, the rest
    replicated."""
    return spec_placements((_data_axes(mesh),), mesh)


def shard_of(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of ``t``, which every rank holds whole (a seeded
    init, a checkpoint, a whole update): no data moves.  The shard is
    copied out once when it views a larger storage, so the whole tensor
    can be freed.  Where every split is even the shard is cut here as a
    view and copied once: ``distribute_tensor`` copies at each mesh dim,
    the whole tensor at a split over a mesh dim of size 1 (torch 2.11: a
    10.7 GB copy of an expert stack of llama4's on (1, 4))."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    local, coord = t, mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if local is None or not pl.is_shard():
            continue
        n = mesh.size(i)
        if local.shape[pl.dim] % n:
            local = None            # uneven: distribute_tensor's split
        elif n > 1:
            k = local.shape[pl.dim] // n
            local = local.narrow(pl.dim, coord[i] * k, k)
    if local is not None:
        if local is not t or not t.is_contiguous():
            local = local.clone(memory_format=torch.contiguous_format)
        return DTensor.from_local(
            local, mesh, placements, run_check=False, shape=t.shape,
            stride=torch.empty(t.shape, device="meta").stride())
    dt = distribute_tensor(t, mesh, placements, src_data_rank=None)
    local = dt._local_tensor
    if local.untyped_storage().nbytes() > local.numel() * \
            local.element_size():
        dt = DTensor.from_local(local.clone(), mesh, dt.placements,
                                run_check=False, shape=dt.shape,
                                stride=dt.stride())
    return dt


def _grad_placed_as(placements):
    """A gradient hook: the gradient placed as its parameter."""
    def hook(g):
        if tuple(g.placements) == tuple(placements):
            return g
        return g.redistribute(g.device_mesh, placements)
    return hook


@torch.no_grad()
def distribute_model(lm, mesh):
    """Place an ``LM`` onto ``mesh`` in place: every ``nn.Parameter``
    becomes a DTensor parameter with ``param_spec``'s placements (the
    shared block's once).  Each whole leaf is freed as its shard replaces
    it, so placing a model drawn whole holds one leaf's shard beyond it.

    On a mesh of more than one rank each parameter's gradient is placed
    as the parameter as autograd makes it (a hook), as the reference's
    gradient of a sharded leaf is sharded as the leaf: an op that leaves
    the weight in place and moves its other operand instead (the MoE's
    expert products slice the expert buffer along the weights'
    data-split ``d``) would otherwise leave a partial sum of the WHOLE
    leaf on every data rank until the optimiser step.  A rank of a
    1 x 1 mesh holds every leaf whole anyway.  On a card the freed whole leaves' blocks are
    released (``empty_cache``): left in PyTorch's cache they are out of
    reach of the buffers NCCL allocates on a collective's first use.
    Returns ``lm``."""
    if mesh is None:
        return lm
    for name in [n for n, _ in lm.named_parameters()]:
        mod_name, leaf = name.rsplit(".", 1)
        mod = lm.get_submodule(mod_name)
        p = getattr(mod, leaf)
        if is_dtensor(p):
            continue
        dt = shard_of(p.detach(), mesh,
                      param_placements(name, p.shape, mesh, lm.cfg))
        new = torch.nn.Parameter(dt, requires_grad=p.requires_grad)
        del p           # the module's reference goes with the setattr
        if new.requires_grad and mesh.size() > 1:
            new.register_hook(_grad_placed_as(dt.placements))
        setattr(mod, leaf, new)
    if lm.device.type == "cuda":
        torch.cuda.empty_cache()
    return lm


def distribute_state(state, mesh, cfg):
    """Place an optimiser state over the port's named leaves onto
    ``mesh``: every tensor slot by ``tree_param_shardings`` under its
    field's name (``.m/...``, ``.vr/...``), as the reference places
    ``opt_shapes``; the step stays replicated.  ``Adam8bit``'s
    ``QTensor`` slots stay plain and whole on every rank: a 256-value
    block of the flattened leaf does not follow a shard of it, so the
    optimiser gathers such a leaf's gradient around them (ROADMAP.md
    queue 3)."""
    if mesh is None:
        return state
    from torch.distributed.tensor import Replicate
    out = {"step": shard_of(state.step, mesh,
                            [Replicate()] * len(mesh_axes(mesh)))}
    for f in state._fields[1:]:
        slots = getattr(state, f)
        out[f] = None if slots is None else {
            k: t if not isinstance(t, torch.Tensor) or is_dtensor(t)
            else shard_of(t, mesh,
                          param_placements(k, t.shape, mesh, cfg, slot=f))
            for k, t in slots.items()}
    return state._replace(**out)


def distribute_cache(cache, like, placements=None):
    """A model's cache (``LM.init_cache``'s list of per-layer dicts) on
    the mesh of ``like`` (a DTensor parameter; a plain tensor leaves the
    cache as it is).  ``placements`` mirrors the cache's structure (the
    dry run's ``cache_shardings``); by default each tensor splits its
    batch dim over the data axes where they divide it."""
    if not is_dtensor(like):
        return cache
    mesh = like.device_mesh

    def place(t, pl):
        if pl is None:
            pl = spec_placements(
                (_divisible(mesh, _data_axes(mesh), t.shape[0]),), mesh)
        return shard_of(t, mesh, pl)

    def walk(c, pl):
        if isinstance(c, torch.Tensor):
            return place(c, pl)
        if isinstance(c, dict):
            return {k: walk(v, None if pl is None else pl[k])
                    for k, v in c.items()}
        if isinstance(c, (list, tuple)):
            out = [walk(v, None if pl is None else pl[i])
                   for i, v in enumerate(c)]
            return type(c)(out) if isinstance(c, tuple) else out
        return c

    return walk(cache, placements)


def host_local_mesh(axis_names=("data", "model")):
    """The mesh over THIS host's ranks, (n, 1): the surviving mesh of a
    multi-process deployment after peers are gone.  None when this host
    has fewer than two local devices (callers pass ``mesh=None``
    downstream: the unsharded path), as in the reference."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n_local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    if n_local < 2 or not dist.is_initialized():
        return None
    local = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
    if local < 2:
        return None
    first = dist.get_rank() - dist.get_rank() % local
    ranks = torch.arange(first, first + local).reshape(local, 1)
    return DeviceMesh("cuda", ranks, mesh_dim_names=tuple(axis_names))


# ---------------------------------------------------------------------------
# device-resident example stores (LGD shard-by-example)
# ---------------------------------------------------------------------------

def shard_store_device(device, shard_id: int, n_shards: int, *,
                       mesh=None) -> torch.device:
    """Placement of corpus shard ``shard_id``'s store: the rank's device.
    Meshless that is the pipeline's one device; under a mesh the store is
    replicated mesh-wide, every rank holding it on its own device, as the
    reference commits it (``NamedSharding(mesh, P())``): the feature and
    query hooks read the model, which spans the mesh."""
    if not (0 <= shard_id < n_shards):
        raise ValueError(f"shard_id {shard_id} not in [0, {n_shards})")
    del mesh
    return resolve_device(device)


def _data_index(mesh) -> int:
    """This rank's position along the data axes (pod-major)."""
    names = list(mesh_axes(mesh))
    coord = mesh.get_coordinate()
    idx = 0
    for a in (("pod", "data") if "pod" in names else ("data",)):
        i = names.index(a)
        idx = idx * mesh.size(i) + coord[i]
    return idx


def compose_sharded_batch(parts: Sequence[torch.Tensor], device, *,
                          mesh=None) -> torch.Tensor:
    """The global batch from equal-length per-shard parts (dim 0), in
    shard order: no host round trip.

    Meshless, their concatenation on ``device``.  Under a mesh, a DTensor
    of that concatenation under ``batch_sharding(mesh)``, built from
    this rank's local rows: a part that is exactly this rank's slice is
    adopted as it is (``DTensor.from_local``, no copy); otherwise the
    slice is cut from the parts it spans (the shard count differs from
    the data-parallel degree)."""
    dev = resolve_device(device)
    if mesh is None:
        return torch.cat([p.to(dev) for p in parts])
    from torch.distributed.tensor import DTensor
    rows = sum(p.shape[0] for p in parts)
    dn = data_axis_size(mesh)
    if rows % dn:
        raise ValueError(f"a batch of {rows} rows does not divide over the "
                         f"data-parallel degree {dn}")
    per, local = rows // len(parts), rows // dn
    start = _data_index(mesh) * local
    stop = start + local
    pieces, s = [], start // per
    while start < stop:
        take = min(stop, (s + 1) * per) - start
        pieces.append(parts[s][start - s * per:start - s * per + take])
        start, s = start + take, s + 1
    mine = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
    return DTensor.from_local(mine.to(dev), mesh, batch_sharding(mesh),
                              run_check=False)
