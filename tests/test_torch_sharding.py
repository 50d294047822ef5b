"""The port's placement rules against the JAX package's, with no devices.

The reference's sharding module touches only ``mesh.shape`` and
``mesh.axis_names``, and so does the port's (``mesh_axes``), so both
take the same stub meshes of 16 x 16 and 2 x 16 x 16:

* every parameter of the ten archs' FULL configs (the port's ``LM`` on
  the ``meta`` device; the reference's leaves from ``jax.eval_shape``):
  the port's spec equals the reference's ``param_spec`` of the stacked
  leaf with its scan axis removed (which the reference leaves
  unsharded), the embed group's and the shared block's unchanged;
* the same for ``pick_optimizer``'s Adam and Adafactor state trees,
  whose reference paths start with the slot's field (``.m/...``), so the
  reference places a slot's layer axis as a feature axis (its split, on
  the data axes where they divide the layer count, has no per-layer
  counterpart);
* ``logical``'s resolution, indivisible dims and ``"batch"`` ->
  ``("pod", "data")`` included;
* ``batch_shardings`` and ``cache_shardings`` on every arch x shape,
  the reference's stacked cache leaves mapped onto the port's per-layer
  cache;
* ``SHAPES``, ``apply_vocab``, ``shape_applicable``, ``active_params``
  and ``model_flops`` for every arch x shape (FLOPs to rtol 1e-12).

Specs compare exactly: they are tuples of axis names.
"""

import os
import types
from functools import partial

import jax
import numpy as np
import pytest
import torch

import repro.dist.sharding as JS
from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro.launch import roofline as jroofline
from repro.models import init_params as j_init_params
from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.dist import sharding as S
from repro_torch.launch import dryrun, roofline
from repro_torch.models import LM
from repro_torch.optim import Adafactor, Adam


def _reference_dryrun():
    """``repro.launch.dryrun`` without its import-time XLA_FLAGS (512
    host devices), which would reach any later JAX backend in this
    process."""
    before = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as jd
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return jd


JD = _reference_dryrun()


class Stub:
    """A mesh as both packages' rules see it."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {"16x16": Stub({"data": 16, "model": 16}),
          "2x16x16": Stub({"pod": 2, "data": 16, "model": 16})}
ARCHS = configs.all_archs()


def _spec(p) -> tuple:
    """A PartitionSpec as the port writes specs: a tuple, one entry a
    dim."""
    return tuple(p)


def _ref_leaves(tree) -> dict:
    return {JS._path_str(kp): x for kp, x in
            jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module", params=ARCHS)
def arch_trees(request):
    arch = request.param
    jcfg = jconfigs.get(arch)
    ref = jax.eval_shape(partial(j_init_params, cfg=jcfg),
                         jax.random.PRNGKey(0))
    cfg = configs.get(arch)
    lm = LM(cfg, device="meta")
    return arch, cfg, lm, ref


def _held(cfg, name, port_shape, ref_path, ref_shape, mesh, slot=None):
    """The port's spec of leaf ``name`` against the reference's of the
    leaf at ``ref_path``."""
    got = S.param_spec(name, port_shape, mesh, cfg, slot=slot)
    want = _spec(JS.param_spec(ref_path, tuple(ref_shape), mesh))
    _, repeats = S.reference_path(name, cfg)
    if repeats is None or tuple(ref_shape) == tuple(port_shape):
        assert got == want, (name, slot, got, want)
    elif tuple(ref_shape) == (repeats,) + tuple(port_shape):
        # the reference keeps a parameter's scan axis unsharded; an
        # optimiser slot's stacked leaf is placed as if that axis were a
        # feature axis (its path starts with ".m/", not "blocks/"), and a
        # split of it has no per-layer counterpart
        if slot is None:
            assert want[0] is None, (name, slot, want)
        assert got == want[1:], (name, slot, got, want)
    else:
        # a 1-D layer parameter's factored Adafactor slots: the reference
        # factors the stacked (R, n) leaf, the port keeps the (n,) moment;
        # both are replicated
        assert all(a is None for a in got) and \
            all(a is None for a in want), (name, slot, got, want)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_specs_match_reference(arch_trees, mesh_name):
    arch, cfg, lm, ref = arch_trees
    mesh = MESHES[mesh_name]
    leaves = _ref_leaves(ref)
    named = dict(lm.named_parameters())
    assert len(named) >= len(leaves)
    for name, p in named.items():
        path, repeats = S.reference_path(name, cfg)
        assert path in leaves, (name, path)
        ref_shape = tuple(leaves[path].shape)
        want_shape = tuple(p.shape) if repeats is None \
            else (repeats,) + tuple(p.shape)
        assert ref_shape == want_shape, (name, ref_shape, want_shape)
        _held(cfg, name, p.shape, path, ref_shape, mesh)
    # placements: Shard(d) on the mesh axes a spec names for dim d
    for name, p in named.items():
        spec = S.param_spec(name, p.shape, mesh, cfg)
        pl = S.param_placements(name, p.shape, mesh, cfg)
        names = list(mesh.axis_names)
        for d, axes in enumerate(spec):
            for a in ((axes,) if isinstance(axes, str) else axes or ()):
                assert pl[names.index(a)].dim == d


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_optimizer_state_specs_match_reference(arch_trees, mesh_name):
    arch, cfg, lm, ref = arch_trees
    mesh = MESHES[mesh_name]
    jopt = JD.pick_optimizer(arch)
    opt = dryrun.pick_optimizer(arch)
    assert type(opt).__name__ == type(jopt).__name__
    ref_state = _ref_leaves(jax.eval_shape(jopt.init, ref))
    named = {k: p for k, p in lm.named_parameters()}
    state = opt.init({k: torch.empty(p.shape, device="meta")
                      for k, p in named.items()})
    fields = ("m", "v") if isinstance(opt, Adam) else ("vr", "vc")
    assert isinstance(opt, (Adam, Adafactor))
    assert ".step" in ref_state
    assert _spec(JS.param_spec(".step", (), mesh)) == ()
    for f in fields:
        for name, t in getattr(state, f).items():
            path, _ = S.reference_path(name, cfg)
            ref_path = f".{f}/{path}"
            assert ref_path in ref_state, ref_path
            _held(cfg, name, t.shape, ref_path, ref_state[ref_path].shape,
                  mesh, slot=f)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape, axes", [
    ((32, 4096, 3072), ("batch", None, None)),
    ((32, 4096, 3072), ("batch", "seq", None)),
    ((32, 4096, 24, 128), ("batch", None, "heads", None)),
    ((32, 4096, 32, 128), ("batch", None, "heads", None)),
    ((8, 4096, 8192), ("batch", None, "ff")),
    ((8, 16, 200064), ("batch", None, "vocab")),
    ((8, 16, 131072), ("batch", None, "vocab")),
    ((64, 128, 5, 4096), ("batch", "experts", None, None)),
    ((1, 7, 3), ("batch", "seq", "ff")),
])
def test_logical_resolution_matches_reference(monkeypatch, mesh_name, shape,
                                              axes):
    mesh = MESHES[mesh_name]
    seen = {}
    fake_jax = types.SimpleNamespace(lax=types.SimpleNamespace(
        with_sharding_constraint=lambda x, s: seen.setdefault("spec", s)))
    monkeypatch.setattr(JS, "jax", fake_jax)
    monkeypatch.setattr(JS, "NamedSharding", lambda m, spec: spec)
    with JS.use_mesh(mesh):
        JS.logical(np.zeros(shape, np.int8), *axes)
    want = _spec(seen["spec"])
    want = want + (None,) * (len(shape) - len(want))
    assert S.logical_spec(shape, axes, mesh) == want
    if mesh_name == "2x16x16" and shape[0] % 32 == 0 and axes[0] == "batch":
        assert want[0] == ("pod", "data")


def test_logical_is_a_noop_meshless():
    x = torch.arange(6.0).reshape(2, 3)
    assert S.current_mesh() is None
    assert S.logical(x, "batch", "ff") is x
    with S.use_mesh(MESHES["16x16"]):
        # a plain tensor is this rank's own: it passes through
        assert S.logical(x, "batch", "ff") is x


def test_spec_placements_split_order():
    mesh = MESHES["2x16x16"]
    pl = S.spec_placements((("pod", "data"), "model", None), mesh)
    assert [p.dim for p in pl] == [0, 0, 1]
    assert S.batch_sharding(mesh)[2].is_replicate()
    assert S.data_axis_size(mesh) == 32
    assert S.data_axis_size(MESHES["16x16"]) == 16


def _map_cache(cfg, ref_specs, port_specs):
    """Pairs (port leaf spec, reference stacked leaf spec) of one cache,
    port layer i against pattern position i mod P."""
    p = len(cfg.block_pattern)
    for i, entry in enumerate(port_specs):
        ref = ref_specs[i % p]
        ref = ref.get("attn", ref)
        for key, v in entry.items():
            r = ref[key]
            if isinstance(v, tuple) and not hasattr(v, "dtype"):
                yield from zip(v, r)
            else:
                yield v, r


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_shardings_match_reference(monkeypatch, arch,
                                                   mesh_name):
    mesh = MESHES[mesh_name]
    monkeypatch.setattr(JD, "NamedSharding", lambda m, spec: spec)
    jcfg, cfg = jconfigs.get(arch), configs.get(arch)
    for name, jsh in jshapes.SHAPES.items():
        sh = shapes.SHAPES[name]
        jc, c = jshapes.apply_vocab(jcfg, jsh), shapes.apply_vocab(cfg, sh)
        jb = jshapes.batch_specs(jc, jsh)
        pb = shapes.batch_specs(c, sh)
        assert set(jb) == set(pb)
        ref_b = JD.batch_shardings(jb, mesh)
        got_b = dryrun.batch_shardings(pb, mesh)
        for k in jb:
            assert tuple(jb[k].shape) == pb[k].shape
            want = S.spec_placements(_spec(ref_b[k]), mesh)
            assert got_b[k] == want, (k, got_b[k], want)
        if sh.kind == "train":
            continue
        jcs = jshapes.cache_specs(jc, jsh)
        pcs = shapes.cache_specs(c, sh)
        assert len(pcs) == c.n_layers
        ref_c = JD.cache_shardings(jcs, jc, mesh)
        got_c = dryrun.cache_shardings(pcs, c, mesh)
        shapes_pairs = list(_map_cache(c, jcs, pcs))
        spec_pairs = list(_map_cache(c, ref_c, got_c))
        assert len(shapes_pairs) == len(spec_pairs) > 0
        for (ps, rs), (pp, rspec) in zip(shapes_pairs, spec_pairs):
            assert tuple(rs.shape) == (c.repeats,) + ps.shape
            rspec = _spec(rspec) + (None,) * (len(rs.shape) - len(rspec))
            assert rspec[0] is None
            assert pp == S.spec_placements(rspec[1:], mesh)


def test_shapes_table_matches_reference():
    assert list(shapes.SHAPES) == list(jshapes.SHAPES)
    for name, j in jshapes.SHAPES.items():
        p = shapes.SHAPES[name]
        assert (p.name, p.seq_len, p.global_batch, p.kind, p.vocab) == \
            (j.name, j.seq_len, j.global_batch, j.kind, j.vocab)


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_rules_and_roofline_match_reference(arch):
    jcfg, cfg = jconfigs.get(arch), configs.get(arch)
    assert roofline.active_params(cfg) == jroofline.active_params(jcfg)
    for name, jsh in jshapes.SHAPES.items():
        sh = shapes.SHAPES[name]
        assert shapes.shape_applicable(cfg, sh) == \
            jshapes.shape_applicable(jcfg, jsh)
        jc, c = jshapes.apply_vocab(jcfg, jsh), shapes.apply_vocab(cfg, sh)
        assert c.vocab == jc.vocab
        assert (c is cfg) == (jc is jcfg)
        assert roofline.active_params(c) == jroofline.active_params(jc)
        for n_dev in (256, 512):
            np.testing.assert_allclose(
                roofline.model_flops(c, sh, n_dev),
                jroofline.model_flops(jc, jsh, n_dev), rtol=1e-12)


def test_roofline_constants_are_the_h100s():
    assert roofline.PEAK_FLOPS == 989e12 and roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 50e9 and roofline.NVLINK_BW == 450e9
    rec = {"arch": "phi4_mini_3_8b", "shape": "train_4k", "n_devices": 256,
           "mesh": "16x16",
           "config": "phi4-mini-3.8b", "flops_per_device": 989e12,
           "bytes_per_device": 3.35e12, "collectives": {"all-reduce": 25e9}}
    t = roofline.roofline_terms(rec)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert t["collective_s"] == pytest.approx(1.0)
    assert "phi4_mini_3_8b" in roofline.build_table([rec])
