"""The dry run on the fake production mesh, on the CPU.

``launch.dryrun.run_cell`` builds each cell as rank 0 of a ``fake``
group of 256 ranks (16 x 16) under ``FakeTensorMode``.  Here every
arch's SMOKE config runs the train kind on a cut-down train shape
(global batch 256, so the 16 data ranks divide it; 16 tokens a row,
for the tier-1 budget: ``train_4k``'s 4,096 take ~75 s a SMOKE cell),
and the SMOKE phi4-mini runs ``prefill_32k`` and ``decode_32k`` as
they stand.  Checks:

* each cell ends, or is skipped with ``shape_applicable``'s reason;
* FLOPs a rank within a band of the roofline's ``model_flops``: at
  least the useful 6·N·D (2·N·D) split evenly over the 256 ranks, at
  most that work replicated over the 16-wide model axis (the SMOKE
  widths do not divide it) times 4/3 for the remat's second forward,
  plus, for the prefill, the masked S² attention that 2·N·D leaves out
  (4·B·S²·H·Dh a layer, per rank);
* the parameter and optimiser bytes a rank equal the sum of their local
  shards, computed here from ``param_spec`` and the mesh's sizes (the
  gradients, as DTensor's backward places them, hold at least as many);
* a train cell reports a non-zero all-reduce or reduce-scatter; the
  decode over the sequence-sharded cache all-gathers it in
  ``gqa_decode``;
* the collectives DTensor issues inside an op's sharding propagation
  are counted: every SMOKE train cell's counts equal those of
  ``tools/mesh_check.py``'s ``collectives()`` on the same step;
* the peak live bytes are a true maximum: a temporary that lives for a
  few ops is in it, and a SMOKE arch's peak does not fall when a layer
  is added;
* the FLOPs a rank exactly: on configs whose every width divides the
  16-wide axes (d_model 256, 16 heads and 16 KV heads of 16, d_ff 512,
  vocab 512, 16 experts of 256 for the MoE), the work splits evenly, so
  rank 0's count equals ``FlopCounterMode``'s total of the same step
  run meshless, over 256 (to rel 1e-9: both are sums of the same
  integer formulas).  The Mamba-2 archs are left out: their scan does
  not split over ``model`` (ROADMAP.md queue 3).
"""

import importlib.util
import inspect
import math
import os

import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, ShapeSpec, shape_applicable
from repro_torch.dist import sharding as S
from repro_torch.launch import dryrun, roofline

ARCHS = configs.all_archs()
TRAIN_CUT = ShapeSpec("train_4k_cut", 16, 256, "train")


class Stub:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESH = Stub({"data": 16, "model": 16})


@pytest.fixture(scope="module", autouse=True)
def fake_group():
    yield
    # later tests in this process may build their own groups
    if dist.is_initialized():
        dist.destroy_process_group()


def _local_numel(shape, spec) -> int:
    n = 1
    for d, axes in zip(shape, spec):
        if axes is not None:
            d //= S._axis_size(MESH, axes)
        n *= d
    return n


def _expected_bytes(arch, cfg):
    """A rank's bytes of parameters, of gradients (each placed as its
    parameter; an embed_stub arch's token table, which the loss does not
    reach, has none) and of optimiser state."""
    from repro_torch.models import LM
    lm = LM(cfg, device="meta")
    named = dict(lm.named_parameters())
    local = {k: _local_numel(p.shape, S.param_spec(k, p.shape, MESH, cfg))
             * p.element_size() for k, p in named.items()}
    params = sum(local.values())
    grads = params - (local["embed_group.embed"]
                      if cfg.frontend == "embed_stub" else 0)
    opt = dryrun.pick_optimizer(arch)
    state = opt.init({k: torch.empty(p.shape, device="meta")
                      for k, p in named.items()})
    opt_bytes = state.step.element_size()
    for f in state._fields[1:]:
        for k, t in getattr(state, f).items():
            opt_bytes += _local_numel(
                t.shape, S.param_spec(k, t.shape, MESH, cfg, slot=f)) \
                * t.element_size()
    return params, grads, opt_bytes


def _mesh_check():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "mesh_check.py")
    spec = importlib.util.spec_from_file_location("mesh_check", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CELLS: dict = {}
_TOOL_COUNTS: dict = {}     # arch -> mesh_check's counter's summary()


def _counted_cell(arch, cfg, multi_pod=False, shapes=None):
    """(the cut train cell of ``cfg``, the summary of
    ``tools/mesh_check.py``'s collective counter run beneath the dry
    run's on the same step); with ``shapes`` (a set), the shape of every
    local tensor the step allocates is added to it (``_recording``)."""
    tool = _mesh_check().collectives()
    counter = dryrun.RankCounter

    class Both(counter if shapes is None else _recording(shapes)):
        def __enter__(self):
            tool.__enter__()
            return super().__enter__()

        def __exit__(self, *exc):
            super().__exit__(*exc)
            tool.__exit__(*exc)

    dryrun.RankCounter = Both
    try:
        cell = dryrun.run_cell(arch, TRAIN_CUT, cfg_override=cfg,
                               multi_pod=multi_pod, verbose=False)
    finally:
        dryrun.RankCounter = counter
    return cell, tool.summary()


def _train_cell(arch):
    """The SMOKE train cell (``_counted_cell``), once a module."""
    if arch not in _CELLS:
        _CELLS[arch], _TOOL_COUNTS[arch] = _counted_cell(
            arch, configs.get_smoke(arch))
    return _CELLS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_train_cell(arch):
    cfg = configs.get_smoke(arch)
    r = _train_cell(arch)
    assert "skipped" not in r and r["mesh"] == "16x16"
    assert r["n_devices"] == 256 and r["output_shape"] == ()
    mf = roofline.model_flops(cfg, TRAIN_CUT, 256)
    assert mf <= r["flops_per_device"] <= mf * 16 * 4 / 3, \
        r["flops_per_device"] / mf
    params, grads, opt_bytes = _expected_bytes(arch, cfg)
    assert r["param_bytes_per_device"] == params
    assert r["opt_bytes_per_device"] == opt_bytes
    assert r["grad_bytes_per_device"] == grads
    assert r["collectives"].get("all-reduce", 0) + \
        r["collectives"].get("reduce-scatter", 0) > 0
    assert r["peak_bytes_per_device"] >= params + opt_bytes
    assert r["fits_80GB"] and r["bytes_per_device"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_counts_the_collectives_dtensor_issues_inside_ops(arch):
    """The dry run's counts are those of the counter that declines
    DTensor ops (``mesh_check.collectives()``), by kind and by call site:
    the redistributions inside an op's sharding propagation included.
    SMOKE qwen3-moe: 120 all-gathers, 65 all-reduces, 21 reduce-scatters
    (133 / 70 / 25 before): the embedding is vocab-parallel (one gather
    of the rank's window where the whole table was gathered, and an
    all-reduce of the looked-up rows across ``model``), and each expert
    product gathers its weight over ``data`` where DTensor moved the
    dispatch buffer and reduced a partial product (``moe._weight_for``):
    3.23 MB of collectives where there were 4.13."""
    r = _train_cell(arch)
    tool = _TOOL_COUNTS[arch]
    assert r["collective_counts"] == tool["count"]
    assert r["collectives"] == tool["bytes"]
    assert dict(r["top_collectives"]) == dict(
        sorted(tool["by_site"].items(), key=lambda kv: -kv[1])[:8])
    if arch == "qwen3_moe_235b_a22b":
        assert r["collective_counts"] == {
            "all-gather": 120, "all-reduce": 65, "reduce-scatter": 21}


def test_peak_catches_a_short_lived_temporary():
    """The peak is taken at every allocation, so a temporary freed a few
    ops later is in it; a freed storage leaves the live bytes."""
    with dryrun.RankCounter() as c:
        x = torch.zeros(1000)                   # 4,000 B, kept
        y = torch.ones(100_000)                 # 400,000 B, a temporary
        z = y.sum()                             # 4 B
        del y
        for _ in range(40):
            x = x + 1
    assert c.peak_bytes == 4000 + 400_000 + 4
    assert c._live_bytes == 4000 + 4
    assert float(z) == 100_000 and float(x[0]) == 40


def test_peak_does_not_fall_with_depth():
    """One layer more keeps one more block input for the remat's
    backward: the peak a rank rises."""
    cfg = configs.get_smoke("phi4_mini_3_8b")
    one = dryrun.run_cell("phi4_mini_3_8b", TRAIN_CUT,
                          cfg_override=cfg.with_(n_layers=1),
                          verbose=False)
    two = _train_cell("phi4_mini_3_8b")
    assert cfg.n_layers == 2
    assert two["peak_bytes_per_device"] > one["peak_bytes_per_device"]


def test_phi4_prefill_cell():
    cfg = configs.get_smoke("phi4_mini_3_8b")
    sh = SHAPES["prefill_32k"]
    r = dryrun.run_cell("phi4_mini_3_8b", "prefill_32k", cfg_override=cfg,
                        verbose=False)
    assert r["output_shape"] == (sh.global_batch, sh.seq_len, cfg.d_model)
    mf = roofline.model_flops(cfg, sh, 256)
    attn = (4.0 * sh.global_batch * sh.seq_len ** 2 * cfg.n_heads
            * cfg.d_head * cfg.n_layers / 256)
    assert mf <= r["flops_per_device"] <= (mf + attn) * 16
    assert r["collectives"]["all-gather"] > 0


def test_phi4_decode_cell_gathers_the_sequence_sharded_cache():
    cfg = configs.get_smoke("phi4_mini_3_8b")
    sh = SHAPES["decode_32k"]
    r = dryrun.run_cell("phi4_mini_3_8b", "decode_32k", cfg_override=cfg,
                        verbose=False)
    assert r["output_shape"] == (sh.global_batch, 1, cfg.vocab)
    mf = roofline.model_flops(cfg, sh, 256)
    assert mf <= r["flops_per_device"] <= mf * 16
    site, nbytes = r["top_collectives"][0]
    assert "gqa_decode" in site
    # the whole K and V caches of each layer for this rank's 8 rows, bf16
    # or f32 as the config: S_max x Hkv x Dh a row
    rows = sh.global_batch // 16
    itemsize = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    assert nbytes == 2 * cfg.n_layers * rows * sh.seq_len * \
        cfg.n_kv_heads * cfg.d_head * itemsize


def test_long_context_cell_is_skipped_for_attention_archs():
    cfg = configs.get_smoke("phi4_mini_3_8b")
    r = dryrun.run_cell("phi4_mini_3_8b", "long_500k", cfg_override=cfg,
                        verbose=False)
    assert r["skipped"] == shape_applicable(cfg, SHAPES["long_500k"])
    assert shape_applicable(configs.get_smoke("zamba2_1_2b"),
                            SHAPES["long_500k"]) is None


def test_roofline_table_over_cells():
    r = {**_train_cell("granite_3_8b"), "shape": "train_4k"}
    # (the roofline keys its model FLOPs on SHAPES)
    t = roofline.roofline_terms(r)
    assert t["dominant"] in ("compute", "memory", "collective")
    assert math.isfinite(t["step_time_lower_bound_s"])
    table = roofline.build_table([r, {"arch": "x", "shape": "long_500k",
                                      "skipped": "reason"}])
    assert "granite_3_8b" in table and "SKIPPED" in table


# widths that the 16-wide data and model axes divide
EVEN = dict(d_model=256, n_heads=16, n_kv_heads=16, d_head=16, d_ff=512,
            vocab=512)


@pytest.mark.parametrize("arch,shape", [
    ("phi4_mini_3_8b", TRAIN_CUT),
    ("phi4_mini_3_8b", ShapeSpec("prefill_cut", 16, 64, "prefill")),
    ("granite_3_8b", TRAIN_CUT),
    ("qwen3_moe_235b_a22b", TRAIN_CUT),
])
def test_flops_per_rank_equal_an_even_split(arch, shape):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.shapes import batch_specs, cache_specs
    from repro_torch.models import LM

    cfg = configs.get_smoke(arch).with_(**EVEN)
    if cfg.moe_experts:
        cfg = cfg.with_(moe_experts=16, moe_d_ff=256)
    r = dryrun.run_cell(arch, shape, cfg_override=cfg, verbose=False)
    with FakeTensorMode(allow_non_fake_inputs=True):
        model = LM(cfg, device="cpu")
        batch = {k: torch.zeros(s.shape, dtype=s.dtype)
                 for k, s in batch_specs(cfg, shape).items()}
        with FlopCounterMode(display=False) as fc:
            if shape.kind == "train":
                model.loss(batch).backward()
            else:
                cache = [dryrun._walk_zeros(c)
                         for c in cache_specs(cfg, shape)]
                with torch.no_grad():
                    model.prefill(batch, cache)
    assert r["flops_per_device"] == pytest.approx(
        fc.get_total_flops() / 256, rel=1e-9)


# -- the placements the dry run found over a shard (each fails on the tree
# before they were repaired) ---------------------------------------------------

def _recording(shapes: set):
    """``dryrun.RankCounter`` that also records the shape of every local
    tensor the step allocates."""
    class Recording(dryrun.RankCounter):
        def _record_local(self, func, out):
            if not self._meta:
                shapes.update(tuple(t.shape) for t in dryrun._tensors(out))
            return super()._record_local(func, out)
    return Recording


_ODD: dict = {}


def _odd_vocab_cell():
    """SMOKE granite with a vocab the 16-wide model axis does not divide
    (granite's own 49,155 does not either): the loss chunk's logits are
    whole over the vocab on each rank."""
    if not _ODD:
        shapes: set = set()
        cfg = configs.get_smoke("granite_3_8b").with_(vocab=130)
        _ODD.update(cfg=cfg, shapes=shapes, cell=_counted_cell(
            "granite_3_8b", cfg, shapes=shapes)[0])
    return _ODD


def test_loss_of_a_whole_vocab_runs_on_the_ranks_rows():
    """The gather's backward on the DTensor logits built zeros of the
    chunk's GLOBAL (B, c, V) shape, which DTensor replicates: at granite's
    ``train_4k`` 51.5 GB a rank where its rows' chunk is 3.22.  Now no
    tensor of that shape exists, and the odd vocab costs the peak no more
    than one local chunk over the vocab-parallel SMOKE cell's."""
    odd = _odd_vocab_cell()
    c, v = odd["cfg"].loss_chunk, odd["cfg"].vocab
    rows = TRAIN_CUT.global_batch // 16
    assert (rows, c, v) in odd["shapes"]
    assert (TRAIN_CUT.global_batch, c, v) not in odd["shapes"]
    base = _train_cell("granite_3_8b")
    assert odd["cell"]["peak_bytes_per_device"] - \
        base["peak_bytes_per_device"] <= rows * c * v * 4


def test_rope_tables_are_not_the_whole_batchs():
    """The prompt's positions broadcast over the batch: no rank builds
    the RoPE tables of the global batch's rows (phi4-mini's ``train_4k``:
    three (256, 4,096, 64) f32 tensors, 0.8 GB, on every rank)."""
    odd = _odd_vocab_cell()
    half = odd["cfg"].d_head // 2
    assert (1, TRAIN_CUT.seq_len, 1, half) in odd["shapes"]
    assert (TRAIN_CUT.global_batch, TRAIN_CUT.seq_len, 1, half) \
        not in odd["shapes"]


def test_serve_peak_holds_no_whole_table():
    """A table that dominates (SMOKE phi4-mini, vocab 2^20: 268 MB in
    f32 whole): the lookup gathered the whole table on every rank, three
    copies live at once.  Now a rank holds its (V / 16, d) window over
    the data axis, beside what the decode step holds anyway."""
    cfg = configs.get_smoke("phi4_mini_3_8b")
    wide = cfg.with_(vocab=1 << 20)
    base = dryrun.run_cell("phi4_mini_3_8b", "decode_32k", cfg_override=cfg,
                           verbose=False)
    r = dryrun.run_cell("phi4_mini_3_8b", "decode_32k", cfg_override=wide,
                        verbose=False)
    table = wide.vocab * wide.d_model * 4
    assert r["peak_bytes_per_device"] < table
    assert r["peak_bytes_per_device"] - base["peak_bytes_per_device"] <= \
        table // 16


def _shapes_of(cfg, fn):
    """The local shapes ``fn(model, mesh)`` allocates on rank 0 of a fake
    16 x 16 group under ``FakeTensorMode``, ``model`` an ``LM`` of
    ``cfg`` placed on that mesh before."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import init_fake_group, make_production_mesh
    from repro_torch.models import LM
    init_fake_group(256)
    mesh = make_production_mesh(device_type="cpu")
    shapes: set = set()
    with FakeTensorMode(allow_non_fake_inputs=True), S.use_mesh(mesh):
        model = S.distribute_model(LM(cfg, device="cpu"), mesh)
        with _recording(shapes)():
            fn(model, mesh)
    return shapes


def test_aux_loss_runs_on_the_ranks_rows():
    """The means' backward expanded their gradient to the global (B·S,
    E) on every rank; now each rank sums its own rows."""
    from repro_torch.models.moe import aux_load_balance_loss

    cfg = configs.get_smoke("qwen3_moe_235b_a22b").with_(n_layers=1)

    def step(model, mesh):
        x = S.shard_of(torch.zeros(256, 16, cfg.d_model), mesh,
                       S.batch_sharding(mesh)).requires_grad_()
        aux_load_balance_loss(model._layer(0).ffn, x).backward()

    shapes = _shapes_of(cfg, step)
    assert (16 * 16, cfg.moe_experts) in shapes
    assert (256 * 16, cfg.moe_experts) not in shapes


def test_sampled_head_reads_the_ranks_columns():
    """DTensor's ``index_select`` of the (d, V) head by the replicated
    draws built (d, T·m) over the global batch's tokens, and a zero head
    of the global shape in the backward; now each rank looks up its own
    rows' columns in its vocab window."""
    from repro_torch.models import LM
    from repro_torch.models.sampled_softmax import (LMHeadIndex,
                                                    SampledSoftmaxConfig,
                                                    sampled_softmax_loss)

    cfg = configs.get_smoke("phi4_mini_3_8b").with_(vocab=512)
    scfg = SampledSoftmaxConfig(k=3, l=4, n_samples=8)
    head = LMHeadIndex(LM.init(cfg, seed=0, device="cpu"), scfg)
    toks = torch.randint(0, cfg.vocab, (256, 3),
                         generator=torch.Generator().manual_seed(0))

    def step(model, mesh):
        batch = {k: S.shard_of(v.contiguous(), mesh, S.batch_sharding(mesh))
                 for k, v in (("tokens", toks[:, :-1]),
                              ("targets", toks[:, 1:]))}
        sampled_softmax_loss(model, cfg, scfg,
                             head.inject(batch, step=1)).backward()

    shapes = _shapes_of(cfg, step)
    tokens = 256 * 2
    assert (tokens // 16, scfg.n_samples, cfg.d_model) in shapes
    assert not any(s and s[0] == cfg.d_model and tokens in s[1:]
                   for s in shapes)
    assert (cfg.d_model, cfg.vocab) not in shapes


# last in the module: a fake group of another size replaces the 256 ranks'
# (DTensor's caches would carry the destroyed group's meshes to a later
# 16 x 16 cell)
def test_multi_pod_expert_products_move_no_buffer():
    """On 2 x 16 x 16 the batch is split over (pod, data): the expert
    products merged that split into E's rows and gathered the dispatch
    buffer over the data axes (qwen3-moe ``train_4k``: 140.22 GB a rank).
    Now they run on the mesh's batch view, one data axis of 32: no line
    of the expert products (their weights' gathers, ``moe._weight_for``,
    among them) issues a collective that the 16 x 16 cell does not, nor
    more bytes than there (the multi-pod rank holds half the rows), and
    the peak is no larger."""
    from repro_torch.models import moe
    arch = "qwen3_moe_235b_a22b"
    flat = _train_cell(arch)
    pod, pod_tool = _counted_cell(arch, configs.get_smoke(arch),
                                  multi_pod=True)
    sites, flat_sites = pod_tool["by_site"], _TOOL_COUNTS[arch]["by_site"]
    # the lines from the buffer's placement to the combine
    src, first = inspect.getsourcelines(moe.MoE.forward)
    lo, hi = (first + next(i for i, line in enumerate(src) if key in line)
              for key in ("_as_batch_dtensor(buf", "combine_local("))
    products = [k for k in sites if k.startswith("models/moe.py:")
                and (lo <= int(k.split(":")[1].split()[0]) < hi
                     or k.endswith(" _weight_for"))]
    assert products
    for k in products:
        assert sites[k] <= flat_sites.get(k, 0), (k, sites[k],
                                                   flat_sites.get(k))
    assert pod["mesh"] == "2x16x16"
    assert pod["peak_bytes_per_device"] <= flat["peak_bytes_per_device"]
