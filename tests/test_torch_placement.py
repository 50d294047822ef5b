"""Placing a model on a mesh, in one process: rank 0 of a ``fake`` group
of four ranks (``launch.mesh.init_fake_group``), whose collectives move
no data, on the layouts (4, 1), (2, 2) and (1, 4).  What is checked
here is where tensors live and when, not their values:

* ``distribute_model`` frees each whole leaf as its shard replaces it
  (a model drawn whole on a card, 68.8 GB for llama4 at 2 layers, would
  otherwise hold every whole leaf and every shard at once), and cuts
  each shard with one copy of the shard (torch 2.11's
  ``distribute_tensor`` also copied a whole expert stack, 10.7 GB, where
  a size-1 mesh dim "split" it);
* every gradient comes back placed as its parameter (the MoE's expert
  products move the expert buffer and leave the weights in place, which
  left a partial sum of the WHOLE expert leaf on every data rank);
* Adafactor updates a full-width expert leaf (llama4's, under
  ``FakeTensorMode``) on the rank's shard: no tensor beyond the shard's
  f32 size, and collectives of less than a hundredth of the three
  leaves' (left to
  DTensor, its row and column statistics came out placed apart from the
  gradient: 120 GB of collectives and a whole f32 leaf on (4, 1));
* an async LGD refresh of a model placed on the mesh has finished its
  host work, and so issued every collective of its forward, when its
  launch returns: a worker thread issuing collectives beside the
  training step's reaches the ranks in different orders (two gloo ranks
  crashed on a size mismatch); one that outlasts its watchdog raises;
* a 1 x 1 mesh registers no gradient hook (its one rank holds every
  leaf whole).
"""

import time
import traceback
import weakref

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.data import (LSHPipelineConfig, LSHSampledPipeline,
                              lm_head_query_fn, make_token_corpus,
                              mean_pool_feature_fn)
from repro_torch.dist import sharding as S
from repro_torch.launch.mesh import init_fake_group
from repro_torch.models import LM
from repro_torch.optim import Adafactor, update_in_place

LAYOUTS = [(4, 1), (2, 2), (1, 4)]


@pytest.fixture(scope="module", autouse=True)
def fake_group():
    init_fake_group(4)
    yield
    # later tests in this process may build their own groups
    if dist.is_initialized():
        dist.destroy_process_group()


def _mesh(layout):
    return DeviceMesh("cpu", torch.arange(4).reshape(layout),
                      mesh_dim_names=("data", "model"))


class _Watch(TorchDispatchMode):
    """The bytes of the largest tensor this rank makes (not a view, not
    on the meta device, not in DTensor's sharding propagation, which
    runs ops at global shapes) and of the
    collectives it issues.  It declines DTensor ops, so DTensor's own
    redistributions reach it as local collectives."""

    def __init__(self):
        super().__init__()
        self.biggest = self.moved = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is DTensor for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        outs = [t for t in (out if isinstance(out, (list, tuple)) else [out])
                if isinstance(t, torch.Tensor) and t.device.type != "meta"]
        nbytes = sum(t.numel() * t.element_size() for t in outs)
        if func.namespace == "_c10d_functional":
            self.moved += nbytes
        elif not func.is_view and not any(
                x in f.filename for f in traceback.extract_stack()
                for x in ("_sharding_prop", "_op_schema")):
            self.biggest = max(self.biggest, nbytes)
        return out


@pytest.mark.parametrize("layout", LAYOUTS)
def test_distribute_model_frees_each_whole_leaf(monkeypatch, layout):
    lm = LM.init(configs.get_smoke("llama4_maverick_400b_a17b"), seed=0,
                 device="cpu")
    refs = [weakref.ref(p) for p in lm.parameters()]
    alive = []
    shard_of = S.shard_of

    def spy(t, mesh, placements):
        alive.append(sum(r() is not None for r in refs))
        return shard_of(t, mesh, placements)

    monkeypatch.setattr(S, "shard_of", spy)
    S.distribute_model(lm, _mesh(layout))
    # at the i-th leaf only the whole leaves not yet placed are alive
    assert alive == list(range(len(refs), 0, -1))
    assert all(r() is None for r in refs)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_shard_of_copies_only_the_shard(layout):
    """Placing a model drawn whole makes no tensor larger than a leaf's
    shard, and every shard equals its cut of the whole leaf."""
    lm = LM.init(configs.get_smoke("llama4_maverick_400b_a17b"), seed=0,
                 device="cpu")
    whole = {k: p.detach().clone() for k, p in lm.named_parameters()}
    mesh = _mesh(layout)
    with _Watch() as w:
        S.distribute_model(lm, mesh)
    shards = {k: p.to_local() for k, p in lm.named_parameters()}
    assert w.biggest <= max(t.numel() * t.element_size()
                            for t in shards.values())
    for k, p in lm.named_parameters():
        want = whole[k]
        for i, pl in enumerate(p.placements):
            if pl.is_shard():
                n = mesh.mesh.shape[i]
                k_ = want.shape[pl.dim] // n
                want = want.narrow(pl.dim, mesh.get_coordinate()[i] * k_, k_)
        assert torch.equal(shards[k], want), k
        assert shards[k].is_contiguous()


@pytest.mark.parametrize("arch", ["llama4_maverick_400b_a17b",
                                  "qwen3_moe_235b_a22b", "phi4_mini_3_8b"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_gradients_are_placed_as_their_parameters(arch, layout):
    cfg = configs.get_smoke(arch)
    mesh = _mesh(layout)
    rows = torch.from_numpy(make_token_corpus(7, 4, 17, cfg.vocab)
                            .tokens).long()
    with S.use_mesh(mesh):
        lm = S.distribute_model(LM.init(cfg, seed=0, device="cpu"), mesh)
        lm.loss({"tokens": rows[:, :-1], "targets": rows[:, 1:]}).backward()
    off = {k: (p.placements, p.grad.placements)
           for k, p in lm.named_parameters()
           if tuple(p.grad.placements) != tuple(p.placements)}
    assert not off, off


@pytest.mark.parametrize("layout", LAYOUTS)
def test_adafactor_updates_a_full_width_expert_leaf_on_its_shard(layout):
    cfg = configs.get("llama4_maverick_400b_a17b").with_(n_layers=1)
    mesh = _mesh(layout)
    with FakeTensorMode(allow_non_fake_inputs=True):
        lm = S.distribute_model(LM(cfg, device="cpu"), mesh)
        named = {k: p for k, p in lm.named_parameters()
                 if ".ffn.experts_" in k}
        opt = Adafactor(lr=1e-2)
        state = S.distribute_state(opt.init(
            {k: p.detach() for k, p in named.items()}), mesh, cfg)
        grads = {k: torch.zeros_like(p) for k, p in named.items()}
        with _Watch() as w:
            update_in_place(opt, named, grads, state)
        local = [p.to_local().numel() * 4 for p in named.values()]
    assert max(local) == 128 * 5120 * 8192 // 4 * 4       # 5.37 GB
    assert w.biggest <= max(local), w.biggest / max(local)
    assert w.moved <= sum(local) / 100, w.moved / sum(local)


def test_async_refresh_on_a_mesh_finishes_at_its_launch():
    cfg = configs.get_smoke("phi4_mini_3_8b")
    mesh = _mesh((1, 4))
    pooled = mean_pool_feature_fn(cfg)
    calls = []

    def slow_features(params, tokens):
        time.sleep(0.2)           # a forward long enough to be seen
        calls.append(1)
        return pooled(params, tokens)

    with S.use_mesh(mesh):
        lm = S.distribute_model(LM.init(cfg, seed=0, device="cpu"), mesh)
        p = LSHSampledPipeline(
            0, make_token_corpus(0, 32, 17, cfg.vocab).tokens,
            slow_features, lm_head_query_fn(),
            LSHPipelineConfig(minibatch=4, k=3, l=4, refresh_every=2,
                              refresh_async=True),
            feature_batch=16, params=lm, device="cpu")
        built = len(calls)
        p._launch_refresh()
        fl = p._flight
        assert not fl.thread.is_alive()
        assert len(calls) == 2 * built and fl.reads_issued.is_set()
        p.finalize()


def test_async_refresh_on_a_mesh_past_its_watchdog_raises():
    """A worker still issuing its forward's collectives when the watchdog
    expires would interleave them with the step's: the launch raises
    instead of letting the step go ahead."""
    cfg = configs.get_smoke("phi4_mini_3_8b")
    mesh = _mesh((1, 4))
    pooled = mean_pool_feature_fn(cfg)
    slow = []

    def features(params, tokens):
        if slow:
            time.sleep(0.5)       # past the watchdog below
        return pooled(params, tokens)

    with S.use_mesh(mesh):
        lm = S.distribute_model(LM.init(cfg, seed=0, device="cpu"), mesh)
        p = LSHSampledPipeline(
            0, make_token_corpus(0, 32, 17, cfg.vocab).tokens,
            features, lm_head_query_fn(),
            LSHPipelineConfig(minibatch=4, k=3, l=4, refresh_every=2,
                              refresh_async=True, refresh_timeout=0.05),
            feature_batch=16, params=lm, device="cpu")
        slow.append(1)
        with pytest.raises(RuntimeError, match="watchdog"):
            p._launch_refresh()
        p._flight.thread.join()


def test_a_one_rank_mesh_places_gradients_without_a_hook():
    """On a 1 x 1 mesh every leaf is whole on its one rank: no gradient
    hook (its redistribution would be host work on every leaf at every
    step), and the loss backward still gives every parameter a
    gradient."""
    cfg = configs.get_smoke("llama4_maverick_400b_a17b")
    mesh = DeviceMesh("cpu", torch.zeros(1, 1, dtype=torch.int64),
                      mesh_dim_names=("data", "model"))
    rows = torch.from_numpy(make_token_corpus(7, 4, 17, cfg.vocab)
                            .tokens).long()
    with S.use_mesh(mesh):
        lm = S.distribute_model(LM.init(cfg, seed=0, device="cpu"), mesh)
        assert not any(p._backward_hooks for p in lm.parameters())
        lm.loss({"tokens": rows[:, :-1], "targets": rows[:, 1:]}).backward()
    assert all(p.grad is not None for p in lm.parameters()
               if p.requires_grad)
