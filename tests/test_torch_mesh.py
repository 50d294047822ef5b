"""The port under a real mesh: two processes on gloo, on the CPU.

``tools/mesh_check.py --device cpu --nprocs 2`` runs as two ranks (a
``FileStore``, no launcher) with the SMOKE phi4-mini on meshes (2, 1)
and (1, 2), each beside the meshless run of the same inputs in the same
process, and ``tools/mesh_check.py --host-mesh`` as one process for the
launcher's 1 x 1 host mesh.  These tests read what each rank wrote; the
four-card check on the H100 runs the same code.  The JAX reference's
own launcher crashes under JAX 0.9 (ROADMAP.md queue 3), so the
yardstick is the port's meshless run; parity with the reference is the
spec tables of ``test_torch_sharding.py`` and the SMOKE parity tests.
Tolerances (the tool's, where a check reads its verdict ``ok``):

* one ``Trainer`` step, clipped (``grad_clip`` 0.05, below the step's
  norm): every leaf's gradient within 1e-5 of the meshless one relative
  to the leaf's largest entry, and the clip's ``grad_norm`` to rtol
  1e-5 (f32 partial sums reduced across ranks in another order); the
  loss to rtol 1e-6; the parameters after Adam's step (lr 1e-3) within
  lr / 4 and on average 1e-6 (Adam's first update is lr · g / (|g| +
  eps): a gradient at eps moves it by up to lr / 4 for a reduction-order
  change), and here, on two ranks, within 1e-5;
* the same step with ``grad_compress`` (each leaf's gradient compressed
  whole) against the meshless compressed step: as Adam's (a gradient
  that differs by 1e-6 may flip one int8 level, which lr / 4 allows),
  the error-feedback residual placed as its parameter and whole bitwise
  the same on both ranks, each element within one int8 level of the
  meshless residual and at most 1% of them off it by more than twice
  the gradient tolerance, and ``wire_bytes`` the meshless count;
* Adafactor and Adam8bit steps of phi4-mini on (1, 2), and one with a
  single KV head (the q heads split, the KV head whole): as Adam's;
* the SMOKE qwen3-moe, llama4 and zamba2 on (1, 2): as Adam's, the loss
  to rtol 1e-5;
* the giants check (SMOKE llama4 and qwen3-moe, Adafactor, 6 trainer
  steps on the launcher's LGD batches with an async refresh at step 3)
  on (2, 1) and (1, 2) against the meshless run of the same shards: the
  losses to rtol 1e-5, the fixed batch's gradient of every leaf within
  1e-5 of its largest meshless entry and its clip norm to rtol 1e-5, the
  ranks' losses equal, the plain LGD entries called once a shard a
  build, refresh and draw, the batch-mean weight 1 +- 1e-5, the refresh
  swapped in healthy, each rank's local bytes of weights, gradients
  and Adafactor slots equal to the tool's prediction, and the fixed
  batch routed as the first layout giving its own loss and norm;
* the prefill and decode steps: the f32 logits within a relative L2 of
  1e-5 of the meshless ones;
* the placement check: the SMOKE granite with an odd vocab (131, whole
  over ``model``) on (2, 1) and (1, 2), the loss to rtol 1e-6 and every
  leaf's gradient within 1e-5; the SMOKE nemotron's prefill and decode
  logits within a relative L2 of 1e-5; the SMOKE qwen3-moe on the pod
  layout (pod 2, data 1, model 1) against (2, 1) and meshless, on 8 x 32
  tokens (each expert weight gathered) and 4 x 4 (the rows moved), the
  loss to rtol 1e-5, every gradient within 1e-5, the collective bytes
  within 5% of (2, 1)'s; the MoE auxiliary loss and the LSH-sampled head on
  each rank's rows, the loss to rtol 1e-6 and every gradient within
  1e-5;
* ``ShardedLSHPipeline(mesh=)``'s composed batch, a meshless checkpoint
  restored onto (1, 2), a (1, 2) checkpoint restored meshless, the
  kernel entries on DTensors and the launcher's 1 x 1 host-mesh losses:
  bitwise.
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(ROOT, "tools", "mesh_check.py")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "1")
    return env


def _run(args, out):
    p = subprocess.run([sys.executable, TOOL, "--device", "cpu", "--out",
                        str(out)] + args, env=_env(), capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, (p.stdout + p.stderr)[-4000:]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    _run(["--nprocs", "2"], out)
    res = []
    for r in (0, 1):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            res.append(json.load(f))
    return res


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    out = tmp_path_factory.mktemp("host")
    _run(["--host-mesh"], out)
    with open(os.path.join(out, "host.json")) as f:
        return json.load(f)


SHAPES = ["2x1", "1x2"]


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_train_step_matches_meshless(ranks, rank, shape):
    got = ranks[rank]["meshes"][shape]["train"]
    assert got["ok"], got
    assert got["param_err_max"] <= 1e-5
    # the reference's placements reached the parameters: embed (V, d)
    # (model, data), wq (d, H, Dh) (data, model, -)
    pl = got["placements"]
    assert pl["embed_group.embed"] == ["S(1)", "S(0)"]
    assert pl["blocks.0.attn.wq"] == ["S(0)", "S(1)"]


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_gradients_and_clip_norm_match_meshless(ranks, rank, shape):
    """What a first Adam step cannot see: the gradient's scale.  The
    step was clipped, and its norm reduced over every shard."""
    got = ranks[rank]["meshes"][shape]["train"]
    assert got["clipped"] and got["grad_norm_meshless"] > 0.05
    assert got["grad_norm_rel"] <= 1e-5
    assert got["grad_rel_max"] <= 1e-5, got["grad_worst_leaf"]


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_compressed_step_matches_meshless(ranks, rank, shape):
    """``Trainer(grad_compress=True)`` on DTensor parameters: the whole
    leaf is compressed, so the step is the meshless compressed step's."""
    got = ranks[rank]["meshes"][shape]["compress"]
    assert got["ok"], got
    assert got["clipped"] and got["grad_norm_rel"] <= 1e-5
    assert got["grad_rel_max"] <= 1e-5, got["grad_worst_leaf"]
    assert got["param_err_max"] <= 1e-3 / 4
    assert got["param_err_mean"] <= 1e-6
    # the whole leaves go on the wire: the meshless byte count
    assert got["wire_bytes"] == got["wire_bytes_meshless"] > 0


@pytest.mark.parametrize("shape", SHAPES)
def test_compressed_residual_same_on_ranks(ranks, shape):
    a, b = (r["meshes"][shape]["compress"] for r in ranks)
    assert a["residual_placed"] and b["residual_placed"]
    assert a["residual_same_on_ranks"] and b["residual_same_on_ranks"]
    assert a["residual_digest"] == b["residual_digest"]
    # carried forward as the meshless residual, off it only where a
    # gradient 1e-6 away flipped one int8 level
    assert a["residual_err_levels"] <= 1.0
    assert a["residual_off_share"] <= 1e-2
    assert a["params_digest"] == b["params_digest"]


def test_ranks_agree(ranks):
    for shape in SHAPES:
        a, b = (r["meshes"][shape]["train"] for r in ranks)
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
        assert a["params_digest"] == b["params_digest"]


@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b",
                                  "llama4_maverick_400b_a17b", "zamba2_1_2b"])
def test_moe_and_mamba_step_on_1x2(ranks, arch):
    got = ranks[0]["1xn"][arch]
    assert got["ok"], got
    # the model axis splits something in each
    assert any("S(" in p[1] for p in got["placements"].values())


def test_q_heads_split_unlike_kv_heads(ranks):
    """One KV head does not split over model = 2 where the 4 q heads do:
    each rank gets the KV head its q heads use (repeated), rather than a
    cut of the KV heads or a gathered q."""
    got = ranks[0]["1xn"]["one_kv_head"]
    assert got["placements"]["blocks.0.attn.wq"] == ["S(0)", "S(1)"]
    assert got["placements"]["blocks.0.attn.wk"] == ["S(0)", "R"]
    assert got["ok"], got
    assert got["param_err_max"] <= 1e-5


@pytest.mark.parametrize("opt", ["adafactor", "adam8bit"])
def test_adafactor_and_adam8bit_step_on_1x2(ranks, opt):
    """Adafactor's factored row and column statistics reduce over the
    shards of a sharded leaf; Adam8bit updates the whole leaf from the
    gathered gradient (its 256-value blocks do not follow a shard)."""
    got = ranks[0]["1xn"][opt]
    assert got["ok"], got
    assert got["param_err_max"] <= 1e-5


@pytest.mark.parametrize("shape", SHAPES)
def test_prefill_and_decode_match_meshless(ranks, shape):
    got = ranks[0]["meshes"][shape]["serve"]
    assert got["ok"] and got["rel_l2"] <= 1e-5, got
    assert got["same_tokens"]


@pytest.mark.parametrize("shape", SHAPES)
def test_lgd_steps_on_mesh(ranks, shape):
    for r in ranks:
        got = r["meshes"][shape]["lgd"]
        assert got["ok"] and len(got["losses"]) == 2, got


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_composed_batch_bitwise(ranks, rank, shape):
    got = ranks[rank]["meshes"][shape]["batch"]
    assert got["equal"] and all(got["equal"].values()), got["equal"]
    # a rank holds its data-parallel slice: half the rows on (2, 1)
    assert got["local_rows"] == got["want_rows"]
    assert all(p == ["S(0)", "R"] for p in got["placements"].values())
    assert got["ok"]


@pytest.mark.parametrize("rank", [0, 1])
def test_meshless_checkpoint_restores_on_1x2(ranks, rank):
    r = ranks[rank]["1xn"]["restore"]
    assert r["onto_mesh"] and all(r["onto_mesh"].values())
    pl = r["placements"]
    assert pl["params/embed_group.embed"] == ["S(1)", "S(0)"]
    assert pl["opt_state/step"] == ["R", "R"]
    assert pl["opt_state/m/embed_group.embed"] == ["S(1)", "S(0)"]


@pytest.mark.parametrize("entry", [
    "simhash", "bucket_probe", "bucket_probe_multi", "bucket_probe_codes",
    "gather_weight", "flash_attention", "flash_decode", "on_cuda_refuses"])
def test_kernel_entries_take_dtensors(ranks, entry):
    """A DTensor at a kernel entry is mapped to local tensors (the LGD
    entries gather it whole; attention runs on each rank's heads) and
    comes back a DTensor equal to the plain call; ``on_cuda`` never
    lets one through."""
    assert all(r["1xn"]["entries"][entry] for r in ranks)


@pytest.mark.parametrize("rank", [0, 1])
def test_mesh_checkpoint_restores_meshless(ranks, rank):
    r = ranks[rank]["1xn"]["restore"]["reverse"]
    assert r and all(r.values())


@pytest.mark.parametrize("lgd", ["uniform", "lgd"])
def test_launcher_host_mesh_matches_meshless_bitwise(host, lgd):
    assert host[lgd]["mesh"] == host[lgd]["meshless"]
    assert len(host[lgd]["mesh"]) == 3


GIANTS = ["llama4_maverick_400b_a17b", "qwen3_moe_235b_a22b"]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", GIANTS)
def test_giants_train_on_every_layout(ranks, arch, shape):
    """The MoE giants' training path (``LM.init``, ``distribute_model``,
    ``make_batches(lgd=True, mesh=)``, ``make_trainer`` with the dry
    run's Adafactor) against the meshless run of the same shards."""
    got = ranks[0]["giants"][arch]["layouts"][shape]
    assert got["run"] and got["ok"], got
    assert len(got["losses"]) == 6
    assert got["loss_rel_max"] <= 1e-5
    assert got["grad_rel_max"] <= 1e-5 and got["grad_norm_rel"] <= 1e-5
    assert got["weight_mean_max_dev"] <= 1e-5
    assert got["refreshes"] == got["n_shards"] and got["refresh_ok"]
    # f32: every token routed to the same experts as on the first layout
    assert got["routes_differ_share"] == 0


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", GIANTS)
def test_giants_pinned_routing_is_the_routed_one(ranks, arch, shape):
    """The fixed batch routed as the first layout (``_pinned_routes``,
    which the cards' layout comparison gates on) gives the loss and clip
    norm of the batch as this layout routes it, where the two routings
    are the same (f32)."""
    got = ranks[0]["giants"][arch]["layouts"][shape]
    assert got["routes_differ_share"] == 0
    for k in ("fixed_loss", "fixed_grad_norm"):
        assert abs(got[k + "_pinned"] - got[k]) <= 1e-6 * abs(got[k]), k


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", GIANTS)
def test_giants_experts_keep_the_reference_placement(ranks, arch, shape):
    """The reference's (E, d, ff) -> (model, data, -): on the (data,
    model) mesh the data axis splits d (dim 1), the model axis E."""
    got = ranks[0]["giants"][arch]["layouts"][shape]["expert_placements"]
    assert len(got) == 6            # gate, up, down of 2 layers
    for k, pl in got.items():
        assert pl == ["S(1)", "S(0)"], (k, pl)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", GIANTS)
def test_giants_ranks_agree_and_launch_per_shard(ranks, arch, shape):
    """Every rank's losses bitwise equal; each rank builds, refreshes and
    draws from every shard (the stores are replicated mesh-wide): the
    plain simhash twice a shard, bucket_probe and draw_assemble once a
    shard a step."""
    a, b = (r["giants"][arch]["layouts"][shape] for r in ranks)
    assert a["losses"] == b["losses"] and a["ranks_equal"]
    dp = int(shape.split("x")[0])
    want = {"simhash": 2 * dp, "bucket_probe": 6 * dp,
            "draw_assemble": 6 * dp}
    assert a["launches"] == b["launches"] == want


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", GIANTS)
def test_giants_predicted_local_bytes_are_real(ranks, arch, shape, rank):
    """``rank_memory``'s local bytes of weights, gradients (placed as
    their parameters) and Adafactor's slots equal the storages this rank
    holds."""
    got = ranks[rank]["giants"][arch]["layouts"][shape]
    pred = got["predicted"]
    assert got["weight_bytes"] == pred["weights_bytes"]
    assert got["grad_bytes"] == pred["grads_bytes"]
    assert got["slot_bytes"] == pred["slots_bytes"]
    # the whole model drawn before it is placed bounds the init
    assert pred["init_gb"] >= pred["whole_gb"] > pred["weights_gb"]


# -- placement: the three placements the dry run found, on real ranks ---------

@pytest.mark.parametrize("shape", SHAPES)
def test_whole_vocab_loss_step_matches_meshless(ranks, shape):
    """A vocab that does not divide ``model`` (granite's 49,155; 131
    here): the loss runs on each rank's rows, the embedding gathers the
    whole table over ``data`` only; the loss and every leaf's gradient,
    the embedding's included, as meshless."""
    got = ranks[0]["placement"]["granite"]
    assert got["vocab"] % 2 == 1
    row = got["layouts"][shape]
    assert row["ok"], row
    assert row["loss_rel"] <= 1e-6 and row["grad_rel_max"] <= 1e-5
    # the table's d split on ``data``; its vocab whole over a 2-wide
    # ``model`` (a 1-wide one "splits" it)
    want = ["S(1)", "R"] if shape == "1x2" else ["S(1)", "S(0)"]
    assert row["embed"] == want


@pytest.mark.parametrize("shape", SHAPES)
def test_vocab_parallel_lookup_serves_as_meshless(ranks, shape):
    """The embedding's window lookup, summed across the vocab's ranks:
    the prefill's and decode steps' f32 logits as meshless."""
    row = ranks[0]["placement"]["nemotron"]["layouts"][shape]
    assert row["ok"] and row["rel_l2"] <= 1e-5, row
    assert row["embed"] == ["S(1)", "S(0)"]


def test_moe_step_on_a_pod_layout(ranks):
    """The batch over (pod, data) against over data alone, the same
    data-parallel degree: the expert products on each rank's rows with
    the weights gathered once over both data axes.  The loss as (2, 1)'s
    and as meshless, every gradient too, and the collective bytes within
    5% of (2, 1)'s."""
    for r in ranks:
        got = r["placement"]["qwen3_moe"]["variants"]["f32"]
        assert got["ok"], got
        assert got["layouts"] == ["2x1", "2x1x1"]
        assert got["loss_rel"] <= 1e-5 and got["grad_rel_max"] <= 1e-5
        assert got["loss_rel_meshless"] <= 1e-5
        assert got["grad_rel_max_meshless"] <= 1e-5
        assert abs(got["collective_ratio"] - 1) <= 0.05
        # experts (E, d, ff): d over pod and data, E over model
        assert got["expert_placements"] == ["S(1)", "S(1)", "S(0)"]
        # 8 x 32 tokens: each product gathers its weight on both layouts
        assert got["weights_gathered"] == [True, True]


def test_moe_short_batch_on_a_pod_layout(ranks):
    """The pod layout on 4 x 4 tokens, where a weight's gather would
    move more bytes than the rows (``moe._weight_for``): DTensor moves
    the rows on both layouts, and the loss and every gradient are as
    (2, 1)'s and as meshless, the collective bytes within 5%."""
    for r in ranks:
        got = r["placement"]["qwen3_moe"]["variants"]["f32 short"]
        assert got["ok"], got
        assert (got["rows"], got["seq"]) == (4, 4)
        assert got["weights_gathered"] == [False, False]
        assert got["loss_rel"] <= 1e-5 and got["grad_rel_max"] <= 1e-5
        assert got["loss_rel_meshless"] <= 1e-5
        assert got["grad_rel_max_meshless"] <= 1e-5
        assert abs(got["collective_ratio"] - 1) <= 0.05


@pytest.mark.parametrize("loss", ["aux", "head"])
@pytest.mark.parametrize("shape", SHAPES)
def test_losses_on_local_rows_match_meshless(ranks, shape, loss):
    """The MoE auxiliary loss and the LSH-sampled head (each rank its own
    rows and vocab window): the loss and every gradient as meshless."""
    row = ranks[0]["placement"]["local_rows"]["layouts"][shape]
    got = row[loss]
    assert got["same_leaves"], got
    assert got["loss_rel"] <= 1e-6 and got["grad_rel_max"] <= 1e-5, got
