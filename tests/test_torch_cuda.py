"""The port's hand-written CUDA kernels against their plain versions.

These need a card and skip without one.  The file imports no JAX, so it
also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Codes must be equal except where a projection is within 1e-4 of zero
(kernel and plain version sum in different orders); lo/hi bitwise
outside the tables whose query code is exempt that way; gathered rows
and weights bitwise.  draw_assemble against the sampler's plain
composition on the same card: ids, walk results and rows bitwise, p
and weights within rtol 1e-4 (another sum order, acosf and powf).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import (
    IndexMutation, LGDProblem, LSHParams, SampleDraws, bucket_bounds,
    draw_samples, init, lgd_step, mutate_index, probe_masks, query_codes)
from repro_torch.core.sampler import draw_assemble, draw_assemble_plain
from repro_torch.kernels import arrival_counts, launches
from repro_torch.kernels.bucket_probe import (
    bucket_probe_codes_cuda,
    bucket_probe_codes_ref,
    bucket_probe_cuda,
    bucket_probe_multi_cuda,
    bucket_probe_multi_ref,
    bucket_probe_ref,
)
from repro_torch.kernels.gather_weight import (
    gather_weight_cuda,
    gather_weight_ref,
)
from repro_torch.kernels.simhash import simhash_codes_cuda, simhash_codes_ref
from repro_torch.launch import train as launch_train
from repro_torch.optim import make_optimizer

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _near(q, w, k):
    """(B, L) mask of codes with a projection within 1e-4 of zero."""
    proj = q.double() @ w.double()
    return (proj.abs() < 1e-4).reshape(q.shape[0], -1, k).any(-1).cpu()


def _inputs(card, seed, n, d, l, k, b):
    g = torch.Generator(device=card).manual_seed(seed)
    shift = torch.linspace(0, 2, d, device=card)
    x = torch.randn((n, d), generator=g, device=card) + shift
    w = torch.randn((d, l * k), generator=g, device=card)
    sc = torch.sort(simhash_codes_ref(x, w, k=k, l=l).T.contiguous(),
                    dim=1).values
    q = torch.randn((b, d), generator=g, device=card) + shift
    return x, w, sc, q


@pytest.mark.parametrize("n,d,l,k", [
    (3000, 91, 100, 5),    # the slice's widths
    (777, 40, 7, 32),      # max K, ragged row tile
    (5, 3, 1, 1),          # degenerate
    (1000, 129, 10, 7),    # past one part: parts across blocks
    (2048, 3072, 10, 7),   # the train path's shape
])
def test_simhash(card, n, d, l, k):
    x, w, _, _ = _inputs(card, 0, n, d, l, k, 1)
    before = launches["simhash"]
    got = simhash_codes_cuda(x, w, k=k, l=l)
    assert got.shape == (l, n) and got.dtype == torch.int64
    assert launches["simhash"] == before + 1
    keep = ~_near(x, w, k).T
    np.testing.assert_array_equal(
        got.cpu()[keep], simhash_codes_ref(x, w, k=k, l=l).T.cpu()[keep])
    assert torch.equal(simhash_codes_cuda(x, w, k=k, l=l), got)


def _cancelling(card, seed, n, d):
    """Rows whose features cancel in pairs up to a remainder of ~1e-6: the
    sign of their sum over an all-ones column is set by rounding, so by
    the order of the sum."""
    g = torch.Generator(device=card).manual_seed(seed)
    u = torch.exp(torch.rand((n, d // 2), generator=g, device=card) * 11 - 3)
    x = torch.cat([u, -u, torch.zeros((n, d % 2), device=card)], 1)
    x = x[:, torch.randperm(d, generator=g, device=card)]
    return x + 1e-6 * torch.randn((n, d), generator=g, device=card)


@pytest.mark.parametrize("n,d,l,k", [
    (3000, 91, 100, 5),    # one sum
    (2000, 129, 10, 7),    # parts across blocks, 32-row tiles
    (2048, 3072, 10, 7),   # the train path's shape: across blocks
    (20_000, 200, 10, 7),  # parts in registers
])
def test_simhash_probe_identity(card, n, d, l, k):
    """A point hashed by the probe as a query gets bitwise the code simhash
    gave it, near-zero projections included: 16 rows (8 of them rows
    that cancel) probed against the index sorted from simhash's codes."""
    x, w, _, _ = _inputs(card, 3, n, d, l, k, 1)
    w[:, ::2] = 1.0
    x[:8] = _cancelling(card, d, 8, d)
    codes = simhash_codes_cuda(x, w, k=k, l=l)               # (L, N)
    sc = torch.sort(codes, dim=1).values
    rows = torch.cat([torch.arange(8, device=card),
                      torch.randint(8, n, (8,), device=card)])
    lo, hi = bucket_probe_cuda(x[rows].contiguous(), w, sc, k=k, l=l)
    assert bool((hi > lo).all())
    hit = torch.gather(sc, 1, lo.T.long())                    # (L, 16)
    assert torch.equal(hit, codes[:, rows])


@pytest.mark.parametrize("n,d,l,k", [(900, 40, 7, 32), (600, 3072, 10, 7)])
def test_simhash_x_layouts_agree(card, n, d, l, k):
    """x with 16-byte aligned rows (16-byte copies) and the same x 4 bytes
    off that alignment (4-byte copies) give the same bits."""
    x, w, _, _ = _inputs(card, 6, n, d, l, k, 1)
    x[:8] = _cancelling(card, 6, 8, d)
    w[:, ::2] = 1.0
    buf = torch.empty(n * d + 1, device=card)
    off = buf[1:].view(n, d)
    off.copy_(x)
    assert off.data_ptr() % 16 == 4 and x.data_ptr() % 16 == 0
    assert torch.equal(simhash_codes_cuda(off, w, k=k, l=l),
                       simhash_codes_cuda(x, w, k=k, l=l))


def test_simhash_plans_agree(card, monkeypatch):
    """Every launch plan sums in the same order: all give the same bits."""
    from repro_torch.kernels.simhash import kernel as sk
    plan_of = sk.simhash_plan
    for n, d, l, k, plans in [
            (700, 91, 100, 5, [(128, 1, False), (64, 1, False),
                               (32, 1, False)]),
            (700, 300, 10, 7, [(64, 1, False), (32, 1, False),
                               (64, 2, False), (32, 4, False),
                               (64, 4, False), (64, 2, True),
                               (128, 4, True), (64, 4, True)])]:
        x, w, _, _ = _inputs(card, 5, n, d, l, k, 1)
        x[:8] = _cancelling(card, 5, 8, d)
        w[:, ::2] = 1.0
        base = plan_of(n, d, l, k, 132)
        outs = []
        # ranks > 1: the blocks of a row tile share their part sums in a
        # cooperative launch; narrow: in the 72-column layout
        for bm, ranks, narrow in plans:
            forced = base._replace(bm=bm, ranks=ranks, tiles=-(-n // bm),
                                   narrow=narrow)
            monkeypatch.setattr(sk, "simhash_plan", lambda *a, p=forced: p)
            outs.append(simhash_codes_cuda(x, w, k=k, l=l))
        for o in outs[1:]:
            assert torch.equal(o, outs[0])


def test_simhash_instances(card):
    """The instantiation each plan runs (as the CUDA launcher reports it)
    was built with at most 128 registers and no spill, and two of its
    blocks fit an SM (227 KB a block, 228 KB an SM less 1 KB a block); a
    plan the kernel does not take is refused."""
    import importlib.util
    from repro_torch.kernels import build
    from repro_torch.kernels.simhash import kernel as sk
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    simhash_codes_cuda(*_inputs(card, 0, 10, 8, 2, 3, 1)[:2], k=3, l=2)
    use = cs.simhash_usage(build)
    for n, d, l, k in [(463_715, 91, 100, 5), (2048, 3072, 10, 7),
                       (777, 40, 7, 32), (100_000, 3072, 10, 7),
                       (100_000, 128, 100, 5), (2048, 129, 10, 7),
                       (600, 3072, 10, 7)]:
        x = torch.empty((1, d), device=card)
        plan = sk.simhash_plan(n, d, l, k, sms)
        inst = sk.simhash_instance(x, plan, l, k)
        assert inst["rows"] == plan.bm and inst["narrow"] == plan.narrow
        u = use[cs.simhash_label(inst)]
        assert u["regs"] <= 128 and u["spill"] == 0
        assert 2 * (inst["smem"] + u["smem"] + 1024) <= 228 * 1024
    x = torch.empty((1, 3072), device=card)
    plan = sk.simhash_plan(2048, 3072, 10, 7, sms)
    assert sk.simhash_instance(x, plan._replace(ranks=1), 10, 7) is None
    assert sk.simhash_instance(x, plan._replace(bm=32), 10, 7) is None


@pytest.mark.parametrize("b", [1, 16])
def test_probes(card, b):
    _, w, sc, q = _inputs(card, 1, 5000, 24, 16, 4, b)
    keep = ~_near(q, w, 4)
    got = bucket_probe_cuda(q, w, sc, k=4, l=16)
    want = bucket_probe_ref(q, w, sc, k=4, l=16)
    for a, c in zip(got, want):
        np.testing.assert_array_equal(a.cpu()[keep], c.cpu()[keep])
    masks = probe_masks(4, 7)
    got = bucket_probe_multi_cuda(q, w, sc, masks, k=4, l=16)
    want = bucket_probe_multi_ref(q, w, sc, masks, k=4, l=16)
    keep_j = keep[:, None, :].expand(b, len(masks), 16)
    for a, c in zip(got, want):
        np.testing.assert_array_equal(a.cpu()[keep_j], c.cpu()[keep_j])
    qc = torch.randint(0, 17, (b, 16), device=card)
    for a, c in zip(bucket_probe_codes_cuda(qc, sc),
                    bucket_probe_codes_ref(qc, sc)):
        np.testing.assert_array_equal(a.cpu(), c.cpu())


def _hold_probes(q, w, sc, k, l, masks):
    """All three probe entries against their plain versions: lo/hi
    bitwise outside near-zero projections, one launch a call, and a
    second call bitwise equal to the first."""
    b, j = q.shape[0], len(masks)
    keep = ~_near(q, w, k)
    keep_j = keep[:, None, :].expand(b, j, l)
    before = dict(launches)
    got = bucket_probe_cuda(q, w, sc, k=k, l=l)
    for a, c in zip(got, bucket_probe_ref(q, w, sc, k=k, l=l)):
        np.testing.assert_array_equal(a.cpu()[keep], c.cpu()[keep])
    got_j = bucket_probe_multi_cuda(q, w, sc, masks, k=k, l=l)
    for a, c in zip(got_j, bucket_probe_multi_ref(q, w, sc, masks, k=k, l=l)):
        np.testing.assert_array_equal(a.cpu()[keep_j], c.cpu()[keep_j])
    marr = torch.tensor(masks, dtype=torch.int64, device=q.device)
    qc = (simhash_codes_ref(q, w, k=k, l=l)[:, None, :]
          ^ marr[None, :, None]).reshape(b * j, l).contiguous()
    got_c = bucket_probe_codes_cuda(qc, sc)
    for a, c in zip(got_c, bucket_probe_codes_ref(qc, sc)):
        np.testing.assert_array_equal(a.cpu(), c.cpu())
    for name in ("bucket_probe", "bucket_probe_multi", "bucket_probe_codes"):
        assert launches[name] == before[name] + 1
    again = (bucket_probe_cuda(q, w, sc, k=k, l=l)
             + bucket_probe_multi_cuda(q, w, sc, masks, k=k, l=l)
             + bucket_probe_codes_cuda(qc, sc))
    for a, c in zip(got + got_j + got_c, again):
        assert torch.equal(a, c)


# N at the k-ary search's round thresholds (32, 1,088, 35,936) and past them
@pytest.mark.parametrize("n", [1, 31, 32, 33, 1_089, 1_090, 35_936, 35_938])
@pytest.mark.parametrize("b", [1, 16])
def test_probe_sizes(card, n, b):
    _, w, sc, q = _inputs(card, n, n, 24, 16, 4, b)
    _hold_probes(q, w, sc, 4, 16, probe_masks(4, 3))


@pytest.mark.parametrize("j", [1, 3, 529])
def test_probe_edge_tables(card, j):
    """K 32: a table whose codes are all equal, duplicates that straddle
    every pivot, 2^32 - 1 codes, and queries below the minimum, above the
    maximum and equal to 2^32 - 1 (all projections positive)."""
    n, d, l, k, b = 35_938, 40, 4, 32, 16
    g = torch.Generator(device=card).manual_seed(j)
    w = torch.randn((d, l * k), generator=g, device=card)
    top = 2 ** 32 - 1
    rows = [torch.full((n,), 7, dtype=torch.int64, device=card),
            torch.arange(34, device=card).repeat_interleave(n // 34 + 1)[:n]
            * (top // 40),
            torch.randint(0, top, (n,), generator=g, device=card),
            torch.randint(0, top, (n,), generator=g, device=card)]
    rows[3][: n // 3] = top
    sc = torch.sort(torch.stack(rows), dim=1).values.contiguous()
    w[0] = w[0].abs() + 1.0
    q = torch.randn((b, d), generator=g, device=card)
    q[0] = 0.0
    q[0, 0] = 1.0                       # projections w[0] > 0: code 2^32 - 1
    assert int(simhash_codes_ref(q[:1], w, k=k, l=l).min()) == top
    _hold_probes(q, w, sc, k, l, probe_masks(k, j))
    qc = torch.tensor([[0, top, 6, top], [top, 0, top, 0]], device=card)
    for a, c in zip(bucket_probe_codes_cuda(qc, sc),
                    bucket_probe_codes_ref(qc, sc)):
        np.testing.assert_array_equal(a.cpu(), c.cpu())


@pytest.mark.parametrize("b", [1, 16])
def test_probe_train_shape(card, b):
    """The train path's query probe (d 3,072, K 7, L 10, N 2,048): the
    hash split over blocks, the last block adding the parts' sums; the
    arrival counts are 0 again after each call."""
    _, w, sc, q = _inputs(card, 9, 2048, 3072, 10, 7, b)
    _hold_probes(q, w, sc, 7, 10, probe_masks(7, 3))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    torch.cuda.synchronize()
    assert int(arrival_counts(q.device, stream, 1).abs().sum()) == 0


def test_bucket_bounds_launches_the_probe_kernel(card):
    """The core entries probe a card index with the kernel, never with
    the plain searches."""
    x, w, _, q = _inputs(card, 2, 2000, 12, 8, 3, 1)
    p = LSHParams(k=3, l=8, dim=12, family="dense")
    index = mutate_index(None, IndexMutation("build", projections=w,
                                             x_aug=x), p)
    qc = query_codes(index, q[0], p)
    before = launches["bucket_probe_codes"]
    lo, hi = bucket_bounds(index, qc)
    assert launches["bucket_probe_codes"] == before + 1
    want = bucket_probe_codes_ref(qc[None], index.sorted_codes)
    np.testing.assert_array_equal(lo.cpu(), want[0][0].cpu())
    np.testing.assert_array_equal(hi.cpu(), want[1][0].cpu())


def test_wrappers_raise_on_bad_inputs(card):
    x = torch.zeros((4, 3), device=card)
    with pytest.raises(TypeError):
        simhash_codes_cuda(x.double(), torch.zeros((3, 4), device=card),
                           k=2, l=2)
    with pytest.raises(ValueError, match="contiguous"):
        simhash_codes_cuda(torch.zeros((3, 4), device=card).T,
                           torch.zeros((3, 4), device=card), k=2, l=2)
    with pytest.raises(ValueError, match="tables"):
        bucket_probe_codes_cuda(torch.zeros((1, 2), dtype=torch.int64,
                                            device=card),
                                torch.zeros((3, 5), dtype=torch.int64,
                                            device=card))


def test_index_and_step_match_cpu(card):
    """An index built on the card equals the CPU's, and one LGD step
    with the same draws gives the same theta."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn((800, 12), generator=g)
    y = x @ torch.randn(12, generator=g) + torch.randn(800, generator=g)
    p = LSHParams(k=4, l=10, dim=13, family="dense")
    proj = torch.randn((13, 40), generator=g)
    prob = LGDProblem(kind="regression", lsh=p, minibatch=8, multiprobe=2)
    opt = make_optimizer("sgd", 0.05)
    st, xt, yt, xa = init(None, prob, x, y, opt, projections=proj)
    idx_g = mutate_index(None, IndexMutation(
        "build", projections=proj.to(card), x_aug=xa.to(card)), p)
    np.testing.assert_array_equal(idx_g.sorted_codes.cpu(),
                                  st.index.sorted_codes)
    np.testing.assert_array_equal(idx_g.order.cpu(), st.index.order)
    dr = draw_samples(g, (8,), 20, 10, 800, "cpu")
    st_c, _ = lgd_step(None, st, xt, yt, xa, prob, opt, draws=dr)
    st_g = st._replace(theta=st.theta.to(card), index=idx_g,
                       step=st.step.to(card),
                       opt_state=type(st.opt_state)(st.opt_state.step.to(
                           card), None))
    st_g, _ = lgd_step(None, st_g, xt.to(card), yt.to(card), xa.to(card),
                       prob, opt, draws=dr.to(card))
    torch.testing.assert_close(st_g.theta.cpu(), st_c.theta, rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("n,w,m", [
    (2048, 513, 8),       # the LM slice: ragged width, 4-byte copies
    (50_000, 513, 512),   # many rows in flight
    (300, 36, 17),        # W % 4 == 0: 16-byte copies
    (64, 128, 5),
    (10, 1, 3),           # one-column rows
])
def test_gather_weight(card, n, w, m):
    g = torch.Generator(device=card).manual_seed(n + w)
    store = torch.randint(0, 200_064, (n, w), generator=g, device=card,
                          dtype=torch.int32)
    idx = torch.randint(0, n, (m,), generator=g, device=card)
    idx[: (m + 1) // 2] = idx[0]                  # duplicate ids
    probs = torch.rand((m,), generator=g, device=card) * 0.2
    probs[-1] = 0.0                               # below the floor
    if m > 2:
        probs[1] = float("nan")
    before = launches["gather_weight"]
    rows, wt = gather_weight_cuda(store, idx, probs, p_floor=1e-8)
    assert launches["gather_weight"] == before + 1
    want_rows, want_w = gather_weight_ref(store, idx, probs, p_floor=1e-8)
    np.testing.assert_array_equal(rows.cpu().numpy(), want_rows.cpu().numpy())
    # equal floats (NaN where p is NaN): bitwise up to the NaN payload
    np.testing.assert_array_equal(wt.cpu().numpy(), want_w.cpu().numpy())
    # and the plain version on the CPU agrees with the card's
    cpu_rows, cpu_w = gather_weight_ref(store.cpu(), idx.cpu(), probs.cpu(),
                                        p_floor=1e-8)
    np.testing.assert_array_equal(wt.cpu().numpy(), cpu_w.numpy())
    np.testing.assert_array_equal(rows.cpu().numpy(), cpu_rows.numpy())


def test_gather_weight_checks_inputs(card):
    store = torch.zeros((8, 5), dtype=torch.int32, device=card)
    idx = torch.zeros((2,), dtype=torch.int64, device=card)
    probs = torch.ones((2,), device=card)
    with pytest.raises(TypeError):
        gather_weight_cuda(store.long(), idx, probs, p_floor=1e-8)
    with pytest.raises(ValueError, match="contiguous"):
        gather_weight_cuda(store.T.contiguous().T, idx, probs, p_floor=1e-8)
    with pytest.raises(ValueError, match="differ"):
        gather_weight_cuda(store, idx, probs[:1], p_floor=1e-8)


def test_gather_weight_id_out_of_range_stops_the_kernel(card):
    """An id outside [0, N) trips the device-side assert (in a child
    process: the assert leaves that process's CUDA context unusable)."""
    code = (
        "import torch\n"
        "from repro_torch.kernels.gather_weight import gather_weight_cuda\n"
        "s = torch.zeros((16, 9), dtype=torch.int32, device='cuda')\n"
        "i = torch.tensor([3, 16], device='cuda')\n"
        "p = torch.ones(2, device='cuda')\n"
        "gather_weight_cuda(s, i, p, p_floor=1e-8)\n"
        "torch.cuda.synchronize()\n")
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "assert" in (out.stdout + out.stderr).lower()


def test_lgd_training_runs_the_kernels(card):
    """A SMOKE LGD training run on the card launches draw_assemble once
    per step (the standalone gather_weight never), the probe at least
    once per step and simhash at the build and at the refresh."""
    cfg, model = launch_train.load_model("phi4_mini_3_8b", False, card)
    for k in launches:
        launches[k] = 0
    sampler, _ = launch_train.make_batches(
        cfg, model, lgd=True, batch=8, seq=32, corpus=256, device=card,
        refresh_every=4)
    tr = launch_train.make_trainer(cfg, model, steps=6, lr=1e-3,
                                   sampler=sampler)
    losses = tr.run(6)["losses"]
    assert all(np.isfinite(losses)) and len(losses) == 6
    assert launches["draw_assemble"] == 6
    assert launches["gather_weight"] == 0
    assert launches["bucket_probe"] >= 6
    assert launches["simhash"] == 2


# -- draw_assemble: Algorithm 1 after the probe, in one launch ---------------

def _held(got, want, rtol=1e-4):
    """The kernel's (result, rows, w) against the plain composition's on
    the same card: integer fields and rows bitwise, p and w within rtol."""
    for key in ("indices", "n_probes", "bucket_sizes", "fallback",
                "probe_code"):
        assert torch.equal(getattr(got[0], key), getattr(want[0], key)), key
    torch.testing.assert_close(got[0].probs, want[0].probs, rtol=rtol,
                               atol=0)
    if want[1] is not None:
        assert torch.equal(got[1], want[1])
        torch.testing.assert_close(got[2], want[2], rtol=rtol, atol=0)


def _draw_twice(args):
    """The kernel twice (one launch each, the same bits) and the plain
    composition, on the same card tensors."""
    before = launches["draw_assemble"]
    got = draw_assemble(*args)
    assert launches["draw_assemble"] == before + 1
    again = draw_assemble(*args)
    for a, b in zip(list(got[0]) + list(got[1:]),
                    list(again[0]) + list(again[1:])):
        assert (a is None and b is None) or torch.equal(
            a.view(torch.int32) if a.dtype == torch.float32 else a,
            b.view(torch.int32) if b.dtype == torch.float32 else b)
    return got, draw_assemble_plain(*args)


@pytest.mark.parametrize("b", [1, 16])
@pytest.mark.parametrize("mp", [0, 2])
@pytest.mark.parametrize("family", ["quadratic", "srp", "mips"])
def test_draw_assemble(card, family, mp, b):
    """The LGD path's draw (d 91, L 100, K 5, P 200, m 16) on an index
    of 3,000 rows, kernel against plain composition on the card."""
    from repro_torch.core.sampler import _probe_bounds
    from repro_torch.data import make_regression
    from repro_torch.quickstart import make_problem

    g = torch.Generator(device=card).manual_seed(31)
    ds = make_regression(g, "yearmsd-like", n_train=3000, d=90,
                         noise="pareto", device=card)
    problem, _ = make_problem(family, mp, "sgd")
    _, _, x_aug = problem.preprocess(ds.x_train, ds.y_train)
    index = mutate_index(None, IndexMutation("build", generator=g,
                                             x_aug=x_aug), problem.lsh)
    theta = 0.1 * torch.randn((b, 90), generator=g, device=card)
    queries = problem.query_fn()(theta).contiguous()
    masks = probe_masks(problem.lsh.k, 1 + mp)
    lo, hi = _probe_bounds(index, queries, problem.lsh, masks)
    draws = draw_samples(g, (b, 16), 200, 100, 3000, card)
    got, want = _draw_twice((draws, lo, hi, index.order, x_aug, queries,
                             problem.lsh, 200, masks))
    assert got[1] is None and got[0].indices.shape == (b, 16)
    _held(got, want)


@pytest.mark.parametrize("width", [513, 512])
def test_draw_assemble_train_shape(card, width):
    """The train path's draw with its store: d 3,072, K 7, L 10, N 2,048,
    m 8; 4-byte row copies at W 513, 16-byte at 512."""
    from repro_torch.core.sampler import _probe_bounds

    x, w, _, q = _inputs(card, 8, 2048, 3072, 10, 7, 1)
    p = LSHParams(k=7, l=10, dim=3072, family="srp")
    index = mutate_index(None, IndexMutation("build", projections=w,
                                             x_aug=x), p)
    store = torch.randint(0, 200_064, (2048, width), device=card,
                          dtype=torch.int32)
    lo, hi = _probe_bounds(index, q, p, (0,))
    g = torch.Generator(device=card).manual_seed(2)
    draws = draw_samples(g, (1, 8), 20, 10, 2048, card)
    got, want = _draw_twice((draws, lo, hi, index.order, x, q, p, 20, (0,),
                             store, 1e-8))
    assert got[1].shape == (8, width)
    _held(got, want)


@pytest.mark.parametrize("name", ["all_empty", "last_round", "probe_2",
                                  "size_1", "u_top", "duplicates"])
def test_draw_assemble_edges(card, name):
    """tests/test_torch_draw.py's edge cases on the card: the kernel
    against the plain composition and against the numpy model of the
    kernel (integers bitwise, p and w within 1e-4)."""
    from test_torch_draw import _edge, _masks, model

    c, j, check = _edge(name)
    p = LSHParams(k=5, l=c["lo"].shape[2], dim=c["x"].shape[1],
                  family="dense")
    masks = _masks(5, j)
    dev = [torch.from_numpy(c[key]).to(card) for key in (
        "lo", "hi", "order", "x", "q", "store")]
    draws = c["draws"].to(card)
    got, want = _draw_twice((draws, *dev[:5], p,
                             draws.tables.shape[2], masks, dev[5], 0.5))
    _held(got, want)
    fields, rows, w = model(c["draws"], c["lo"], c["hi"], c["order"], c["x"],
                            c["q"], "angle", 5, masks, c["store"], 0.5)
    assert check(fields)
    for key, val in fields.items():
        if key != "probs":
            np.testing.assert_array_equal(
                getattr(got[0], key).cpu().numpy(), val)
    np.testing.assert_allclose(got[0].probs.cpu().numpy(), fields["probs"],
                               rtol=1e-4)
    np.testing.assert_array_equal(got[1].cpu().numpy(), rows)
    np.testing.assert_allclose(got[2].cpu().numpy(), w, rtol=1e-4)


def test_draw_assemble_does_not_spill(card):
    """Every draw_assemble instantiation of the build (4- and 16-byte row
    copies, flat and band mode) is spill-free."""
    from repro_torch.kernels import build

    build.library("gather_weight")
    use = {name: u for name, u in build.ptxas_usage(
        build.build_log("gather_weight")).items()
        if "draw_assemble_kernel" in name}
    assert len(use) == 4
    assert all(u["spill_stores"] == u["spill_loads"] == 0
               for u in use.values()), use


def test_draw_assemble_unknown_law_raises(card, monkeypatch):
    """A family whose collision law the kernel does not know raises on
    the card: no plain fallback."""
    import dataclasses

    from repro_torch.core import families

    fam = dataclasses.replace(families.get_family("srp"), name="odd",
                              cp_law="")
    monkeypatch.setitem(families.FAMILIES, "odd", fam)
    p = LSHParams(k=2, l=3, dim=4, family="odd")
    lo = torch.zeros((1, 1, 3), dtype=torch.int32, device=card)
    draws = SampleDraws(torch.zeros((1, 2, 8), dtype=torch.int64,
                                    device=card),
                        torch.zeros((1, 2), device=card),
                        torch.zeros((1, 2), dtype=torch.int64, device=card))
    with pytest.raises(ValueError, match="knows no collision law"):
        draw_assemble(draws, lo, lo, torch.zeros((3, 5), dtype=torch.int64,
                                                 device=card),
                      torch.ones((5, 4), device=card),
                      torch.ones((1, 4), device=card), p, 8, (0,))


def test_draw_assemble_id_out_of_range_stops_the_kernel(card):
    """A fallback id outside [0, N) trips the device-side assert (in a
    child process: the assert leaves its CUDA context unusable)."""
    code = (
        "import torch\n"
        "from repro_torch.kernels.gather_weight import draw_assemble_cuda\n"
        "c = 'cuda'\n"
        "lo = torch.zeros((1, 1, 3), dtype=torch.int32, device=c)\n"
        "draw_assemble_cuda(lo, lo, torch.zeros((3, 5), dtype=torch.int64,"
        " device=c), torch.ones((5, 4), device=c), torch.ones((1, 4),"
        " device=c), torch.zeros((1, 2, 8), dtype=torch.int64, device=c),"
        " torch.zeros((1, 2), device=c), torch.tensor([[1, 5]], device=c),"
        " (0,), k=2, law=0, p_fallback=0.2)\n"
        "torch.cuda.synchronize()\n")
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "assert" in (out.stdout + out.stderr).lower()


# -- the streaming slice: n_live, the sentinel tail, the async refresh -------

@pytest.mark.parametrize("j", [1, 3])
@pytest.mark.parametrize("n_live", [1, 37, 300])
def test_draw_assemble_live_prefix(card, n_live, j):
    """The live-prefix fallback (order[0, draw], p = 1/n_live, weights
    1/(p n_live)) on the card: against the plain composition and the
    numpy model of tests/test_torch_draw.py."""
    from test_torch_draw import _case, _live, _masks, model

    c = _live(_case(60 + n_live, b=3, m=6, j=j, p=30), n_live)
    p = LSHParams(k=5, l=c["lo"].shape[2], dim=c["x"].shape[1],
                  family="dense")
    masks = _masks(5, j)
    dev = [torch.from_numpy(c[key]).to(card) for key in (
        "lo", "hi", "order", "x", "q", "store")]
    draws = c["draws"].to(card)
    got, want = _draw_twice((draws, *dev[:5], p, draws.tables.shape[2],
                             masks, dev[5], 1e-8, n_live))
    _held(got, want)
    fields, rows, w = model(c["draws"], c["lo"], c["hi"], c["order"], c["x"],
                            c["q"], "angle", 5, masks, c["store"], 1e-8,
                            n_live)
    np.testing.assert_array_equal(got[0].indices.cpu().numpy(),
                                  fields["indices"])
    np.testing.assert_array_equal(got[1].cpu().numpy(), rows)
    np.testing.assert_allclose(got[2].cpu().numpy(), w, rtol=1e-4)
    assert bool(got[0].fallback.any())


@pytest.mark.parametrize("evicted", [2, 8])
def test_draw_assemble_streaming_train_shape(card, evicted):
    """The train shape (d 3,072, K 7, L 10, capacity 2,048, m 8, S+1 513)
    with 1/2 or 7/8 of the slots evicted and queries far from every live
    row, so most walks fall back to the live prefix."""
    from repro_torch.core import evict_rows
    from repro_torch.core.sampler import _probe_bounds

    x, w, _, _ = _inputs(card, 9, 2048, 3072, 10, 7, 1)
    p = LSHParams(k=7, l=10, dim=3072, family="srp")
    index = mutate_index(None, IndexMutation("build", projections=w,
                                             x_aug=x), p)
    g = torch.Generator(device=card).manual_seed(4)
    gone = torch.randperm(2048, generator=g, device=card)[
        :2048 - 2048 // evicted]
    index = evict_rows(index, gone)
    n_live = 2048 // evicted
    assert int((index.sorted_codes[:, n_live:] == 0xFFFFFFFF).sum()) == \
        10 * (2048 - n_live)
    q = -x[gone[:4]].contiguous()            # far from the live rows
    store = torch.randint(0, 200_064, (2048, 513), device=card,
                          dtype=torch.int32)
    lo, hi = _probe_bounds(index, q, p, (0,))
    draws = draw_samples(g, (4, 8), 20, 10, n_live, card)
    got, want = _draw_twice((draws, lo, hi, index.order, x, q, p, 20, (0,),
                             store, 1e-8, n_live))
    _held(got, want)
    live = torch.ones(2048, dtype=torch.bool, device=card)
    live[gone] = False
    assert bool(live[got[0].indices].all())
    assert float(got[0].fallback.float().mean()) > 0.5


def _toy_embed(card):
    g = torch.Generator().manual_seed(1)
    return torch.randint(-4, 5, (50, 16), generator=g).float()


def test_streaming_pipeline_card_matches_cpu(card):
    """A streaming, delta, async pipeline (window 100, lead 1) on the card
    and on the CPU with the same draws and drift masks injected, through
    appends past the window, an explicit evict and two delta refreshes:
    the index bitwise after each mutation, ids bitwise, weights rtol
    1e-5 (integer features: exact on both)."""
    from repro_torch.data import LSHPipelineConfig, LSHSampledPipeline

    emb = _toy_embed(card)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 50, (96, 9)).astype(np.int32)
    cfg = dict(k=4, l=8, minibatch=8, refresh_every=4, refresh_mode="delta",
               drift_frac=0.2, refresh_async=True, window=100)
    drift = lambda r, cap: torch.from_numpy(                      # noqa: E731
        np.random.default_rng(r).random(cap) < 0.2)
    pipes = {}
    for dev in ("cpu", card):
        params = {"embed": emb.to(dev), "q": torch.ones(16, device=dev)}
        pipes[dev] = LSHSampledPipeline(
            3, toks, lambda pr, c: pr["embed"][c].sum(1), lambda pr: pr["q"],
            LSHPipelineConfig(**cfg), params=params, device=dev,
            drift=drift, projections=None if dev == "cpu"
            else pipes["cpu"].index.projections.to(card))
    cpu, gpu = pipes["cpu"], pipes[card]

    def same_index():
        assert torch.equal(gpu.index.sorted_codes.cpu(),
                           cpu.index.sorted_codes)
        assert torch.equal(gpu.index.order.cpu(), cpu.index.order)

    same_index()
    g = torch.Generator().manual_seed(5)
    for step in range(10):
        if step in (2, 6):
            extra = rng.integers(0, 50, (8, 9)).astype(np.int32)
            for pp in (cpu, gpu):
                pp.append_rows(extra)
            same_index()
        if step == 5:
            gone = np.flatnonzero(cpu._live_np)[:6]
            for pp in (cpu, gpu):
                pp.evict_rows(gone)
            same_index()
        dr = draw_samples(g, (8,), 16, 8, cpu.n_live, "cpu")
        bc = cpu.next_batch(draws=dr)
        bg = gpu.next_batch(draws=dr.to(card))
        assert torch.equal(bg["example_ids"].cpu(), bc["example_ids"])
        torch.testing.assert_close(bg["loss_weights"].cpu(),
                                   bc["loss_weights"], rtol=1e-5, atol=0)
    for pp in (cpu, gpu):
        pp.finalize()
    same_index()
    assert gpu._refresh_count == cpu._refresh_count == 2
    assert all(r["ok"] for r in gpu.refresh_records())
    assert not gpu.health_summary()["transitions"]


def test_async_refresh_reads_the_launch_time_weights(card):
    """The weights change IN PLACE on the step's stream right after the
    launch (behind before_param_update): the refresh, on its own stream,
    still embeds the launch-time weights, bitwise."""
    from repro_torch.data import LSHPipelineConfig, LSHSampledPipeline

    g = torch.Generator(device=card).manual_seed(3)
    params = {"w": torch.randn((256,), generator=g, device=card),
              "q": torch.ones(256, device=card)}

    def heavy(pr, chunk):    # slow enough to overlap; elementwise, so exact
        h = torch.nn.functional.one_hot(chunk.long(), 256).float().sum(1)
        for _ in range(100):
            h = torch.tanh(h * pr["w"] + 0.5)
        return h

    toks = np.random.default_rng(1).integers(0, 256, (2048, 17)).astype(
        np.int32)
    pipe = LSHSampledPipeline(
        4, toks, heavy, lambda pr: pr["q"],
        LSHPipelineConfig(k=7, l=10, minibatch=8, refresh_every=3,
                          refresh_async=True), feature_batch=64,
        params=params, device=card)
    for _ in range(3):                       # the launch is at step 2
        pipe.next_batch()
    launch_time = {k: v.clone() for k, v in params.items()}
    pipe.before_param_update()
    params["w"].mul_(-1.5)                   # the in-place update
    pipe.next_batch()                        # the swap
    want, _ = pipe._compute_features_scaled(launch_time)
    assert torch.equal(pipe.features, want)
    rec = pipe.refresh_records()[0]
    assert rec["ok"] and rec["async"] and rec["device_ms"] > 0


# -- the banded slice: draw_assemble's band mode and the LSH decode head ------

@pytest.mark.parametrize("j", [1, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_draw_assemble_band_mode(card, seed, j):
    """The band mode (starts on the card, band_u and fallback_u, the law
    on d - 1 coordinates) against the plain composition with starts and
    the numpy model of tests/test_torch_draw.py: ids, walk results and
    rows bitwise, p and w within 1e-4; never a row of the empty band."""
    from test_torch_draw import _band_case, _masks, model

    c = _band_case(50 + seed, j=j, p=40, empty=0.8)
    p = LSHParams(k=5, l=c["lo"].shape[3], dim=c["x"].shape[1],
                  family="mips_banded")
    masks = _masks(5, j)
    dev = [torch.from_numpy(c[key]).to(card) for key in (
        "lo", "hi", "order", "x", "q", "store", "starts")]
    draws = c["draws"].to(card)
    got, want = _draw_twice((draws, *dev[:5], p, draws.tables.shape[2],
                             masks, dev[5], 1e-8, None, dev[6]))
    _held(got, want)
    fields, rows, w = model(c["draws"], c["lo"], c["hi"], c["order"], c["x"],
                            c["q"], "angle", 5, masks, c["store"], 1e-8,
                            starts=c["starts"], d_law=c["x"].shape[1] - 1)
    for key, val in fields.items():
        if key != "probs":
            np.testing.assert_array_equal(
                getattr(got[0], key).cpu().numpy(), val)
    np.testing.assert_allclose(got[0].probs.cpu().numpy(), fields["probs"],
                               rtol=1e-4)
    np.testing.assert_array_equal(got[1].cpu().numpy(), rows)
    s = c["starts"]
    assert not np.isin(got[0].indices.cpu().numpy(),
                       c["order"][0, s[3]:s[4]]).any()


def test_draw_assemble_flat_path_is_unchanged(card):
    """Without starts (nb 1) the kernel is the flat path: the law's
    d_law given as d or left out gives the same bits, and both the plain
    composition's integers."""
    from repro_torch.kernels.gather_weight import draw_assemble_cuda
    from test_torch_draw import _case

    c = _case(71, b=3, m=6, j=3, p=30, empty=0.7)
    dev = [torch.from_numpy(c[key]).to(card) for key in (
        "lo", "hi", "order", "x", "q")]
    draws = c["draws"].to(card)
    args = (*dev, draws.tables, draws.slot_u, draws.fallback, (0, 1, 1))
    kw = dict(k=5, law=0, p_fallback=1 / 300)
    a = draw_assemble_cuda(*args, **kw)
    b = draw_assemble_cuda(*args, d_law=c["x"].shape[1], **kw)
    for x, y in zip(a[:6], b[:6]):
        assert torch.equal(x.view(torch.int32) if x.dtype == torch.float32
                           else x, y.view(torch.int32)
                           if y.dtype == torch.float32 else y)
    with pytest.raises(ValueError, match="need starts"):
        draw_assemble_cuda(*args, band_u=draws.slot_u, **kw)


def _banded_problem(card):
    from repro_torch.data import make_regression
    from repro_torch.quickstart import make_problem

    g = torch.Generator(device=card).manual_seed(5)
    ds = make_regression(g, "yearmsd-like", n_train=3000, d=90,
                         noise="pareto", device=card)
    problem, opt = make_problem("mips_banded", 2, "sgd")
    state, xt, yt, xa = init(g, problem, ds.x_train, ds.y_train, opt)
    return g, problem, opt, state, xt, yt, xa


def test_banded_lgd_step_has_no_host_sync(card):
    """A banded LGD step on the card is one bucket_probe_codes launch
    (every band's probe codes) and one draw_assemble launch, and runs
    under torch.cuda.set_sync_debug_mode("error")."""
    g, problem, opt, state, xt, yt, xa = _banded_problem(card)
    state, _ = lgd_step(g, state, xt, yt, xa, problem, opt)   # warm-up
    torch.cuda.synchronize()
    before = dict(launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            state, _ = lgd_step(g, state, xt, yt, xa, problem, opt)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    ran = {k: launches[k] - before[k] for k in launches}
    assert ran["draw_assemble"] == 3 and ran["bucket_probe_codes"] == 3
    assert ran["bucket_probe"] == ran["bucket_probe_multi"] == 0
    assert bool(torch.isfinite(state.theta).all())


def test_banded_draw_matches_the_cpu(card):
    """The banded sample on the card against the CPU's plain path on the
    same index and draws: ids bitwise, p within 1e-4."""
    from repro_torch.core import LSHIndex, sample_batched

    g, problem, _, state, _, _, xa = _banded_problem(card)
    q = problem.query_fn()(0.1 * torch.randn(
        (4, 90), generator=g, device=card)).contiguous()
    dr = draw_samples(torch.Generator().manual_seed(1), (4, 16), 200, 100,
                      3000, "cpu", bands=True)
    got = sample_batched(None, state.index, xa, q, problem.lsh, m=16,
                         multiprobe=2, draws=dr.to(card))
    idx_c = LSHIndex(*(x.cpu() for x in state.index))
    want = sample_batched(None, idx_c, xa.cpu(), q.cpu(), problem.lsh, m=16,
                          multiprobe=2, draws=dr)
    for key in ("indices", "n_probes", "bucket_sizes", "fallback",
                "probe_code"):
        assert torch.equal(getattr(got, key).cpu(), getattr(want, key)), key
    torch.testing.assert_close(got.probs.cpu(), want.probs, rtol=1e-4,
                               atol=0)


def test_lsh_decode_step_has_no_host_sync(card):
    """SMOKE serving with the LSH head on the card: the index built by
    simhash, every token one bucket_probe_codes launch, the tokens the
    masked argmax over their own candidates, no host sync in a step."""
    from repro_torch import serve
    from repro_torch.models import lsh_decode_step
    from repro_torch.models.sampled_softmax import (
        shortlist_candidates, shortlist_logits)

    cfg, lm = serve.load_model("phi4_mini_3_8b", device=card)
    before = launches["simhash"]
    head, _ = serve.build_head(lm)
    assert launches["simhash"] == before + 1
    prompts = serve.make_prompts(cfg, 2, 16, card)
    with torch.inference_mode():
        cache = lm.init_cache(2, 24)
        h, cache = lm.prefill({"tokens": prompts}, cache)
        tok = prompts[:, -1:]
        step = {"tokens": tok, "positions": torch.full(
            (2, 1), 16, dtype=torch.int32, device=card)}
        lsh_decode_step(lm, step, cache, head)
        torch.cuda.synchronize()
        probes = launches["bucket_probe_codes"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            for i in range(3):
                step = {"tokens": tok, "positions": torch.full(
                    (2, 1), 17 + i, dtype=torch.int32, device=card)}
                h, cache = lm.decode_hidden(step, cache)
                tok = serve.lsh_head_tokens(lm, h, head)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert launches["bucket_probe_codes"] == probes + 3
        q = lm.embed_group.final_norm(h)[:, 0].float()
        ids, valid = shortlist_candidates(
            head.index, head._fam.augment_query(q), head.lsh, head.scfg)
        lg = shortlist_logits(lm.embed_group.lm_head.T, q, ids, valid)
        want = torch.gather(ids, 1, lg.argmax(-1)[:, None])
    assert torch.equal(tok, want)
    assert bool(((tok >= 0) & (tok < cfg.vocab)).all())


def test_serve_lsh_head_on_the_card(card, capsys):
    from repro_torch import serve

    out = serve.main(["--head", "lsh", "--batch", "2", "--prompt-len", "16",
                      "--new-tokens", "4"])
    text = capsys.readouterr().out
    assert "head=lsh:" in text and "decode head=lsh" in text
    toks = out["tokens"]
    assert toks.shape == (2, 5) and toks.is_cuda
    assert bool(((toks >= 0) & (toks < 128)).all())


# the attention shapes of the archs that run the flash kernels beside
# phi4-mini's: (Hkv, G, D) of zamba2's shared block and musicgen, qwen3,
# llama4 and llama-3.2-vision
NEW_ARCH_HEADS = [(32, 1, 64), (4, 16, 64), (8, 5, 128), (8, 8, 128)]
FLASH_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
             torch.bfloat16: dict(rtol=2 ** -6, atol=1e-4)}


@pytest.mark.parametrize("hkv,g,d", NEW_ARCH_HEADS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_at_new_arch_heads(card, hkv, g, d, dtype):
    """flash_attention (causal, S 300: ragged tiles) and flash_decode
    (mixed kv_len over a 520-row cache) against their plain versions at
    the new archs' head shapes, one launch each."""
    from repro_torch.kernels.flash_attention import (
        attention_ref, decode_ref, flash_attention_cuda, flash_decode_cuda)

    gen = torch.Generator(device=card).manual_seed(hkv * g + d)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=card).to(dtype)

    q, k, v = randn(2, hkv, g, 300, d), randn(2, hkv, 300, d), randn(
        2, hkv, 300, d)
    before = dict(launches)
    got = flash_attention_cuda(q, k, v, causal=True)
    torch.testing.assert_close(got.float(),
                               attention_ref(q, k, v).float(),
                               **FLASH_TOL[dtype])
    q, k, v = randn(4, hkv, g, d), randn(4, hkv, 520, d), randn(4, hkv, 520,
                                                               d)
    kv_len = torch.tensor([1, 77, 512, 520], dtype=torch.int32, device=card)
    got = flash_decode_cuda(q, k, v, kv_len)
    torch.testing.assert_close(got.float(),
                               decode_ref(q, k, v, kv_len).float(),
                               **FLASH_TOL[dtype])
    assert launches["flash_attention"] == before["flash_attention"] + 1
    assert launches["flash_decode"] == before["flash_decode"] + 1


@pytest.mark.parametrize("arch", ["zamba2_1_2b", "xlstm_350m",
                                  "musicgen_large", "qwen3_moe_235b_a22b",
                                  "llama4_maverick_400b_a17b",
                                  "llama_3_2_vision_90b"])
def test_other_archs_card_match_cpu(card, arch):
    """Each new SMOKE arch (f32) with the same weights: prefill of 2 x 20
    then 3 teacher-forced decode steps, the card (kernels) against the
    CPU (plain versions), logits within 1e-4; the flash kernels ran once
    a self-attention layer a call."""
    from repro_torch import configs, serve
    from repro_torch.models import LM

    cfg = configs.get_smoke(arch).with_(attn_impl="pallas")
    lm_cpu = LM.init(cfg, seed=0, device="cpu")
    lm_gpu = LM(cfg, device=card)
    lm_gpu.load_state_dict(lm_cpu.state_dict())
    batch = serve.make_inputs(cfg, 2, 23, "cpu", seed=1)
    out = {}
    before = dict(launches)
    for name, lm in (("cpu", lm_cpu), ("cuda", lm_gpu)):
        dev = lm.device
        full = {k: v.to(dev) for k, v in batch.items()}
        prompt = {k: v if k == "image_embeds" else v[:, :20]
                  for k, v in full.items()}
        cache = lm.init_cache(2, 23)
        h, cache = lm.prefill(prompt, cache)
        got = [lm.embed_group.lm_logits(h[:, -1:])[:, 0]]
        for i in range(20, 23):
            step = {k: v if k == "image_embeds" else v[:, i:i + 1]
                    for k, v in full.items()}
            step["positions"] = torch.full((2, 1), i, device=dev)
            lg, cache = lm.decode_step(step, cache)
            got.append(lg[:, 0])
        out[name] = torch.stack(got).cpu()
    n_attn = sum(k in ("attn", "cross_attn", "shared_attn")
                 for k in lm_gpu.kinds)
    assert launches["flash_attention"] == before["flash_attention"] + n_attn
    assert launches["flash_decode"] == before["flash_decode"] + 3 * n_attn
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-4, atol=1e-4)
