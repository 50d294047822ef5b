"""Parity of the port's kernel modules with the JAX package's.

On the CPU each port wrapper runs its plain PyTorch version; it is held
against the JAX kernel run in Pallas interpret mode and against the
JAX plain version, on the same numpy inputs.  lo/hi must be bitwise
equal; codes bitwise except bits whose projection is within 1e-4 of
zero (the two packages sum in different orders).

The CUDA kernels themselves are tested on a card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from _torch_parity import assert_codes_match, n, t
from repro.kernels.bucket_probe import ops as jbp
from repro.kernels.simhash import ops as jsh
from repro_torch.kernels import build, launches, on_cuda, round_up
from repro_torch.kernels.bucket_probe import kernel as bp_kernel
from repro_torch.kernels.bucket_probe import (
    bucket_probe,
    bucket_probe_codes,
    bucket_probe_codes_cuda,
    bucket_probe_multi,
    bucket_probe_multi_ref,
)
from repro_torch.kernels.simhash import (
    simhash_codes,
    simhash_codes_cuda,
    simhash_codes_ref,
)
from repro_torch.core.simhash import probe_masks


def _index_inputs(seed, n_pts, d, l, k, b):
    """Skewed points (so buckets are populated), projections, sorted
    codes of the reference and a query batch — all numpy."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n_pts, d)) +
         np.linspace(0, 2, d)).astype(np.float32)
    w = rng.standard_normal((d, l * k)).astype(np.float32)
    codes = np.asarray(jsh.simhash_codes(x, w, k=k, l=l, use_pallas=False))
    sc = np.sort(codes.T, axis=1)
    q = (rng.standard_normal((b, d)) + np.linspace(0, 2, d)).astype(
        np.float32)
    return x, w, sc, q


def _query_near(q, w, b, j, l, k):
    """(B, J, L) mask of tables whose query projection is near zero."""
    proj = np.asarray(q, np.float64) @ np.asarray(w, np.float64)
    near = (np.abs(proj) < 1e-4).reshape(b, 1, l, k).any(-1)
    return np.broadcast_to(near, (b, j, l))


class TestSimhash:
    @pytest.mark.parametrize("n_pts,d,k,l", [
        (300, 24, 5, 16),     # padding on both axes of the TPU kernel
        (64, 20, 32, 2),      # max K
        (8, 16, 1, 1),        # degenerate
    ])
    def test_matches_jax_kernel_and_ref(self, n_pts, d, k, l):
        rng = np.random.default_rng(n_pts * d)
        x = rng.standard_normal((n_pts, d)).astype(np.float32)
        w = rng.standard_normal((d, l * k)).astype(np.float32)
        got = simhash_codes(t(x), t(w), k=k, l=l)
        assert got.dtype == torch.int64 and got.shape == (n_pts, l)
        proj = x @ w
        for want in (jsh.simhash_codes(x, w, k=k, l=l, use_pallas=True,
                                       interpret=True),
                     jsh.simhash_codes(x, w, k=k, l=l, use_pallas=False)):
            assert_codes_match(got, want, proj, k)
        np.testing.assert_array_equal(
            n(got), n(simhash_codes_ref(t(x), t(w), k=k, l=l)))

    def test_rejects_bad_projection_shape(self):
        with pytest.raises(ValueError, match="projections"):
            simhash_codes(torch.zeros(4, 3), torch.zeros(3, 7), k=2, l=4)


class TestBucketProbe:
    N, D, L, K = 700, 12, 16, 3

    @pytest.mark.parametrize("b", [1, 5])
    def test_fused_matches_jax(self, b):
        x, w, sc, q = _index_inputs(1, self.N, self.D, self.L, self.K, b)
        lo, hi = bucket_probe(t(q), t(w), t(sc), k=self.K, l=self.L)
        jlo, jhi = jbp.bucket_probe(q, w, sc, k=self.K, l=self.L,
                                    use_pallas=True, interpret=True)
        keep = ~_query_near(q, w, b, 1, self.L, self.K)[:, 0]
        assert lo.dtype == torch.int32 and lo.shape == (b, self.L)
        np.testing.assert_array_equal(n(lo)[keep], n(jlo)[keep])
        np.testing.assert_array_equal(n(hi)[keep], n(jhi)[keep])
        assert (n(hi) - n(lo)).sum() > 0, "no populated bucket probed"

    @pytest.mark.parametrize("b,j", [(1, 3), (4, 7)])
    def test_multi_matches_jax(self, b, j):
        x, w, sc, q = _index_inputs(2, self.N, self.D, self.L, self.K, b)
        masks = probe_masks(self.K, j)
        lo, hi = bucket_probe_multi(t(q), t(w), t(sc), masks, k=self.K,
                                    l=self.L)
        jlo, jhi = jbp.bucket_probe_multi(q, w, sc, masks, k=self.K,
                                          l=self.L, use_pallas=True,
                                          interpret=True)
        keep = ~_query_near(q, w, b, j, self.L, self.K)
        assert lo.shape == (b, j, self.L)
        np.testing.assert_array_equal(n(lo)[keep], n(jlo)[keep])
        np.testing.assert_array_equal(n(hi)[keep], n(jhi)[keep])
        np.testing.assert_array_equal(
            n(lo), n(bucket_probe_multi_ref(t(q), t(w), t(sc), masks,
                                            k=self.K, l=self.L)[0]))

    @pytest.mark.parametrize("b", [1, 6])
    def test_codes_matches_jax_bitwise(self, b):
        _, _, sc, _ = _index_inputs(3, self.N, self.D, self.L, self.K, 1)
        rng = np.random.default_rng(b)
        qc = rng.integers(0, 2 ** self.K + 1, (b, self.L)).astype(np.uint32)
        lo, hi = bucket_probe_codes(t(qc), t(sc))
        jlo, jhi = jbp.bucket_probe_codes(qc, sc, use_pallas=True,
                                          interpret=True)
        np.testing.assert_array_equal(n(lo), n(jlo))
        np.testing.assert_array_equal(n(hi), n(jhi))

    def test_single_query_drops_batch_axis(self):
        _, w, sc, q = _index_inputs(4, 50, self.D, self.L, self.K, 1)
        lo, hi = bucket_probe(t(q[0]), t(w), t(sc), k=self.K, l=self.L)
        assert lo.shape == (self.L,)
        lo2, _ = bucket_probe_multi(t(q[0]), t(w), t(sc), (0, 1), k=self.K,
                                    l=self.L)
        assert lo2.shape == (2, self.L)
        np.testing.assert_array_equal(n(lo2[0]), n(lo))

    def test_sentinel_sorts_last(self):
        """int64 codes: EMPTY_CODE slots never fall in a live bucket."""
        sc = np.sort(np.array([[0, 1, 1, 0xFFFFFFFF, 0xFFFFFFFF]],
                              np.uint32), axis=1)
        lo, hi = bucket_probe_codes(t(np.array([[1, 31]], np.uint32)).T,
                                    t(sc))
        np.testing.assert_array_equal(n(lo)[:, 0], [1, 3])
        np.testing.assert_array_equal(n(hi)[:, 0], [3, 3])


class TestProbePlan:
    """The hashed probe's launch plan (``probe_plan``), which the CUDA
    launcher checks: whole tables of at most 256 columns a block, the
    fewest of 1, 2, 4, 8 that keeps the launch within 2 blocks an SM of
    an H100 (132); one block sums all features up to 128 (the simhash
    kernel's order), else parts of 64."""

    @pytest.mark.parametrize("b,d,l,k,plan", [
        (1, 91, 100, 5, (1, 1)),        # the LGD query: 100 blocks
        (16, 91, 100, 5, (8, 1)),       # 208 blocks
        (1, 3072, 10, 7, (2, 48)),      # the train path's query: 240
        (16, 3072, 10, 7, (8, 48)),     # past the aim: the most tables
        (4, 128, 100, 5, (2, 1)),
        (1, 129, 10, 7, (1, 3)),
        (16, 40, 4, 32, (1, 1)),        # K 32, 64 blocks
        (200, 40, 4, 32, (4, 1)),       # L caps the group
        (200, 40, 16, 32, (8, 1)),      # K 32: 256 columns cap it
        (64, 40, 16, 32, (4, 1)),       # 256 blocks
        (200, 5, 3, 1, (3, 1)),
        (1, 0, 2, 3, (1, 1)),
    ])
    def test_plan(self, b, d, l, k, plan):
        tables, parts = bp_kernel.probe_plan(b, d, l, k, 132)
        assert (tables, parts) == plan
        assert tables * k <= bp_kernel.THREADS
        assert (parts - 1) * bp_kernel.FEAT_PART < d <= max(
            parts * bp_kernel.FEAT_PART, bp_kernel.FEAT_ONE) or d == 0

    def test_mask_tuples_are_built_once(self):
        masks = probe_masks(5, 3)
        assert bp_kernel._host_masks(masks) is bp_kernel._host_masks(
            tuple(masks))
        big = probe_masks(32, 529)
        assert len(big) == bp_kernel.MAX_MASKS
        np.testing.assert_array_equal(np.array(bp_kernel._host_masks(big)),
                                      np.array(big, np.uint32))


class TestDispatch:
    def test_round_up(self):
        assert [round_up(a, 8) for a in (0, 1, 8, 9)] == [0, 8, 8, 16]

    def test_other_devices_raise(self):
        with pytest.raises(ValueError, match="unsupported device"):
            on_cuda(torch.empty(2, device="meta"))

    def test_kernel_wrappers_refuse_cpu_tensors(self):
        """A wrapper launches its kernel or raises — never runs on."""
        x = torch.zeros(4, 3)
        before = dict(launches)
        with pytest.raises(ValueError, match="CUDA tensor"):
            simhash_codes_cuda(x, torch.zeros(3, 4), k=2, l=2)
        with pytest.raises(ValueError, match="CUDA tensor"):
            bucket_probe_codes_cuda(torch.zeros(1, 2, dtype=torch.int64),
                                    torch.zeros(2, 5, dtype=torch.int64))
        assert launches == before


class TestBuild:
    def test_ptxas_usage_reads_each_kernel(self):
        """The -Xptxas -v lines of a build log, per kernel (nvcc's format;
        the log is made on a card's machine, so a sample stands in)."""
        log = "\n".join([
            "ptxas info    : 0 bytes gmem",
            "ptxas info    : Compiling entry function '_Z1aPf' for 'sm_90a'",
            "ptxas info    : Function properties for _Z1aPf",
            "    8 bytes stack frame, 4 bytes spill stores, "
            "12 bytes spill loads",
            "ptxas info    : Used 255 registers, used 1 barriers, "
            "1024 bytes smem, 400 bytes cmem[0]",
            "ptxas info    : Compiling entry function '_Z1bPf' for 'sm_90a'",
            "ptxas info    : Function properties for _Z1bPf",
            "    0 bytes stack frame, 0 bytes spill stores, "
            "0 bytes spill loads",
            "ptxas info    : Used 168 registers, used 1 barriers, "
            "400 bytes cmem[0]",
        ])
        assert build.ptxas_usage(log) == {
            "_Z1aPf": dict(registers=255, spill_stores=4, spill_loads=12,
                           stack=8, smem=1024),
            "_Z1bPf": dict(registers=168, spill_stores=0, spill_loads=0,
                           stack=0, smem=0),
        }
        assert build.ptxas_usage("") == {}

    def test_a_variant_builds_apart(self):
        """A source built with extra -D flags gets a directory of its
        own, so the default library is never replaced by a variant."""
        compact = ("-DPROBE_MASK_SLOTS=16",)
        assert build._build_dir(compact) != build._build_dir()
        assert build._build_dir(compact) == build._build_dir(compact)
