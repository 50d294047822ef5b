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
from repro_torch.kernels.simhash import kernel as sh_kernel
from repro_torch.kernels.simhash.ref import pack_bits
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


class TestSimhashPlan:
    """The SimHash launch plan (``simhash_plan``), which the CUDA launcher
    checks: whole tables of at most 128 columns a block, one sum up to 128
    features and parts of 64 above (at most 64 rows a block, or 128 in
    the narrow layout), at least 2 blocks an SM of an H100 (132) where N
    allows, a split over the blocks of a row tile only as wide as keeps
    every block resident (2 an SM), in the narrow 72-column layout where
    the group fits it, and part sums through scratch only within the
    cap."""

    SMS = 132

    @pytest.mark.parametrize("n,d,l,k,plan,pad", [
        # the LGD build: 4 groups of 25 tables, 14,492 blocks
        (463_715, 91, 100, 5, (128, 25, 125, 4, 1, 1, 3623, False),
         12 / 512),
        # the train path: 16 row tiles x 16 blocks of 3 parts, narrow
        (2048, 3072, 10, 7, (128, 10, 70, 1, 48, 16, 16, True), 2 / 72),
        (2048, 128, 10, 7, (32, 10, 70, 1, 1, 1, 64, False), 58 / 128),
        # past one part: 32-row tiles give twice the blocks of narrow's 64
        (2048, 129, 10, 7, (32, 10, 70, 1, 3, 2, 64, False), 58 / 128),
        (777, 40, 7, 32, (32, 4, 128, 2, 1, 1, 25, False), 32 / 256),  # K 32
        (100_000, 91, 200, 1, (128, 128, 128, 2, 1, 1, 782, False),
         56 / 256),
        (1, 91, 100, 5, (32, 25, 125, 4, 1, 1, 1, False), 12 / 512),  # N 1
        (1, 3072, 10, 7, (128, 10, 70, 1, 48, 16, 1, True), 2 / 72),
        (1000, 91, 100, 5, (32, 25, 125, 4, 1, 1, 32, False),
         12 / 512),  # ragged
        (600, 3072, 10, 7, (64, 10, 70, 1, 48, 16, 10, True), 2 / 72),
        (100_000, 3072, 10, 7, (64, 10, 70, 1, 48, 1, 1563, False),
         58 / 128),
        (700, 300, 10, 7, (32, 10, 70, 1, 5, 4, 22, False), 58 / 128),
        (800, 3072, 2, 32, (64, 2, 64, 1, 48, 16, 13, True), 8 / 72),
        # a split would take 645 MB of part sums: parts in registers
        (4000, 20_000, 10, 7, (32, 10, 70, 1, 313, 1, 125, False),
         58 / 128),
    ])
    def test_plan(self, n, d, l, k, plan, pad):
        p = sh_kernel.simhash_plan(n, d, l, k, self.SMS)
        assert tuple(p) == plan
        # whole tables, the fewest groups
        assert p.cols == p.tables * k <= sh_kernel.COLS
        assert (p.groups - 1) * p.tables < l <= p.groups * p.tables
        assert p.tables == min(l, sh_kernel.COLS // k)
        assert p.parts == (1 if d <= 128 else -(-d // 64))
        if p.narrow:
            assert p.split and p.cols <= sh_kernel.NARROW_COLS
            assert p.bm in sh_kernel.NARROW_ROWS
        else:
            assert p.bm in sh_kernel.ROWS and (p.parts == 1 or p.bm <= 64)
        assert p.tiles == -(-n // p.bm) and (p.tiles - 1) * p.bm < n
        # a split: a power of 2 of at most 16 blocks a tile, every block
        # resident, each with its parts, the sums within the cap
        assert p.ranks & (p.ranks - 1) == 0 and p.ranks <= min(16, p.parts)
        assert p.split == (p.ranks > 1) == (p.scratch_floats > 0)
        if p.split:   # (a last rank may get no part)
            assert p.blocks <= 2 * self.SMS
            assert p.pg == -(-p.parts // p.ranks)
        assert p.scratch_floats * 4 <= sh_kernel.SCRATCH_CAP
        # 2 blocks an SM where the row tiles allow it (the split cases
        # fill the card as residency allows: the test below)
        if -(-n // 32) * p.groups >= 2 * self.SMS:
            assert p.blocks >= 2 * self.SMS
        # the share of computed columns that are padding
        width = sh_kernel.NARROW_COLS if p.narrow else sh_kernel.COLS
        assert (p.groups * width - l * k) / (p.groups * width) == \
            pytest.approx(pad)

    def test_train_shape_fills_the_card_in_one_wave(self):
        p = sh_kernel.simhash_plan(2048, 3072, 10, 7, self.SMS)
        assert 1.9 * self.SMS <= p.blocks <= 2 * self.SMS

    @pytest.mark.parametrize("l,k", [(100, 5), (10, 7), (7, 32), (3, 1),
                                     (200, 1)])
    def test_padded_projections(self, l, k):
        """w laid out for 16-byte copies: group g's columns at g * 128."""
        d = 6
        w = torch.arange(d * l * k, dtype=torch.float32).reshape(d, l * k)
        p = sh_kernel.simhash_plan(100, d, l, k, self.SMS)
        wp = sh_kernel.padded_projections(w, p)
        assert wp.shape == (d, p.groups * sh_kernel.COLS)
        assert wp.is_contiguous()
        for g in range(p.groups):
            c = w[:, g * p.cols:(g + 1) * p.cols]
            assert torch.equal(wp[:, g * 128:g * 128 + c.shape[1]], c)

    def test_narrow_plan_reads_w_as_given(self):
        """The narrow layout copies w 4 bytes at a time: no padded copy."""
        w = torch.zeros((3072, 70))
        p = sh_kernel.simhash_plan(2048, 3072, 10, 7, self.SMS)
        assert p.narrow
        assert sh_kernel.padded_projections(w, p) is w


def _epilogue_codes(signs: np.ndarray, k: int, ntab: int) -> np.ndarray:
    """The kernel's epilogue on a block's (rows, 128) signs: byte ct of a
    row holds columns 8ct..8ct+7 (bit j is column 8ct + j); its 16 bytes
    and a zero word are five little-endian 32-bit words; a table's K bits
    are the 64 bits of words cb >> 5 and (cb >> 5) + 1 shifted right by
    cb & 31, cb = table * K.  -> (ntab, rows) codes."""
    rows = signs.shape[0]
    sb = np.zeros((rows, 20), np.uint8)
    for ct in range(16):
        sb[:, ct] = (signs[:, 8 * ct:8 * ct + 8].astype(np.uint64)
                     << np.arange(8, dtype=np.uint64)).sum(1)
    words = sb.view("<u4").astype(np.uint64)                  # (rows, 5)
    codes = np.zeros((ntab, rows), np.int64)
    for tl in range(ntab):
        cb = tl * k
        both = words[:, cb >> 5] | (words[:, (cb >> 5) + 1] << np.uint64(32))
        codes[tl] = (both >> np.uint64(cb & 31)) & np.uint64((1 << k) - 1)
    return codes


# the CUDA source's column layouts (struct Cols): column warps, columns a
# thread, their floats in shared w
_WIDE, _NARROW = (4, 8, 8), (2, 9, 12)


def _thread_columns(layout, ct):
    """Columns of column thread ct: wide ct * 8 + j, narrow ct + 8 j."""
    cw, tn, _ = layout
    return ([ct + 4 * cw * j for j in range(tn)] if layout == _NARROW
            else [ct * tn + j for j in range(tn)])


class TestSimhashEpilogue:
    """Pure-Python models of the CUDA kernel's index arithmetic."""

    @pytest.mark.parametrize("k", [1, 5, 7, 32])
    def test_bit_mapping_matches_pack_bits(self, k):
        ntab = 128 // k
        rng = np.random.default_rng(k)
        signs = rng.random((64, 128)) < 0.5   # padding columns: any bits
        got = _epilogue_codes(signs, k, ntab)
        want = pack_bits(torch.from_numpy(signs[:, :ntab * k]).reshape(
            64, ntab, k), k).T.numpy()
        np.testing.assert_array_equal(got, want)
        straddle = [t for t in range(ntab) if (t * k) % 32 + k > 32]
        assert bool(straddle) == (k in (5, 7))
        # a group of fewer tables reads the same bits
        np.testing.assert_array_equal(_epilogue_codes(signs, k, 3),
                                      want[:3])

    @pytest.mark.parametrize("layout,tm", [(_WIDE, 8), (_WIDE, 4),
                                           (_WIDE, 2), (_NARROW, 4),
                                           (_NARROW, 2)])
    def test_thread_tiles_cover_the_block_once(self, layout, tm):
        """Warp w, lane -> rows rt*TM + i, a thread's columns: every (row,
        column) of a block once.  Wide: 16 x TM rows x 128 columns, a warp
        on 32 contiguous columns, so a group of 70 columns leaves 2 of the
        8 warps idle; narrow: 32 x TM rows x 72 columns, a warp's columns
        spread over all 72, so every warp computes."""
        cw, tn, _ = layout
        rt_count, cols = 256 // (4 * cw), 4 * cw * tn
        seen = np.zeros((rt_count * tm, cols), int)
        live = 0
        for warp in range(8):
            mine = set()
            for lane in range(32):
                rt = warp // cw * 8 + (lane >> 2)
                ct = warp % cw * 4 + (lane & 3)
                for c in _thread_columns(layout, ct):
                    seen[rt * tm:(rt + 1) * tm, c] += 1
                    mine.add(c)
            live += min(mine) < 70
        assert (seen == 1).all()
        assert live == (8 if layout == _NARROW else 6)

    @pytest.mark.parametrize("rows", [128, 64, 32])
    def test_staging_map(self, rows):
        """4-byte copy e -> (feature f, row r) of a chunk of x: every
        element once, and each warp's 32 copies hit 32 distinct banks of
        the feature-major tile (row stride rows + 4 floats)."""
        depth = 32
        xs, groups = rows + 4, depth // 8
        hit = np.zeros((depth, rows), int)
        for e0 in range(0, rows * depth, 32):
            banks = set()
            for e in range(e0, e0 + 32):
                f = (e // 32) % groups * 8 + (e & 7)
                r = e // (32 * groups) * 4 + ((e >> 3) & 3)
                hit[f, r] += 1
                banks.add((f * xs + r) % 32)
            assert len(banks) == 32
        assert (hit == 1).all()

    def test_narrow_w_staging_map(self):
        """The narrow layout's 4-byte copies of w: thread tid < 216 copies
        column c = tid % 72 of features tid / 72 + 3 i, to c % 8 * 12 + c / 8
        of the 96-float shared row, so thread ct's columns ct + 8 j are
        floats [ct * 12, + 9) (16-byte aligned: 3 loads); every (feature,
        column) once, and a warp's 32 copies of one step on 32 distinct
        banks where they share a feature row."""
        cw, tn, sn = _NARROW
        ct_count, depth = 4 * cw, 32
        cols, ws = ct_count * tn, ct_count * sn
        span = 256 // cols
        slot = np.full((depth, ws), -1)
        for tid in range(span * cols):
            c, fs = tid % cols, tid // cols
            for f in range(fs, depth, span):
                dst = c % ct_count * sn + c // ct_count
                assert slot[f, dst] == -1
                slot[f, dst] = c
        for w0 in range(0, span * cols, 32):
            for i in range(depth // span):
                hits = [(tid // cols + span * i) * ws
                        + tid % cols % ct_count * sn
                        + tid % cols // ct_count
                        for tid in range(w0, min(w0 + 32, span * cols))]
                rows_ = {h // ws for h in hits}
                if len(rows_) == 1:
                    assert len({h % 32 for h in hits}) == len(hits)
        assert (slot[:, [c % ct_count * sn + c // ct_count
                         for c in range(cols)]] >= 0).all()
        for ct in range(ct_count):
            assert ct * sn % 4 == 0
            assert list(slot[0, ct * sn:ct * sn + tn]) == \
                _thread_columns(_NARROW, ct)
        assert (slot[:, [ct * sn + j for ct in range(ct_count)
                         for j in range(tn, sn)]] == -1).all()

    @pytest.mark.parametrize("tm,row_threads", [(4, 16), (2, 16), (4, 32),
                                                (2, 32)])
    def test_row_major_x(self, tm, row_threads):
        """16-byte copies of x (row stride 36 floats): every piece once, and
        a warp's 8 row threads (rows rt + RT i, rt consecutive) read 16
        bytes each from 8 distinct 4-bank groups."""
        rows, depth = row_threads * tm, 32
        hit = np.zeros((rows, depth // 4), int)
        for e in range(rows * depth // 4):
            hit[e // (depth // 4), e % (depth // 4)] += 1
        assert (hit == 1).all()
        for i in range(tm):
            for r0 in range(0, row_threads, 8):
                groups = {((r + row_threads * i) * (depth + 4) // 4) % 8
                          for r in range(r0, r0 + 8)}
                assert len(groups) == 8


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

    def test_simhash_usage_reads_each_instantiation(self):
        """chip_smoke.py's labels of the simhash kernel's instantiations
        (rows, sum mode, x layout, column layout) from the -Xptxas -v
        lines."""
        import importlib.util
        import os
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), "chip_smoke.py"))
        cs = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(cs)
        pre = "_ZN43_GLOBAL__N__2ea0_10_simhash_cu_27bd0fb114simhash_kernelI"
        names = {
            pre + "Li8ELNS_4ModeE0ELb0ELb0EEEvNS_6ParamsE": "128 rows, one",
            pre + "Li4ELNS_4ModeE2ELb1ELb0EEEvNS_6ParamsE":
                "64 rows, split_parts, 16-byte x",
            pre + "Li2ELNS_4ModeE1ELb0ELb0EEEvNS_6ParamsE":
                "32 rows, reg_parts",
            pre + "Li4ELNS_4ModeE2ELb1ELb1EEEvNS_6ParamsE":
                "128 rows, split_parts, 16-byte x, narrow",
        }
        log = "\n".join(
            f"ptxas info    : Compiling entry function '{m}' for 'sm_90a'\n"
            f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
            f"loads\nptxas info    : Used {100 + i} registers, used 1 "
            f"barriers" for i, m in enumerate(names))

        class Log:
            ptxas_usage = staticmethod(build.ptxas_usage)

            @staticmethod
            def build_log(name):
                return log if name == "simhash" else ""

        use = cs.simhash_usage(Log)
        assert set(use) == set(names.values())
        assert use["64 rows, split_parts, 16-byte x"] == dict(
            regs=101, spill=0, smem=0)
        assert cs.simhash_label(dict(rows=128, mode="split_parts", x16=True,
                                     narrow=True)) == \
            "128 rows, split_parts, 16-byte x, narrow"

    def test_a_variant_builds_apart(self):
        """A source built with extra -D flags gets a directory of its
        own, so the default library is never replaced by a variant."""
        compact = ("-DPROBE_MASK_SLOTS=16",)
        assert build._build_dir(compact) != build._build_dir()
        assert build._build_dir(compact) == build._build_dir(compact)
