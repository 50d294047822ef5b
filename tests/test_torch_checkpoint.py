"""The port's checkpoints and fault-tolerant trainer against the JAX package,
on the CPU.

* Every case of ``tests/test_checkpoint_integrity.py``, against the
  port's ``train.checkpoint``, corrupters and trainer.
* The shared on-disk format: each package's ``verify`` on the other's
  checkpoints, each package's corrupters against the other's ``verify``,
  and a bf16 leaf written byte for byte as the reference writes it.
* Trainer parity with ``repro.train.Trainer`` built without a mesh, from
  the same parameters through ``convert`` (a 1-layer tiny LM, f32):
  resume after a corrupted newest (params rtol 1e-4, atol 1e-6; the
  resumed losses rtol 1e-5, as ``test_torch_train.py`` holds 5 trainer
  steps), rollback under ``NanLossWeights`` (the rollback events equal),
  the step hook's order against the checkpoint and the log (equal), and
  a streaming sampler's mutation log (the manifests' logs equal; two
  trainers resumed from it bitwise alike).
* The ``train_lm`` twin on its demo preset: ``--head lsh``, ``--sampler
  lgd`` and ``--ckpt`` with resume.
"""

import contextlib
import io
import json
import logging
import os
import shutil
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data as JD
import repro.models as JM
import repro.optim as JO
import repro.testing as JF
import repro.train as JT
from repro.train import checkpoint as jckpt
from repro_torch import convert, train_lm
from repro_torch.data import (
    HealthConfig,
    LSHPipelineConfig,
    LSHSampledPipeline,
    lm_head_query_fn,
    make_token_corpus,
    mean_pool_feature_fn,
    uniform_batches,
)
from repro_torch.models import ModelConfig
from repro_torch.optim import Adam, Adam8bit
from repro_torch.testing import (
    NanLossWeights,
    delete_leaf,
    flip_manifest_byte,
    truncate_arrays,
)
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train import checkpoint as ckpt

TREE = {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones((5,)),
        "nested": {"m": torch.zeros((2, 2), dtype=torch.int32)}}
PARAMS = dict(rtol=1e-4, atol=1e-6)
LOSS = dict(rtol=1e-5, atol=1e-6)
TINY = dict(name="tiny", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2,
            d_ff=64, vocab=64, chunk=16, loss_chunk=16, dtype="float32",
            rope_theta=10000.0)


def _save_steps(d, steps, tree=TREE):
    for s in steps:
        ckpt.save(d, s, tree, extra={"step": s})


def _tiny():
    return ModelConfig(**TINY), JM.ModelConfig(**TINY)


@pytest.fixture(scope="module")
def tiny_params():
    _, jcfg = _tiny()
    return jax.jit(JM.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)


def _lm(params):
    return convert.lm_params_from_numpy(params, _tiny()[0], "cpu")


# ---------------------------------------------------------------------------
# tests/test_checkpoint_integrity.py, against the port
# ---------------------------------------------------------------------------

class TestVerify:
    def test_pristine_checkpoint_verifies(self, tmp_path):
        d = os.fspath(tmp_path)
        _save_steps(d, [3])
        ok, reason = ckpt.verify(d, 3)
        assert ok, reason

    def test_truncated_arrays_fail_verify(self, tmp_path):
        d = os.fspath(tmp_path)
        _save_steps(d, [3])
        truncate_arrays(d, 3)
        ok, reason = ckpt.verify(d, 3)
        assert not ok and "arrays.npz" in reason

    def test_deleted_leaf_fails_verify(self, tmp_path):
        d = os.fspath(tmp_path)
        _save_steps(d, [3])
        victim = delete_leaf(d, 3)
        ok, reason = ckpt.verify(d, 3)
        assert not ok and "missing" in reason
        assert victim.endswith(".npy")

    def test_flipped_manifest_byte_fails_verify(self, tmp_path):
        d = os.fspath(tmp_path)
        _save_steps(d, [3])
        flip_manifest_byte(d, 3)
        ok, reason = ckpt.verify(d, 3)
        assert not ok and "manifest" in reason

    def test_flipped_array_byte_fails_crc(self, tmp_path):
        """Bit rot inside a stored array: the manifest stays valid; the
        member's own zip CRC or the leaf's CRC32 catches it."""
        d = os.fspath(tmp_path)
        _save_steps(d, [3])
        p = os.path.join(d, "step_00000003", "arrays.npz")
        with zipfile.ZipFile(p) as z:
            second = z.infolist()[1].header_offset
        with open(p, "r+b") as f:
            data = bytearray(f.read())
            # ZIP_STORED: the byte before the second member's local
            # header is the first member's last data byte
            data[second - 1] ^= 0xFF
            f.seek(0)
            f.write(data)
        ok, reason = ckpt.verify(d, 3)
        assert not ok and "CRC" in reason.upper()

    def test_legacy_manifest_without_checksums_passes_structural(
            self, tmp_path):
        d = os.fspath(tmp_path)
        _save_steps(d, [3])
        mpath = os.path.join(d, "step_00000003", "manifest.json")
        with open(mpath) as f:
            manifest = json.load(f)
        manifest.pop("checksum")
        for leaf in manifest["leaves"]:
            leaf.pop("crc32")
        with open(mpath, "w") as f:
            json.dump(manifest, f)
        ok, reason = ckpt.verify(d, 3)
        assert ok, reason


class TestLatestValidStep:
    def test_skips_corrupt_newest(self, tmp_path):
        d = os.fspath(tmp_path)
        _save_steps(d, [10, 20, 30])
        truncate_arrays(d, 30)
        assert ckpt.latest_step(d) == 30
        assert ckpt.latest_valid_step(d) == 20

    def test_skips_multiple_corrupt(self, tmp_path):
        d = os.fspath(tmp_path)
        _save_steps(d, [10, 20, 30])
        truncate_arrays(d, 30)
        flip_manifest_byte(d, 20)
        assert ckpt.latest_valid_step(d) == 10

    def test_none_when_all_corrupt(self, tmp_path):
        d = os.fspath(tmp_path)
        _save_steps(d, [10])
        truncate_arrays(d, 10)
        assert ckpt.latest_valid_step(d) is None

    def test_trainer_resume_skips_corrupt_and_replays_bitwise(
            self, tmp_path, tiny_params):
        """resume=True lands on the newest VALID step, and two restored
        trainers hold bitwise the same parameters and Adam state."""
        d = os.fspath(tmp_path)
        cfg, _ = _tiny()
        corpus = make_token_corpus(5, 64, 16, cfg.vocab)

        def fresh(resume):
            return Trainer(
                cfg, _lm(tiny_params), Adam(lr=1e-2),
                uniform_batches(corpus, 8, seed=1, device="cpu"),
                TrainerConfig(ckpt_dir=d, ckpt_every=10, log_every=50),
                resume=resume)

        t1 = fresh(resume=False)
        t1.run(30)
        t1.finalize()
        truncate_arrays(d, 30)
        t2 = fresh(resume=True)
        assert t2.step == 20
        t3 = fresh(resume=True)
        assert t3.step == 20
        for a, b in zip(t2.params.parameters(), t3.params.parameters()):
            assert torch.equal(a, b)
        for k, v in t2.opt_state.m.items():
            assert torch.equal(v, t3.opt_state.m[k])
        assert int(t2.opt_state.step) == 20


class TestAsyncCheckpointerErrors:
    def test_write_failure_reraised_at_wait(self, tmp_path):
        a = ckpt.AsyncCheckpointer()
        # a FILE where the step dir must go forces the writer to fail
        bad_dir = os.fspath(tmp_path / "ckpts")
        with open(bad_dir, "w") as f:
            f.write("not a directory")
        a.save(bad_dir, 1, TREE)
        with pytest.raises(RuntimeError, match="async checkpoint"):
            a.wait()
        a.wait()                     # the error is consumed, not sticky

    def test_write_failure_reraised_at_next_save(self, tmp_path):
        a = ckpt.AsyncCheckpointer()
        bad_dir = os.fspath(tmp_path / "ckpts")
        with open(bad_dir, "w") as f:
            f.write("x")
        a.save(bad_dir, 1, TREE)
        with pytest.raises(RuntimeError, match="async checkpoint"):
            a.save(os.fspath(tmp_path), 2, TREE)


class TestTmpGarbageCollection:
    def test_keep_last_reaps_orphaned_tmp(self, tmp_path):
        d = os.fspath(tmp_path)
        _save_steps(d, [10, 20])
        os.makedirs(os.path.join(d, "step_00000015.tmp"))  # dead writer
        ckpt.keep_last(d, 2)
        assert not os.path.exists(os.path.join(d, "step_00000015.tmp"))
        assert ckpt.latest_valid_step(d) == 20

    def test_keep_last_spares_inflight_tmp(self, tmp_path):
        d = os.fspath(tmp_path)
        _save_steps(d, [10, 20])
        os.makedirs(os.path.join(d, "step_00000030.tmp"))
        ckpt.keep_last(d, 2)
        assert os.path.exists(os.path.join(d, "step_00000030.tmp"))

    def test_keep_last_removes_manifestless_dirs(self, tmp_path):
        d = os.fspath(tmp_path)
        _save_steps(d, [10, 20, 30])
        os.remove(os.path.join(d, "step_00000010", "manifest.json"))
        ckpt.keep_last(d, 2)
        assert not os.path.exists(os.path.join(d, "step_00000010"))

    def test_save_clobbers_stale_tmp_with_warning(self, tmp_path, caplog):
        d = os.fspath(tmp_path)
        os.makedirs(os.path.join(d, "step_00000005.tmp"))
        with caplog.at_level(logging.WARNING,
                             logger="repro_torch.checkpoint"):
            ckpt.save(d, 5, TREE)
        assert any("clobbering" in r.message for r in caplog.records)
        ok, reason = ckpt.verify(d, 5)
        assert ok, reason


class TestIteratorResumeHygiene:
    def test_empty_iterator_first_draw_returns_cleanly(self, tiny_params):
        cfg, _ = _tiny()
        tr = Trainer(cfg, _lm(tiny_params), Adam(lr=1e-2), iter([]),
                     TrainerConfig(log_every=50), resume=False)
        assert tr.run(5)["losses"] == [] and tr.step == 0

    def test_short_iterator_on_restore_raises_clear_error(
            self, tmp_path, tiny_params):
        d = os.fspath(tmp_path)
        cfg, _ = _tiny()
        corpus = make_token_corpus(5, 64, 16, cfg.vocab)

        def fresh(batches, resume):
            return Trainer(cfg, _lm(tiny_params), Adam(lr=1e-2), batches,
                           TrainerConfig(ckpt_dir=d, ckpt_every=10,
                                         log_every=50), resume=resume)

        t1 = fresh(uniform_batches(corpus, 8, seed=1, device="cpu"), False)
        t1.run(10)
        t1.finalize()
        short = (b for _, b in zip(
            range(3), uniform_batches(corpus, 8, seed=1, device="cpu")))
        with pytest.raises(RuntimeError, match="shorter than the"):
            fresh(short, resume=True)


# ---------------------------------------------------------------------------
# the shared on-disk format
# ---------------------------------------------------------------------------

def _mixed_tree():
    """A tree with every leaf kind an LM checkpoint holds; its reference
    twin (same paths, in sorted order, as JAX flattens dicts)."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    # finite bf16 bit patterns (exponent field below all-ones), both signs
    bits = (rng.integers(0, 2 ** 14, (3, 5))
            | (rng.integers(0, 2, (3, 5)) << 15)).astype(np.uint16).view(
                np.int16)
    q = Adam8bit(block=8)._slots(torch.zeros(13))[0]
    port = {"a_f32": torch.from_numpy(w), "b_bf16": torch.from_numpy(
        bits).view(torch.bfloat16), "c_i64": torch.arange(7),
        "d_q": {"q": q.q, "scale": q.scale}, "e_step": torch.tensor(
            3, dtype=torch.int32)}
    ref = {"a_f32": jnp.asarray(w), "b_bf16": jnp.asarray(
        bits.view(jnp.bfloat16)), "c_i64": np.arange(7),
        "d_q": {"q": jnp.asarray(q.q.numpy()),
                "scale": jnp.asarray(q.scale.numpy())},
        "e_step": jnp.asarray(3, jnp.int32)}
    return port, ref


class TestSharedFormat:
    def test_port_checkpoint_is_the_references_byte_for_byte(
            self, tmp_path):
        """The same tree saved by both packages: every npz member's bytes
        (the .npy header and data, a bf16 leaf as a raw |V2 member) and
        the whole manifest, checksum included, are equal."""
        port, ref = _mixed_tree()
        ckpt.save(os.fspath(tmp_path / "t"), 4, port, extra={"step": 4})
        jckpt.save(os.fspath(tmp_path / "j"), 4, ref, extra={"step": 4})
        parts = []
        for side in ("t", "j"):
            d = tmp_path / side / "step_00000004"
            with zipfile.ZipFile(d / "arrays.npz") as z:
                members = {n_: z.read(n_) for n_ in z.namelist()}
            parts.append((members, json.loads((d / "manifest.json")
                                              .read_text())))
        assert parts[0][0] == parts[1][0]
        assert parts[0][1] == parts[1][1]
        bf16 = [leaf for leaf in parts[0][1]["leaves"]
                if leaf["path"] == "b_bf16"]
        assert bf16[0]["dtype"] == "bfloat16"

    def test_port_checkpoint_passes_reference_verify(self, tmp_path):
        d = os.fspath(tmp_path)
        port, _ = _mixed_tree()
        port.pop("b_bf16")
        ckpt.save(d, 4, port)
        assert jckpt.verify(d, 4) == (True, "ok")

    def test_bf16_leaf_against_both_verifies(self, tmp_path):
        """A bf16 leaf: the port's verify passes both packages'
        checkpoints; the reference's rejects both alike, its own too
        (numpy reads the raw member back as |V2, not ``bfloat16``)."""
        port, ref = _mixed_tree()
        t_dir, j_dir = os.fspath(tmp_path / "t"), os.fspath(tmp_path / "j")
        ckpt.save(t_dir, 4, port)
        jckpt.save(j_dir, 4, ref)
        assert ckpt.verify(t_dir, 4) == (True, "ok")
        assert ckpt.verify(j_dir, 4) == (True, "ok")
        want = (False, "leaf dtype mismatch: b_bf16 |V2 != bfloat16")
        assert jckpt.verify(j_dir, 4) == want
        assert jckpt.verify(t_dir, 4) == want

    def test_reference_checkpoint_restores_in_the_port(self, tmp_path):
        port, ref = _mixed_tree()
        d = os.fspath(tmp_path)
        jckpt.save(d, 4, ref, extra={"step": 4, "note": [1, 2]})
        tmpl = {k: (torch.zeros_like(v) if isinstance(v, torch.Tensor)
                    else {kk: torch.zeros_like(vv) for kk, vv in v.items()})
                for k, v in port.items()}
        tree, extra = ckpt.restore(d, 4, tmpl)
        assert extra == {"step": 4, "note": [1, 2]}
        for path, leaf in ckpt.flatten(port):
            got = dict(ckpt.flatten(tree))[path]
            assert got.dtype == leaf.dtype and torch.equal(got, leaf), path

    @pytest.mark.parametrize("writer", ["port", "reference"])
    @pytest.mark.parametrize("corrupt", ["truncate_arrays", "delete_leaf",
                                         "flip_manifest_byte"])
    def test_each_packages_corrupters_fail_the_others_verify(
            self, tmp_path, writer, corrupt):
        """The reference's corrupters against the port's verify and the
        port's against the reference's, on either package's checkpoint."""
        port, ref = _mixed_tree()
        port.pop("b_bf16")
        ref.pop("b_bf16")
        d = os.fspath(tmp_path)
        if writer == "port":
            ckpt.save(d, 4, port)
            getattr(JF, corrupt)(d, 4)
            ok, reason = jckpt.verify(d, 4)
            ok_port, _ = ckpt.verify(d, 4)
        else:
            jckpt.save(d, 4, ref)
            getattr(__import__("repro_torch.testing", fromlist=[corrupt]),
                    corrupt)(d, 4)
            ok, reason = ckpt.verify(d, 4)
            ok_port, _ = jckpt.verify(d, 4)
        assert not ok and not ok_port
        assert {"truncate_arrays": "arrays.npz", "delete_leaf": "missing",
                "flip_manifest_byte": "manifest"}[corrupt] in reason

    def test_fortran_ordered_leaf_round_trips(self, tmp_path):
        """A transposed tensor is written as a Fortran-ordered member;
        both packages' verify pass it (CRC32 over its C-order bytes) and
        it restores equal."""
        d = os.fspath(tmp_path)
        tree = {"t": torch.arange(12.0).reshape(3, 4).T}
        ckpt.save(d, 1, tree)
        assert ckpt.verify(d, 1) == jckpt.verify(d, 1) == (True, "ok")
        back, _ = ckpt.restore(d, 1, {"t": torch.zeros(4, 3)})
        assert torch.equal(back["t"], tree["t"])

    def test_qtensor_state_round_trips(self, tmp_path):
        """An Adam8bit state (QTensor slots, a 0-d step) restored in place
        into a fresh state is bitwise the saved one."""
        opt = Adam8bit(block=16)
        p = {"w": torch.randn(5, 7), "b": torch.randn(3)}
        st = opt.init(p)
        _, st = opt.update({k: torch.randn_like(v) for k, v in p.items()},
                           st, p)
        d = os.fspath(tmp_path)
        ckpt.save(d, 1, {"opt_state": st})
        paths = [path for path, _ in ckpt.flatten({"opt_state": st})]
        assert "opt_state/m/w/q" in paths and "opt_state/step" in paths
        fresh = opt.init(p)
        ckpt.restore(d, 1, {"opt_state": fresh}, in_place=True)
        for (_, a), (_, b) in zip(ckpt.flatten(st), ckpt.flatten(fresh)):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the trainer against repro.train.Trainer
# ---------------------------------------------------------------------------

def _ref_trainer(jcfg, params, d, batches=None, sampler=None, resume=False,
                 **kw):
    return JT.Trainer(jcfg, params, JO.Adam(lr=1e-2), batches,
                      JT.TrainerConfig(ckpt_dir=d, donate=False, **kw),
                      resume=resume, sampler=sampler)


class TestTrainerParity:
    def test_resume_after_corrupted_newest(self, tmp_path, tiny_params):
        cfg, jcfg = _tiny()
        corpus = make_token_corpus(5, 64, 16, cfg.vocab)
        jcorpus = JD.make_token_corpus(5, 64, 16, cfg.vocab)
        dj, dt = os.fspath(tmp_path / "j"), os.fspath(tmp_path / "t")
        kw = dict(ckpt_every=10, log_every=50)
        j1 = _ref_trainer(jcfg, tiny_params, dj,
                          JD.uniform_batches(jcorpus, 8, seed=1), **kw)
        j1.run(30)
        j1.finalize()
        t1 = Trainer(cfg, _lm(tiny_params), Adam(lr=1e-2),
                     uniform_batches(corpus, 8, seed=1, device="cpu"),
                     TrainerConfig(ckpt_dir=dt, **kw), resume=False)
        t1.run(30)
        t1.finalize()
        for corrupt, d in ((JF.truncate_arrays, dt), (truncate_arrays, dj)):
            corrupt(d, 30)
        j2 = _ref_trainer(jcfg, tiny_params, dj,
                          JD.uniform_batches(jcorpus, 8, seed=1),
                          resume=True, **kw)
        lm = _lm(tiny_params)
        t2 = Trainer(cfg, lm, Adam(lr=1e-2),
                     uniform_batches(corpus, 8, seed=1, device="cpu"),
                     TrainerConfig(ckpt_dir=dt, **kw))
        assert t2.step == j2.step == 20
        for d in (dj, dt):          # the abandoned step 30 is gone
            assert jckpt.latest_step(d) == ckpt.latest_step(d) == 20
        got = convert.lm_params_to_numpy(lm)
        for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                                jax.tree_util.tree_leaves(j2.params)):
            np.testing.assert_allclose(g, np.asarray(w), **PARAMS,
                                       err_msg=jax.tree_util.keystr(path))
        np.testing.assert_allclose(t2.run(3)["losses"], j2.run(3)["losses"],
                                   **LOSS)

    def test_rollback_under_nan_loss_weights(self, tmp_path, tiny_params):
        """6 poisoned draws from step 12, rollback after 3: each package
        rolls back twice, 14 -> 10, then runs clean to step 20."""
        cfg, jcfg = _tiny()
        tokens = make_token_corpus(11, 128, 16, cfg.vocab,
                                   hard_frac=0.15).tokens
        pkw = dict(k=5, l=10, minibatch=8, refresh_every=0)
        j_inner = JD.LSHSampledPipeline(
            jax.random.PRNGKey(12), tokens, JD.mean_pool_feature_fn(jcfg),
            JD.lm_head_query_fn(), JD.LSHPipelineConfig(
                health=JD.HealthConfig(fallback_spike=1.1), **pkw),
            params=tiny_params)
        lm = _lm(tiny_params)
        t_inner = LSHSampledPipeline(
            12, tokens, mean_pool_feature_fn(cfg), lm_head_query_fn(),
            LSHPipelineConfig(health=HealthConfig(fallback_spike=1.1),
                              **pkw), params=lm, device="cpu")
        kw = dict(ckpt_every=10, log_every=5, rollback_after=3)
        events = []
        for make in ("ref", "port"):
            if make == "ref":
                sampler = JF.NanLossWeights(j_inner, at_step=12, count=6)
                tr = _ref_trainer(jcfg, tiny_params,
                                  os.fspath(tmp_path / "j"),
                                  sampler=sampler, **kw)
            else:
                sampler = NanLossWeights(t_inner, at_step=12, count=6)
                tr = Trainer(cfg, lm, Adam(lr=1e-2), sampler=sampler,
                             tcfg=TrainerConfig(
                                 ckpt_dir=os.fspath(tmp_path / "t"), **kw),
                             resume=False)
            losses = tr.run(20)["losses"]
            tr.finalize()
            assert tr.step == 20 and sampler.fired == 6
            assert np.isfinite(losses[-1])
            events.append((tr.rollbacks, tr.skipped_steps,
                           [e for e in tr.metrics_history
                            if e.get("event") == "rollback"]))
        assert events[0] == events[1]
        assert events[1][0] == 2 and events[1][2][0]["to_step"] == 10

    def test_step_hook_runs_after_the_checkpoint_and_the_log(
            self, tmp_path, tiny_params):
        """Per step: the log entry, then the checkpoint, then the hook —
        the same sequence in both packages."""
        cfg, jcfg = _tiny()
        corpus = make_token_corpus(5, 64, 16, cfg.vocab)
        jcorpus = JD.make_token_corpus(5, 64, 16, cfg.vocab)
        seqs = []
        for side in ("ref", "port"):
            seq = []

            def hook(tr, seq=seq):
                seq.append(("hook", tr.step, len(tr.metrics_history)))

            kw = dict(ckpt_every=2, log_every=3, step_hook=hook)
            d = os.fspath(tmp_path / side)
            if side == "ref":
                tr = _ref_trainer(jcfg, tiny_params, d,
                                  JD.uniform_batches(jcorpus, 8, seed=1),
                                  **kw)
            else:
                tr = Trainer(cfg, _lm(tiny_params), Adam(lr=1e-2),
                             uniform_batches(corpus, 8, seed=1,
                                             device="cpu"),
                             TrainerConfig(ckpt_dir=d, **kw))
            save = tr.save

            def saved(tr=tr, seq=seq, save=save):
                seq.append(("save", tr.step, len(tr.metrics_history)))
                save()

            tr.save = saved
            tr.run(6)
            tr.finalize()
            seqs.append(seq)
        assert seqs[0] == seqs[1]
        assert seqs[1][:3] == [("hook", 1, 0), ("save", 2, 0),
                               ("hook", 2, 0)]

    def test_streaming_mutation_log_restored(self, tmp_path, tiny_params):
        """Rows appended and evicted from a step hook: the checkpoint at
        step 4 carries the reference's mutation log, and two trainers
        resumed from copies of it replay it and run bitwise alike."""
        cfg, jcfg = _tiny()
        rng = np.random.default_rng(3)
        tokens = rng.integers(0, cfg.vocab, (96, 17)).astype(np.int32)
        extra_rows = rng.integers(0, cfg.vocab, (8, 17)).astype(np.int32)
        pkw = dict(k=5, l=10, minibatch=8, refresh_every=0, streaming=True,
                   min_capacity=128)

        def mutate(tr):
            if tr.step == 2:
                tr.sampler.append_rows(extra_rows)
            elif tr.step == 3:
                tr.sampler.evict_rows(np.arange(5, 13))

        j_pipe = JD.LSHSampledPipeline(
            jax.random.PRNGKey(12), tokens, JD.mean_pool_feature_fn(jcfg),
            JD.lm_head_query_fn(), JD.LSHPipelineConfig(**pkw),
            params=tiny_params)
        jt = _ref_trainer(jcfg, tiny_params, os.fspath(tmp_path / "j"),
                          sampler=j_pipe, ckpt_every=4, step_hook=mutate)
        jt.run(4)
        jt.finalize()

        def port(d, resume):
            lm = _lm(tiny_params)
            pipe = LSHSampledPipeline(
                12, tokens, mean_pool_feature_fn(cfg), lm_head_query_fn(),
                LSHPipelineConfig(**pkw), params=lm, device="cpu")
            return Trainer(cfg, lm, Adam(lr=1e-2), sampler=pipe,
                           tcfg=TrainerConfig(ckpt_dir=d, ckpt_every=4,
                                              step_hook=mutate),
                           resume=resume)

        ta = port(os.fspath(tmp_path / "t"), False)
        ta.run(4)
        ta.finalize()
        logs = {}
        for side, dd in (("ref", tmp_path / "j"), ("port", tmp_path / "t")):
            with open(dd / "step_00000004" / "manifest.json") as f:
                logs[side] = json.load(f)["extra"]["mutation_log"]
        assert logs["ref"] == logs["port"]
        assert [e["op"] for e in logs["port"]] == ["append", "evict"]
        runs = []
        for sub in ("b", "c"):
            d = os.fspath(tmp_path / sub)
            shutil.copytree(os.fspath(tmp_path / "t"), d)
            tr = port(d, True)
            assert tr.step == 4
            assert tr.sampler.mutation_log() == logs["port"]
            assert tr.sampler.n_live == 96 + 8 - 8
            runs.append((tr.run(2)["losses"],
                         [p.detach().clone() for p in tr.params.parameters()]))
            tr.finalize()
        assert runs[0][0] == runs[1][0]
        for a, b in zip(runs[0][1], runs[1][1]):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the train_lm twin
# ---------------------------------------------------------------------------

def _twin(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tr = train_lm.main(["--device", "cpu", *argv])
    return tr, out.getvalue()


class TestTrainLMTwin:
    def test_head_lsh_refreshes_through_the_step_hook(self):
        tr, out = _twin("--sampler", "uniform", "--head", "lsh", "--steps",
                        "4", "--head-refresh-every", "2")
        assert tr.step == 4 and "head index: 1024 rows x 8 tables" in out
        head = tr.tcfg.step_hook.__self__
        assert head.refreshes == 2
        assert np.isfinite(float(out.split("eval ")[1].split()[0]))

    def test_lgd_sampler(self):
        tr, out = _twin("--sampler", "lgd", "--steps", "3",
                        "--optimizer", "adam8bit")
        assert tr.step == 3 and tr.sampler.sampler_stats()["draws"] == 48
        assert "fallback" in out

    def test_ckpt_resume(self, tmp_path):
        """A checkpoint at step 2, then two resumed runs of 2 steps from
        copies of it: both start at step 2 and end equal.  Not bitwise:
        two fresh runs of the demo preset in one process differ by an
        ulp or so on this CPU (its multithreaded backward sums), so
        rtol 1e-5, atol 1e-6."""
        d = os.fspath(tmp_path / "a")
        tr, _ = _twin("--sampler", "uniform", "--steps", "2", "--ckpt", d)
        tr.save()
        tr.finalize()
        shutil.copytree(d, os.fspath(tmp_path / "b"))
        ends = []
        for sub in ("a", "b"):
            tr, out = _twin("--sampler", "uniform", "--steps", "2",
                            "--ckpt", os.fspath(tmp_path / sub))
            assert "resumed at step 2" in out and tr.step == 4
            ends.append([p.detach().clone() for p in tr.params.parameters()])
        for a, b in zip(*ends):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)

    def test_shards_parse_and_train(self, monkeypatch):
        """``--shards 2`` trains through a two-shard
        ``ShardedLSHPipeline``: each shard draws its half of the batch
        (the demo preset on a 256-row corpus)."""
        monkeypatch.setitem(train_lm.PRESETS, "demo",
                            dict(train_lm.PRESETS["demo"], corpus=256))
        assert train_lm.parse_args(["--shards", "2"]).shards == 2
        tr, out = _twin("--shards", "2", "--steps", "2")
        assert "shards: 2" in out and tr.sampler.n_shards == 2
        assert [p.sampler_stats()["draws"] for p in tr.sampler.shards] == [
            16, 16]
        assert all(bool(torch.isfinite(p).all())
                   for p in tr.params.parameters())
