"""The port's entry points as a ``torchrun`` job on the CPU.

``tools/mesh_check.py --launcher MODE --nprocs 2 --device cpu`` runs
``python -m torch.distributed.run --standalone --nproc-per-node 2 -m
repro_torch.launch.train`` (the SMOKE phi4-mini, 3 steps, batch 4 x 16
tokens, corpus 64; gloo) and one process alone: the same command for
``uniform``; for ``lgd`` (``--lgd``) the same run built from
``launch.train``'s functions with the job's 2 shards, so that it draws
the job's batches:

* ``uniform`` and ``lgd``: the job's rank 0 reports the (2, 1) mesh
  over 2 ranks, both ranks' losses are equal, and they are within rtol
  1e-5 of the lone process's (f32: the data-parallel sums' order);
* ``production``: ``--production-mesh`` in the job raises the
  world-size error, not the "no process group" one.

``python -m repro_torch.elastic_restart`` as a two-rank job restores
onto the (2, 1) host mesh with one printout.  Without the card: which
card ``resolve_device`` and the elastic worker pick, with the card count
patched.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(ROOT, "tools", "mesh_check.py")
RTOL = 1e-5


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    return env


def _launcher(mode, out):
    p = subprocess.run([sys.executable, TOOL, "--launcher", mode,
                        "--nprocs", "2", "--device", "cpu", "--out",
                        str(out)], env=_env(), capture_output=True,
                       text=True, timeout=600)
    with open(os.path.join(out, f"launcher-{mode}.json")) as f:
        res = json.load(f)
    return p.returncode, res


@pytest.fixture(scope="module")
def uniform_job(tmp_path_factory):
    return _launcher("uniform", tmp_path_factory.mktemp("uniform"))


@pytest.fixture(scope="module")
def lgd_job(tmp_path_factory):
    return _launcher("lgd", tmp_path_factory.mktemp("lgd"))


@pytest.fixture(scope="module")
def production_job(tmp_path_factory):
    return _launcher("production", tmp_path_factory.mktemp("production"))


@pytest.fixture(params=["uniform", "lgd"])
def job(request):
    return request.getfixturevalue(f"{request.param}_job")


def test_job_reports_the_2x1_host_mesh_over_2_ranks(job):
    rc, res = job
    assert res["job"]["rc"] == 0, res["job"]["tail"]
    assert "mesh={'data': 2, 'model': 1}" in res["job"]["mesh_line"]
    assert "placed over 2 ranks" in res["job"]["placed_line"]
    assert [r["rank"] for r in res["job"]["ranks"]] == [0, 1]
    # only rank 0 prints: one mesh line, one ranks line
    assert res["job"]["tail"].count("mesh={") == 1
    assert rc == 0 and res["ok"]


def test_job_losses_equal_on_ranks_and_match_one_process(job):
    _, res = job
    a, b = (r["losses"] for r in res["job"]["ranks"])
    assert a == b and len(a) == 3
    alone = res["alone"]["ranks"][0]["losses"]
    if res["mode"] == "uniform":     # the launcher alone: a 1 x 1 mesh
        assert "mesh={'data': 1, 'model': 1}" in res["alone"]["mesh_line"]
    assert all(abs(x - y) <= RTOL * abs(y) for x, y in zip(a, alone)), \
        (a, alone)


def test_production_mesh_in_a_job_raises_the_world_size_error(
        production_job):
    rc, res = production_job
    assert rc == 0 and res["ok"]
    tail = res["job"]["tail"]
    assert res["job"]["rc"] != 0
    assert "needs 256 ranks, the process group has 2" in tail
    assert "in a process group" not in tail


def test_elastic_restart_job_restores_onto_the_job_mesh():
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.elastic_restart",
         "--steps", "3", "--device", "cpu"], env=_env(), cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, (p.stdout + p.stderr)[-4000:]
    assert p.stdout.count("phase 1: trained to step 3") == 1
    assert "phase 2: restarted at step 3" in p.stdout
    restored = [ln for ln in p.stdout.splitlines()
                if ln.startswith("phase 3:")]
    assert restored == [ln for ln in restored
                        if "onto mesh {'data': 2, 'model': 1}" in ln]
    assert len(restored) == 1 and "restored step 5" in restored[0]


@pytest.fixture
def cards(monkeypatch):
    """A host with ``n`` cards, as far as the device choice can tell."""
    chosen = []

    def host(n):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
        monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
        return chosen
    return host


def _job_env(monkeypatch, local_rank):
    """The environment torchrun gives local rank ``local_rank``."""
    for k, v in (("RANK", local_rank), ("WORLD_SIZE", 4),
                 ("LOCAL_RANK", local_rank), ("MASTER_ADDR", "localhost"),
                 ("MASTER_PORT", 29500)):
        monkeypatch.setenv(k, str(v))


@pytest.mark.parametrize("n_cards, want", [(2, 1), (1, 0), (4, 1)])
def test_resolve_device_is_the_ranks_own_card(cards, monkeypatch, n_cards,
                                              want):
    from repro_torch.kernels import resolve_device
    cards(n_cards)
    _job_env(monkeypatch, 1)
    assert resolve_device("cuda") == torch.device("cuda", want)
    # an explicit card and the CPU stay as asked
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")
    # LOCAL_RANK without the rest of the job's environment is no job: the
    # process group would be one rank on card 0, and so is the device
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k)
    assert resolve_device("cuda") == torch.device("cuda", 0)
    monkeypatch.delenv("LOCAL_RANK")
    assert resolve_device("cuda") == torch.device("cuda", 0)


def test_resolve_device_without_a_card_raises(monkeypatch):
    from repro_torch.kernels import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _job_env(monkeypatch, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")


@pytest.mark.parametrize("n_cards, rank, want", [
    (2, 1, 1), (1, 1, 0), (2, 0, 0), (4, 3, 3), (2, 3, 1)])
def test_worker_takes_its_own_card(cards, monkeypatch, n_cards, rank, want):
    from repro_torch.dist.multihost_worker import worker_device
    chosen = cards(n_cards)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert worker_device("cuda", rank) == torch.device("cuda", want)
    assert chosen == [torch.device("cuda", want)]
    assert worker_device("cpu", rank) == torch.device("cpu")
