"""Mesh construction (PyTorch port of ``repro.launch.mesh``).

``make_production_mesh(multi_pod=)`` is the reference's target layout:
16 x 16 ``("data", "model")``, or 2 x 16 x 16 ``("pod", "data",
"model")`` with ``multi_pod``, one rank a device.  A 16-wide ``model``
axis spans two 8-GPU H100 nodes, so its collectives cross the
inter-node fabric (``launch.roofline``).  The ranks come from the
default process group, which must hold exactly 256 or 512 of them (a
job launched with ``torchrun``; the dry run builds them on the ``fake``
backend): a mesh that cannot be built raises.

``make_host_mesh()`` is the mesh of one host, ``(n, 1)`` ``("data",
"model")`` over the ranks of the default group, the reference's every
device on ``data``.  Every entry point's group comes from
``init_job_group``: a process that ``torchrun`` started (one process a
card: ``torchrun --nproc-per-node n -m repro_torch.launch.train ...``)
joins the job's group on its own card, ``cuda:LOCAL_RANK``; a lone
process gets a one-rank group on an in-process store (``HashStore``, no
network), so a lone process is a 1 x 1 mesh on card 0 however many
cards the host has.  The backend is NCCL for ``cuda`` and gloo for
``cpu``.

Functions, so that importing this module touches no process group.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import with_batch_view
from repro_torch.kernels import in_job, resolve_device

PRODUCTION_SHAPE = (16, 16)
MULTI_POD_SHAPE = (2, 16, 16)


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The 16 x 16 (or 2 x 16 x 16, with its batch view:
    ``with_batch_view``) ``DeviceMesh`` over the default group's ranks;
    raises unless the group has exactly that many."""
    from torch.distributed.device_mesh import DeviceMesh

    shape = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    if not dist.is_initialized():
        raise RuntimeError(
            f"the production mesh needs {need} ranks in a process group; "
            "launch one process a device (torchrun) or build the ranks on "
            "the fake backend, as launch.dryrun does")
    if dist.get_world_size() != need:
        raise RuntimeError(
            f"the production mesh {shape} needs {need} ranks, the process "
            f"group has {dist.get_world_size()}")
    return with_batch_view(DeviceMesh(
        device_type, torch.arange(need).reshape(shape), mesh_dim_names=axes))


def init_local_group(device_type: str = "cuda") -> bool:
    """A one-rank default process group on an in-process store, unless
    one exists: no network, no launcher.  True when it made one."""
    if dist.is_initialized():
        return False
    if device_type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(_backend(device_type), store=dist.HashStore(),
                            rank=0, world_size=1)
    return True


def init_job_group(device_type: str = "cuda") -> bool:
    """The default process group every entry point's mesh goes through,
    unless one exists.  In a ``torchrun`` job (``in_job``) the process
    takes its own card (``cuda:LOCAL_RANK``) and joins the job's group
    (``init_method="env://"``); otherwise it is a lone process and gets
    ``init_local_group``'s one rank.  True when it made a group."""
    if dist.is_initialized():
        return False
    if not in_job():
        return init_local_group(device_type)
    if device_type == "cuda":
        torch.cuda.set_device(resolve_device("cuda"))
    dist.init_process_group(_backend(device_type), init_method="env://")
    return True


@contextlib.contextmanager
def job_scope(device_type: str = "cuda"):
    """``init_job_group(device_type)`` for the block; a group it made is
    destroyed on the way out, so an entry point called in a longer-lived
    process leaves no group behind."""
    made = init_job_group(device_type)
    try:
        yield
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()


@contextlib.contextmanager
def host_mesh_scope(device_type: str = "cuda"):
    """``make_host_mesh(device_type)`` for the block, in ``job_scope``."""
    with job_scope(device_type):
        yield make_host_mesh(device_type)


def init_fake_group(world: int) -> None:
    """Rank 0 of a ``fake`` process group of ``world`` ranks, in this one
    process (the dry run's stand-in for the production mesh: collectives
    move no data).  A fake group of another size is replaced; a real
    group is refused."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is initialized; the "
                               "fake ranks need a group of their own")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_host_mesh(device_type: str = "cuda"):
    """``(n, 1)`` ``("data", "model")`` over the default group's n ranks
    (``init_job_group``'s when none exists: the job's, or one rank)."""
    from torch.distributed.device_mesh import DeviceMesh

    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_host_mesh('cuda'): no CUDA device is "
                           "available; pass device_type='cpu'")
    init_job_group(device_type)
    n = dist.get_world_size()
    return DeviceMesh(device_type, torch.arange(n).reshape(n, 1),
                      mesh_dim_names=("data", "model"))
