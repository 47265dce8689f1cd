"""Device meshes on ``torch.distributed`` (port of ``repro/launch/mesh.py``).

The reference builds its meshes from the devices JAX sees; here a mesh is a
``DeviceMesh`` over the ranks of the default process group, with the
reference's axis names ("data", "model").  Nothing tells a program of a
cluster, so the caller starts the group (the tests start ``gloo`` groups
on the CPU, one process per rank; ``chip_smoke.py``'s two-rank phase a
``gloo`` group of two processes that share the one card, since NCCL
refuses two ranks on one device) — except for the one-rank mesh of a
single card, which starts its own.

Like every entry point of the port, these run on the card unless the
caller asks for the CPU, and raise without a CUDA device.  The production
meshes (16 x 16 over ("data", "model"), 2 x 16 x 16 with a "pod" axis)
are what the dry-run (``launch/dryrun.py``) traces a rank of, on a fake
process group of 256 or 512 ranks (``fake_group``) with its mesh on the
CPU's device type and the step's tensors on ``meta``.
"""
from __future__ import annotations

import contextlib
import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

_OWN_GROUP = False   # make_local_mesh started the default process group


def _mesh(shape, names, dev_type: str) -> DeviceMesh:
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs a process group with {n} "
                           "ranks; start one first")
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks, the process "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(dev_type, shape, mesh_dim_names=names)


def make_debug_mesh(data: int = 2, model: int = 2, device=None,
                    pod: int = 0) -> DeviceMesh:
    """A (data, model) mesh, or with ``pod`` a (pod, data, model) one, over
    the default process group, which must already hold that many ranks."""
    dev = resolve_device(device)
    if pod:
        return _mesh((pod, data, model), ("pod", "data", "model"), dev.type)
    return _mesh((data, model), ("data", "model"), dev.type)


def make_production_mesh(*, multi_pod: bool = False, device=None
                         ) -> DeviceMesh:
    """16 x 16 over ("data", "model") (256 ranks) or 2 x 16 x 16 over
    ("pod", "data", "model") (512 ranks), on the default process group,
    which must hold exactly that many.  Axis roles as in the reference:
    "pod" pure data parallelism over the slow link, "data" DP and FSDP
    storage, "model" TP / EP / SP."""
    dev = resolve_device(device)
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"), dev.type)
    return _mesh((16, 16), ("data", "model"), dev.type)


@contextlib.contextmanager
def fake_group(world_size: int, rank: int = 0):
    """A fake default process group of ``world_size`` ranks in this one
    process, as rank ``rank``: collectives return at once and move
    nothing (``torch.testing``'s ``FakeStore``, backend "fake").  For
    tracing one rank's step; ended on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already running")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_local_mesh(device=None) -> DeviceMesh:
    """The one-rank (1, 1) mesh of a single device.  Without a process group
    it starts a one-rank group itself (NCCL on CUDA, gloo on the CPU) and
    raises if that fails; ``teardown`` ends that group."""
    global _OWN_GROUP
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
        _OWN_GROUP = True
    return make_debug_mesh(1, 1, dev)


def teardown() -> None:
    """End the process group that ``make_local_mesh`` started, if it did;
    a group the caller started is the caller's to end."""
    global _OWN_GROUP
    if _OWN_GROUP and dist.is_initialized():
        dist.destroy_process_group()
    _OWN_GROUP = False
