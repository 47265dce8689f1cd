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
caller asks for the CPU, and raise without a CUDA device.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

_OWN_GROUP = False   # make_local_mesh started the default process group


def make_debug_mesh(data: int = 2, model: int = 2, device=None) -> DeviceMesh:
    """A (data, model) mesh over the default process group, which must
    already hold ``data * model`` ranks."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_debug_mesh needs a process group with "
                           f"{data * model} ranks; start one first")
    if dist.get_world_size() != data * model:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks, the process group has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))


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
