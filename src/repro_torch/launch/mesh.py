"""Production mesh factories, as ``torch.distributed`` DeviceMeshes.

Counterpart of ``repro.launch.mesh``. One pod is a (16, 16) mesh of 256
cards over the axes (data, model); two pods are (2, 16, 16) over (pod,
data, model), "pod" being pure data parallelism (gradient all-reduce
only). The factories are functions, so importing this module touches no
process group.

``make_production_mesh`` is built over the default process group, which
the launcher initialises (``torchrun`` on 256 or 512 cards; the dry run's
``fake`` backend): it raises when no group is initialised or the world
has another size, and never shrinks the mesh. ``make_host_mesh`` is the
(1, 1) mesh of one process, the axes kept for code parity.
"""
from __future__ import annotations

from typing import Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device


def production_shape(multi_pod: bool = False
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(mesh shape, axis names) of one pod or of two."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape, axes = production_shape(multi_pod)
    need = 1
    for n in shape:
        need *= n
    if not dist.is_initialized():
        raise RuntimeError(
            f"the production mesh {shape} needs a process group of {need} "
            "ranks (launch under torchrun); none is initialised")
    world = dist.get_world_size()
    if world != need:
        raise RuntimeError(
            f"the production mesh {shape} needs a world of {need} ranks, "
            f"not {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device="cuda") -> DeviceMesh:
    """The (1, 1) mesh of one process: over NCCL on CUDA, gloo on the CPU.
    Initialises a group of one over a ``HashStore`` (no network) if none
    exists."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != 1:
        raise RuntimeError("the host mesh is one process; this world has "
                           f"{dist.get_world_size()} ranks")
    return init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))


# Hardware constants of the roofline, for one NVIDIA H100 SXM5 80GB at its
# 700 W power limit (the card's name and limit as nvidia-smi gives them).
# dense bf16 FLOP/s and HBM3 bytes/s a card (the data sheet); the names
# are the reference's, so that ``roofline`` reads the same
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12  # simcheck: ignore[units]
# The 16-wide model axis spans two 8-GPU NVLink nodes, so its ring crosses
# the nodes' network: one 400 Gb/s NIC a GPU, 50e9 bytes/s a direction
# (NVLink alone, within a node, would be 450e9 bytes/s a direction).
ICI_BW = 50e9  # simcheck: ignore[units]
# torch.cuda.get_device_properties(0).total_memory on an "NVIDIA H100 80GB
# HBM3, 700.00 W" card
HBM_BYTES = 85017493504
