"""Process group and mesh construction (port of
``rumi_slam_tpu/parallel/distributed.py``).

The reference distributes by ROS TCP between an edge PC and a cloud server.
The JAX package links its processes with ``jax.distributed`` and lays work
out on a ``("host", "chip")`` mesh; here the processes form a
``torch.distributed`` process group (``nccl`` with a card, ``gloo`` on the
CPU) and the mesh is a ``DeviceMesh`` of the same two axes.

Differences from the JAX package:

* PyTorch runs one rank per device, so the mesh holds one entry per process:
  two processes give a ``(2, 1)`` mesh where JAX's two processes with two
  devices each give ``(2, 2)``.
* The sharded bundle adjustment keeps all of a process's shards on one
  device, batched on a leading ``[D, ...]`` axis (``BaMesh``); the psum of
  the JAX solver is a ``sum(0)`` over that axis.  Spreading the shards over
  several cards waits for a multi-GPU host.

The ``RUMI_COORD`` / ``RUMI_NUM_PROCS`` / ``RUMI_PROC_ID`` environment
contract is the JAX package's, so the same entry point works under any
launcher.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch


class BaMesh(NamedTuple):
    """Where the sharded BA runs: ``size`` shards of the problem's points,
    batched on one ``device`` (the counterpart of the JAX solver's 1-D
    ``("ba",)`` mesh over ``size`` devices)."""

    device: str | torch.device
    size: int


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """Join the process group from the arguments or the RUMI_* environment.

    Returns True when a multi-process group was set up, False in a single
    process (no environment, no arguments).  ``coordinator`` is
    ``host:port`` of rank 0's TCP store.
    """
    import torch.distributed as dist

    coordinator = coordinator or os.environ.get("RUMI_COORD")
    if num_processes is None:
        num_processes = int(os.environ.get("RUMI_NUM_PROCS", "0") or 0)
    if process_id is None:
        pid = os.environ.get("RUMI_PROC_ID")
        process_id = int(pid) if pid is not None else None
    if not coordinator or num_processes <= 1 or process_id is None:
        return False
    if torch.cuda.is_available():
        torch.cuda.set_device(process_id % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return True


def mesh_shape(n_devices: int, hosts: int | None, n_processes: int) -> tuple[int, int]:
    """``(hosts, devices per host)`` of the global mesh; raises as the JAX
    package's ``global_mesh`` does when the devices do not fill it."""
    n_hosts = hosts or max(1, n_processes)
    if n_hosts > n_devices:
        raise ValueError(
            f"global_mesh: {n_hosts} hosts requested but only {n_devices} "
            "devices are visible — every host axis entry needs >=1 device"
        )
    if n_devices % n_hosts != 0:
        raise ValueError(
            f"global_mesh: {n_devices} devices do not divide evenly over "
            f"{n_hosts} hosts; pass hosts= explicitly or fix the topology "
            "(trailing devices would be silently dropped)"
        )
    return n_hosts, n_devices // n_hosts


def global_mesh(hosts: int | None = None):
    """``("host", "chip")`` DeviceMesh over every rank of the process group.

    With one rank per device the mesh has one entry per process.  In a
    single process with no group, a group of one is made from an in-memory
    store (no socket).
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    shape = mesh_shape(world, hosts, world)
    device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return init_device_mesh(device_type, shape, mesh_dim_names=("host", "chip"))


def ba_mesh(max_devices: int | None = None) -> BaMesh | None:
    """The sharded PCG global BA's mesh (``sharded_ba.sharded_bundle_adjust_pcg``,
    the post-merge GBA relaunch path, reference CloudMerging.cc:243-250): one
    shard per visible card, all on ``cuda:0``.

    Returns None with fewer than two cards (and on a host without one), where
    callers take the single-device dense Schur solve, as the JAX package does
    on one device.
    """
    if not torch.cuda.is_available():
        return None
    n = torch.cuda.device_count()
    if max_devices:
        n = min(n, max_devices)
    if n <= 1:
        return None
    return BaMesh("cuda:0", n)


def process_local_devices() -> list[torch.device]:
    """This process's devices: every visible card, else the CPU."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]
