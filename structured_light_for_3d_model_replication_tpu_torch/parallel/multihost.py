"""Multi-process (multi-host) meshes (the JAX package's
``parallel/multihost.py``).

Every process calls ``initialize()``, which joins one
``torch.distributed`` process group: NCCL when the process's devices are
cards, gloo on the CPU. ``global_mesh()`` then builds one ``DeviceMesh``
over every process's devices, carrying the group, and the sharded
functions written against ``parallel/mesh``'s collectives run on it
unchanged: each process loops over its own slots and the values cross
processes through the group.

The settings are the JAX package's environment variables
(``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``),
so one launcher serves both packages. Without them ``initialize()`` does
nothing and ``global_mesh()`` is the local mesh.
"""
from __future__ import annotations

import os

import torch

from structured_light_for_3d_model_replication_tpu_torch.parallel import mesh as meshlib

__all__ = ["initialize", "is_multiprocess", "global_mesh", "process_summary"]

# this process's devices in the group, set by initialize()
_LOCAL: list[torch.device] = []


def _dist():
    import torch.distributed as dist

    return dist


def _local_devices() -> list[torch.device]:
    return list(_LOCAL) or meshlib.attached_devices()


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               connect_timeout_s: float | None = None,
               local_devices=None) -> bool:
    """Join the process group when multi-process settings are given (the
    arguments or the environment); True when the group is up. Safe to call
    more than once. ``local_devices``: this process's devices in the
    global mesh (default: every attached card, else the CPU; a list may
    repeat a device).

    ``connect_timeout_s`` bounds the join: a peer that never shows up would
    otherwise hang the rendezvous with no diagnostic. Past the bound a
    ``DeadlineExceeded`` names the address and the topology."""
    dist = _dist()
    env_addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
    env_np = os.environ.get("JAX_NUM_PROCESSES")
    addr = coordinator_address or env_addr
    nproc = num_processes if num_processes is not None else (
        int(env_np) if env_np else None)
    if addr is None and nproc is None:
        return dist.is_available() and dist.is_initialized()
    if addr is None:
        raise ValueError(
            f"num_processes={nproc!r} given without a coordinator address; set "
            f"JAX_COORDINATOR_ADDRESS")
    if nproc is None:
        raise ValueError(
            f"coordinator {addr!r} given without a process count; set "
            f"JAX_NUM_PROCESSES (torch.distributed needs the world size)")
    pid = process_id if process_id is not None else int(os.environ.get("JAX_PROCESS_ID", "0"))
    devices = [meshlib._norm(d) for d in (local_devices or meshlib.attached_devices())]
    backend = "nccl" if devices[0].type == "cuda" else "gloo"

    def _join():
        if dist.is_initialized():
            return
        if backend == "nccl":
            torch.cuda.set_device(devices[0])
        dist.init_process_group(backend, init_method=f"tcp://{addr}",
                                world_size=int(nproc), rank=int(pid))

    if connect_timeout_s is None:
        _join()
    else:
        _join_bounded(_join, connect_timeout_s, addr, nproc, pid)
    _LOCAL[:] = devices
    return True


def _join_bounded(join, timeout_s: float, addr: str, nproc: int, pid: int) -> None:
    """``join`` on a daemon thread, waited ``timeout_s``: a wedged
    rendezvous neither hangs the caller past the bound nor blocks the
    interpreter's exit (the thread is abandoned and dies with the
    process)."""
    import threading
    from concurrent.futures import Future

    from structured_light_for_3d_model_replication_tpu_torch.utils import deadline as dl

    fut: Future = Future()

    def _runner():
        if not fut.set_running_or_notify_cancel():
            return
        try:
            join()
        except BaseException as e:
            fut.set_exception(e)
        else:
            fut.set_result(None)

    threading.Thread(target=_runner, name="sl3d-mh-connect", daemon=True).start()
    try:
        dl.wait_future(fut, timeout_s, f"multihost connect to {addr} "
                       f"(num_processes={nproc}, process_id={pid})")
    except dl.DeadlineExceeded:
        raise dl.DeadlineExceeded(
            f"multihost.initialize: no process group within {timeout_s:g}s — "
            f"coordinator {addr!r} (num_processes={nproc}, process_id={pid}) never "
            f"completed the rendezvous. Check that the coordinator host is up, the "
            f"port is reachable, and every peer was launched with the same "
            f"topology.") from None


def is_multiprocess() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def global_mesh(n_data: int | None = None, n_model: int | None = None) -> meshlib.DeviceMesh:
    """A mesh over every process's devices, rank by rank (each process
    brings the same number), with the process group; the local mesh when
    no group is up. Axes as in ``parallel/mesh``."""
    dist = _dist()
    local = _local_devices()
    if not (dist.is_available() and dist.is_initialized()):
        return meshlib.make_mesh(n_data, n_model, devices=local)
    world, rank = dist.get_world_size(), dist.get_rank()
    every: list = [None] * world
    dist.all_gather_object(every, [str(d) for d in local])
    if len({len(e) for e in every}) != 1:
        raise ValueError(f"processes bring unequal device counts: "
                         f"{[len(e) for e in every]}")
    devices = [d for e in every for d in e]
    ranks = [r for r, e in enumerate(every) for _ in e]
    n_data, n_model = meshlib._grid_shape(len(devices), n_data, n_model)
    if n_data * n_model != len(devices):
        raise ValueError(f"a global mesh {n_data}x{n_model} must use all "
                         f"{len(devices)} devices")
    return meshlib.DeviceMesh(devices, n_data, n_model, ranks=ranks,
                              group=dist.group.WORLD, rank=rank)


def process_summary() -> dict:
    """Topology facts for logs and failure reports."""
    dist = _dist()
    up = dist.is_available() and dist.is_initialized()
    local = _local_devices()
    count = dist.get_world_size() if up else 1
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": count,
        "local_devices": len(local),
        "global_devices": len(local) * count,
        "platform": "gpu" if local[0].type == "cuda" else "cpu",
    }
