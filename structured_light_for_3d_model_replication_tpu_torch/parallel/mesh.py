"""Device meshes and the collectives the sharded modules call (the JAX
package's ``parallel/mesh.py`` and the ``jax.lax`` collectives of its
``shard_map`` bodies).

One process drives every device it sees, as JAX's single controller does.
A ``DeviceMesh`` is an ``[n_data, n_model]`` grid of ``torch.device``s:

  - ``"data"``  spreads turntable views (the batch axis);
  - ``"model"`` spreads pixel rows within a view, or point / grid slabs.

A sharded function is a loop over this process's shards between collective
calls. A collective takes the list of this process's shards (in
``mesh.local_slots()`` order) and returns a list in the same order. Within a
process the values move with ``.to(device, non_blocking=True)`` and the
reductions stay device tensors (no host sync); a mesh that spans processes
(``multihost.global_mesh``) also carries its ``torch.distributed`` group,
and the values cross it through ``all_reduce``, ``all_gather`` and
``batch_isend_irecv``. Every shard runs on its device's current stream.

A device list may repeat one device (``[cpu] * 8``, ``[cuda:0] * 4``): the
counterpart of XLA's virtual host devices, how the tests and the card's
smoke check drive the sharded arms. ``merge_mesh`` and ``views_mesh`` count
*distinct* attached devices, so one card or the CPU gives None and the
unsharded paths run.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["AXIS_DATA", "AXIS_MODEL", "DeviceMesh", "make_mesh", "merge_mesh",
           "views_mesh", "attached_devices", "view_sharding", "batch_sharding",
           "shard_rows", "gather_shards", "psum", "pmax", "pmin", "all_gather",
           "ppermute", "axis_index"]

AXIS_DATA = "data"
AXIS_MODEL = "model"


def _norm(dev) -> torch.device:
    """A torch.device with its index: ``cuda`` -> ``cuda:<current>``."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class DeviceMesh:
    """An ``[n_data, n_model]`` grid of devices, axes ``("data",
    "model")``. ``devices`` is the grid (a numpy object array), ``shape``
    maps each axis to its size, ``size`` counts the slots. ``ranks`` gives
    the process that owns each slot and ``group`` the process group that
    spans them (None: this process owns every slot)."""

    axis_names = (AXIS_DATA, AXIS_MODEL)

    def __init__(self, devices, n_data: int, n_model: int, ranks=None,
                 group=None, rank: int = 0):
        grid = np.empty((n_data, n_model), dtype=object)
        for i, d in enumerate(devices):
            grid.flat[i] = _norm(d) if ranks is None or ranks[i] == rank else torch.device(d)
        self.devices = grid
        self.ranks = np.zeros((n_data, n_model), np.int64) if ranks is None \
            else np.asarray(ranks, np.int64).reshape(n_data, n_model)
        self.group = group
        self.rank = int(rank)

    @property
    def shape(self) -> dict[str, int]:
        return {AXIS_DATA: self.devices.shape[0], AXIS_MODEL: self.devices.shape[1]}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def local_slots(self) -> list[int]:
        """Flat (data-major) indices of the slots this process owns."""
        return [int(i) for i in np.flatnonzero(self.ranks.reshape(-1) == self.rank)]

    def local_devices(self) -> list[torch.device]:
        flat = self.devices.reshape(-1)
        return [flat[i] for i in self.local_slots()]

    def distributed(self) -> bool:
        return self.group is not None

    def __repr__(self) -> str:
        return (f"DeviceMesh(shape={self.shape}, devices="
                f"{[str(d) for d in self.devices.reshape(-1)]})")


def attached_devices() -> list[torch.device]:
    """Every attached card (``cuda:0..n-1``), else ``[cpu]``."""
    if torch.cuda.is_available() and torch.cuda.device_count() > 0:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _grid_shape(n: int, n_data: int | None, n_model: int | None) -> tuple[int, int]:
    if n_data is None and n_model is None:
        n_data, n_model = n, 1
    elif n_data is None:
        if n % n_model:
            raise ValueError(f"{n} devices not divisible by n_model={n_model}")
        n_data = n // n_model
    elif n_model is None:
        if n % n_data:
            raise ValueError(f"{n} devices not divisible by n_data={n_data}")
        n_model = n // n_data
    if n_data * n_model > n:
        raise ValueError(f"mesh {n_data}x{n_model} needs more than {n} devices")
    return int(n_data), int(n_model)


def make_mesh(n_data: int | None = None, n_model: int | None = None,
              devices=None) -> DeviceMesh:
    """A (data, model) mesh over ``devices`` (default: every attached
    card, else the CPU). Defaults favour the data (views) axis; pass
    ``n_model > 1`` to also split pixel rows or point slabs. The list may
    repeat a device."""
    devices = list(devices) if devices is not None else attached_devices()
    n_data, n_model = _grid_shape(len(devices), n_data, n_model)
    return DeviceMesh(devices[:n_data * n_model], n_data, n_model)


def _distinct_attached() -> int:
    return len({str(d) for d in attached_devices()} - {"cpu"})


def merge_mesh(parallel_cfg=None) -> DeviceMesh | None:
    """The sharded merge's mesh, resolved in one place: every attached card
    when ``parallel.merge_mesh`` is on and at least two distinct cards are
    attached, else None."""
    if parallel_cfg is not None and not getattr(parallel_cfg, "merge_mesh", False):
        return None
    if _distinct_attached() < 2:
        return None
    return make_mesh()


def views_mesh(parallel_cfg=None) -> DeviceMesh | None:
    """The view-batched reconstruct's mesh: every attached card when
    ``parallel.shard_views`` is on (the default) and at least two distinct
    cards are attached, else None."""
    if parallel_cfg is not None and not getattr(parallel_cfg, "shard_views", True):
        return None
    if _distinct_attached() < 2:
        return None
    return make_mesh()


# ---------------------------------------------------------------------------
# Shardings: a host array or a tensor split into per-device pieces
# ---------------------------------------------------------------------------

def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev``; asynchronous only where the destination is a card
    (a copy to the host must be complete when it returns)."""
    return t.to(dev, non_blocking=dev.type == "cuda")


def _put(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A contiguous copy of ``x`` on ``dev`` (a slice that is already a
    contiguous tensor on ``dev`` is returned as it is)."""
    return _to(x.contiguous() if x.device.type == "cpu" else x, dev).contiguous()


def _split(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{what}: {n} not divisible by {parts} shards")
    return n // parts


def batch_sharding(mesh: DeviceMesh, x) -> list[torch.Tensor]:
    """``x`` [V, ...] split on its leading axis over every mesh slot,
    data-major; this process's pieces, each on its own device."""
    x = _as_tensor(x)
    per = _split(x.shape[0], mesh.size, "batch_sharding: leading axis")
    flat = mesh.devices.reshape(-1)
    return [_put(x[s * per:(s + 1) * per], flat[s]) for s in mesh.local_slots()]


def view_sharding(mesh: DeviceMesh, x, row_axis: int = 2) -> list[torch.Tensor]:
    """``x`` [V, F, H, W] split views over ``data`` and pixel rows
    (``row_axis``) over ``model``; this process's pieces, each a contiguous
    copy on its own device (a row slab of the stack is not contiguous)."""
    x = _as_tensor(x)
    n_data, n_model = mesh.devices.shape
    per_v = _split(x.shape[0], n_data, "view_sharding: views")
    per_r = _split(x.shape[row_axis], n_model, "view_sharding: rows")
    flat = mesh.devices.reshape(-1)
    out = []
    for s in mesh.local_slots():
        i, j = divmod(s, n_model)
        piece = x[i * per_v:(i + 1) * per_v].narrow(row_axis, j * per_r, per_r)
        out.append(_put(piece, flat[s]))
    return out


def shard_rows(mesh: DeviceMesh, x, axis: int = 0) -> list[torch.Tensor]:
    """``x`` split on ``axis`` over the ``model`` axis and replicated over
    ``data`` (the ray field of a row-sharded view)."""
    x = _as_tensor(x)
    n_model = mesh.devices.shape[1]
    per = _split(x.shape[axis], n_model, "shard_rows")
    flat = mesh.devices.reshape(-1)
    return [_put(x.narrow(axis, (s % n_model) * per, per), flat[s])
            for s in mesh.local_slots()]


def gather_shards(shards: list[torch.Tensor], device, dim: int = 0) -> torch.Tensor:
    """This process's shards concatenated on ``device``."""
    dev = _norm(device)
    return torch.cat([_to(t, dev) for t in shards], dim)


# ---------------------------------------------------------------------------
# Collectives (the jax.lax names): a list of this process's shards in, a list out
# ---------------------------------------------------------------------------

def _devices_of(shards) -> list[torch.device]:
    return [t.device for t in shards]


def _reduce(mesh: DeviceMesh, shards, op, dist_op) -> list[torch.Tensor]:
    """``op``-fold the shards in slot order on the first shard's device,
    then across the mesh's processes; every shard gets the result on its
    own device."""
    acc = shards[0]
    for t in shards[1:]:
        acc = op(acc, _to(t, acc.device))
    if mesh.distributed():
        import torch.distributed as dist

        acc = acc.clone()
        dist.all_reduce(acc, op=dist_op, group=mesh.group)
    return [_to(acc, d) for d in _devices_of(shards)]


def psum(mesh: DeviceMesh, shards) -> list[torch.Tensor]:
    """Sum over every slot of the mesh (``jax.lax.psum`` over all axes)."""
    import torch.distributed as dist

    return _reduce(mesh, shards, torch.add, dist.ReduceOp.SUM)


def pmax(mesh: DeviceMesh, shards) -> list[torch.Tensor]:
    import torch.distributed as dist

    return _reduce(mesh, shards, torch.maximum, dist.ReduceOp.MAX)


def pmin(mesh: DeviceMesh, shards) -> list[torch.Tensor]:
    import torch.distributed as dist

    return _reduce(mesh, shards, torch.minimum, dist.ReduceOp.MIN)


def all_gather(mesh: DeviceMesh, shards) -> list[torch.Tensor]:
    """Every slot's value stacked [mesh.size, ...] in slot order, on each
    shard's device. The shards share one shape and dtype."""
    local = torch.stack([_to(t, shards[0].device) for t in shards])
    if mesh.distributed():
        import torch.distributed as dist

        parts = [torch.empty_like(local) for _ in range(dist.get_world_size(mesh.group))]
        dist.all_gather(parts, local.contiguous(), group=mesh.group)
        full = torch.cat(parts)
        # ranks own contiguous runs of slots in rank order (global_mesh)
        order = np.argsort(mesh.ranks.reshape(-1), kind="stable")
        full = full[torch.as_tensor(np.argsort(order), device=full.device)]
    else:
        full = local
    return [_to(full, d) for d in _devices_of(shards)]


def ppermute(mesh: DeviceMesh, shards, perm) -> list[torch.Tensor]:
    """``out[dst] = shards[src]`` for each (src, dst) slot pair of
    ``perm``; a slot no pair sends to gets zeros (``jax.lax.ppermute``)."""
    slots = mesh.local_slots()
    where = {s: k for k, s in enumerate(slots)}
    out = [torch.zeros_like(t) for t in shards]
    ops = []
    ranks = mesh.ranks.reshape(-1)
    for src, dst in perm:
        if src in where and dst in where:
            t = shards[where[src]]
            out[where[dst]] = _to(t, shards[where[dst]].device)
        elif src in where:
            import torch.distributed as dist

            ops.append(dist.P2POp(dist.isend, shards[where[src]].contiguous(),
                                  int(ranks[dst]), mesh.group))
        elif dst in where:
            import torch.distributed as dist

            ops.append(dist.P2POp(dist.irecv, out[where[dst]], int(ranks[src]),
                                  mesh.group))
    if ops:
        import torch.distributed as dist

        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def axis_index(mesh: DeviceMesh) -> list[int]:
    """The flat slot index of each of this process's shards."""
    return mesh.local_slots()
