"""Mesh construction and the collectives the distributed components use.

Counterpart of ``low_cost_mocap_tpu/parallel/mesh.py``.  One place decides
the device topology; every distributed component takes a ``Mesh`` and an
axis name.

A ``Mesh`` names the device of every shard (``devices``, shaped by the axis
sizes) and, across processes, the ``torch.distributed`` group and which
shards this process owns (``local``).  A device may appear more than once:
several shards then run one after another on one device, which is how the
CPU tests lay out eight shards and how one card serves several camera
shards.  In one process the shards meet on the mesh's first device
(``tail_device``); across processes every rank gathers the others' partial
results with ``all_gather`` and reduces them in global shard order, so a
reduction gives the same bits whatever the split into processes.  With a
gloo group, CUDA tensors cross the process boundary through host memory:
gloo's support for CUDA tensors differs from one collective to another.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from low_cost_mocap_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    devices: np.ndarray          # object array of torch.device, axis sizes
    axis_names: tuple
    group: Any = None            # torch.distributed group; None: one process
    local: tuple = ()            # flat indices of this process's shards

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def tail_device(self) -> torch.device:
        """Where this process gathers the shards and runs replicated work:
        the device of its first shard."""
        return self.devices.flat[self.local[0]]

    def axis_shards(self, axis: str) -> list:
        """This process's shards along ``axis`` as (position, device).  In
        one process every position, each on the device at that position
        and the first position of the other axes (the work is replicated
        along them, so it runs once)."""
        ax = self.axis_names.index(axis)
        if self.distributed:
            return [(k, self.devices.flat[k]) for k in self.local]
        out = []
        for i in range(self.devices.shape[ax]):
            coord = [0] * self.devices.ndim
            coord[ax] = i
            out.append((i, self.devices[tuple(coord)]))
        return out

    def backend(self) -> str | None:
        if not self.distributed:
            return None
        import torch.distributed as dist

        return dist.get_backend(self.group)

    def gather(self, parts: list) -> torch.Tensor:
        """Stack per-shard tensors of like shape, given in this process's
        shard order, into (axis size, ...) in global shard order on the
        tail device: the port's ``all_gather``."""
        tail = self.tail_device
        local = torch.stack([p.to(tail) for p in parts])
        if not self.distributed:
            return local
        import torch.distributed as dist

        wire = local.cpu() if self.backend() == "gloo" else local
        world = dist.get_world_size(self.group)
        got = [torch.empty_like(wire) for _ in range(world)]
        dist.all_gather(got, wire.contiguous(), group=self.group)
        return torch.cat(got).to(tail)

    def sum_shards(self, parts: list) -> torch.Tensor:
        """The sum over every shard of the axis of per-shard partials
        (JAX's ``psum``), added one shard at a time in global shard order,
        so the bits do not depend on how the shards are split."""
        g = self.gather(parts)
        acc = g[0]
        for i in range(1, g.shape[0]):
            acc = acc + g[i]
        return acc


def _as_devices(devices) -> list:
    return [d if isinstance(d, torch.device) else torch.device(d)
            for d in devices]


def make_mesh(axis_sizes: dict[str, int] | None = None, devices=None, *,
              group=None) -> Mesh:
    """A mesh from {axis_name: size}; the sizes must multiply to the
    device count, else ``ValueError``.

    ``devices``: default every CUDA device (raises without CUDA).  A device
    may repeat.  Default axes: every device on one ``point`` axis (the BA
    residual axis).

    ``group``: a ``torch.distributed`` group (``torch.distributed.group.
    WORLD`` for the default one) joins the processes; ``devices`` are then
    this process's own (default the current CUDA device), every process
    must give as many, and the mesh is the ranks' devices in rank order on
    one axis.  Collective: every rank of the group calls it.
    """
    if devices is None:
        if group is None:
            resolve_device("cuda")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [torch.device("cuda", torch.cuda.current_device())]
    devices = _as_devices(devices)
    local = tuple(range(len(devices)))
    if group is not None:
        import torch.distributed as dist

        rank = dist.get_rank(group)
        every = [None] * dist.get_world_size(group)
        dist.all_gather_object(every, [str(d) for d in devices], group=group)
        if len({len(d) for d in every}) != 1:
            raise ValueError("every process must give as many devices: "
                             f"{[len(d) for d in every]}")
        local = tuple(rank * len(devices) + i for i in range(len(devices)))
        # the other ranks' devices by name; this rank's as given
        devices = [devices[k - local[0]] if k in local
                   else torch.device(name)
                   for k, name in enumerate(n for d in every for n in d)]
    if axis_sizes is None:
        axis_sizes = {"point": len(devices)}
    names = tuple(axis_sizes.keys())
    sizes = tuple(int(s) for s in axis_sizes.values())
    if int(np.prod(sizes)) != len(devices):
        raise ValueError(
            f"mesh {axis_sizes} needs {int(np.prod(sizes))} devices, "
            f"have {len(devices)}")
    if group is not None and len(sizes) != 1:
        raise ValueError("a mesh across processes has one axis")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(sizes), names, group, local)


def shard_along(mesh: Mesh, axis: str, x, dim: int = 0) -> list:
    """This process's shards of ``x`` along ``dim`` (default 0), split
    evenly over the ``axis`` shards, each on its shard's device, in shard
    order.  The size of ``dim`` must be divisible by the axis size."""
    x = torch.as_tensor(x)
    n = mesh.shape[axis]
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {x.shape[dim]} is not "
                         f"divisible by the {axis!r} axis size {n}")
    step = x.shape[dim] // n
    return [x.narrow(dim, i * step, step).to(dev)
            for i, dev in mesh.axis_shards(axis)]


def replicated(mesh: Mesh, x) -> dict:
    """``x`` on each of this process's devices: {device: tensor}, one copy
    a distinct device."""
    x = torch.as_tensor(x)
    out = {}
    for k in mesh.local:
        dev = mesh.devices.flat[k]
        if dev not in out:
            out[dev] = x.to(dev)
    return out
