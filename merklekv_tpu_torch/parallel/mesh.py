"""Device meshes for the keyspace data plane (counterpart of
``merklekv_tpu/parallel/mesh.py``).

A JAX ``Mesh`` names the axes of an array of devices and ``shard_map`` runs
one program on each. PyTorch has no such program: the sharded functions in
``parallel/sharded_merkle.py`` and ``parallel/sharded_state.py`` loop over
the devices of a mesh axis, keep each shard's tensors on its own device and
copy between devices with ``.to``. The mesh is only the named array of
devices they loop over.

A device may appear more than once — ``["cpu"] * 8`` in the tests, or
``[cuda:0] * 4`` on a one-card machine — the analogue of XLA's forced host
device count: every shard then runs for real, only the copies between
distinct cards are missing.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from merklekv_tpu_torch.utils.torchenv import resolve_device

__all__ = ["Mesh", "make_mesh", "local_devices", "shard_devices"]


class Mesh:
    """A numpy object array of ``torch.device`` plus its axis names.

    A mesh that spans processes (``parallel/multihost.py::global_key_mesh``)
    holds only this process's devices, a rectangular block of the global
    device grid: ``origin`` is the global index of its first device along
    each axis and ``global_shape`` the global grid's size per axis (the
    global grid lists process 0's devices first, row-major, as the JAX
    ``make_mesh`` reshapes ``jax.devices()``). ``process_index``,
    ``process_count`` and ``group`` (a ``torch.distributed`` process group)
    say who holds the rest. ``replica_group`` is set on a 2-D mesh whose
    ``replica`` axis crosses processes: ``(group, src)``, the group of the
    processes that hold this process's key columns and the global rank of
    the one among them that holds replica shard 0 (``None`` when this
    process holds every replica shard of its columns). The sharded
    functions combine their per-device results across these groups."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 process_index: int = 0, process_count: int = 1, group=None,
                 origin: Optional[Sequence[int]] = None,
                 global_shape: Optional[Sequence[int]] = None,
                 replica_group=None) -> None:
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.process_index = process_index
        self.process_count = process_count
        self.group = group
        self.origin = tuple(origin) if origin is not None else (0,) * devices.ndim
        sizes = tuple(global_shape) if global_shape is not None else devices.shape
        self.global_shape = dict(zip(self.axis_names, sizes))
        self.replica_group = replica_group

    @property
    def spans_processes(self) -> bool:
        return self.process_count > 1

    @property
    def shape(self) -> dict[str, int]:
        """This process's part of the mesh, per axis (``global_shape`` for
        the whole)."""
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis``, at index 0 of every other axis."""
        k = self.axis_names.index(axis)
        return list(np.moveaxis(self.devices, k, 0).reshape(self.devices.shape[k], -1)[:, 0])


def local_devices() -> list[torch.device]:
    """Every CUDA card of this host; raises when there is none (the port
    never picks the CPU on its own)."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def shard_devices(device: torch.device, devices=None) -> list[torch.device]:
    """The devices a sharded path of a caller on ``device`` may use:
    ``devices`` as given, else ``[device]`` for a CPU caller, else every
    CUDA card of the host."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if device.type == "cpu":
        return [device]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    axis_sizes: Optional[dict[str, int]] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a Mesh over ``devices`` (default: every CUDA card of the host).

    ``axis_sizes`` maps axis name -> size, e.g. ``{"replica": 2, "key": 4}``.
    Default: all devices on one ``key`` axis (pure keyspace data parallelism).
    """
    devs = [torch.device(d) for d in devices] if devices is not None else local_devices()
    if axis_sizes is None:
        axis_sizes = {"key": len(devs)}
    names = tuple(axis_sizes)
    sizes = tuple(axis_sizes[n] for n in names)
    total = int(np.prod(sizes))
    if total > len(devs):
        raise ValueError(f"mesh needs {total} devices, have {len(devs)}")
    arr = np.empty(total, dtype=object)
    arr[:] = devs[:total]
    return Mesh(arr.reshape(sizes), names)
