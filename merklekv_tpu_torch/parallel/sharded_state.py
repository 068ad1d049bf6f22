"""ShardedDeviceMerkleState: the serving Merkle tree over the devices of a
mesh (counterpart of ``merklekv_tpu/parallel/sharded_state.py``).

The single-device ``DeviceMerkleState`` (``merkle/incremental.py``) keeps
the padded tree on one device; this subclass splits the keyspace-ordered
leaf array into D contiguous shards, each with its local levels on its own
device, plus the top tree over the D shard roots on the first device
(``parallel/sharded_merkle.py``). It replaces only the device seams:

- **build / restructure** (``_dispatch_build`` / ``_dispatch_restructure``)
  hash each shard's leaves on its device, reduce the shards, and reduce the
  top tree over the copied shard roots; a restructure plans its cross-shard
  gather of survivors on the host;
- **value batches** (``_update_in_place``) are routed per shard on the
  host: each shard that received keys runs one fused ``path_rehash`` launch
  over its own subtree, then the top tree is reduced again;
- **queries** read through ``_promotion_chain`` (two launches: the chain
  inside the last live shard, then the top tree's) and ``_level_words``
  (rows gathered from the shards or the top tree).

Every answer — roots, ``TREELEVEL`` slices, ``to_numpy_levels()`` in the
global padded layout — is bit-identical to the single-device tree and to
the JAX sharded state: a walker cannot tell how many devices serve it.

Guard labels carry the width (``shard4_build``, ``shard4_scatter``,
``shard4_restructure``, ``shard4_root``, ``shard4_levels``), so the chaos
globs ``shard*`` and ``shard8_*`` reach one rung of the ladder. Metrics:
``device.shard_batches`` counts sharded builds and restructures,
``device.shard_rebuild_dispatch`` their host-side dispatch time;
``last_shard_rebuild_us`` is the last of them (the ``device.shard_rebuild_us``
gauge).
"""

from __future__ import annotations

import sys
import time
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from merklekv_tpu_torch.merkle.incremental import DeviceMerkleState, _next_pow2
from merklekv_tpu_torch.merkle.packing import PackedLeaves, pack_leaves
from merklekv_tpu_torch.parallel.mesh import Mesh, local_devices, make_mesh
from merklekv_tpu_torch.parallel.sharded_merkle import (
    sharded_build,
    sharded_promotion_chain,
    sharded_restructure,
    sharded_scatter,
)
from merklekv_tpu_torch.utils.torchenv import as_tensor, words_np
from merklekv_tpu_torch.utils.tracing import get_metrics

__all__ = ["ShardedDeviceMerkleState", "resolve_shard_count"]

_warned_clamp = False


def resolve_shard_count(mode, n_devices: Optional[int] = None) -> int:
    """``[device] sharding`` -> shard count.

    Returns 0 for the single-device backend ("off", or "auto" on a
    one-device host), else a power-of-two count: "auto" takes the largest
    power-of-two subset of the local devices; an explicit N is clamped to
    that subset (with a one-time warning) so an over-sized config degrades
    the mesh instead of killing the serving path. ``n_devices`` defaults to
    ``torch.cuda.device_count()``.
    """
    mode = str(mode).strip().lower()
    if mode in ("off", "false", "0", "none", ""):
        return 0
    if n_devices is None:
        n_devices = torch.cuda.device_count()
    avail = 1 << (max(1, n_devices).bit_length() - 1)
    if mode in ("auto", "true"):
        return avail if avail > 1 else 0
    d = int(mode)
    if d < 1 or d & (d - 1):
        raise ValueError(
            f"[device] sharding must be auto|off|power-of-two, got {mode!r}"
        )
    if d > avail:
        global _warned_clamp
        if not _warned_clamp:
            _warned_clamp = True
            print(
                f"[device] sharding={d} exceeds the local device complement "
                f"({n_devices}); clamping to {avail}",
                file=sys.stderr, flush=True,
            )
        return avail
    return d


class ShardedDeviceMerkleState(DeviceMerkleState):
    """Keyspace-sharded serving tree over local devices.

    ``shards`` must be a power of two <= the device count (1 runs the
    sharded path over one device — useful for parity tests); ``devices``
    defaults to every CUDA card of the host and may repeat a device;
    passing a prebuilt ``mesh`` reuses it instead. All host bookkeeping
    (sorted key array, pending staging, flush classification, the
    restructure plan) is inherited from :class:`DeviceMerkleState`.

    ``_levels`` holds one list of local levels per shard (sizes L .. 1,
    L = C / D) and ``_top`` the top tree (sizes D .. 1) on the first device.
    """

    def __init__(
        self,
        shards: Optional[int] = None,
        mesh: Optional[Mesh] = None,
        axis: str = "key",
        devices=None,
    ) -> None:
        if mesh is None:
            devs = [torch.device(d) for d in devices] if devices is not None else local_devices()
            # Default: the auto policy's width, floored at one shard.
            d = shards if shards is not None else max(
                1, resolve_shard_count("auto", len(devs))
            )
            if d < 1 or d & (d - 1):
                raise ValueError(
                    f"shard count must be a positive power of two, got {d}"
                )
            if d > len(devs):
                raise ValueError(
                    f"shard count {d} exceeds local device count {len(devs)}"
                )
            mesh = make_mesh({axis: d}, devices=devs[:d])
        self._mesh = mesh
        self._axis = axis
        self._devices = mesh.axis_devices(axis)
        super().__init__(device=self._devices[0])
        self._n_shards = len(self._devices)
        self._top: Optional[list[torch.Tensor]] = None
        # Dispatch cost of the last sharded build or restructure,
        # microseconds — the device.shard_rebuild_us gauge.
        self.last_shard_rebuild_us = -1

    @classmethod
    def from_items(
        cls,
        items: Iterable[tuple[bytes, bytes]],
        shards: Optional[int] = None,
        mesh: Optional[Mesh] = None,
        axis: str = "key",
        devices=None,
    ) -> "ShardedDeviceMerkleState":
        st = cls(shards=shards, mesh=mesh, axis=axis, devices=devices)
        dedup = dict(items)
        if dedup:
            ordered = sorted(dedup.items())
            st._initial_build(
                np.array([k for k, _ in ordered], dtype=object),
                [v for _, v in ordered],
            )
        return st

    @classmethod
    def from_levels(
        cls,
        levels_np: Sequence[np.ndarray],
        keys: Sequence[bytes],
        shards: Optional[int] = None,
        mesh: Optional[Mesh] = None,
        axis: str = "key",
        devices=None,
    ) -> "ShardedDeviceMerkleState":
        """Adopt a padded tree in the global layout — e.g. the JAX sharded
        state's ``[np.asarray(l) for l in st._levels]`` and its sorted keys —
        split across this state's shards."""
        st = cls(shards=shards, mesh=mesh, axis=axis, devices=devices)
        st._load_levels(levels_np, keys)
        return st

    @property
    def shard_count(self) -> int:
        return self._n_shards

    @property
    def _guard_prefix(self) -> str:
        return f"shard{self._n_shards}_"

    def _capacity_for(self, n: int) -> int:
        # A multiple of the shard count, so the leaf level divides evenly
        # (one-leaf shards when n <= D).
        return max(_next_pow2(n), self._n_shards)

    def _adopt_levels(self, levels: Optional[tuple[list, list]]) -> None:
        """Swap in a new tree version: (per-shard levels, top levels), or
        ``None`` for the empty tree."""
        c = self._n_shards * int(levels[0][0][0].shape[0]) if levels else 0
        if c != self._capacity:
            self._counters = None
        self._chain = None
        self._levels, self._top = levels if levels else (None, None)
        self._capacity = c

    def _levels_from_numpy(self, levels_np: list[np.ndarray]) -> tuple[list, list]:
        d = self._n_shards
        c = levels_np[0].shape[0]
        if c < d:
            raise ValueError(f"capacity {c} is smaller than {d} shards")
        depth = (c // d).bit_length() - 1
        shards = [
            [as_tensor(levels_np[j][s * (c // d >> j) : (s + 1) * (c // d >> j)], dev)
             for j in range(depth + 1)]
            for s, dev in enumerate(self._devices)
        ]
        return shards, [as_tensor(arr, self._devices[0]) for arr in levels_np[depth:]]

    # -------------------------------------------------- device dispatch
    def _record_rebuild(self, t0: float) -> None:
        dt = time.perf_counter() - t0
        self.last_shard_rebuild_us = int(dt * 1e6)
        m = get_metrics()
        m.inc("device.shard_batches")
        m.observe("device.shard_rebuild_dispatch", dt)

    def _dispatch_build(self, packed: PackedLeaves, c: int) -> tuple[list, list]:
        t0 = time.perf_counter()
        levels = self._run("build", lambda: sharded_build(
            self._devices, c, packed.blocks, packed.nblocks))
        self._record_rebuild(t0)
        return levels

    def _dispatch_restructure(self, gather_padded: np.ndarray, fresh_pos: np.ndarray,
                              fresh: PackedLeaves, c_new: int) -> tuple[list, list]:
        t0 = time.perf_counter()
        levels = self._run("restructure", lambda: sharded_restructure(
            [lv[0] for lv in self._levels], self._devices, c_new, gather_padded,
            fresh_pos, fresh.blocks, fresh.nblocks))
        self._record_rebuild(t0)
        return levels

    def _update_in_place(self, items: list[tuple[bytes, bytes]]) -> None:
        """Value-only batch, routed per shard on the host (``pos // L``):
        one ``path_rehash`` launch per shard that received keys, then the
        top tree. Same metrics as the single-device batch."""
        keys = [key for key, _ in items]
        pos = self._positions(keys)
        packed = pack_leaves(keys, [v for _, v in items])

        def scatter() -> None:
            if self._counters is None:
                self._counters = [None] * self._n_shards
            self._top = sharded_scatter(self._levels, self._top, self._counters,
                                        packed.blocks, packed.nblocks, pos)

        t0 = time.perf_counter()
        self._chain = None
        self._run("scatter", scatter)
        self.incremental_batches += 1
        m = get_metrics()
        m.inc("device.scatter_keys", len(items))
        m.inc("device.scatter_bytes",
              int(packed.blocks.nbytes + packed.nblocks.nbytes + 4 * len(pos)))
        m.observe("device.scatter_dispatch", time.perf_counter() - t0)

    # ------------------------------------------------------------ queries
    def _promotion_chain(self) -> torch.Tensor:
        if self._chain is None:
            self._chain = sharded_promotion_chain(self._levels, self._top, len(self._keys))
        return self._chain

    def _level_words(self, level: int, lo: int, hi: int) -> np.ndarray:
        depth = (self._capacity // self._n_shards).bit_length() - 1
        if level >= depth:
            return words_np(self._top[level - depth][lo:hi])
        lj = (self._capacity // self._n_shards) >> level
        parts = [
            words_np(self._levels[s][level][max(lo - s * lj, 0) : min(hi - s * lj, lj)])
            for s in range(lo // lj, (hi - 1) // lj + 1)
        ]
        return np.concatenate(parts)
