"""Sharded Merkle build and diff over the devices of a mesh (counterpart of
``merklekv_tpu/parallel/sharded_merkle.py``).

Decomposition, for N = D * L leaves with L >= 1: let 2^v be the largest
power of two that divides L. Below level v every level's shard segments
(L / 2^j nodes, starting at s * L / 2^j) are even in length and offset, so
every pair merge is inside one shard and no level promotes a node. So each
device reduces its own [L, 8] leaf block for v levels to its [L / 2^v, 8]
nodes of level v (the seam), the D seams are copied to the first device
(the JAX ``all_gather``) and the rest of the tree, odd promotion intact,
is built there over their D * L / 2^v nodes. The result is bit-identical
to the single-device tree of N leaves for every D and L. When L is a power
of two each seam is the shard's subtree root, as in the JAX package (which
accepts only that case). When L is odd (v = 0) the whole leaf level is
copied to the first device and its tree built there alone: exact, but the
first device does all of the tree's work.

Divergence is parallel over keys: each device compares its [R, L] digest
block (``ops.dispatch.divergence``: masks and counts in one kernel launch
on a card, reading a key slice of a larger tensor where it lies) and the
per-replica counts are summed on the first device (the JAX ``psum``). The
2-D diff (:func:`sharded_divergence_2d`), whose reference rows come from
another device, keeps the eager predicate.

What differs from the JAX module: there is no ``shard_map`` and no program
cache. Each function loops over the mesh axis, runs the shard's kernels on
the shard's device and moves tensors with ``.to(device)``, which orders the
copy after the work already queued on both devices' current streams. The
results the JAX programs return as global sharded arrays are returned as
tensors on the first device of the axis. The masks are the exception
(:class:`_ColumnGather`): each shard's [R, L] block is written straight
into its column slice of one [R, N] result, on distinct cards by the copy
engines on a side stream that waits only for the shard's diff, so that in
the fused step the copies run while the cards hash their leaves.

Two input forms. A global tensor (or numpy array) is split along its key
dimension and each slice copied to its device. The per-device form — a list
holding one tensor per device of the axis, each already on its device, as
``parallel/multihost.py::lift_local_shards`` returns them — is used as it
is, with no copy.

Across processes (a mesh from ``multihost.global_key_mesh`` whose group has
more than one rank), the inputs are this rank's rows and the local results
are combined over the group: the seams (every rank holds as many shards
of one L) by an ``all_reduce`` sum of a zero-filled [D_global * L / 2^v, 8]
int32 buffer in which each rank has written only its own rows (each row
has one nonzero contributor, so the sum is exactly the concatenation —
gloo documents CUDA tensors only for ``broadcast`` and ``all_reduce``, so
there is no ``all_gather`` here), and the per-replica counts by an
``all_reduce`` sum. The root and the counts are
then the same on every rank; the masks stay this rank's rows (the JAX
docstring's "each process addressing only its own rows"). The 2-D diff
across processes (:func:`sharded_divergence_2d`) moves replica 0's rows to
the ranks of their key columns by a ``broadcast`` and sums the counts by
the same zero-filled ``all_reduce``.

The serving-tree helpers at the end keep the padded tree of capacity
C = D * L as D lists of shard-local levels (sizes L .. 1) plus the top tree
on the first device (sizes D .. 1); ``parallel/sharded_state.py`` drives
them.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import numpy as np
import torch

from merklekv_tpu_torch.merkle.cpu import ref_level_sizes
from merklekv_tpu_torch.merkle.torch_engine import DiffBeside
from merklekv_tpu_torch.ops.diff_cuda import divergence_vs_ref
from merklekv_tpu_torch.ops.dispatch import (
    build_levels,
    divergence,
    hash_blocks,
    hash_node_level,
    path_scratch,
    promotion_chain,
    rehash_paths,
)
from merklekv_tpu_torch.ops.mesh_copy import copy_columns, enable_peer_access
from merklekv_tpu_torch.parallel.mesh import Mesh
from merklekv_tpu_torch.utils.torchenv import as_tensor
from merklekv_tpu_torch.utils.tracing import device_span, get_metrics

__all__ = [
    "sharded_tree_root",
    "sharded_divergence",
    "sharded_divergence_2d",
    "sharded_anti_entropy_step",
    "make_anti_entropy_step",
    "sharded_build",
    "sharded_scatter",
    "sharded_restructure",
    "sharded_promotion_chain",
]


def _seam(block: torch.Tensor) -> torch.Tensor:
    """[L, 8] shard leaves -> [L / 2^v, 8], the shard's nodes at level v
    (2^v the largest power of two dividing L): pairs of adjacent nodes,
    while the level is even, so nothing crosses a shard or is promoted."""
    cur = block
    while cur.shape[0] % 2 == 0:
        cur = hash_node_level(cur)
    return cur


def _shard_len(n: int, d: int, what: str = "leaf count") -> int:
    """Validate n = d * L with L >= 1; return L."""
    if n % d:
        raise ValueError(f"{what} {n} not divisible by mesh axis {d}")
    if n == 0:
        raise ValueError(f"per-shard {what} 0 must be at least 1")
    return n // d


def _check_shardable(n: int, d: int, what: str = "leaf count") -> int:
    """Validate n = d * L with L a positive power of two (the serving
    tree's padded capacity); return L."""
    l = _shard_len(n, d, what)
    if l & (l - 1):
        raise ValueError(f"per-shard {what} {l} must be a positive power of two")
    return l


def _to(x, dev: torch.device, dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """A numpy array or a tensor -> a tensor on ``dev`` (a tensor already
    there is returned as it is, views included)."""
    if isinstance(x, torch.Tensor):
        if x.dtype != dtype:
            raise TypeError(f"expected {dtype}, got {x.dtype}")
        return x.to(dev)
    return as_tensor(x, dev, dtype)


def _split(x, d: int, dim: int) -> list:
    """``d`` equal consecutive chunks of ``x`` along ``dim`` (views)."""
    step = x.shape[dim] // d
    return [x[(slice(None),) * dim + (slice(s * step, (s + 1) * step),)] for s in range(d)]


def _per_device(x) -> bool:
    return isinstance(x, (list, tuple))


def _on(t: torch.Tensor, dev: torch.device) -> bool:
    return t.device.type == dev.type and (dev.index is None or t.device.index == dev.index)


def _shards(x, devs: Sequence[torch.device], dim: int,
            dtype: torch.dtype = torch.int32) -> list[torch.Tensor]:
    """One tensor per device: the per-device form as given (each shard must
    already sit on its device; nothing is copied), or a global input split
    along ``dim`` with each slice moved to its device."""
    if not _per_device(x):
        return [_to(c, dev, dtype) for c, dev in zip(_split(x, len(devs), dim), devs)]
    if len(x) != len(devs):
        raise ValueError(f"{len(x)} per-device shards for {len(devs)} devices")
    for s, (t, dev) in enumerate(zip(x, devs)):
        if not isinstance(t, torch.Tensor) or t.dtype != dtype:
            raise TypeError(f"shard {s}: expected a {dtype} tensor")
        if not _on(t, dev):
            raise ValueError(f"shard {s} is on {t.device}, its mesh device is {dev}")
    return list(x)


def _rows(x, dim: int, d: int) -> int:
    """The key rows of ``x``: global for a tensor, per shard (all equal)
    for the per-device form."""
    if not _per_device(x):
        return x.shape[dim]
    sizes = {t.shape[dim] for t in x}
    if len(sizes) != 1:
        raise ValueError(f"per-device shards differ in length: {sorted(sizes)}")
    return sizes.pop() * d


def _gather(parts: Sequence[torch.Tensor], dev: torch.device, dim: int = 0,
            mesh: Mesh | None = None) -> torch.Tensor:
    """Concatenate per-device tensors on ``dev`` (the JAX ``all_gather``).
    With a ``mesh`` that spans processes, the [d, ...] local result then
    goes into this rank's rows of a zero-filled [d * ranks, ...] buffer,
    summed over the group with ``all_reduce`` (dim 0 only)."""
    local = torch.cat([p.to(dev) for p in parts], dim=dim)
    if mesh is None or not mesh.spans_processes:
        return local
    import torch.distributed as dist

    d = local.shape[0]
    buf = torch.zeros((d * mesh.process_count, *local.shape[1:]), dtype=local.dtype, device=dev)
    buf[mesh.process_index * d : (mesh.process_index + 1) * d] = local
    dist.all_reduce(buf, group=mesh.group)
    return buf


def _copy_engines(devs: Sequence[torch.device]) -> bool:
    """Whether a gather onto ``devs[0]`` goes by copy engine: every device
    a distinct CUDA card, the first and each other able to reach each
    other's memory directly."""
    idx = [d.index for d in devs]
    if any(d.type != "cuda" for d in devs) or None in idx or len(set(idx)) < len(idx):
        return False
    return all(torch.cuda.can_device_access_peer(idx[0], i)
               and torch.cuda.can_device_access_peer(i, idx[0]) for i in idx[1:])


class _ColumnGather:
    """Per-device [R, L] blocks (the masks) gathered along keys into one
    contiguous [R, D * L] tensor on the first device (the JAX
    ``all_gather``): each block is written straight into its column slice,
    with no per-device temporaries and no ``torch.cat``. Made once every
    block's writes are queued; :meth:`join` returns the result.

    ``ready`` holds, for each block, the CUDA event after its writes, or
    None where they are on its device's current stream; with no ``ready``
    every block's are. Each slice's copy waits for its block's writes as
    they stand when the gather is made, and not for what the cards queue
    after them.

    On distinct CUDA cards that reach each other's memory, each slice is
    one 2-D ``cudaMemcpy2DAsync`` (``ops/mesh_copy.py``; across cards the
    copy engines move it over NVLink) on a side stream of the first card,
    which waits for each block's writes just before its copy: the copies
    run under the work the cards queue next. :meth:`join` makes the first
    card's current stream wait on the copies, and each source card's too,
    so that the caching allocator hands out no block's memory again while
    a copy still reads it. Elsewhere (the CPU, devices that shards share)
    each slice is a plain ``copy_`` on the current stream, after its
    block's writes, and a single block already on the first device is the
    result itself. ``span`` names a device span around the copies, on the
    stream that runs them.
    """

    def __init__(self, parts: Sequence[torch.Tensor], devs: Sequence[torch.device],
                 span: str | None = None, ready: Sequence | None = None) -> None:
        self._done = None
        self._streams: list = []
        self._parts = None
        dev = devs[0]
        if len(parts) == 1 and _on(parts[0], dev):
            self.out = parts[0]
            return
        r, l = parts[0].shape
        self.out = torch.empty((r, l * len(parts)), dtype=parts[0].dtype, device=dev)
        engines = _copy_engines(devs)
        where = contextlib.nullcontext()
        ready = list(ready) if ready is not None else [None] * len(parts)
        if engines:
            side = torch.cuda.Stream(device=dev)  # one of torch's pooled streams
            self._streams = [torch.cuda.current_stream(d) for d in devs]
            for d in devs:
                if d != dev:
                    enable_peer_access(dev.index, d.index)
                    enable_peer_access(d.index, dev.index)
            ready = [ev if ev is not None else stream.record_event()
                     for ev, stream in zip(ready, self._streams)]
            where = torch.cuda.stream(side)
        with where, device_span(span, dev) if span else contextlib.nullcontext():
            # The other devices' blocks first: on an H100 the copy within the
            # first card started only once SMs were free (in the fused step,
            # as its leaf hash ended) and held back the copies queued behind it.
            for s in [*range(1, len(parts)), 0]:
                if ready[s] is not None:
                    torch.cuda.current_stream(dev).wait_event(ready[s])
                if engines:
                    copy_columns(self.out, s * l, parts[s], side)
                else:
                    self.out[:, s * l:(s + 1) * l].copy_(parts[s])
        if engines:
            self._done = torch.cuda.Event()
            self._done.record(side)
            self._parts = list(parts)

    def join(self) -> torch.Tensor:
        """The gathered tensor, once every stream that wrote a block or
        reads the result waits on the copies."""
        if self._done is not None:
            for stream in self._streams:
                stream.wait_event(self._done)
            self._done = self._parts = None
        return self.out


def _psum(parts: Sequence[torch.Tensor], dev: torch.device,
          mesh: Mesh | None = None) -> torch.Tensor:
    """Sum per-device tensors on ``dev`` (the JAX ``psum``); with a mesh
    that spans processes, then ``all_reduce`` sum over its group."""
    total = parts[0].to(dev)
    for p in parts[1:]:
        total = total + p.to(dev)
    if mesh is not None and mesh.spans_processes:
        import torch.distributed as dist

        dist.all_reduce(total, group=mesh.group)
    return total


def _finish_root(seams: Sequence[torch.Tensor], dev: torch.device,
                 mesh: Mesh | None = None) -> torch.Tensor:
    """[8] root of the tree whose level v is the shards' seams in key order
    (every rank's, when ``mesh`` spans processes), built on ``dev``."""
    return build_levels(_gather(seams, dev, mesh=mesh))[-1][0]


def sharded_tree_root(mesh: Mesh, leaves, axis: str = "key") -> torch.Tensor:
    """Root of the Merkle tree over [N, 8] leaf digests (numpy uint32 or an
    int32 tensor, or the per-device form: one [L, 8] tensor per device),
    keyspace-sharded over ``mesh``'s ``axis``.

    N must equal mesh.shape[axis] * L for some L >= 1. Each shard reduces
    its leaves to its seam and the first device finishes the tree (see the
    module's note; an odd L sends every leaf there). Returns [8] int32 on
    the axis's first device, bit-identical to ``tree_root(leaves)``; across
    processes, the root of every rank's rows, the same on each rank.
    """
    devs = mesh.axis_devices(axis)
    _shard_len(_rows(leaves, 0, len(devs)), len(devs))
    seams = [_seam(block) for block in _shards(leaves, devs, 0)]
    return _finish_root(seams, devs[0], mesh)


def sharded_divergence(
    mesh: Mesh, digests, present, axis: str = "key"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Keyspace-sharded multi-replica divergence.

    digests: [R, N, 8] uint32 (numpy, or int32 tensor); present: [R, N]
    bool; N divisible by the mesh axis — or the per-device form of both.
    Returns (masks [R, N] bool, counts [R] int32 — summed over the shards),
    both on the axis's first device. Across processes the counts are summed
    over every rank and the masks are this rank's rows.
    """
    devs = mesh.axis_devices(axis)
    d = len(devs)
    if _rows(digests, 1, d) % d:
        raise ValueError("key axis not divisible by mesh")
    masks, counts = zip(*(
        divergence(dig, pres)
        for dig, pres in zip(_shards(digests, devs, 1), _shards(present, devs, 1, torch.bool))
    ))
    return _ColumnGather(masks, devs).join(), _psum(counts, devs[0], mesh)


def _grid(mesh: Mesh, replica_axis: str, key_axis: str) -> np.ndarray:
    """This process's devices as a [replica, key] array (index 0 of any
    other axis)."""
    names = mesh.axis_names
    grid = np.moveaxis(mesh.devices, (names.index(replica_axis), names.index(key_axis)), (0, 1))
    return grid.reshape(grid.shape[0], grid.shape[1], -1)[:, :, 0]


def grid_blocks(x, grid: np.ndarray, dtype: torch.dtype) -> list[list[torch.Tensor]]:
    """[R, N, ...] split into ``grid``'s [R / rows, N / columns, ...]
    blocks, each moved to its device: a list over rows of lists over
    columns (the per-device form of :func:`sharded_divergence_2d`)."""
    dr, dk = grid.shape
    if x.shape[0] % dr:
        raise ValueError(f"replica count {x.shape[0]} not divisible by mesh axis {dr}")
    if x.shape[1] % dk:
        raise ValueError(f"key count {x.shape[1]} not divisible by mesh axis {dk}")
    return [[_to(blk, grid[i, j], dtype) for j, blk in enumerate(_split(row, dk, 1))]
            for i, row in enumerate(_split(x, dr, 0))]


def _checked_blocks(x, grid: np.ndarray, dtype: torch.dtype) -> list[list[torch.Tensor]]:
    """The per-device form as given: a list over ``grid``'s rows of
    :func:`_shards`-checked rows, every block of one shape."""
    if len(x) != grid.shape[0]:
        raise ValueError(f"{len(x)} rows of per-device blocks for {grid.shape[0]} replica shards")
    blocks = [_shards(row, list(grid[i]), 1, dtype) for i, row in enumerate(x)]
    shapes = {tuple(t.shape) for row in blocks for t in row}
    if len(shapes) != 1:
        raise ValueError(f"per-device blocks differ in shape: {sorted(shapes)}")
    return blocks


def sharded_divergence_2d(
    mesh: Mesh,
    digests,
    present,
    replica_axis: str = "replica",
    key_axis: str = "key",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Replica-AND-keyspace-sharded divergence for large fleets.

    Over a 2-D ``(replica, key)`` mesh of Dr x Dk devices each device holds
    an [R/Dr, N/Dk] block. Reference replica 0 lives in the first replica
    shard: each key column takes just that shard's row 0 (digests and
    presence) — the JAX program's one-row ``all_gather`` — never the other
    replicas' blocks. Per-replica counts are summed over the key axis only.

    Inputs: digests [R, N, 8] uint32 and present [R, N] bool (numpy, or
    tensors), R and N divisible by their mesh axes; or the per-device form
    of both (``multihost.lift_local_blocks``: lists over this process's
    replica shards of lists over its key shards, each block on its device).
    A mesh that spans processes takes the per-device form only. There the
    reference rows of this process's key columns come from the process
    holding replica shard 0 by one ``broadcast`` over
    ``mesh.replica_group`` (digests, then presence as bytes); nothing else
    crosses but the counts.

    Returns (masks, counts), both on the first device of this process's
    grid. masks: bool, this process's block of the [R, N] masks,
    ``[R/Dr * rows, N/Dk * columns]`` for its ``rows x columns`` devices,
    whose element (0, 0) is replica ``mesh.origin[replica] * R/Dr``, key
    ``mesh.origin[key] * N/Dk`` (in one process: the whole [R, N]).
    counts: [R] int32, the same on every process (across processes an
    ``all_reduce`` sum of a zero-filled [R] buffer holding each process's
    rows).
    """
    grid = _grid(mesh, replica_axis, key_axis)
    lr, lc = grid.shape
    dr, dk = mesh.global_shape[replica_axis], mesh.global_shape[key_axis]
    row0 = mesh.origin[mesh.axis_names.index(replica_axis)]
    if _per_device(digests):
        dig = _checked_blocks(digests, grid, torch.int32)
        pres = _checked_blocks(present, grid, torch.bool)
        rb, nb = dig[0][0].shape[0], dig[0][0].shape[1]
        if tuple(pres[0][0].shape) != (rb, nb):
            raise ValueError(f"present blocks {tuple(pres[0][0].shape)} for digest blocks {(rb, nb)}")
    elif mesh.spans_processes:
        raise ValueError("across processes sharded_divergence_2d takes the per-device form "
                         "(multihost.lift_local_blocks)")
    else:
        dig = grid_blocks(digests, grid, torch.int32)
        pres = grid_blocks(present, grid, torch.bool)
        rb, nb = digests.shape[0] // dr, digests.shape[1] // dk
    dev0 = grid[0, 0]

    # Replica 0's rows of this process's key columns, on each column's
    # first device: held here, or broadcast by the process that holds them.
    if row0 == 0:
        refs = [(dig[0][j][:1], pres[0][j][:1]) for j in range(lc)]
    else:
        refs = None
    if mesh.replica_group is not None:
        import torch.distributed as dist

        group, src = mesh.replica_group
        if refs is not None:
            ref_d = torch.cat([d[0].to(dev0) for d, _ in refs])
            ref_p = torch.cat([p[0].to(dev0) for _, p in refs])
        else:
            ref_d = torch.empty((lc * nb, 8), dtype=torch.int32, device=dev0)
            ref_p = torch.empty(lc * nb, dtype=torch.bool, device=dev0)
        dist.broadcast(ref_d, src, group=group)
        dist.broadcast(ref_p.view(torch.uint8), src, group=group)
        refs = [(ref_d[None, j * nb:(j + 1) * nb], ref_p[None, j * nb:(j + 1) * nb])
                for j in range(lc)]
    elif refs is None:
        raise ValueError("this process holds no replica shard 0 and its mesh has no replica group")

    rows, local_counts = [], []
    for i in range(lr):
        row_masks = []
        for j in range(lc):
            dev = grid[i, j]
            ref_d, ref_p = refs[j][0].to(dev), refs[j][1].to(dev)
            row_masks.append(divergence_vs_ref(dig[i][j], pres[i][j], ref_d, ref_p))
        local_counts.append(_psum([m.sum(dim=1, dtype=torch.int32) for m in row_masks], grid[i, 0]))
        rows.append(_gather(row_masks, grid[i, 0], dim=1))
    counts = torch.zeros(rb * dr, dtype=torch.int32, device=dev0)
    counts[row0 * rb:(row0 + lr) * rb] = _gather(local_counts, dev0)
    if mesh.spans_processes:
        import torch.distributed as dist

        dist.all_reduce(counts, group=mesh.group)
    return _gather(rows, dev0), counts


def make_anti_entropy_step(mesh: Mesh, axis: str = "key"):
    """The fused anti-entropy step over a keyspace-sharded mesh, as a plain
    function ``step(blocks, nblocks, digests, present)`` (the JAX package
    returns a compiled program):

      1. hash every local (key, value) leaf on its shard's device;
      2. compare R replicas' digest blocks elementwise on each shard's
         device (masks and per-replica counts), on a card beside the leaf
         hash (``merkle.torch_engine.DiffBeside``: the card's
         high-priority side stream, a grid of one block an SM), and
         gather the masks on the first device (:class:`_ColumnGather`: on
         distinct cards by the copy engines, each card's as its diff ends);
      3. reduce the local leaves to the shard's seam, wait for the shard's
         diff, copy the D seams to the first device and finish the tree
         there (see the module's note: any L >= 1 leaves a shard; an odd L
         sends every leaf there); sum the per-replica counts; wait for the
         masks.

    The diff reads nothing the leaf hash writes, so running it beside the
    leaf hash changes no answer: the diff takes the bytes, the leaf hash
    the integer pipes, and the masks cross to the first card while the
    cards hash their leaves.

    Inputs (global shapes, numpy arrays or tensors; N divisible by the
    mesh axis):
      blocks  [N, B, 16] uint32 — padded SHA-256 blocks
      nblocks [N] int32         — valid block count per leaf
      digests [R, N, 8] uint32  — R replicas' leaf digests
      present [R, N] bool
    or the per-device form of each (one shard per device, already there:
    ``multihost.lift_local_shards``). Returns (root [8] int32, masks [R, N]
    bool, counts [R] int32), all on the axis's first device; the masks are
    one contiguous tensor. Across processes the inputs are this rank's
    rows: root and counts cover every rank and are the same on each, the
    masks are this rank's rows.

    While a profiler session records on the calling thread, a step is the
    device span ``ae.cycle`` on the first device; in it each shard's
    ``ae.leaf`` on the shard's device, then each shard's ``ae.diff`` (its
    masks and counts) on the stream that runs it, then ``ae.gather`` on
    the first device (the masks' copies, on the stream that runs them: the
    copy stream on distinct cards), then each shard's ``ae.levels`` (its
    seam) and ``ae.diff_wait`` (its current stream's wait for its diff:
    the part the leaf hash and the levels did not hide), then
    ``ae.combine`` on the first device (the counts' sum, the tree's
    finish, the wait for the masks), and inside it ``ae.seam`` (the seams'
    gather and the tree's finish) and ``ae.gather_wait`` (the first
    device's wait for the masks' copies: the part of the gather the leaf
    hash did not hide). Each step adds 1 to the counter
    ``device.ae_mesh_steps`` and to ``device.ae_combine_bytes`` the bytes
    of the seams, masks and counts of every shard after the first: what
    crosses to the first device when the shards are on distinct cards
    (across processes, this rank's); each shard's diff on a card adds 1 to
    ``device.ae_diff_overlapped``.
    """
    devs = mesh.axis_devices(axis)
    d = len(devs)

    def step(blocks, nblocks, digests, present):
        _shard_len(_rows(blocks, 0, d), d)
        with device_span("ae.cycle", devs[0]):
            # Every card's leaf hash is queued first, so that none waits on
            # the host's launches; each diff then takes the next slot a leaf
            # block frees on each SM. The inputs stay referenced (in the
            # diffs) until each diff is waited for.
            diffs = [DiffBeside(dev, dig, pres) for dev, dig, pres in
                     zip(devs, _shards(digests, devs, 1), _shards(present, devs, 1, torch.bool))]
            leaves = []
            for dev, blk, nb in zip(devs, _shards(blocks, devs, 0), _shards(nblocks, devs, 0)):
                with device_span("ae.leaf", dev):
                    leaves.append(hash_blocks(blk, nb))
            for diff in diffs:
                diff.start()
            masks, counts = [d.masks for d in diffs], [d.counts for d in diffs]
            gather = _ColumnGather(masks, devs, "ae.gather", ready=[d.done for d in diffs])
            seams = []
            for s, (dev, diff) in enumerate(zip(devs, diffs)):
                with device_span("ae.levels", dev):
                    seams.append(_seam(leaves[s]))
                leaves[s] = None
                diff.wait()
            with device_span("ae.combine", devs[0]):
                total = _psum(counts, devs[0], mesh)
                with device_span("ae.seam", devs[0]):
                    root = _finish_root(seams, devs[0], mesh)
                with device_span("ae.gather_wait", devs[0]):
                    gathered = gather.join()
        metrics = get_metrics()
        metrics.inc("device.ae_mesh_steps")
        metrics.inc("device.ae_combine_bytes",
                    sum(t.nbytes for part in (seams, masks, counts) for t in part[1:]))
        return root, gathered, total

    return step


def sharded_anti_entropy_step(
    mesh: Mesh, blocks, nblocks, digests, present, axis: str = "key"
):
    """Run the fused hash+build+diff step (see :func:`make_anti_entropy_step`)."""
    d = mesh.shape[axis]
    n = _rows(blocks, 0, d)
    _shard_len(n, d)
    if _rows(digests, 1, d) != n:
        raise ValueError(
            f"digest key axis {_rows(digests, 1, d)} != leaf count {n}"
        )
    return make_anti_entropy_step(mesh, axis)(blocks, nblocks, digests, present)


# --------------------------------------------------------------------------
# Serving-tree helpers (the ShardedDeviceMerkleState backend).
#
# The padded tree at capacity C = D * L (L a power of two) decomposes like
# the root above, each shard's seam being its root:
# shard s holds the levels of leaves [s*L, (s+1)*L) — sizes L .. 1, every
# pair merge inside the shard — and concatenating the shards' level j gives
# the global padded level j. Only the log2(D) top levels combine shards:
# the D shard roots are copied to the first device and reduced there. The
# top tree's level 0 is the global level of size D. A shard may hold one
# leaf (L = 1, when the keyspace is smaller than D): its only level is its
# root, and the top tree does the rest.


def _top_levels(shard_levels: Sequence[list], dev: torch.device) -> list[torch.Tensor]:
    """The top tree over the shard roots, on ``dev``: sizes D .. 1."""
    return build_levels(_gather([lv[-1] for lv in shard_levels], dev))


def _hash_into(leaves: Sequence[torch.Tensor], pos: np.ndarray, blocks: np.ndarray,
               nblocks: np.ndarray) -> None:
    """Hash the packed leaves whose global slots are the sorted ``pos`` on
    the device of the shard each falls in, and write them there."""
    l = leaves[0].shape[0]
    bounds = np.searchsorted(pos, np.arange(len(leaves) + 1) * l)
    for s, lv in enumerate(leaves):
        a, b = bounds[s], bounds[s + 1]
        if a == b:
            continue
        dev = lv.device
        digests = hash_blocks(as_tensor(blocks[a:b], dev), as_tensor(nblocks[a:b], dev))
        lv.index_put_((as_tensor(pos[a:b] - s * l, dev, torch.int64),), digests)


def sharded_build(devices: Sequence[torch.device], capacity: int, blocks: np.ndarray,
                  nblocks: np.ndarray) -> tuple[list, list]:
    """The n packed leaves (slots 0 .. n-1 of a zero-padded capacity) ->
    (per-shard levels, top levels): each shard hashes and reduces its own
    slice on its own device."""
    l = _check_shardable(capacity, len(devices), "capacity")
    leaves = [torch.zeros((l, 8), dtype=torch.int32, device=dev) for dev in devices]
    _hash_into(leaves, np.arange(len(nblocks)), blocks, nblocks)
    shards = [build_levels(lv) for lv in leaves]
    return shards, _top_levels(shards, devices[0])


def sharded_scatter(shard_levels: list, top: list, counters: list, blocks: np.ndarray,
                    nblocks: np.ndarray, pos: np.ndarray) -> list:
    """Value batch of the k packed leaves at the sorted unique global slots
    ``pos``, routed per shard on the host: each shard that received keys
    runs one fused ``path_rehash`` launch over its local levels (one-leaf
    shards write their leaf), in place; then the touched shard roots are
    copied into the top tree's level 0 and the top tree is reduced again.
    ``counters[s]`` is shard s's path-rehash scratch, made here when missing.
    Returns the new top levels."""
    d = len(shard_levels)
    l = shard_levels[0][0].shape[0]
    bounds = np.searchsorted(pos, np.arange(d + 1) * l)
    for s, lv in enumerate(shard_levels):
        a, b = bounds[s], bounds[s + 1]
        if a == b:
            continue
        dev = lv[0].device
        blk, nb = as_tensor(blocks[a:b], dev), as_tensor(nblocks[a:b], dev)
        if l == 1:
            lv[0].copy_(hash_blocks(blk, nb))
        else:
            if counters[s] is None:
                counters[s] = path_scratch(l, dev)
            rehash_paths(lv, counters[s], blk, nb, pos[a:b] - s * l)
        top[0][s : s + 1].copy_(lv[-1])
    return build_levels(top[0])


def sharded_restructure(old_leaves: Sequence[torch.Tensor], devices: Sequence[torch.device],
                        c_new: int, gather_padded: np.ndarray, fresh_pos: np.ndarray,
                        blocks: np.ndarray, nblocks: np.ndarray) -> tuple[list, list]:
    """Shape change over the shards. ``gather_padded`` [c_new] holds each
    new slot's source slot in the old leaf level, or -1; its non-negative
    entries increase, so new shard t pulls one run of sources from each of
    a few old shards. Planned on the host: per (new shard, old shard) pair,
    the survivors are gathered on the old shard's device, copied to the new
    one and written into their slots. Then the fresh digests are hashed on
    the shard each falls in, and every shard is reduced. Survivors are never
    re-hashed. Returns (per-shard levels, top levels)."""
    d = len(devices)
    l_old = old_leaves[0].shape[0]
    l_new = _check_shardable(c_new, d, "capacity")
    new_leaves = []
    for t, dev in enumerate(devices):
        base = torch.zeros((l_new, 8), dtype=torch.int32, device=dev)
        g = gather_padded[t * l_new : (t + 1) * l_new]
        dst = np.flatnonzero(g >= 0)
        src = g[dst]
        cuts = np.searchsorted(src, np.arange(d + 1) * l_old)
        for s in range(d):
            a, b = cuts[s], cuts[s + 1]
            if a == b:
                continue
            old = old_leaves[s]
            vals = old[as_tensor(src[a:b] - s * l_old, old.device, torch.int64)]
            base[as_tensor(dst[a:b], dev, torch.int64)] = vals.to(dev)
        new_leaves.append(base)
    _hash_into(new_leaves, fresh_pos, blocks, nblocks)
    shards = [build_levels(lv) for lv in new_leaves]
    return shards, _top_levels(shards, devices[0])


def sharded_promotion_chain(shard_levels: list, top: list, n: int) -> torch.Tensor:
    """[len(ref_level_sizes(n)), 8] on the top tree's device: the reference
    tree's last node at every level over the first n live leaves, the last
    row its root (the sharded form of ``ops/merkle_paths.promotion_chain``).

    With L leaves per shard, the chain's nodes below the shard-root level
    all lie in shard s = (n - 1) // L, and there it equals shard s's own
    chain over its n - s*L live leaves: the two trees' indices differ by
    s*L / 2^j, even at every level j < log2 L, so the odd levels match.
    Above it, the chain is the top tree's chain over s + 1 shard roots with
    row s replaced by shard s's local reference root. Two promotion-chain
    launches (one when D = 1 or L = 1)."""
    d = len(shard_levels)
    l = shard_levels[0][0].shape[0]
    depth = l.bit_length() - 1  # log2 L: the shard-root level
    s = (n - 1) // l
    lv = shard_levels[s]
    local = lv[0][n - 1 - s * l : n - s * l] if l == 1 else promotion_chain(lv, n - s * l)
    dev = top[0].device
    local = local.to(dev)
    root_s = local[-1:]
    below = torch.cat([local, root_s.expand(depth + 1 - local.shape[0], 8)])[:depth]
    if d == 1:
        above = root_s
    else:
        top0 = top[0].clone()
        top0[s : s + 1] = root_s
        above = promotion_chain([top0, *top[1:]], s + 1)
    return torch.cat([below, above])[: len(ref_level_sizes(n))]
