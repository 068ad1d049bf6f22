"""Multi-process keyspace mesh over ``torch.distributed`` (counterpart of
``merklekv_tpu/parallel/multihost.py``).

The JAX module joins a ``jax.distributed`` cluster and runs one compiled
program over a global mesh whose collectives cross the host boundary. Here
every rank runs the same Python step over its own devices and the step's
two collectives — the gather of subtree roots and the sum of divergence
counts — go through a ``torch.distributed`` process group
(``parallel/sharded_merkle.py``):

    from merklekv_tpu_torch.parallel import multihost
    multihost.initialize()                      # no-op when single-process
    mesh = multihost.global_key_mesh()
    blocks, nblocks, digests, present = multihost.lift_local_shards(
        mesh, blocks_local, nblocks_local, digests_local, present_local)
    root, masks, counts = sharded_anti_entropy_step(
        mesh, blocks, nblocks, digests, present)

Every rank gets the same root and counts; ``masks`` holds this rank's rows.

The 2-D ``(replica, key)`` diff across processes (BASELINE config 5: many
replicas, where one rank cannot hold every replica's digests):

    mesh = multihost.global_key_mesh(replicas=dr)
    digests, present = multihost.lift_local_blocks(mesh, dig_block, pres_block)
    masks, counts = sharded_divergence_2d(mesh, digests, present)

Each rank brings only its block of replica rows and keys; replica 0's rows
reach the other ranks of their key columns by one ``broadcast`` over
``Mesh.replica_group``; every rank gets the full [R] counts and its own
block of the masks.

The backend follows the ranks' devices: gloo where they compute on the CPU
(``MERKLEKV_TORCH_DEVICE=cpu``), NCCL where each rank owns its own cards
(one rank per card: give each rank one card with ``CUDA_VISIBLE_DEVICES``).
NCCL refuses two ranks on one card, so ranks that share a card name gloo
themselves (``initialize(..., backend="gloo")``); gloo carries CUDA tensors
through ``broadcast`` and ``all_reduce``, the only collectives used here. The choice is
made once, before the group forms: nothing here switches backend after a
failure.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from merklekv_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_devices
from merklekv_tpu_torch.utils import deviceenv
from merklekv_tpu_torch.utils.torchenv import as_tensor

__all__ = [
    "initialize",
    "is_initialized",
    "process_count",
    "process_index",
    "global_key_mesh",
    "spanning_mesh",
    "lift_local_shards",
    "lift_local_blocks",
]


def initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
) -> None:
    """Join (or form) the ``torch.distributed`` process group.

    Args fall back to ``MKV_COORDINATOR`` (host:port of process 0, where
    rank 0 serves the rendezvous store), ``MKV_NUM_PROCESSES``, and
    ``MKV_PROCESS_ID``. With no coordinator configured (the single-host
    case) this is a no-op — every helper below degrades to plain
    single-process behavior, so callers can invoke it unconditionally at
    startup. A second call is a no-op too.

    ``backend``: ``"gloo"`` or ``"nccl"``; default gloo when the node's
    device is the CPU, else NCCL. Ranks that share one card must pass
    ``"gloo"``.

    Run it before the first device touch in the process, as the JAX
    function requires.
    """
    coordinator = coordinator or os.environ.get("MKV_COORDINATOR", "")
    if not coordinator or is_initialized():
        return
    if num_processes is None:
        env = os.environ.get("MKV_NUM_PROCESSES")
        if env is None:
            raise ValueError(
                "multihost.initialize: coordinator is set but the process "
                "count is not — pass num_processes or set MKV_NUM_PROCESSES"
            )
        num_processes = int(env)
    if process_id is None:
        env = os.environ.get("MKV_PROCESS_ID")
        if env is None:
            raise ValueError(
                "multihost.initialize: coordinator is set but this "
                "process's rank is not — pass process_id or set "
                "MKV_PROCESS_ID"
            )
        process_id = int(env)
    if backend is None:
        backend = "gloo" if deviceenv.device_name() == "cpu" else "nccl"
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"multihost.initialize: backend must be gloo or nccl, got {backend!r}")
    torch.distributed.init_process_group(
        backend=backend,
        init_method=f"tcp://{coordinator}",
        world_size=num_processes,
        rank=process_id,
    )


def is_initialized() -> bool:
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def process_count() -> int:
    return torch.distributed.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return torch.distributed.get_rank() if is_initialized() else 0


def global_key_mesh(replicas: int = 0) -> Mesh:
    """The keyspace mesh over every rank's devices, as this rank holds it:
    a :class:`Mesh` over this rank's devices (its CPU, or every card it
    sees) that records where they sit in the global grid, the rank, the
    world size and the default process group. Ranks are expected to bring
    the same number of devices.

    Ranks on one host see every card of the host unless each is given its
    own with ``CUDA_VISIBLE_DEVICES``; a card claimed by two ranks is
    refused here (:func:`_check_cards_disjoint`), except the one-card shape
    where every rank sees that card alone and the group runs over gloo.

    Default: one ``key`` axis (keyspace data parallelism across ranks).
    ``replicas > 0`` adds a leading ``replica`` axis of that size: the
    global device list (rank 0's devices first) reshaped to ``(replicas,
    n // replicas)``, as the JAX ``make_mesh`` does. Across processes each
    rank's devices must form a rectangle of that grid (a whole number of
    rows, or an equal share of one row); the mesh then also holds the
    process group that carries replica shard 0's rows to the other ranks
    of its key columns (``Mesh.replica_group``). Every rank must call this
    together: forming that group is a collective.
    """
    local = shard_devices(deviceenv.resolve())
    world = process_count()
    n = world * len(local)
    if replicas > 0 and n % replicas:
        raise ValueError(
            f"{n} devices not divisible by replicas={replicas}"
        )
    if world == 1:
        sizes = {"replica": replicas, "key": n // replicas} if replicas > 0 else {"key": n}
        return make_mesh(sizes, devices=local)
    _check_cards_disjoint(local)
    return spanning_mesh(local, replicas)


def _block_of(rank: int, l: int, cols: int) -> tuple[int, int, int, int]:
    """(first row, first column, rows, columns) of the block that rank
    ``rank``'s ``l`` devices take in a row-major grid ``cols`` wide."""
    first = rank * l
    if l <= cols and cols % l == 0:
        return first // cols, first % cols, 1, l
    if l > cols and l % cols == 0:
        return first // cols, 0, l // cols, cols
    raise ValueError(
        f"multihost.global_key_mesh: each rank's {l} devices must fill whole rows "
        f"or an equal share of one row of a grid {cols} wide"
    )


def spanning_mesh(local: Sequence[torch.device], replicas: int = 0) -> Mesh:
    """The mesh of :func:`global_key_mesh` across processes, over ``local``
    as this rank's devices (which may repeat a device, as in the tests),
    without the card checks. ``replicas > 0``: the 2-D ``(replica, key)``
    mesh, which forms the replica-axis process groups — every rank calls
    ``new_group`` for each group, in the same order."""
    rank, world, l = process_index(), process_count(), len(local)
    world_group = torch.distributed.group.WORLD
    arr = np.empty(l, dtype=object)
    arr[:] = [torch.device(d) for d in local]
    if replicas <= 0:
        return Mesh(arr, ("key",), rank, world, world_group,
                    origin=(rank * l,), global_shape=(world * l,))
    cols = world * l // replicas
    blocks = [_block_of(q, l, cols) for q in range(world)]
    by_columns: dict[tuple[int, int], list[int]] = {}
    for q, (_, c0, _, nc) in enumerate(blocks):
        by_columns.setdefault((c0, nc), []).append(q)
    mine = None
    for key in sorted(by_columns):
        members = by_columns[key]
        if len(members) < 2:
            continue
        group = world_group if len(members) == world else torch.distributed.new_group(members)
        if rank in members:
            mine = (group, next(q for q in members if blocks[q][0] == 0))
    r0, c0, nr, nc = blocks[rank]
    return Mesh(arr.reshape(nr, nc), ("replica", "key"), rank, world, world_group,
                origin=(r0, c0), global_shape=(replicas, cols), replica_group=mine)


def _check_cards_disjoint(local: Sequence[torch.device]) -> None:
    """Gather every rank's card UUIDs and raise if a card is claimed twice
    (:func:`_card_overlap`). The gather runs over a gloo side group, since
    NCCL cannot run a collective among ranks that share a card."""
    mine = sorted({str(torch.cuda.get_device_properties(d).uuid)
                   for d in local if d.type == "cuda"})
    side = torch.distributed.new_group(backend="gloo")
    try:
        claims: list = [None] * process_count()
        torch.distributed.all_gather_object(claims, mine, group=side)
    finally:
        torch.distributed.destroy_process_group(side)
    err = _card_overlap(claims, torch.distributed.get_backend())
    if err:
        raise ValueError(err)


def _card_overlap(claims: Sequence[Sequence[str]], backend: str) -> Optional[str]:
    """Why the ranks' card claims (``claims[rank]``: card UUIDs) cannot
    form a mesh, or ``None``. Two ranks may share a card only when each
    sees that card alone and the backend is gloo."""
    owner: dict[str, int] = {}
    for rank, cards in enumerate(claims):
        for card in cards:
            other = owner.setdefault(card, rank)
            if other == rank:
                continue
            if len(cards) > 1 or len(claims[other]) > 1:
                return (f"multihost.global_key_mesh: ranks {other} and {rank} both "
                        f"claim card {card}; give each rank on a host its own cards "
                        "with CUDA_VISIBLE_DEVICES")
            if backend != "gloo":
                return (f"multihost.global_key_mesh: ranks {other} and {rank} share "
                        f"card {card} over {backend}, which refuses two ranks on one "
                        "card; ranks that share a card pass initialize(backend=\"gloo\")")
    return None


def _check_same_on_every_rank(mesh: Mesh, dev: torch.device, what: str, sizes: list) -> None:
    """Raise unless every rank of a spanning ``mesh`` brings these
    ``sizes`` (one ``all_reduce`` of their maxima and negated minima)."""
    if not mesh.spans_processes:
        return
    spread = torch.tensor(sizes + [-v for v in sizes], dtype=torch.int64, device=dev)
    torch.distributed.all_reduce(spread, op=torch.distributed.ReduceOp.MAX, group=mesh.group)
    hi, lo = spread[:len(sizes)].tolist(), [-v for v in spread[len(sizes):].tolist()]
    if hi != sizes or lo != sizes:
        raise ValueError(f"ranks bring {what} from {lo} to {hi}; every rank must bring the same")


def lift_local_shards(
    mesh: Mesh,
    blocks_local,
    nblocks_local,
    digests_local,
    present_local,
    axis: str = "key",
):
    """This rank's anti-entropy inputs -> per-device shard lists on its
    devices (the per-device form of ``parallel/sharded_merkle.py``).

    Each rank passes the rows IT owns: ``blocks_local [n_local, B, 16]``,
    ``nblocks_local [n_local]``, ``digests_local [R, n_local, 8]``,
    ``present_local [R, n_local]`` (numpy arrays or tensors) — where
    n_local is its contiguous slice of the sorted global keyspace, in rank
    order (rank 0 owns the first slice). Each device of ``axis`` gets
    n_local / D consecutive rows; replica-major inputs split on their key
    dimension. Across processes every rank must bring the same n_local
    (checked with one ``all_reduce``).

    Single-process: the same call, which splits the rows over the local
    devices.
    """
    devs = mesh.axis_devices(axis)
    d = len(devs)
    n = blocks_local.shape[0]
    if n % d:
        raise ValueError(f"local leaf count {n} not divisible by mesh axis {d}")
    if digests_local.shape[1] != n or present_local.shape[1] != n or nblocks_local.shape[0] != n:
        raise ValueError("local inputs disagree on the key count")
    _check_same_on_every_rank(mesh, devs[0], "local rows", [n])
    l = n // d

    def cut(x, dim, dtype=torch.int32):
        return [as_tensor(x[(slice(None),) * dim + (slice(s * l, (s + 1) * l),)], dev, dtype)
                for s, dev in enumerate(devs)]

    return (cut(blocks_local, 0), cut(nblocks_local, 0), cut(digests_local, 1),
            cut(present_local, 1, torch.bool))


def lift_local_blocks(
    mesh: Mesh,
    digests_local,
    present_local,
    replica_axis: str = "replica",
    key_axis: str = "key",
):
    """This rank's block of a 2-D diff's inputs -> the per-device form of
    ``sharded_divergence_2d`` (the JAX package reaches it through
    ``make_array_from_process_local_data`` with ``P("replica", "key",
    None)``).

    Each rank passes only the block its devices hold: ``digests_local
    [R_local, n_local, 8]`` and ``present_local [R_local, n_local]`` (numpy
    arrays or tensors), the replica rows ``mesh.origin[replica] * R / Dr``
    onward and the keys ``mesh.origin[key] * N / Dk`` onward, where ``Dr,
    Dk = mesh.global_shape``. Returns ``(digests, present)``, each a list
    over this rank's replica shards of lists over its key shards: one
    ``[R / Dr, N / Dk(, 8)]`` tensor per device, on that device. Across
    processes every rank must bring the same block shape (checked with one
    ``all_reduce``). Single-process: the same call over the whole [R, N].
    """
    from merklekv_tpu_torch.parallel.sharded_merkle import _grid, grid_blocks

    grid = _grid(mesh, replica_axis, key_axis)
    r, n = digests_local.shape[0], digests_local.shape[1]
    if tuple(present_local.shape) != (r, n):
        raise ValueError(f"present {tuple(present_local.shape)} for digests {(r, n)}")
    _check_same_on_every_rank(mesh, grid[0, 0], "blocks of (replicas, keys)", [r, n])
    return (grid_blocks(digests_local, grid, torch.int32),
            grid_blocks(present_local, grid, torch.bool))
