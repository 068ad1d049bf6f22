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

The backend follows the ranks' devices: gloo where they compute on the CPU
(``MERKLEKV_TORCH_DEVICE=cpu``), NCCL where each rank owns its own cards
(one rank per card: give each rank one card with ``CUDA_VISIBLE_DEVICES``).
NCCL refuses two ranks on one card, so ranks that share a card name gloo
themselves (``initialize(..., backend="gloo")``); gloo carries CUDA tensors
through ``all_reduce``, the only collective the step uses. The choice is
made once, before the group forms: nothing here switches backend after a
failure.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch

from merklekv_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_devices
from merklekv_tpu_torch.unported import refuse
from merklekv_tpu_torch.utils import deviceenv
from merklekv_tpu_torch.utils.torchenv import as_tensor

__all__ = [
    "initialize",
    "is_initialized",
    "process_count",
    "process_index",
    "global_key_mesh",
    "lift_local_shards",
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
    sees) that records the rank, the world size and the default process
    group. Ranks are expected to bring the same number of devices.

    Ranks on one host see every card of the host unless each is given its
    own with ``CUDA_VISIBLE_DEVICES``; a card claimed by two ranks is
    refused here (:func:`_check_cards_disjoint`), except the one-card shape
    where every rank sees that card alone and the group runs over gloo.

    Default: one ``key`` axis (keyspace data parallelism across ranks).
    ``replicas > 0`` adds a leading ``replica`` axis of that size; across
    processes that 2-D mesh is not in the port yet (``NotImplementedError``).
    """
    local = shard_devices(deviceenv.resolve())
    world = process_count()
    n = world * len(local)
    if replicas > 0:
        if n % replicas:
            raise ValueError(
                f"{n} devices not divisible by replicas={replicas}"
            )
        if world > 1:
            refuse("multihost_2d")
        return make_mesh({"replica": replicas, "key": n // replicas}, devices=local)
    mesh = make_mesh({"key": len(local)}, devices=local)
    if world == 1:
        return mesh
    _check_cards_disjoint(local)
    return Mesh(mesh.devices, mesh.axis_names, process_index=process_index(),
                process_count=world, group=torch.distributed.group.WORLD)


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
    if mesh.spans_processes:
        spread = torch.tensor([n, -n], dtype=torch.int64, device=devs[0])
        torch.distributed.all_reduce(spread, op=torch.distributed.ReduceOp.MAX, group=mesh.group)
        hi, lo = int(spread[0]), -int(spread[1])
        if hi != n or lo != n:
            raise ValueError(f"ranks bring {lo}..{hi} local rows; every rank must bring the same")
    l = n // d

    def cut(x, dim, dtype=torch.int32):
        return [as_tensor(x[(slice(None),) * dim + (slice(s * l, (s + 1) * l),)], dev, dtype)
                for s, dev in enumerate(devs)]

    return (cut(blocks_local, 0), cut(nblocks_local, 0), cut(digests_local, 1),
            cut(present_local, 1, torch.bool))
