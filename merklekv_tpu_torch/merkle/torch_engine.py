"""Merkle engine on torch tensors: whole-keyspace hashing and tree build.

Counterpart of ``merklekv_tpu/merkle/jax_engine.py``. Every SHA-256 call goes
through ``ops/dispatch.py``, so on a CUDA tensor the hand-written kernels run
and on a CPU tensor their plain versions do. The odd-node promotion rule of
the reference tree is reproduced exactly, so roots are bit-identical to the
CPU golden tree and to the JAX package.

Two build paths, as in the JAX engine:
- **static** (``tree_root``, ``build_levels_device``): level sizes follow the
  exact leaf count N; one level-kernel launch per level.
- **capacity** (``tree_root_capacity``): leaves padded to a power-of-two
  capacity C, valid for any live count n <= C. PyTorch runs eagerly, so ``n``
  is a host integer and the promotion is a host-side branch plus one row
  write per odd level.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np
import torch

from merklekv_tpu_torch.merkle.ragged import RaggedLeaves
from merklekv_tpu_torch.ops.dispatch import (
    build_levels,
    divergence,
    divergence_beside,
    hash_blocks,
    hash_node_level,
    hash_ragged,
)
from merklekv_tpu_torch.ops.sha256 import digest_to_bytes, digests_to_bytes
from merklekv_tpu_torch.utils.torchenv import as_tensor, resolve_device, words_np
from merklekv_tpu_torch.utils.tracing import device_span, get_metrics

__all__ = [
    "leaf_digests",
    "ragged_digests",
    "build_levels_device",
    "tree_root",
    "tree_root_capacity",
    "anti_entropy_forward",
    "DiffBeside",
    "diff_stream",
    "TorchMerkleTree",
]


def anti_entropy_forward(blocks, nblocks, digests, present, device=None):
    """The single-device data-plane step: hash every leaf, reduce to the tree
    root, and compute R-replica divergence.

    blocks [N, B, 16] u32, nblocks [N] i32, digests [R, N, 8] u32,
    present [R, N] bool — numpy arrays or tensors (uint32 words as int32
    tensors) — moved to ``device`` (``None`` = CUDA). In place of the padded
    ``(blocks, nblocks)``, ``blocks`` may be a ragged leaf set on ``device``
    (:class:`merkle.ragged.RaggedLeaves`) with ``nblocks`` None: its leaves
    are hashed by :func:`ragged_digests`.
    Returns (root [8] int32, masks [R, N] bool, counts [R] int32) on device.

    On a card the diff runs beside the leaf hash and the levels
    (:class:`DiffBeside`): it reads nothing the tree writes. The results
    come back once the current stream has waited for it, so a caller's
    reads on that stream, and whatever it allocates next, come after the
    diff.

    While a profiler session records on the calling thread, the step is the
    device span ``ae.cycle`` with the phases ``ae.leaf`` (hash every leaf),
    ``ae.diff`` (the masks and the counts, on the side stream), ``ae.levels``
    (the tree) and ``ae.diff_wait`` (the current stream's wait for the diff:
    the part of it the leaf hash and the levels did not hide) in it
    (``utils.tracing.device_span``); the copy of a host array of blocks to
    the device falls in ``ae.leaf``, of digests or presence before it.
    """
    dev = resolve_device(device)
    with device_span("ae.cycle", dev):
        diff = DiffBeside(dev, as_tensor(digests, dev), as_tensor(present, dev, torch.bool))
        with device_span("ae.leaf", dev):
            if isinstance(blocks, RaggedLeaves):
                leaves = ragged_digests(blocks)
            else:
                leaves = hash_blocks(as_tensor(blocks, dev), as_tensor(nblocks, dev))
        diff.start()
        with device_span("ae.levels", dev):
            root = build_levels(leaves)[-1][0]
        diff.wait()
    return root, diff.masks, diff.counts


# ---------------------------------------------------- the diff beside the tree

_diff_streams: dict = {}
_diff_streams_lock = threading.Lock()


def diff_stream(dev: torch.device) -> torch.cuda.Stream:
    """Card ``dev``'s high-priority side stream for the diff, made at first
    use and kept."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    with _diff_streams_lock:
        stream = _diff_streams.get(index)
        if stream is None:
            stream = _diff_streams[index] = torch.cuda.Stream(index, priority=-1)
        return stream


class DiffBeside:
    """The N-replica diff of ``digests`` [R, N, 8] and ``present`` [R, N]
    (on ``dev``), run beside the leaf hash that the caller queues on the
    current stream between making this object and :meth:`start`.

    On a card: made, it makes ``masks`` and ``counts`` on the current
    stream (the counts zeroed there) and marks the current stream's work so
    far (the caller's writes of the inputs); :meth:`start` has the card's
    side stream (:func:`diff_stream`) wait for that mark alone, not for the
    leaf hash queued since, and runs the kernel there in its co-resident
    shape (``ops.dispatch.divergence_beside``): a high-priority grid of one
    block an SM, which takes the next slot a leaf block frees on each SM;
    :meth:`wait` makes the current stream wait for it. The caller calls
    :meth:`wait` before any reader of the results, and keeps the inputs
    alive until then. Each started diff adds 1 to the counter
    ``device.ae_diff_overlapped``. On the CPU :meth:`start` runs the diff
    in turn and :meth:`wait` waits for nothing. The device spans are
    ``ae.diff`` (on the stream that runs the diff) and ``ae.diff_wait``
    (on the current stream).
    """

    def __init__(self, dev: torch.device, digests: torch.Tensor, present: torch.Tensor) -> None:
        self.dev, self.digests, self.present = dev, digests, present
        self.done = None
        if dev.type != "cuda":
            self.masks = self.counts = None
            return
        r, n = present.shape
        self.masks = torch.empty((r, n), dtype=torch.bool, device=dev)
        self.counts = torch.zeros(r, dtype=torch.int32, device=dev)
        self._ready = torch.cuda.current_stream(dev).record_event()

    def start(self) -> None:
        if self.dev.type != "cuda":
            with device_span("ae.diff", self.dev):
                self.masks, self.counts = divergence(self.digests, self.present)
            return
        side = diff_stream(self.dev)
        side.wait_event(self._ready)
        with torch.cuda.stream(side), device_span("ae.diff", self.dev):
            divergence_beside(self.digests, self.present, self.masks, self.counts)
        self.done = side.record_event()
        get_metrics().inc("device.ae_diff_overlapped")

    def wait(self) -> None:
        with device_span("ae.diff_wait", self.dev):
            if self.done is not None:
                torch.cuda.current_stream(self.dev).wait_event(self.done)
        self.digests = self.present = None


# ------------------------------------------------------------ leaf hashing

def leaf_digests(keys: Sequence[bytes], values: Sequence[bytes], device=None) -> torch.Tensor:
    """[N, 8] int32 leaf digests for N (key, value) pairs, hashed on
    ``device`` (``None`` = CUDA). Packing runs on the host, ragged: each
    leaf at its own block count (``merkle/ragged.py``)."""
    return ragged_digests(RaggedLeaves.pack(list(keys), list(values), resolve_device(device)))


def ragged_digests(leaves: RaggedLeaves) -> torch.Tensor:
    """[N, 8] int32 digests of a ragged leaf set, in key order, on its
    device (``ops.dispatch.hash_ragged``). Each call adds the set's
    compressions to the counter ``device.ae_leaf_blocks`` and its lane slots
    (32 lanes times each warp's longest leaf) to ``device.ae_leaf_lane_slots``:
    numbers the set computed when it was made. Their ratio is the lane fill."""
    metrics = get_metrics()
    metrics.inc("device.ae_leaf_blocks", leaves.total_blocks)
    metrics.inc("device.ae_leaf_lane_slots", leaves.lane_slots)
    return hash_ragged(leaves)


# ------------------------------------------------------------ static build

def build_levels_device(leaves: torch.Tensor) -> list[torch.Tensor]:
    """All tree levels, bottom-up, on the leaves' device. leaves: [N, 8]
    int32. Odd trailing nodes are promoted (copied up) exactly like the
    reference tree."""
    return build_levels(leaves)


def tree_root(leaves: torch.Tensor) -> torch.Tensor:
    """[8] int32 root digest from [N, 8] leaf digests (N >= 1)."""
    return build_levels(leaves)[-1][0]


# ---------------------------------------------------------- capacity build

def tree_root_capacity(leaves: torch.Tensor, n: int) -> torch.Tensor:
    """Root over the first ``n`` of C leaf slots (1 <= n <= C, C a power of
    two): bit-identical to ``tree_root(leaves[:n])`` for every such n.

    With C a power of two, every level size m <= C_level keeps the promotion
    slot m//2 strictly inside the next level's C_level/2 slots, so the row
    write below never lands on a live pair slot. Levels past the top
    (m == 1) pass the root through unchanged.
    """
    c = leaves.shape[0]
    if c & (c - 1) or c == 0:
        raise ValueError(f"capacity must be a power of two, got {c}")
    m = int(n)
    if not 1 <= m <= c:
        raise ValueError(f"live count must be in [1, {c}], got {m}")
    cur = leaves
    while cur.shape[0] > 1:
        if m <= 1:
            cur = cur[: cur.shape[0] // 2]
            continue
        nxt = hash_node_level(cur)
        if m % 2:
            # Promote the odd tail: slot m//2 of the next level gets cur[m-1].
            nxt[m // 2] = cur[m - 1]
        cur = nxt
        m = (m + 1) // 2
    return cur[0]


# ------------------------------------------------------------ engine class

class TorchMerkleTree:
    """Same surface as the CPU ``MerkleTree`` with device-batched hashing
    (counterpart of ``JaxMerkleTree``).

    Mutations only touch a host-side (key -> value) map; ``root_hash`` /
    ``levels`` trigger one batched device rebuild on ``device``
    (``None`` = CUDA).
    """

    def __init__(self, device=None) -> None:
        self._device = resolve_device(device)
        self._items: dict[bytes, bytes] = {}
        self._levels_np: Optional[list[np.ndarray]] = None

    # -- mutation ----------------------------------------------------------
    def insert(self, key: str | bytes, value: str | bytes) -> None:
        self._items[_b(key)] = _b(value)
        self._levels_np = None

    def remove(self, key: str | bytes) -> None:
        if self._items.pop(_b(key), None) is not None:
            self._levels_np = None

    def clear(self) -> None:
        if self._items:
            self._items.clear()
            self._levels_np = None

    def __len__(self) -> int:
        return len(self._items)

    # -- build -------------------------------------------------------------
    def _rebuild(self) -> None:
        if self._levels_np is not None:
            return
        if not self._items:
            self._levels_np = []
            return
        ordered = sorted(self._items.items())
        leaves = leaf_digests([k for k, _ in ordered], [v for _, v in ordered],
                              device=self._device)
        self._levels_np = [words_np(lv) for lv in build_levels(leaves)]

    @property
    def levels(self) -> list[np.ndarray]:
        self._rebuild()
        assert self._levels_np is not None
        return self._levels_np

    def root_hash(self) -> Optional[bytes]:
        self._rebuild()
        if not self._levels_np:
            return None
        return digest_to_bytes(self._levels_np[-1][0])

    def root_hex(self) -> str:
        r = self.root_hash()
        return r.hex() if r is not None else "0" * 64

    def inorder_keys(self) -> list[str]:
        return [k.decode("utf-8", "surrogateescape") for k in sorted(self._items)]

    def leaves(self) -> list[tuple[str, bytes]]:
        self._rebuild()
        assert self._levels_np is not None
        if not self._levels_np:
            return []
        hashes = digests_to_bytes(self._levels_np[0])
        return [
            (k.decode("utf-8", "surrogateescape"), h)
            for k, h in zip(sorted(self._items), hashes)
        ]


def _b(s: str | bytes) -> bytes:
    return s.encode("utf-8") if isinstance(s, str) else s
