"""Device-resident Merkle state with incremental updates for every op kind.

Counterpart of ``merklekv_tpu/merkle/incremental.py``. The tree LIVES in
device memory as int32 tensors, and change-event batches are applied as
device work:

- **value updates** (keyspace shape unchanged): hash the k changed leaves,
  scatter them into the capacity-padded leaf level, re-hash only the
  touched parent paths — O(k log C) device work, one fused kernel launch
  per batch on the card (``ops/merkle_paths.py``).
- **inserts / deletes** (shape changes): the host computes the permutation
  (numpy index arithmetic, no hashing), the device gathers surviving
  digests into their new slots, scatters the k fresh digests, and
  re-reduces all levels.

Representation: a FULL binary tree at capacity C = 2^d (slots >= n hold a
zero sentinel). The reference tree pairs only live nodes and promotes odd
tails, so its levels differ from the padded tree's only on the right spine:
reference level l equals padded level l at every position except the last.
The promotion-chain walk recovers that last node (and so the root) in
O(log C) node hashes, one kernel launch per tree version.

Unlike the JAX state, which rebuilt an immutable tuple of levels per batch,
value updates write into the level tensors in place; the restructure and
build paths still produce fresh levels and swap them in.

Every device call runs through the process's dispatch guard
(``device/guard.py``) under the JAX state's labels — ``build``, ``scatter``,
``restructure``, ``root``, ``levels`` — so the fault injector matches the
same seams and the degradation ladder reads the same typed errors. Because
value updates write in place, an abandoned dispatch must never run late: a
guarded call holds the state's dispatch lock while it touches the tensors,
and one the guard has given up on (a hang past the deadline) does nothing
when it gets there (see ``_run``).

Metrics (the port's registry, the JAX state's names): ``device.scatter_keys``
/ ``device.restructure_keys`` count the changed leaves of a batch, equal to
the JAX state's counts; ``device.scatter_bytes`` / ``device.restructure_bytes``
count the host arrays this state uploads for the batch — unlike the JAX
state's, with no bucket padding, since eager launches share no compiled
program; ``device.scatter_dispatch`` / ``device.restructure_dispatch`` are
host-side dispatch latency histograms.

Host memory: only the sorted key array is kept (values are never stored).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Iterable, Optional, Sequence, TypeVar

import numpy as np
import torch

from merklekv_tpu_torch.device.guard import DispatchHungError, get_guard
from merklekv_tpu_torch.merkle.cpu import ref_level_sizes as _ref_level_sizes
from merklekv_tpu_torch.merkle.packing import PackedLeaves, pack_leaves
from merklekv_tpu_torch.ops.dispatch import (
    build_levels,
    hash_blocks,
    path_scratch,
    promotion_chain,
    rehash_paths,
)
from merklekv_tpu_torch.ops.sha256 import digest_to_bytes, digests_to_bytes
from merklekv_tpu_torch.utils.torchenv import as_tensor, resolve_device, words_np
from merklekv_tpu_torch.utils.tracing import get_metrics, span

__all__ = ["DeviceMerkleState"]

_T = TypeVar("_T")


def _next_pow2(n: int) -> int:
    return 1 << max(1, (n - 1).bit_length())


class DeviceMerkleState:
    """Sorted keyspace + device-resident padded tree levels.

    Host side owns only the sorted key array. Device side owns ``_levels``:
    levels[0] is [C, 8] int32 leaf digests, levels[-1] is [1, 8].
    ``device=None`` means CUDA (raises without a GPU); tests pass "cpu".
    """

    # Auto-flush ceiling: bounds the host memory pending values can hold.
    PENDING_LIMIT = 65536

    # Prefix of every guard label; the sharded subclass puts its width here
    # (``shard4_scatter``) so a fault can target one rung of the ladder.
    _guard_prefix = ""

    def __init__(self, device=None) -> None:
        self._device = resolve_device(device)
        self._keys = np.empty(0, dtype=object)  # sorted key bytes
        # key -> sorted position; O(1) dict probes instead of searchsorted on
        # an object array. Rebuilt on structural changes only.
        self._index: dict[bytes, int] = {}
        self._levels: Optional[list[torch.Tensor]] = None
        self._capacity = 0
        # The path-rehash kernel's scratch (ops/merkle_paths.py::path_scratch),
        # zero between batches. Allocated at the first value batch of a
        # capacity, dropped when the capacity changes or a batch fails.
        self._counters: Optional[torch.Tensor] = None
        # The reference tree's last node per level (the promotion chain) as
        # one [L, 8] tensor, computed once per tree version and dropped
        # whenever the levels or the key array change.
        self._chain: Optional[torch.Tensor] = None
        # Writes accumulate here and flush as ONE device batch at the next
        # query (or at PENDING_LIMIT).
        self._pending: dict[bytes, Optional[bytes]] = {}
        # Held by a guarded call while it touches the tensors (see _run).
        self._dispatch_mu = threading.RLock()
        self.full_rebuilds = 0
        self.incremental_batches = 0
        self.structural_batches = 0

    def _run(self, label: str, fn: Callable[[], _T]) -> _T:
        """The one seam every device call goes through: ``fn`` runs under
        the process's dispatch guard with ``label`` (build, scatter,
        restructure, root, levels), holding the dispatch lock. If the guard
        abandons the call at its deadline, the call is cancelled: when its
        thread reaches the lock it raises instead of touching the tensors,
        so a late in-place scatter can never overwrite a newer batch. A
        call already inside ``fn`` when the deadline passes finishes under
        the lock first, and later calls wait for it. It never reroutes."""
        cancelled = threading.Event()

        def locked() -> _T:
            with self._dispatch_mu:
                if cancelled.is_set():
                    raise RuntimeError(f"dispatch {label!r} ran after it was abandoned")
                return fn()

        try:
            return get_guard().run(self._guard_prefix + label, locked)
        except DispatchHungError:
            cancelled.set()
            raise

    # ------------------------------------------------------------ loading
    @classmethod
    def from_items(
        cls, items: Iterable[tuple[bytes, bytes]], device=None
    ) -> "DeviceMerkleState":
        st = cls(device=device)
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
        cls, levels_np: Sequence[np.ndarray], keys: Sequence[bytes], device=None
    ) -> "DeviceMerkleState":
        """Adopt a padded tree built elsewhere — e.g. the JAX state's
        ``[np.asarray(l) for l in st._levels]`` and its sorted keys — so both
        packages answer queries on the same tree, bit for bit."""
        st = cls(device=device)
        st._load_levels(levels_np, keys)
        return st

    def _load_levels(self, levels_np: Sequence[np.ndarray], keys: Sequence[bytes]) -> None:
        keys_arr = np.array(list(keys), dtype=object)
        n = len(keys_arr)
        if n == 0:
            if len(levels_np):
                raise ValueError("levels given for an empty keyspace")
            return
        c = int(levels_np[0].shape[0])
        if c & (c - 1) or c < n:
            raise ValueError(f"capacity {c} is not a power of two >= {n}")
        if len(levels_np) != c.bit_length():
            raise ValueError(f"{len(levels_np)} levels for capacity {c}")
        for lvl, arr in enumerate(levels_np):
            if tuple(arr.shape) != (c >> lvl, 8):
                raise ValueError(f"level {lvl} has shape {tuple(arr.shape)}")
        if any(keys_arr[i] >= keys_arr[i + 1] for i in range(n - 1)):
            raise ValueError("keys must be sorted and unique")
        self._adopt_levels(self._levels_from_numpy(
            [np.asarray(arr, np.uint32) for arr in levels_np]))
        self._set_keys(keys_arr)

    def _levels_from_numpy(self, levels_np: list[np.ndarray]) -> list[torch.Tensor]:
        """Validated global padded levels -> this state's level tensors."""
        return [as_tensor(arr, self._device) for arr in levels_np]

    def to_numpy_levels(self) -> list[np.ndarray]:
        """Every padded level as numpy uint32 (staged changes flushed first);
        the inverse of :meth:`from_levels`."""
        self._flush()
        if self._levels is None:
            return []
        c = self._capacity
        return self._run("levels", lambda: [
            self._level_words(lvl, 0, c >> lvl) for lvl in range(c.bit_length())])

    def _level_words(self, level: int, lo: int, hi: int) -> np.ndarray:
        """Rows ``[lo, hi)`` of padded level ``level`` as numpy uint32 — the
        one read of the levels every query goes through."""
        return words_np(self._levels[level][lo:hi])

    def __len__(self) -> int:
        self._flush()
        return len(self._keys)

    def leaf_count(self) -> int:
        """Built leaf count WITHOUT flushing staged changes."""
        return len(self._keys)

    # ------------------------------------------------------------ lookups
    def _find(self, key: bytes) -> int:
        """Position of key in the sorted array, or -1."""
        return self._index.get(key, -1)

    def _positions(self, keys: Sequence[bytes]) -> np.ndarray:
        """Sorted-array positions for keys known to be present."""
        idx = self._index
        return np.fromiter(
            (idx[k] for k in keys), dtype=np.int64, count=len(keys)
        )

    def _set_keys(self, keys_arr: np.ndarray) -> None:
        self._keys = keys_arr
        self._index = {k: i for i, k in enumerate(keys_arr)}

    def _put(self, arr: np.ndarray, dtype: torch.dtype = torch.int32) -> torch.Tensor:
        return as_tensor(arr, self._device, dtype)

    def _adopt_levels(self, levels: Optional[list[torch.Tensor]]) -> None:
        """Swap in a new tree version (``None`` = empty)."""
        c = int(levels[0].shape[0]) if levels else 0
        if c != self._capacity:
            self._counters = None
        self._chain = None
        self._levels = levels
        self._capacity = c

    # ------------------------------------------------------------ updates
    def apply(self, changes: Sequence[tuple[bytes, Optional[bytes]]]) -> None:
        """Stage (key, value|None-for-delete) changes; last write per key
        wins. Device work is deferred to the next flush."""
        for k, v in changes:
            self._pending[k] = v
        if len(self._pending) >= self.PENDING_LIMIT:
            self._flush()

    def pending_count(self) -> int:
        """Staged-but-undispatched changes (no device work to read it)."""
        return len(self._pending)

    def flush_pending(self) -> None:
        """Dispatch every staged change to the device now. Idempotent when
        nothing is staged."""
        self._flush()

    def _flush(self) -> None:
        if not self._pending:
            return
        pending, self._pending = self._pending, {}
        try:
            self._flush_batch(pending)
        except BaseException:
            # A failed dispatch must not silently drop the batch. Restructure
            # and build swap fresh levels in only on success; an in-place
            # value scatter that failed part-way is healed by the retry,
            # which re-scatters the same leaves and re-hashes their paths,
            # on a freshly zeroed scratch (a launch cut short may leave it
            # set). Until that retry the levels may be torn, so
            # the serving mirror drops a state whose drain failed rather
            # than serve it. Entries staged by a racing caller win over the
            # restored batch.
            self._counters = None
            merged = dict(pending)
            merged.update(self._pending)
            self._pending = merged
            raise

    def _flush_batch(self, pending: dict[bytes, Optional[bytes]]) -> None:
        keys = sorted(pending)
        idx = self._index
        deletes = [k for k in keys if k in idx and pending[k] is None]
        inserts = [k for k in keys if k not in idx and pending[k] is not None]
        upserts = {k: v for k, v in pending.items() if v is not None}

        if not deletes and not inserts:
            updates = sorted(upserts.items())
            if updates and self._levels is not None:
                self._update_in_place(updates)
            return
        self._restructure(deletes, upserts, inserts)

    def _update_in_place(self, items: list[tuple[bytes, bytes]]) -> None:
        """Value updates of present keys. ``items`` are sorted by key, so
        their positions are sorted and unique: no bucket padding (the JAX
        state pads to share compiled programs; eager launches need none)."""
        keys = [key for key, _ in items]
        pos = self._positions(keys)
        packed = pack_leaves(keys, [v for _, v in items])

        def scatter() -> None:
            counters = self._counters
            if counters is None:
                counters = self._counters = path_scratch(self._capacity, self._device)
            rehash_paths(self._levels, counters, self._put(packed.blocks),
                         self._put(packed.nblocks), pos)

        t0 = time.perf_counter()
        self._chain = None
        self._run("scatter", scatter)
        self.incremental_batches += 1
        m = get_metrics()
        m.inc("device.scatter_keys", len(items))
        # Positions go up as int32 (ops/merkle_paths.py).
        m.inc("device.scatter_bytes",
              int(packed.blocks.nbytes + packed.nblocks.nbytes + 4 * len(pos)))
        m.observe("device.scatter_dispatch", time.perf_counter() - t0)

    # ------------------------------------------------------------ structure
    def _capacity_for(self, n: int) -> int:
        """Padded capacity for ``n`` live leaves (the sharded subclass keeps
        it a multiple of its shard count)."""
        return _next_pow2(n)

    def _initial_build(self, keys_arr: np.ndarray, values: list) -> None:
        n = len(keys_arr)
        c = self._capacity_for(n)
        packed = pack_leaves(list(keys_arr), values)
        # Full rebuilds are rare (warm-up, empty -> non-empty) and expensive:
        # one span each, with batch size and capacity.
        with span("device.rebuild", keys=n, capacity=c):
            self._adopt_levels(self._dispatch_build(packed, c))
        self._set_keys(keys_arr)
        self.full_rebuilds += 1

    def _restructure(
        self,
        deletes: list[bytes],
        upserts: dict[bytes, Optional[bytes]],
        inserts: list[bytes],
    ) -> None:
        old = self._keys
        n_old = len(old)

        # Host plan: pure index arithmetic, no hashing of survivors.
        del_pos = self._positions(deletes)
        survivors = np.delete(old, del_pos) if len(del_pos) else old
        surv_src = (
            np.delete(np.arange(n_old, dtype=np.int64), del_pos)
            if len(del_pos)
            else np.arange(n_old, dtype=np.int64)
        )
        ins_keys = np.array(sorted(inserts), dtype=object)
        if len(ins_keys):
            ins_at = np.searchsorted(survivors, ins_keys).astype(np.int64)
            new_keys = np.insert(survivors, ins_at, ins_keys)
            gather = np.insert(surv_src, ins_at, -1)
        else:
            new_keys = survivors
            gather = surv_src
        n_new = len(new_keys)
        if n_new == 0:
            self._set_keys(np.empty(0, dtype=object))
            self._adopt_levels(None)
            return
        if self._levels is None:
            # Empty -> non-empty: everything is fresh; all values are in
            # this batch by construction.
            self._initial_build(new_keys, [upserts[k] for k in new_keys])
            return

        c_new = self._capacity_for(n_new)
        gather_padded = np.full(c_new, -1, np.int64)
        gather_padded[:n_new] = gather

        # Fresh digests: every upsert (update of a survivor or insert).
        fresh_items = sorted(upserts.items())
        k = len(fresh_items)
        fresh_keys = [key for key, _ in fresh_items]
        fresh_pos = np.searchsorted(new_keys, np.array(fresh_keys, dtype=object)).astype(np.int64)
        packed = pack_leaves(fresh_keys, [v for _, v in fresh_items])

        t0 = time.perf_counter()
        self._adopt_levels(self._dispatch_restructure(gather_padded, fresh_pos, packed, c_new))
        self._set_keys(new_keys)
        self.structural_batches += 1
        m = get_metrics()
        m.inc("device.restructure_keys", k)
        m.inc("device.restructure_bytes",
              int(gather_padded.nbytes + fresh_pos.nbytes
                  + packed.blocks.nbytes + packed.nblocks.nbytes))
        m.observe("device.restructure_dispatch", time.perf_counter() - t0)

    # ------------------------------------------------- device dispatch seam
    # The host planning above is backend-agnostic; only these two hooks build
    # levels on the device. The multi-GPU subclass overrides them.
    def _dispatch_build(self, packed: PackedLeaves, c: int) -> list[torch.Tensor]:
        """Packed leaves -> their digests in a zero-padded [c, 8] leaf level
        -> every padded level."""
        def go() -> list[torch.Tensor]:
            padded = torch.zeros((c, 8), dtype=torch.int32, device=self._device)
            padded[:packed.n] = hash_blocks(self._put(packed.blocks), self._put(packed.nblocks))
            return build_levels(padded)

        return self._run("build", go)

    def _dispatch_restructure(
        self,
        gather_padded: np.ndarray,
        fresh_pos: np.ndarray,
        fresh: PackedLeaves,
        c_new: int,
    ) -> list[torch.Tensor]:
        """Gather survivors into shifted slots + scatter the digests of the
        ``fresh`` leaves + full re-reduction (``self._capacity`` still holds
        the OLD C).

        gather_padded [c_new] int64: source slot in the OLD leaf level for
        each new slot, or -1 for slots that receive a fresh digest / stay
        zero. fresh_pos [k]: the new slots of the k packed ``fresh`` leaves
        (every upsert), sorted."""
        c_old = self._capacity

        def go() -> list[torch.Tensor]:
            gather = self._put(gather_padded, torch.int64)
            safe = gather.clamp(0, max(c_old - 1, 0))
            base = self._levels[0][safe]
            base[gather < 0] = 0
            if len(fresh_pos):
                base.index_put_((self._put(fresh_pos, torch.int64),),
                                hash_blocks(self._put(fresh.blocks), self._put(fresh.nblocks)))
            return build_levels(base)

        return self._run("restructure", go)

    # ------------------------------------------------------------ queries
    def _promotion_chain(self) -> torch.Tensor:
        """The reference tree's LAST node at every level, [L, 8] on the
        device, recovered from the padded levels (see
        ``ops/merkle_paths.py::promotion_chain``); row L-1 is the reference
        root. Cached until the tree changes."""
        if self._chain is None:
            self._chain = promotion_chain(self._levels, len(self._keys))
        return self._chain

    def root_hash(self, flush: bool = True) -> Optional[bytes]:
        """Reference-tree root. ``flush=False`` serves the tree AS BUILT —
        staged changes stay staged."""
        if flush:
            self._flush()
        if not len(self._keys) or self._levels is None:
            return None
        return self._run(
            "root",
            lambda: digest_to_bytes(words_np(self._promotion_chain()[-1])),
        )

    def root_hex(self, flush: bool = True) -> str:
        r = self.root_hash(flush=flush)
        return r.hex() if r is not None else "0" * 64

    def leaf_digest(self, key: bytes) -> Optional[bytes]:
        self._flush()
        i = self._find(key)
        if i < 0 or self._levels is None:
            return None
        return self._run(
            "levels",
            lambda: digest_to_bytes(self._level_words(0, i, i + 1)[0]),
        )

    # ------------------------------------------- reference-level serving
    @staticmethod
    def ref_level_sizes(n: int) -> list[int]:
        """Reference (odd-promotion) tree level sizes for ``n`` leaves."""
        return _ref_level_sizes(n)

    def _promoted_last(self, level: int) -> bytes:
        """The reference tree's last node at ``level`` as 32 bytes."""
        return digest_to_bytes(words_np(self._promotion_chain()[level]))

    def level_nodes(
        self, level: int, lo: int, hi: int, flush: bool = True
    ) -> tuple[list[tuple[int, bytes]], int]:
        """Reference-tree digests at ``level`` for indices ``[lo, hi)``
        (clamped to the level's size), plus the live leaf count — the answer
        to the TREELEVEL wire verb. One device read serves the slice; the
        promotion-chain correction runs only when the slice touches the
        level's last node."""
        if flush:
            self._flush()
        n = len(self._keys)
        if n == 0 or self._levels is None:
            return [], 0
        sizes = self.ref_level_sizes(n)
        if level >= len(sizes):
            return [], n
        m = sizes[level]
        lo = max(0, min(lo, m))
        hi = max(lo, min(hi, m))
        if lo == hi:
            return [], n

        def read() -> list[tuple[int, bytes]]:
            digs = digests_to_bytes(self._level_words(level, lo, hi))
            rows = [(lo + i, d) for i, d in enumerate(digs)]
            if hi == m and level > 0:
                rows[-1] = (m - 1, self._promoted_last(level))
            return rows

        return self._run("levels", read), n
