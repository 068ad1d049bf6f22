"""A plain serving mirror: the control that takes the program's place in
the mirror cells.

It has the surface the mirror cells drive (``start_warming``, ``ready``,
``on_events``, ``published_version``, ``published_root_stamped``,
``level_nodes_stamped``, ``close``) and keeps the tree with the plain
reference: a pump thread takes the staged writes every few milliseconds,
re-hashes their leaves, rebuilds the levels and publishes the root stamped
with the last staged watermark. It serves the tree of a power-of-two
capacity with zero digests in its empty slots, so without the odd-promotion
rule: the broken guarantee of the control.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from portbench.reference import sha256 as ref_sha
from portbench.reference import tree as ref_tree
from portbench.reference.encode import pack_records

PUMP_S = 0.005


class PlainMirror:
    def __init__(self, cell) -> None:
        self._cell = cell
        self._row = {k.decode(): i for i, k in enumerate(cell.key_b.tolist())}
        self._mu = threading.Lock()
        self._pending: list = []
        self._staged = 0
        self._pub = None  # (root hex, version, levels)
        self._stop = threading.Event()
        self._ready = threading.Event()
        self._thread = None

    def start_warming(self) -> None:
        self._thread = threading.Thread(target=self._run, name="plain-mirror-pump", daemon=True)
        self._thread.start()

    def ready(self) -> bool:
        return self._ready.is_set()

    def on_events(self, events, watermark: int) -> None:
        with self._mu:
            self._pending.append(([self._row[e.key] for e in events], [e.val for e in events]))
            self._staged = max(self._staged, watermark)

    def _run(self) -> None:
        cell = self._cell
        keys, vals, _pool = cell.records()
        self._keys = keys
        blk = pack_records(keys, vals)
        del vals
        self._leaves = ref_sha.hash_blocks(blk, torch.full((blk.shape[0],), blk.shape[1],
                                                           dtype=torch.int32, device=keys.device))
        del blk
        self._publish(cell.versions[0])
        self._ready.set()
        while not self._stop.wait(PUMP_S):
            with self._mu:
                pending, self._pending = self._pending, []
                ver = self._staged
            if not pending:
                continue
            rows = np.concatenate([np.asarray(r, dtype=np.int64) for r, _ in pending])
            values = [v for _, vs in pending for v in vs]
            last = len(rows) - 1 - np.unique(rows[::-1], return_index=True)[1]
            val = np.frombuffer(b"".join(values[i] for i in last), dtype=np.uint8)
            dev = self._keys.device
            idx = torch.from_numpy(rows[last]).to(dev)
            blk = pack_records(self._keys[idx], torch.from_numpy(val.copy()).to(dev)
                               .view(len(last), -1))
            self._leaves[idx] = ref_sha.hash_blocks(blk, torch.full((len(last),), blk.shape[1],
                                                    dtype=torch.int32, device=dev))
            self._publish(ver)

    def _publish(self, version: int) -> None:
        levels = ref_tree.padded_levels(self._leaves)
        self._pub = (ref_sha.digest_hex(levels[-1][0]), version, levels)

    def published_version(self) -> int:
        pub = self._pub
        return pub[1] if pub is not None else 0

    def published_root_stamped(self):
        pub = self._pub
        return None if pub is None else (pub[0], pub[1])

    def level_nodes_stamped(self, level: int, lo: int, hi: int):
        pub = self._pub
        if pub is None or level >= len(pub[2]):
            return None
        nodes = pub[2][level]
        hi = min(hi, nodes.shape[0])
        words = nodes[lo:hi].cpu().numpy().astype(">i4")
        rows = [(lo + i, words[i].tobytes()) for i in range(hi - lo)]
        return rows, self._leaves.shape[0], pub[1]

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(60)
