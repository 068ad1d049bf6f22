"""Closed loop of anti-entropy cycles at the ``MerkleEngine`` boundary.

One cycle: a full rebuild of the tree over every record plus the N-replica
diff, with the root and the per-replica counts back on the host. On one
device the entry is ``merkle.torch_engine.anti_entropy_forward``; on a key
axis of several devices it is ``parallel.sharded_merkle.make_anti_entropy_step``
over a ``Mesh`` of them, each device holding its own contiguous key shard.

Every cycle XORs a salt of its own into one word of leaf 0's first block
(a value byte) and into digest word 0 of key 0 in one replica (the replica
turns with the cycle; the previous cycle's row is restored), so no two
cycles see the same input.

Mix parameters (``traffic/<name>.json``): ``salt_word``, ``warmup_cycles``.
"""

from __future__ import annotations

import concurrent.futures
import gc
import time

import torch

from portbench import data, roofline
from portbench.reference import sha256 as ref_sha
from portbench.reference import tree as ref_tree
from portbench.reference.encode import blocks_per_leaf


def salt_of(cycle: int) -> int:
    """The cycle's salt as an int32 (never 0)."""
    return ref_sha.signed(((cycle + 1) * 0x9E3779B1) & 0xFFFFFFFF or 1)


def _parallel(devices: list, fn) -> list:
    """``fn(i, device)`` for each device, on a thread per card when they
    are distinct cards (launches from one thread would queue card after
    card), in order otherwise."""
    distinct = len({str(d) for d in devices}) == len(devices) and devices[0].type == "cuda"
    if not distinct or len(devices) == 1:
        return [fn(i, d) for i, d in enumerate(devices)]

    def on(i, d):
        with torch.cuda.device(d):
            return fn(i, d)

    with concurrent.futures.ThreadPoolExecutor(len(devices)) as pool:
        return list(pool.map(on, range(len(devices)), devices))


def _sync(devices: list) -> None:
    for d in {str(d): d for d in devices}.values():
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class Cell:
    CONTROLS = ("digest128",)

    def __init__(self, ctx) -> None:
        cfg = ctx.config
        self.ctx = ctx
        self.devices = list(ctx.devices)
        self.shards = len(self.devices)
        self.n = int(cfg["keys"])
        self.replicas = int(cfg["replicas"])
        self.key_len = int(cfg["key_bytes"])
        self.value_len = int(cfg["value_bytes"])
        self.blocks_per_leaf = blocks_per_leaf(self.key_len, self.value_len)
        if self.n % self.shards:
            raise ValueError(f"{self.n} keys do not split over {self.shards} devices")
        self.rows = self.n // self.shards
        self.salt_word = int(ctx.mix["salt_word"])
        self.control = None
        self.facts: dict = {}
        self.probes: dict = {}
        self.cycle = 0
        self.last = None

    def use_control(self, name: str) -> None:
        if name not in self.CONTROLS:
            raise ValueError(f"no control {name!r}; have {self.CONTROLS}")
        self.control = name

    # ---------------------------------------------------------------- data
    def make_inputs(self) -> tuple:
        """Per-shard lists (blocks, nblocks, digests, present), made on each
        shard's device from the seed."""
        seed, r_count, l = self.ctx.seed, self.replicas, self.rows
        ranges = data.split_key_range(self.shards)

        def shard(s, dev):
            blocks = data.ycsb_blocks(data.generator(dev, seed, 1, s), l, self.key_len,
                                      self.value_len, dev, *ranges[s])
            nblocks = torch.full((l,), self.blocks_per_leaf, dtype=torch.int32, device=dev)
            base = torch.randint(-(2**31), 2**31 - 1, (l, 8), dtype=torch.int32, device=dev,
                                 generator=data.generator(dev, seed, 2, s))
            digests = base.unsqueeze(0).repeat(r_count, 1, 1)
            del base
            present = torch.ones((r_count, l), dtype=torch.bool, device=dev)
            return blocks, nblocks, digests, present

        blocks, nblocks, digests, present = map(list, zip(*_parallel(self.devices, shard)))
        div = self.ctx.config["divergence"]
        if div["rule"] == "uniform":
            for s, dev in enumerate(self.devices):
                data.uniform_divergence(data.generator(dev, seed, 3, s), digests[s], present[s],
                                        div["fraction"])
        elif div["rule"] == "zipf":
            data.zipf_divergence(seed, digests, present, div["fraction"], div["s"],
                                 div["absent_every"], self.devices[0])
        else:
            raise ValueError(f"unknown divergence rule {div['rule']!r}")
        _sync(self.devices)
        return blocks, nblocks, digests, present

    def _salt(self, cycle: int, blocks: list, digests: list) -> None:
        """Put cycle ``cycle``'s salt in place (and take the last one out)."""
        salt = salt_of(cycle)
        blocks[0][0, 0, self.salt_word] = self.base_word ^ salt
        if self.prev_row is not None:
            digests[0][self.prev_row, 0, 0] = self.base_col[self.prev_row]
        row = 1 + cycle % (self.replicas - 1)
        digests[0][row, 0, 0] = self.base_col[row] ^ salt
        self.prev_row = row

    # ------------------------------------------------------------- program
    def _program(self):
        blocks, nblocks, digests, present = self.inputs
        if self.control == "digest128":
            return lambda: self._control_step(blocks, nblocks, digests, present)
        if self.shards == 1:
            from merklekv_tpu_torch.merkle import torch_engine

            dev = self.devices[0]
            return lambda: torch_engine.anti_entropy_forward(
                blocks[0], nblocks[0], digests[0], present[0], device=dev)
        from merklekv_tpu_torch.parallel import mesh, sharded_merkle

        m = mesh.make_mesh({"key": self.shards}, devices=self.devices)
        step = sharded_merkle.make_anti_entropy_step(m)
        return lambda: step(blocks, nblocks, digests, present)

    def _control_step(self, blocks, nblocks, digests, present):
        """The reference in the program's place, with digests compared on
        their first 128 bits only (the broken guarantee)."""
        root, masks = self._reference(blocks, nblocks, digests, present, words=4)
        return root, masks, masks.sum(dim=1, dtype=torch.int32)

    def setup(self) -> None:
        self.inputs = self.make_inputs()
        blocks, nblocks, digests, present = self.inputs
        self.base_word = int(blocks[0][0, 0, self.salt_word].item())
        self.base_col = [int(x) for x in digests[0][:, 0, 0].tolist()]
        self.prev_row = None
        self.input_sums = self._sums()
        self.step = self._program()
        for _ in range(int(self.ctx.mix["warmup_cycles"])):
            self._one_cycle()
        _sync(self.devices)
        self._probes()

    def _one_cycle(self) -> None:
        blocks, _nb, digests, _p = self.inputs
        self._salt(self.cycle, blocks, digests)
        self.last = None
        self.last = self.step()
        self.root_host = self.last[0].cpu()
        self.counts_host = self.last[2].cpu()
        self.cycle += 1

    def _probes(self) -> None:
        """Calls into single layers, on each shard's own tensors, for the
        readers to time."""
        from merklekv_tpu_torch.merkle import diff
        from merklekv_tpu_torch.ops import dispatch

        blocks, nblocks, digests, present = self.inputs
        self.probes = {
            "leaf": [(dev, (lambda b=b, nb=nb: dispatch.hash_blocks(b, nb)),
                      roofline.leaf_work(self.rows, self.blocks_per_leaf))
                     for dev, b, nb in zip(self.devices, blocks, nblocks)],
            "diff": [(dev, (lambda d=d, p=p: diff.divergence_masks(d, p).sum(dim=1, dtype=torch.int32)),
                      roofline.diff_work(self.replicas, self.rows))
                     for dev, d, p in zip(self.devices, digests, present)],
        }

    # -------------------------------------------------------------- window
    def window(self, tracer) -> dict:
        cycles = 0
        t0 = time.perf_counter()
        tracer.begin(t0)
        deadline = t0 + self.ctx.seconds
        while True:
            self._one_cycle()
            cycles += 1
            now = time.perf_counter()
            tracer.tick(now)
            if now >= deadline:
                break
        _sync(self.devices)
        t_end = time.perf_counter()
        self.facts = {"cycles": cycles, "window_s": t_end - t0, "keys": self.n,
                      "replicas": self.replicas, "shards": self.shards}
        self.ctx.log(f"[window] {cycles} cycles in {t_end - t0:.6f} s; counts "
                     f"{self.counts_host.tolist()}")
        return {"t0": t0, "attempted": cycles, "failed": 0,
                "metrics": {"cycle_ms": 1e3 * (t_end - t0) / cycles}}

    def release(self) -> None:
        """Keep the last cycle's answer (root and counts on the host, masks
        where they are) and the benchmark's inputs; free the rest."""
        self.masks = self.last[1]
        self.last = None
        self.step = None
        self.probes = {}
        gc.collect()
        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.empty_cache()

    # --------------------------------------------------------------- check
    def _sums(self) -> list:
        """Per shard, the int64 sum of each input tensor (with the salts
        taken out): the check's proof that the inputs it reads are the ones
        the benchmark made."""
        blocks, nblocks, digests, present = self.inputs
        saved = (blocks[0][0, 0, self.salt_word].item(),
                 digests[0][self.prev_row, 0, 0].item() if self.prev_row is not None else None)
        blocks[0][0, 0, self.salt_word] = self.base_word
        if self.prev_row is not None:
            digests[0][self.prev_row, 0, 0] = self.base_col[self.prev_row]
        sums = [[_sum64(t) for t in (b, nb, d, p)]
                for b, nb, d, p in zip(blocks, nblocks, digests, present)]
        blocks[0][0, 0, self.salt_word] = saved[0]
        if self.prev_row is not None:
            digests[0][self.prev_row, 0, 0] = saved[1]
        return sums

    def _reference(self, blocks, nblocks, digests, present, words: int = 8):
        """(root [8] on device 0, masks [R, N] on device 0) by the plain
        reference, shard by shard."""
        leaves = _parallel(self.devices, lambda s, d: ref_sha.hash_blocks(blocks[s], nblocks[s]))
        root = ref_tree.tree_root(torch.cat([x.to(self.devices[0]) for x in leaves]))
        masks = _parallel(self.devices,
                          lambda s, d: ref_tree.diff_masks(digests[s], present[s], words=words))
        return root, torch.cat([m.to(self.devices[0]) for m in masks], dim=1)

    def check(self) -> list:
        """The last timed cycle's root, masks and counts against the plain
        reference over the same inputs: the benchmark's own tensors as the
        last cycle salted them, unchanged otherwise (their sums)."""
        t = time.perf_counter()
        changed = int(self._sums() != self.input_sums)
        blocks, nblocks, digests, present = self.inputs
        leaves = _parallel(self.devices, lambda s, d: ref_sha.hash_blocks(blocks[s], nblocks[s]))
        root = ref_tree.tree_root(torch.cat([x.to(self.devices[0]) for x in leaves]))
        del leaves
        l = self.rows
        bad_masks, counts = 0, torch.zeros(self.replicas, dtype=torch.int64)
        for s, dev in enumerate(self.devices):
            want = ref_tree.diff_masks(digests[s], present[s])
            got = self.masks[:, s * l:(s + 1) * l].to(dev)
            bad_masks += int((want != got).sum().item())
            counts += want.sum(dim=1).cpu()
        bad_counts = int((counts != self.counts_host.to(torch.int64)).sum().item())
        root_bad = int(not torch.equal(root.cpu(), self.root_host.cpu()))
        self.ctx.log(f"[check] reference {time.perf_counter() - t:.3f} s; root "
                     f"{ref_sha.digest_hex(root)}; counts {counts.tolist()}")
        return [("root_mismatch", root_bad, 0), ("mask_mismatches", bad_masks, 0),
                ("count_mismatches", bad_counts, 0), ("inputs_changed", changed, 0)]


def _sum64(t: torch.Tensor, chunk: int = 1 << 24) -> int:
    """The int64 sum of ``t``, a chunk at a time: the widened copy of a
    chunk (128 MB) stays out of the program's memory peak."""
    flat = t.reshape(-1)
    return sum(int(flat[lo:lo + chunk].sum(dtype=torch.int64)) for lo in range(0, flat.numel(), chunk))
