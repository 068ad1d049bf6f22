"""Closed loop of anti-entropy cycles over a ragged leaf set, on one card.

The records' sizes come from the configuration's fits (``key_sizes``,
``value_sizes``): each size is a quantile of its fit at (i + 0.5) / N,
floored and clipped to the fit's ``min`` and ``max``, in an order drawn from
the seed (the rule of ``data.exponential_gaps``), so every seed has the same
multisets of key and value sizes and changes only which record gets which.
Keys start with a 10-character prefix, a sorted distinct key number from
the seed in base 94 (``!`` to ``~``), so byte order is number order;
printable filler follows up to the key's size. Values are printable bytes.
Keys, values and the ragged blocks are made on the card, packed by the
benchmark's own packer (``reference/ragged.py``); the program gets the
blocks and offsets as one set (``merkle.ragged.RaggedLeaves``, made in
set-up) and runs ``merkle.torch_engine.anti_entropy_forward`` on it.

Every cycle XORs a salt of its own (``ae_cycle.salt_of``) into one word of
one record's value (the word ``salt_word`` of the first record, in key
order, whose value covers that whole word) and into digest word 0 of key 0
in one replica (the replica turns with the cycle; the previous cycle's row
is restored), so no two cycles see the same input and no length changes.

Mix parameters (``traffic/<name>.json``): ``salt_word``, ``warmup_cycles``.
"""

from __future__ import annotations

import time

import torch

from portbench import data
from portbench.reference import ragged as ref_ragged
from portbench.reference import sha256 as ref_sha
from portbench.reference import tree as ref_tree
from portbench.traffic import ae_cycle

PREFIX = 10
BASE = 94


def sizes(spec: dict, n: int, gen: torch.Generator, device) -> torch.Tensor:
    """[n] int64 sizes: the fit's quantiles at (i + 0.5) / n, floored,
    clipped, in an order drawn from ``gen``. ``gev``: generalized extreme
    value (``mu``, ``sigma``, shape ``k``); ``gpd``: generalized Pareto
    (location ``theta``, ``sigma``, shape ``k``)."""
    p = (torch.arange(n, dtype=torch.float64, device=device) + 0.5) / n
    k = float(spec["k"])
    if spec["dist"] == "gev":
        x = spec["mu"] + spec["sigma"] / k * ((-torch.log(p)) ** (-k) - 1)
    elif spec["dist"] == "gpd":
        x = spec["theta"] + spec["sigma"] / k * ((1 - p) ** (-k) - 1)
    else:
        raise ValueError(f"unknown size fit {spec['dist']!r}")
    x = torch.floor(x).clamp(min=spec.get("min", 0), max=spec.get("max", 1 << 62)).long()
    return x[torch.randperm(n, generator=gen, device=device)]


def key_prefixes(numbers: torch.Tensor) -> torch.Tensor:
    """int64 numbers -> [N, 10] uint8 base-94 digits ``!`` .. ``~``, most
    significant first (byte order equals number order)."""
    out = torch.empty((numbers.shape[0], PREFIX), dtype=torch.uint8, device=numbers.device)
    x = numbers.clone()
    for j in range(PREFIX - 1, -1, -1):
        out[:, j] = (x % BASE + 33).to(torch.uint8)
        x = x // BASE
    return out


def records(cfg: dict, seed: int, device) -> tuple:
    """(flat keys uint8, key sizes, flat values uint8, value sizes) of the
    configuration's ``keys`` sorted records, from ``seed``."""
    n = int(cfg["keys"])
    key_lens = sizes(cfg["key_sizes"], n, data.generator(device, seed, 11), device)
    value_lens = sizes(cfg["value_sizes"], n, data.generator(device, seed, 12), device)
    if int(key_lens.min()) < PREFIX:
        raise ValueError(f"keys need at least {PREFIX} bytes for their prefix")
    gen = data.generator(device, seed, 13)
    keys = torch.randint(32, 127, (int(key_lens.sum()),), generator=gen, device=device,
                         dtype=torch.uint8)
    key_at = torch.cumsum(key_lens, 0) - key_lens
    prefix = key_prefixes(data.key_numbers(gen, n, device))
    for j in range(PREFIX):
        keys[key_at + j] = prefix[:, j]
    del prefix, key_at
    values = torch.randint(32, 127, (int(value_lens.sum()),), generator=gen, device=device,
                           dtype=torch.uint8)
    return keys, key_lens, values, value_lens


class Cell(ae_cycle.Cell):
    """``ae_cycle.Cell`` over a ragged set on one card: its own inputs,
    salt, program, probes, input sums and reference leaf hash; the closed
    loop, the window and the release are ``ae_cycle``'s."""

    CONTROLS = ("digest128", "short_leaf")

    def __init__(self, ctx) -> None:
        # The program's ragged leaf set: a program without it fails here.
        from merklekv_tpu_torch.merkle import ragged  # noqa: F401

        if len(ctx.devices) != 1:
            raise ValueError("the ragged cycle runs on one device")
        self.ctx = ctx
        self.devices = list(ctx.devices)
        self.dev = self.devices[0]
        self.shards = 1
        self.n = self.rows = int(ctx.config["keys"])
        self.replicas = int(ctx.config["replicas"])
        self.salt_word = int(ctx.mix["salt_word"])
        self.control = None
        self.facts: dict = {}
        self.probes: dict = {}
        self.cycle = 0
        self.last = None

    # ---------------------------------------------------------------- data
    def make_inputs(self) -> tuple:
        """(blocks [T, 16], offsets [N + 1], digests [R, N, 8], present [R, N])
        on the card, from the seed; and the flat index of the salted word."""
        seed, dev, n = self.ctx.seed, self.dev, self.n
        keys, key_lens, values, value_lens = records(self.ctx.config, seed, dev)
        blocks, offsets = ref_ragged.pack(keys, key_lens, values, value_lens)
        del keys, values
        # The first record whose value holds all of word salt_word's bytes.
        lo = 4 * self.salt_word
        covers = (8 + key_lens <= lo) & (8 + key_lens + value_lens >= lo + 4)
        rec = int(torch.nonzero(covers)[0, 0])
        salt_at = int(offsets[rec]) * 16 + self.salt_word
        base = torch.randint(-(2**31), 2**31 - 1, (n, 8), dtype=torch.int32, device=dev,
                             generator=data.generator(dev, seed, 2))
        digests = base.unsqueeze(0).repeat(self.replicas, 1, 1)
        del base
        present = torch.ones((self.replicas, n), dtype=torch.bool, device=dev)
        div = self.ctx.config["divergence"]
        if div["rule"] != "uniform":
            raise ValueError(f"the ragged cycle takes uniform divergence, not {div['rule']!r}")
        data.uniform_divergence(data.generator(dev, seed, 3), digests, present, div["fraction"])
        ae_cycle._sync(self.devices)
        return (blocks, offsets, digests, present), salt_at

    def _salt(self, cycle: int, blocks: torch.Tensor, digests: torch.Tensor) -> None:
        """Put cycle ``cycle``'s salt in place (and take the last one out).
        Each word is written by a fill of one element, whose value travels
        as the kernel's argument: no copy from the host."""
        salt = ae_cycle.salt_of(cycle)
        blocks.view(-1).narrow(0, self.salt_at, 1).fill_(self.base_word ^ salt)
        if self.prev_row is not None:
            digests[self.prev_row, 0, :1].fill_(self.base_col[self.prev_row])
        row = 1 + cycle % (self.replicas - 1)
        digests[row, 0, :1].fill_(self.base_col[row] ^ salt)
        self.prev_row = row

    # ------------------------------------------------------------- program
    def _program(self):
        blocks, offsets, digests, present = self.inputs
        if self.control is not None:
            return lambda: self._control_step(blocks, offsets, digests, present)
        from merklekv_tpu_torch.merkle import ragged, torch_engine

        leaves = ragged.RaggedLeaves(blocks, offsets)
        return lambda: torch_engine.anti_entropy_forward(leaves, None, digests, present,
                                                         device=self.dev)

    def _control_step(self, blocks, offsets, digests, present):
        """The reference in the program's place with one guarantee broken:
        ``digest128`` compares digests on their first 128 bits only;
        ``short_leaf`` hashes the longest leaf without its last block."""
        leaves = self._reference_leaves()
        if self.control == "short_leaf":
            lengths = offsets[1:] - offsets[:-1]
            i = int(torch.argmax(lengths))
            lo, hi = int(offsets[i]), int(offsets[i + 1])
            leaves[i] = ref_sha.hash_blocks(blocks[lo:hi - 1].unsqueeze(0),
                                            torch.tensor([hi - 1 - lo], device=blocks.device))[0]
        words = 4 if self.control == "digest128" else 8
        masks = ref_tree.diff_masks(digests, present, words=words)
        return ref_tree.tree_root(leaves), masks, masks.sum(dim=1, dtype=torch.int32)

    def setup(self) -> None:
        self.inputs, self.salt_at = self.make_inputs()
        blocks, _off, digests, _p = self.inputs
        self.base_word = int(blocks.view(-1)[self.salt_at].item())
        self.base_col = [int(x) for x in digests[:, 0, 0].tolist()]
        self.prev_row = None
        self.input_sums = self._sums()
        self.step = self._program()
        for _ in range(int(self.ctx.mix["warmup_cycles"])):
            self._one_cycle()
        ae_cycle._sync(self.devices)
        self._probes()

    def _probes(self) -> None:
        """Calls into the leaf hash alone, for the readers to time: on the
        cell's set, and on a set of the cell's longest leaf alone."""
        if self.control is not None:
            return
        from merklekv_tpu_torch.merkle import ragged
        from merklekv_tpu_torch.ops import dispatch

        blocks, offsets = self.inputs[0], self.inputs[1]
        lengths = offsets[1:] - offsets[:-1]
        i = int(torch.argmax(lengths))
        lo, hi = int(offsets[i]), int(offsets[i + 1])
        longest = ragged.RaggedLeaves(blocks[lo:hi],
                                      torch.tensor([0, hi - lo], dtype=torch.int64, device=self.dev))
        leaves = ragged.RaggedLeaves(blocks, offsets)
        self.probes = {
            "leaf": [(self.dev, lambda: dispatch.hash_ragged(leaves),
                      ref_ragged.work(self.n, int(offsets[-1])))],
            "longest": [(self.dev, lambda: dispatch.hash_ragged(longest), hi - lo)],
        }

    # -------------------------------------------------------------- window
    def window(self, tracer) -> dict:
        """``ae_cycle``'s window, with the lane counters' growth over it."""
        before = _lane_counters()
        result = super().window(tracer)
        after = _lane_counters()
        self.facts.update(leaf_blocks=after[0] - before[0], lane_slots=after[1] - before[1])
        return result

    # --------------------------------------------------------------- check
    def _sums(self) -> list:
        """The int64 sum of each input tensor, with the salts taken out."""
        blocks, offsets, digests, present = self.inputs
        flat = blocks.view(-1)
        saved = (flat[self.salt_at].item(),
                 digests[self.prev_row, 0, 0].item() if self.prev_row is not None else None)
        flat[self.salt_at] = self.base_word
        if self.prev_row is not None:
            digests[self.prev_row, 0, 0] = self.base_col[self.prev_row]
        sums = [ae_cycle._sum64(t) for t in (blocks, offsets, digests, present)]
        flat[self.salt_at] = saved[0]
        if self.prev_row is not None:
            digests[self.prev_row, 0, 0] = saved[1]
        return sums

    def _reference_leaves(self) -> torch.Tensor:
        """[N, 8] leaf digests of the benchmark's set by the plain reference."""
        return ref_ragged.hash_ragged(self.inputs[0], self.inputs[1])

    def check(self) -> list:
        """The last timed cycle's root, masks and counts against the plain
        reference over the same inputs: the benchmark's own tensors as the
        last cycle salted them, unchanged otherwise (their sums)."""
        t = time.perf_counter()
        changed = int(self._sums() != self.input_sums)
        _blocks, _off, digests, present = self.inputs
        root = ref_tree.tree_root(self._reference_leaves())
        want = ref_tree.diff_masks(digests, present)
        bad_masks = int((want != self.masks.to(want.device)).sum().item())
        counts = want.sum(dim=1).cpu()
        del want
        bad_counts = int((counts != self.counts_host.to(torch.int64)).sum().item())
        root_bad = int(not torch.equal(root.cpu(), self.root_host.cpu()))
        self.ctx.log(f"[check] reference {time.perf_counter() - t:.3f} s; root "
                     f"{ref_sha.digest_hex(root)}; counts {counts.tolist()}")
        return [("root_mismatch", root_bad, 0), ("mask_mismatches", bad_masks, 0),
                ("count_mismatches", bad_counts, 0), ("inputs_changed", changed, 0)]


def _lane_counters() -> tuple:
    """The program's counters ``device.ae_leaf_blocks`` and
    ``device.ae_leaf_lane_slots`` (0 where it has none)."""
    try:
        from merklekv_tpu_torch.obs.metrics import get_metrics
    except ImportError:
        return 0, 0
    counters = get_metrics().snapshot()["counters"]
    return counters.get("device.ae_leaf_blocks", 0), counters.get("device.ae_leaf_lane_slots", 0)
