"""The torch serving tree (``DeviceMerkleState``) against the golden
``CpuMerkleState`` and the JAX ``DeviceMerkleState`` on the CPU.

Seeded random streams of value updates, inserts and deletes; after every
batch the root and every ``level_nodes`` slice (whole levels, each level's
last node, a random window) must be identical across the three. The JAX
state runs the scan path (the Pallas kernels' own plain reference); the torch
state runs the plain PyTorch versions behind the CUDA wrappers. Tolerance:
exact equality. Sizes stay inside one capacity bucket (33..64 keys) and
batches inside one batch bucket (<= 16), so the JAX programs compile once.

The plain versions of the two serving kernels (``ops/merkle_paths.py``) are
also held level by level against the JAX programs they replace: the fused
path rehash against ``_scatter_levels`` (run through ``_scatter_hash_fn``,
leaf hashing included) and the promotion chain against ``_ref_root_fn`` and
the golden reference tree.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merklekv_tpu.merkle.cpu_state import CpuMerkleState as JaxCpuMerkleState
from merklekv_tpu.merkle.incremental import DeviceMerkleState as JaxState
from merklekv_tpu.merkle.incremental import _ref_root_fn, _scatter_hash_fn
from merklekv_tpu_torch.merkle import incremental as t_inc
from merklekv_tpu_torch.merkle.cpu import build_levels as golden_levels
from merklekv_tpu_torch.merkle.cpu import ref_level_sizes
from merklekv_tpu_torch.merkle.cpu_state import CpuMerkleState
from merklekv_tpu_torch.merkle.incremental import DeviceMerkleState
from merklekv_tpu_torch.ops import dispatch
from merklekv_tpu_torch.ops import merkle_paths as mp
from merklekv_tpu_torch.ops.sha256 import digests_to_bytes

CPU = "cpu"
UNIVERSE = [b"sk%03d" % i for i in range(64)]


def _initial(seed: int):
    rng = np.random.RandomState(seed)
    keys = sorted(rng.choice(len(UNIVERSE), size=48, replace=False))
    return {UNIVERSE[i]: b"v%d" % rng.randint(100) for i in keys}


def _assert_same(states, rng, what: str) -> None:
    roots = {type(s).__module__ + type(s).__name__: s.root_hex() for s in states}
    assert len(set(roots.values())) == 1, (what, roots)
    n = states[0].leaf_count()
    assert all(s.leaf_count() == n for s in states), what
    for level, m in enumerate(ref_level_sizes(n)):
        lo = int(rng.randint(0, m))
        for a, b in ((0, m), (m - 1, m), (lo, lo + 3), (0, m + 5)):
            answers = [s.level_nodes(level, a, b) for s in states]
            assert all(x == answers[0] for x in answers), (what, level, a, b)
    assert all(s.level_nodes(len(ref_level_sizes(n)), 0, 4) == ([], n) for s in states)


def _random_batch(rng, items: dict, round_: int) -> list:
    batch = []
    for _ in range(rng.randint(1, 12)):
        k = UNIVERSE[rng.randint(len(UNIVERSE))]
        if rng.rand() < 0.3 and k in items and len(items) > 34:
            del items[k]
            batch.append((k, None))
        else:
            v = b"r%d-%d" % (round_, rng.randint(1000))
            items[k] = v
            batch.append((k, v))
    return batch


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_stream_matches_cpu_and_jax(seed):
    items = _initial(seed)
    states = [
        DeviceMerkleState.from_items(items.items(), device=CPU),
        CpuMerkleState.from_items(items.items()),
        JaxState.from_items(items.items()),
    ]
    rng = np.random.RandomState(100 + seed)
    _assert_same(states, rng, "build")
    for round_ in range(8):
        if round_ % 3 == 2:
            # A pure value-update batch: the in-place scatter path.
            keys = [UNIVERSE[i] for i in rng.choice(64, size=10) if UNIVERSE[i] in items]
            batch = [(k, b"u%d-%d" % (round_, rng.randint(1000))) for k in keys]
            items.update(batch)
        else:
            batch = _random_batch(rng, items, round_)
        for s in states:
            s.apply(batch)
        _assert_same(states, rng, f"seed {seed} round {round_}")
        assert len(states[0]) == len(items)
    t, _, j = states
    assert (t.full_rebuilds, t.incremental_batches, t.structural_batches) == (
        j.full_rebuilds, j.incremental_batches, j.structural_batches)
    assert t.incremental_batches >= 2 and t.structural_batches >= 1
    assert t.full_rebuilds == 1


def test_pending_and_flush_semantics():
    items = _initial(3)
    t = DeviceMerkleState.from_items(items.items(), device=CPU)
    c = CpuMerkleState.from_items(items.items())
    before = t.root_hex()
    change = [(UNIVERSE[0], b"staged"), (UNIVERSE[63], None)]
    t.apply(change)
    c.apply(change)
    assert t.pending_count() == 2
    assert t.root_hex(flush=False) == before  # served as built
    assert t.level_nodes(0, 0, 2, flush=False) == c.level_nodes(0, 0, 2, flush=False)
    t.flush_pending()
    assert t.pending_count() == 0
    assert t.root_hex() == c.root_hex() != before
    assert t.leaf_digest(UNIVERSE[0]) == c.leaf_digest(UNIVERSE[0])
    assert t.leaf_digest(b"absent") is None


def test_empty_and_grow_from_empty():
    t = DeviceMerkleState(device=CPU)
    c = CpuMerkleState()
    assert t.root_hash() is None and t.root_hex() == "0" * 64
    assert t.level_nodes(0, 0, 4) == ([], 0) and len(t) == 0
    batch = [(b"a", b"1"), (b"b", b"2"), (b"c", b"3")]
    t.apply(batch)
    c.apply(batch)
    assert t.root_hex() == c.root_hex()
    t.apply([(k, None) for k, _ in batch])
    assert t.root_hash() is None and t.to_numpy_levels() == []


def test_copied_cpu_state_matches_jax_cpu_state():
    items = _initial(4)
    ours = CpuMerkleState.from_items(items.items())
    theirs = JaxCpuMerkleState.from_items(items.items())
    rng = np.random.RandomState(5)
    for round_ in range(3):
        batch = _random_batch(rng, items, round_)
        ours.apply(batch)
        theirs.apply(batch)
        assert ours.root_hex() == theirs.root_hex()
        assert ours.level_nodes(1, 0, 64) == theirs.level_nodes(1, 0, 64)


def _jax_levels(js) -> list:
    return [np.asarray(lv) for lv in js._levels]


def test_from_levels_to_numpy_levels_round_trip():
    """A tree built by either package is carried into the other and queried,
    with identical answers and identical padded levels."""
    import jax.numpy as jnp

    items = _initial(6)
    js = JaxState.from_items(items.items())
    t = DeviceMerkleState.from_levels(_jax_levels(js), list(js._keys), device=CPU)
    rng = np.random.RandomState(7)
    _assert_same([t, js], rng, "adopted")

    for round_, batch in enumerate([
        [(k, b"x" + k) for k in sorted(items)[:9]],
        _random_batch(rng, items, 1),
    ]):
        t.apply(batch)
        js.apply(batch)
        _assert_same([t, js], rng, f"round {round_}")
        for a, b in zip(t.to_numpy_levels(), _jax_levels(js)):
            np.testing.assert_array_equal(a, b)

    # ... and back: the torch tree's levels loaded into a JAX state.
    back = JaxState()
    back._levels = tuple(jnp.asarray(lv) for lv in t.to_numpy_levels())
    back._set_keys(np.array(list(t._keys), dtype=object))
    back._capacity = t._capacity
    _assert_same([t, back], rng, "carried back")


def test_from_levels_rejects_inconsistent_input():
    items = _initial(8)
    t = DeviceMerkleState.from_items(items.items(), device=CPU)
    levels, keys = t.to_numpy_levels(), list(t._keys)
    with pytest.raises(ValueError):
        DeviceMerkleState.from_levels(levels[:-1], keys, device=CPU)
    with pytest.raises(ValueError):
        DeviceMerkleState.from_levels(levels, keys[::-1], device=CPU)
    with pytest.raises(ValueError):
        DeviceMerkleState.from_levels([lv[:3] for lv in levels], keys, device=CPU)
    with pytest.raises(ValueError):
        DeviceMerkleState.from_levels(levels, [], device=CPU)
    assert DeviceMerkleState.from_levels([], [], device=CPU).root_hash() is None


def test_levels_are_int32_on_requested_device():
    t = DeviceMerkleState.from_items(_initial(9).items(), device=CPU)
    assert all(lv.dtype == torch.int32 and lv.device.type == "cpu" for lv in t._levels)
    assert t._capacity == 64 and len(t._levels) == 7


# ------------------------------------------- the serving kernels' plain versions

PATH_C = 1024  # one JAX program (capacity 1024, batch bucket 1024) for every case


def _rand_u32(rng, shape) -> np.ndarray:
    return rng.randint(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def _padded_levels(leaves: np.ndarray) -> list:
    """Every padded level of [C, 8] uint32 leaves, as CPU int32 tensors."""
    return dispatch.build_levels(torch.from_numpy(leaves.view(np.int32)))


PATH_CASES = {
    "k1": lambda rng: [517],
    "sibling_pair": lambda rng: [6, 7],
    "first_and_last": lambda rng: [0, PATH_C - 1],
    "one_subtree": lambda rng: list(range(256, 384)),
    "every_leaf": lambda rng: list(range(PATH_C)),
    "random_257": lambda rng: sorted(rng.choice(PATH_C, size=257, replace=False)),
}


@pytest.mark.parametrize("case", sorted(PATH_CASES))
def test_path_rehash_plain_matches_jax_scatter_levels(case):
    rng = np.random.RandomState(sorted(PATH_CASES).index(case))
    levels = _padded_levels(_rand_u32(rng, (PATH_C, 8)))
    jax_levels = tuple(jnp.asarray(lv.numpy().view(np.uint32)) for lv in levels)
    pos = np.asarray(PATH_CASES[case](rng), np.int64)
    k = len(pos)
    blocks = _rand_u32(rng, (k, 2, 16))
    nblocks = rng.randint(0, 3, size=k).astype(np.int32)

    counters = torch.zeros(PATH_C - 1, dtype=torch.int32)
    mp.path_rehash_cuda(levels, counters, torch.from_numpy(blocks.view(np.int32)),
                        torch.from_numpy(nblocks), pos)

    # The JAX program pads its batch to a bucket with duplicates of entry 0.
    kb = PATH_C
    idx = np.concatenate([pos, np.full(kb - k, pos[0])]).astype(np.int32)
    jb = np.concatenate([blocks, np.repeat(blocks[:1], kb - k, axis=0)])
    jn = np.concatenate([nblocks, np.repeat(nblocks[:1], kb - k)])
    want = _scatter_hash_fn(PATH_C, kb, 2, False)(
        jax_levels, jnp.asarray(idx), jnp.asarray(jb), jnp.asarray(jn))
    assert len(want) == len(levels) == 11
    for lvl, (got, exp) in enumerate(zip(levels, want)):
        np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(exp),
                                      err_msg=f"{case}: level {lvl}")
    assert not counters.any()


@pytest.mark.parametrize("n", [1, 2, 3, PATH_C // 2 + 1, PATH_C - 1, PATH_C])
def test_promotion_chain_plain_matches_jax_ref_root(n):
    rng = np.random.RandomState(n)
    leaves = np.zeros((PATH_C, 8), np.uint32)
    leaves[:n] = _rand_u32(rng, (n, 8))
    levels = _padded_levels(leaves)
    chain = mp.promotion_chain_cuda(levels, n)
    assert chain.shape == (len(ref_level_sizes(n)), 8)
    jax_levels = tuple(jnp.asarray(lv.numpy().view(np.uint32)) for lv in levels)
    root = np.asarray(_ref_root_fn(PATH_C)(jax_levels, n))
    np.testing.assert_array_equal(chain[-1].numpy().view(np.uint32), root)
    golden = golden_levels(digests_to_bytes(leaves[:n]))
    assert digests_to_bytes(chain.numpy().view(np.uint32)) == [lv[-1] for lv in golden]


@pytest.mark.parametrize("d,nblk", [(0, 0), (3, 0), (0, 1), (20, 1)])
def test_hash_chain_plain_vs_hashlib(d, nblk):
    """The plain version of the serial-floor microkernel: a one-block leaf
    (the row is a padded message) or the row's first half, then
    x <- sha256(x || y) d times, y the row's second half."""
    rng = np.random.RandomState(100 * d + nblk)
    msgs = [rng.bytes(rng.randint(0, 56)) for _ in range(32)]
    padded = [m + b"\x80" + bytes(55 - len(m)) + (8 * len(m)).to_bytes(8, "big") for m in msgs]
    rows = np.stack([np.frombuffer(p, ">u4").astype(np.uint32) for p in padded])
    got = mp.hash_chain(torch.from_numpy(rows.view(np.int32)), d, nblk).numpy().view(np.uint32)
    for msg, row, out in zip(msgs, rows, got):
        x = hashlib.sha256(msg).digest() if nblk else row[:8].astype(">u4").tobytes()
        y = row[8:].astype(">u4").tobytes()
        for _ in range(d):
            x = hashlib.sha256(x + y).digest()
        assert out.astype(">u4").tobytes() == x


def test_path_rehash_rejects_unsorted_or_duplicate_positions():
    levels = _padded_levels(np.zeros((16, 8), np.uint32))
    counters = torch.zeros(15, dtype=torch.int32)
    blocks = torch.zeros((2, 1, 16), dtype=torch.int32)
    nblocks = torch.ones(2, dtype=torch.int32)
    for bad in ([3, 3], [5, 2]):
        with pytest.raises(ValueError, match="sorted and unique"):
            mp.path_rehash_cuda(levels, counters, blocks, nblocks, np.array(bad))
    with pytest.raises(ValueError, match="outside capacity"):
        mp.path_rehash_cuda(levels, counters, blocks, nblocks, np.array([3, 16]))
    with pytest.raises(ValueError):
        mp.path_rehash_cuda(levels, counters, blocks[:1], nblocks, np.array([1, 2]))
    with pytest.raises(ValueError):
        mp.promotion_chain_cuda(levels, 17)
    with pytest.raises(ValueError):
        mp.promotion_chain_cuda(levels[:-1], 3)


VALUE_BATCHES = {
    "one_key": lambda keys, rng: keys[17:18],
    "sibling_pair": lambda keys, rng: keys[10:12],
    "first_and_last": lambda keys, rng: [keys[0], keys[-1]],
    "every_key": lambda keys, rng: list(keys),
    "random": lambda keys, rng: [keys[i] for i in rng.choice(len(keys), size=13)],
}


@pytest.mark.parametrize("case", sorted(VALUE_BATCHES))
def test_value_batches_match_jax_and_cpu_state(case):
    """Value-only batches take the fused path on the torch state; the
    trees, roots and every level slice stay equal to the JAX state's and
    CpuMerkleState's."""
    items = _initial(11)
    states = [
        DeviceMerkleState.from_items(items.items(), device=CPU),
        CpuMerkleState.from_items(items.items()),
        JaxState.from_items(items.items()),
    ]
    rng = np.random.RandomState(12)
    keys = sorted(items)
    for round_ in range(3):
        batch = [(k, b"w%d-%d" % (round_, rng.randint(1000)))
                 for k in VALUE_BATCHES[case](keys, rng)]
        for s in states:
            s.apply(batch)
        _assert_same(states, rng, f"{case} round {round_}")
    t, _, j = states
    assert t.incremental_batches == j.incremental_batches == 3
    assert t.structural_batches == 0
    for a, b in zip(t.to_numpy_levels(), _jax_levels(j)):
        np.testing.assert_array_equal(a, b)


def test_failed_value_batch_is_restored_with_fresh_counters(monkeypatch):
    items = _initial(13)
    t = DeviceMerkleState.from_items(items.items(), device=CPU)
    c = CpuMerkleState.from_items(items.items())
    batch = [(k, b"again") for k in sorted(items)[:5]]
    t.apply(batch[:2])
    t.flush_pending()
    assert t._counters is not None and t._counters.shape == mp.path_scratch(64, CPU).shape

    def boom(*args):
        raise RuntimeError("CUDA kernel path_rehash failed to launch")

    monkeypatch.setattr(t_inc, "rehash_paths", boom)
    t.apply(batch)
    with pytest.raises(RuntimeError):
        t.flush_pending()
    assert t.pending_count() == 5 and t._counters is None
    monkeypatch.undo()
    c.apply(batch)
    assert t.root_hex() == c.root_hex()
    assert t._counters is not None and not t._counters.any()
