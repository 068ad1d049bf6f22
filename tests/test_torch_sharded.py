"""The torch port's sharded tree and diff (``merklekv_tpu_torch/parallel/``)
against the JAX package's, on the CPU.

The JAX programs run on the 8 virtual CPU devices of ``tests/conftest.py``;
the port runs over an explicit device list that repeats the CPU
(``devices=["cpu"] * D``), so every shard, gather and top tree runs for real.
The same inputs, made from a numpy seed, go through both. Tolerance
everywhere: bit-identical (exact equality of words, digests and masks).

Covered: ``make_mesh``; ``sharded_tree_root`` for D in {1, 2, 4, 8} and
per-shard sizes {1, 2, 16}, a keyspace that does not split raising;
``sharded_divergence``, ``sharded_divergence_2d`` and
``sharded_anti_entropy_step``, the masks of the first and the last
gathered in place (one contiguous [R, N] tensor, each shard's own masks in
its columns); the root and the step over shards of any
length (D in {1, 2, 3, 4, 8}, L in {1, 3, 6, ..., 64}: levels that cross the
seams between shards and promote odd nodes) against ``portbench``'s plain
reference and the JAX package's unsharded ``tree_root``, where the JAX
sharded functions refuse a per-shard size that is not a power of two; the sharded
serving state for D in {1, 2, 8} (build, value batch across every shard
boundary, restructure with capacity growth and shrink, drain to empty and
refill, n < D) held to the JAX sharded state's padded levels and TREELEVEL
answers; the promotion-chain sweep against the JAX ``_ref_root_fn``;
``from_levels`` carrying a JAX sharded state across; the diff engine's
sharded branch and its fallback under an injected ``shard*_diff`` fault;
the mirror on a sharded rung and the ladder drills (step-down and climb,
roots golden throughout); ``resolve_shard_count`` and config parsing.
"""

import time

import jax
import numpy as np
import pytest
import torch

from merklekv_tpu.merkle import diff as jdiff
from merklekv_tpu.merkle.incremental import _ref_root_fn
from merklekv_tpu.merkle.jax_engine import tree_root as jax_tree_root
from merklekv_tpu.parallel import make_mesh as jax_make_mesh
from merklekv_tpu.parallel import sharded_merkle as jsm
from merklekv_tpu.parallel.sharded_state import ShardedDeviceMerkleState as JaxSharded
from merklekv_tpu.parallel.sharded_state import resolve_shard_count as jax_resolve
from merklekv_tpu_torch.cluster.change_event import ChangeEvent, OpKind
from merklekv_tpu_torch.cluster.mirror import DeviceTreeMirror
from merklekv_tpu_torch.cluster.retry import RetryPolicy
from merklekv_tpu_torch.config import Config
from merklekv_tpu_torch.device import guard as guard_mod
from merklekv_tpu_torch.device.guard import DeviceDispatchError
from merklekv_tpu_torch.device.ladder import DeviceBackendLadder
from merklekv_tpu_torch.merkle import diff as tdiff
from merklekv_tpu_torch.merkle.cpu import build_levels, ref_level_sizes
from merklekv_tpu_torch.merkle.cpu_state import CpuMerkleState
from merklekv_tpu_torch.merkle.encoding import leaf_hash
from merklekv_tpu_torch.merkle.incremental import DeviceMerkleState, _reduce_levels
from merklekv_tpu_torch.merkle.packing import pack_leaves
from merklekv_tpu_torch.native_bindings import NativeEngine
from merklekv_tpu_torch.obs.flightrec import get_recorder
from merklekv_tpu_torch.obs.metrics import get_metrics
from merklekv_tpu_torch.ops import dispatch
from merklekv_tpu_torch.ops import merkle_paths as mp
from merklekv_tpu_torch.parallel import (
    ShardedDeviceMerkleState,
    make_mesh,
    resolve_shard_count,
    sharded_anti_entropy_step,
    sharded_divergence,
    sharded_divergence_2d,
    sharded_tree_root,
)
from merklekv_tpu_torch.parallel import sharded_merkle as tsm
from merklekv_tpu_torch.parallel.sharded_merkle import sharded_promotion_chain
from merklekv_tpu_torch.testing.device_faults import DeviceFaultInjector
from merklekv_tpu_torch.utils.torchenv import words_np
from portbench.reference import sha256 as ref_sha
from portbench.reference import tree as ref_tree

CPU8 = ["cpu"] * 8
FAST_HEAL = RetryPolicy(first_delay=0.05, max_delay=0.2, jitter=0.0)


def _jmesh(axis_sizes):
    return jax_make_mesh(axis_sizes, devices=jax.devices()[: int(np.prod(list(axis_sizes.values())))])


def _words(seed, shape):
    return np.random.RandomState(seed).randint(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def _counter(name):
    return get_metrics().snapshot()["counters"].get(name, 0)


def _golden_root(items) -> str:
    return build_levels([leaf_hash(k, v) for k, v in sorted(items)])[-1][0].hex() if items else "0" * 64


def _wait(cond, timeout=60.0, poll=0.01) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(poll)
    return False


@pytest.fixture(autouse=True)
def _guard_restored():
    """The guard and its injection slot are process-wide: put them back."""
    old = guard_mod.get_guard().deadline_ms
    guard_mod.configure(deadline_ms=60_000)
    yield
    guard_mod.set_inject(None)
    guard_mod.configure(deadline_ms=old)


# ------------------------------------------------------------------ mesh

@pytest.mark.parametrize("axes", [{"key": 1}, {"key": 4}, {"key": 8}, {"replica": 2, "key": 4},
                                  {"replica": 4, "key": 2}])
def test_make_mesh_shapes(axes):
    m = make_mesh(axes, devices=CPU8)
    assert m.shape == dict(_jmesh(axes).shape) == axes
    assert m.devices.shape == tuple(axes.values())
    assert m.axis_devices("key") == [torch.device("cpu")] * axes["key"]


def test_make_mesh_errors_and_default_axis():
    with pytest.raises(ValueError) as port:
        make_mesh({"key": 16}, devices=CPU8)
    with pytest.raises(ValueError) as ref:
        jax_make_mesh({"key": 16})
    assert str(port.value) == str(ref.value) == "mesh needs 16 devices, have 8"
    assert make_mesh(devices=["cpu"] * 3).shape == {"key": 3}


# ------------------------------------------------------- root / diff / step

@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("per_shard", [1, 2, 16])
def test_sharded_tree_root_matches_jax(d, per_shard):
    leaves = _words(d * 100 + per_shard, (d * per_shard, 8))
    want = np.asarray(jsm.sharded_tree_root(_jmesh({"key": d}), leaves))
    got = words_np(sharded_tree_root(make_mesh({"key": d}, devices=CPU8), leaves))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, words_np(_reduce_levels(torch.from_numpy(leaves.view(np.int32)))[-1][0]))


@pytest.mark.parametrize("n", [10, 12])
def test_sharded_tree_root_rejects_bad_shapes(n):
    """10 leaves do not split over 4 shards: both packages refuse alike. 12
    (3 a shard) the JAX package refuses, not being a power of two a shard;
    the port builds the exact tree."""
    leaves = _words(n, (n, 8))
    with pytest.raises(ValueError) as ref:
        jsm.sharded_tree_root(_jmesh({"key": 4}), leaves)
    if n % 4:
        with pytest.raises(ValueError) as port:
            sharded_tree_root(make_mesh({"key": 4}, devices=CPU8), leaves)
        assert str(port.value) == str(ref.value)
    else:
        got = sharded_tree_root(make_mesh({"key": 4}, devices=CPU8), leaves)
        assert torch.equal(got, ref_tree.tree_root(torch.from_numpy(leaves.view(np.int32))))


RAGGED_D = [1, 2, 3, 4, 8]
RAGGED_L = [1, 3, 6, 12, 20, 33, 48, 64]


@pytest.mark.parametrize("d", RAGGED_D)
@pytest.mark.parametrize("per_shard", RAGGED_L)
def test_sharded_tree_root_over_shards_of_any_length(d, per_shard):
    """N = D * L for any L: the root equals the plain reference's and the
    JAX package's unsharded ``tree_root`` over the concatenated leaves."""
    leaves = _words(d * 1000 + per_shard, (d * per_shard, 8))
    got = sharded_tree_root(make_mesh({"key": d}, devices=CPU8), leaves)
    assert torch.equal(got, ref_tree.tree_root(torch.from_numpy(leaves.view(np.int32))))
    np.testing.assert_array_equal(words_np(got), np.asarray(jax_tree_root(leaves)))


def _records(n):
    keys = [b"ragged:%05d" % i for i in range(n)]
    return keys, [b"value-%d" % (i * 7919 % 1000) for i in range(n)]


# The root of ``_records(99)`` by hashlib alone (length-prefixed leaves,
# sorted keys, SHA-256 of each pair, odd node promoted).
RAGGED_GOLDEN_99 = "efbf7cdbaf3397cf85bc649824706278e324042a91827f9d0175e50f033c4173"


@pytest.mark.parametrize("d", RAGGED_D)
@pytest.mark.parametrize("per_shard", RAGGED_L)
def test_sharded_anti_entropy_step_over_shards_of_any_length(d, per_shard):
    """The fused step at N = D * L for any L: root, masks and counts equal
    the plain reference's ``tree_root`` and ``diff_masks`` over the whole
    keyspace, and the root the JAX package's unsharded ``tree_root``. The
    masks are one contiguous [R, N] tensor on the first device, each
    shard's own ``divergence`` masks in its column slice."""
    n = d * per_shard
    keys, vals = _records(n)
    packed = pack_leaves(keys, vals)
    rng = np.random.RandomState(n)
    dig = np.repeat(_words(n + 7, (1, n, 8)), 3, axis=0)
    pres = np.ones((3, n), bool)
    dig[1, rng.choice(n, (n + 2) // 3, replace=False), 1] ^= 1
    pres[2, rng.choice(n, (n + 3) // 4, replace=False)] = False
    pres[0, n - 1] = False
    root, masks, counts = sharded_anti_entropy_step(
        make_mesh({"key": d}, devices=CPU8), packed.blocks, packed.nblocks, dig, pres)
    leaves = ref_sha.hash_blocks(torch.from_numpy(packed.blocks.view(np.int32)),
                                 torch.from_numpy(packed.nblocks.astype(np.int32)))
    assert torch.equal(root, ref_tree.tree_root(leaves))
    np.testing.assert_array_equal(words_np(root), np.asarray(jax_tree_root(words_np(leaves))))
    want = ref_tree.diff_masks(torch.from_numpy(dig.view(np.int32)), torch.from_numpy(pres))
    assert torch.equal(masks, want)
    assert torch.equal(counts, want.sum(dim=1, dtype=torch.int32))
    _assert_gathered(masks, dig, pres, d)
    if n == 99:
        assert words_np(root).astype(">u4").tobytes().hex() == RAGGED_GOLDEN_99
        assert _golden_root(zip(keys, vals)) == RAGGED_GOLDEN_99


def _assert_gathered(masks, dig, pres, d):
    """``masks`` is one contiguous [R, N] tensor on the CPU equal to
    ``torch.cat`` of each of the d shards' own ``divergence`` masks."""
    r, n = pres.shape
    l = n // d
    shards = [dispatch.divergence(torch.from_numpy(dig[:, s * l:(s + 1) * l].view(np.int32)),
                                  torch.from_numpy(pres[:, s * l:(s + 1) * l]))[0]
              for s in range(d)]
    assert masks.device == torch.device("cpu") and masks.is_contiguous()
    assert tuple(masks.shape) == (r, n) and torch.equal(masks, torch.cat(shards, dim=1))


def _replicas(seed, r, n):
    rng = np.random.RandomState(seed)
    dig = np.repeat(_words(seed, (1, n, 8)), r, axis=0)
    pres = np.ones((r, n), bool)
    for i in range(1, r):
        dig[i, rng.choice(n, 3, replace=False), i % 8] ^= 1
        pres[i, rng.choice(n, 2, replace=False)] = False
    pres[0, rng.choice(n, 2, replace=False)] = False
    return dig, pres


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_sharded_divergence_matches_jax(d):
    dig, pres = _replicas(d, 5, 96)
    jm, jc = jsm.sharded_divergence(_jmesh({"key": d}), dig, pres)
    tm, tc = sharded_divergence(make_mesh({"key": d}, devices=CPU8), dig, pres)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    _assert_gathered(tm, dig, pres, d)
    if d > 1:
        with pytest.raises(ValueError, match="not divisible"):
            sharded_divergence(make_mesh({"key": d}, devices=CPU8), dig[:, :95], pres[:, :95])


@pytest.mark.parametrize("dr,dk", [(1, 8), (2, 4), (4, 2)])
def test_sharded_divergence_2d_matches_jax(dr, dk):
    dig, pres = _replicas(dr * 10 + dk, 8, 32)
    axes = {"replica": dr, "key": dk}
    jm, jc = jsm.sharded_divergence_2d(_jmesh(axes), dig, pres)
    tm, tc = sharded_divergence_2d(make_mesh(axes, devices=CPU8), dig, pres)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tm.numpy(), jdiff.divergence_masks_np(dig, pres))
    with pytest.raises(ValueError, match="replica count"):
        sharded_divergence_2d(make_mesh({"replica": 3, "key": 2}, devices=CPU8), dig, pres)


@pytest.mark.parametrize("d", [2, 8])
def test_sharded_anti_entropy_step_matches_jax(d):
    n = d * 8
    keys = [b"fk%04d" % i for i in range(n)]
    vals = [b"fv%d" % (i * 3) for i in range(n)]
    packed = pack_leaves(keys, vals)
    dig, pres = _replicas(n, 3, n)
    jroot, jmasks, jcounts = jsm.sharded_anti_entropy_step(
        _jmesh({"key": d}), packed.blocks, packed.nblocks, dig, pres)
    root, masks, counts = sharded_anti_entropy_step(
        make_mesh({"key": d}, devices=CPU8), packed.blocks, packed.nblocks, dig, pres)
    np.testing.assert_array_equal(words_np(root), np.asarray(jroot))
    assert words_np(root).astype(">u4").tobytes().hex() == _golden_root(zip(keys, vals))
    np.testing.assert_array_equal(masks.numpy(), np.asarray(jmasks))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    with pytest.raises(ValueError, match="digest key axis"):
        sharded_anti_entropy_step(make_mesh({"key": d}, devices=CPU8), packed.blocks,
                                  packed.nblocks, dig[:, : n // 2], pres[:, : n // 2])


# ------------------------------------------------------------ serving state

def _jax_levels(js) -> list:
    return [np.asarray(lv) for lv in js._levels]


def _assert_same(ts, js, what):
    """Root, every padded level and every TREELEVEL slice of the port's
    sharded state against the JAX sharded state."""
    assert ts.root_hex() == js.root_hex(), what
    got, want = ts.to_numpy_levels(), _jax_levels(js)
    assert len(got) == len(want), what
    for lvl, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: level {lvl}")
    n = len(js)
    for level, m in enumerate(ref_level_sizes(n) if n else []):
        assert ts.level_nodes(level, 0, m) == js.level_nodes(level, 0, m), (what, level)
        assert ts.level_nodes(level, m - 1, m + 3) == js.level_nodes(level, m - 1, m + 3), (what, level)


@pytest.mark.parametrize("d", [1, 2, 8])
def test_sharded_state_matches_jax(d):
    items = {b"sp%05d" % i: b"v%d" % i for i in range(133)}
    js = JaxSharded.from_items(items.items(), shards=d)
    ts = ShardedDeviceMerkleState.from_items(items.items(), shards=d, devices=CPU8)
    assert ts.shard_count == ts._n_shards == d and ts._capacity == js._capacity
    _assert_same(ts, js, "build")

    # A value batch hitting the last leaf of every shard and the first of
    # the next, and both keyspace extremes.
    skeys = sorted(items)
    l = ts._capacity // d
    batch = {skeys[0]: b"first", skeys[-1]: b"last"}
    for b in range(1, d):
        for p in (b * l - 1, b * l):
            if p < len(skeys):
                batch[skeys[p]] = b"x%d" % p
    for st in (js, ts):
        st.apply(list(batch.items()))
    _assert_same(ts, js, "value batch")
    assert ts.incremental_batches == 1 and ts.structural_batches == 0

    # Capacity growth (256 -> 512) with inserts in every shard and a delete.
    changes = [(b"sp%05d-x" % i, b"n%d" % i) for i in range(0, 133, 2)]
    changes += [(b"zz%05d" % i, b"t%d" % i) for i in range(60)]
    changes.append((b"sp00003", None))
    for st in (js, ts):
        st.apply(changes)
    _assert_same(ts, js, "growth")
    # Shrink: delete most keys, capacity falls back.
    dels = [(k, None) for k in sorted(items)[5:] + [b"zz%05d" % i for i in range(60)]]
    for st in (js, ts):
        st.apply(dels)
    _assert_same(ts, js, "shrink")
    assert ts.structural_batches == 2
    # Drain to empty and refill.
    for st in (js, ts):
        st.apply([(k, None) for k in list(st._keys)])
    assert ts.root_hex() == js.root_hex() == "0" * 64 and ts.to_numpy_levels() == []
    for st in (js, ts):
        st.apply([(b"back", b"again")])
    _assert_same(ts, js, "refill")


@pytest.mark.parametrize("d", [2, 8])
def test_sharded_state_smaller_than_its_shards(d):
    """n < D: one-leaf (or empty) shards, capacity padded up to D."""
    items = {b"tiny1": b"a", b"tiny2": b"b"}
    js = JaxSharded.from_items(items.items(), shards=d)
    ts = ShardedDeviceMerkleState.from_items(items.items(), shards=d, devices=CPU8)
    assert ts._capacity == max(2, d)
    _assert_same(ts, js, "build")
    for st in (js, ts):
        st.apply([(b"tiny2", b"B")])
    _assert_same(ts, js, "value batch")
    for st in (js, ts):
        st.apply([(b"tiny0", b"z"), (b"tiny1", None)])
    _assert_same(ts, js, "restructure")
    assert ts.leaf_digest(b"tiny0") == leaf_hash(b"tiny0", b"z")


@pytest.mark.parametrize("l", [1, 8])
def test_promotion_chain_sweep_matches_jax(l):
    """Every n from 1 to 3L + 1 of a C = 4L tree at D = 4: the two-stage
    chain (inside shard (n - 1) // L, then the top tree) gives the JAX
    ``_ref_root_fn`` root and the single-device chain's every row."""
    d, c = 4, 4 * l
    ref = _ref_root_fn(c)
    for n in range(1, min(3 * l + 1, c) + 1):
        leaves = np.zeros((c, 8), np.uint32)
        leaves[:n] = _words(n, (n, 8))
        levels = _reduce_levels(torch.from_numpy(leaves.view(np.int32)))
        want = np.asarray(ref(tuple(jax.numpy.asarray(words_np(lv)) for lv in levels), n))
        ts = ShardedDeviceMerkleState.from_levels(
            [words_np(lv) for lv in levels], [b"%06d" % i for i in range(n)], shards=d,
            devices=CPU8)
        chain = sharded_promotion_chain(ts._levels, ts._top, n)
        np.testing.assert_array_equal(words_np(chain[-1]), want, err_msg=f"n={n}")
        np.testing.assert_array_equal(words_np(chain), words_np(mp.promotion_chain(levels, n)),
                                      err_msg=f"n={n}")


@pytest.mark.parametrize("d", [2, 8])
def test_from_levels_carries_a_jax_sharded_state_across(d):
    items = {b"fl%04d" % i: b"v%d" % i for i in range(77)}
    js = JaxSharded.from_items(items.items(), shards=d)
    js.apply([(b"fl%04d" % i, b"u%d" % i) for i in range(0, 77, 5)])
    js.flush_pending()
    ts = ShardedDeviceMerkleState.from_levels(_jax_levels(js), list(js._keys), shards=d,
                                              devices=CPU8)
    _assert_same(ts, js, "adopted")
    more = [(b"fl%04d" % i, b"w%d" % i) for i in range(1, 77, 9)] + [(b"fl0002", None)]
    for st in (js, ts):
        st.apply(more)
    _assert_same(ts, js, "after a batch on both")
    with pytest.raises(ValueError, match="smaller than"):
        ShardedDeviceMerkleState.from_levels([np.zeros((2, 8), np.uint32),
                                              np.zeros((1, 8), np.uint32)],
                                             [b"a", b"b"], shards=4, devices=CPU8)


def test_sharded_state_guard_labels_and_metrics():
    base = _counter("device.shard_batches")
    with DeviceFaultInjector(match="shard2_build", mode="fail"):
        with pytest.raises(DeviceDispatchError) as e:
            ShardedDeviceMerkleState.from_items([(b"k", b"v")], shards=2, devices=CPU8)
        assert e.value.label == "shard2_build"
        ShardedDeviceMerkleState.from_items([(b"k", b"v")], shards=4, devices=CPU8)
    st = ShardedDeviceMerkleState.from_items(((b"m%03d" % i, b"v") for i in range(40)),
                                             shards=2, devices=CPU8)
    assert _counter("device.shard_batches") == base + 2
    assert st.last_shard_rebuild_us >= 0
    seen = []
    guard_mod.set_inject(type("Spy", (), {"around": lambda self, label, fn: seen.append(label) or fn()})())
    st.apply([(b"m000", b"w")])
    st.root_hex()
    st.level_nodes(0, 0, 2)
    st.apply([(b"m999", b"new")])
    st.flush_pending()
    assert seen == ["shard2_scatter", "shard2_root", "shard2_levels", "shard2_restructure"]


def test_shard_count_validation():
    with pytest.raises(ValueError, match="power of two"):
        ShardedDeviceMerkleState(shards=3, devices=CPU8)
    with pytest.raises(ValueError, match="exceeds local device count"):
        ShardedDeviceMerkleState(shards=16, devices=CPU8)
    assert ShardedDeviceMerkleState(devices=["cpu"] * 6).shard_count == 4  # auto policy
    assert ShardedDeviceMerkleState(devices=["cpu"]).shard_count == 1


@pytest.mark.parametrize("mode,n_dev", [
    ("off", 8), ("auto", 8), ("auto", 6), ("auto", 1), ("2", 8), (4, 8), ("1", 8),
    ("16", 8), ("true", 4), ("none", 4), ("AUTO", 2),
])
def test_resolve_shard_count_matches_jax(mode, n_dev):
    assert resolve_shard_count(mode, n_dev) == jax_resolve(mode, n_dev)
    with pytest.raises(ValueError, match="power-of-two"):
        resolve_shard_count("3", n_dev)


def test_resolve_shard_count_counts_the_cards_by_default():
    assert resolve_shard_count("auto") == (
        0 if torch.cuda.device_count() < 2 else resolve_shard_count("auto", torch.cuda.device_count()))
    assert resolve_shard_count("off") == 0


def test_config_sharding_values(tmp_path):
    assert Config().device.sharding == "off"
    p = tmp_path / "c.toml"
    for text, want in (('sharding = "auto"', "auto"), ("sharding = 4", "4"),
                       ("sharded_mirror = true", "auto")):
        p.write_text(f"[device]\n{text}\n")
        assert Config.load(str(p)).device.sharding == want
    p.write_text("[device]\nsharding = 3\n")
    with pytest.raises(ValueError, match="power-of-two"):
        Config.load(str(p))


# ------------------------------------------------------------ diff engine

@pytest.mark.parametrize("n", [64, 77])
def test_engine_sharded_branch_matches_jax(n, monkeypatch):
    dig, pres = _replicas(n, 5, n)
    calls = []
    real = tsm.sharded_divergence
    monkeypatch.setattr(tsm, "sharded_divergence", lambda *a: calls.append(a[1].shape) or real(*a))
    got = tdiff.divergence_masks_engine(dig, pres, device="cpu", min_keys=0, devices=CPU8)
    want = np.asarray(jdiff.divergence_masks_engine(dig, pres, min_keys=0))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), jdiff.divergence_masks_np(dig, pres))
    assert calls == [(5, n + (-n) % 8, 8)]  # padded with absent columns
    # Below the threshold, or on a one-device list, no sharding.
    tdiff.divergence_masks_engine(dig, pres, device="cpu", devices=CPU8)
    tdiff.divergence_masks_engine(dig, pres, device="cpu", min_keys=0)
    assert len(calls) == 1


def test_engine_falls_back_to_one_device_under_a_shard_fault():
    dig, pres = _replicas(3, 4, 64)
    base = _counter("device.guard_errors")
    with DeviceFaultInjector(match="shard*_diff", mode="fail") as inj:
        got = tdiff.divergence_masks_engine(dig, pres, device="cpu", min_keys=0, devices=CPU8)
        with DeviceFaultInjector(match="shard*_diff", mode="fail"):
            jgot = jdiff.divergence_masks_engine(dig, pres, min_keys=0)
    assert inj.failures == 2  # the guard's one retry, then the fallback
    assert _counter("device.guard_errors") == base + 1
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    np.testing.assert_array_equal(got.numpy(), jdiff.divergence_masks_np(dig, pres))


# ------------------------------------------------------------ mirror / ladder

def test_mirror_sharded_backend_and_pump_contract():
    """A mirror with sharding=8 over eight devices serves the pump-published
    snapshot from the sharded state, equal to the engine's root, and a
    published read never drains staged work."""
    engine = NativeEngine("mem")
    try:
        for i in range(64):
            engine.set(b"mk%03d" % i, b"v%d" % i)
        mirror = DeviceTreeMirror(engine, sharding="8", device="cpu", devices=CPU8,
                                  scrub_interval_s=0.0)
        try:
            mirror.start_warming()
            assert _wait(mirror.ready), "sharded mirror never warmed"
            assert mirror.shard_count() == 8 and mirror.backend_level() == 8
            assert mirror.published_root_hex() == engine.merkle_root().hex()
            engine.set(b"mk000", b"updated")
            ev = ChangeEvent(op=OpKind.SET, key="mk000", val=b"updated", ts=time.time_ns(),
                             src="test")
            gen_before = mirror._published_gen
            mirror.on_events([ev], watermark=engine.version())
            _ = mirror.published_root_hex()  # read-only serve
            mirror.publish_now()
            assert mirror.published_root_hex() == engine.merkle_root().hex()
            assert mirror._published_gen > gen_before
            assert mirror.shard_rebuild_us() >= 0
            rows, n = mirror.level_nodes(0, 60, 64)
            assert n == 64 and rows == CpuMerkleState.from_items(engine.snapshot()).level_nodes(0, 60, 64)[0]
        finally:
            mirror.close()
    finally:
        engine.close()


class _Eng:
    """The engine a mirror reads: a dict and a mutation counter."""

    def __init__(self, n=96):
        self.d = {b"lk:%04d" % i: b"v%d" % i for i in range(n)}
        self.v = 0

    def version(self):
        return self.v

    def get(self, key):
        return self.d.get(key)

    def snapshot(self):
        return sorted(self.d.items())

    def set(self, key, val):
        self.d[key] = val
        self.v += 1

    def golden(self):
        return _golden_root(self.d.items())


def _ev(key: bytes) -> ChangeEvent:
    return ChangeEvent(op=OpKind.SET, key=key.decode(), val=b"x", ts=1, src="t")


def _ladder_mirror(eng, sharding, cpu_rung=True, **kw):
    top = 0 if sharding in ("off", "1") else int(sharding)
    ladder = DeviceBackendLadder(top, degrade_after=1, heal_policy=FAST_HEAL, cpu_rung=cpu_rung)
    kw.setdefault("scrub_interval_s", 0.0)
    kw.setdefault("max_staleness_ms", 50.0)
    return DeviceTreeMirror(eng, sharding=sharding, ladder=ladder, device="cpu", devices=CPU8, **kw)


@pytest.mark.parametrize("sharding,match,expect_rung", [
    ("8", "shard8_*", 4),   # width-8 fault: the largest healthy subset
    ("8", "shard*", 1),     # every sharded width sick: one device
    ("2", "shard2_*", 1),
    ("8", "*", 0),          # the whole device plane sick: CPU golden
])
def test_warm_build_lands_on_surviving_rung(sharding, match, expect_rung):
    eng = _Eng()
    m = _ladder_mirror(eng, sharding)
    try:
        with DeviceFaultInjector(match=match, mode="fail"):
            m.start_warming()
            assert _wait(m.ready), "mirror never warmed"
            assert m.backend_level() == expect_rung
            assert m.published_root_hex() == eng.golden()
            rows, n = m.level_nodes(0, 0, 8)
            assert n == len(eng.d) and rows == CpuMerkleState.from_items(eng.snapshot()).level_nodes(0, 0, 8)[0]
    finally:
        m.close()


@pytest.mark.parametrize("cpu_rung", [True, False])
def test_drain_failure_degrades_then_reclimbs(cpu_rung):
    """A persistent fault on every sharded width mid-serve: each failed
    drain invalidates and re-warms one rung lower until one device serves,
    bit-identical, stamps monotone; the card's ladder (no CPU rung) never
    reaches rung 0. After heal the probe climbs back to sharded(8)."""
    eng = _Eng()
    m = _ladder_mirror(eng, "8", cpu_rung=cpu_rung)
    seen = set()
    try:
        m.start_warming()
        assert _wait(m.ready)
        assert m.backend_level() == 8 and m.published_root_hex() == eng.golden()
        v0 = m.published_version()
        inj = DeviceFaultInjector(match="shard*", mode="fail").install()
        try:
            eng.set(b"lk:0000", b"CHANGED")
            m.on_events([_ev(b"lk:0000")], watermark=eng.version())

            def contained():
                seen.add(m.backend_level())
                return m.ready() and m.backend_level() == 1 and m.staleness() == 0

            assert _wait(contained), f"never contained at one device (rung {m.backend_level()})"
            assert m.published_root_hex() == eng.golden()
            v1 = m.published_version()
            assert v1 >= v0
            assert "device_degraded" in [e.kind for e in get_recorder().last(100)]
        finally:
            inj.heal()
        assert _wait(lambda: seen.add(m.backend_level()) or m.backend_level() == 8), "never reclimbed"
        assert "device_healed" in [e.kind for e in get_recorder().last(100)]
        eng.set(b"lk:0001", b"AFTERHEAL")
        m.on_events([_ev(b"lk:0001")], watermark=eng.version())
        assert _wait(lambda: m.staleness() == 0 and m.published_root_hex() == eng.golden())
        assert m.published_version() >= v1
        assert 0 not in seen
        inj.uninstall()
    finally:
        m.close()


def test_scatter_fault_steps_down_one_rung_on_the_card_ladder():
    """``fail:shard8_scatter`` on the card's ladder: the one failed drain
    re-warms on rung 4 (a sharded rung, never the host), which serves the
    golden root; the counters are exactly those of the injected failure."""
    eng = _Eng()
    m = DeviceTreeMirror(eng, sharding="8", device="cpu", devices=CPU8, scrub_interval_s=0.0,
                         ladder=DeviceBackendLadder(8, degrade_after=1, cpu_rung=False,
                                                    heal_policy=RetryPolicy(first_delay=600.0)))
    names = ("device.guard_errors", "device.pump_errors", "device.rewarms",
             "device.degraded_total", "device.warm_errors")
    try:
        m.start_warming()
        assert _wait(m.ready) and m.backend_level() == 8
        base = {k: _counter(k) for k in names}
        with DeviceFaultInjector(match="shard8_scatter", mode="fail") as inj:
            eng.set(b"lk:0005", b"F")
            m.on_events([_ev(b"lk:0005")], watermark=eng.version())
            assert _wait(lambda: m.ready() and m.backend_level() == 4)
            m.publish_now()
            assert m.published_root_stamped() == (eng.golden(), eng.version())
        assert inj.failures == 2
        assert {k: _counter(k) - base[k] for k in names} == {
            "device.guard_errors": 1, "device.pump_errors": 1, "device.rewarms": 1,
            "device.degraded_total": 1, "device.warm_errors": 0}
    finally:
        m.close()
