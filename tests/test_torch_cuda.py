"""The CUDA kernels on the card: wrappers, launch counts, and parity with the
plain versions and the CPU path. Tolerance: exact equality.

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips without a GPU. This file imports nothing of JAX, so it runs on a
machine without JAX too (bypassing ``tests/conftest.py``, which imports it):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import hashlib
import json
import threading

import numpy as np
import pytest
import torch

from merklekv_tpu_torch.device.guard import DispatchGuard
from merklekv_tpu_torch.merkle import diff as tdiff
from merklekv_tpu_torch.merkle import ragged
from merklekv_tpu_torch.merkle import torch_engine as te
from merklekv_tpu_torch.merkle.cpu_state import CpuMerkleState
from merklekv_tpu_torch.merkle.incremental import DeviceMerkleState
from merklekv_tpu_torch.ops import cuda_lib as cl
from merklekv_tpu_torch.ops import diff_cuda as dc
from merklekv_tpu_torch.ops import dispatch
from merklekv_tpu_torch.ops import merkle_paths as mp
from merklekv_tpu_torch.ops import sha256 as plain
from merklekv_tpu_torch.ops import sha256_cuda as sc
from merklekv_tpu_torch.utils import device_profile

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _launches(**counts):
    """Every key of ``LAUNCHES`` at 0 but the ``counts`` given."""
    return {**dict.fromkeys(cl.LAUNCHES, 0), **counts}


def _words(seed, shape, device):
    arr = np.random.RandomState(seed).randint(0, 2**32, size=shape, dtype=np.uint64)
    return torch.from_numpy(arr.astype(np.uint32).view(np.int32)).to(device)


@pytest.mark.parametrize("n", [1, 3, 257, 65537])
def test_kernels_match_plain_versions(dev, n):
    blocks = _words(n, (n, 2, 16), dev)
    nblocks = torch.arange(n, dtype=torch.int32, device=dev) % 3
    assert torch.equal(sc.leaf_digests_cuda(blocks, nblocks), plain.sha256_blocks(blocks, nblocks))
    cur = _words(n + 1, (n + 1, 8), dev)
    assert torch.equal(sc.node_level_cuda(cur), plain.sha256_node_level(cur))
    left, right = _words(n + 2, (n, 8), dev), _words(n + 3, (n, 8), dev)
    assert torch.equal(sc.node_pairs_cuda(left, right), plain.sha256_node_pairs(left, right))


# The pairs kernel's launch (csrc/node_pairs.cuh) at p on each side of one
# warp, of one 4-warp block, of the serving batch and of one 4-warp block
# per SM. ("sms", o) stands for 4 * 32 * SMs + o, resolved on the card.
PAIRS_EDGES = [1, 31, 32, 33, 127, 128, 129, 4095, 4096, 4097,
               ("sms", -1), ("sms", 0), ("sms", 1), 65537, 1 << 20]


@pytest.mark.parametrize("p", PAIRS_EDGES, ids=str)
def test_node_pairs_kernel_at_shape_edges(dev, p):
    if isinstance(p, tuple):
        p = 4 * 32 * torch.cuda.get_device_properties(dev).multi_processor_count + p[1]
    left, right = _words(p, (p, 8), dev), _words(p + 1, (p, 8), dev)
    before = cl.LAUNCHES["node_pairs"]
    got = sc.node_pairs_cuda(left, right)
    assert cl.LAUNCHES["node_pairs"] == before + 1
    assert torch.equal(got, plain.sha256_node_pairs(left, right))
    rows = [(left[i], right[i]) for i in (0, p // 2, p - 1)]
    want = [hashlib.sha256(b"".join(r.cpu().numpy().view(np.uint32).astype(">u4").tobytes()
                                    for r in pair)).digest() for pair in rows]
    got_rows = got[[0, p // 2, p - 1]].cpu().numpy().view(np.uint32)
    assert plain.digests_to_bytes(got_rows) == want


def test_node_kernels_match_hashlib(dev):
    cur = _words(7, (64, 8), dev)
    rows = [r.astype(">u4").tobytes() for r in cur.cpu().numpy().view(np.uint32)]
    want = [hashlib.sha256(rows[2 * i] + rows[2 * i + 1]).digest() for i in range(32)]
    got = sc.node_level_cuda(cur).cpu().numpy().view(np.uint32)
    assert plain.digests_to_bytes(got) == want
    got = sc.node_pairs_cuda(cur[0::2].contiguous(), cur[1::2].contiguous())
    assert plain.digests_to_bytes(got.cpu().numpy().view(np.uint32)) == want


# ------------------------------------------- the adds on the FMA pipe
# leaf_kernel, node_level_kernel and bulk_kernel add in the FMA form
# (csrc/sha256_core.cuh, MkvFmaAdd): held to hashlib and the plain versions
# at the block counts and widths where their loops and tails turn, and on
# words of 0xFFFFFFFF, where every add carries.

_IV_BYTES = np.asarray(plain._IV, dtype=np.uint32).astype(">u4").tobytes()


def _padded(msg: bytes) -> np.ndarray:
    """``msg`` padded as FIPS 180-4 says, as [blocks, 16] uint32 words."""
    padded = msg + b"\x80" + b"\x00" * ((55 - len(msg)) % 64) + (8 * len(msg)).to_bytes(8, "big")
    return np.frombuffer(padded, ">u4").astype(np.uint32).reshape(-1, 16)


def _message(rng, nb: int, ones: bool) -> bytes:
    """A message whose padding takes ``nb`` >= 1 blocks: random bytes, or
    every byte 0xFF."""
    length = int(rng.randint(max(0, 64 * nb - 72), 64 * nb - 8))
    return b"\xff" * length if ones else rng.bytes(length)


@pytest.mark.parametrize("nb", [0, 1, 16, 17])
def test_leaf_kernel_matches_hashlib_in_padded_rows(dev, nb):
    """Rows of ``nb`` blocks (every seventh row another count) in [n, 18, 16]
    with random words past each row's count, random and 0xFF messages: each
    row is hashlib's digest of its message, the IV at 0 blocks, and the
    plain version's row."""
    rng = np.random.RandomState(nb)
    n, width = 300, 18
    counts = np.full(n, nb, dtype=np.int32)
    counts[::7] = rng.randint(0, width, size=len(counts[::7]))
    blocks = rng.randint(0, 2**32, size=(n, width, 16), dtype=np.uint64).astype(np.uint32)
    want = []
    for i, c in enumerate(counts):
        msg = _message(rng, int(c), ones=i % 3 == 0) if c else None
        if msg is not None:
            blocks[i, :c] = _padded(msg)
        want.append(hashlib.sha256(msg).digest() if msg is not None else _IV_BYTES)
    bt = torch.from_numpy(blocks.view(np.int32)).to(dev)
    ct = torch.from_numpy(counts).to(dev)
    got = sc.leaf_digests_cuda(bt, ct)
    assert torch.equal(got, plain.sha256_blocks(bt, ct))
    assert plain.digests_to_bytes(got.cpu().numpy().view(np.uint32)) == want


@pytest.mark.parametrize("m", [1, 2, 3, 4, 255, 256, 257, 513, 65537])
def test_node_level_kernel_matches_hashlib_at_odd_and_even_widths(dev, m):
    """A level of ``m`` rows, its first two of 0xFFFFFFFF words: m // 2
    parents, each hashlib's digest of its two rows and the plain version's;
    one row makes no parent and no launch."""
    cur = _words(m, (m, 8), dev)
    cur[:2] = -1
    before = cl.LAUNCHES["node_level"]
    got = sc.node_level_cuda(cur)
    assert got.shape == (m // 2, 8)
    assert cl.LAUNCHES["node_level"] == before + (m >= 2)
    assert torch.equal(got, plain.sha256_node_level(cur))
    rows = [r.astype(">u4").tobytes() for r in cur.cpu().numpy().view(np.uint32)]
    want = [hashlib.sha256(rows[2 * i] + rows[2 * i + 1]).digest() for i in range(m // 2)]
    assert plain.digests_to_bytes(got.cpu().numpy().view(np.uint32)) == want


def test_bulk_kernel_matches_hashlib_on_empty_and_long_leaves(dev):
    """Every leaf in bulk_kernel (none chained): leaves of 0 blocks (the
    IV), 1, 17 and 3,000 blocks and 500 of 0 to 39, random and 0xFF
    messages, each hashlib's digest and the plain version's; the scheduled
    launch (chains beside the bulk) gives the same rows."""
    rng = np.random.RandomState(3)
    counts = [0, 1, 3000, 0, 17, 2, 3000, 1, 0] + [int(c) for c in rng.randint(0, 40, size=500)]
    msgs = [_message(rng, c, ones=i % 3 == 0) if c else None for i, c in enumerate(counts)]
    words = np.concatenate([_padded(m) for m in msgs if m is not None])
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    leaves = ragged.RaggedLeaves(torch.from_numpy(words.view(np.int32)).to(dev),
                                 torch.from_numpy(offsets).to(dev))
    got = sc.leaf_ragged_cuda(leaves.blocks, leaves.offsets, leaves.order, 0)
    want = plain.sha256_ragged(leaves.blocks, leaves.offsets)
    assert torch.equal(got, want)
    assert torch.equal(dispatch.hash_ragged(leaves), want)
    assert plain.digests_to_bytes(got.cpu().numpy().view(np.uint32)) == [
        hashlib.sha256(m).digest() if m is not None else _IV_BYTES for m in msgs]


def test_launch_counts_and_empty_inputs(dev):
    cl.reset_launch_counts()
    e8 = torch.empty((0, 8), dtype=torch.int32, device=dev)
    assert sc.leaf_digests_cuda(torch.empty((0, 1, 16), dtype=torch.int32, device=dev),
                                torch.empty(0, dtype=torch.int32, device=dev)).shape == (0, 8)
    one_row = torch.zeros((1, 8), dtype=torch.int32, device=dev)
    assert sc.node_level_cuda(one_row).shape == (0, 8)
    assert sc.node_pairs_cuda(e8, e8).shape == (0, 8)
    assert set(cl.LAUNCHES.values()) == {0}
    x = _words(1, (4, 8), dev)
    sc.node_level_cuda(x)
    sc.node_pairs_cuda(x, x)
    sc.leaf_digests_cuda(_words(2, (4, 1, 16), dev), torch.ones(4, dtype=torch.int32, device=dev))
    assert cl.LAUNCHES == _launches(leaf=1, node_level=1, node_pairs=1)


def test_wrappers_reject_bad_tensors(dev):
    good = _words(3, (8, 8), dev)
    with pytest.raises(TypeError):
        sc.node_level_cuda(good.to(torch.int64))
    with pytest.raises(ValueError):
        sc.node_level_cuda(good[:, :4])
    with pytest.raises(ValueError):
        sc.node_pairs_cuda(good.t().contiguous().t(), good)  # non-contiguous
    with pytest.raises(ValueError):
        sc.node_pairs_cuda(good, good.cpu())
    with pytest.raises(ValueError):
        sc.node_pairs_cuda(good, good[:4])
    with pytest.raises(ValueError):
        sc.leaf_digests_cuda(_words(4, (8, 1, 16), dev), torch.ones(7, dtype=torch.int32, device=dev))


def test_engine_on_card_matches_cpu(dev):
    keys = [b"ck%05d" % i for i in range(3001)]
    vals = [b"v%d" % (i * 7) for i in range(3001)]
    on_card = te.leaf_digests(keys, vals)  # device=None means CUDA
    assert on_card.device.type == "cuda"
    on_cpu = te.leaf_digests(keys, vals, device="cpu")
    assert torch.equal(on_card.cpu(), on_cpu)
    assert torch.equal(te.tree_root(on_card).cpu(), te.tree_root(on_cpu))
    padded = torch.zeros((4096, 8), dtype=torch.int32, device=dev)
    padded[:3001] = on_card
    assert torch.equal(te.tree_root_capacity(padded, 3001).cpu(), te.tree_root(on_cpu))


def test_serving_tree_on_card_matches_cpu(dev):
    items = {b"sk%04d" % i: b"v%d" % i for i in range(300)}
    card = DeviceMerkleState.from_items(items.items())
    cpu = DeviceMerkleState.from_items(items.items(), device="cpu")
    rng = np.random.RandomState(0)
    for round_ in range(4):
        batch = [(b"sk%04d" % i, b"u%d" % round_) for i in rng.randint(0, 400, size=20)]
        batch += [(b"sk%04d" % i, None) for i in rng.randint(0, 400, size=3 * (round_ % 2))]
        card.apply(batch)
        cpu.apply(batch)
        assert card.root_hex() == cpu.root_hex()
        n = card.leaf_count()
        for level, m in enumerate(card.ref_level_sizes(n)):
            assert card.level_nodes(level, 0, m) == cpu.level_nodes(level, 0, m)
    for a, b in zip(card.to_numpy_levels(), cpu.to_numpy_levels()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [3, 300, 1025])
def test_sharded_state_on_card_matches_single_device(dev, n):
    """The sharded serving tree over ``[cuda:0] * 4`` (one-leaf shards at
    n = 3) against the single-device state on the card: roots, every level,
    TREELEVEL slices, through value and structural batches; a value batch is
    one ``path_rehash`` per shard that received keys plus the top reduce."""
    from merklekv_tpu_torch.parallel import ShardedDeviceMerkleState

    items = {b"sh%05d" % i: b"v%d" % i for i in range(n)}
    card = ShardedDeviceMerkleState.from_items(items.items(), shards=4, devices=[dev] * 4)
    one = DeviceMerkleState.from_items(items.items())
    rng = np.random.RandomState(n)
    for round_ in range(4):
        # Updates of live keys only: rounds 0, 1 and 3 are value batches.
        live = one._keys
        keys = sorted({live[i] for i in rng.randint(0, len(live), size=max(1, n // 10))})
        batch = [(k, b"u%d" % round_) for k in keys]
        if round_ == 2:
            batch += [(b"sh%05d-x" % i, b"new") for i in range(0, n, 7)]
            batch += [(b"sh%05d" % i, None) for i in range(1, n, 11)]
        before = dict(cl.LAUNCHES)
        card.apply(batch)
        card.flush_pending()
        delta = {name: cl.LAUNCHES[name] - before[name] for name in before}
        if round_ != 2 and card._capacity >= 8:
            owners = len(set(card._positions(keys) // (card._capacity // 4)))
            assert delta == _launches(node_level=2, path_rehash=owners)
        one.apply(batch)
        assert card.root_hex() == one.root_hex()
        for level, m in enumerate(card.ref_level_sizes(card.leaf_count())):
            assert card.level_nodes(level, 0, m) == one.level_nodes(level, 0, m)
    for a, b in zip(card.to_numpy_levels(), one.to_numpy_levels()):
        np.testing.assert_array_equal(a, b)


PATH_C = 4096


def _zipf(rng, c, k):
    """Up to k positions drawn Zipf-skewed over the leaf index: dense at the
    left end, sparse to the right."""
    return sorted(set((np.minimum(rng.zipf(1.2, size=k), c) - 1).tolist()))


PATH_CASES = {
    "k1": lambda rng: [1234],
    "sibling_pair": lambda rng: [100, 101],
    "first_and_last": lambda rng: [0, PATH_C - 1],
    "one_subtree": lambda rng: list(range(1024, 1536)),
    "every_leaf": lambda rng: list(range(PATH_C)),
    "random_257": lambda rng: sorted(rng.choice(PATH_C, size=257, replace=False)),
    "zipf": lambda rng: _zipf(rng, PATH_C, 2000),
    "one_per_256_leaf_subtree": lambda rng: [256 * j + rng.randint(256) for j in range(16)],
    "one_per_16_leaf_subtree": lambda rng: [16 * j + rng.randint(16) for j in range(256)],
}
# (chunk width, top-level width): the kernel's own, and narrow ones that cut
# a small batch into many blocks with shared nodes below the top.
PATH_SHAPES = [(64, 128), (2, 2), (4, 16)]


def _rehash_both(dev, levels, pos, rng):
    """One launch on ``levels`` and the plain version on a copy: every
    level bit for bit, one launch counted, the scratch zero again."""
    ref = [lv.clone() for lv in levels]
    k = len(pos)
    blocks = _words(int(rng.randint(1 << 30)), (k, 2, 16), dev)
    nblocks = torch.from_numpy(rng.randint(0, 3, size=k).astype(np.int32)).to(dev)
    scratch = mp.path_scratch(levels[0].shape[0], dev)
    before = cl.LAUNCHES["path_rehash"]
    mp.path_rehash_cuda(levels, scratch, blocks, nblocks, pos)
    assert cl.LAUNCHES["path_rehash"] == before + 1
    mp.path_rehash(ref, blocks, nblocks, pos)
    for lvl, (got, want) in enumerate(zip(levels, ref)):
        assert torch.equal(got, want), (list(pos)[:8], lvl)
    assert not scratch.any()


def _padded(msg: bytes) -> np.ndarray:
    """One SHA-256-padded message as [blocks, 16] uint32 words."""
    padded = msg + b"\x80" + b"\x00" * ((55 - len(msg)) % 64) + (8 * len(msg)).to_bytes(8, "big")
    return np.frombuffer(padded, ">u4").astype(np.uint32).reshape(-1, 16)


def _rehash_vs_hashlib(dev, c, masks, rng):
    """For each position mask of a c-leaf tree: one launch on the levels,
    every level against hashlib's tree over the new leaves, the scratch
    zero again."""
    leaves = [hashlib.sha256(rng.bytes(8)).digest() for _ in range(c)]
    rows = [np.stack([np.frombuffer(d, ">u4") for d in leaves]).astype(np.uint32)]
    while len(rows[-1]) > 1:
        cur = [r.astype(">u4").tobytes() for r in rows[-1]]
        rows.append(np.stack([np.frombuffer(hashlib.sha256(cur[i] + cur[i + 1]).digest(), ">u4")
                              for i in range(0, len(cur), 2)]).astype(np.uint32))
    levels = [torch.from_numpy(r.view(np.int32)).to(dev) for r in rows]
    scratch = mp.path_scratch(c, dev)
    for mask in masks:
        pos = np.array([i for i in range(c) if int(mask) >> i & 1], np.int64)
        msgs = [rng.bytes(int(rng.randint(0, 120))) for _ in pos]
        blocks = np.zeros((len(pos), 2, 16), np.uint32)
        nblocks = np.zeros(len(pos), np.int32)
        for i, m in enumerate(msgs):
            w = _padded(m)
            blocks[i, : len(w)] = w
            nblocks[i] = len(w)
            leaves[pos[i]] = hashlib.sha256(m).digest()
        mp.path_rehash_cuda(levels, scratch, torch.from_numpy(blocks.view(np.int32)).to(dev),
                            torch.from_numpy(nblocks).to(dev), pos)
        want = leaves
        for lvl, got in enumerate(levels):
            assert plain.digests_to_bytes(got.cpu().numpy().view(np.uint32)) == want, (mask, lvl)
            want = [hashlib.sha256(want[i] + want[i + 1]).digest() for i in range(0, len(want) - 1, 2)]
        assert not scratch.any()


@pytest.mark.parametrize("shape", PATH_SHAPES)
@pytest.mark.parametrize("case", sorted(PATH_CASES) + [f"every_subset_depth_{d}" for d in range(1, 7)])
def test_path_rehash_kernel_matches_plain(dev, case, shape, monkeypatch):
    """The path-rehash kernel at the kernel's chunk width and top and at
    narrow ones. On 4096 leaves: one launch on the levels, the plain version
    on a copy, every level bit for bit. On the small trees of 2 to 64
    leaves: every position subset up to 8 leaves and 300 random ones above,
    each against hashlib's tree. The scratch is zero again after each."""
    monkeypatch.setattr(mp, "PATH_WIDTH", shape[0])
    monkeypatch.setattr(mp, "PATH_TOP_NODES", shape[1])
    rng = np.random.RandomState(sorted(PATH_CASES).index(case) if case in PATH_CASES else 99)
    if case in PATH_CASES:
        levels = dispatch.build_levels(_words(1, (PATH_C, 8), dev))
        _rehash_both(dev, levels, np.asarray(PATH_CASES[case](rng), np.int64), rng)
        return
    c = 1 << int(case.rsplit("_", 1)[1])
    masks = range(1, 1 << c) if c <= 8 else [
        (int(x) & ((1 << c) - 1)) or 1 for x in rng.randint(1, 1 << 62, size=300)]
    _rehash_vs_hashlib(dev, c, masks, rng)


def test_promotion_chain_kernel_matches_plain(dev):
    levels = dispatch.build_levels(_words(3, (PATH_C, 8), dev))
    for n in (1, 2, 3, PATH_C // 2 + 1, 3000, PATH_C):
        before = cl.LAUNCHES["promotion_chain"]
        got = mp.promotion_chain_cuda(levels, n)
        assert cl.LAUNCHES["promotion_chain"] == before + 1
        assert torch.equal(got, mp.promotion_chain(levels, n)), n


@pytest.mark.parametrize("d,nblk", [(0, 0), (12, 0), (21, 0), (20, 1), (3, 2)])
def test_hash_chain_kernel_matches_plain(dev, d, nblk):
    inp = _words(d + nblk, (32, 16), dev)
    got, cycles, ns = mp.hash_chain_cuda(inp, d, nblk)
    assert torch.equal(got, mp.hash_chain(inp, d, nblk))
    assert cycles >= 0 and ns >= 0


def test_value_batch_is_one_fused_launch(dev):
    items = {b"sk%04d" % i: b"v%d" % i for i in range(300)}
    card = DeviceMerkleState.from_items(items.items())
    cpu = DeviceMerkleState.from_items(items.items(), device="cpu")
    batch = [(b"sk%04d" % i, b"w%d" % i) for i in (0, 1, 7, 150, 299)]
    before, ks = dict(cl.LAUNCHES), mp.PATH_KS.copy()
    card.apply(batch)
    card.flush_pending()
    delta = {name: cl.LAUNCHES[name] - before[name] for name in before}
    assert delta == _launches(path_rehash=1)
    assert mp.PATH_KS - ks == {len(batch): 1}
    cpu.apply(batch)
    assert card.root_hex() == cpu.root_hex()
    assert cl.LAUNCHES["promotion_chain"] == before["promotion_chain"] + 1


@pytest.mark.parametrize("via", ["thread", "guard"])
def test_launches_from_a_fresh_thread_match_plain(dev, via):
    """The serving mirror dispatches every device call on a new thread (the
    guard's): a value batch and a root read launched there must match the
    plain versions bit for bit."""
    items = {b"tk%04d" % i: b"v%d" % i for i in range(1000)}
    card = DeviceMerkleState.from_items(items.items())
    cpu = DeviceMerkleState.from_items(items.items(), device="cpu")
    batch = [(b"tk%04d" % i, b"w%d" % i) for i in range(0, 1000, 7)]
    before = dict(cl.LAUNCHES)
    out, names = {}, []

    def body():
        names.append(threading.current_thread().name)
        card.apply(batch)
        card.flush_pending()
        out["root"] = card.root_hex()

    if via == "thread":
        t = threading.Thread(target=body, name="fresh")
        t.start()
        t.join(60)
        assert not t.is_alive()
    else:
        DispatchGuard(deadline_ms=60_000).run("scatter", body)
    assert names and names[0] != threading.main_thread().name
    assert cl.LAUNCHES["path_rehash"] == before["path_rehash"] + 1
    assert cl.LAUNCHES["promotion_chain"] == before["promotion_chain"] + 1
    cpu.apply(batch)
    assert out["root"] == cpu.root_hex()
    for a, b in zip(card.to_numpy_levels(), cpu.to_numpy_levels()):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ the node

def _node(monkeypatch, **anti_entropy):
    """A node started as ``python -m merklekv_tpu_torch`` starts it, on the
    card (``MERKLEKV_TORCH_DEVICE`` unset means CUDA), with replication on
    the in-process bus so it serves from its mirror."""
    from merklekv_tpu_torch.__main__ import start
    from merklekv_tpu_torch.config import Config

    monkeypatch.delenv("MERKLEKV_TORCH_DEVICE", raising=False)
    cfg = Config()
    cfg.port = 0
    cfg.replication.enabled = True
    cfg.replication.mqtt_broker = "local"
    cfg.replication.topic_prefix = f"cuda-{id(cfg)}"
    for k, v in anti_entropy.items():
        setattr(cfg.anti_entropy, k, v)
    return start(cfg)


def _client(run):
    from merklekv_tpu_torch.client import MerkleKVClient

    return MerkleKVClient("127.0.0.1", run.port, timeout=120).connect()


def _serves_from_mirror(c) -> bool:
    import time

    end = time.monotonic() + 120
    while time.monotonic() < end:
        c.hash()
        if c.metrics().get("device.backend_level") == "1":
            return True
        time.sleep(0.05)
    return False


def test_node_serves_the_golden_root_from_the_card(dev, monkeypatch):
    from merklekv_tpu_torch.merkle.cpu_state import CpuMerkleState

    run = _node(monkeypatch)
    try:
        c = _client(run)
        items = {b"n%05d" % i: b"v%d" % i for i in range(5000)}
        c.mset({k.decode(): v.decode() for k, v in items.items()})
        cl.reset_launch_counts()
        assert _serves_from_mirror(c)
        assert cl.LAUNCHES["leaf"] >= 1 and cl.LAUNCHES["node_level"] >= 1
        golden = CpuMerkleState.from_items(items.items())
        assert c.hash(force=True) == golden.root_hex()
        c.set("n00007", "changed")
        golden.apply([(b"n00007", b"changed")])
        assert c.hash(force=True) == golden.root_hex()
        assert cl.LAUNCHES["path_rehash"] >= 1 and cl.LAUNCHES["promotion_chain"] >= 1
        rows, n = c.tree_level(1, 0, 4)
        assert n == 5000 and [(i, bytes.fromhex(h)) for i, h in rows] == golden.level_nodes(1, 0, 4)[0]
        c.close()
    finally:
        run.close()


def test_node_sync_runs_its_leaf_pass_on_the_card(dev, monkeypatch):
    a = _node(monkeypatch, engine="tpu")
    b = _node(monkeypatch, engine="tpu")
    try:
        ca, cb = _client(a), _client(b)
        ca.mset({f"s{i:05d}": f"v{i}" for i in range(3000)})
        cb.mset({f"s{i:05d}": f"w{i}" for i in range(0, 3000, 5)})
        fallbacks = int(cb.metrics().get("device.fallbacks", 0))  # the process's registry
        cl.reset_launch_counts()
        assert cb.sync_with("127.0.0.1", a.port)
        assert cl.LAUNCHES["leaf_ragged"] >= 1
        assert b.engine.snapshot() == a.engine.snapshot()
        assert cb.hash(force=True) == ca.hash(force=True)
        assert int(cb.metrics().get("device.fallbacks", 0)) == fallbacks
        ca.close()
        cb.close()
    finally:
        b.close()
        a.close()


def test_snapshot_root_runs_the_kernels_on_the_card(dev, monkeypatch):
    """``[storage]``'s snapshot root on the node's device: the ragged leaf
    and level kernels launch, and the root equals the host hashlib chain."""
    from merklekv_tpu_torch.storage import snapshot as snapmod

    monkeypatch.setenv("MERKLEKV_TORCH_DEVICE", "cuda")
    items = [(b"inc:%09d" % i, b"v%d" % i) for i in range(5000)]
    cl.reset_launch_counts()
    got = snapmod.compute_root_hex(items, engine="auto")
    assert cl.LAUNCHES["leaf_ragged"] == 1 and cl.LAUNCHES["node_level"] >= 1
    assert got == snapmod.compute_root_hex(items, engine="cpu")


def test_two_ranks_sharing_cuda0_over_gloo(dev):
    """``tests/torch_multihost_worker.py`` as two ranks on ``cuda:0``, each
    seeing that card alone: NCCL refuses two ranks on one card, so they
    name gloo."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    from merklekv_tpu_torch.merkle.cpu import build_levels
    from merklekv_tpu_torch.merkle.encoding import leaf_hash

    root_dir = Path(__file__).resolve().parents[1]
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs = []
    try:
        for rank in range(2):
            env = dict(os.environ, PYTHONPATH=str(root_dir), MKV_COORDINATOR=f"127.0.0.1:{port}",
                       MKV_NUM_PROCESSES="2", MKV_PROCESS_ID=str(rank),
                       MERKLEKV_TORCH_DEVICE="cuda:0", CUDA_VISIBLE_DEVICES="0")
            procs.append(subprocess.Popen(
                [sys.executable, str(root_dir / "tests" / "torch_multihost_worker.py"),
                 "64", "3", "5", "1", "gloo"],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    keys = [b"mh:%05d" % i for i in range(64)]
    golden = build_levels([leaf_hash(k, b"val-%d" % i) for i, k in enumerate(keys)])[-1][0].hex()
    for out in outs:
        assert f"ROOT {golden}" in out and "COUNTS 0,5,0" in out and "MASKS ok" in out


def test_device_profile_traces_the_kernels(dev, tmp_path):
    """``utils.device_profile`` records the card's kernels: a build and a
    value batch with a root read, its TensorBoard trace parsed."""
    items = [(b"p%05d" % i, b"v%d" % i) for i in range(1000)]
    with device_profile(str(tmp_path)):
        st = DeviceMerkleState.from_items(items, device=dev)
        st.apply([(b"p00001", b"changed")])
        root = st.root_hex()
        torch.cuda.synchronize()
    items[1] = (b"p00001", b"changed")
    assert root == CpuMerkleState.from_items(items).root_hex()
    (trace,) = tmp_path.glob("*.pt.trace.json")
    names = [ev.get("name", "") for ev in json.loads(trace.read_text())["traceEvents"]
             if ev.get("cat") == "kernel"]
    for kernel in ("leaf_kernel", "node_level_kernel", "path_rehash_kernel",
                   "promotion_chain_kernel"):
        assert any(kernel in n for n in names), (kernel, sorted(set(names))[:20])


def test_device_spans_time_the_cycle_on_the_card(dev, tmp_path):
    """Under ``device_profile`` on the calling thread, each cycle's
    ``ae.*`` spans get device times from their CUDA events (the phases
    inside the cycle's: the diff on its side stream, the others in turn on
    the current one), the second cycle the gap after the first, and the
    trace holds them as ``gpu_user_annotation`` ranges."""
    from merklekv_tpu_torch.utils import tracing

    n, r = 4099, 3
    blocks = _words(21, (n, 3, 16), dev)
    nblocks = torch.full((n,), 3, dtype=torch.int32, device=dev)
    digests = _words(22, (1, n, 8), dev).repeat(r, 1, 1)
    digests[1, 7, 0] ^= 1
    present = torch.ones((r, n), dtype=torch.bool, device=dev)
    want = te.anti_entropy_forward(blocks, nblocks, digests, present, device=dev)
    tracing.clear_device_spans()
    try:
        with device_profile(str(tmp_path)):
            for _ in range(2):
                got = te.anti_entropy_forward(blocks, nblocks, digests, present, device=dev)
                got[0].cpu()
        torch.cuda.synchronize()
        recs = tracing.device_spans()
    finally:
        tracing.clear_device_spans()
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    phases = ["ae.leaf", "ae.diff", "ae.levels", "ae.diff_wait"]
    assert [s["name"] for s in recs] == ["ae.cycle", *phases] * 2
    for cyc in (recs[:5], recs[5:]):
        by = {s["name"]: s for s in cyc}
        assert all(s["device"] == 0 and s["device_ms"] >= 0 for s in cyc)
        assert all(by[name]["device_ms"] > 0
                   for name in ("ae.cycle", "ae.diff", "ae.leaf", "ae.levels"))
        # The leaf hash, the levels and the wait run in turn on the current
        # stream; the diff beside them, on its own.
        in_turn = sum(by[name]["device_ms"] for name in ("ae.leaf", "ae.levels", "ae.diff_wait"))
        assert in_turn <= by["ae.cycle"]["device_ms"] * 1.001
        assert by["ae.diff"]["device_ms"] <= by["ae.cycle"]["device_ms"] * 1.001
    assert recs[0]["between_ms"] is None and recs[5]["between_ms"] >= 0
    (trace,) = tmp_path.glob("*.pt.trace.json")
    names = {ev.get("name") for ev in json.loads(trace.read_text())["traceEvents"]
             if ev.get("cat") == "gpu_user_annotation"}
    assert {"ae.leaf", "ae.levels", "ae.diff"} <= names, sorted(names)


# ------------------------------------------------------------ the N-replica diff

def _replicas(seed, r, m):
    """[r, m, 8] uint32 digests and [r, m] bool presence: replica 0's random
    digests in every replica, then in each replica r >= 1 keys that differ
    in one word (each of the 8; bit 31 in the odd words), keys absent from
    it alone and from both it and replica 0; and keys absent from replica 0
    alone."""
    rng = np.random.default_rng(seed)
    some = max(1, m // 40)
    dig = np.repeat(rng.integers(0, 2**32, size=(1, m, 8), dtype=np.uint64).astype(np.uint32),
                    r, axis=0)
    pres = np.ones((r, m), bool)
    for ri in range(1, r):
        for w in range(8):
            bit = 31 if w % 2 else int(rng.integers(0, 31))
            dig[ri, rng.integers(0, m, size=some), w] ^= np.uint32(1 << bit)
        pres[ri, rng.integers(0, m, size=some)] = False
        both = rng.integers(0, m, size=some)
        pres[ri, both] = False
        pres[0, both] = False
    pres[0, rng.integers(0, m, size=some)] = False
    return dig, pres


def _check_diff(dig_np, pres_np, masks, counts):
    want = tdiff.divergence_masks_np(dig_np, pres_np)
    np.testing.assert_array_equal(masks.cpu().numpy(), want)
    np.testing.assert_array_equal(counts.cpu().numpy(), want.sum(axis=1, dtype=np.int32))
    plain_m, plain_c = dc.divergence_plain(torch.from_numpy(dig_np.view(np.int32)),
                                           torch.from_numpy(pres_np))
    assert torch.equal(masks.cpu(), plain_m) and torch.equal(counts.cpu(), plain_c)


# ("grid", o): 8192 keys an SM (2048 threads of 4 keys), more than one
# launch's grid covers in one pass at any occupancy, plus o.
DIFF_KEYS = [1, 31, 32, 33, 4096, 4097, ("grid", 12344), ("grid", 12345)]


@pytest.mark.parametrize("r", [1, 2, 3, 8])
@pytest.mark.parametrize("n", DIFF_KEYS, ids=str)
def test_diff_kernel_matches_plain(dev, r, n):
    if isinstance(n, tuple):
        n = 8192 * torch.cuda.get_device_properties(dev).multi_processor_count + n[1]
    dig, pres = _replicas(7 * r + n, r, n)
    before = cl.LAUNCHES["diff"]
    masks, counts = dc.divergence_cuda(torch.from_numpy(dig.view(np.int32)).to(dev),
                                       torch.from_numpy(pres).to(dev))
    assert cl.LAUNCHES["diff"] == before + 1
    assert masks.device == dev and counts.dtype == torch.int32
    _check_diff(dig, pres, masks, counts)


# (first key, keys, keys after): presence rows misaligned for word loads
# and ragged, aligned, and a long ragged slice.
@pytest.mark.parametrize("start,n,after", [(1, 33, 2), (3, 4097, 0), (128, 4096, 0),
                                           (5, 100_003, 11)])
def test_diff_kernel_on_a_key_slice(dev, start, n, after):
    dig, pres = _replicas(start + n, 8, start + n + after)
    d = torch.from_numpy(dig.view(np.int32)).to(dev)[:, start:start + n]
    p = torch.from_numpy(pres).to(dev)[:, start:start + n]
    assert d.stride(0) != 8 * n and not d.is_contiguous()
    masks, counts = dc.divergence_cuda(d, p)
    _check_diff(dig[:, start:start + n].copy(), pres[:, start:start + n].copy(), masks, counts)


def test_diff_kernel_copies_a_layout_it_cannot_read(dev):
    dig, pres = _replicas(3, 3, 1000)
    d = torch.from_numpy(dig.view(np.int32).transpose(0, 2, 1).copy()).to(dev).transpose(1, 2)
    p = torch.from_numpy(pres.T.copy()).to(dev).T
    masks, counts = dc.divergence_cuda(d, p)
    _check_diff(dig, pres, masks, counts)


def test_diff_kernel_finds_one_word_in_each_position(dev):
    dig = np.zeros((2, 17, 8), np.uint32)
    dig[:] = np.arange(17 * 8, dtype=np.uint32).reshape(17, 8) * np.uint32(0x9E3779B1)
    for w in range(8):
        dig[1, 2 * w, w] ^= np.uint32(1 << 31)
        dig[1, 2 * w + 1, w] ^= np.uint32(1)
    masks, counts = dc.divergence_cuda(torch.from_numpy(dig.view(np.int32)).to(dev),
                                       torch.ones((2, 17), dtype=torch.bool, device=dev))
    assert masks[1].tolist() == [True] * 16 + [False] and not masks[0].any()
    assert counts.tolist() == [0, 16]


def test_diff_empty_inputs_launch_nothing(dev):
    before = cl.LAUNCHES["diff"]
    for r, n in ((3, 0), (0, 5)):
        masks, counts = dc.divergence_cuda(torch.zeros((r, n, 8), dtype=torch.int32, device=dev),
                                           torch.zeros((r, n), dtype=torch.bool, device=dev))
        assert masks.shape == (r, n) and counts.tolist() == [0] * r
    assert cl.LAUNCHES["diff"] == before


def test_diff_wrapper_rejects_bad_tensors(dev):
    d = torch.zeros((2, 4, 8), dtype=torch.int32, device=dev)
    p = torch.ones((2, 4), dtype=torch.bool, device=dev)
    with pytest.raises(TypeError):
        dc.divergence_cuda(d.to(torch.int64), p)
    with pytest.raises(TypeError):
        dc.divergence_cuda(d, p.to(torch.uint8))
    with pytest.raises(ValueError):
        dc.divergence_cuda(d[:, :, :4], p)
    with pytest.raises(ValueError):
        dc.divergence_cuda(d, p[:, :3])
    with pytest.raises(ValueError):
        dc.divergence_cuda(d, p.cpu())


def test_anti_entropy_forward_launches_the_diff_once_a_cycle(dev):
    n, r = 4099, 8
    blocks = _words(31, (n, 2, 16), dev)
    nblocks = torch.full((n,), 2, dtype=torch.int32, device=dev)
    dig, pres = _replicas(32, r, n)
    digests, present = torch.from_numpy(dig.view(np.int32)).to(dev), torch.from_numpy(pres).to(dev)
    before = cl.LAUNCHES["diff"]
    for cycle in range(3):
        _root, masks, counts = te.anti_entropy_forward(blocks, nblocks, digests, present,
                                                       device=dev)
        assert cl.LAUNCHES["diff"] == before + cycle + 1
    _check_diff(dig, pres, masks, counts)


def test_sharded_diff_reads_each_shards_slice(dev):
    from merklekv_tpu_torch.parallel import sharded_merkle
    from merklekv_tpu_torch.parallel.mesh import make_mesh

    dig, pres = _replicas(41, 3, 4 * 1027)
    mesh = make_mesh({"key": 4}, devices=[dev] * 4)
    before = cl.LAUNCHES["diff"]
    masks, counts = sharded_merkle.sharded_divergence(
        mesh, torch.from_numpy(dig.view(np.int32)).to(dev), torch.from_numpy(pres).to(dev))
    assert cl.LAUNCHES["diff"] == before + 4
    _check_diff(dig, pres, masks, counts)


# ------------------------------------------------------------ the key-mesh step

def _mesh_devices(dev, layout):
    if layout == "one_card":
        return [dev] * 4
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("needs two or more CUDA cards")
    return [torch.device("cuda", i) for i in range(count)]


@pytest.mark.parametrize("layout", ["one_card", "every_card"])
def test_mesh_steps_back_to_back_without_a_host_sync(dev, layout, monkeypatch):
    """Three key-mesh steps queued back to back, the inputs salted in place
    before each and no host sync between them; each step's answers are
    copied at once on the first card. Every step's root, masks and counts
    equal the single-device cycle's on the same salted inputs. Over
    distinct cards the masks cross by the copy engines on side streams;
    here a spin kernel (``torch.cuda._sleep``) holds each copy back on its
    stream, so the copies end well after all else a step queues. Without
    the first card's wait for them a step's masks are copied out before
    they are whole; without a source card's wait the next step's diff
    writes its masks where a copy has yet to read."""
    from merklekv_tpu_torch.parallel import sharded_merkle
    from merklekv_tpu_torch.parallel.mesh import make_mesh

    copy_columns = sharded_merkle.copy_columns

    def held_back(dst, col, src, stream):
        with torch.cuda.stream(stream):
            torch.cuda._sleep(20_000_000)  # about 10 ms at the card's clock
        copy_columns(dst, col, src, stream)

    monkeypatch.setattr(sharded_merkle, "copy_columns", held_back)
    devs = _mesh_devices(dev, layout)
    d, r, l = len(devs), 64, 3 << 16
    n = d * l
    blocks = _words(51, (n, 1, 16), dev)
    nblocks = torch.ones(n, dtype=torch.int32, device=dev)
    digests = _words(52, (1, n, 8), dev).repeat(r, 1, 1)
    present = torch.ones((r, n), dtype=torch.bool, device=dev)
    present[5, 7::1009] = False
    salts = [((k + 1) * 0x9E3779B1) & 0x7FFFFFFF for k in range(3)]
    keys = [torch.arange(k, n, 61, device=dev) for k in range(3)]

    def salt(k, blk, dig, idx):
        blk[idx, 0, 3] ^= salts[k]
        dig[1 + k, idx, k] ^= salts[k]

    want = []
    for k in range(3):
        salt(k, blocks, digests, keys[k])
        want.append(te.anti_entropy_forward(blocks, nblocks, digests, present, device=dev))
        salt(k, blocks, digests, keys[k])
    torch.cuda.synchronize(dev)

    def shards(t, dim):
        return [t.narrow(dim, s * l, l).to(devs[s], copy=True).contiguous() for s in range(d)]

    sh = [shards(blocks, 0), shards(nblocks, 0), shards(digests, 1), shards(present, 1)]
    local = [[(keys[k][(keys[k] >= s * l) & (keys[k] < (s + 1) * l)] - s * l).to(devs[s])
              for s in range(d)] for k in range(3)]
    for x in set(devs):
        torch.cuda.synchronize(x)
    step = sharded_merkle.make_anti_entropy_step(make_mesh({"key": d}, devices=devs))
    engines = sharded_merkle._copy_engines(devs)
    before = cl.LAUNCHES["copy_2d"]
    got = []
    for k in range(3):
        for s in range(d):
            if k:
                salt(k - 1, sh[0][s], sh[2][s], local[k - 1][s])
            salt(k, sh[0][s], sh[2][s], local[k][s])
        root, masks, counts = step(*sh)
        got.append((root.clone(), masks.clone(), counts.clone()))
    for x in set(devs):
        torch.cuda.synchronize(x)
    assert cl.LAUNCHES["copy_2d"] - before == (3 * d if engines else 0)
    for k, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g[0], w[0]), f"step {k}: root"
        assert torch.equal(g[2], w[2]), f"step {k}: counts"
        bad = (g[1] != w[1]).sum().item()
        assert bad == 0, f"step {k}: {bad} mask bytes differ"


# ------------------------------------------------------------ the diff beside the leaf hash

# Keys: one, a ragged tile, a ragged warp's grid stride, and past one full
# pass of either grid (the standalone's 2 blocks of 8 warps an SM, the
# co-resident's 1 of 4: csrc/diff_kernels.cuh; 128 keys a warp's tile) by a
# ragged count.
def _beside_keys(dev):
    grid_keys = torch.cuda.get_device_properties(dev).multi_processor_count * 16 * 128
    return [1, 33, 4097, 2 * grid_keys + 77]


def _step(layout, dev):
    """The step under test and its devices: the one-card forward, or the
    key-mesh step over four shards of one card or over every card."""
    from merklekv_tpu_torch.parallel import sharded_merkle
    from merklekv_tpu_torch.parallel.mesh import make_mesh

    if layout == "forward":
        return (lambda *a: te.anti_entropy_forward(*a, device=dev)), [dev]
    devs = _mesh_devices(dev, layout)
    return sharded_merkle.make_anti_entropy_step(make_mesh({"key": len(devs)}, devices=devs)), devs


def _cycle_inputs(seed, r, n, dev, nblk=2):
    blocks = _words(seed, (n, nblk, 16), dev)
    nblocks = torch.full((n,), nblk, dtype=torch.int32, device=dev)
    dig, pres = _replicas(seed + 1, r, n)
    return blocks, nblocks, torch.from_numpy(dig.view(np.int32)).to(dev), \
        torch.from_numpy(pres).to(dev)


def _overlapped():
    from merklekv_tpu_torch.utils.tracing import get_metrics

    return get_metrics().snapshot()["counters"].get("device.ae_diff_overlapped", 0)


@pytest.mark.parametrize("layout", ["forward", "one_card", "every_card"])
@pytest.mark.parametrize("r", [1, 2, 8, 64])
@pytest.mark.parametrize("k", range(4))
def test_overlapped_step_matches_serial_and_plain(dev, layout, r, k):
    """The step with its diff beside the leaf hash gives the root, masks
    and counts of the serial path (standalone kernels one after another on
    one stream) and of the plain versions on the CPU, bit for bit; each
    diff on a card counts once in ``device.ae_diff_overlapped``."""
    step, devs = _step(layout, dev)
    n = _beside_keys(dev)[k]
    n = -(-n // len(devs)) * len(devs)
    args = _cycle_inputs(100 * r + k, r, n, dev)
    before = _overlapped()
    root, masks, counts = step(*args)
    assert _overlapped() == before + len(devs)
    serial_masks, serial_counts = dispatch.divergence(args[2], args[3])
    serial_root = dispatch.build_levels(dispatch.hash_blocks(args[0], args[1]))[-1][0]
    plain = te.anti_entropy_forward(*(a.cpu() for a in args), device="cpu")
    for got, serial, cpu in zip((root, masks, counts), (serial_root, serial_masks, serial_counts),
                                plain):
        assert torch.equal(got.cpu(), serial.cpu()) and torch.equal(got.cpu(), cpu)


def _spin(ms=20):
    torch.cuda._sleep(int(ms * 2_000_000))  # about ms milliseconds at the card's clock


@pytest.mark.parametrize("layout", ["forward", "one_card", "every_card"])
def test_the_side_stream_waits_for_the_callers_writes(dev, layout):
    """A digest write queued on the caller's stream behind a spin kernel,
    before the step: the diff on the side stream sees it. Without the side
    stream's wait for the caller's stream the diff would run during the
    spin, on the digests as they were."""
    step, devs = _step(layout, dev)
    n = 4 * 4099
    blocks, nblocks, digests, present = _cycle_inputs(7, 3, n, dev)
    shards = [blocks, nblocks, digests, present]
    if layout != "forward":
        l = n // len(devs)
        shards = [[t.narrow(dim, s * l, l).to(devs[s]).contiguous() for s in range(len(devs))]
                  for t, dim in zip((blocks, nblocks, digests, present), (0, 0, 1, 1))]
    for x in set(devs):
        torch.cuda.synchronize(x)
    want = te.anti_entropy_forward(*(t.cpu() for t in (blocks, nblocks, digests, present)),
                                   device="cpu")
    same = ~want[1][2] & present[0].cpu() & present[2].cpu()
    key = int(torch.nonzero(same)[-1])  # present in both, equal: the write makes it diverge
    flipped = digests.clone()
    flipped[2, key, 7] ^= 1 << 30
    want_after = te.anti_entropy_forward(blocks.cpu(), nblocks.cpu(), flipped.cpu(),
                                         present.cpu(), device="cpu")
    assert not torch.equal(want[2], want_after[2])
    if layout == "forward":
        _spin()
        digests[2, key, 7] ^= 1 << 30
    else:
        s = key // (n // len(devs))
        with torch.cuda.device(devs[s]):
            _spin()
            shards[2][s][2, key - s * (n // len(devs)), 7] ^= 1 << 30
    root, masks, counts = step(*shards)
    assert torch.equal(counts.cpu(), want_after[2]) and torch.equal(masks.cpu(), want_after[1])
    assert torch.equal(root.cpu(), want_after[0])


@pytest.mark.parametrize("layout", ["forward", "one_card", "every_card"])
def test_results_and_copies_wait_for_the_diff(dev, layout, monkeypatch):
    """A spin kernel on the side stream ahead of each diff holds it back
    past all else a step queues. The counts and masks the step returns,
    read at once on the caller's stream, are whole: without the current
    stream's wait for the diff the counts (zeroed on the caller's stream)
    read 0, and without the mesh copies' wait for each card's diff the
    gathered masks are those of the previous step."""
    step, devs = _step(layout, dev)
    real = te.divergence_beside

    def held_back(*a):
        _spin()
        real(*a)

    n = 4 * 8191
    first = _cycle_inputs(61, 8, n, dev)
    step(*first)  # the masks' memory then holds this step's answer
    second = _cycle_inputs(62, 8, n, dev)
    want = te.anti_entropy_forward(*(a.cpu() for a in second), device="cpu")
    assert want[2].sum() > 0 and not torch.equal(want[1], dispatch.divergence(
        first[2], first[3])[0].cpu())
    monkeypatch.setattr(te, "divergence_beside", held_back)
    for x in set(devs):
        torch.cuda.synchronize(x)
    root, masks, counts = step(*second)
    got_counts, got_masks = counts.clone(), masks.clone()  # on the caller's stream
    assert torch.equal(got_counts.cpu(), want[2]), "the results did not wait for the diff"
    bad = (got_masks.cpu() != want[1]).sum().item()
    assert bad == 0, f"{bad} mask bytes read before the diff wrote them"
    assert torch.equal(root.cpu(), want[0])


def test_the_diff_runs_under_the_leaf_hash(dev, tmp_path):
    """At [8, 1M] keys of 17 blocks, with the caller's stream busy when
    each cycle is queued (a spin kernel ahead of it, so that both grids
    wait on the same work and not on the host's launches), the profiler's
    intervals put most of each diff kernel's interval under its cycle's
    leaf kernel's: the diff's few blocks an SM and the leaf hash's share
    the card."""
    from torch.profiler import ProfilerActivity, profile

    n, r = 1 << 20, 8
    blocks = torch.randint(-(2**31), 2**31 - 1, (n, 17, 16), dtype=torch.int32, device=dev)
    nblocks = torch.full((n,), 17, dtype=torch.int32, device=dev)
    digests = torch.randint(-(2**31), 2**31 - 1, (1, n, 8), dtype=torch.int32,
                            device=dev).repeat(r, 1, 1)
    digests[3, ::97, 2] ^= 1
    present = torch.ones((r, n), dtype=torch.bool, device=dev)
    te.anti_entropy_forward(blocks, nblocks, digests, present, device=dev)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            _spin(2)
            te.anti_entropy_forward(blocks, nblocks, digests, present, device=dev)[0].cpu()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    iv = {"diff_kernel": [], "leaf_kernel": []}
    for e in json.loads(path.read_text())["traceEvents"]:
        for name in iv:
            if e.get("cat") == "kernel" and name in e.get("name", ""):
                iv[name].append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    # Each diff with the leaf kernel that starts nearest it (the profiler
    # may drop a kernel's record).
    under = []
    for ds, de in iv["diff_kernel"]:
        ls, le = min(iv["leaf_kernel"], key=lambda x: abs(x[0] - ds))
        under.append(max(0.0, min(de, le) - max(ds, ls)) / (de - ds))
    assert len(under) >= 3 and sorted(under)[len(under) // 2] > 0.5, (under, iv)


# ------------------------------------------------------------ ragged leaves

def _ragged_records(case):
    """(keys, values) of each ragged case: ETC-like sizes (key sizes about
    36 bytes, value sizes a Pareto tail), messages ending on bytes 55 and 56
    of a block, empty values, a 1 MiB value, and a set whose longest leaf is
    over 3,000 blocks beside 60,000 short ones."""
    rng = np.random.default_rng(len(case))
    if case == "etc":
        n = 20_000
        vl = np.floor(214.476 / 0.348238 * ((1 - (np.arange(n) + 0.5) / n) ** -0.348238 - 1))
        keys = [b"e%09d" % i + b"k" * int(rng.integers(0, 40)) for i in range(n)]
        return keys, [bytes(rng.integers(0, 256, int(v), dtype=np.uint8)) for v in rng.permutation(vl)]
    if case == "tails":
        keys = [b"t%03d" % i for i in range(64)]
        return keys, [b"v" * (64 * (i % 3) + 55 + i % 2 - 8 - len(k)) for i, k in enumerate(keys)]
    if case == "empty_value":
        return [b"a", b"bb", b"k" * 300], [b"", b"", b""]
    if case == "one_mib":
        return [b"big", b"small"], [bytes(range(256)) * 4096, b"x"]
    keys = [b"c%06d" % i for i in range(60_001)]
    values = [b"s" * int(rng.integers(0, 200)) for _ in keys]
    values[777] = bytes(rng.integers(0, 256, 200_000, dtype=np.uint8))
    return keys, values


def _leaf_golden(keys, values):
    return [hashlib.sha256(len(k).to_bytes(4, "big") + k + len(v).to_bytes(4, "big") + v).digest()
            for k, v in zip(keys, values)]


@pytest.mark.parametrize("case", ["etc", "tails", "empty_value", "one_mib", "long_chain"])
def test_ragged_kernel_matches_hashlib(dev, case):
    """One launch a hash; the rows come back in key order; the next reader on
    the stream sees every chain's digest (it waits for the chain kernel)."""
    keys, values = _ragged_records(case)
    leaves = ragged.RaggedLeaves.pack(keys, values, dev)
    if case == "long_chain":
        assert leaves.longest > 3000 and leaves.chained >= 32 and leaves.chained % 32 == 0
    before = cl.LAUNCHES["leaf_ragged"]
    got = dispatch.hash_ragged(leaves)
    assert cl.LAUNCHES["leaf_ragged"] == before + 1
    assert plain.digests_to_bytes(got.cpu().numpy().view(np.uint32)) == _leaf_golden(keys, values)


def test_ragged_schedule_fills_the_lanes(dev):
    """The set made on the card has the CPU set's order and counts, at least
    90% of its lane slots compress, and its long groups run as chains."""
    keys, values = _ragged_records("etc")
    on_card = ragged.RaggedLeaves.pack(keys, values, dev)
    on_cpu = ragged.RaggedLeaves.pack(keys, values, "cpu")
    assert torch.equal(on_card.order.cpu(), on_cpu.order)
    assert (on_card.total_blocks, on_card.lane_slots) == (on_cpu.total_blocks, on_cpu.lane_slots)
    assert on_card.total_blocks / on_card.lane_slots >= 0.9
    assert on_card.chained > 0 and on_cpu.chained == 0
    assert torch.equal(dispatch.hash_ragged(on_card).cpu(), dispatch.hash_ragged(on_cpu))


def test_ragged_wrapper_takes_the_whole_order_only(dev):
    """An order of fewer or more positions than leaves is refused before any
    launch: every row of the result is a digest."""
    leaves = ragged.RaggedLeaves.pack([b"a", b"b", b"c"], [b"", b"x", b"y" * 100], dev)
    before = dict(cl.LAUNCHES)
    for order in (leaves.order[:2], torch.cat([leaves.order, leaves.order[:1]])):
        with pytest.raises(ValueError, match="positions for 3 leaves"):
            sc.leaf_ragged_cuda(leaves.blocks, leaves.offsets, order.contiguous(),
                                leaves.chained)
    assert cl.LAUNCHES == before


def test_ragged_empty_set_launches_nothing(dev):
    leaves = ragged.RaggedLeaves.pack([], [], dev)
    before = dict(cl.LAUNCHES)
    assert dispatch.hash_ragged(leaves).shape == (0, 8)
    assert cl.LAUNCHES == before


def test_ragged_engine_on_card_matches_cpu(dev):
    keys, values = _ragged_records("long_chain")
    rng = np.random.default_rng(1)
    digests = torch.from_numpy(rng.integers(0, 2**32, (4, len(keys), 8), dtype=np.uint64)
                               .astype(np.uint32).view(np.int32))
    digests[1:] = digests[0]
    digests[2, 5, 3] ^= 1
    present = torch.ones((4, len(keys)), dtype=torch.bool)
    present[3, 9] = False
    want = te.anti_entropy_forward(ragged.RaggedLeaves.pack(keys, values, "cpu"), None,
                                   digests, present, device="cpu")
    got = te.anti_entropy_forward(ragged.RaggedLeaves.pack(keys, values, dev), None,
                                  digests.to(dev), present.to(dev), device=dev)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
