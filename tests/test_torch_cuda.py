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
from merklekv_tpu_torch.merkle import torch_engine as te
from merklekv_tpu_torch.merkle.cpu_state import CpuMerkleState
from merklekv_tpu_torch.merkle.incremental import DeviceMerkleState, _reduce_levels
from merklekv_tpu_torch.ops import diff_cuda as dc
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
    before = sc.LAUNCHES["node_pairs"]
    got = sc.node_pairs_cuda(left, right)
    assert sc.LAUNCHES["node_pairs"] == before + 1
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


def test_launch_counts_and_empty_inputs(dev):
    sc.reset_launch_counts()
    e8 = torch.empty((0, 8), dtype=torch.int32, device=dev)
    assert sc.leaf_digests_cuda(torch.empty((0, 1, 16), dtype=torch.int32, device=dev),
                                torch.empty(0, dtype=torch.int32, device=dev)).shape == (0, 8)
    one_row = torch.zeros((1, 8), dtype=torch.int32, device=dev)
    assert sc.node_level_cuda(one_row).shape == (0, 8)
    assert sc.node_pairs_cuda(e8, e8).shape == (0, 8)
    assert set(sc.LAUNCHES.values()) == {0}
    x = _words(1, (4, 8), dev)
    sc.node_level_cuda(x)
    sc.node_pairs_cuda(x, x)
    sc.leaf_digests_cuda(_words(2, (4, 1, 16), dev), torch.ones(4, dtype=torch.int32, device=dev))
    assert sc.LAUNCHES == {"leaf": 1, "node_level": 1, "node_pairs": 1,
                           "path_rehash": 0, "promotion_chain": 0, "diff": 0}


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
        before = dict(sc.LAUNCHES)
        card.apply(batch)
        card.flush_pending()
        delta = {name: sc.LAUNCHES[name] - before[name] for name in before}
        if round_ != 2 and card._capacity >= 8:
            owners = len(set(card._positions(keys) // (card._capacity // 4)))
            assert delta == {"leaf": 0, "node_level": 2, "node_pairs": 0,
                             "path_rehash": owners, "promotion_chain": 0, "diff": 0}
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
    before = sc.LAUNCHES["path_rehash"]
    mp.path_rehash_cuda(levels, scratch, blocks, nblocks, pos)
    assert sc.LAUNCHES["path_rehash"] == before + 1
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
        levels = _reduce_levels(_words(1, (PATH_C, 8), dev))
        _rehash_both(dev, levels, np.asarray(PATH_CASES[case](rng), np.int64), rng)
        return
    c = 1 << int(case.rsplit("_", 1)[1])
    masks = range(1, 1 << c) if c <= 8 else [
        (int(x) & ((1 << c) - 1)) or 1 for x in rng.randint(1, 1 << 62, size=300)]
    _rehash_vs_hashlib(dev, c, masks, rng)


def test_promotion_chain_kernel_matches_plain(dev):
    levels = _reduce_levels(_words(3, (PATH_C, 8), dev))
    for n in (1, 2, 3, PATH_C // 2 + 1, 3000, PATH_C):
        before = sc.LAUNCHES["promotion_chain"]
        got = mp.promotion_chain_cuda(levels, n)
        assert sc.LAUNCHES["promotion_chain"] == before + 1
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
    before, ks = dict(sc.LAUNCHES), mp.PATH_KS.copy()
    card.apply(batch)
    card.flush_pending()
    delta = {name: sc.LAUNCHES[name] - before[name] for name in before}
    assert delta == {"leaf": 0, "node_level": 0, "node_pairs": 0,
                     "path_rehash": 1, "promotion_chain": 0, "diff": 0}
    assert mp.PATH_KS - ks == {len(batch): 1}
    cpu.apply(batch)
    assert card.root_hex() == cpu.root_hex()
    assert sc.LAUNCHES["promotion_chain"] == before["promotion_chain"] + 1


@pytest.mark.parametrize("via", ["thread", "guard"])
def test_launches_from_a_fresh_thread_match_plain(dev, via):
    """The serving mirror dispatches every device call on a new thread (the
    guard's): a value batch and a root read launched there must match the
    plain versions bit for bit."""
    items = {b"tk%04d" % i: b"v%d" % i for i in range(1000)}
    card = DeviceMerkleState.from_items(items.items())
    cpu = DeviceMerkleState.from_items(items.items(), device="cpu")
    batch = [(b"tk%04d" % i, b"w%d" % i) for i in range(0, 1000, 7)]
    before = dict(sc.LAUNCHES)
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
    assert sc.LAUNCHES["path_rehash"] == before["path_rehash"] + 1
    assert sc.LAUNCHES["promotion_chain"] == before["promotion_chain"] + 1
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
        sc.reset_launch_counts()
        assert _serves_from_mirror(c)
        assert sc.LAUNCHES["leaf"] >= 1 and sc.LAUNCHES["node_level"] >= 1
        golden = CpuMerkleState.from_items(items.items())
        assert c.hash(force=True) == golden.root_hex()
        c.set("n00007", "changed")
        golden.apply([(b"n00007", b"changed")])
        assert c.hash(force=True) == golden.root_hex()
        assert sc.LAUNCHES["path_rehash"] >= 1 and sc.LAUNCHES["promotion_chain"] >= 1
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
        sc.reset_launch_counts()
        assert cb.sync_with("127.0.0.1", a.port)
        assert sc.LAUNCHES["leaf"] >= 1
        assert b.engine.snapshot() == a.engine.snapshot()
        assert cb.hash(force=True) == ca.hash(force=True)
        assert int(cb.metrics().get("device.fallbacks", 0)) == fallbacks
        ca.close()
        cb.close()
    finally:
        b.close()
        a.close()


def test_snapshot_root_runs_the_kernels_on_the_card(dev, monkeypatch):
    """``[storage]``'s snapshot root on the node's device: the leaf and
    level kernels launch, and the root equals the host hashlib chain."""
    from merklekv_tpu_torch.storage import snapshot as snapmod

    monkeypatch.setenv("MERKLEKV_TORCH_DEVICE", "cuda")
    items = [(b"inc:%09d" % i, b"v%d" % i) for i in range(5000)]
    sc.reset_launch_counts()
    got = snapmod.compute_root_hex(items, engine="auto")
    assert sc.LAUNCHES["leaf"] == 1 and sc.LAUNCHES["node_level"] >= 1
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
    inside the cycle's), the second cycle the gap after the first, and
    the trace holds them as ``gpu_user_annotation`` ranges."""
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
    assert [s["name"] for s in recs] == ["ae.cycle", "ae.leaf", "ae.levels", "ae.diff"] * 2
    for cyc in (recs[:4], recs[4:]):
        assert all(s["device"] == 0 and s["device_ms"] > 0 for s in cyc)
        assert sum(s["device_ms"] for s in cyc[1:]) <= cyc[0]["device_ms"] * 1.001
    assert recs[0]["between_ms"] is None and recs[4]["between_ms"] >= 0
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
    before = sc.LAUNCHES["diff"]
    masks, counts = dc.divergence_cuda(torch.from_numpy(dig.view(np.int32)).to(dev),
                                       torch.from_numpy(pres).to(dev))
    assert sc.LAUNCHES["diff"] == before + 1
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
    before = sc.LAUNCHES["diff"]
    for r, n in ((3, 0), (0, 5)):
        masks, counts = dc.divergence_cuda(torch.zeros((r, n, 8), dtype=torch.int32, device=dev),
                                           torch.zeros((r, n), dtype=torch.bool, device=dev))
        assert masks.shape == (r, n) and counts.tolist() == [0] * r
    assert sc.LAUNCHES["diff"] == before


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
    before = sc.LAUNCHES["diff"]
    for cycle in range(3):
        _root, masks, counts = te.anti_entropy_forward(blocks, nblocks, digests, present,
                                                       device=dev)
        assert sc.LAUNCHES["diff"] == before + cycle + 1
    _check_diff(dig, pres, masks, counts)


def test_sharded_diff_reads_each_shards_slice(dev):
    from merklekv_tpu_torch.parallel import sharded_merkle
    from merklekv_tpu_torch.parallel.mesh import make_mesh

    dig, pres = _replicas(41, 3, 4 * 1027)
    mesh = make_mesh({"key": 4}, devices=[dev] * 4)
    before = sc.LAUNCHES["diff"]
    masks, counts = sharded_merkle.sharded_divergence(
        mesh, torch.from_numpy(dig.view(np.int32)).to(dev), torch.from_numpy(pres).to(dev))
    assert sc.LAUNCHES["diff"] == before + 4
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
    from merklekv_tpu_torch.ops import mesh_copy
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
    before = mesh_copy.COPIES["2d"]
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
    assert mesh_copy.COPIES["2d"] - before == (3 * d if engines else 0)
    for k, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g[0], w[0]), f"step {k}: root"
        assert torch.equal(g[2], w[2]), f"step {k}: counts"
        bad = (g[1] != w[1]).sum().item()
        assert bad == 0, f"step {k}: {bad} mask bytes differ"
