"""The CUDA kernels on the card: wrappers, launch counts, and parity with the
plain versions and the CPU path. Tolerance: exact equality.

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips without a GPU. This file imports nothing of JAX, so it runs on a
machine without JAX too (bypassing ``tests/conftest.py``, which imports it):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import hashlib
import threading

import numpy as np
import pytest
import torch

from merklekv_tpu_torch.device.guard import DispatchGuard
from merklekv_tpu_torch.merkle import torch_engine as te
from merklekv_tpu_torch.merkle.incremental import DeviceMerkleState, _reduce_levels
from merklekv_tpu_torch.ops import merkle_paths as mp
from merklekv_tpu_torch.ops import sha256 as plain
from merklekv_tpu_torch.ops import sha256_cuda as sc

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
                           "path_rehash": 0, "promotion_chain": 0}


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


PATH_C = 4096
PATH_CASES = {
    "k1": lambda rng: [1234],
    "sibling_pair": lambda rng: [100, 101],
    "first_and_last": lambda rng: [0, PATH_C - 1],
    "one_subtree": lambda rng: list(range(1024, 1536)),
    "every_leaf": lambda rng: list(range(PATH_C)),
    "random_257": lambda rng: sorted(rng.choice(PATH_C, size=257, replace=False)),
}


@pytest.mark.parametrize("case", sorted(PATH_CASES))
def test_path_rehash_kernel_matches_plain(dev, case):
    """The fused kernel on one copy of the levels, its plain version on
    another: every level bit for bit, the counters zero again."""
    rng = np.random.RandomState(sorted(PATH_CASES).index(case))
    levels = _reduce_levels(_words(1, (PATH_C, 8), dev))
    ref = [lv.clone() for lv in levels]
    pos = np.asarray(PATH_CASES[case](rng), np.int64)
    k = len(pos)
    blocks = _words(2, (k, 2, 16), dev)
    nblocks = torch.from_numpy(rng.randint(0, 3, size=k).astype(np.int32)).to(dev)
    counters = torch.zeros(PATH_C - 1, dtype=torch.int32, device=dev)
    before = sc.LAUNCHES["path_rehash"]
    mp.path_rehash_cuda(levels, counters, blocks, nblocks, pos)
    assert sc.LAUNCHES["path_rehash"] == before + 1
    mp.path_rehash(ref, blocks, nblocks, pos)
    for lvl, (got, want) in enumerate(zip(levels, ref)):
        assert torch.equal(got, want), (case, lvl)
    assert not counters.any()


def test_promotion_chain_kernel_matches_plain(dev):
    levels = _reduce_levels(_words(3, (PATH_C, 8), dev))
    for n in (1, 2, 3, PATH_C // 2 + 1, 3000, PATH_C):
        before = sc.LAUNCHES["promotion_chain"]
        got = mp.promotion_chain_cuda(levels, n)
        assert sc.LAUNCHES["promotion_chain"] == before + 1
        assert torch.equal(got, mp.promotion_chain(levels, n)), n


def test_value_batch_is_one_fused_launch(dev):
    items = {b"sk%04d" % i: b"v%d" % i for i in range(300)}
    card = DeviceMerkleState.from_items(items.items())
    cpu = DeviceMerkleState.from_items(items.items(), device="cpu")
    batch = [(b"sk%04d" % i, b"w%d" % i) for i in (0, 1, 7, 150, 299)]
    before = dict(sc.LAUNCHES)
    card.apply(batch)
    card.flush_pending()
    delta = {name: sc.LAUNCHES[name] - before[name] for name in before}
    assert delta == {"leaf": 0, "node_level": 0, "node_pairs": 0,
                     "path_rehash": 1, "promotion_chain": 0}
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
