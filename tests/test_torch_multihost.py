"""The torch port's multi-process keyspace mesh
(``merklekv_tpu_torch/parallel/multihost.py``) against the JAX package's
``tests/test_multihost.py``, on the CPU over gloo.

- Two spawned ranks (``tests/torch_multihost_worker.py``) over 64 keys, 3
  replicas and 5 diverged keys, with one and with two ``"cpu"`` devices per
  rank (2 and 4 global shards): both report the golden root and counts
  ``0,5,0``, their mask rows equal the injected divergence, and the root
  equals the JAX single-process ``sharded_anti_entropy_step`` on the CPU.
- ``initialize`` raises the JAX function's ``ValueError`` texts for the same
  arguments, and is a no-op without a coordinator.
- One process: ``lift_local_shards`` + the step in the per-device form over
  ``["cpu"] * 4`` equals the single-tensor form and the JAX step bit for
  bit; shards on the wrong device are refused.
- The 2-D ``(replica, key)`` diff across processes: 2 ranks (3 for R = 3,
  where each replica shard is one replica and the first holds the reference
  alone) with 1 and 2 ``"cpu"`` devices each, meshes where the replica axis
  crosses the ranks and where the key axis does, R up to 64: the ranks'
  mask blocks and counts are bit-identical to the JAX
  ``sharded_divergence_2d`` on the virtual CPU devices at the same
  ``(Dr, Dk)`` and to ``divergence_masks_np``. In one process
  ``lift_local_blocks`` gives the per-device form, which equals the global
  form; the block layout of each rank in the grid, and its refusals.
- A node started with ``MKV_COORDINATOR``, ``MKV_NUM_PROCESSES=1`` and
  ``MKV_PROCESS_ID=0`` joins a one-rank group and serves ``HASH`` == golden.

The same worker with two ranks sharing ``cuda:0`` over gloo runs on the card
in ``tests/test_torch_cuda.py``.

Every subprocess runs under a timeout and is killed on any failure path.
Tolerance: exact equality.
"""

import os
import signal
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch_multihost_worker as worker  # tests/ is on sys.path under pytest

from merklekv_tpu.merkle import diff as jdiff
from merklekv_tpu.merkle.cpu import build_levels as jax_golden_levels
from merklekv_tpu.merkle.encoding import leaf_hash as jax_leaf_hash
from merklekv_tpu.merkle.jax_engine import leaf_digests as jax_leaf_digests
from merklekv_tpu.merkle.packing import pack_leaves as jax_pack_leaves
from merklekv_tpu.ops.sha256 import digest_to_bytes as jax_digest_to_bytes
from merklekv_tpu.parallel import make_mesh as jax_make_mesh
from merklekv_tpu.parallel import multihost as jax_multihost
from merklekv_tpu.parallel import sharded_anti_entropy_step as jax_step
from merklekv_tpu.parallel.sharded_merkle import sharded_divergence_2d as jax_sharded_2d
from merklekv_tpu_torch.client import MerkleKVClient
from merklekv_tpu_torch.merkle.diff import divergence_masks_np
from merklekv_tpu_torch.merkle.packing import pack_leaves
from merklekv_tpu_torch.merkle.torch_engine import leaf_digests
from merklekv_tpu_torch.ops.sha256 import digest_to_bytes
from merklekv_tpu_torch.parallel import make_mesh, multihost, sharded_anti_entropy_step
from merklekv_tpu_torch.parallel.mesh import Mesh
from merklekv_tpu_torch.parallel.sharded_merkle import sharded_divergence_2d
from merklekv_tpu_torch.utils.torchenv import words_np

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_multihost_worker.py"
N_GLOBAL, R, DIVERGED = 64, 3, 5
RANK_TIMEOUT = 120


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _kv(n=N_GLOBAL):
    return [b"mh:%05d" % i for i in range(n)], [b"val-%d" % i for i in range(n)]


def _inputs(n=N_GLOBAL):
    keys, values = _kv(n)
    packed = pack_leaves(keys, values)
    digests = np.tile(words_np(leaf_digests(keys, values, device="cpu"))[None], (R, 1, 1))
    digests[1, :DIVERGED, 0] ^= 0xDEAD
    return packed, digests, np.ones((R, n), bool)


def _golden_hex() -> str:
    keys, values = _kv()
    return jax_golden_levels([jax_leaf_hash(k, v) for k, v in zip(keys, values)])[-1][0].hex()


def _jax_step_root_hex() -> tuple[str, str]:
    """The JAX single-process sharded step over the 8 virtual CPU devices."""
    keys, values = _kv()
    packed = jax_pack_leaves(keys, values)
    digests = np.tile(np.asarray(jax_leaf_digests(keys, values))[None], (R, 1, 1))
    digests[1, :DIVERGED, 0] ^= 0xDEAD
    mesh = jax_make_mesh({"key": 8}, devices=jax.devices()[:8])
    root, _, counts = jax_step(mesh, packed.blocks, packed.nblocks, digests,
                               np.ones((R, N_GLOBAL), bool))
    return (jax_digest_to_bytes(np.asarray(root)).hex(),
            ",".join(str(int(c)) for c in np.asarray(counts)))


def _run_ranks(world: int, local: int, env_extra: dict, backend=None) -> list[dict]:
    port = _free_port()
    args = [str(N_GLOBAL), str(R), str(DIVERGED), str(local)] + ([backend] if backend else [])
    procs = []
    try:
        for rank in range(world):
            env = dict(os.environ, PYTHONPATH=str(ROOT), MKV_COORDINATOR=f"127.0.0.1:{port}",
                       MKV_NUM_PROCESSES=str(world), MKV_PROCESS_ID=str(rank), **env_extra)
            procs.append(subprocess.Popen([sys.executable, str(WORKER), *args], env=env,
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True))
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=RANK_TIMEOUT)
            assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
            outs.append(dict(ln.split(" ", 1) for ln in out.splitlines()
                             if ln.startswith(("ROOT", "COUNTS", "MASKS"))))
        return outs
    finally:
        # A dead rank leaves the others blocked in the rendezvous or a
        # collective: never orphan one on a failure path.
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


@pytest.mark.integration
@pytest.mark.parametrize("local", [1, 2], ids=["1-device-per-rank", "2-devices-per-rank"])
def test_two_ranks_agree_with_golden_and_the_jax_step(local):
    outs = _run_ranks(2, local, {"MERKLEKV_TORCH_DEVICE": "cpu"})
    golden = _golden_hex()
    jax_root, jax_counts = _jax_step_root_hex()
    assert jax_root == golden and jax_counts == f"0,{DIVERGED},0"
    for out in outs:
        assert out["ROOT"] == golden
        assert out["COUNTS"] == f"0,{DIVERGED},0"
        assert out["MASKS"] == "ok"


@pytest.mark.parametrize("kwargs,env,match", [
    (dict(coordinator="127.0.0.1:1"), {}, "MKV_NUM_PROCESSES"),
    (dict(coordinator="127.0.0.1:1", num_processes=2), {}, "MKV_PROCESS_ID"),
    (dict(), {"MKV_COORDINATOR": "127.0.0.1:1"}, "MKV_NUM_PROCESSES"),
    (dict(num_processes=2), {"MKV_COORDINATOR": "127.0.0.1:1"}, "MKV_PROCESS_ID"),
])
def test_initialize_requires_full_topology_with_the_jax_messages(monkeypatch, kwargs, env, match):
    monkeypatch.delenv("MKV_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("MKV_PROCESS_ID", raising=False)
    monkeypatch.delenv("MKV_COORDINATOR", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError) as theirs:
        jax_multihost.initialize(**kwargs)
    with pytest.raises(ValueError, match=match) as ours:
        multihost.initialize(**kwargs)
    assert str(ours.value) == str(theirs.value)
    assert not multihost.is_initialized()


def test_without_a_coordinator_everything_is_one_process(monkeypatch):
    monkeypatch.delenv("MKV_COORDINATOR", raising=False)
    monkeypatch.setenv("MERKLEKV_TORCH_DEVICE", "cpu")
    multihost.initialize()
    assert not multihost.is_initialized()
    assert (multihost.process_count(), multihost.process_index()) == (1, 0)
    mesh = multihost.global_key_mesh()
    assert mesh.shape == {"key": 1} and not mesh.spans_processes
    assert mesh.axis_devices("key") == [torch.device("cpu")]
    mesh2 = multihost.global_key_mesh(replicas=1)
    assert mesh2.shape == {"replica": 1, "key": 1}
    with pytest.raises(ValueError) as theirs:
        jax_multihost.global_key_mesh(replicas=3)
    assert str(theirs.value) == "8 devices not divisible by replicas=3"
    with pytest.raises(ValueError, match=r"^1 devices not divisible by replicas=2$"):
        multihost.global_key_mesh(replicas=2)


@pytest.mark.parametrize("claims,backend,error", [
    ([["a"], ["b"]], "nccl", None),
    ([["a", "b"], ["c", "d"]], "nccl", None),
    ([["a"], ["a"]], "gloo", None),
    ([[], []], "gloo", None),
    ([["a"], ["a"]], "nccl", "ranks 0 and 1 share card a over nccl"),
    ([["a", "b"], ["a", "b"]], "gloo", "ranks 0 and 1 both claim card a"),
    ([["a"], ["b"], ["b", "c"]], "nccl", "ranks 1 and 2 both claim card b"),
], ids=["one-card-each", "two-cards-each", "shared-card-gloo", "cpu-ranks",
        "shared-card-nccl", "default-every-card", "overlap-on-a-later-rank"])
def test_card_claims_of_the_ranks_must_not_overlap(claims, backend, error):
    got = multihost._card_overlap(claims, backend)
    if error is None:
        assert got is None
    else:
        assert got is not None and error in got


def test_one_process_per_device_form_equals_single_tensor_and_jax():
    packed, digests, present = _inputs()
    mesh = make_mesh({"key": 4}, devices=["cpu"] * 4)
    lifted = multihost.lift_local_shards(mesh, packed.blocks, packed.nblocks, digests, present)
    assert [len(x) for x in lifted] == [4, 4, 4, 4]
    assert all(t.shape[0] == N_GLOBAL // 4 for t in lifted[0])
    root, masks, counts = sharded_anti_entropy_step(mesh, *lifted)
    root_1, masks_1, counts_1 = sharded_anti_entropy_step(
        make_mesh({"key": 4}, devices=["cpu"] * 4), packed.blocks, packed.nblocks, digests, present)
    assert torch.equal(root, root_1) and torch.equal(masks, masks_1) and torch.equal(counts, counts_1)
    jax_root, jax_counts = _jax_step_root_hex()
    assert digest_to_bytes(words_np(root)).hex() == jax_root == _golden_hex()
    assert ",".join(str(int(c)) for c in counts) == jax_counts
    want = np.zeros((R, N_GLOBAL), bool)
    want[1, :DIVERGED] = True
    np.testing.assert_array_equal(masks.numpy(), want)


def test_per_device_form_is_checked():
    packed, digests, present = _inputs()
    mesh = make_mesh({"key": 4}, devices=["cpu"] * 4)
    blocks, nblocks, dig, pres = multihost.lift_local_shards(
        mesh, packed.blocks, packed.nblocks, digests, present)
    with pytest.raises(ValueError, match="3 per-device shards for 4 devices"):
        sharded_anti_entropy_step(mesh, blocks[:3], nblocks[:3], dig[:3], pres[:3])
    meta = [t.to("meta") for t in blocks]
    with pytest.raises(ValueError, match="shard 0 is on meta"):
        sharded_anti_entropy_step(mesh, meta, nblocks, dig, pres)
    with pytest.raises(ValueError, match="not divisible by mesh axis 4"):
        multihost.lift_local_shards(mesh, packed.blocks[:62], packed.nblocks[:62],
                                    digests[:, :62], present[:, :62])
    with pytest.raises(ValueError, match="must be a positive power of two"):
        sharded_anti_entropy_step(mesh, *multihost.lift_local_shards(
            mesh, packed.blocks[:48], packed.nblocks[:48], digests[:, :48], present[:, :48]))


def _run_2d(world, local, replicas, r, n, seed) -> list[dict]:
    port = _free_port()
    args = ["2d", str(n), str(r), str(local), str(replicas), str(seed)]
    procs = []
    try:
        for rank in range(world):
            env = dict(os.environ, PYTHONPATH=str(ROOT), MKV_COORDINATOR=f"127.0.0.1:{port}",
                       MKV_NUM_PROCESSES=str(world), MKV_PROCESS_ID=str(rank),
                       MERKLEKV_TORCH_DEVICE="cpu")
            procs.append(subprocess.Popen([sys.executable, str(WORKER), *args], env=env,
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True))
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=RANK_TIMEOUT)
            assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
            outs.append(dict(ln.split(" ", 1) for ln in out.splitlines()
                             if ln.startswith(("BLOCK", "COUNTS2D", "MASKS2D"))))
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


@pytest.mark.integration
@pytest.mark.parametrize("world,local,replicas,r,n", [
    (2, 1, 1, 5, 32),
    (2, 1, 2, 4, 32),
    (2, 2, 1, 4, 32),
    (2, 2, 2, 6, 32),
    (2, 2, 4, 8, 32),
    (3, 1, 3, 3, 24),
    (2, 1, 2, 64, 16),
    (2, 2, 4, 64, 16),
], ids=["1dev-key-axis-crosses", "1dev-replica-axis-crosses", "2dev-key-axis-crosses",
        "2dev-replica-axis-crosses-row-per-rank", "2dev-replica-axis-crosses-2-rows-per-rank",
        "3ranks-R3-reference-alone", "1dev-R64", "2dev-R64-4-replica-shards"])
def test_2d_diff_across_ranks_equals_jax_and_host(world, local, replicas, r, n):
    seed = 1000 * world + 100 * local + r
    dig, pres = worker.diff_inputs(n, r, seed)
    dr, dk = replicas, world * local // replicas
    jm, jc = jax_sharded_2d(jax_make_mesh({"replica": dr, "key": dk},
                                          devices=jax.devices()[:dr * dk]), dig, pres)
    want = jdiff.divergence_masks_np(dig, pres)
    np.testing.assert_array_equal(np.asarray(jm), want)
    np.testing.assert_array_equal(divergence_masks_np(dig, pres), want)
    got = np.zeros((r, n), np.int8) - 1
    for out in _run_2d(world, local, replicas, r, n, seed):
        assert out["COUNTS2D"] == ",".join(str(int(c)) for c in np.asarray(jc))
        r0, c0, rows, cols = (int(x) for x in out["BLOCK"].split())
        bits = np.unpackbits(np.frombuffer(bytes.fromhex(out["MASKS2D"]), np.uint8))
        assert (got[r0:r0 + rows, c0:c0 + cols] == -1).all(), "two ranks hold one block"
        got[r0:r0 + rows, c0:c0 + cols] = bits[:rows * cols].reshape(rows, cols)
    np.testing.assert_array_equal(got, want.astype(np.int8))


@pytest.mark.parametrize("rank,l,cols,block", [
    (0, 1, 2, (0, 0, 1, 1)),
    (1, 1, 2, (0, 1, 1, 1)),
    (1, 1, 1, (1, 0, 1, 1)),
    (1, 2, 4, (0, 2, 1, 2)),
    (3, 2, 4, (1, 2, 1, 2)),
    (1, 2, 1, (2, 0, 2, 1)),
    (1, 4, 2, (2, 0, 2, 2)),
], ids=["share-of-row-0", "share-of-row-1", "one-column", "half-row", "half-of-row-1",
        "two-rows-one-column", "two-rows"])
def test_each_rank_takes_a_rectangle_of_the_2d_grid(rank, l, cols, block):
    assert multihost._block_of(rank, l, cols) == block


@pytest.mark.parametrize("l,cols", [(2, 3), (3, 2)])
def test_a_rank_whose_devices_are_not_a_rectangle_is_refused(l, cols):
    with pytest.raises(ValueError, match="whole rows or an equal share of one row"):
        multihost._block_of(1, l, cols)


def test_one_process_2d_per_device_form_equals_global_and_is_checked():
    dig, pres = worker.diff_inputs(16, 4, 7)
    mesh = make_mesh({"replica": 2, "key": 2}, devices=["cpu"] * 4)
    d_blocks, p_blocks = multihost.lift_local_blocks(mesh, dig, pres)
    assert [len(row) for row in d_blocks] == [2, 2] and d_blocks[1][0].shape == (2, 8, 8)
    masks, counts = sharded_divergence_2d(mesh, d_blocks, p_blocks)
    masks_1, counts_1 = sharded_divergence_2d(mesh, dig, pres)
    assert torch.equal(masks, masks_1) and torch.equal(counts, counts_1)
    np.testing.assert_array_equal(masks.numpy(), divergence_masks_np(dig, pres))
    meta = [[t.to("meta") for t in row] for row in d_blocks]
    with pytest.raises(ValueError, match="shard 0 is on meta"):
        sharded_divergence_2d(mesh, meta, p_blocks)
    with pytest.raises(ValueError, match="1 rows of per-device blocks for 2 replica shards"):
        sharded_divergence_2d(mesh, d_blocks[:1], p_blocks[:1])
    with pytest.raises(ValueError, match="1 per-device shards for 2 devices"):
        sharded_divergence_2d(mesh, [row[:1] for row in d_blocks], p_blocks)
    spanning = Mesh(mesh.devices, mesh.axis_names, process_index=0, process_count=2)
    with pytest.raises(ValueError, match="takes the per-device form"):
        sharded_divergence_2d(spanning, dig, pres)


@pytest.mark.integration
def test_node_with_a_one_rank_coordinator_serves_the_golden_root(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), MERKLEKV_TORCH_DEVICE="cpu",
               MKV_COORDINATOR=f"127.0.0.1:{_free_port()}", MKV_NUM_PROCESSES="1",
               MKV_PROCESS_ID="0")
    proc = subprocess.Popen([sys.executable, "-m", "merklekv_tpu_torch", "--port", "0"],
                            cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("merklekv_tpu_torch listening on "), (line, proc.stderr.read())
        port = int(line.split()[3].rsplit(":", 1)[1])
        keys, values = _kv()
        with MerkleKVClient("127.0.0.1", port, timeout=60) as c:
            c.mset({k.decode(): v.decode() for k, v in zip(keys, values)})
            assert c.hash() == _golden_hex()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(RANK_TIMEOUT) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
