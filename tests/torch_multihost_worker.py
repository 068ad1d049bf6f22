"""One rank of the torch port's multi-process anti-entropy step or 2-D diff.

    MKV_COORDINATOR=127.0.0.1:<port> MKV_NUM_PROCESSES=2 MKV_PROCESS_ID=<rank> \\
        python tests/torch_multihost_worker.py N R DIVERGED LOCAL_DEVICES [BACKEND]
    ... python tests/torch_multihost_worker.py 2d N R LOCAL_DEVICES REPLICAS SEED [BACKEND]

Step mode: every rank builds the same global keyspace (``b"mh:%05d"`` /
``b"val-%d"``) and R replica digest stacks, replica 1 diverging on the first
DIVERGED keys; it then keeps its contiguous slice of the rows, lifts them
onto ``LOCAL_DEVICES`` devices of its own with
``multihost.lift_local_shards`` and runs the sharded step. Prints ``ROOT
<hex>``, ``COUNTS <r0>,<r1>,...`` and ``MASKS ok`` when this rank's mask
rows equal the injected divergence.

2-D mode: every rank builds the same [R, N] inputs (:func:`diff_inputs`
from SEED), forms the ``(replica, key)`` mesh with REPLICAS replica shards
over every rank's ``LOCAL_DEVICES`` devices, keeps only the block its
devices hold, lifts it with ``multihost.lift_local_blocks`` and runs
``sharded_divergence_2d``. Prints ``BLOCK <first row> <first key> <rows>
<keys>``, ``COUNTS2D <r0>,<r1>,...`` and ``MASKS2D <hex of the packed
bits of its mask block>``.

The device is ``MERKLEKV_TORCH_DEVICE`` (unset means ``cpu`` here); with one
device the mesh is ``multihost.global_key_mesh``, with more
``multihost.spanning_mesh`` over that device repeated. BACKEND (gloo or
nccl) defaults to ``initialize``'s choice. Imports torch and the port only
(``tests/test_torch_package.py`` checks it).
"""

import os
import sys

import numpy as np


def diff_inputs(n: int, r: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """[R, N, 8] uint32 digests and [R, N] presence: replica 0 random with
    some keys absent; each other replica a copy with a quarter of its keys
    changed in one word and an eighth of its presence bits flipped."""
    rng = np.random.default_rng(seed)
    dig = np.repeat(rng.integers(0, 2**32, size=(1, n, 8), dtype=np.uint32), r, axis=0)
    pres = np.ones((r, n), bool)
    pres[0, rng.choice(n, max(1, n // 8), replace=False)] = False
    for i in range(1, r):
        dig[i, rng.choice(n, max(1, n // 4), replace=False), i % 8] ^= np.uint32(i)
        pres[i, rng.choice(n, max(1, n // 8), replace=False)] ^= True
    return dig, pres


def _mesh(multihost, dev: str, local: int, replicas: int = 0):
    import torch

    if local == 1:
        return multihost.global_key_mesh(replicas)
    return multihost.spanning_mesh([torch.device(dev)] * local, replicas)


def step_mode(argv: list[str], dev: str) -> None:
    from merklekv_tpu_torch.merkle.packing import pack_leaves
    from merklekv_tpu_torch.merkle.torch_engine import leaf_digests
    from merklekv_tpu_torch.ops.sha256 import digest_to_bytes
    from merklekv_tpu_torch.parallel import multihost, sharded_anti_entropy_step
    from merklekv_tpu_torch.utils.torchenv import words_np

    n, r, diverged, local = (int(a) for a in argv[:4])
    world, rank = multihost.process_count(), multihost.process_index()
    keys = [b"mh:%05d" % i for i in range(n)]
    values = [b"val-%d" % i for i in range(n)]
    packed = pack_leaves(keys, values)
    digests = np.tile(words_np(leaf_digests(keys, values, device="cpu"))[None], (r, 1, 1))
    present = np.ones((r, n), bool)
    digests[1, :diverged, 0] ^= 0xDEAD
    expected = np.zeros((r, n), bool)
    expected[1, :diverged] = True

    lo, hi = rank * n // world, (rank + 1) * n // world
    mesh = _mesh(multihost, dev, local)
    lifted = multihost.lift_local_shards(
        mesh, packed.blocks[lo:hi], packed.nblocks[lo:hi], digests[:, lo:hi], present[:, lo:hi])
    root, masks, counts = sharded_anti_entropy_step(mesh, *lifted)
    print("ROOT", digest_to_bytes(words_np(root)).hex(), flush=True)
    print("COUNTS", ",".join(str(int(c)) for c in counts.cpu()), flush=True)
    if np.array_equal(masks.cpu().numpy(), expected[:, lo:hi]):
        print("MASKS ok", flush=True)


def diff2d_mode(argv: list[str], dev: str) -> None:
    from merklekv_tpu_torch.parallel import multihost
    from merklekv_tpu_torch.parallel.sharded_merkle import sharded_divergence_2d

    n, r, local, replicas, seed = (int(a) for a in argv[:5])
    mesh = _mesh(multihost, dev, local, replicas)
    rb, nb = r // mesh.global_shape["replica"], n // mesh.global_shape["key"]
    r0, c0 = mesh.origin[0] * rb, mesh.origin[1] * nb
    rows, cols = mesh.shape["replica"] * rb, mesh.shape["key"] * nb
    dig, pres = diff_inputs(n, r, seed)
    blocks = multihost.lift_local_blocks(
        mesh, dig[r0:r0 + rows, c0:c0 + cols], pres[r0:r0 + rows, c0:c0 + cols])
    masks, counts = sharded_divergence_2d(mesh, *blocks)
    block = masks.cpu().numpy()
    assert block.shape == (rows, cols), block.shape
    print("BLOCK", r0, c0, rows, cols, flush=True)
    print("COUNTS2D", ",".join(str(int(c)) for c in counts.cpu()), flush=True)
    print("MASKS2D", np.packbits(block).tobytes().hex(), flush=True)


def main(argv: list[str]) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    from merklekv_tpu_torch.parallel import multihost

    two_d = bool(argv) and argv[0] == "2d"
    args = argv[1:] if two_d else argv
    nargs = 5 if two_d else 4
    backend = args[nargs] if len(args) > nargs else None
    dev = os.environ.setdefault("MERKLEKV_TORCH_DEVICE", "cpu")
    multihost.initialize(backend=backend)
    assert multihost.is_initialized()
    assert multihost.process_count() == int(os.environ["MKV_NUM_PROCESSES"])
    (diff2d_mode if two_d else step_mode)(args, dev)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
