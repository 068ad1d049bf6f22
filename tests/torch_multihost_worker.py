"""One rank of the torch port's multi-process anti-entropy step.

    MKV_COORDINATOR=127.0.0.1:<port> MKV_NUM_PROCESSES=2 MKV_PROCESS_ID=<rank> \\
        python tests/torch_multihost_worker.py N R DIVERGED LOCAL_DEVICES [BACKEND]

Every rank builds the same global keyspace (``b"mh:%05d"`` / ``b"val-%d"``)
and R replica digest stacks, replica 1 diverging on the first DIVERGED
keys; it then keeps its contiguous slice of the rows, lifts them onto
``LOCAL_DEVICES`` devices of its own with ``multihost.lift_local_shards`` and
runs the sharded step. The device is ``MERKLEKV_TORCH_DEVICE`` (unset means
``cpu`` here); with one device the mesh is ``multihost.global_key_mesh()``,
with more it spans the ranks over that device repeated. BACKEND (gloo or nccl) defaults to ``initialize``'s choice.
Prints ``ROOT <hex>``, ``COUNTS <r0>,<r1>,...`` and ``MASKS ok`` when this
rank's mask rows equal the injected divergence. Imports torch and the port
only (``tests/test_torch_package.py`` checks it).
"""

import os
import sys


def main(argv: list[str]) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import numpy as np
    import torch

    from merklekv_tpu_torch.merkle.packing import pack_leaves
    from merklekv_tpu_torch.merkle.torch_engine import leaf_digests
    from merklekv_tpu_torch.ops.sha256 import digest_to_bytes
    from merklekv_tpu_torch.parallel import multihost, sharded_anti_entropy_step
    from merklekv_tpu_torch.utils.torchenv import words_np

    from merklekv_tpu_torch.parallel.mesh import Mesh

    n, r, diverged, local = (int(a) for a in argv[:4])
    backend = argv[4] if len(argv) > 4 else None
    dev = os.environ.setdefault("MERKLEKV_TORCH_DEVICE", "cpu")
    multihost.initialize(backend=backend)
    world, rank = multihost.process_count(), multihost.process_index()
    assert multihost.is_initialized() and world == int(os.environ["MKV_NUM_PROCESSES"])

    keys = [b"mh:%05d" % i for i in range(n)]
    values = [b"val-%d" % i for i in range(n)]
    packed = pack_leaves(keys, values)
    digests = np.tile(words_np(leaf_digests(keys, values, device="cpu"))[None], (r, 1, 1))
    present = np.ones((r, n), bool)
    digests[1, :diverged, 0] ^= 0xDEAD
    expected = np.zeros((r, n), bool)
    expected[1, :diverged] = True

    lo, hi = rank * n // world, (rank + 1) * n // world
    if local == 1:
        mesh = multihost.global_key_mesh()
    else:
        mesh = Mesh(np.array([torch.device(dev)] * local, dtype=object), ("key",),
                    process_index=rank, process_count=world, group=torch.distributed.group.WORLD)
    lifted = multihost.lift_local_shards(
        mesh, packed.blocks[lo:hi], packed.nblocks[lo:hi], digests[:, lo:hi], present[:, lo:hi])
    root, masks, counts = sharded_anti_entropy_step(mesh, *lifted)
    print("ROOT", digest_to_bytes(words_np(root)).hex(), flush=True)
    print("COUNTS", ",".join(str(int(c)) for c in counts.cpu()), flush=True)
    if np.array_equal(masks.cpu().numpy(), expected[:, lo:hi]):
        print("MASKS ok", flush=True)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
