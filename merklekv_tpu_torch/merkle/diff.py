"""Vectorized multi-replica Merkle diff (counterpart of ``merklekv_tpu.merkle.diff``).

The whole comparison is one elementwise pass over stacked replica tensors:

  - N replicas' leaf digests are aligned host-side onto the union keyspace
    (sorted keys; absent keys get a presence-mask 0);
  - the device computes per-key divergence masks for all replicas against a
    reference replica simultaneously — [R, N] in one pass;
  - winners for reconciliation come back as index lists, not values.

These are plain torch elementwise ops, as the JAX package left them to XLA
outside any Pallas kernel. ``divergence_masks_np`` is a copy of the JAX
package's host twin. ``divergence_masks_engine`` is the engine boundary the
anti-entropy manager calls: on one GPU it is ``divergence_masks`` on the
given device. The JAX package shards it over a multi-device mesh past
``SHARDED_DIFF_MIN_KEYS``; that branch waits for the multi-GPU work (ROADMAP
Queue A item 3). The masks are bit-identical either way.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from merklekv_tpu_torch.utils.torchenv import as_tensor, resolve_device

__all__ = [
    "AlignedReplicas",
    "align_replicas",
    "divergence_vs_ref",
    "divergence_masks",
    "divergence_masks_np",
    "divergence_masks_engine",
    "diff_keys_multi",
    "diff_keys_pair",
]


class AlignedReplicas:
    """Union-keyspace alignment of R replicas' (key -> leaf digest) maps.

    Attributes:
      keys:    union keyspace, sorted bytes, length N.
      digests: [R, N, 8] uint32 — leaf digest per replica/key (0 if absent).
      present: [R, N] bool — key present in replica r.
    """

    __slots__ = ("keys", "digests", "present")

    def __init__(self, keys: list[bytes], digests: np.ndarray, present: np.ndarray):
        self.keys = keys
        self.digests = digests
        self.present = present

    @property
    def n_replicas(self) -> int:
        return self.digests.shape[0]

    @property
    def n_keys(self) -> int:
        return self.digests.shape[1]


def align_replicas(replicas: Sequence[dict[bytes, bytes]]) -> AlignedReplicas:
    """Align R (key -> 32-byte leaf hash) maps onto the sorted union keyspace."""
    union: set[bytes] = set()
    for r in replicas:
        union.update(r.keys())
    keys = sorted(union)
    n = len(keys)
    r_count = len(replicas)
    idx = {k: i for i, k in enumerate(keys)}
    digests = np.zeros((r_count, n, 8), np.uint32)
    present = np.zeros((r_count, n), bool)
    for ri, rep in enumerate(replicas):
        for k, h in rep.items():
            i = idx[k]
            digests[ri, i] = np.frombuffer(h, ">u4").astype(np.uint32)
            present[ri, i] = True
    return AlignedReplicas(keys, digests, present)


def divergence_vs_ref(digests, present, ref_d, ref_p):
    """THE divergence predicate: a key diverges iff presence differs or both
    are present with different digests. Written with methods and operators
    only, so it runs on numpy arrays and on torch tensors alike."""
    same_digest = (digests == ref_d).all(axis=-1)
    both_present = present & ref_p
    return (present != ref_p) | (both_present & ~same_digest)


def divergence_masks(digests: torch.Tensor, present: torch.Tensor) -> torch.Tensor:
    """[R, N] bool: key i diverges between replica r and replica 0.

    Row 0 is all-False by construction."""
    return divergence_vs_ref(digests, present, digests[0:1], present[0:1])


def divergence_masks_np(digests: np.ndarray, present: np.ndarray) -> np.ndarray:
    """Host-side twin of :func:`divergence_masks` for small keyspaces where
    initializing an accelerator backend is not worth it (and, in spawned
    server processes, must be avoided unless explicitly configured)."""
    return divergence_vs_ref(digests, present, digests[0:1], present[0:1])


def divergence_masks_engine(digests, present, device=None) -> torch.Tensor:
    """The N-replica diff behind the engine boundary: ``[R, N]`` bool masks
    of ``digests`` ``[R, N, 8]`` uint32 and ``present`` ``[R, N]`` bool
    (numpy arrays or tensors), computed on ``device`` (``None`` = CUDA)."""
    dev = resolve_device(device)
    return divergence_masks(as_tensor(digests, dev), as_tensor(present, dev, torch.bool))


def diff_keys_multi(aligned: AlignedReplicas, device=None) -> dict[int, list[bytes]]:
    """Per-replica divergent key lists vs replica 0, computed in one pass on
    ``device`` (``None`` = CUDA)."""
    dev = resolve_device(device)
    if aligned.n_keys == 0:
        return {r: [] for r in range(1, aligned.n_replicas)}
    masks = divergence_masks(
        as_tensor(aligned.digests, dev), as_tensor(aligned.present, dev, torch.bool)
    ).cpu().numpy()
    out: dict[int, list[bytes]] = {}
    for r in range(1, aligned.n_replicas):
        (ii,) = np.nonzero(masks[r])
        out[r] = [aligned.keys[i] for i in ii]
    return out


def diff_keys_pair(
    local: dict[bytes, bytes], remote: dict[bytes, bytes], device=None
) -> list[bytes]:
    """Sorted keys differing between two leaf-hash maps (reference
    ``merkle.rs`` diff semantics), via the batched device path."""
    aligned = align_replicas([local, remote])
    return diff_keys_multi(aligned, device=device).get(1, [])
