"""Vectorized multi-replica Merkle diff (counterpart of ``merklekv_tpu.merkle.diff``).

The whole comparison is one elementwise pass over stacked replica tensors:

  - N replicas' leaf digests are aligned host-side onto the union keyspace
    (sorted keys; absent keys get a presence-mask 0);
  - the device computes per-key divergence masks for all replicas against a
    reference replica simultaneously — [R, N] in one pass;
  - winners for reconciliation come back as index lists, not values.

The JAX package left the predicate to XLA outside any Pallas kernel; here
``divergence_masks`` goes through ``ops.dispatch.divergence``: on a CUDA
tensor one hand-written kernel (``csrc/diff_kernels.cu``) that reads every
digest once and writes the masks and the per-replica counts in the same
pass, on a CPU tensor ``divergence_vs_ref``, the one predicate both
share (defined in ``ops/diff_cuda.py``, exported here as the JAX module
exports it). ``divergence_masks_np`` is a copy of the JAX package's host
twin.
``divergence_masks_engine`` is the engine boundary the anti-entropy
manager calls: past ``SHARDED_DIFF_MIN_KEYS`` on a host with two or more
devices it shards the comparison over them
(``parallel/sharded_merkle.py::sharded_divergence``), else it is
``divergence_masks`` on the given device. The masks are bit-identical
either way.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from merklekv_tpu_torch.ops.diff_cuda import divergence_vs_ref
from merklekv_tpu_torch.ops.dispatch import divergence
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

# Route the [R, N] comparison through the keyspace-sharded path only past
# this union-keyspace size: below it the copies cost more than the
# elementwise pass they parallelize.
SHARDED_DIFF_MIN_KEYS = 1 << 15


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


def divergence_masks(digests: torch.Tensor, present: torch.Tensor) -> torch.Tensor:
    """[R, N] bool: key i diverges between replica r and replica 0, from
    [R, N, 8] int32 digests and [R, N] bool presence (the masks of
    ``ops.dispatch.divergence``; callers that need the per-replica counts
    take both from it).

    Row 0 is all-False by construction."""
    return divergence(digests, present)[0]


def divergence_masks_np(digests: np.ndarray, present: np.ndarray) -> np.ndarray:
    """Host-side twin of :func:`divergence_masks` for small keyspaces where
    initializing an accelerator backend is not worth it (and, in spawned
    server processes, must be avoided unless explicitly configured)."""
    return divergence_vs_ref(digests, present, digests[0:1], present[0:1])


def _pad_keys(x, pad: int):
    """Append ``pad`` all-zero (absent) key columns along axis 1."""
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x.new_zeros((x.shape[0], pad, *x.shape[2:]))], dim=1)
    x = np.asarray(x)
    return np.concatenate([x, np.zeros((x.shape[0], pad, *x.shape[2:]), x.dtype)], axis=1)


def divergence_masks_engine(
    digests, present, device=None, min_keys: Optional[int] = None, devices=None
) -> torch.Tensor:
    """The N-replica diff behind the engine boundary: ``[R, N]`` bool masks
    of ``digests`` ``[R, N, 8]`` uint32 and ``present`` ``[R, N]`` bool
    (numpy arrays or tensors), returned on ``device`` (``None`` = CUDA).

    ``devices`` is the local device list (default: every card of the host,
    or ``[device]`` for a CPU ``device``). When it holds two or more and the
    union keyspace reaches ``min_keys`` (default
    :data:`SHARDED_DIFF_MIN_KEYS`; 0 forces it), the comparison is sharded
    over the largest power-of-two subset of it: the key axis is padded with
    all-absent columns (absent everywhere == absent on the reference ->
    never divergent) and sliced back off. The sharded call runs under the
    dispatch guard as ``shard{D}_diff``; on a ``DeviceDispatchError`` it
    falls back to the single-device compare on ``device`` — never to the
    host. Masks are bit-identical either way."""
    dev = resolve_device(device)
    n = int(digests.shape[1])
    lim = SHARDED_DIFF_MIN_KEYS if min_keys is None else min_keys
    if n > 0 and n >= lim:
        # Imported here: parallel/ imports this module.
        from merklekv_tpu_torch.device.guard import DeviceDispatchError, get_guard
        from merklekv_tpu_torch.parallel import sharded_merkle
        from merklekv_tpu_torch.parallel.mesh import make_mesh, shard_devices
        from merklekv_tpu_torch.parallel.sharded_state import resolve_shard_count

        devs = shard_devices(dev, devices)
        d = resolve_shard_count("auto", len(devs))  # 0 on a one-device list
        if d >= 2:
            mesh = make_mesh({"key": d}, devices=devs[:d])
            pad = (-n) % d
            dig, pres = (_pad_keys(digests, pad), _pad_keys(present, pad)) if pad else (digests, present)
            try:
                masks, _counts = get_guard().run(
                    f"shard{d}_diff", lambda: sharded_merkle.sharded_divergence(mesh, dig, pres))
                return masks[:, :n].to(dev)
            except DeviceDispatchError:
                # The sharded path is an optimization, never the contract:
                # the single-device compare below is bit-identical.
                pass
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
