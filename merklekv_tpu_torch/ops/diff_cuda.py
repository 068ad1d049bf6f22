"""The N-replica diff: the predicate, its plain version and the CUDA wrapper.

One pass over R replicas' leaf digests and presence gives the ``[R, N]``
masks of the keys that diverge from replica 0 and the ``[R]`` int32 counts
of each row. The JAX package runs the predicate
(``merklekv_tpu/merkle/diff.py:98``) under ``jit``, where XLA fuses it into
one pass; on the card it is one hand-written kernel,
``csrc/diff_kernels.cu``, whose note says what bounds it and what its
design does about that. The predicate itself is :func:`divergence_vs_ref`
here and ``mkv_key_diverges`` (``csrc/diff_kernels.cuh``) in the kernel.

The wrapper (``divergence_cuda``) keeps the contract of
``ops/cuda_lib.py``; a key-axis slice of a larger tensor is read where it
lies: only inputs whose key or word axis is not contiguous are copied.
"""

from __future__ import annotations

import torch

from merklekv_tpu_torch.ops.cuda_lib import is_cpu, launch

__all__ = ["divergence_vs_ref", "divergence_plain", "divergence_cuda"]


def divergence_vs_ref(digests, present, ref_d, ref_p):
    """THE divergence predicate: a key diverges iff presence differs or both
    are present with different digests. Written with methods and operators
    only, so it runs on numpy arrays and on torch tensors alike."""
    same_digest = (digests == ref_d).all(axis=-1)
    both_present = present & ref_p
    return (present != ref_p) | (both_present & ~same_digest)


def divergence_plain(digests: torch.Tensor, present: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: :func:`divergence_vs_ref` against row 0 and the
    int32 sum of each row of its masks."""
    masks = divergence_vs_ref(digests, present, digests[0:1], present[0:1])
    return masks, masks.sum(dim=1, dtype=torch.int32)


def divergence_cuda(digests: torch.Tensor, present: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """[R, N, 8] int32 digests (uint32 bits) + [R, N] bool presence ->
    ([R, N] bool masks, row 0 all False, of the keys that diverge from
    replica 0; [R] int32 counts of each row), in one launch on the card."""
    if is_cpu(digests, present):
        return divergence_plain(digests, present)
    dev = digests.device
    if present.device != dev:
        raise ValueError(f"present is on {present.device}, digests on {dev}")
    if digests.dtype != torch.int32 or present.dtype != torch.bool:
        raise TypeError(f"expected int32 digests and bool presence, got {digests.dtype}, "
                        f"{present.dtype}")
    if digests.dim() != 3 or digests.shape[2] != 8 or tuple(present.shape) != digests.shape[:2]:
        raise ValueError(f"digests {tuple(digests.shape)} and present {tuple(present.shape)} "
                         f"are not [R, N, 8] and [R, N]")
    if digests.stride(2) != 1 or digests.stride(1) != 8 or digests.stride(0) % 4:
        digests = digests.contiguous()
    if present.stride(1) != 1:
        present = present.contiguous()
    if digests.data_ptr() % 16:
        raise ValueError("digests must be 16-byte aligned for vector loads")
    r, n = digests.shape[0], digests.shape[1]
    masks = torch.empty((r, n), dtype=torch.bool, device=dev)
    counts = torch.zeros(r, dtype=torch.int32, device=dev)
    if r and n:
        launch("mkv_divergence", dev, digests.data_ptr(), digests.stride(0), present.data_ptr(),
               present.stride(0), masks.data_ptr(), counts.data_ptr(), n, r)
    return masks, counts
