"""The N-replica diff: the predicate, its plain version and the CUDA wrapper.

One pass over R replicas' leaf digests and presence gives the ``[R, N]``
masks of the keys that diverge from replica 0 and the ``[R]`` int32 counts
of each row. The JAX package runs the predicate
(``merklekv_tpu/merkle/diff.py:98``) under ``jit``, where XLA fuses it into
one pass; on the card it is one hand-written kernel,
``csrc/diff_kernels.cu``, whose note says what bounds it and what its
design does about that. The predicate itself is :func:`divergence_vs_ref`
here and ``mkv_key_diverges`` (``csrc/diff_kernels.cuh``) in the kernel.

The wrappers keep the contract of ``ops/cuda_lib.py``; a key-axis slice of
a larger tensor is read where it lies: only inputs whose key or word axis
is not contiguous are copied. ``divergence_cuda`` launches the standalone
grid, as many blocks as the card holds; ``divergence_beside_cuda`` the
co-resident grid, one block of 128 threads an SM (``csrc/diff_kernels.cuh``),
for the anti-entropy step that runs the diff on a stream of its own beside
the leaf hash, into outputs the step made on the leaf hash's stream.
"""

from __future__ import annotations

import torch

from merklekv_tpu_torch.ops.cuda_lib import is_cpu, launch

__all__ = ["divergence_vs_ref", "divergence_plain", "divergence_cuda", "divergence_beside_cuda"]


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


def _checked(digests: torch.Tensor, present: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """CUDA digests and presence as the kernel reads them, or raise; only a
    layout it cannot read is copied (on the current stream)."""
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
    return digests, present


def _launch(digests, present, masks, counts, beside: bool) -> None:
    r, n = digests.shape[0], digests.shape[1]
    if r and n:
        launch("mkv_divergence", digests.device, digests.data_ptr(), digests.stride(0),
               present.data_ptr(), present.stride(0), masks.data_ptr(), counts.data_ptr(), n, r,
               int(beside))


def divergence_cuda(digests: torch.Tensor, present: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """[R, N, 8] int32 digests (uint32 bits) + [R, N] bool presence ->
    ([R, N] bool masks, row 0 all False, of the keys that diverge from
    replica 0; [R] int32 counts of each row), in one launch on the card, in
    the standalone shape: as many blocks as the card holds at once."""
    if is_cpu(digests, present):
        return divergence_plain(digests, present)
    digests, present = _checked(digests, present)
    r, n = digests.shape[0], digests.shape[1]
    masks = torch.empty((r, n), dtype=torch.bool, device=digests.device)
    counts = torch.zeros(r, dtype=torch.int32, device=digests.device)
    _launch(digests, present, masks, counts, False)
    return masks, counts


def divergence_beside_cuda(digests: torch.Tensor, present: torch.Tensor, masks: torch.Tensor,
                           counts: torch.Tensor) -> None:
    """The same diff of CUDA tensors into ``masks`` [R, N] bool and
    ``counts`` [R] int32 (zero on entry), in one launch on the current
    stream in the co-resident grid, one block of 128 threads an SM: for a
    caller that runs it on a stream of its own beside another kernel,
    which keeps the rest of each SM. The caller made the outputs on the other stream and orders
    their readers after this one. There is no plain version: CPU tensors
    are refused."""
    if is_cpu(digests, present, masks, counts):
        raise ValueError("divergence_beside_cuda takes CUDA tensors")
    digests, present = _checked(digests, present)
    r, n = digests.shape[0], digests.shape[1]
    if masks.device != digests.device or counts.device != digests.device:
        raise ValueError(f"outputs on {masks.device} and {counts.device}, digests on "
                         f"{digests.device}")
    if masks.dtype != torch.bool or counts.dtype != torch.int32:
        raise TypeError(f"expected bool masks and int32 counts, got {masks.dtype}, {counts.dtype}")
    if tuple(masks.shape) != (r, n) or tuple(counts.shape) != (r,) or not (
            masks.is_contiguous() and counts.is_contiguous()):
        raise ValueError(f"masks {tuple(masks.shape)} and counts {tuple(counts.shape)} are not "
                         f"contiguous [{r}, {n}] and [{r}]")
    _launch(digests, present, masks, counts, True)
