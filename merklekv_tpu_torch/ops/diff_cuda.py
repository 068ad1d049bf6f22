"""The N-replica diff: the plain version and the CUDA wrapper.

One pass over R replicas' leaf digests and presence gives the ``[R, N]``
masks of the keys that diverge from replica 0 and the ``[R]`` int32 counts
of each row. The JAX package runs the predicate
(``merklekv_tpu/merkle/diff.py:98``) under ``jit``, where XLA fuses it into
one pass; on the card it is one hand-written kernel,
``csrc/diff_kernels.cu``, whose note says what bounds it and what its
design does about that. The predicate itself is
``merkle/diff.py::divergence_vs_ref`` in Python and
``mkv_key_diverges`` (``csrc/diff_kernels.cuh``) in the kernel.

The wrapper (``divergence_cuda``), as in ``ops/sha256_cuda.py``:
- tensors on the CPU run the plain version below (``divergence_vs_ref``
  itself plus the int32 row sum); that is the only case that does;
- CUDA tensors are checked (dtypes, shapes, one device) and the kernel is
  launched under ``torch.cuda.device`` of the digests, on that device's
  current stream, or the wrapper raises (a failed build or a refused
  launch is an error, never a fallback). A key-axis slice of a larger
  tensor is read where it lies: only inputs whose key or word axis is not
  contiguous are copied;
- no keys or no replicas give empty outputs without a launch;
- ``LAUNCHES["diff"]`` counts the launches, incremented at the launch and
  nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from merklekv_tpu_torch.ops.sha256_cuda import (
    LAUNCHES,
    _check_rc,
    _is_cpu,
    _stream,
    build_kernels,
)

__all__ = ["divergence_plain", "divergence_cuda"]


def divergence_plain(digests: torch.Tensor, present: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: ``merkle.diff.divergence_vs_ref`` against row 0
    and the int32 sum of each row of its masks."""
    # Imported here: merkle/diff.py imports this module through dispatch.
    from merklekv_tpu_torch.merkle.diff import divergence_vs_ref

    masks = divergence_vs_ref(digests, present, digests[0:1], present[0:1])
    return masks, masks.sum(dim=1, dtype=torch.int32)


def _lib() -> ctypes.CDLL:
    """The kernel library (``ops/sha256_cuda.py`` builds it) with
    ``mkv_divergence`` bound."""
    lib = build_kernels().lib
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    lib.mkv_divergence.argtypes = [p, i64, p, i64, p, p, i64, i32, p]
    lib.mkv_divergence.restype = ctypes.c_int
    return lib


def divergence_cuda(digests: torch.Tensor, present: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """[R, N, 8] int32 digests (uint32 bits) + [R, N] bool presence ->
    ([R, N] bool masks, row 0 all False, of the keys that diverge from
    replica 0; [R] int32 counts of each row), in one launch on the card."""
    if _is_cpu(digests, present):
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
    if r == 0 or n == 0:
        return masks, counts
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.mkv_divergence(digests.data_ptr(), digests.stride(0), present.data_ptr(),
                                present.stride(0), masks.data_ptr(), counts.data_ptr(), n, r,
                                _stream(dev))
        _check_rc(lib, rc, "diff")
        LAUNCHES["diff"] += 1
    return masks, counts
