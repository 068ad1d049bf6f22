"""Batched SHA-256: plain PyTorch versions (``sha256``), the CUDA kernels
(``sha256_cuda``), and the device-based dispatch between them (``dispatch``).

A copy of ``merklekv_tpu/ops/__init__.py``: the package exports the plain
``sha256`` functions. The kernels' modules are imported on demand, so
importing this package builds nothing and loads no compiler.
"""

from merklekv_tpu_torch.ops.sha256 import (
    sha256_blocks,
    sha256_node_pairs,
    sha256_single_block,
)

__all__ = [
    "sha256_blocks",
    "sha256_node_pairs",
    "sha256_single_block",
]
