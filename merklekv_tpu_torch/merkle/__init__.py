"""Merkle hash-tree core of the torch port.

``encoding`` pins the byte-level hash spec; ``cpu`` and ``cpu_state`` are the
golden host implementations; ``torch_engine``, ``diff`` and ``incremental``
run on torch tensors through ``merklekv_tpu_torch.ops.dispatch``.

A copy of ``merklekv_tpu/merkle/__init__.py``: the package exports the hash
spec and the golden tree.
"""

from merklekv_tpu_torch.merkle.encoding import (
    EMPTY_ROOT_HEX,
    encode_leaf,
    leaf_hash,
    node_hash,
)
from merklekv_tpu_torch.merkle.cpu import MerkleTree, build_levels, root_from_leaf_hashes

__all__ = [
    "EMPTY_ROOT_HEX",
    "encode_leaf",
    "leaf_hash",
    "node_hash",
    "MerkleTree",
    "build_levels",
    "root_from_leaf_hashes",
]
