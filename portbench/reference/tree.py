"""The MerkleKV tree and N-replica diff, written plainly.

Tree (``src/store/merkle.rs`` of the upstream project): leaves are the
SHA-256 of each record in sorted key order; a parent is SHA256(left ||
right); a level of odd size promotes its last node unchanged to the next
level. The root is the one node of the top level.

Diff: key i diverges in replica r iff its presence differs from replica
0's, or both hold it with digests that differ in any of the 8 words.
"""

from __future__ import annotations

import torch

from portbench.reference.sha256 import node_hash


def level_sizes(n: int) -> list[int]:
    sizes = [n]
    while sizes[-1] > 1:
        sizes.append((sizes[-1] + 1) // 2)
    return sizes


def tree_levels(leaves: torch.Tensor) -> list[torch.Tensor]:
    """Every level of the tree over [N, 8] leaf digests, bottom-up."""
    levels = [leaves]
    cur = leaves
    while cur.shape[0] > 1:
        p = cur.shape[0] // 2
        nxt = node_hash(cur[0:2 * p:2], cur[1:2 * p:2])
        if cur.shape[0] % 2:
            nxt = torch.cat([nxt, cur[-1:]])
        levels.append(nxt)
        cur = nxt
    return levels


def tree_root(leaves: torch.Tensor) -> torch.Tensor:
    """[8] root over [N >= 1, 8] leaf digests."""
    return tree_levels(leaves)[-1][0]


def padded_levels(leaves: torch.Tensor) -> list[torch.Tensor]:
    """The levels of a power-of-two tree whose empty slots hold zero
    digests: the tree WITHOUT the odd-promotion rule. Its root equals
    ``tree_root``'s only when N is a power of two (the mirror's control
    serves it as the broken rule)."""
    n = leaves.shape[0]
    cap = 1 << max(0, (n - 1).bit_length())
    cur = torch.cat([leaves, leaves.new_zeros((cap - n, 8))])
    levels = [cur]
    while cur.shape[0] > 1:
        cur = node_hash(cur[0::2], cur[1::2])
        levels.append(cur)
    return levels


def diff_masks(digests: torch.Tensor, present: torch.Tensor, words: int = 8,
               chunk: int = 1 << 20) -> torch.Tensor:
    """[R, N] bool divergence of every replica against replica 0, from
    [R, N, 8] digests and [R, N] presence, computed ``chunk`` keys at a time.
    ``words`` < 8 compares only that prefix of each digest (the controls'
    shortened digest)."""
    r, n = present.shape
    out = torch.empty((r, n), dtype=torch.bool, device=present.device)
    for lo in range(0, n, chunk):
        d = digests[:, lo:lo + chunk, :words]
        p = present[:, lo:lo + chunk]
        differs = (d != d[0:1]).any(dim=-1)
        out[:, lo:lo + chunk] = (p != p[0:1]) | (p & p[0:1] & differs)
    return out
