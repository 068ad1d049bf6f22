"""Peaks of one NVIDIA H100 SXM and the least time each layer's work needs.

Peaks, with their sources:

- HBM3 bandwidth 3.35 TB/s: NVIDIA's H100 SXM data sheet.
- INT32 rate 16.7 Tops/s, DERIVED: shifts and logic run only on the 64
  INT32 lanes of an SM, 132 SMs x 64 lanes x 1.98 GHz boost clock (half the
  FP32 lanes behind the data sheet's 67 TFLOP/s float32 figure).
- Issue rate 33.5 T thread-ops/s, DERIVED: adds can issue to the FMA pipe
  as IMAD, so they count only against the issue rate, 4 warp instructions
  per SM per clock, 132 x 128 x 1.98 GHz.

These rates assume the card's full 700 W; the harness prints the card's
``power.limit`` beside every share.

Least instruction counts per SHA-256 compression with 3-input LOP3/IADD3
fusion: a message block is 64 x (6 SHF + 4 LOP3) + 48 x (6 SHF + 2 LOP3)
shift/logic ops plus 64 x 4 + 48 x 2 + 8 adds. (The arithmetic and the
constants are those of ``chip_smoke.py``'s bound, copied here so that the
program cannot move the yardstick.)
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
ISSUE_OPS_PER_S = 132 * 128 * 1.98e9
LOGIC_MSG_BLOCK = 64 * 10 + 48 * 8
ADDS_MSG_BLOCK = 64 * 4 + 48 * 2 + 8


def bound_s(nbytes: float, logic: float = 0.0, adds: float = 0.0) -> tuple[float, str]:
    """(least seconds, "bytes" or "operations") for work of ``nbytes`` moved
    and ``logic`` shift/logic plus ``adds`` add thread-operations."""
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = max(logic / INT32_OPS_PER_S, (logic + adds) / ISSUE_OPS_PER_S)
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def leaf_work(n_leaves: int, blocks_per_leaf: int) -> dict:
    """Leaf hashing of n leaves of B blocks each: every block read once, one
    count per leaf read, one 32-byte digest written; B compressions a leaf."""
    comp = n_leaves * blocks_per_leaf
    return {"bytes": n_leaves * (blocks_per_leaf * 64 + 4 + 32),
            "logic": comp * LOGIC_MSG_BLOCK, "adds": comp * ADDS_MSG_BLOCK}


def diff_work(replicas: int, keys: int) -> dict:
    """The N-replica diff: digests (32 B) and presence (1 B) of every replica
    and key read once, the [R, N] masks and R int32 counts written once."""
    return {"bytes": replicas * keys * (32 + 1 + 1) + 4 * replicas, "logic": 0, "adds": 0}


def roofline_pct(work: dict, seconds: float) -> tuple[float, str]:
    """(share of the roofline in %, what bounds it) of work done in
    ``seconds``."""
    least, by = bound_s(work["bytes"], work["logic"], work["adds"])
    return 100.0 * least / seconds, by


def gpu_lines() -> list[str]:
    """``name, power.limit`` of each card, as nvidia-smi reads them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    if out.returncode != 0:
        return [f"nvidia-smi failed: {out.stderr.strip()}"]
    return [line.strip() for line in out.stdout.strip().splitlines()]
