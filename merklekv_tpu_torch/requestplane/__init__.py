"""Production request plane: pipelined epoll router + hot-key read leases.

A copy of ``merklekv_tpu/requestplane/__init__.py``, its imports pointed at the
port's modules.

One address in front of a partitioned cluster, built with the same I/O
discipline as the native serving plane (fixed io-worker pool, full
client pipelining, writev-coalesced bursts), per-partition pipelined
upstream pools with concurrent fan-out, bounded MOVED/BUSY healing, and
an optional lease-guarded read cache invalidated straight off the
replication topics. See router.py for the architecture tour and
docs/PROTOCOL.md "Router semantics" for the wire contract.
"""

from merklekv_tpu_torch.requestplane.cache import LEAD, MISS, WAIT, LeaseCache
from merklekv_tpu_torch.requestplane.invalidation import InvalidationFeed
from merklekv_tpu_torch.requestplane.router import RequestPlaneRouter, main

__all__ = [
    "LeaseCache",
    "InvalidationFeed",
    "RequestPlaneRouter",
    "main",
    "MISS",
    "WAIT",
    "LEAD",
]
