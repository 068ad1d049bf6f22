"""The replication record the serving mirror reads (partial copy of
``merklekv_tpu/cluster/change_event.py:58-103``: ``OpKind`` and
``ChangeEvent``).

`val` carries the POST-OP result so application is idempotent. The mirror
reads only ``op`` and ``key`` (it re-reads each touched key's current value
from the engine). The CBOR, binary and JSON codecs and the batch envelope
wait for the replicator.
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

__all__ = ["OpKind", "ChangeEvent"]


class OpKind(str, Enum):
    SET = "set"
    DEL = "del"
    INCR = "incr"
    DECR = "decr"
    APPEND = "append"
    PREPEND = "prepend"
    # Local extension: staged by the native server for device-mirror
    # invalidation; never published on the wire.
    TRUNCATE = "truncate"


@dataclass
class ChangeEvent:
    op: OpKind
    key: str
    val: Optional[bytes]  # post-op value; None for deletions
    ts: int  # unix nanoseconds (or logical clock); only ordering matters
    src: str  # originating node id (loop prevention)
    op_id: bytes = field(default_factory=lambda: uuid.uuid4().bytes)
    v: int = 1
    prev: Optional[bytes] = None  # optional 32-byte Merkle hash
    ttl: Optional[int] = None

    def __post_init__(self) -> None:
        if len(self.op_id) != 16:
            raise ValueError("op_id must be 16 bytes")
        if self.prev is not None and len(self.prev) != 32:
            raise ValueError("prev must be 32 bytes")

    @classmethod
    def new(
        cls,
        op: OpKind,
        key: str,
        val: Optional[bytes],
        src: str,
        ts: Optional[int] = None,
    ) -> "ChangeEvent":
        return cls(op=op, key=key, val=val, src=src,
                   ts=time.time_ns() if ts is None else ts)
