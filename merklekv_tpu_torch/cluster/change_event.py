"""Canonical replication record + wire codecs.

A copy of ``merklekv_tpu/cluster/change_event.py``, its imports pointed at the port's modules.

Schema matches the reference ChangeEvent
(the reference's src/change_event.rs:59-79):
  {v: u16, op, key: str, val: Optional[bytes], ts: u64 (ns), src: str,
   op_id: 16 bytes (uuid4), prev: Optional[32 bytes], ttl: Optional[u64]}
`val` carries the POST-OP result so application is idempotent
(change_event.rs:17-19).

Codecs (change_event.rs:127-172 analog): CBOR is the wire default; a compact
length-prefixed binary format stands in for bincode; JSON (base64 for bytes)
for debuggability. ``decode_any`` tries CBOR -> binary -> JSON. The CBOR
encoder below emits standard definite-length RFC 8949 items (maps with text
keys, uints, byte/text strings, null), so third-party CBOR tooling can read
events off the wire.

Batch framing: a drained replication batch travels as ONE versioned CBOR
envelope ``{v, src, events: [...]}`` (``encode_batch_cbor``) instead of one
publish per event — the publisher coalesces per key first
(``coalesce_events``: every event carries its post-op value, so the last
SET/DEL per key alone reproduces that key's final state). Receivers use
``decode_events``, which accepts both the envelope and every legacy
single-event format, so mixed-version clusters stay wire-compatible: an
old publisher's single events keep applying here, while an old subscriber
counts a new publisher's envelopes as decode errors and anti-entropy
repairs what it missed (see docs/PROTOCOL.md "Replication framing").
"""

from __future__ import annotations

import base64
import json
import struct
import time
import uuid
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

__all__ = [
    "OpKind",
    "ChangeEvent",
    "BATCH_ENVELOPE_VERSION",
    "coalesce_events",
    "encode_cbor",
    "decode_cbor",
    "encode_batch_cbor",
    "encode_binary",
    "decode_binary",
    "encode_json",
    "decode_json",
    "decode_any",
    "decode_events",
    "decode_events_meta",
]


class OpKind(str, Enum):
    SET = "set"
    DEL = "del"
    INCR = "incr"
    DECR = "decr"
    APPEND = "append"
    PREPEND = "prepend"
    # Local extension: staged by the native server for device-mirror
    # invalidation; never published on the wire (the reference replicates
    # only the six ops above, replication.rs:197-254).
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


# ------------------------------------------------------------------ CBOR

def _cbor_head(major: int, arg: int) -> bytes:
    if arg < 24:
        return bytes([(major << 5) | arg])
    if arg < 0x100:
        return bytes([(major << 5) | 24, arg])
    if arg < 0x10000:
        return bytes([(major << 5) | 25]) + struct.pack(">H", arg)
    if arg < 0x100000000:
        return bytes([(major << 5) | 26]) + struct.pack(">I", arg)
    return bytes([(major << 5) | 27]) + struct.pack(">Q", arg)


def _cbor_uint(v: int) -> bytes:
    return _cbor_head(0, v)


def _cbor_bytes(b: bytes) -> bytes:
    return _cbor_head(2, len(b)) + b


def _cbor_text(s: str) -> bytes:
    e = s.encode("utf-8")
    return _cbor_head(3, len(e)) + e


def _cbor_text_or_bytes(s: str) -> bytes:
    """Key/src fields: a valid-UTF-8 string is a standard text item; a
    surrogateescape-decoded raw key (non-UTF-8 wire bytes, from
    replicator._to_event) is emitted as a BYTE string — RFC 8949 requires
    text items to be valid UTF-8, and smuggling raw bytes into one would
    make strict third-party decoders drop the whole event."""
    try:
        e = s.encode("utf-8")
        return _cbor_head(3, len(e)) + e
    except UnicodeEncodeError:
        return _cbor_bytes(s.encode("utf-8", "surrogateescape"))


_CBOR_NULL = b"\xf6"


def _event_map_cbor(ev: ChangeEvent, include_src: bool = True) -> bytes:
    """One event as a CBOR map. Inside a batch envelope ``src`` is carried
    once on the envelope, so per-event maps omit it (include_src=False)."""
    pairs = [
        (b"\x61v", _cbor_uint(ev.v)),
        (b"\x62op", _cbor_text(ev.op.value)),
        (b"\x63key", _cbor_text_or_bytes(ev.key)),
        (b"\x63val", _CBOR_NULL if ev.val is None else _cbor_bytes(ev.val)),
        (b"\x62ts", _cbor_uint(ev.ts)),
    ]
    if include_src:
        pairs.append((b"\x63src", _cbor_text_or_bytes(ev.src)))
    pairs += [
        (b"\x65op_id", _cbor_bytes(ev.op_id)),
        (b"\x64prev", _CBOR_NULL if ev.prev is None else _cbor_bytes(ev.prev)),
        (b"\x63ttl", _CBOR_NULL if ev.ttl is None else _cbor_uint(ev.ttl)),
    ]
    out = _cbor_head(5, len(pairs))
    for k, v in pairs:
        out += k + v
    return out


def encode_cbor(ev: ChangeEvent) -> bytes:
    return _event_map_cbor(ev)


# ------------------------------------------------------------ batch frame

# Version of the batch envelope FORMAT (distinct from the per-event v
# field): receivers refuse unknown versions loudly instead of misapplying
# half-understood frames.
BATCH_ENVELOPE_VERSION = 1


def coalesce_events(
    events: list[ChangeEvent],
) -> tuple[list[ChangeEvent], int]:
    """Per-key coalescing for one wire frame: a later SET/DEL on a key
    supersedes every earlier op on it — safe because events carry POST-OP
    values, so the last event alone reproduces the key's final state (and
    receivers are per-key LWW anyway). Returns (kept events in stable
    order, number coalesced away)."""
    last: dict[str, int] = {}
    for i, ev in enumerate(events):
        last[ev.key] = i
    kept = [ev for i, ev in enumerate(events) if last[ev.key] == i]
    return kept, len(events) - len(kept)


def encode_batch_cbor(
    events: list[ChangeEvent],
    src: str,
    hwm_seq: Optional[int] = None,
    hwm_ts: Optional[int] = None,
    trace: Optional[str] = None,
) -> bytes:
    """Batch envelope ``{v, src, events: [...]}``: one wire frame for a
    whole drained batch. ``src`` rides on the envelope once; per-event maps
    omit it (the decoder reinstates it).

    Optional additive fields (same envelope version — old decoders ignore
    unknown map keys):

    - ``hseq``/``hts``: the publisher's **publish high-water mark** —
      cumulative events put on the wire INCLUDING this frame, and the
      publish wall clock (unix ns). Appliers derive per-peer
      ``replication.lag_events`` / ``replication.lag_ms`` from them
      (obs/lag.py).
    - ``tc``: a causal trace-context token (obs/tracewire.py) so a traced
      write's replication apply stitches into the originating trace.
    """
    body = bytearray(_cbor_head(4, len(events)))
    for ev in events:
        body += _event_map_cbor(ev, include_src=False)
    extra: list[tuple[bytes, bytes]] = []
    if hwm_seq is not None:
        extra.append((b"\x64hseq", _cbor_uint(hwm_seq)))
    if hwm_ts is not None:
        extra.append((b"\x63hts", _cbor_uint(hwm_ts)))
    if trace:
        extra.append((b"\x62tc", _cbor_text(trace)))
    out = bytearray(_cbor_head(5, 3 + len(extra)))
    out += b"\x61v" + _cbor_uint(BATCH_ENVELOPE_VERSION)
    out += b"\x63src" + _cbor_text_or_bytes(src)
    for k, v in extra:
        out += k + v
    out += b"\x66events" + bytes(body)
    return bytes(out)


class _CborReader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated CBOR")
        b = self.data[self.pos : self.pos + n]
        self.pos += n
        return b

    def _head(self) -> tuple[int, int]:
        b = self._take(1)[0]
        major, info = b >> 5, b & 0x1F
        if info < 24:
            return major, info
        if info == 24:
            return major, self._take(1)[0]
        if info == 25:
            return major, struct.unpack(">H", self._take(2))[0]
        if info == 26:
            return major, struct.unpack(">I", self._take(4))[0]
        if info == 27:
            return major, struct.unpack(">Q", self._take(8))[0]
        raise ValueError(f"unsupported CBOR info {info}")

    def item(self):
        start = self.pos
        b = self.data[self.pos] if self.pos < len(self.data) else None
        if b is None:
            raise ValueError("truncated CBOR")
        if b == 0xF6:  # null
            self.pos += 1
            return None
        if b == 0xF4:
            self.pos += 1
            return False
        if b == 0xF5:
            self.pos += 1
            return True
        major, arg = self._head()
        if major == 0:
            return arg
        if major == 1:
            return -1 - arg
        if major == 2:
            return self._take(arg)
        if major == 3:
            # Lenient on inbound text (a peer's corrupt bytes degrade to a
            # representable key instead of killing the decode); our own
            # emitter never produces invalid text items (_cbor_text_or_bytes).
            return self._take(arg).decode("utf-8", "surrogateescape")
        if major == 4:
            return [self.item() for _ in range(arg)]
        if major == 5:
            return {self.item(): self.item() for _ in range(arg)}
        raise ValueError(f"unsupported CBOR major {major} at {start}")


def decode_cbor(data: bytes) -> ChangeEvent:
    reader = _CborReader(data)
    m = reader.item()
    if not isinstance(m, dict):
        raise ValueError("CBOR event must be a map")
    return _from_map(m)


def _as_key_str(x) -> str:
    """key/src arrive as text items, or byte strings for non-UTF-8 keys
    (see _cbor_text_or_bytes); both normalize to the surrogateescape str
    form the rest of the pipeline uses."""
    if isinstance(x, (bytes, bytearray)):
        return bytes(x).decode("utf-8", "surrogateescape")
    return x


def _from_map(m: dict) -> ChangeEvent:
    val = m.get("val")
    if val is not None and not isinstance(val, (bytes, bytearray)):
        # A corrupt frame can decode "val" into a non-bytes CBOR item;
        # letting it through would blow up deep in the applier's FFI
        # instead of at the decode boundary where errors are counted.
        raise ValueError(f"event val must be bytes, got {type(val).__name__}")
    try:
        return ChangeEvent(
            v=int(m["v"]),
            op=OpKind(m["op"]),
            key=_as_key_str(m["key"]),
            val=None if val is None else bytes(val),
            ts=int(m["ts"]),
            src=_as_key_str(m["src"]),
            op_id=bytes(m["op_id"]),
            prev=None if m.get("prev") is None else bytes(m["prev"]),
            ttl=None if m.get("ttl") is None else int(m["ttl"]),
        )
    except (KeyError, TypeError) as e:
        raise ValueError(f"malformed event map: {e}") from e


# ---------------------------------------------------------------- binary

_BIN_MAGIC = b"MKB1"


def encode_binary(ev: ChangeEvent) -> bytes:
    """Compact fixed-order binary codec (bincode-role analog)."""
    key = ev.key.encode("utf-8", "surrogateescape")
    src = ev.src.encode("utf-8", "surrogateescape")
    out = bytearray(_BIN_MAGIC)
    op_code = list(OpKind).index(ev.op)
    out += struct.pack("<HBQ", ev.v, op_code, ev.ts)
    out += struct.pack("<I", len(key)) + key
    out += struct.pack("<I", len(src)) + src
    out += ev.op_id
    if ev.val is None:
        out += b"\x00"
    else:
        out += b"\x01" + struct.pack("<I", len(ev.val)) + ev.val
    out += b"\x00" if ev.prev is None else b"\x01" + ev.prev
    out += b"\x00" if ev.ttl is None else b"\x01" + struct.pack("<Q", ev.ttl)
    return bytes(out)


def decode_binary(data: bytes) -> ChangeEvent:
    if data[:4] != _BIN_MAGIC:
        raise ValueError("bad magic")
    pos = 4

    def take(n: int) -> bytes:
        nonlocal pos
        if pos + n > len(data):
            raise ValueError("truncated binary event")
        b = data[pos : pos + n]
        pos += n
        return b

    v, op_code, ts = struct.unpack("<HBQ", take(11))
    (klen,) = struct.unpack("<I", take(4))
    key = take(klen).decode("utf-8", "surrogateescape")
    (slen,) = struct.unpack("<I", take(4))
    src = take(slen).decode("utf-8", "surrogateescape")
    op_id = take(16)
    val = None
    if take(1) == b"\x01":
        (vlen,) = struct.unpack("<I", take(4))
        val = take(vlen)
    prev = take(32) if take(1) == b"\x01" else None
    ttl = struct.unpack("<Q", take(8))[0] if take(1) == b"\x01" else None
    return ChangeEvent(v=v, op=list(OpKind)[op_code], key=key, val=val,
                       ts=ts, src=src, op_id=op_id, prev=prev, ttl=ttl)


# ------------------------------------------------------------------ JSON

def encode_json(ev: ChangeEvent) -> bytes:
    def b64(b: Optional[bytes]):
        return None if b is None else base64.b64encode(b).decode()

    return json.dumps(
        {
            "v": ev.v,
            "op": ev.op.value,
            "key": ev.key,
            "val": b64(ev.val),
            "ts": ev.ts,
            "src": ev.src,
            "op_id": b64(ev.op_id),
            "prev": b64(ev.prev),
            "ttl": ev.ttl,
        },
        separators=(",", ":"),
    ).encode("utf-8")


def decode_json(data: bytes) -> ChangeEvent:
    m = json.loads(data.decode("utf-8"))
    if not isinstance(m, dict):
        raise ValueError("JSON event must be an object")

    def u64(x):
        return None if x is None else base64.b64decode(x)

    m = dict(m)
    m["val"] = u64(m.get("val"))
    m["op_id"] = u64(m.get("op_id"))
    m["prev"] = u64(m.get("prev"))
    return _from_map(m)


def decode_any(data: bytes) -> ChangeEvent:
    """CBOR -> binary -> JSON, like the reference's decode_any
    (change_event.rs:159-172)."""
    for dec in (decode_cbor, decode_binary, decode_json):
        try:
            return dec(data)
        except Exception:
            continue
    raise ValueError("undecodable change event")


def _events_from_envelope(m: dict) -> list[ChangeEvent]:
    v = m.get("v")
    if v != BATCH_ENVELOPE_VERSION:
        raise ValueError(f"unsupported batch envelope version {v!r}")
    evs = m.get("events")
    if not isinstance(evs, list):
        raise ValueError("batch envelope 'events' must be an array")
    src = _as_key_str(m.get("src", ""))
    out = []
    for em in evs:
        if not isinstance(em, dict):
            raise ValueError("batch envelope event must be a map")
        if "src" not in em:
            em = dict(em)
            em["src"] = src
        out.append(_from_map(em))
    return out


def decode_events(data: bytes) -> list[ChangeEvent]:
    """Replication inbound decode: a batch envelope yields its events; any
    legacy single-event payload (CBOR/binary/JSON) yields a one-event list
    — old publishers stay wire-compatible with batching subscribers.
    Raises ValueError for undecodable frames AND for envelopes of an
    unknown version or malformed shape (a half-understood frame must be
    counted and dropped whole, never partially applied)."""
    events, _meta = decode_events_meta(data)
    return events


def decode_events_meta(data: bytes) -> tuple[list[ChangeEvent], dict]:
    """``decode_events`` plus the envelope's additive metadata: ``src``,
    the publish high-water mark (``hseq``/``hts``) and the causal trace
    token (``tc``) when present. Legacy single-event payloads yield the
    event's own ``src`` and no HWM."""
    m = None
    try:
        m = _CborReader(data).item()
    except Exception:
        pass
    if isinstance(m, dict) and "events" in m:
        events = _events_from_envelope(m)
        meta: dict = {"src": _as_key_str(m.get("src", ""))}
        if isinstance(m.get("hseq"), int):
            meta["hseq"] = m["hseq"]
        if isinstance(m.get("hts"), int):
            meta["hts"] = m["hts"]
        tc = m.get("tc")
        if isinstance(tc, str):
            meta["tc"] = tc
        return events, meta
    ev = decode_any(data)
    return [ev], {"src": ev.src}
