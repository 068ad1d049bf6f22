"""Cluster control plane of the torch port: the node (``node``), the
anti-entropy manager (``sync``), replication (``replicator``, ``applier``,
``change_event``, ``transport``, ``transport_mqtt``), peer health and
overload (``health``, ``overload``), the retry policies (``retry``) and the
serving mirror (``mirror``). Copies of the JAX package's ``cluster/``
modules; each docstring says what differs.

A copy of ``merklekv_tpu/cluster/__init__.py``: the package exports the
canonical replication record with its codecs (``change_event``) and the
LWW applier (``applier``).
"""

from merklekv_tpu_torch.cluster.change_event import (
    ChangeEvent,
    OpKind,
    coalesce_events,
    decode_any,
    decode_cbor,
    decode_binary,
    decode_events,
    decode_json,
    encode_batch_cbor,
    encode_cbor,
    encode_binary,
    encode_json,
)
from merklekv_tpu_torch.cluster.applier import LWWApplier

__all__ = [
    "ChangeEvent",
    "OpKind",
    "LWWApplier",
    "coalesce_events",
    "decode_any",
    "decode_cbor",
    "decode_binary",
    "decode_events",
    "decode_json",
    "encode_batch_cbor",
    "encode_cbor",
    "encode_binary",
    "encode_json",
]
