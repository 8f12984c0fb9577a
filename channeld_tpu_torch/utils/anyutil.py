"""google.protobuf.Any helpers (pack / resolve-and-unpack).

Mirrors the reference's anypb.New / Any.UnmarshalNew usage: the concrete
type is resolved from the process-wide descriptor pool, so game-defined
channel-data types just need their generated modules imported.
"""

from __future__ import annotations

from google.protobuf import any_pb2, symbol_database
from google.protobuf.message import Message

_sym_db = symbol_database.Default()


def pack_any(msg: Message) -> any_pb2.Any:
    a = any_pb2.Any()
    a.Pack(msg)
    return a


def unpack_any(a: any_pb2.Any) -> Message:
    """Resolve the concrete message type and unpack (ref: UnmarshalNew)."""
    type_name = a.type_url.split("/")[-1]
    cls = _sym_db.GetSymbol(type_name)
    msg = cls()
    if not a.Unpack(msg):
        raise ValueError(f"failed to unpack Any of type {type_name}")
    return msg
