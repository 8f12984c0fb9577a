"""Snappy block-format codec via the system C library.

The wire protocol optionally compresses each packet with snappy
(ref: pkg/channeld/connection.go:497-516, CompressionType.SNAPPY).
python-snappy isn't available in this image, but libsnappy.so.1 is, and
its C API (snappy-c.h) is a stable ABI — we bind it with ctypes. The
native C++ codec extension (channeld_tpu/native) links the same library
for the batched hot path.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    for name in ("libsnappy.so.1", "libsnappy.so", ctypes.util.find_library("snappy")):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.snappy_compress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.snappy_compress.restype = ctypes.c_int
        lib.snappy_uncompress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.snappy_uncompress.restype = ctypes.c_int
        lib.snappy_max_compressed_length.argtypes = [ctypes.c_size_t]
        lib.snappy_max_compressed_length.restype = ctypes.c_size_t
        lib.snappy_uncompressed_length.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.snappy_uncompressed_length.restype = ctypes.c_int
        _lib = lib
        return lib
    return None


def available() -> bool:
    return _load() is not None


def compress(data: bytes) -> bytes:
    lib = _load()
    if lib is None:
        raise RuntimeError("snappy library not available")
    out_len = ctypes.c_size_t(lib.snappy_max_compressed_length(len(data)))
    out = ctypes.create_string_buffer(out_len.value)
    status = lib.snappy_compress(data, len(data), out, ctypes.byref(out_len))
    if status != 0:
        raise RuntimeError(f"snappy_compress failed: {status}")
    return out.raw[: out_len.value]


# A frame body is capped at 64KB before compression (see framing.MAX_PACKET_SIZE),
# so no legitimate frame decompresses past a small multiple of that. Without
# this cap a <=64KB frame whose varint preamble claims ~4GiB would trigger a
# ~4GiB allocation per frame, pre-auth.
MAX_UNCOMPRESSED_SIZE = 4 * 0xFFFF


def uncompress(data: bytes, max_len: int = MAX_UNCOMPRESSED_SIZE) -> bytes:
    lib = _load()
    if lib is None:
        raise RuntimeError("snappy library not available")
    out_len = ctypes.c_size_t()
    if lib.snappy_uncompressed_length(data, len(data), ctypes.byref(out_len)) != 0:
        raise ValueError("corrupt snappy data (bad length preamble)")
    if out_len.value > max_len:
        raise ValueError(
            f"snappy uncompressed length {out_len.value} exceeds cap {max_len}"
        )
    out = ctypes.create_string_buffer(out_len.value)
    if lib.snappy_uncompress(data, len(data), out, ctypes.byref(out_len)) != 0:
        raise ValueError("corrupt snappy data")
    return out.raw[: out_len.value]
