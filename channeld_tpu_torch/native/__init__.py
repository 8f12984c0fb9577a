"""Native runtime components.

``_codec``: the C++ framing + snappy codec of ``codec.cc``, built with
g++ at first use of ``codec`` into ``build/channeld_tpu_torch/`` at the
repository root (``build_codec``; cached by a hash of the source, the
flags and the Python ABI, one build across concurrent processes). Import
``codec`` from here: it is None when the extension cannot be built or
loaded (no g++, no libsnappy.so.1, no Python headers), the reason is
logged once, and callers fall back to the pure-Python path in
protocol/framing.py, as the JAX package's callers do when its codec is
not built.

``step_columns.cc``: a StepRequest's position updates decoded from its
wire bytes into two columns, for the sidecar's ingest
(``load_step_columns``; plain C, loaded with ctypes, so it needs neither
snappy nor Python headers).

``kcp_peer.cc``: a standalone KCP wire peer for interop tests, built by
``build_kcp_peer``.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sysconfig
from pathlib import Path

import numpy as np

from ..utils.logger import get_logger

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parents[1] / "build" / "channeld_tpu_torch"
CODEC_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")
CODEC_LIBS = ("-l:libsnappy.so.1", "-L/usr/lib/x86_64-linux-gnu")
PEER_FLAGS = ("-O2", "-std=c++17")


def _build(source: str, name: str, suffix: str, flags: tuple, libs: tuple = ()) -> Path:
    """Compile ``source`` (in this directory) with g++ into BUILD_DIR,
    once per hash of the source and the command, under a file lock.
    Raises OSError when g++ cannot run and RuntimeError with the
    compiler's output when the build fails."""
    h = hashlib.sha256(" ".join(("g++", *flags, source, *libs)).encode())
    h.update((SRC_DIR / source).read_bytes())
    out = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}{suffix}"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            argv = ["g++", *flags, str(SRC_DIR / source), *libs, "-o", str(tmp)]
            proc = subprocess.run(argv, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ exit {proc.returncode}: {proc.stderr.strip()[-2000:]}")
            os.replace(tmp, out)
    return out


def build_codec() -> Path:
    """The ``_codec`` extension built from ``codec.cc`` (see ``_build``)."""
    flags = (*CODEC_FLAGS, f"-I{sysconfig.get_paths()['include']}")
    return _build("codec.cc", "_codec", sysconfig.get_config_var("EXT_SUFFIX"), flags, CODEC_LIBS)


def build_kcp_peer() -> Path:
    """The ``kcp_peer`` binary built from ``kcp_peer.cc`` (see ``_build``)."""
    return _build("kcp_peer.cc", "kcp_peer", "", PEER_FLAGS)


def build_step_columns() -> Path:
    """The shared library built from ``step_columns.cc`` (see ``_build``),
    with the codec's flags and no include path or library."""
    return _build("step_columns.cc", "step_columns", ".so", CODEC_FLAGS)


@functools.cache
def load_step_columns():
    """The decoder of ``step_columns.cc``, built and loaded once per
    process: ``decode(buf, cap)`` returns ``(ids u32[k], xyz f32[k, 3])``
    for the position updates of a serialized StepRequest, or None when
    the bytes are malformed or hold more than ``cap`` updates. None in
    place of the decoder when the library cannot be built or loaded (the
    reason is logged)."""
    try:
        lib = ctypes.CDLL(str(build_step_columns()))
    except (OSError, RuntimeError) as e:
        get_logger("native").warning(
            "step columns not built (%s); the sidecar reads its updates field by field", e)
        return None
    fn = lib.chtpu_step_columns
    fn.argtypes = (ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64)
    fn.restype = ctypes.c_int64

    def decode(buf: bytes, cap: int):
        ids = np.empty(cap, np.uint32)
        xyz = np.empty((cap, 3), np.float32)
        k = fn(buf, len(buf), ids.ctypes.data, xyz.ctypes.data, cap)
        if k < 0:
            return None
        return ids[:k], xyz[:k]

    return decode


def _load_codec():
    try:
        path = build_codec()
        name = f"{__name__}._codec"
        loader = importlib.machinery.ExtensionFileLoader(name, str(path))
        spec = importlib.util.spec_from_file_location(name, str(path), loader=loader)
        module = importlib.util.module_from_spec(spec)
        loader.exec_module(module)
        return module
    except (OSError, RuntimeError, ImportError) as e:
        get_logger("native").warning(
            "native codec not built (%s); framing takes the pure-Python path", e)
        return None


def __getattr__(name: str):
    # ``codec`` is built at its first use, so that importing this package
    # for another of its libraries costs no codec build.
    if name == "codec":
        global codec
        codec = _load_codec()
        return codec
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["codec", "build_codec", "build_kcp_peer", "build_step_columns", "load_step_columns"]
