"""Native runtime components.

``_codec``: the C++ framing + snappy codec of ``codec.cc``, built with
g++ at first import into ``build/channeld_tpu_torch/`` at the repository
root (``build_codec``; cached by a hash of the source, the flags and the
Python ABI, one build across concurrent processes). Import ``codec``
from here: it is None when the extension cannot be built or loaded (no
g++, no libsnappy.so.1, no Python headers), the reason is logged once,
and callers fall back to the pure-Python path in protocol/framing.py,
as the JAX package's callers do when its codec is not built.

``kcp_peer.cc``: a standalone KCP wire peer for interop tests, built by
``build_kcp_peer``.
"""

from __future__ import annotations

import fcntl
import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sysconfig
from pathlib import Path

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


codec = _load_codec()

__all__ = ["codec", "build_codec", "build_kcp_peer"]
