"""Native runtime components.

``_codec``: C++ framing + snappy codec (build with scripts/build_native.sh).
Import ``codec`` from here; it is None when the extension isn't built, and
callers fall back to the pure-Python path in protocol/framing.py.
"""

try:
    from . import _codec as codec  # type: ignore[attr-defined]
except ImportError:
    codec = None

__all__ = ["codec"]
