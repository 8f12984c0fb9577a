"""Read and write the repo's hand-maintained ``*_pb2.py`` modules.

The committed pb2 modules are protoc-format: a serialized
``FileDescriptorProto`` blob passed to ``AddSerializedFile`` plus the
``_serialized_start/_end`` offset table.  With no protoc in the image
they are regenerated by hand, so two tools need to handle them without
importing them (importing would collide with the already-loaded default
descriptor pool, and the drift checker must be able to inspect a
*wrong* pb2 without executing it):

- :func:`extract_serialized_pb` pulls the descriptor blob out of pb2
  *source text* via the AST — safe on arbitrary (even drifted) input.
- :func:`emit_pb2_module` renders a complete pb2 module from a
  ``FileDescriptorProto``, byte-compatible with the committed format
  (``scripts/regen_pb2.py`` drives it; ``tests/test_analysis.py``
  round-trips every protocol schema through it).
"""

from __future__ import annotations

import ast

from google.protobuf import descriptor_pb2


class Pb2ExtractError(Exception):
    pass


def extract_serialized_pb(pb2_source: str, name: str = "<pb2>") -> bytes:
    """The ``AddSerializedFile`` bytes argument of a pb2 module, found
    statically (the module is never imported/executed)."""
    try:
        tree = ast.parse(pb2_source)
    except SyntaxError as e:
        raise Pb2ExtractError(f"{name}: not parseable python ({e})")
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "AddSerializedFile"
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, bytes)
        ):
            return node.args[0].value
    raise Pb2ExtractError(f"{name}: no AddSerializedFile(b'...') call found")


def parse_pb2_descriptor(
    pb2_source: str, name: str = "<pb2>"
) -> descriptor_pb2.FileDescriptorProto:
    blob = extract_serialized_pb(pb2_source, name)
    fdp = descriptor_pb2.FileDescriptorProto()
    fdp.ParseFromString(blob)
    return fdp


def carry_over_json_names(
    fdp: descriptor_pb2.FileDescriptorProto,
    committed: descriptor_pb2.FileDescriptorProto,
) -> None:
    """Copy explicit ``json_name`` cosmetics from a committed descriptor
    onto a freshly built one (matched by message path + field name).

    protoc omits ``json_name`` when it is derivable from the field name;
    the repo's hand-regenerated descriptors carry it explicitly on
    hand-added fields.  Preserving the existing bytes keeps a regen
    diff-free for untouched messages.
    """
    def index(fdp):
        fields = {}

        def walk(msg, prefix):
            path = f"{prefix}.{msg.name}"
            for f in msg.field:
                fields[(path, f.name)] = f
            for n in msg.nested_type:
                walk(n, path)

        for m in fdp.message_type:
            walk(m, "")
        return fields

    ours = index(fdp)
    for key, theirs in index(committed).items():
        if theirs.HasField("json_name") and key in ours:
            ours[key].json_name = theirs.json_name


# ---------------------------------------------------------------------------
# module emission (protoc 3.20-era _builder layout, matching the repo)
# ---------------------------------------------------------------------------

def _import_line(dep: str) -> str:
    """The protoc import line for one .proto dependency."""
    base = dep[:-len(".proto")] if dep.endswith(".proto") else dep
    alias = base.replace("_", "__").replace("/", "_dot_") + "__pb2"
    parts = base.split("/")
    package = ".".join(parts[:-1])
    module = parts[-1] + "_pb2"
    return f"from {package} import {module} as {alias}"


def _offset_lines(fdp: descriptor_pb2.FileDescriptorProto) -> list[str]:
    """``_NAME._serialized_start/_end`` lines in protoc order: top-level
    enums first, then messages preorder with nested types after their
    parent."""
    blob = fdp.SerializeToString()
    lines: list[str] = []

    def locate(sub: bytes, search_from: int) -> tuple[int, int]:
        start = blob.find(sub, search_from)
        if start < 0:
            raise Pb2ExtractError(
                f"{fdp.name}: could not locate a sub-descriptor in the "
                "serialized file (non-canonical serialization?)"
            )
        return start, start + len(sub)

    def emit(sym: str, sub: bytes, search_from: int) -> int:
        start, end = locate(sub, search_from)
        lines.append(f"  _{sym}._serialized_start={start}")
        lines.append(f"  _{sym}._serialized_end={end}")
        return start

    def walk_message(msg, sym_prefix: str, search_from: int) -> None:
        sym = f"{sym_prefix}{msg.name.upper()}"
        start = emit(sym, msg.SerializeToString(), search_from)
        for nested in msg.nested_type:
            walk_message(nested, f"{sym}_", start)
        for enum in msg.enum_type:
            emit(f"{sym}_{enum.name.upper()}", enum.SerializeToString(),
                 start)

    for enum in fdp.enum_type:
        emit(enum.name.upper(), enum.SerializeToString(), 0)
    for msg in fdp.message_type:
        walk_message(msg, "", 0)
    return lines


def emit_pb2_module(
    fdp: descriptor_pb2.FileDescriptorProto, module_name: str
) -> str:
    """Render a complete ``*_pb2.py`` module (text) for ``fdp``.

    ``module_name`` is the dotted python module the file will live at,
    e.g. ``channeld_tpu.protocol.wire_pb2``.
    """
    blob = fdp.SerializeToString()
    imports = "".join(f"{_import_line(dep)}\n" for dep in fdp.dependency)
    offsets = "".join(f"{line}\n" for line in _offset_lines(fdp))
    return (
        "# -*- coding: utf-8 -*-\n"
        "# Generated by the protocol buffer compiler.  DO NOT EDIT!\n"
        f"# source: {fdp.name}\n"
        '"""Generated protocol buffer code."""\n'
        "from google.protobuf.internal import builder as _builder\n"
        "from google.protobuf import descriptor as _descriptor\n"
        "from google.protobuf import descriptor_pool as _descriptor_pool\n"
        "from google.protobuf import symbol_database as _symbol_database\n"
        "# @@protoc_insertion_point(imports)\n"
        "\n"
        "_sym_db = _symbol_database.Default()\n"
        "\n"
        "\n"
        f"{imports}"
        "\n"
        "\n"
        f"DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile({blob!r})\n"
        "\n"
        "_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())\n"
        f"_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, "
        f"{module_name!r}, globals())\n"
        "if _descriptor._USE_C_DESCRIPTORS == False:\n"
        "\n"
        "  DESCRIPTOR._options = None\n"
        f"{offsets}"
        "# @@protoc_insertion_point(module_scope)\n"
    )
