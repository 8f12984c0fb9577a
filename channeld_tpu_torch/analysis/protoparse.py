"""A pure-python ``.proto`` -> ``FileDescriptorProto`` compiler.

There is no protoc in the image: the committed ``*_pb2.py`` modules are
regenerated *by hand* (historically by editing the serialized descriptor
blob in place — see doc/analysis.md).  That convention is exactly the
kind that silently breaks wire compatibility, so this module gives the
repo a checkable source of truth: it parses the subset of proto3 the
project's schemas use and builds a real
``google.protobuf.descriptor_pb2.FileDescriptorProto`` — byte-for-byte
what protoc would serialize for these files (field-number-ordered
serialization, synthetic oneofs for ``optional`` fields, no json_name
for derivable names).

Consumers:

- ``analysis/rules/proto_drift.py`` diffs the parsed schema against the
  committed pb2 descriptor (drift rule, gated in tier-1).
- ``scripts/regen_pb2.py`` regenerates a pb2 module from the ``.proto``
  (the descriptor-rewrite regen path), round-trip-tested in
  ``tests/test_analysis.py``.

Supported subset (everything under ``channeld_tpu/protocol/``): proto3
syntax, packages, imports, messages (nested), enums (nested and top
level), scalar/message/enum fields, ``repeated`` and proto3
``optional``.  Unsupported constructs (maps, real oneofs, services,
options, extensions) raise ``ProtoParseError`` — extend the parser when
a schema first needs them rather than silently mis-compiling.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field

from google.protobuf import descriptor_pb2


class ProtoParseError(Exception):
    pass


# FieldDescriptorProto.Type values for scalar type names.
SCALAR_TYPES = {
    "double": 1, "float": 2, "int64": 3, "uint64": 4, "int32": 5,
    "fixed64": 6, "fixed32": 7, "bool": 8, "string": 9, "bytes": 12,
    "uint32": 13, "sfixed32": 15, "sfixed64": 16, "sint32": 17,
    "sint64": 18,
}
TYPE_MESSAGE = 11
TYPE_ENUM = 14
LABEL_OPTIONAL = 1
LABEL_REPEATED = 3

# Well-known imports we cannot parse from disk (the runtime ships them
# pre-compiled): import path -> {symbol full name: is_message}.
WELL_KNOWN = {
    "google/protobuf/any.proto": {".google.protobuf.Any": True},
}

_TOKEN_RE = re.compile(
    r'"(?:[^"\\]|\\.)*"'      # string literal
    r"|[A-Za-z_][A-Za-z0-9_.]*"  # identifier / dotted reference
    r"|-?\d+"                  # integer
    r"|[{}=;<>,\[\]()]",       # punctuation
)

# ``msgType N`` claims in the comment block attached to a message: the
# project documents every extension message's wire msgType this way, and
# the drift rule cross-checks the claims against the python registries.
# (\b after "msgType" keeps the plural "msgTypes 30-37" range prose from
# matching — 's' is a word char, so there is no boundary.)
_MSGTYPE_CLAIM_RE = re.compile(r"\bmsgType\s+(\d+)\b")


@dataclass
class ParsedField:
    name: str
    number: int
    label: int
    type: int            # 0 until resolved for named types
    type_ref: str | None  # unresolved reference text, None for scalars
    type_name: str = ""   # resolved full name (".chtpu.X")
    proto3_optional: bool = False
    oneof_index: int | None = None


@dataclass
class ParsedEnum:
    name: str
    full_name: str
    values: list[tuple[str, int]] = field(default_factory=list)


@dataclass
class ParsedMessage:
    name: str
    full_name: str
    fields: list[ParsedField] = field(default_factory=list)
    nested: list["ParsedMessage"] = field(default_factory=list)
    enums: list[ParsedEnum] = field(default_factory=list)
    oneofs: list[str] = field(default_factory=list)
    # msgType numbers claimed by the doc comment attached to this message.
    msgtype_claims: list[int] = field(default_factory=list)


@dataclass
class ParsedFile:
    path: str            # import path, e.g. channeld_tpu/protocol/wire.proto
    package: str
    syntax: str
    imports: list[str] = field(default_factory=list)
    messages: list[ParsedMessage] = field(default_factory=list)
    enums: list[ParsedEnum] = field(default_factory=list)


class _Tokens:
    def __init__(self, text: str, path: str):
        self.toks = _TOKEN_RE.findall(text)
        self.i = 0
        self.path = path

    def peek(self) -> str | None:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str:
        tok = self.peek()
        if tok is None:
            raise ProtoParseError(f"{self.path}: unexpected end of file")
        self.i += 1
        return tok

    def expect(self, want: str) -> str:
        tok = self.next()
        if tok != want:
            raise ProtoParseError(
                f"{self.path}: expected {want!r}, got {tok!r}"
            )
        return tok


def _strip_comments(text: str) -> tuple[str, dict[str, str]]:
    """Remove comments; return (code, {message name: attached comment}).

    The attached comment of a message is the contiguous ``//`` block
    immediately above its ``message X {`` line — where the project
    documents msgType claims.  A blank line detaches a block (section
    banners above a message keep their own claims to themselves).
    """
    comments: dict[str, str] = {}
    lines = text.split("\n")
    block: list[str] = []
    for line in lines:
        stripped = line.strip()
        if stripped.startswith("//"):
            block.append(stripped[2:].strip())
            continue
        m = re.match(r"\s*message\s+([A-Za-z_][A-Za-z0-9_]*)", line)
        if m and block:
            comments[m.group(1)] = " ".join(block)
        block = []
    code = re.sub(r"//[^\n]*", "", text)
    code = re.sub(r"/\*.*?\*/", "", code, flags=re.S)
    return code, comments


def _parse_enum(toks: _Tokens, scope: str) -> ParsedEnum:
    name = toks.next()
    enum = ParsedEnum(name=name, full_name=f"{scope}.{name}")
    toks.expect("{")
    while toks.peek() != "}":
        vname = toks.next()
        if vname == "option":
            raise ProtoParseError(
                f"{toks.path}: enum options are not supported "
                f"(enum {name})"
            )
        toks.expect("=")
        vnum = int(toks.next())
        toks.expect(";")
        enum.values.append((vname, vnum))
    toks.expect("}")
    return enum


def _parse_message(
    toks: _Tokens, scope: str, comments: dict[str, str]
) -> ParsedMessage:
    name = toks.next()
    msg = ParsedMessage(name=name, full_name=f"{scope}.{name}")
    comment = comments.get(name, "")
    msg.msgtype_claims = sorted(
        {int(n) for n in _MSGTYPE_CLAIM_RE.findall(comment)}
    )
    toks.expect("{")
    while toks.peek() != "}":
        tok = toks.next()
        if tok == "message":
            msg.nested.append(_parse_message(toks, msg.full_name, comments))
            continue
        if tok == "enum":
            msg.enums.append(_parse_enum(toks, msg.full_name))
            continue
        if tok in ("oneof", "map", "option", "extensions", "reserved",
                   "extend", "group", "required"):
            raise ProtoParseError(
                f"{toks.path}: {tok!r} is not supported "
                f"(message {msg.full_name})"
            )
        label = LABEL_OPTIONAL
        proto3_optional = False
        if tok == "repeated":
            label = LABEL_REPEATED
            tok = toks.next()
        elif tok == "optional":
            proto3_optional = True
            tok = toks.next()
        ftype = tok
        fname = toks.next()
        toks.expect("=")
        fnum = int(toks.next())
        nxt = toks.next()
        if nxt == "[":
            raise ProtoParseError(
                f"{toks.path}: field options are not supported "
                f"({msg.full_name}.{fname})"
            )
        if nxt != ";":
            raise ProtoParseError(
                f"{toks.path}: expected ';' after field "
                f"{msg.full_name}.{fname}, got {nxt!r}"
            )
        if ftype in SCALAR_TYPES:
            f = ParsedField(fname, fnum, label, SCALAR_TYPES[ftype], None)
        else:
            f = ParsedField(fname, fnum, label, 0, ftype)
        f.proto3_optional = proto3_optional
        msg.fields.append(f)
    toks.expect("}")
    # Synthetic oneofs for proto3 optional fields, in declaration order
    # (protoc appends them after any real oneofs; this subset has none).
    for f in msg.fields:
        if f.proto3_optional:
            f.oneof_index = len(msg.oneofs)
            msg.oneofs.append(f"_{f.name}")
    return msg


def parse_proto_text(text: str, import_path: str) -> ParsedFile:
    code, comments = _strip_comments(text)
    toks = _Tokens(code, import_path)
    pf = ParsedFile(path=import_path, package="", syntax="proto2")
    while toks.peek() is not None:
        tok = toks.next()
        if tok == "syntax":
            toks.expect("=")
            pf.syntax = toks.next().strip('"')
            toks.expect(";")
        elif tok == "package":
            pf.package = toks.next()
            toks.expect(";")
        elif tok == "import":
            pf.imports.append(toks.next().strip('"'))
            toks.expect(";")
        elif tok == "message":
            pf.messages.append(
                _parse_message(toks, f".{pf.package}", comments)
            )
        elif tok == "enum":
            pf.enums.append(_parse_enum(toks, f".{pf.package}"))
        elif tok == "option":
            raise ProtoParseError(
                f"{import_path}: file options are not supported"
            )
        elif tok == "service":
            raise ProtoParseError(
                f"{import_path}: services are not supported"
            )
        else:
            raise ProtoParseError(
                f"{import_path}: unexpected top-level token {tok!r}"
            )
    return pf


# ---------------------------------------------------------------------------
# symbol resolution
# ---------------------------------------------------------------------------

def _symbols_of(pf: ParsedFile) -> dict[str, bool]:
    """{full name: is_message} declared by one parsed file."""
    syms: dict[str, bool] = {}

    def walk(msg: ParsedMessage) -> None:
        syms[msg.full_name] = True
        for e in msg.enums:
            syms[e.full_name] = False
        for n in msg.nested:
            walk(n)

    for m in pf.messages:
        walk(m)
    for e in pf.enums:
        syms[e.full_name] = False
    return syms


def _resolve_file(pf: ParsedFile, symbols: dict[str, bool]) -> None:
    """Resolve named field types against ``symbols`` using protoc's
    innermost-scope-outward rule."""

    def resolve(ref: str, scopes: list[str], where: str) -> tuple[str, bool]:
        if ref.startswith("."):
            if ref in symbols:
                return ref, symbols[ref]
            raise ProtoParseError(f"{pf.path}: unknown type {ref} ({where})")
        for scope in scopes:
            cand = f"{scope}.{ref}" if scope else f".{ref}"
            if cand in symbols:
                return cand, symbols[cand]
        raise ProtoParseError(f"{pf.path}: unresolved type {ref} ({where})")

    def walk(msg: ParsedMessage, scopes: list[str]) -> None:
        inner = [msg.full_name] + scopes
        for f in msg.fields:
            if f.type_ref is not None:
                full, is_msg = resolve(
                    f.type_ref, inner, f"{msg.full_name}.{f.name}"
                )
                f.type_name = full
                f.type = TYPE_MESSAGE if is_msg else TYPE_ENUM
        for n in msg.nested:
            walk(n, inner)

    pkg_scopes = [f".{pf.package}", ""]
    for m in pf.messages:
        walk(m, pkg_scopes)


def parse_proto_file(
    path: str, repo_root: str, _cache: dict | None = None
) -> ParsedFile:
    """Parse ``path`` (filesystem) and resolve type references using its
    transitive imports (resolved relative to ``repo_root``)."""
    cache = _cache if _cache is not None else {}
    import_path = os.path.relpath(path, repo_root).replace(os.sep, "/")

    def load(ipath: str) -> ParsedFile | None:
        if ipath in cache:
            return cache[ipath]
        if ipath in WELL_KNOWN:
            cache[ipath] = None
            return None
        fs_path = os.path.join(repo_root, ipath)
        try:
            with open(fs_path) as fh:
                pf = parse_proto_text(fh.read(), ipath)
        except OSError as e:
            raise ProtoParseError(f"{ipath}: unreadable ({e})")
        cache[ipath] = pf
        try:
            for dep in pf.imports:
                load(dep)
        except ProtoParseError:
            # Never leave a partially-loaded entry in a SHARED cache: a
            # later call would skip dependency loading and crash in
            # gather() instead of re-raising the real parse error.
            del cache[ipath]
            raise
        return pf

    pf = load(import_path)
    assert pf is not None
    symbols: dict[str, bool] = {}
    seen: set[str] = set()

    def gather(ipath: str) -> None:
        if ipath in seen:
            return
        seen.add(ipath)
        if ipath in WELL_KNOWN:
            symbols.update(WELL_KNOWN[ipath])
            return
        dep = cache[ipath]
        symbols.update(_symbols_of(dep))
        for sub in dep.imports:
            gather(sub)

    gather(import_path)
    for ipath in seen:
        if ipath not in WELL_KNOWN and cache[ipath] is not None:
            _resolve_file(cache[ipath], symbols)
    return pf


# ---------------------------------------------------------------------------
# FileDescriptorProto construction
# ---------------------------------------------------------------------------

def build_file_descriptor(
    pf: ParsedFile,
) -> descriptor_pb2.FileDescriptorProto:
    fdp = descriptor_pb2.FileDescriptorProto()
    fdp.name = pf.path
    fdp.package = pf.package
    for dep in pf.imports:
        fdp.dependency.append(dep)

    def fill_enum(dst, enum: ParsedEnum) -> None:
        dst.name = enum.name
        for vname, vnum in enum.values:
            v = dst.value.add()
            v.name = vname
            v.number = vnum

    def fill_message(dst, msg: ParsedMessage) -> None:
        dst.name = msg.name
        for f in msg.fields:
            fd = dst.field.add()
            fd.name = f.name
            fd.number = f.number
            fd.label = f.label
            fd.type = f.type
            if f.type_name:
                fd.type_name = f.type_name
            if f.oneof_index is not None:
                fd.oneof_index = f.oneof_index
            if f.proto3_optional:
                fd.proto3_optional = True
        for n in msg.nested:
            fill_message(dst.nested_type.add(), n)
        for e in msg.enums:
            fill_enum(dst.enum_type.add(), e)
        for oname in msg.oneofs:
            dst.oneof_decl.add().name = oname

    for m in pf.messages:
        fill_message(fdp.message_type.add(), m)
    for e in pf.enums:
        fill_enum(fdp.enum_type.add(), e)
    if pf.syntax != "proto2":
        fdp.syntax = pf.syntax
    return fdp


def msgtype_claims(pf: ParsedFile) -> dict[str, list[int]]:
    """{message name: [claimed msgType numbers]} for one parsed file."""
    claims: dict[str, list[int]] = {}

    def walk(msg: ParsedMessage) -> None:
        if msg.msgtype_claims:
            claims[msg.name] = list(msg.msgtype_claims)
        for n in msg.nested:
            walk(n)

    for m in pf.messages:
        walk(m)
    return claims
