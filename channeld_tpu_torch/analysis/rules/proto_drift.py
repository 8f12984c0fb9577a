"""proto-drift: the hand-regenerated pb2 modules match their .proto
sources, and the msgType registry is single, unique, and in range.

There is no protoc in the image: every ``*_pb2.py`` under
``channeld_tpu_torch/protocol/`` is a copy of the JAX package's, which is
regenerated by hand (scripts/regen_pb2.py).  The port's ``.proto``
sources keep the JAX package's import paths and descriptor names
(``channeld_tpu/protocol/...``): protobuf's default pool then holds one
file for both packages.  So each port schema is compiled under that
logical name, every import it reaches read from the port's own copy
(``parse_port_proto``).  A hand-regen mistake — a renumbered field, a
dropped message, a type change — silently corrupts the wire for every
SDK speaking the schema.  This rule recompiles each ``.proto`` with the
pure-python compiler (``analysis/protoparse.py``) and diffs the result
against the descriptor embedded in the committed pb2 *source* (never
imported, so a drifted pb2 cannot poison the descriptor pool).

The msgType registry checks make the extension message-type space
mechanical (doc/analysis.md):

- ``core/types.py MessageType`` is THE registry; duplicate values are
  findings.
- The wire schema's own ``MessageType`` enum must carry the same
  name->value pairs (a peer reading wire.proto must see every type the
  gateway can send).
- Extension msgTypes live in the documented 24-46 range.
- Every extension member is claimed by exactly one ``msgType N`` doc
  comment in a ``.proto`` and registered in exactly one template map
  (``protocol/__init__.py MESSAGE_TEMPLATES`` or the trunk map in
  ``federation/trunk.py``), with the comment, the registry and the
  enum all agreeing.
"""

from __future__ import annotations

import ast
import glob
import os

from google.protobuf import descriptor_pb2

from .. import pb2io, protoparse
from ..astutil import dotted
from ..engine import Finding, ModuleInfo, RepoContext, Rule

PROTO_DIR = "channeld_tpu_torch/protocol"
# The schemas' import root (descriptor names) and where the port keeps them.
LOGICAL_ROOT, PORT_ROOT = "channeld_tpu/", "channeld_tpu_torch/"
TYPES_REL = "channeld_tpu_torch/core/types.py"
TEMPLATES_REL = "channeld_tpu_torch/protocol/__init__.py"
TRUNK_REL = "channeld_tpu_torch/federation/trunk.py"

# The reference protocol's msgTypes (pkg/channeldpb); everything the
# reproduction adds on top must sit in the documented extension range.
REFERENCE_MSGTYPES = set(range(0, 24)) | {99, 100}
EXTENSION_RANGE = range(24, 47)

_RULE = "proto-drift"

_TYPE_NAMES = {
    1: "double", 2: "float", 3: "int64", 4: "uint64", 5: "int32",
    6: "fixed64", 7: "fixed32", 8: "bool", 9: "string", 10: "group",
    11: "message", 12: "bytes", 13: "uint32", 14: "enum",
    15: "sfixed32", 16: "sfixed64", 17: "sint32", 18: "sint64",
}
_LABEL_NAMES = {1: "optional", 2: "required", 3: "repeated"}


def _normalize(fdp: descriptor_pb2.FileDescriptorProto) -> None:
    """Drop serialization cosmetics that carry no wire meaning."""
    def walk(msg) -> None:
        for f in msg.field:
            f.ClearField("json_name")
        for n in msg.nested_type:
            walk(n)

    for m in fdp.message_type:
        walk(m)
    fdp.ClearField("source_code_info")


def _field_desc(f) -> str:
    t = _TYPE_NAMES.get(f.type, str(f.type))
    if f.type_name:
        t = f.type_name
    return f"{_LABEL_NAMES.get(f.label, f.label)} {t} = {f.number}"


def diff_descriptors(
    expected: descriptor_pb2.FileDescriptorProto,
    actual: descriptor_pb2.FileDescriptorProto,
    pb2_rel: str,
) -> list[Finding]:
    """Semantic schema diff: ``expected`` compiled from the .proto,
    ``actual`` extracted from the committed pb2."""
    findings: list[Finding] = []

    def flag(detector: str, msg: str, scope: str = "") -> None:
        findings.append(Finding(
            rule=_RULE, path=pb2_rel, line=1, message=msg,
            detector=detector, scope=scope,
        ))

    if expected.package != actual.package:
        flag("package", f"package {actual.package!r} != proto "
                        f"{expected.package!r}")
    if expected.name != actual.name:
        flag("file-name", f"descriptor file name {actual.name!r} != "
                          f"proto path {expected.name!r}")
    if expected.syntax != actual.syntax:
        # A dropped trailing syntax marker flips every field to
        # proto2-optional presence semantics — silent wire corruption.
        flag("syntax", f"syntax {actual.syntax or 'proto2'!r} != proto "
                       f"{expected.syntax or 'proto2'!r}")
    if list(expected.dependency) != list(actual.dependency):
        flag("dependency", f"imports {list(actual.dependency)} != proto "
                           f"{list(expected.dependency)}")

    def diff_enum(exp, act, scope: str) -> None:
        evals = {(v.name, v.number) for v in exp.value}
        avals = {(v.name, v.number) for v in act.value}
        for name, num in sorted(evals - avals):
            flag(f"{scope}.{name}", f"enum value {name}={num} in .proto "
                                    "missing from pb2", scope)
        for name, num in sorted(avals - evals):
            flag(f"{scope}.{name}", f"enum value {name}={num} in pb2 "
                                    "missing from .proto", scope)

    def diff_msg(exp, act, scope: str) -> None:
        efields = {f.name: f for f in exp.field}
        afields = {f.name: f for f in act.field}
        for name in sorted(set(efields) - set(afields)):
            flag(f"{scope}.{name}",
                 f"field {name} ({_field_desc(efields[name])}) in .proto "
                 "missing from pb2", scope)
        for name in sorted(set(afields) - set(efields)):
            flag(f"{scope}.{name}",
                 f"field {name} ({_field_desc(afields[name])}) in pb2 "
                 "missing from .proto", scope)
        for name in sorted(set(efields) & set(afields)):
            e, a = efields[name], afields[name]
            if (e.number, e.label, e.type, e.type_name,
                    e.proto3_optional) != (
                    a.number, a.label, a.type, a.type_name,
                    a.proto3_optional):
                flag(f"{scope}.{name}",
                     f"field {name}: pb2 has {_field_desc(a)}, .proto "
                     f"has {_field_desc(e)}"
                     + ("" if e.proto3_optional == a.proto3_optional
                        else " (proto3 optional mismatch)"),
                     scope)
        _diff_children(exp, act, scope)

    def _diff_children(exp, act, scope: str) -> None:
        enested = {m.name: m for m in exp.nested_type}
        anested = {m.name: m for m in act.nested_type}
        for name in sorted(set(enested) - set(anested)):
            flag(f"{scope}.{name}", f"message {scope}.{name} in .proto "
                                    "missing from pb2", scope)
        for name in sorted(set(anested) - set(enested)):
            flag(f"{scope}.{name}", f"message {scope}.{name} in pb2 "
                                    "missing from .proto", scope)
        for name in sorted(set(enested) & set(anested)):
            diff_msg(enested[name], anested[name], f"{scope}.{name}")
        eenums = {e.name: e for e in exp.enum_type}
        aenums = {e.name: e for e in act.enum_type}
        for name in sorted(set(eenums) - set(aenums)):
            flag(f"{scope}.{name}", f"enum {scope}.{name} in .proto "
                                    "missing from pb2", scope)
        for name in sorted(set(aenums) - set(eenums)):
            flag(f"{scope}.{name}", f"enum {scope}.{name} in pb2 "
                                    "missing from .proto", scope)
        for name in sorted(set(eenums) & set(aenums)):
            diff_enum(eenums[name], aenums[name], f"{scope}.{name}")

    class _Top:
        pass

    top_e, top_a = _Top(), _Top()
    top_e.nested_type = expected.message_type
    top_a.nested_type = actual.message_type
    top_e.enum_type = expected.enum_type
    top_a.enum_type = actual.enum_type
    _diff_children(top_e, top_a, expected.package or "<file>")
    return findings


def parse_port_proto(proto_path: str, repo_root: str,
                     cache: dict) -> "protoparse.ParsedFile":
    """Parse a port schema under its logical name (``channeld_tpu/...``),
    seeding ``cache`` with every schema it imports, read from the port's
    copy; raises ProtoParseError."""
    def seed(logical: str) -> None:
        if logical in cache or logical in protoparse.WELL_KNOWN:
            return
        fs_rel = logical
        if logical.startswith(LOGICAL_ROOT):
            fs_rel = PORT_ROOT + logical[len(LOGICAL_ROOT):]
        try:
            with open(os.path.join(repo_root, fs_rel)) as fh:
                pf = protoparse.parse_proto_text(fh.read(), logical)
        except OSError as e:
            raise protoparse.ProtoParseError(f"{fs_rel}: unreadable ({e})")
        cache[logical] = pf
        for dep in pf.imports:
            seed(dep)

    rel = os.path.relpath(proto_path, repo_root).replace(os.sep, "/")
    logical = LOGICAL_ROOT + rel[len(PORT_ROOT):] if rel.startswith(PORT_ROOT) else rel
    seed(logical)
    return protoparse.parse_proto_file(os.path.join(repo_root, logical), repo_root, cache)


def check_proto_pair(
    proto_path: str, pb2_path: str, repo_root: str,
    parsed: "protoparse.ParsedFile | None" = None,
    cache: dict | None = None,
) -> list[Finding]:
    """Drift findings for one (.proto, _pb2.py) pair — also the fixture
    entry point for tests.  ``parsed``/``cache`` let a repo sweep reuse
    one parse per schema and one transitive-import cache."""
    pb2_rel = os.path.relpath(pb2_path, repo_root).replace(os.sep, "/")
    try:
        pf = parsed if parsed is not None else \
            parse_port_proto(proto_path, repo_root, {} if cache is None else cache)
        expected = protoparse.build_file_descriptor(pf)
    except protoparse.ProtoParseError as e:
        return [Finding(rule=_RULE, path=pb2_rel, line=1,
                        message=str(e), detector="proto-parse-error")]
    if not os.path.exists(pb2_path):
        return [Finding(rule=_RULE, path=pb2_rel, line=1,
                        message=f"no committed pb2 for {pf.path}",
                        detector="missing-pb2")]
    try:
        with open(pb2_path, encoding="utf-8") as fh:
            actual = pb2io.parse_pb2_descriptor(fh.read(), pb2_rel)
    except pb2io.Pb2ExtractError as e:
        return [Finding(rule=_RULE, path=pb2_rel, line=1,
                        message=str(e), detector="pb2-extract-error")]
    _normalize(expected)
    _normalize(actual)
    return diff_descriptors(expected, actual, pb2_rel)


# ---------------------------------------------------------------------------
# msgType registry
# ---------------------------------------------------------------------------

def _parse_enum_class(mod: ModuleInfo, class_name: str) -> dict[str, int]:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef) and node.name == class_name:
            values: dict[str, int] = {}
            for stmt in node.body:
                if (isinstance(stmt, ast.Assign)
                        and len(stmt.targets) == 1
                        and isinstance(stmt.targets[0], ast.Name)
                        and isinstance(stmt.value, ast.Constant)
                        and isinstance(stmt.value.value, int)):
                    values[stmt.targets[0].id] = stmt.value.value
            return values
    return {}


def _parse_template_dicts(
    mod: ModuleInfo, enum: dict[str, int]
) -> list[tuple[str, list[tuple[int, str, int]], list[tuple[int, str]]]]:
    """Module-level dict literals mapping msgTypes to template classes:
    [(dict name, [(msgType, class name, line)], [(line, problem)])].
    Keys are int constants or ``MessageType.X`` attributes; values are
    ``*_pb2.Class`` references.  A dict counts as a registry when ANY
    entry conforms — the remaining non-conforming entries are returned
    as problems so one odd entry can never silently switch the whole
    registry's enforcement off."""
    out = []
    for node in mod.tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Dict)):
            continue
        entries: list[tuple[int, str, int]] = []
        problems: list[tuple[int, str]] = []
        for k, v in zip(node.value.keys, node.value.values):
            if k is None:
                problems.append((node.value.lineno,
                                 "dict-spread (**...) entry"))
                continue
            num = None
            if isinstance(k, ast.Constant) and isinstance(k.value, int):
                num = k.value
            else:
                kname = dotted(k)
                if kname and kname.startswith("MessageType."):
                    num = enum.get(kname.split(".", 1)[1])
                    if num is None:
                        problems.append(
                            (k.lineno, f"unknown enum member {kname}"))
                        continue
            vname = dotted(v) if v is not None else None
            if num is None or vname is None or "_pb2." not in vname:
                problems.append((k.lineno,
                                 "key is not an int/MessageType.X or "
                                 "value is not a *_pb2 class"))
                continue
            entries.append((num, vname.split(".")[-1], k.lineno))
        if entries:
            out.append((node.targets[0].id, entries, problems))
    return out


class ProtoDriftRule(Rule):
    name = _RULE
    repo_wide = True
    description = (
        "committed *_pb2.py descriptors match their .proto sources; one "
        "global msgType registry, unique, within the documented 24-46 "
        "extension range"
    )

    def check_repo(self, repo: RepoContext) -> list[Finding]:
        findings: list[Finding] = []
        proto_glob = os.path.join(repo.root, PROTO_DIR, "*.proto")
        claims: dict[str, list[tuple[int, str]]] = {}  # msg -> [(n, rel)]
        cache: dict = {}  # one transitive-import parse cache for the sweep
        parsed: dict[str, "protoparse.ParsedFile"] = {}
        for proto_path in sorted(glob.glob(proto_glob)):
            rel = os.path.relpath(proto_path, repo.root).replace(os.sep, "/")
            pb2_path = proto_path[:-len(".proto")] + "_pb2.py"
            pf = None
            try:
                pf = parse_port_proto(proto_path, repo.root, cache)
                parsed[rel] = pf
            except protoparse.ProtoParseError:
                pass  # check_proto_pair re-raises it as a finding
            findings.extend(
                check_proto_pair(proto_path, pb2_path, repo.root,
                                 parsed=pf, cache=cache)
            )
            if pf is None:
                continue
            for msg, nums in protoparse.msgtype_claims(pf).items():
                claims.setdefault(msg, []).extend((n, rel) for n in nums)
        # The reverse direction: a committed pb2 whose .proto was
        # deleted/renamed keeps shipping wire classes with no source of
        # truth — and no pair above would ever look at it.
        for pb2_path in sorted(glob.glob(
                os.path.join(repo.root, PROTO_DIR, "*_pb2.py"))):
            proto_path = pb2_path[:-len("_pb2.py")] + ".proto"
            if not os.path.exists(proto_path):
                rel = os.path.relpath(pb2_path, repo.root).replace(
                    os.sep, "/")
                findings.append(Finding(
                    rule=_RULE, path=rel, line=1,
                    message="orphaned pb2: no matching .proto source "
                            "(deleted or renamed?); the schema cannot "
                            "be drift-checked",
                    detector="orphaned-pb2",
                ))
        findings.extend(self._check_registry(repo, claims, parsed))
        return findings

    def _check_registry(
        self, repo: RepoContext,
        claims: dict[str, list[tuple[int, str]]],
        parsed: "dict[str, protoparse.ParsedFile] | None" = None,
    ) -> list[Finding]:
        findings: list[Finding] = []
        types_mod = repo.module(TYPES_REL)
        if types_mod is None:
            return findings
        enum = _parse_enum_class(types_mod, "MessageType")

        def flag(path: str, line: int, detector: str, msg: str) -> None:
            findings.append(Finding(
                rule=_RULE, path=path, line=line, message=msg,
                detector=detector, scope="MessageType",
            ))

        # Unique values in the enum itself.
        seen: dict[int, str] = {}
        for name, num in enum.items():
            if num in seen:
                flag(TYPES_REL, 1, f"dup:{num}",
                     f"MessageType value {num} assigned to both "
                     f"{seen[num]} and {name}")
            seen[num] = name

        # Extension members sit in the documented range.
        for name, num in sorted(enum.items(), key=lambda kv: kv[1]):
            if num not in REFERENCE_MSGTYPES and num not in EXTENSION_RANGE:
                flag(TYPES_REL, 1, f"range:{name}",
                     f"MessageType.{name} = {num} is outside the "
                     f"documented extension range "
                     f"{EXTENSION_RANGE.start}-{EXTENSION_RANGE.stop - 1}")

        # wire.proto's MessageType enum carries the same pairs.
        wire_rel = f"{PROTO_DIR}/wire.proto"
        wire_path = os.path.join(repo.root, wire_rel)
        if os.path.exists(wire_path):
            wire_pf = (parsed or {}).get(wire_rel)
            if wire_pf is None:
                try:
                    wire_pf = parse_port_proto(wire_path, repo.root, {})
                except protoparse.ProtoParseError:
                    wire_pf = None
            if wire_pf is not None:
                wire_enum = {}
                for e in wire_pf.enums:
                    if e.name == "MessageType":
                        wire_enum = dict(e.values)
                py_pairs = set(enum.items())
                wire_pairs = set(wire_enum.items())
                for name, num in sorted(py_pairs - wire_pairs,
                                        key=lambda kv: kv[1]):
                    flag(wire_rel, 1, f"wire-missing:{name}",
                         f"core/types.py MessageType.{name} = {num} is "
                         "missing from wire.proto's MessageType enum "
                         "(peers reading the schema cannot see it)")
                for name, num in sorted(wire_pairs - py_pairs,
                                        key=lambda kv: kv[1]):
                    flag(wire_rel, 1, f"wire-extra:{name}",
                         f"wire.proto MessageType.{name} = {num} is not "
                         "in core/types.py MessageType")

        # Template registries: protocol/__init__.py + federation/trunk.py.
        registries: list[tuple[str, str, dict[int, tuple[str, int]]]] = []
        for rel in (TEMPLATES_REL, TRUNK_REL):
            mod = repo.module(rel)
            if mod is None:
                continue
            for dict_name, entries, problems in _parse_template_dicts(
                    mod, enum):
                for line, why in problems:
                    flag(rel, line, f"opaque-entry:{dict_name}",
                         f"{dict_name} entry the registry checker cannot "
                         f"read ({why}); keep registry entries literal "
                         "so msgType enforcement stays on")
                table: dict[int, tuple[str, int]] = {}
                for num, cls, line in entries:
                    if num in table:
                        flag(rel, line, f"dup-key:{dict_name}:{num}",
                             f"{dict_name} registers msgType {num} twice "
                             f"({table[num][0]} and {cls})")
                        continue
                    table[num] = (cls, line)
                registries.append((rel, dict_name, table))

        merged: dict[int, tuple[str, str, str]] = {}  # num -> (cls, rel, dict)
        for rel, dict_name, table in registries:
            for num, (cls, line) in table.items():
                if num in merged:
                    prev_cls, prev_rel, prev_dict = merged[num]
                    flag(rel, line, f"cross-dup:{num}",
                         f"msgType {num} registered in both "
                         f"{prev_dict} ({prev_rel}: {prev_cls}) and "
                         f"{dict_name} ({cls}); one global registry only")
                    continue
                merged[num] = (cls, rel, dict_name)
                if num not in seen:
                    flag(rel, line, f"unregistered-enum:{num}",
                         f"{dict_name} registers msgType {num} which has "
                         "no MessageType member")

        # Every extension member: registered exactly once and claimed by
        # a ``msgType N`` doc comment on its .proto message.
        claimed_nums: dict[int, list[tuple[str, str]]] = {}
        for msg, pairs in claims.items():
            for num, rel in pairs:
                claimed_nums.setdefault(num, []).append((msg, rel))
        for name, num in sorted(enum.items(), key=lambda kv: kv[1]):
            if num not in EXTENSION_RANGE or num in REFERENCE_MSGTYPES:
                continue
            entry = merged.get(num)
            if entry is None:
                flag(TYPES_REL, 1, f"unregistered:{name}",
                     f"extension MessageType.{name} = {num} is in no "
                     "template registry (MESSAGE_TEMPLATES or the trunk "
                     "map)")
            owners = claimed_nums.get(num, [])
            if not owners:
                flag(TYPES_REL, 1, f"unclaimed:{name}",
                     f"extension MessageType.{name} = {num} has no "
                     "'msgType {n}' doc comment on any .proto message "
                     "(the wire contract must be documented at the "
                     "schema)")
            elif len(owners) > 1:
                flag(TYPES_REL, 1, f"multi-claimed:{name}",
                     f"msgType {num} claimed by multiple proto messages: "
                     f"{sorted(m for m, _ in owners)}")
            elif entry is not None and owners[0][0] != entry[0]:
                flag(TYPES_REL, 1, f"claim-mismatch:{name}",
                     f"msgType {num}: .proto comment claims "
                     f"{owners[0][0]} but the registry maps it to "
                     f"{entry[0]}")
        return findings
