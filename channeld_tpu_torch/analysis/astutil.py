"""Small AST helpers shared by the tpulint rules."""

from __future__ import annotations

import ast
from dataclasses import dataclass


def dotted(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclass
class FuncInfo:
    qualname: str        # e.g. "TPUSpatialController.tick"
    name: str
    node: ast.AST        # FunctionDef | AsyncFunctionDef
    is_async: bool
    in_async: bool       # lexically inside an async def (closures included)


def iter_functions(tree: ast.AST) -> list[FuncInfo]:
    """Every function definition with its class-qualified name and
    whether it executes in an async context (being async itself, or a
    closure defined inside an async def — such closures run inline on
    the event loop)."""
    out: list[FuncInfo] = []

    def walk(node: ast.AST, prefix: str, in_async: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                walk(child, f"{prefix}{child.name}.", in_async)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                is_async = isinstance(child, ast.AsyncFunctionDef)
                qual = f"{prefix}{child.name}"
                out.append(FuncInfo(
                    qualname=qual, name=child.name, node=child,
                    is_async=is_async, in_async=in_async or is_async,
                ))
                walk(child, f"{qual}.", in_async or is_async)
            else:
                walk(child, prefix, in_async)

    walk(tree, "", False)
    return out


def direct_body_nodes(func: ast.AST) -> list[ast.AST]:
    """All AST nodes lexically inside ``func`` but NOT inside a nested
    function/class definition.  Lambdas are NOT a boundary: a lambda
    handed to ``call_soon``/``sorted`` from an async context runs
    inline, so its body belongs to the enclosing function for
    blocking/readback purposes."""
    out: list[ast.AST] = []

    def walk(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                continue
            out.append(child)
            walk(child)

    walk(func)
    return out


def import_aliases(tree: ast.AST) -> dict[str, str]:
    """{local name: canonical dotted name} for module imports and
    from-imports (``import time as _time`` -> {"_time": "time"};
    ``from time import sleep`` -> {"sleep": "time.sleep"};
    ``from ..core import metrics`` -> {"metrics": "..core.metrics"}).
    Relative imports keep their leading dots."""
    out: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:
                    out[alias.asname] = alias.name
                else:
                    # ``import a.b`` binds the ROOT package name ``a``
                    # locally; mapping it to ``a.b`` would mis-resolve
                    # every ``a.x`` call.
                    root = alias.name.split(".")[0]
                    out[root] = root
        elif isinstance(node, ast.ImportFrom):
            base = "." * node.level + (node.module or "")
            for alias in node.names:
                if alias.name == "*":
                    continue
                out[alias.asname or alias.name] = f"{base}.{alias.name}"
    return out


def metrics_aliases(tree: ast.AST) -> tuple[set[str], dict[str, str]]:
    """Names bound to the core metrics MODULE, and {local name: metric
    attr} for names imported from it directly."""
    modules: set[str] = set()
    objects: dict[str, str] = {}
    for local, target in import_aliases(tree).items():
        norm = target.lstrip(".")
        if norm in ("metrics", "core.metrics", "channeld_tpu.core.metrics"):
            modules.add(local)
        elif norm.startswith(("metrics.", "core.metrics.",
                              "channeld_tpu.core.metrics.")):
            objects[local] = norm.rsplit(".", 1)[1]
    return modules, objects


def call_name(node: ast.Call, aliases: dict[str, str]) -> str | None:
    """Canonical dotted name of a call target, resolving the leading
    module alias (``_time.sleep(...)`` -> ``time.sleep``)."""
    name = dotted(node.func)
    if name is None:
        return None
    head, _, rest = name.partition(".")
    canonical = aliases.get(head)
    if canonical is None:
        return name
    canonical = canonical.lstrip(".")
    return f"{canonical}.{rest}" if rest else canonical
