"""Concurrency-discipline rules over the thread model (doc/concurrency.md).

Five rules, all consuming ``analysis/threadmodel.py``'s call-graph
domain assignment:

- **thread-model** — every thread/executor entry point must be claimed
  by the declared model (a new ``threading.Thread``/``submit`` target
  outside the spec is a finding), and the spec itself must not rot
  (a seed matching nothing in a present module is stale).
- **shared-state** — a mutable instance attribute written from two or
  more OS threads must carry a declared handoff mechanism:
  ``# tpulint: shared=<lock|queue|fence|atomic|cond|event>`` on an
  assignment of that attribute inside the owner class.  An undeclared
  cross-domain write is exactly the bug class review kept catching
  (the WAL's dead-writer flag, the SLO plane's ring intake).
- **off-loop-asyncio** — asyncio primitives that are only safe on the
  loop thread (``call_soon``, ``call_later``, ``call_at``,
  ``create_task``, ``ensure_future``) are findings in any function
  reachable from an own-thread domain; off-loop code must use
  ``call_soon_threadsafe`` / ``run_coroutine_threadsafe``.
- **fence-discipline** — in ``ops/engine.py``, any store to
  engine-visible device state (``self._d_*``, ``self.generation``)
  reachable from the device-worker domain must be generation-fenced:
  a fence check (``_fence()`` or an ``if ... generation ... raise``)
  must sit between the staging work and the store, with no other call
  in between (the ``_flush_host_state`` pattern, machine-checked).
- **live-iter** — an off-loop function iterating a loop-owned mapping
  view (``for x in self.thing.items()`` or a comprehension/genexp over
  one) races the loop's mutations across bytecode boundaries; it must
  snapshot first (``list(d.items())`` / ``sorted(d.items())`` are
  single C-level copies and stay allowed as direct arguments).
"""

from __future__ import annotations

import ast
import fnmatch
import re

from .. import threadmodel
from ..astutil import call_name, direct_body_nodes, dotted, import_aliases, iter_functions
from ..engine import Finding, ModuleInfo, RepoContext, Rule

# ---------------------------------------------------------------------------
# thread-model
# ---------------------------------------------------------------------------


class ThreadModelRule(Rule):
    name = "thread-model"
    description = (
        "every thread/executor entry point must be declared in the "
        "thread model (analysis/threadmodel.py DOMAINS); stale spec "
        "seeds are findings too"
    )
    # Stale-seed findings attribute to analysis/threadmodel.py while
    # the CAUSE is a rename in some other module (the same cross-file
    # attribution as proto-drift): they must survive the --changed
    # filter or the pre-commit hook passes exactly when the model rots.
    repo_wide = True

    def check_repo(self, repo: RepoContext) -> list[Finding]:
        model = threadmodel.build_model(repo)
        findings: list[Finding] = []
        for site in model.sites:
            if site.declared:
                continue
            findings.append(Finding(
                rule=self.name,
                path=site.rel,
                line=site.line,
                message=(
                    f"{site.kind} entry point {site.target_repr!r} is not "
                    "claimed by any execution domain — declare it in "
                    "analysis/threadmodel.py DOMAINS (seeds or "
                    "spawn_sites) so the concurrency rules see it"
                ),
                detector=f"undeclared-entry:{site.target_repr}",
                scope=site.site,
            ))
        for dom, glob, pattern in model.stale_seeds:
            findings.append(Finding(
                rule=self.name,
                path="channeld_tpu_torch/analysis/threadmodel.py",
                line=1,
                message=(
                    f"domain {dom!r} seed ({glob!r}, {pattern!r}) matches "
                    "no function — the model is rotting (a rename moved "
                    "the entry point out from under it)"
                ),
                detector=f"stale-seed:{dom}:{pattern}",
                scope=dom,
            ))
        return findings


# ---------------------------------------------------------------------------
# shared-state
# ---------------------------------------------------------------------------

_MUTATORS = {
    "append", "add", "clear", "pop", "popitem", "update", "discard",
    "remove", "extend", "insert", "setdefault", "appendleft",
}

_SHARED_DECL_RE = re.compile(
    r"self\.(\w+)\s*(?::[^=#]+)?=.*#\s*tpulint:\s*shared=([a-z-]+)"
)
_SHARED_ANY_RE = re.compile(r"#\s*tpulint:\s*shared=([a-z-]+)")


def _self_attr_of(node: ast.AST) -> str | None:
    """The first attribute after ``self`` in a write-target chain
    (``self.a``, ``self.a.b``, ``self.a[k]`` all own attr ``a``)."""
    while isinstance(node, ast.Subscript):
        node = node.value
    chain = []
    while isinstance(node, ast.Attribute):
        chain.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name) and node.id == "self" and chain:
        return chain[-1]
    return None


def _attr_writes(fn_node: ast.AST):
    """(attr, line) pairs for every self-attribute mutation lexically in
    ``fn_node`` (nested defs excluded — they are their own functions)."""
    out = []
    for node in direct_body_nodes(fn_node):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                attr = _self_attr_of(t)
                if attr:
                    out.append((attr, node.lineno))
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            if getattr(node, "value", None) is None:
                continue
            attr = _self_attr_of(node.target)
            if attr:
                out.append((attr, node.lineno))
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                attr = _self_attr_of(t)
                if attr:
                    out.append((attr, node.lineno))
        elif isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute) and func.attr in _MUTATORS:
                attr = _self_attr_of(func.value)
                if attr:
                    out.append((attr, node.lineno))
    return out


def _class_spans(tree: ast.AST):
    """[(class name, lineno, end_lineno)] innermost-last."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            out.append((node.name, node.lineno, node.end_lineno or node.lineno))
    return out


def _shared_declarations(mod: ModuleInfo):
    """{(class, attr): (mechanism, line)} plus findings for malformed
    declarations (unknown mechanism, or a shared= comment on a line
    that does not assign a self attribute)."""
    spans = _class_spans(mod.tree)
    decls: dict[tuple, tuple] = {}
    bad: list[tuple] = []  # (line, mechanism or None)
    for i, line in enumerate(mod.lines, start=1):
        m = _SHARED_ANY_RE.search(line)
        if not m:
            continue
        owner = None
        for name, lo, hi in spans:
            if lo <= i <= hi:
                owner = name  # innermost wins (spans walk outer-first)
        decl = _SHARED_DECL_RE.search(line)
        mech = m.group(1)
        if decl is None or owner is None:
            bad.append((i, None))
            continue
        if mech not in threadmodel.SHARED_MECHANISMS:
            bad.append((i, mech))
            continue
        decls[(owner, decl.group(1))] = (mech, i)
    return decls, bad


class SharedStateRule(Rule):
    name = "shared-state"
    description = (
        "instance attributes written from >=2 OS threads must declare "
        "their handoff mechanism: '# tpulint: shared=<mechanism>' on an "
        "assignment in the owner class (mechanisms: "
        + "/".join(threadmodel.SHARED_MECHANISMS) + ")"
    )

    def check_module(self, mod: ModuleInfo, repo: RepoContext) -> list[Finding]:
        if not threadmodel.in_scope(mod.rel):
            return []
        model = threadmodel.build_model(repo)
        decls, bad = _shared_declarations(mod)
        findings: list[Finding] = []
        for line, mech in bad:
            findings.append(Finding(
                rule=self.name, path=mod.rel, line=line,
                message=(
                    f"unknown shared= mechanism {mech!r} (use one of "
                    + ", ".join(threadmodel.SHARED_MECHANISMS) + ")"
                    if mech is not None else
                    "tpulint shared= declaration must sit on a self-"
                    "attribute assignment inside the owner class"
                ),
                detector="bad-shared-declaration",
            ))
        # attr key -> {fn qual: (domains, line)}
        per_attr: dict[tuple, dict] = {}
        for fn in iter_functions(mod.tree):
            parts = fn.qualname.split(".")
            if len(parts) < 2:
                continue
            cls = parts[0]
            domains = model.domains_of(mod.rel, fn.qualname)
            if not domains:
                continue  # unreached: tests/boot-construction only
            for attr, line in _attr_writes(fn.node):
                per_attr.setdefault((cls, attr), {})[fn.qualname] = (
                    domains, line
                )
        for (cls, attr), writers in sorted(per_attr.items()):
            threads = set()
            for domains, _line in writers.values():
                threads |= model.threads_of(domains)
            if len(threads) < 2:
                continue
            if (cls, attr) in decls:
                continue
            first = min(line for _d, line in writers.values())
            who = ", ".join(
                f"{q} [{'/'.join(sorted(d))}]"
                for q, (d, _l) in sorted(writers.items())
            )
            findings.append(Finding(
                rule=self.name, path=mod.rel, line=first,
                message=(
                    f"{cls}.{attr} is written from {len(threads)} threads "
                    f"({who}) with no declared handoff — protect it and "
                    "declare '# tpulint: shared=<mechanism>' on its "
                    "assignment in the class"
                ),
                detector="cross-domain-write",
                scope=f"{cls}.{attr}",
            ))
        return findings


# ---------------------------------------------------------------------------
# off-loop-asyncio
# ---------------------------------------------------------------------------

_LOOP_ONLY_METHODS = {"call_soon", "call_later", "call_at", "create_task"}
_LOOP_ONLY_CALLS = {"asyncio.ensure_future", "asyncio.create_task"}


class OffLoopAsyncioRule(Rule):
    name = "off-loop-asyncio"
    description = (
        "call_soon/call_later/call_at/create_task/ensure_future are "
        "loop-thread-only; functions reachable from an own-thread "
        "domain must use call_soon_threadsafe/run_coroutine_threadsafe"
    )

    def check_module(self, mod: ModuleInfo, repo: RepoContext) -> list[Finding]:
        if not threadmodel.in_scope(mod.rel):
            return []
        model = threadmodel.build_model(repo)
        aliases = import_aliases(mod.tree)
        findings: list[Finding] = []
        for fn in iter_functions(mod.tree):
            domains = model.domains_of(mod.rel, fn.qualname)
            off = model.off_loop(domains)
            if not off:
                continue
            for node in direct_body_nodes(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                func = node.func
                hit = None
                if isinstance(func, ast.Attribute) \
                        and func.attr in _LOOP_ONLY_METHODS:
                    hit = func.attr
                else:
                    canonical = call_name(node, aliases)
                    if canonical in _LOOP_ONLY_CALLS:
                        hit = canonical.rsplit(".", 1)[1]
                if hit is None:
                    continue
                findings.append(Finding(
                    rule=self.name, path=mod.rel, line=node.lineno,
                    message=(
                        f"{hit}() in a function reachable from the "
                        f"{'/'.join(off)} thread(s): loop-only primitive "
                        "— use call_soon_threadsafe / "
                        "run_coroutine_threadsafe from off-loop code"
                    ),
                    detector=hit,
                    scope=fn.qualname,
                ))
        return findings


# ---------------------------------------------------------------------------
# fence-discipline
# ---------------------------------------------------------------------------

_ENGINE_REL = "channeld_tpu_torch/ops/engine.py"


def _is_fence(stmt: ast.AST) -> bool:
    """A generation fence: a call to a ``*_fence`` helper, or an ``if``
    comparing against the generation whose body raises."""
    if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
        name = dotted(stmt.value.func) or ""
        return name.endswith("_fence") or name == "_fence"
    if isinstance(stmt, ast.If):
        mentions_gen = any(
            (isinstance(n, ast.Attribute) and n.attr == "generation")
            or (isinstance(n, ast.Name) and "generation" in n.id)
            or (isinstance(n, ast.Name) and n.id == "gen")
            for n in ast.walk(stmt.test)
        )
        raises = any(isinstance(n, ast.Raise) for s in stmt.body
                     for n in ast.walk(s))
        return mentions_gen and raises
    return False


def _has_unfenced_reset(stmt: ast.AST) -> bool:
    """True when the statement performs a call that could re-enter
    device work (anything but an allowlisted self.*.clear()/discard())."""
    for node in ast.walk(stmt):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute) \
                    and func.attr in ("clear", "discard"):
                continue
            name = dotted(func) or ""
            if name.endswith("_fence"):
                continue
            return True
    return False


class FenceDisciplineRule(Rule):
    name = "fence-discipline"
    description = (
        "stores to engine-visible device state (self._d_*, generation) "
        "reachable from the device-worker domain must re-check the "
        "generation fence between staging and store (ops/engine.py "
        "_flush_host_state pattern)"
    )

    def _engine_store(self, stmt: ast.AST) -> list[tuple[str, int]]:
        out = []
        targets: list[ast.AST] = []
        if isinstance(stmt, ast.Assign):
            targets = list(stmt.targets)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            targets = [stmt.target]
        for t in targets:
            attr = _self_attr_of(t)
            if attr and (attr.startswith("_d_") or attr == "generation"):
                out.append((attr, stmt.lineno))
        return out

    def _scan_body(self, body: list, fenced: bool, qual: str,
                   mod: ModuleInfo, findings: list) -> bool:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if _is_fence(stmt):
                fenced = True
                continue
            stores = self._engine_store(stmt)
            if stores:
                for attr, line in stores:
                    if not fenced:
                        findings.append(Finding(
                            rule=self.name, path=mod.rel, line=line,
                            message=(
                                f"store to engine-visible self.{attr} "
                                "without a generation re-check between "
                                "staging and store — a watchdog-"
                                "abandoned worker unwedging here would "
                                "commit stale arrays over a rebuilt "
                                "engine (doc/concurrency.md#fences)"
                            ),
                            detector=f"unfenced-store:{attr}",
                            scope=qual,
                        ))
                continue  # a fenced store keeps the fence for its block
            if isinstance(stmt, (ast.If, ast.For, ast.While, ast.With,
                                 ast.Try)):
                # The test/iter expression may itself call out.
                header = getattr(stmt, "test", None) or \
                    getattr(stmt, "iter", None)
                if header is not None and _has_unfenced_reset(
                        ast.Expr(value=header)):
                    fenced = False
                # Each branch is scanned from the PRE-statement state,
                # and the post-statement state is the conjunction of
                # every path's exit state — a fence inside one branch
                # must never license a store on the path that skipped
                # it (if-without-else, a zero-iteration loop, a raising
                # try body all fall through unfenced).
                exits = []
                branches = [getattr(stmt, "body", [])]
                if getattr(stmt, "orelse", None):
                    branches.append(stmt.orelse)
                elif isinstance(stmt, (ast.If, ast.For, ast.While)):
                    exits.append(fenced)  # the skipped/fall-through path
                if isinstance(stmt, (ast.For, ast.While)):
                    exits.append(fenced)  # zero iterations
                for h in getattr(stmt, "handlers", []):
                    branches.append(h.body)
                for sub in branches:
                    exits.append(self._scan_body(sub, fenced, qual, mod,
                                                 findings))
                fenced = all(exits) if exits else fenced
                if getattr(stmt, "finalbody", None):
                    fenced = self._scan_body(stmt.finalbody, fenced,
                                             qual, mod, findings)
                continue
            if _has_unfenced_reset(stmt):
                fenced = False
        return fenced

    def check_module(self, mod: ModuleInfo, repo: RepoContext) -> list[Finding]:
        if mod.rel != _ENGINE_REL:
            return []
        model = threadmodel.build_model(repo)
        findings: list[Finding] = []
        for fn in iter_functions(mod.tree):
            domains = model.domains_of(mod.rel, fn.qualname)
            if "device-worker" not in domains:
                continue
            self._scan_body(list(getattr(fn.node, "body", [])),
                            False, fn.qualname, mod, findings)
        return findings


# ---------------------------------------------------------------------------
# live-iter
# ---------------------------------------------------------------------------

_VIEW_METHODS = {"items", "values", "keys"}


class LiveIterRule(Rule):
    name = "live-iter"
    description = (
        "off-loop functions must not iterate loop-owned mapping views "
        "(for/comprehension over x.y.items()); snapshot with "
        "list()/sorted() first (single C-level copy)"
    )

    def check_module(self, mod: ModuleInfo, repo: RepoContext) -> list[Finding]:
        if not threadmodel.in_scope(mod.rel):
            return []
        model = threadmodel.build_model(repo)
        findings: list[Finding] = []
        for fn in iter_functions(mod.tree):
            domains = model.domains_of(mod.rel, fn.qualname)
            off = model.off_loop(domains)
            if not off:
                continue
            # Iteration under a held lock is the OTHER legitimate
            # pattern (the flight recorder's dump walks its ring dict
            # inside `with self._rings_lock:`): exempt With blocks
            # whose context expression names a lock/condition.
            locked_spans = []
            for node in ast.walk(fn.node):
                if isinstance(node, ast.With):
                    for item in node.items:
                        name = (dotted(item.context_expr) or "").lower()
                        if "lock" in name or "cond" in name:
                            locked_spans.append(
                                (node.lineno, node.end_lineno or node.lineno)
                            )
                            break
            iters: list[ast.AST] = []
            for node in direct_body_nodes(fn.node):
                if isinstance(node, ast.For):
                    iters.append(node.iter)
                elif isinstance(node, (ast.ListComp, ast.SetComp,
                                       ast.DictComp, ast.GeneratorExp)):
                    iters.extend(gen.iter for gen in node.generators)
            iters = [
                it for it in iters
                if not any(lo <= it.lineno <= hi for lo, hi in locked_spans)
            ]
            for it in iters:
                if not isinstance(it, ast.Call):
                    continue
                func = it.func
                if not (isinstance(func, ast.Attribute)
                        and func.attr in _VIEW_METHODS):
                    continue
                receiver = dotted(func.value)
                if receiver is None or "." not in receiver:
                    continue  # locals and bare names are out of scope
                findings.append(Finding(
                    rule=self.name, path=mod.rel, line=it.lineno,
                    message=(
                        f"iterating {receiver}.{func.attr}() from the "
                        f"{'/'.join(off)} thread(s) races loop mutations "
                        "across bytecode boundaries — snapshot first: "
                        f"list({receiver}.{func.attr}())"
                    ),
                    detector=f"live-iter:{receiver}.{func.attr}",
                    scope=fn.qualname,
                ))
        return findings
