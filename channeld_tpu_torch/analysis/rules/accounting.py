"""double-entry: metric declarations are the registry; bumps pair with
ledgers.

Two checks:

1. **Ledger pairing.**  Every Prometheus Counter in ``core/metrics.py``
   whose help text names a python ledger ("ledger" appears in the help)
   is double-entry: soak invariant checkers assert the python-side
   ledger equals the metric exactly, so a bump without the paired
   ledger write silently breaks soak accounting.  The rule requires
   every ``.inc()`` of a ledgered counter to sit in a function that
   also performs a ledger write (a ``self.X[...] = / +=`` dict store,
   a ``self.X += n`` tally, or a ``self.X.append(...)``) — the
   project-wide ``_count()`` idiom.

2. **Declaration + label-set consistency.**  Every metric referenced
   anywhere (``metrics.name`` attribute or a direct import from
   ``core.metrics``) must be declared in ``core/metrics.py``, and every
   use must match the declared label set: ``.labels()`` keywords must
   equal the declared labelnames, a labeled family cannot be bumped
   without ``.labels()``, an unlabeled one cannot be given labels, and
   positional ``.labels`` args are rejected (kwargs only — positional
   labels silently reorder on a declaration change).
"""

from __future__ import annotations

import ast

from ..astutil import dotted, iter_functions, metrics_aliases
from ..engine import Finding, ModuleInfo, RepoContext, Rule

METRICS_REL = "channeld_tpu_torch/core/metrics.py"
_METRIC_CTORS = {"Counter", "Gauge", "Histogram", "Summary"}
_BUMP_METHODS = {"inc", "dec", "set", "observe"}


class MetricDecl:
    def __init__(self, attr: str, ctor: str, prom_name: str,
                 help_text: str, labels: tuple[str, ...]):
        self.attr = attr
        self.ctor = ctor
        self.prom_name = prom_name
        self.help = help_text
        self.labels = labels

    @property
    def ledgered(self) -> bool:
        return self.ctor == "Counter" and "ledger" in self.help.lower()


def parse_metric_decls(mod: ModuleInfo) -> dict[str, MetricDecl]:
    """Metric declarations from core/metrics.py, by attribute name."""
    decls: dict[str, MetricDecl] = {}
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Call)):
            continue
        ctor = dotted(node.value.func)
        if ctor is None or ctor.split(".")[-1] not in _METRIC_CTORS:
            continue
        args = node.value.args
        prom_name = ""
        help_text = ""
        labels: tuple[str, ...] = ()
        if args and isinstance(args[0], ast.Constant) \
                and isinstance(args[0].value, str):
            prom_name = args[0].value
        if len(args) > 1 and isinstance(args[1], ast.Constant) \
                and isinstance(args[1].value, str):
            help_text = args[1].value
        for extra in args[2:]:
            if isinstance(extra, (ast.List, ast.Tuple)):
                labels = tuple(
                    e.value for e in extra.elts
                    if isinstance(e, ast.Constant) and isinstance(e.value, str)
                )
        for kw in node.value.keywords:
            if kw.arg == "labelnames" and isinstance(kw.value,
                                                    (ast.List, ast.Tuple)):
                labels = tuple(
                    e.value for e in kw.value.elts
                    if isinstance(e, ast.Constant) and isinstance(e.value, str)
                )
        decls[node.targets[0].id] = MetricDecl(
            node.targets[0].id, ctor.split(".")[-1], prom_name,
            help_text, labels,
        )
    return decls


def _has_ledger_write(func_node: ast.AST) -> bool:
    """A self-attribute dict store / tally / append anywhere in the
    function body — the python half of double-entry accounting."""
    for node in ast.walk(func_node):
        target = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
        elif isinstance(node, ast.AugAssign):
            target = node.target
        if target is not None:
            if isinstance(target, ast.Subscript) and isinstance(
                    target.value, ast.Attribute):
                return True
            if isinstance(node, ast.AugAssign) and isinstance(
                    target, ast.Attribute):
                return True
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "append"
                and isinstance(node.func.value, ast.Attribute)):
            return True
    return False


class DoubleEntryRule(Rule):
    name = "double-entry"
    description = (
        "ledgered *_total counter bumps pair with a python ledger write "
        "in the same function; every metric use matches its declaration "
        "and label set in core/metrics.py"
    )

    def _decls(self, repo: RepoContext) -> dict[str, MetricDecl]:
        cached = getattr(repo, "_metric_decls", None)
        if cached is None:
            mod = repo.module(METRICS_REL)
            cached = parse_metric_decls(mod) if mod else {}
            repo._metric_decls = cached
        return cached

    def check_module(self, mod: ModuleInfo, repo: RepoContext) -> list[Finding]:
        if mod.rel == METRICS_REL:
            return []
        decls = self._decls(repo)
        if not decls:
            return []
        mod_names, obj_names = metrics_aliases(mod.tree)
        if not mod_names and not obj_names:
            return []
        findings: list[Finding] = []
        func_of: dict[int, ast.AST] = {}
        qual_of: dict[int, str] = {}
        for fn in iter_functions(mod.tree):
            for sub in ast.walk(fn.node):
                # innermost function wins (walk order is outer->inner)
                func_of[id(sub)] = fn.node
                qual_of[id(sub)] = fn.qualname

        def metric_attr(node: ast.AST) -> str | None:
            """metrics.<attr> or a direct-imported metric name."""
            if isinstance(node, ast.Attribute) and isinstance(
                    node.value, ast.Name) and node.value.id in mod_names:
                return node.attr
            if isinstance(node, ast.Name) and node.id in obj_names:
                return obj_names[node.id]
            return None

        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if not isinstance(func, ast.Attribute):
                continue
            scope = qual_of.get(id(node), "")

            # metrics.X.labels(...) -----------------------------------
            if func.attr == "labels":
                attr = metric_attr(func.value)
                if attr is None:
                    continue
                decl = decls.get(attr)
                if decl is None:
                    findings.append(Finding(
                        rule=self.name, path=mod.rel, line=node.lineno,
                        message=f"metric {attr!r} is not declared in "
                                f"core/metrics.py",
                        detector=f"undeclared:{attr}", scope=scope))
                    continue
                if not decl.labels:
                    findings.append(Finding(
                        rule=self.name, path=mod.rel, line=node.lineno,
                        message=f"metric {attr!r} is declared without "
                                "labels but used with .labels()",
                        detector=f"labels-on-unlabeled:{attr}", scope=scope))
                    continue
                if node.args:
                    findings.append(Finding(
                        rule=self.name, path=mod.rel, line=node.lineno,
                        message=f"positional .labels() args on {attr!r}; "
                                "use keywords so a declaration reorder "
                                "cannot silently swap label values",
                        detector=f"positional-labels:{attr}", scope=scope))
                    continue
                used = {kw.arg for kw in node.keywords if kw.arg}
                if used != set(decl.labels):
                    findings.append(Finding(
                        rule=self.name, path=mod.rel, line=node.lineno,
                        message=f"label set {sorted(used)} on {attr!r} "
                                f"does not match declared "
                                f"{sorted(decl.labels)}",
                        detector=f"label-mismatch:{attr}", scope=scope))
                continue

            # metrics.X.inc()/set()/observe()/dec() -------------------
            if func.attr in _BUMP_METHODS:
                base = func.value
                attr = metric_attr(base)
                labeled_call = False
                if attr is None and isinstance(base, ast.Call) \
                        and isinstance(base.func, ast.Attribute) \
                        and base.func.attr == "labels":
                    attr = metric_attr(base.func.value)
                    labeled_call = True
                if attr is None:
                    continue
                decl = decls.get(attr)
                if decl is None:
                    findings.append(Finding(
                        rule=self.name, path=mod.rel, line=node.lineno,
                        message=f"metric {attr!r} is not declared in "
                                f"core/metrics.py",
                        detector=f"undeclared:{attr}", scope=scope))
                    continue
                if decl.labels and not labeled_call:
                    findings.append(Finding(
                        rule=self.name, path=mod.rel, line=node.lineno,
                        message=f"labeled metric {attr!r} bumped without "
                                f".labels() (declared labels: "
                                f"{sorted(decl.labels)})",
                        detector=f"missing-labels:{attr}", scope=scope))
                if decl.ledgered and func.attr == "inc":
                    owner = func_of.get(id(node))
                    if owner is None or not _has_ledger_write(owner):
                        findings.append(Finding(
                            rule=self.name, path=mod.rel, line=node.lineno,
                            message=f"ledgered counter {attr!r} bumped "
                                    "without a python ledger write in the "
                                    "same function (double-entry: soaks "
                                    "assert ledger == metric exactly)",
                            detector=f"unpaired:{attr}", scope=scope))
        return findings
