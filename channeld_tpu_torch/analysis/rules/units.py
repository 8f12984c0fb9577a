"""histogram-units: one unit convention for every histogram family.

The metric surface accumulated two unit idioms — ``*_seconds``
families (the reference's prometheus-idiomatic convention) and
``*_ms`` families (the soak/bench artifacts' readability convention).
Both are fine; an *unlabeled* family or a family whose bucket edges
were authored in the other unit is not (a dashboard reading
``trunk_rtt`` as seconds is off by 1000x and nothing fails). The
convention (doc/observability.md#metric-unit-conventions):

- Every ``Histogram`` declared in ``core/metrics.py`` must end in
  ``_ms``, ``_seconds`` or ``_bytes``.
- Bucket edges must be plausible for the suffix: ``_seconds`` edges
  live in [1e-6, 600] (nothing the gateway times takes ten minutes);
  ``_ms`` edges live in [1e-3, 600000] AND the largest edge is at
  least 0.5 (an _ms family whose edges top out below half a
  millisecond was almost certainly authored in seconds); ``_bytes``
  edges are positive.
- A histogram with no explicit ``buckets=`` uses prometheus' default
  edges, which are seconds-scale — so the name must end ``_seconds``.

Grandfathered families (reference-parity names that predate the
convention) are baselined with reasons in ``analysis_baseline.json``.
"""

from __future__ import annotations

import ast

from ..engine import Finding, ModuleInfo, RepoContext, Rule

METRICS_REL = "channeld_tpu_torch/core/metrics.py"

# suffix -> (min edge, max edge) plausibility band.
_EDGE_BANDS = {
    "_seconds": (1e-6, 600.0),
    "_ms": (1e-3, 600000.0),
    "_bytes": (1.0, float("inf")),
}


def _const_edges(node: ast.AST) -> list[float] | None:
    """Numeric bucket edges from a literal tuple/list; None when the
    expression is not a literal sequence of numbers."""
    if not isinstance(node, (ast.Tuple, ast.List)):
        return None
    edges: list[float] = []
    for e in node.elts:
        if isinstance(e, ast.Constant) and isinstance(e.value, (int, float)):
            edges.append(float(e.value))
        else:
            return None
    return edges


class HistogramUnitsRule(Rule):
    name = "histogram-units"
    description = (
        "histogram families in core/metrics.py end in _ms/_seconds/"
        "_bytes and their bucket edges match the suffix"
    )

    def check_module(self, mod: ModuleInfo, repo: RepoContext) -> list[Finding]:
        if mod.rel != METRICS_REL:
            return []
        # Module-level literal-tuple constants (shared bucket tables
        # like DELIVERY_LATENCY_BUCKETS): a buckets= referencing one
        # resolves to its edges instead of escaping the check.
        consts: dict[str, list[float]] = {}
        for node in ast.walk(mod.tree):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                edges = _const_edges(node.value)
                if edges is not None:
                    consts[node.targets[0].id] = edges
        findings: list[Finding] = []
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)):
                continue
            func = node.value.func
            ctor = func.attr if isinstance(func, ast.Attribute) else (
                func.id if isinstance(func, ast.Name) else "")
            if ctor != "Histogram":
                continue
            attr = node.targets[0].id
            args = node.value.args
            prom_name = ""
            if args and isinstance(args[0], ast.Constant) \
                    and isinstance(args[0].value, str):
                prom_name = args[0].value
            suffix = next(
                (s for s in _EDGE_BANDS if prom_name.endswith(s)), None)
            if suffix is None:
                findings.append(Finding(
                    rule=self.name, path=mod.rel, line=node.lineno,
                    message=(
                        f"histogram {prom_name!r} has no unit suffix; "
                        "families must end in _ms/_seconds/_bytes "
                        "(doc/observability.md#metric-unit-conventions)"
                    ),
                    detector=f"suffix:{attr}", scope="",
                ))
                continue
            buckets_node = next(
                (kw.value for kw in node.value.keywords
                 if kw.arg == "buckets"), None)
            if buckets_node is None:
                if suffix != "_seconds":
                    findings.append(Finding(
                        rule=self.name, path=mod.rel, line=node.lineno,
                        message=(
                            f"histogram {prom_name!r} uses the prometheus "
                            "default buckets, which are seconds-scale, "
                            f"but is named {suffix}"
                        ),
                        detector=f"edges:{attr}", scope="",
                    ))
                continue
            edges = _const_edges(buckets_node)
            if edges is None and isinstance(buckets_node, ast.Name):
                edges = consts.get(buckets_node.id)
            if edges is None or not edges:
                continue  # computed edges: out of static reach
            lo, hi = _EDGE_BANDS[suffix]
            bad = [e for e in edges if not (lo <= e <= hi)]
            if bad:
                findings.append(Finding(
                    rule=self.name, path=mod.rel, line=node.lineno,
                    message=(
                        f"histogram {prom_name!r} ({suffix}) has bucket "
                        f"edges {bad} outside the plausible "
                        f"[{lo}, {hi}] band for its unit"
                    ),
                    detector=f"edges:{attr}", scope="",
                ))
            elif suffix == "_ms" and max(edges) < 0.5:
                findings.append(Finding(
                    rule=self.name, path=mod.rel, line=node.lineno,
                    message=(
                        f"histogram {prom_name!r} is named _ms but every "
                        f"bucket edge is under 0.5 (max {max(edges)}) — "
                        "edges authored in seconds?"
                    ),
                    detector=f"edges:{attr}", scope="",
                ))
        return findings
