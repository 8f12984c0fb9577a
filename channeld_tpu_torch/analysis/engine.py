"""tpulint rule engine: findings, suppressions, baseline, runner.

The analysis suite turns the project's review-enforced conventions into
mechanical checks (doc/analysis.md).  Design points:

- **Pure static**: rules work on ``ast`` trees and file text only; no
  project module is imported (the proto-drift rule reads pb2 *source*,
  so it can inspect a drifted descriptor without executing it).
- **Findings fail the build** (tier-1 runs the full suite via
  ``tests/test_analysis.py``) unless suppressed with a *reason*, either
  inline (``# tpulint: disable=rule -- reason``) or in the committed
  baseline file ``channeld_tpu_torch/analysis/baseline.json`` (the
  port's own; the JAX package keeps ``analysis_baseline.json``).  A suppression without a
  reason is itself a finding; a baseline entry nothing matches is
  reported as stale so suppressions cannot outlive their target.
- **Stable keys**: baseline entries key on
  ``rule:path:scope:detector`` — no line numbers, so unrelated edits
  don't rot the baseline.
"""

from __future__ import annotations

import ast
import fnmatch
import json
import os
import re
from dataclasses import dataclass, field

BASELINE_FILE = "channeld_tpu_torch/analysis/baseline.json"

# Directories and single files scanned for python modules (relative to
# repo root): the port and the scripts that drive it on the card.
PY_SCAN_DIRS = ("channeld_tpu_torch",)
PY_SCAN_FILES = ("chip_smoke.py", "chip_host.py")
_SKIP_PARTS = ("__pycache__",)
_SKIP_SUFFIXES = ("_pb2.py",)


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # repo-relative, forward slashes
    line: int
    message: str
    detector: str      # stable tag for the baseline key (no line numbers)
    scope: str = ""    # enclosing symbol (function/class/message), if any

    @property
    def key(self) -> str:
        return f"{self.rule}:{self.path}:{self.scope}:{self.detector}"

    def render(self) -> str:
        where = f"{self.path}:{self.line}"
        scope = f" [{self.scope}]" if self.scope else ""
        return f"{where}: {self.rule}{scope}: {self.message}"


@dataclass
class ModuleInfo:
    """One python module under analysis."""

    path: str          # absolute
    rel: str           # repo-relative, forward slashes
    text: str
    tree: ast.AST
    lines: list[str] = field(default_factory=list)

    @classmethod
    def load(cls, path: str, repo: str) -> "ModuleInfo | SyntaxError":
        rel = os.path.relpath(path, repo).replace(os.sep, "/")
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        try:
            tree = ast.parse(text, filename=rel)
        except SyntaxError as e:
            return e
        return cls(path=path, rel=rel, text=text, tree=tree,
                   lines=text.split("\n"))


@dataclass
class RepoContext:
    """Everything a rule may look at."""

    root: str
    modules: list[ModuleInfo]
    # None = analyze everything (full run); a set of repo-relative paths
    # = only report findings attributable to those files (--changed).
    changed: set[str] | None = None
    # (repo-relative path, error text) for files ast could not parse —
    # surfaced as findings so an unparseable module can never silently
    # evade every rule.
    parse_failures: list[tuple[str, str]] = field(default_factory=list)

    def module(self, rel: str) -> ModuleInfo | None:
        for m in self.modules:
            if m.rel == rel:
                return m
        return None

    def read(self, rel: str) -> str | None:
        path = os.path.join(self.root, rel)
        if not os.path.exists(path):
            return None
        with open(path, encoding="utf-8") as fh:
            return fh.read()


class Rule:
    """Base rule.  Subclasses set ``name``/``description`` and override
    one or both hooks."""

    name = ""
    description = ""
    # Repo-wide rules attribute findings to files OTHER than the one
    # that changed (a .proto edit flags the stale pb2): their findings
    # survive the --changed filter whenever the rule runs at all (the
    # driver gates WHETHER it runs on the changed set).
    repo_wide = False

    def check_module(self, mod: ModuleInfo, repo: RepoContext) -> list[Finding]:
        return []

    def check_repo(self, repo: RepoContext) -> list[Finding]:
        return []


# ---------------------------------------------------------------------------
# inline suppressions
# ---------------------------------------------------------------------------

_DISABLE_RE = re.compile(
    r"#\s*tpulint:\s*disable=([a-z0-9_,-]+)(?:\s+--\s+(.*\S))?"
)


def inline_suppressions(
    mod: ModuleInfo,
) -> tuple[dict[int, set[str]], list[Finding]]:
    """{line number: {rule names}} suppressed inline, plus findings for
    suppressions missing the mandatory ``-- reason``.

    A directive covers its own line and, when it is a comment-only
    line, the next line.
    """
    by_line: dict[int, set[str]] = {}
    findings: list[Finding] = []
    for i, line in enumerate(mod.lines, start=1):
        m = _DISABLE_RE.search(line)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        if not m.group(2):
            findings.append(Finding(
                rule="tpulint",
                path=mod.rel,
                line=i,
                message="tpulint disable comment without a '-- reason'",
                detector="disable-without-reason",
                scope="",
            ))
            continue
        by_line.setdefault(i, set()).update(rules)
        if line.strip().startswith("#"):
            by_line.setdefault(i + 1, set()).update(rules)
    return by_line, findings


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------

@dataclass
class Baseline:
    entries: dict[str, str]  # key -> reason

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls(entries={})
        with open(path) as fh:
            doc = json.load(fh)
        entries: dict[str, str] = {}
        for item in doc.get("suppressions", []):
            key = item.get("key", "")
            reason = (item.get("reason") or "").strip()
            if key:
                entries[key] = reason
        return cls(entries=entries)


@dataclass
class Report:
    findings: list[Finding]               # unsuppressed — these fail
    suppressed: list[tuple[Finding, str]]  # (finding, reason)
    stale_baseline: list[str]             # baseline keys nothing matched
    unreasoned_baseline: list[str]        # baseline keys without a reason

    @property
    def ok(self) -> bool:
        return not self.findings and not self.unreasoned_baseline


def _iter_py_files(repo: str) -> list[str]:
    out: list[str] = [os.path.join(repo, f) for f in PY_SCAN_FILES
                      if os.path.exists(os.path.join(repo, f))]
    for top in PY_SCAN_DIRS:
        base = os.path.join(repo, top)
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames if d not in _SKIP_PARTS]
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                if any(fn.endswith(sfx) for sfx in _SKIP_SUFFIXES):
                    continue
                out.append(os.path.join(dirpath, fn))
    return out


def load_repo(
    repo: str, changed: set[str] | None = None
) -> RepoContext:
    modules = []
    failures: list[tuple[str, str]] = []
    for path in _iter_py_files(repo):
        mod = ModuleInfo.load(path, repo)
        if isinstance(mod, ModuleInfo):
            modules.append(mod)
        else:
            rel = os.path.relpath(path, repo).replace(os.sep, "/")
            failures.append((rel, str(mod)))
    return RepoContext(root=repo, modules=modules, changed=changed,
                       parse_failures=failures)


def run_analysis(
    repo: RepoContext,
    rules: list[Rule],
    baseline: Baseline | None = None,
) -> Report:
    baseline = baseline or Baseline(entries={})
    raw: list[Finding] = []
    for rel, err in repo.parse_failures:
        raw.append(Finding(
            rule="tpulint", path=rel, line=1,
            message=f"module does not parse ({err}); it is invisible to "
                    "every rule",
            detector="syntax-error",
        ))
    sup_map: dict[str, dict[int, set[str]]] = {}
    for mod in repo.modules:
        by_line, meta = inline_suppressions(mod)
        sup_map[mod.rel] = by_line
        raw.extend(meta)
        for rule in rules:
            raw.extend(rule.check_module(mod, repo))
    for rule in rules:
        raw.extend(rule.check_repo(repo))

    if repo.changed is not None:
        repo_wide = {r.name for r in rules if r.repo_wide}
        raw = [f for f in raw
               if f.path in repo.changed or f.rule in repo_wide]

    findings: list[Finding] = []
    suppressed: list[tuple[Finding, str]] = []
    used_keys: set[str] = set()
    for f in raw:
        inline = sup_map.get(f.path, {}).get(f.line, set())
        if f.rule in inline:
            suppressed.append((f, "inline"))
            continue
        if f.key in baseline.entries:
            used_keys.add(f.key)
            suppressed.append((f, baseline.entries[f.key]))
            continue
        findings.append(f)

    stale = []
    if repo.changed is None:
        # Only a full run can prove a baseline entry stale, and only for
        # the rules that actually ran.
        ran = {r.name for r in rules}
        stale = sorted(
            key for key in set(baseline.entries) - used_keys
            if key.split(":", 1)[0] in ran
        )
    # A reason is mandatory for EVERY committed entry, matched or stale
    # — a reasonless entry whose finding has since disappeared must
    # still fail, or it silently outlives its justification.
    unreasoned = sorted(
        key for key, reason in baseline.entries.items() if not reason
    )
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return Report(
        findings=findings,
        suppressed=suppressed,
        stale_baseline=stale,
        unreasoned_baseline=unreasoned,
    )


def match_scope(rel: str, name: str,
                spec: tuple[tuple[str, str], ...]) -> bool:
    """True when (module path, function name) matches one (glob, regex)
    row of a scope spec."""
    for glob, name_re in spec:
        if fnmatch.fnmatch(rel, glob) and re.match(name_re, name):
            return True
    return False
