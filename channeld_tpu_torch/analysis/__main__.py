"""tpulint over the port: run the static-analysis suite on
``channeld_tpu_torch`` and ``chip_smoke.py``.

Usage (from the repository root):
    python -m channeld_tpu_torch.analysis              # full run (tier-1 runs it)
    python -m channeld_tpu_torch.analysis --changed    # only files changed vs git
    python -m channeld_tpu_torch.analysis --rule hot-readback
    python -m channeld_tpu_torch.analysis --json       # machine-readable findings
    python -m channeld_tpu_torch.analysis --list       # rule names + descriptions

Exit status: 0 clean (suppressed findings and a reason-annotated
baseline are clean), 1 findings or a baseline entry without a reason.
Stale baseline entries (nothing matches them any more) are reported on
a full run so suppressions cannot outlive their target.

Suppression (doc/analysis.md#baseline--suppressions):
- inline: ``# tpulint: disable=<rule> -- <reason>``
- committed baseline: ``channeld_tpu_torch/analysis/baseline.json``,
  entries ``{"key": "<rule>:<path>:<scope>:<detector>", "reason": ...}``.

``--changed`` is the pre-commit fast path: python findings are filtered
to files with uncommitted changes (staged, unstaged, or untracked);
repo-wide rules (proto-drift, the msgType registry) only run when a
schema/registry file changed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from . import BASELINE_FILE, Baseline, load_repo, make_rules, run_analysis

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Files that feed the repo-wide proto-drift/registry checks: a change to
# any of them re-runs the whole rule even in --changed mode.
_PROTO_TRIGGERS = (
    "channeld_tpu_torch/protocol/",
    "channeld_tpu_torch/core/types.py",
    "channeld_tpu_torch/federation/trunk.py",
)
# The metric registry: editing it can invalidate label sets / ledger
# pairing in UNCHANGED files, so a change here promotes the
# double-entry rule to repo-wide for this run (its findings survive
# the changed-files filter).
_METRICS_TRIGGER = "channeld_tpu_torch/core/metrics.py"


def changed_files(repo: str) -> set[str] | None:
    """Files changed vs git (staged + unstaged + untracked), or None
    when git itself is unusable — the caller must then fall back to a
    FULL run rather than silently reporting a clean tree."""
    out: set[str] = set()
    failures = 0
    cmds = (
        ["git", "diff", "--name-only"],
        ["git", "diff", "--cached", "--name-only"],
        ["git", "ls-files", "-o", "--exclude-standard"],
    )
    for cmd in cmds:
        try:
            proc = subprocess.run(
                cmd, cwd=repo, capture_output=True, text=True, check=True
            )
        except (OSError, subprocess.CalledProcessError):
            failures += 1
            continue
        out.update(line.strip() for line in proc.stdout.splitlines()
                   if line.strip())
    if failures == len(cmds):
        return None
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--changed", action="store_true",
                    help="fast mode: only report findings in files "
                         "changed vs git (pre-commit)")
    ap.add_argument("--rule", action="append", default=None,
                    help="run only this rule (repeatable)")
    ap.add_argument("--json", action="store_true",
                    help="print findings as JSON")
    ap.add_argument("--list", action="store_true",
                    help="list rules and exit")
    ap.add_argument("--baseline", default=os.path.join(REPO, BASELINE_FILE),
                    help=f"baseline file (default: {BASELINE_FILE})")
    ap.add_argument("--repo", default=REPO, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    rules = make_rules(args.rule)
    if args.list:
        for r in rules:
            print(f"{r.name:16s} {r.description}")
        return 0

    changed: set[str] | None = None
    if args.changed:
        changed = changed_files(args.repo)
        if changed is None:
            print("tpulint: git unavailable; falling back to a FULL run",
                  file=sys.stderr)
        elif not changed:
            print("tpulint: no changed files")
            return 0
        else:
            if not any(f.startswith(_PROTO_TRIGGERS) for f in changed):
                rules = [r for r in rules if r.name != "proto-drift"]
            if _METRICS_TRIGGER in changed:
                for r in rules:
                    if r.name == "double-entry":
                        r.repo_wide = True
            if not rules:
                print("tpulint: no applicable rules for the changed set")
                return 0

    repo = load_repo(args.repo, changed=changed)
    baseline = Baseline.load(args.baseline)
    report = run_analysis(repo, rules, baseline)

    if args.json:
        # Per-domain stats from the thread model (doc/concurrency.md):
        # reachable-function counts per execution domain plus the
        # thread/executor entry-point census — what CI and
        # check_artifacts gate on (a domain whose count collapses to 0
        # means the model rotted even if no rule fired).
        from . import threadmodel

        model = threadmodel.build_model(repo)
        print(json.dumps({
            "findings": [
                {"rule": f.rule, "path": f.path, "line": f.line,
                 "scope": f.scope, "message": f.message, "key": f.key}
                for f in report.findings
            ],
            "suppressed": len(report.suppressed),
            "stale_baseline": report.stale_baseline,
            "unreasoned_baseline": report.unreasoned_baseline,
            "domains": model.stats(),
            "thread_entries": [
                {"kind": s.kind, "path": s.rel, "line": s.line,
                 "target": s.target_repr, "declared": s.declared}
                for s in model.sites
            ],
            "ok": report.ok,
        }, indent=2))
    else:
        for f in report.findings:
            print(f"FINDING: {f.render()}")
            print(f"         baseline key: {f.key}")
        for key in report.unreasoned_baseline:
            print(f"BASELINE WITHOUT REASON: {key}")
        for key in report.stale_baseline:
            print(f"stale baseline entry (no longer matches): {key}")
        n_sup = len(report.suppressed)
        # changed=None means the git fallback promoted this to a full run.
        mode = "changed-files" if changed is not None else "full"
        print(f"tpulint [{mode}]: {len(report.findings)} finding(s), "
              f"{n_sup} suppressed, {len(rules)} rule(s), "
              f"{len(repo.modules)} module(s)")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
