"""async-blocking: no synchronous blocking calls on the event loop.

The gateway is a single event loop: one ``time.sleep`` or sync socket
dial inside a coroutine stalls EVERY channel tick, trunk heartbeat and
client read for its duration — the exact failure mode the tick-budget
anomaly trigger exists to catch at runtime (doc/observability.md).
This rule catches it at lint time instead, across the event-loop
planes: core, federation, spatial.

Two scopes, union'd per function:

- **Lexical** (the original rule): any call site inside an ``async
  def`` (closures included — they run inline on the loop unless
  explicitly executor-bound).
- **Reachability** (doc/concurrency.md): any SYNC function whose
  thread-model domain set (analysis/threadmodel.py) includes a
  *steady* loop domain — tick-loop or trunk-reader — is on the loop
  just as surely as a coroutine is; per-function syntax cannot see the
  helper three calls below ``tick_once`` that opens a file.  The
  boot-loop domain is deliberately exempt: run_server/drain block
  before listeners open and after they close.

Detectors beyond the call table: ``Future.result()`` without a timeout
parks the loop indefinitely behind a worker (the device guard always
bounds its waits), and torch's ``.synchronize()`` (``torch.cuda``, an
``Event``, a ``Stream``) is a full device wait.
"""

from __future__ import annotations

import ast
import fnmatch

from .. import threadmodel
from ..astutil import call_name, direct_body_nodes, dotted, import_aliases, iter_functions
from ..engine import Finding, ModuleInfo, RepoContext, Rule

SCOPE_GLOBS = (
    "channeld_tpu_torch/core/*.py",
    "channeld_tpu_torch/federation/*.py",
    "channeld_tpu_torch/spatial/*.py",
)

# Canonical call name -> short description of why it blocks.
BLOCKING_CALLS = {
    "time.sleep": "blocks the event loop; use await asyncio.sleep",
    "os.system": "spawns and WAITS for a shell on the loop",
    "os.popen": "synchronous pipe I/O on the loop",
    "os.fsync": "a disk flush can stall the loop for tens of ms; fsync "
                "belongs on a writer thread (core/wal.py discipline)",
    "subprocess.run": "synchronous subprocess wait on the loop",
    "subprocess.call": "synchronous subprocess wait on the loop",
    "subprocess.check_call": "synchronous subprocess wait on the loop",
    "subprocess.check_output": "synchronous subprocess wait on the loop",
    "subprocess.getoutput": "synchronous subprocess wait on the loop",
    "subprocess.Popen": "subprocess spawn blocks on fork/exec",
    "socket.create_connection": "synchronous TCP dial on the loop",
    "socket.socket": "raw sync socket in a coroutine",
    "socket.getaddrinfo": "synchronous DNS resolution on the loop",
    "open": "synchronous file open/read on the loop",
    "time.sleep_ms": "blocks the event loop",
    "torch.cuda.synchronize": "full device sync stalls the loop for the "
                              "whole launch queue",
}


class AsyncBlockingRule(Rule):
    name = "async-blocking"
    description = (
        "no time.sleep / sync socket / file I/O / fsync / subprocess / "
        "unbounded .result() calls on the event loop: async defs "
        "(lexical) plus sync functions reachable from the tick-loop/"
        "trunk-reader domains (call graph)"
    )

    def check_module(self, mod: ModuleInfo, repo: RepoContext) -> list[Finding]:
        lexical_scope = any(
            fnmatch.fnmatch(mod.rel, g) for g in SCOPE_GLOBS
        )
        reach_scope = threadmodel.in_scope(mod.rel)
        if not lexical_scope and not reach_scope:
            return []
        model = threadmodel.build_model(repo) if reach_scope else None
        aliases = import_aliases(mod.tree)
        findings: list[Finding] = []
        for fn in iter_functions(mod.tree):
            lexical = lexical_scope and fn.in_async
            reach = ""
            if not lexical and model is not None:
                domains = model.domains_of(mod.rel, fn.qualname)
                if model.is_steady_loop(domains):
                    reach = "/".join(sorted(
                        d for d in domains
                        if threadmodel.DOMAINS_BY_NAME[d].thread == "loop"
                        and threadmodel.DOMAINS_BY_NAME[d].steady
                    ))
            if not lexical and not reach:
                continue
            why_ctx = (
                "in async context" if lexical
                else f"reachable from the {reach} domain"
            )
            for node in direct_body_nodes(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                func = node.func
                # Unbounded worker wait: fut.result() with no timeout
                # parks the loop behind the worker indefinitely. SYNC
                # functions only: inside a coroutine the receiver is
                # usually an asyncio Task/Future, whose result() is
                # non-blocking by contract (and takes no timeout — the
                # 'add a timeout' advice would be a TypeError there).
                if isinstance(func, ast.Attribute) \
                        and func.attr == "result" \
                        and not fn.in_async \
                        and not node.args \
                        and not any(kw.arg == "timeout"
                                    for kw in node.keywords):
                    findings.append(Finding(
                        rule=self.name, path=mod.rel, line=node.lineno,
                        message=(
                            f".result() without a timeout {why_ctx}: an "
                            "unbounded wait on a worker parks the loop "
                            "(the device guard always bounds its waits)"
                        ),
                        detector="result-no-timeout",
                        scope=fn.qualname,
                    ))
                    continue
                if isinstance(func, ast.Attribute) \
                        and func.attr == "synchronize":
                    findings.append(Finding(
                        rule=self.name, path=mod.rel, line=node.lineno,
                        message=(
                            f"{dotted(func) or '.synchronize'}() {why_ctx}: "
                            "a device wait stalls the loop for the whole "
                            "launch queue"
                        ),
                        detector="synchronize",
                        scope=fn.qualname,
                    ))
                    continue
                name = call_name(node, aliases)
                if name is None:
                    continue
                why = BLOCKING_CALLS.get(name)
                if why is None:
                    continue
                findings.append(Finding(
                    rule=self.name,
                    path=mod.rel,
                    line=node.lineno,
                    message=f"blocking call {name}() {why_ctx}: {why}",
                    detector=name,
                    scope=fn.qualname,
                ))
        return findings
