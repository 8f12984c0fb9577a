"""tpulint for the port: the project-invariant static-analysis suite
over ``channeld_tpu_torch`` and ``chip_smoke.py``.

The JAX package's suite restated for torch: proto/pb2 drift + one global
msgType registry, no blocking calls (torch's synchronizing calls among
them) in async paths, no implicit device->host syncs (``.item()``,
``.cpu()``, ``.numpy()``, ``.tolist()``, ``np.asarray`` of a tensor,
``torch.cuda.synchronize``, ...) in tick paths, double-entry
counter/ledger accounting, exception hygiene in the hot paths, and the
thread model's rules over the port's modules.

Driver: ``python -m channeld_tpu_torch.analysis`` (``--changed`` for
pre-commit). Docs: ``doc/analysis.md``. Gate:
``tests/test_torch_analysis.py``. Baseline:
``channeld_tpu_torch/analysis/baseline.json``.
"""

from .engine import (  # noqa: F401
    BASELINE_FILE,
    Baseline,
    Finding,
    ModuleInfo,
    RepoContext,
    Report,
    Rule,
    load_repo,
    run_analysis,
)
from .rules import ALL_RULES, make_rules  # noqa: F401
