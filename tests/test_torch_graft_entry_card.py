"""Phase 20 of ``chip_smoke.py`` small on the card: the port's
``graft_entry`` (``__graft_entry__.py``'s entry points) against the plain
kernels and the CPU. No JAX here: the card's machine has none, and
``tests/test_torch_graft_entry.py`` holds the module to the JAX package."""

from __future__ import annotations

import pytest
import torch

from test_torch_elastic import chip_smoke


@pytest.mark.cuda
def test_graft_entry_on_the_card():
    """20a on the card (every output equal to the CPU run, K1 and K2 once
    each and exact against their plain versions) and 20c at 4 shards on
    one card (equal to its CPU run, the launches its meshes make)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from channeld_tpu_torch.ops import cuda_kernels as K

    cs = chip_smoke()
    K.build()
    dev = torch.device("cuda", 0)
    launches, entries = cs.phase_graft_step(K, dev, "20a", {})
    assert launches == {"assign_count": 1, "aoi": 1}
    assert {e["max_abs_err"] for e in entries.values()} == {0}
    assert cs.phase_graft_dryrun(K, 4, devices=[dev] * 4) == cs.dryrun_launches(4)
