"""``channeld_tpu_torch.graft_entry`` against ``__graft_entry__.py``.

``__graft_entry__.py`` (loaded by path) holds the JAX system's top-level entry
points: ``_example_inputs``, ``entry()`` (one jittable ``spatial_step`` with
its example arguments) and ``dryrun_multichip(n)`` (the serving engine over
an n-device mesh). The port's module is held to it on the CPU:

- the port's example inputs equal JAX's element by element, and JAX's
  example arguments, as numpy arrays, become the port's tensors;
- the port's ``entry()`` ``fn`` equals JAX's jitted ``fn`` on the same
  inputs, every output exactly (all are int or bool);
- ``dryrun_multichip(8, device="cpu")`` passes its own checks, and each
  tick's decisions equal a single-device JAX ``SpatialEngine`` driven
  through the same script (JAX's meshed dry run is not run here: its
  compiles are heavy for this suite);
- the entry points want a card unless given the CPU, and a mesh wants as
  many devices as it has shards.

Its ``cuda`` case, which runs phase 20 on the card, sits in
``test_torch_graft_entry_card.py``: the card's machine has no JAX.
"""

from __future__ import annotations

import ast
import importlib.util
import os
import sys

import jax
import numpy as np
import pytest
import torch

from channeld_tpu_torch import graft_entry as G
from test_torch_elastic import REPO

SIZES = {"entry": {}, "sidecar-cut": dict(n=3000, q=96, s=512, cols=15, rows=15)}


def jax_entry():
    """``__graft_entry__.py``, loaded by path."""
    if "__graft_entry__" not in sys.modules:
        path = os.path.join(REPO, "__graft_entry__.py")
        spec = importlib.util.spec_from_file_location("__graft_entry__", path)
        module = importlib.util.module_from_spec(spec)
        sys.modules["__graft_entry__"] = module
        spec.loader.exec_module(module)
    return sys.modules["__graft_entry__"]


def host(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(want, got):
    a, b = np.asarray(want), host(got)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def test_the_port_has_every_entry_point():
    """Every function of ``__graft_entry__.py`` has its namesake here."""
    with open(os.path.join(REPO, "__graft_entry__.py")) as f:
        names = [n.name for n in ast.parse(f.read()).body if isinstance(n, ast.FunctionDef)]
    assert names == ["_example_inputs", "entry", "dryrun_multichip"]
    assert all(callable(getattr(G, name)) for name in names)


@pytest.mark.parametrize("case", SIZES)
def test_example_inputs_equal_jax(case):
    sizes = SIZES[case]
    jgrid, *jarrays, jq, jsub = jax_entry()._example_inputs(**sizes)
    tgrid, *tarrays, tq, tsub = G._example_inputs(device="cpu", **sizes)
    assert type(tgrid).__module__ == "channeld_tpu_torch.ops.spatial_ops"
    assert tuple(tgrid) == tuple(jgrid)
    assert type(tq).__module__ == "channeld_tpu_torch.ops.spatial_ops"
    for want, got in zip([*jarrays, *jq[:5], *jsub], [*tarrays, *tq[:5], *tsub]):
        assert_same(want, got)
    assert jq.spot_dist is None and tq.spot_dist is None


def test_entry_example_args_carried_across():
    """JAX's example arguments, as numpy arrays, are the port's own."""
    _, jargs = jax_entry().entry()
    _, targs = G.entry(device="cpu")
    carried = G.example_args_from_numpy([np.asarray(a) for a in jargs], device="cpu")
    assert len(carried) == len(targs) == len(jargs) == 12
    for want, got, own in zip(jargs[:-1], carried[:-1], targs[:-1]):
        assert_same(want, got)
        assert torch.equal(got, own)
    assert carried[-1] == targs[-1] == int(jargs[-1]) == 33


@pytest.mark.parametrize("case", SIZES)
def test_entry_fn_equals_jax(case):
    """The port's ``fn`` on the CPU against JAX's jitted ``fn``, on the
    port's example and on JAX's carried across: every output exactly."""
    sizes = SIZES[case]
    gx = jax_entry()
    if sizes:
        from channeld_tpu.ops.spatial_ops import QuerySet, spatial_step

        grid, pos, prev, valid, q, sub = gx._example_inputs(**sizes)

        def jfn(*a):  # JAX's fn at this example's grid
            return spatial_step(grid, *a[:3], QuerySet(*a[3:8]), tuple(a[8:11]), 64, a[11])

        jargs = (pos, prev, valid, *q[:5], *sub, np.int32(33))
    else:
        jfn, jargs = gx.entry()
    want = jax.jit(jfn)(*jargs)
    tfn, targs = G.entry(device="cpu", **sizes)
    carried = G.example_args_from_numpy([np.asarray(a) for a in jargs], device="cpu")
    for args in (targs, carried):
        got = tfn(*args)
        assert set(got) == set(want)
        for key in want:
            assert_same(want[key], got[key])
    assert int(got["cell_counts"].sum()) == targs[0].shape[0]  # every entity placed


def test_dryrun_multichip_on_cpu_equals_the_jax_engine():
    """The 8-shard dry run on the CPU passes its own checks (every sharding
    equal to the single device, the cells plane equal to the dense counts),
    prints JAX's OK line, and each tick's decisions equal a single-device
    JAX SpatialEngine driven through the same script."""
    from channeld_tpu.ops.engine import SpatialEngine

    r = G.dryrun_multichip(8, device="cpu")
    assert [label for label, _ in r["meshes"]] == ["entities", "entities-2d", "cells"]
    assert r["line"] == (
        "dryrun_multichip OK: serving engine on 8 devices, 96 entities, "
        f"{r['handovers']} handovers, decisions identical to single-device across "
        "['entities', 'entities', 'cells'] serving shardings; cell-sharded all_to_all + "
        "ring-halo plane matches dense")
    assert r["handovers"] > 0 and r["cells_plane"]["overflow"] == 0
    assert r["cells_plane"]["counts"].sum() == 128
    eng = SpatialEngine(G.DRY_RUN_GRID, entity_capacity=128, query_capacity=8, sub_capacity=16,
                        max_handovers=256)
    want = G.drive_engine(eng, 96)
    assert len(want) == len(r["single"]) == 3
    for t, w in enumerate(want):
        for label, ticks in [("single", r["single"]), *r["meshes"]]:
            assert G.first_difference(ticks[t], w) is None, (label, t)
    assert any(w["due"].any() for w in want) and want[0]["interest_3"]


def test_dryrun_multichip_odd_count_has_no_2d_mesh():
    r = G.dryrun_multichip(3, device="cpu")
    assert [label for label, _ in r["meshes"]] == ["entities", "cells"]


@pytest.mark.parametrize("call", ["example_inputs", "entry", "dryrun_multichip"])
def test_entry_points_want_a_card_unless_given_the_cpu(call):
    """Without a card each entry point raises unless given the CPU; with
    fewer than 8 cards the default dry run raises as JAX's asserts."""
    fn = dict(example_inputs=G._example_inputs, entry=G.entry,
              dryrun_multichip=lambda: G.dryrun_multichip(8))[call]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()
    elif call == "dryrun_multichip" and torch.cuda.device_count() < 8:
        with pytest.raises(ValueError, match="8 devices"):
            fn()
    else:
        fn()


def test_dryrun_multichip_wants_as_many_devices_as_shards():
    with pytest.raises(ValueError, match="need 8 devices, have 7"):
        G.dryrun_multichip(8, devices=["cpu"] * 7)
    with pytest.raises(ValueError):
        G.dryrun_multichip(0, device="cpu")
