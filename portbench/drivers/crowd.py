"""The device crowd: ``SpatialEngine`` with the sim pass and the standing-query
plane, driven tick by tick as ``scripts/sim_bench.py`` drives it (the
gateway's ``SimPlane`` and its channel commit are bypassed).

A tick: the flee mask switches when the mix says; the followers re-centre
(one ``set_query`` each, from the host's shadow of their agent); the engine
ticks (sim pass, spatial step, query diff); the host reads the decision
(``consume``), the changed query rows and the handovers; on a census tick it
fetches the four sim columns and absorbs them into the host's shadow. Its
latency runs from the start of that drive to the readbacks in hand.

Set-up builds the engine, builds the kernels on its empty tables, seeds the
agents, runs the sim pass's own warm-up, registers the queries and
subscriptions and runs ``warmup_ticks`` ticks, a census tick among them.
Every tick of the run, warm-up and window, is kept and held to
``reference.crowd_ref``, which replays them all from the seed.
"""

from __future__ import annotations

import time

import numpy as np

from ..gen import crowd_world as cw
from . import Base


class Driver(Base):
    DEVICE_SPANS = ("engine.spatial_step", "engine.sim_step")

    def setup(self) -> None:
        from channeld_tpu_torch.ops import spatial_ops as ops
        from channeld_tpu_torch.ops.engine import SpatialEngine

        from ..core.spans import Spans

        cfg, mix = self.config, self.mix
        self.spans = Spans()
        self.ops = ops
        eng = SpatialEngine(ops.GridSpec(**cfg["grid"]),
                            entity_capacity=cfg["entity_capacity"],
                            query_capacity=cfg["query_capacity"],
                            sub_capacity=cfg["sub_capacity"],
                            max_handovers=cfg["max_handovers"],
                            query_rows_max=cfg["query_rows_max"], device=self.device)
        eng.warmup()  # builds the kernels; the tables are still empty
        world = cw.build(self.seed, cfg["grid"], mix)
        self.world = world
        eng.seed_agents(list(zip(world.ids.tolist(), world.xs.tolist(),
                                 [0.0] * len(world.ids), world.zs.tolist())),
                        self.seed, ops.SimParams(**cfg["sim_params"]))
        eng.run_sim_pass = True
        eng.track_query_changes = True
        eng.sim_warmup()
        self.eng = eng
        self.slots = eng.agent_slots()  # fixed: no agent leaves or joins
        self.followed = self.slots[world.followed]
        self.radius = (float(mix["follower_radius"]), 0.0)
        self.follow()
        for s in world.sensors:
            if s.kind == cw.SPOTS:
                eng.set_spots_query(s.conn, [(s.x, s.z)], [1])
            else:
                eng.set_query(s.conn, s.kind, (s.x, s.z), (s.ex, s.ez), (1.0, 0.0),
                              float(mix["sensor_angle"]))
        for interval, first in zip(world.sub_interval.tolist(), world.sub_first.tolist()):
            eng.add_subscription(int(interval), int(first))
        self.t = 0
        self.kept: list[dict] = []
        self.census_ms: list[float] = []
        for _ in range(int(cfg["warmup_ticks"])):
            self.step()
        self.sync()

    def follow(self) -> None:
        """Re-centre each follower sphere on its agent's host-shadow
        position, which the census refreshes: no device read."""
        pos = self.eng._positions
        for i, slot in enumerate(self.followed):
            self.eng.set_query(1 + i, self.ops.AOI_SPHERE,
                               (float(pos[slot, 0]), float(pos[slot, 2])), self.radius)

    def step(self) -> float:
        eng, t, spans = self.eng, self.t, self.spans
        t0 = time.perf_counter()
        which = cw.flee_set(self.mix, t)
        if which is not None:
            eng.set_flee_cells(self.world.flee[which])
        with spans.span("crowd.follow"):
            self.follow()
        eng.sim_census_due = cw.census_due(self.config, t)
        out = eng.tick(now_ms=cw.now_ms(t))
        count, _, counts, due = eng.consume(out)
        q_count, q_rows = eng.query_changed_rows(out)
        handovers = eng.handover_list(out)
        census = None
        if "sim_census" in out:
            with spans.span("crowd.census"):
                c0 = time.perf_counter()
                census = tuple(c.cpu().numpy() for c in out["sim_census"])
                eng.absorb_census(self.slots, *census)
                self.census_ms.append((time.perf_counter() - c0) * 1e3)
        eng.sim_census_due = False
        lat = time.perf_counter() - t0
        kept = dict(handover_count=count, handovers=np.array(handovers, np.int32).reshape(-1, 3),
                    counts=counts.copy(), due=np.nonzero(due)[0].astype(np.int32),
                    q_count=q_count, q_rows=q_rows[: min(q_count, len(q_rows))].copy())
        if census is not None:
            kept["census"] = tuple(np.array(col[self.slots]) for col in census)
        self.kept.append(kept)
        self.t += 1
        return lat

    def live(self) -> int:
        return len(self.world.ids)

    def instrument(self, spans) -> None:
        from channeld_tpu_torch.ops import engine as engine_mod

        self.spans = spans
        eng = self.eng
        for attr, name in (("tick", "engine.tick"), ("_flush_host_state", "engine.flush"),
                           ("consume", "engine.consume"),
                           ("query_changed_rows", "engine.query_changed_rows"),
                           ("handover_list", "engine.handover_list")):
            spans.wrap(eng, attr, name)
        spans.wrap(engine_mod, "spatial_step", "engine.spatial_step", device=True)
        spans.wrap(engine_mod, "sim_step", "engine.sim_step", device=True)

    def close(self) -> None:
        self.eng = None
        self.free_device()

    def check(self) -> tuple[dict, list[str]]:
        """Every tick of the run against the reference's replay from the seed."""
        from ..reference.crowd_ref import CrowdRef, census_bits_wrong, compare_tick

        t0 = time.perf_counter()
        ref = CrowdRef(self.seed, self.config, self.mix)
        wrong = bits = 0
        first = None
        censuses = 0
        for t, got in enumerate(self.kept):
            want = ref.tick(t)
            diffs = compare_tick(got, want)
            if "census" in got and "census" in want:
                censuses += 1
                b = census_bits_wrong(got["census"], want["census"])
                bits += b
                if b:
                    diffs.append(f"{b} census elements differ")
            if diffs:
                wrong += 1
                first = first or f"tick {t}: {diffs[:4]}"
        lines = [f"reference: {len(self.kept)} ticks of {self.t} compared ({censuses} "
                 f"censuses) in {time.perf_counter() - t0:.1f} s; cone pairs inside the "
                 f"threshold's band: {ref.cone_band_pairs}"]
        if self.census_ms:
            lines.append(f"census fetch+absorb: mean {np.mean(self.census_ms):.3f} ms "
                         f"over {len(self.census_ms)}")
        if first:
            lines.append(f"first difference: {first}")
        return {"ticks_wrong": (wrong, 0), "census_elements_wrong": (bits, 0)}, lines
