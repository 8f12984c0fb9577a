"""The host-grid side of ``chip_smoke.py``: its child gateways, which load
no torch, and what they share with the parent.

Every gateway of the fleet and edge phases (15b, 16b, 17, 18) runs the
scripts' Static2DSpatialController, the host grid, which touches no device
by the scripts' own design. ``chip_smoke.py`` imports this module before
numpy and torch and hands these roles to ``run_role`` before it imports
either, so a child loads only the port's host layers (``host_modules``), as
the scripts' children load only the JAX package's:

    python3 chip_smoke.py --fed-child CONFIG REPORT                  # 15b's "b"
    python3 chip_smoke.py --crash-child CONFIG REPORT STATE_DIR SEED # 16b's "b"
    python3 chip_smoke.py --live-child ROLE GW CONFIG REPORT PARAMS  # phase 17's
    python3 chip_smoke.py --edge-child REPORT                        # phase 18's

Each prints ``READY`` with a JSON of its boot's parts and of the modules of
JAX, of the JAX package or of torch it loaded (none). Imports nothing of
JAX, of ``channeld_tpu``, of numpy or of torch at module level.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import time
from types import SimpleNamespace as NS
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
# Seconds this script's own imports took before a child's role started (set
# by ``run_role``; a child's READY reports it).
IMPORTS_S = 0.0


# ---- the gateway's modules -----------------------------------------------------

# The gateway's modules by role: the host layers every gateway loads, and the
# device planes a GPU-controlled gateway adds (each of these loads torch in
# the port, as its counterpart loads JAX in the reference).
HOST_MODULES = dict(
    channel="core.channel", connection="core.connection", data="core.data", ddos="core.ddos",
    recovery="core.connection_recovery", message="core.message", settings="core.settings",
    types="core.types", sub="core.subscription", overload="core.overload",
    guard="core.device_guard", wal="core.wal", slo="core.slo", tracing="core.tracing",
    events="core.events", edge="core.edge", control_pb2="protocol.control_pb2",
    sim_pb2="models.sim_pb2", sim_models="models.sim", controller="spatial.controller",
    balancer="spatial.balancer", partition="spatial.partition", metrics="core.metrics",
    logger="utils.logger", snapshot="core.snapshot", chaos="chaos",
    invariants="chaos.invariants", opshttp="core.opshttp", failover="core.failover",
    spatial_pb2="protocol.spatial_pb2", spatial_messages="spatial.messages",
    server="core.server", protocol="protocol", wire_pb2="protocol.wire_pb2",
    anyutil="utils.anyutil", federation="federation", fleet_obs="federation.obs")
DEVICE_MODULES = dict(sim_plane="sim.plane", ops="ops.spatial_ops",
                      queryplane="spatial.queryplane")


def host_modules(pkg: str = "channeld_tpu_torch") -> NS:
    """The host layers of one package's gateway (``HOST_MODULES``): what a
    gateway on the host grid imports, as the scripts' child gateways do."""
    import importlib

    return NS(port=pkg == "channeld_tpu_torch",
              **{k: importlib.import_module(f"{pkg}.{v}") for k, v in HOST_MODULES.items()})


def gateway_modules(pkg: str = "channeld_tpu_torch") -> NS:
    """The gateway's modules of one package, its device planes too: the
    port's, or (in the tests, which drive phases 12 and 13 through both) a
    package with the same module names."""
    import importlib

    P = host_modules(pkg)
    for k, v in DEVICE_MODULES.items():
        setattr(P, k, importlib.import_module(f"{pkg}.{v}"))
    return P


def reset_gateway(P, keep_census: bool = False) -> None:
    """Every process-wide registry of the port's gateway back to boot
    (but a census that a WAL replay staged, with ``keep_census``). A host
    gateway (``host_modules``) never loaded the sim plane: nothing of it
    to reset."""
    P.channel.reset_channels()
    P.connection.reset_connections()
    P.data.reset_registries()
    P.ddos.reset_ddos()
    P.recovery.reset_recovery()
    P.controller.reset_spatial_controller()
    P.overload.reset_overload()
    P.guard.reset_device_guard()
    P.balancer.reset_balancer()
    P.partition.reset_partition()
    P.wal.reset_wal()
    P.slo.reset_slo()
    P.tracing.reset_tracing()
    if not keep_census and hasattr(P, "sim_plane"):
        P.sim_plane.reset_sim()
    P.events.reset_all()
    P.settings.reset_global_settings()


SERVER_FSM, CLIENT_FSM = "config/server_authoritative_fsm.json", "config/client_authoritative_fsm.json"

# ---- scripts/chaos_soak.py's client helpers ------------------------------------

def soak_frame(P, msg_type: int, body: bytes, channel_id: int = 0) -> bytes:
    return P.protocol.encode_packet(P.wire_pb2.Packet(messages=[P.wire_pb2.MessagePack(
        channelId=channel_id, msgType=msg_type, msgBody=body)]))


async def soak_read_frames(P, reader, on_pack, stop) -> None:
    """Drain a socket into per-MessagePack callbacks until EOF or ``stop``."""
    dec = P.protocol.FrameDecoder()
    while not stop.is_set():
        try:
            data = await reader.read(65536)
        except (ConnectionError, OSError):
            return
        if not data:
            return
        for packet in dec.decode_packets(data):
            for mp in packet.messages:
                on_pack(mp)


async def soak_auth(P, reader, writer, pit: str, timeout: float = 5.0) -> None:
    """AUTH and wait for the first frame back."""
    import asyncio

    writer.write(soak_frame(P, P.types.MessageType.AUTH, P.control_pb2.AuthMessage(
        playerIdentifierToken=pit, loginToken="soak").SerializeToString()))
    await writer.drain()
    dec = P.protocol.FrameDecoder()
    deadline = time.monotonic() + timeout
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TimeoutError(f"auth timeout for {pit}")
        data = await asyncio.wait_for(reader.read(65536), timeout=remaining)
        if not data:
            raise ConnectionError(f"closed during auth of {pit}")
        if any(p.messages for p in dec.decode_packets(data)):
            return

# ---- phase 15: the federation soak's world and boot (15b) -----------------------

# scripts/federation_soak.py's world: 4x4 cells of 50 m, two server blocks
# (index 0 = columns 0-1, x < 0, gateway a; index 1 = columns 2-3, gateway b).
WORLD_SPATIAL = {
    "SpatialControllerType": "Static2DSpatialController",
    "Config": {"WorldOffsetX": -100, "WorldOffsetZ": -100, "GridWidth": 50, "GridHeight": 50,
               "GridCols": 4, "GridRows": 4, "ServerCols": 2, "ServerRows": 1,
               "ServerInterestBorderSize": 0},
}

# scripts/global_soak.py's world: 6x4 cells of 50 m, three 2x4 shard blocks
# (a = columns 0-1, x in [-150, -50); b = columns 2-3; c = columns 4-5).
WORLD_3 = {
    "SpatialControllerType": "Static2DSpatialController",
    "Config": {"WorldOffsetX": -150, "WorldOffsetZ": -100, "GridWidth": 50, "GridHeight": 50,
               "GridCols": 6, "GridRows": 4, "ServerCols": 3, "ServerRows": 1,
               "ServerInterestBorderSize": 0},
}
# scripts/global_soak.py's per-gateway x ranges (strictly inside each shard), z
# range and entity-id bases.
GLOBAL_XR = {"a": (-148.0, -52.0), "b": (-48.0, 48.0), "c": (52.0, 148.0)}
GLOBAL_ZR = (-98.0, 98.0)
GLOBAL_BASE = {"a": 0, "b": 1000, "c": 2000}


@dataclasses.dataclass
class FedSoakParams:
    """scripts/federation_soak.py's FedSoakParams."""
    entities: int = 48
    burst: int = 12
    refusal_burst: int = 6
    sever_burst: int = 12
    herd_back: int = 8
    phase_timeout_s: float = 20.0
    quiesce_s: float = 3.0
    child_boot_timeout_s: float = 60.0
    retry_after_ms: int = 300
    heartbeat_ms: int = 200
    trunk_timeout_ms: int = 1200
    handover_timeout_ms: int = 1500
    global_tick_ms: int = 20
    seed: int = 20260803
    out_path: str = ""


@dataclasses.dataclass
class GlobalSoakParams:
    """scripts/global_soak.py's GlobalSoakParams."""
    seed: int = 20260803
    base_entities: int = 10
    hotspot: int = 36
    kill_burst: int = 10
    committed_to_c: int = 4
    epoch_ms: int = 250
    heartbeat_ms: int = 150
    trunk_timeout_ms: int = 900
    handover_timeout_ms: int = 1500
    death_miss_epochs: int = 4
    imbalance_enter: float = 1.25
    phase_timeout_s: float = 25.0
    quiesce_s: float = 2.0
    child_boot_timeout_s: float = 60.0
    global_tick_ms: int = 20
    out_path: str = ""


def fed_config(ports: dict) -> dict:
    """scripts/federation_soak.py's ``_fed_config``: the two-gateway directory."""
    return {"secret": "fed-soak-secret", "gateways": {
        "a": {"trunk": f"127.0.0.1:{ports['a_trunk']}",
              "client": f"127.0.0.1:{ports['a_client']}", "servers": [0]},
        "b": {"trunk": f"127.0.0.1:{ports['b_trunk']}",
              "client": f"127.0.0.1:{ports['b_client']}", "servers": [1]}}}


def fed_config3(ports: dict) -> dict:
    """scripts/global_soak.py's ``_fed_config3``: the three-gateway directory."""
    return {"secret": "global-soak-secret", "gateways": {
        gw: {"trunk": f"127.0.0.1:{ports[gw + '_trunk']}",
             "client": f"127.0.0.1:{ports[gw + '_client']}", "servers": [i]}
        for i, gw in enumerate(("a", "b", "c"))}}


def global_settings_hook(p: GlobalSoakParams):
    """scripts/global_soak.py's ``_settings_hook``: the control plane armed."""
    def hook(gs) -> None:
        gs.global_control_enabled = True
        gs.global_epoch_ms = p.epoch_ms
        gs.global_imbalance_enter = p.imbalance_enter
        gs.global_imbalance_exit = p.imbalance_enter * 0.85
        gs.global_hold_epochs = 2
        gs.global_min_entity_delta = 8
        gs.global_death_miss_epochs = p.death_miss_epochs
        gs.global_budget_per_window = 8
        gs.global_budget_window_epochs = 120
        gs.global_cooldown_epochs = 8
        gs.global_migrate_timeout_ms = 8000
        gs.global_adopt_claims_timeout_ms = 800
        gs.failover_enabled = True
        gs.partition_enabled = False

    return hook


def fed_pins(P, p: FedSoakParams) -> None:
    """scripts/federation_soak.py's ``boot_gateway`` settings (balancer,
    partitioning, guard, SLO plane, control plane, recorder and WAL pinned
    off; the ladder on with unreachable thresholds; its trunk and channel
    timings)."""
    gs = P.settings.global_settings
    gs.development = True
    gs.balancer_enabled = False
    gs.partition_enabled = False
    gs.device_guard_enabled = False
    gs.slo_enabled = False
    gs.global_control_enabled = False
    gs.trace_enabled = False
    gs.wal_path = ""
    P.tracing.recorder.configure(enabled=False)
    gs.overload_enabled = True
    gs.overload_enter_thresholds = (99.0, 99.0, 99.0)
    gs.overload_down_hold_s = 9999.0
    gs.overload_retry_after_ms = p.retry_after_ms
    gs.federation_heartbeat_ms = p.heartbeat_ms
    gs.federation_trunk_timeout_ms = p.trunk_timeout_ms
    gs.federation_handover_timeout_ms = p.handover_timeout_ms
    gs.federation_reconnect_base_ms = 50
    gs.federation_reconnect_max_ms = 500
    CT = P.types.ChannelType
    gs.channel_settings = {
        CT.GLOBAL: P.settings.ChannelSettings(tick_interval_ms=p.global_tick_ms,
                                              default_fanout_interval_ms=50),
        CT.SPATIAL: P.settings.ChannelSettings(tick_interval_ms=50,
                                               default_fanout_interval_ms=100),
        CT.ENTITY: P.settings.ChannelSettings(tick_interval_ms=50,
                                              default_fanout_interval_ms=100)}


async def fed_boot_gateway(P, gw_id: str, fed_cfg: dict, params: FedSoakParams, stop,
                           scratch: str, expect_cells: int = 8, settings_hook=None,
                           pre_start_hook=None, world: Optional[dict] = None) -> dict:
    """scripts/federation_soak.py's ``boot_gateway`` through one package's
    modules: every singleton reset, the soak's pins (then
    ``settings_hook(global_settings)``), listeners on loopback, the master
    possessing GLOBAL and one spatial server claiming the local block of
    ``world`` (default WORLD_SPATIAL) over TCP, ``pre_start_hook()``, the
    federation plane armed and started (its trunks)."""
    import asyncio
    import os

    reset_gateway(P)
    P.failover.reset_failover()
    P.federation.reset_federation()
    fed_pins(P, params)
    if settings_hook is not None:
        settings_hook(P.settings.global_settings)
    P.sim_models.register_sim_types()
    P.connection.init_connections(SERVER_FSM, CLIENT_FSM)
    P.channel.init_channels()
    P.ddos.init_anti_ddos()
    spatial_path = os.path.join(scratch, f"fed_soak_spatial_{gw_id}_{os.getpid()}.json")
    with open(spatial_path, "w") as f:
        json.dump(world if world is not None else WORLD_SPATIAL, f)
    P.controller.init_spatial_controller(spatial_path)
    ctl = P.controller.get_spatial_controller()
    P.federation.init_federation(fed_cfg, gw_id, ctl)
    MT, CT = P.types.MessageType, P.types.ChannelType
    host = "127.0.0.1"
    client_port = int(fed_cfg["gateways"][gw_id]["client"].rpartition(":")[2])
    server_srv = await P.server.start_listening(P.types.ConnectionType.SERVER, "tcp", f"{host}:0")
    server_port = server_srv.sockets[0].getsockname()[1]
    client_srv = await P.server.start_listening(P.types.ConnectionType.CLIENT, "tcp",
                                                f"{host}:{client_port}")
    tasks = [asyncio.ensure_future(P.server.flush_loop()),
             asyncio.ensure_future(P.ddos.unauth_reaper_loop()),
             asyncio.ensure_future(P.recovery.connection_recovery_loop())]
    writers = []
    for pit, create in ((f"fed-master-{gw_id}", P.control_pb2.CreateChannelMessage(
            channelType=CT.GLOBAL)), (f"fed-spatial-{gw_id}", P.control_pb2.CreateChannelMessage(
            channelType=CT.SPATIAL, subOptions=P.control_pb2.ChannelSubscriptionOptions(
                dataAccess=P.types.ChannelDataAccess.WRITE_ACCESS)))):
        reader, writer = await asyncio.open_connection(host, server_port)
        await soak_auth(P, reader, writer, pit, timeout=8.0)
        writer.write(soak_frame(P, MT.CREATE_CHANNEL, create.SerializeToString()))
        await writer.drain()
        tasks.append(asyncio.ensure_future(soak_read_frames(P, reader, lambda mp: None, stop)))
        writers.append(writer)
    gs = P.settings.global_settings
    start_id, end_id = gs.spatial_channel_id_start, gs.entity_channel_id_start
    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline:
        cells = [ch for cid, ch in P.channel.all_channels().items() if start_id <= cid < end_id]
        if len(cells) == expect_cells and all(ch.has_owner() for ch in cells):
            break
        await asyncio.sleep(0.05)
    else:
        raise RuntimeError(f"gateway {gw_id}: local shard failed to come up")
    if pre_start_hook is not None:
        pre_start_hook()
    plane = P.federation.plane
    await plane.start()
    return dict(ctl=ctl, plane=plane, tasks=tasks, writers=writers,
                servers=[server_srv, client_srv], spatial_path=spatial_path,
                client_port=client_port)


def fed_teardown_gateway(P, gw: dict) -> None:
    """scripts/federation_soak.py's ``teardown_gateway``."""
    import os

    P.federation.reset_federation()
    P.wal.reset_wal()
    for t in gw.get("tasks", []):
        t.cancel()
    for w in gw.get("writers", []):
        w.close()
    for s in gw.get("servers", []):
        s.close()
    reset_gateway(P)
    P.failover.reset_failover()
    with contextlib.suppress(OSError):
        os.remove(gw.get("spatial_path", ""))


class FedSim:
    """scripts/federation_soak.py's FedSim: entities created in the local
    shard and moved through the entity channels' merge and notify path;
    those handed to the peer vanish locally and leave the drive set."""

    def __init__(self, P, ctl, rng):
        self.P, self.ctl, self.rng = P, ctl, rng
        self.entity_ids: list = []

    def local_ids(self) -> list:
        return [e for e in self.entity_ids if self.P.channel.get_channel(e) is not None]

    def adopt_scan(self) -> None:
        known = set(self.entity_ids)
        estart = self.P.settings.global_settings.entity_channel_id_start
        for cid in self.P.channel.all_channels():
            if cid > estart and cid not in known:
                self.entity_ids.append(cid)

    def create_entities(self, n: int, x0: float, x1: float, z0: float, z1: float,
                        base: int = 0) -> None:
        P = self.P
        estart = P.settings.global_settings.entity_channel_id_start
        for i in range(n):
            eid = estart + 1 + base + i
            x, z = self.rng.uniform(x0, x1), self.rng.uniform(z0, z1)
            cell_ch = P.channel.get_channel(self.ctl.get_channel_id(P.controller.SpatialInfo(x, 0, z)))
            owner = cell_ch.get_owner()
            ch = P.channel.create_entity_channel(eid, owner)
            d = P.sim_pb2.SimEntityChannelData()
            d.state.entityId = eid
            d.state.transform.position.x = x
            d.state.transform.position.z = z
            ch.init_data(d, None)
            ch.spatial_notifier = self.ctl
            if owner is not None:
                P.sub.subscribe_to_channel(owner, ch, None)
            cell_ch.execute(lambda c, e=eid, dd=d: c.get_data_message().add_entity(e, dd))
            self.entity_ids.append(eid)

    def move(self, eid: int, x: float, z: float) -> bool:
        P = self.P
        ch = P.channel.get_channel(eid)
        if ch is None or ch.is_removing():
            return False
        upd = P.sim_pb2.SimEntityChannelData()
        upd.state.entityId = eid
        upd.state.transform.position.x = x
        upd.state.transform.position.z = z

        def apply(c, u=upd):
            owner = c.get_owner()
            c.data.on_update(u, c.get_time(), owner.id if owner is not None else 0, self.ctl)

        ch.execute(apply)
        return True

    def herd(self, ids: list, x0: float, x1: float, z0: float, z1: float) -> list:
        return [eid for eid in ids
                if self.move(eid, self.rng.uniform(x0, x1), self.rng.uniform(z0, z1))]

    def jitter(self, x0: float, x1: float, z0: float, z1: float) -> None:
        ids = self.local_ids()
        for eid in self.rng.sample(ids, max(1, len(ids) // 6)):
            self.move(eid, self.rng.uniform(x0, x1), self.rng.uniform(z0, z1))


def fed_local_placement(P) -> dict:
    """scripts/federation_soak.py's ``local_placement``: entity id -> cell
    over every local cell (duplicates within the gateway under
    ``__local_dups__``)."""
    gs = P.settings.global_settings
    placement: dict = {}
    counts: dict = {}
    for cid, ch in P.channel.all_channels().items():
        if not gs.spatial_channel_id_start <= cid < gs.entity_channel_id_start:
            continue
        ents = getattr(ch.get_data_message(), "entities", None)
        if ents is None:
            continue
        for eid in ents:
            placement[str(eid)] = cid
            counts[eid] = counts.get(eid, 0) + 1
    dups = sorted(e for e, n in counts.items() if n > 1)
    if dups:
        placement["__local_dups__"] = dups
    return placement


def fed_metric_delta(P, baseline: dict) -> dict:
    """federation_handover_total{result} deltas (the ledger's far side)."""
    inv = P.invariants
    return {dict(labels)["result"]: int(v) for (name, labels), v in
            inv.delta(inv.scrape(), baseline).items()
            if name == "federation_handover_total" and v}


def fed_trunk_metrics(P, baseline: dict) -> dict:
    inv = P.invariants
    d = inv.delta(inv.scrape(), baseline)
    return {"trunk_msgs_out": int(inv.sample_total(d, "trunk_msgs_total", direction="out")),
            "trunk_msgs_in": int(inv.sample_total(d, "trunk_msgs_total", direction="in")),
            "redirects_total": int(inv.sample_total(d, "redirects_total")),
            "trunk_rtt_ms_p50": inv.histogram_quantile(d, "trunk_rtt_ms", 0.50),
            "trunk_rtt_ms_p99": inv.histogram_quantile(d, "trunk_rtt_ms", 0.99)}


def fed_free_ports(n: int) -> list:
    """scripts/federation_soak.py's ``_free_ports``: n distinct free ports."""
    import socket

    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def foreign_modules() -> list:
    """Modules of JAX or of the JAX package loaded in this process, and
    ``torch`` when it is: a host-grid child gateway loads none of them."""
    return sorted(m for m in sys.modules
                  if m in ("jax", "channeld_tpu", "torch")
                  or m.startswith(("jax.", "channeld_tpu.")))


def ready(modules_s: float, gateway_s: Optional[float]) -> dict:
    """Print a child's ``READY`` line with a JSON of its boot's parts (this
    script's imports before the role started, the port's host modules, the
    gateway's boot, None where the role boots it later) and the foreign
    modules it loaded; returns the JSON."""
    boot = dict(modules=foreign_modules(), imports_s=round(IMPORTS_S, 3),
                modules_s=round(modules_s, 3),
                gateway_s=None if gateway_s is None else round(gateway_s, 3))
    print("READY " + json.dumps(boot), flush=True)
    return boot


async def fed_child_main(config: str, report_path: str) -> None:
    """scripts/federation_soak.py's ``remote_main`` (gateway "b") through the
    port, driven over stdin: force_l3, clear_l3, herd_back, quiesce,
    report, exit. Its report also lists the modules of JAX, of the JAX
    package or of torch it loaded (none), and its boot's parts."""
    import asyncio

    from random import Random

    import os

    t0 = time.perf_counter()
    P = host_modules()
    t1 = time.perf_counter()
    with open(config) as f:
        fed_cfg = json.load(f)
    p = FedSoakParams()
    stop = asyncio.Event()
    scratch = os.path.dirname(os.path.abspath(report_path))
    gw = await fed_boot_gateway(P, "b", fed_cfg, p, stop, scratch)
    plane, ctl = gw["plane"], gw["ctl"]
    journal, governor = P.failover.journal, P.overload.governor
    sim = FedSim(P, ctl, Random(p.seed ^ 0xB))
    baseline = P.invariants.scrape()
    boot = ready(t1 - t0, time.perf_counter() - t1)

    async def jitter_loop():
        while not stop.is_set():
            sim.adopt_scan()
            if sim.local_ids():
                sim.jitter(2.0, 98.0, -98.0, 98.0)  # stay inside shard b
            await asyncio.sleep(0.15)

    jitter_task = asyncio.ensure_future(jitter_loop())
    loop = asyncio.get_running_loop()
    reader = asyncio.StreamReader()
    await loop.connect_read_pipe(lambda: asyncio.StreamReaderProtocol(reader), sys.stdin)
    while True:
        line = await reader.readline()
        if not line:
            break
        try:
            cmd = json.loads(line)
        except ValueError:
            continue
        name = cmd.get("cmd")
        if name == "force_l3":
            governor._move(3)
            print("OK force_l3", flush=True)
        elif name == "clear_l3":
            governor._move(0, forced=True)
            print("OK clear_l3", flush=True)
        elif name == "herd_back":
            sim.adopt_scan()
            moved = sim.herd(sim.local_ids()[: int(cmd.get("n", 8))], -98.0, -2.0, -98.0, 98.0)
            print(f"OK herd_back {len(moved)}", flush=True)
        elif name == "quiesce":
            until = time.monotonic() + float(cmd.get("drain_s", 10.0))
            jitter_task.cancel()
            while time.monotonic() < until and (plane._pending or plane._parked
                                                or journal.in_flight_count()):
                await asyncio.sleep(0.1)
            print("OK quiesce", flush=True)
        elif name == "report":
            report = dict(gateway="b", ledger=dict(plane.ledger), busy_frames=plane.busy_frames,
                          metric_delta=fed_metric_delta(P, baseline),
                          trunk=fed_trunk_metrics(P, baseline), placement=fed_local_placement(P),
                          pending=len(plane._pending), parked=len(plane._parked),
                          journal=journal.report(), events=plane.events[-200:],
                          overload_transitions=governor.transitions,
                          modules=foreign_modules(), spatial=type(ctl).__name__, boot=boot)
            with open(report_path, "w") as f:
                json.dump(report, f)
            print("OK report", flush=True)
        elif name == "exit":
            break
    stop.set()
    jitter_task.cancel()
    fed_teardown_gateway(P, gw)


def fed_child(config: str, report_path: str) -> int:
    """``chip_smoke.py --fed-child CONFIG REPORT``: 15b's gateway "b"."""
    import asyncio

    asyncio.run(fed_child_main(config, report_path))
    return 0

# ---- phase 16: the crash soak's live run (16b) ----------------------------------

# scripts/crash_soak.py's per-gateway x ranges (strictly inside each half of
# WORLD_SPATIAL), z range and entity-id bases.
CRASH_XR = {"a": (-98.0, -2.0), "b": (2.0, 98.0)}
CRASH_ZR = (-98.0, 98.0)
CRASH_BASE = {"a": 0, "b": 1000}


@dataclasses.dataclass
class CrashSoakParams:
    """scripts/crash_soak.py's CrashSoakParams."""
    seed: int = 20260804
    base_entities: int = 12
    committed_each_way: int = 4
    kill_burst: int = 8
    phases: tuple = ("reclaim", "adopt")
    epoch_ms: int = 250
    epoch_ms_b: int = 10_000
    death_miss_epochs: int = 4
    heartbeat_ms: int = 150
    trunk_timeout_ms: int = 900
    handover_timeout_ms: int = 1500
    global_tick_ms: int = 20
    fsync_ms: float = 10.0
    snapshot_interval_s: float = 2.0
    restart_deadline_s: float = 90.0
    phase_timeout_s: float = 30.0
    quiesce_s: float = 2.0
    child_boot_timeout_s: float = 90.0
    out_path: str = ""
    state_dir: str = ""


def persistence_paths(state_dir: str, gw_id: str) -> tuple:
    """scripts/crash_soak.py's ``persistence_paths``: (snapshot, WAL)."""
    import os

    return (os.path.join(state_dir, f"gw_{gw_id}.snap"),
            os.path.join(state_dir, f"gw_{gw_id}.wal"))


def wal_settings_hook(gw_id: str, state_dir: str, p: CrashSoakParams):
    """scripts/crash_soak.py's ``wal_settings_hook``: the control plane armed
    (gateway a's epoch 250 ms, b's 10 s), failover on, partitioning off, the
    snapshot and the WAL armed."""
    snap_path, wal_path = persistence_paths(state_dir, gw_id)

    def hook(gs) -> None:
        gs.global_control_enabled = True
        gs.global_epoch_ms = p.epoch_ms if gw_id == "a" else p.epoch_ms_b
        gs.global_death_miss_epochs = p.death_miss_epochs
        gs.global_min_entity_delta = 10_000
        gs.failover_enabled = True
        gs.partition_enabled = False
        gs.snapshot_path = snap_path
        gs.snapshot_interval_s = p.snapshot_interval_s
        gs.wal_path = wal_path
        gs.wal_fsync_ms = p.fsync_ms

    return hook


def wal_pre_start_hook(P, gw_id: str, state_dir: str, sink: dict):
    """scripts/crash_soak.py's ``wal_pre_start_hook``: replay the snapshot
    and the WAL (a no-op on a virgin state dir) and start the journal
    writer, before the plane starts."""
    def hook() -> None:
        snap_path, wal_path = persistence_paths(state_dir, gw_id)
        t0 = time.monotonic()
        sink["replay"] = P.wal.boot_replay(snap_path, wal_path)
        sink["replay"]["wall_s"] = round(time.monotonic() - t0, 3)
        P.wal.wal.start(wal_path, initial_seq=sink["replay"].get("max_seq", 0))

    return hook


def wal_metric_delta(P, baseline: dict) -> dict:
    """scripts/crash_soak.py's ``wal_metric_delta``: wal_records_total{kind},
    wal_replayed_total{kind} and resurrection_total{outcome} since
    ``baseline``."""
    inv = P.invariants
    out: dict = {"records": {}, "replayed": {}, "resurrection": {}}
    for (name, labels), value in inv.delta(inv.scrape(), baseline).items():
        if not value:
            continue
        if name == "wal_records_total":
            out["records"][dict(labels)["kind"]] = int(value)
        elif name == "wal_replayed_total":
            out["replayed"][dict(labels)["kind"]] = int(value)
        elif name == "resurrection_total":
            out["resurrection"][dict(labels)["outcome"]] = int(value)
    return out


def persistence_report(P, baseline: dict, replay: dict) -> dict:
    """scripts/crash_soak.py's ``persistence_report``."""
    return {"wal": P.wal.wal.report(), "replay": replay,
            "metric": wal_metric_delta(P, baseline),
            "resurrections": dict(P.federation.control.resurrections)}


async def crash_child_main(config: str, report_path: str, state_dir: str, seed: int) -> None:
    """scripts/crash_soak.py's ``remote_main`` (gateway "b", the crash victim)
    through the port, driven over stdin: spawn, herd_to, flush_wal,
    arm_torn, quiesce, report, exit. READY carries its boot's parts; its
    report also lists the modules of JAX, of the JAX package or of torch
    it loaded (none) and its controller."""
    import asyncio
    import os

    from random import Random

    t0 = time.perf_counter()
    P = host_modules()
    t1 = time.perf_counter()
    baseline = P.invariants.scrape()  # before any WAL/replay counter moves
    with open(config) as f:
        fed_cfg = json.load(f)
    p = CrashSoakParams()
    fp = FedSoakParams(heartbeat_ms=p.heartbeat_ms, trunk_timeout_ms=p.trunk_timeout_ms,
                       handover_timeout_ms=p.handover_timeout_ms, global_tick_ms=p.global_tick_ms)
    stop = asyncio.Event()
    sink: dict = {"replay": {}}
    scratch = os.path.dirname(os.path.abspath(report_path))
    gw = await fed_boot_gateway(P, "b", fed_cfg, fp, stop, scratch,
                                settings_hook=wal_settings_hook("b", state_dir, p),
                                pre_start_hook=wal_pre_start_hook(P, "b", state_dir, sink))
    plane, ctl = gw["plane"], gw["ctl"]
    journal, wal = P.failover.journal, P.wal.wal
    snap_path, _ = persistence_paths(state_dir, "b")
    snap_task = asyncio.ensure_future(P.snapshot.snapshot_loop(snap_path, p.snapshot_interval_s))
    sim = FedSim(P, ctl, Random(seed ^ 0xB))
    boot = ready(t1 - t0, time.perf_counter() - t1)
    loop = asyncio.get_running_loop()
    reader = asyncio.StreamReader()
    await loop.connect_read_pipe(lambda: asyncio.StreamReaderProtocol(reader), sys.stdin)
    while True:
        line = await reader.readline()
        if not line:
            break
        try:
            cmd = json.loads(line)
        except ValueError:
            continue
        name = cmd.get("cmd")
        if name == "spawn":
            sim.create_entities(int(cmd["n"]), *CRASH_XR["b"], *CRASH_ZR,
                                base=CRASH_BASE["b"] + int(cmd.get("offset", 0)))
            print(f"OK spawn {cmd['n']}", flush=True)
        elif name == "herd_to":
            sim.adopt_scan()
            moved = sim.herd(sim.local_ids()[: int(cmd.get("n", 4))], *CRASH_XR[cmd["gw"]],
                             *CRASH_ZR)
            print(f"OK herd_to {len(moved)}", flush=True)
        elif name == "flush_wal":
            ok = await asyncio.to_thread(wal.flush, 10.0)
            print(f"OK flush_wal {ok}", flush=True)
        elif name == "arm_torn":
            P.chaos.arm({"seed": seed, "faults": [
                {"point": "wal.torn_write", "every_n": 1, "max_fires": 1}]})
            wal.log_flip([], 0)  # the record that tears
            await asyncio.to_thread(wal.flush, 5.0)
            print("OK arm_torn", flush=True)
        elif name == "quiesce":
            deadline = time.monotonic() + float(cmd.get("drain_s", 10.0))
            while time.monotonic() < deadline and (plane._pending or plane._parked
                                                   or journal.in_flight_count()):
                await asyncio.sleep(0.1)
            print("OK quiesce", flush=True)
        elif name == "report":
            report = dict(gateway="b", ledger=dict(plane.ledger),
                          persistence=persistence_report(P, baseline, sink["replay"]),
                          placement=fed_local_placement(P), pending=len(plane._pending),
                          parked=len(plane._parked), journal=journal.report(),
                          events=plane.events[-300:], modules=foreign_modules(),
                          spatial=type(ctl).__name__, boot=boot)
            with open(report_path, "w") as f:
                json.dump(report, f)
            print("OK report", flush=True)
        elif name == "exit":
            break
    stop.set()
    snap_task.cancel()
    fed_teardown_gateway(P, gw)


def crash_child(config: str, report_path: str, state_dir: str, seed: int) -> int:
    """``chip_smoke.py --crash-child CONFIG REPORT STATE_DIR SEED``: 16b's
    gateway "b"."""
    import asyncio

    asyncio.run(crash_child_main(config, report_path, state_dir, seed))
    return 0

# ---- phase 17: the last live fleet paths ---------------------------------------

# The trunk timings both soaks' phase 2 boot their gateways with.
PHASE2_TRUNK = dict(heartbeat_ms=200, trunk_timeout_ms=1200, handover_timeout_ms=1500)


def obs_fed_settings_hook(epoch_ms: int):
    """scripts/obs_soak.py's phase-2 settings hook: the SLO plane and the
    control plane re-armed."""
    def hook(gs) -> None:
        gs.slo_enabled = True
        gs.global_control_enabled = True
        gs.global_epoch_ms = epoch_ms

    return hook


async def global_boot(P, gw_id: str, fed_cfg: dict, p: GlobalSoakParams, stop,
                      scratch: str) -> dict:
    """scripts/global_soak.py's ``boot3``: gateway ``gw_id``'s block of
    WORLD_3 with the control plane armed."""
    fp = FedSoakParams(heartbeat_ms=p.heartbeat_ms, trunk_timeout_ms=p.trunk_timeout_ms,
                       handover_timeout_ms=p.handover_timeout_ms, global_tick_ms=p.global_tick_ms)
    return await fed_boot_gateway(P, gw_id, fed_cfg, fp, stop, scratch, expect_cells=8,
                                  settings_hook=global_settings_hook(p), world=WORLD_3)


def global_control_report(P, baseline: dict) -> dict:
    """scripts/global_soak.py's ``control_report``: the control plane's
    report and its metrics' deltas since ``baseline``."""
    inv = P.invariants
    d = inv.delta(inv.scrape(), baseline)
    migrations = {dict(labels)["result"]: int(value) for (name, labels), value in d.items()
                  if name == "global_migrations_total" and value}
    rep = P.federation.control.report()
    rep["metric_migrations"] = migrations
    rep["metric_adoptions"] = int(inv.sample_total(d, "gateway_adoptions_total"))
    rep["metric_deaths"] = int(inv.sample_total(d, "gateway_deaths_total"))
    return rep


def entity_alive(P, eid: int) -> bool:
    """scripts/global_soak.py's ``get_alive``."""
    ch = P.channel.get_channel(eid)
    return ch is not None and not ch.is_removing()


def entity_forensics(P, eids) -> dict:
    """scripts/global_soak.py's ``entity_forensics``: for each id, whether
    its entity channel lives, what the placement ledger says and which
    local cells' data hold a row."""
    gs = P.settings.global_settings
    ledger = getattr(P.controller.get_spatial_controller(), "_data_cell", {})
    out: dict = {}
    for eid in eids:
        rows = []
        for cid, ch in P.channel.all_channels().items():
            if gs.spatial_channel_id_start <= cid < gs.entity_channel_id_start \
                    and not ch.is_removing():
                ents = getattr(ch.get_data_message(), "entities", None)
                if ents is not None and eid in ents:
                    rows.append(cid)
        out[str(eid)] = {"channel": entity_alive(P, eid), "ledger": ledger.get(eid), "rows": rows}
    return out


async def live_child_main(role: str, gw_id: str, config: str, report_path: str,
                          params: dict) -> None:
    """Gateway ``gw_id`` of phase 17 through the port, driven over stdin:
    ``trace`` (17a's "b": scripts/trace_soak.py's ``remote_main``, the
    recorder on; report), ``obs`` (17b's "b": scripts/obs_soak.py's
    ``remote_main``, the SLO and control planes on; report writes
    ``build_local_digest()``) or ``global`` (17c's "b" and "c":
    scripts/global_soak.py's ``remote_main``; spawn, herd_to, quiesce,
    report). Every role answers exit. READY carries a JSON of the boot's
    parts (``ready``) and the modules of JAX, of the JAX package or of
    torch loaded; every report carries the latter too."""
    import asyncio
    import os

    from random import Random

    t0 = time.perf_counter()
    P = host_modules()
    modules_s = time.perf_counter() - t0
    with open(config) as f:
        fed_cfg = json.load(f)
    stop = asyncio.Event()
    scratch = os.path.dirname(os.path.abspath(report_path))
    journal = P.failover.journal
    t1 = time.perf_counter()
    if role == "trace":
        gw = await fed_boot_gateway(P, gw_id, fed_cfg, FedSoakParams(**PHASE2_TRUNK), stop,
                                    scratch)
        P.settings.global_settings.trace_enabled = True
        P.tracing.recorder.configure(enabled=True, ring_spans=16384, dump_path=scratch,
                                     origin=gw_id)
    elif role == "obs":
        gw = await fed_boot_gateway(P, gw_id, fed_cfg, FedSoakParams(**PHASE2_TRUNK), stop,
                                    scratch, settings_hook=obs_fed_settings_hook(
                                        int(params["fed_epoch_ms"])))
        P.slo.slo.configure(enabled=True)
    elif role == "global":
        p = GlobalSoakParams(**params)
        gw = await global_boot(P, gw_id, fed_cfg, p, stop, scratch)
    else:
        raise ValueError(f"no live child role {role!r}")
    plane, ctl = gw["plane"], gw["ctl"]
    baseline = P.invariants.scrape()
    jitter_task = None
    if role == "global":
        sim = FedSim(P, ctl, Random(p.seed ^ ord(gw_id)))
        x0, x1 = GLOBAL_XR[gw_id]

        async def jitter_loop():
            while not stop.is_set():
                sim.adopt_scan()
                if sim.local_ids():
                    sim.jitter(x0, x1, *GLOBAL_ZR)
                await asyncio.sleep(0.2)

        jitter_task = asyncio.ensure_future(jitter_loop())
    ready(modules_s, time.perf_counter() - t1)
    loop = asyncio.get_running_loop()
    reader = asyncio.StreamReader()
    await loop.connect_read_pipe(lambda: asyncio.StreamReaderProtocol(reader), sys.stdin)
    while True:
        line = await reader.readline()
        if not line:
            break
        try:
            cmd = json.loads(line)
        except ValueError:
            continue
        name = cmd.get("cmd")
        if name == "spawn" and role == "global":
            sim.create_entities(int(cmd["n"]), x0, x1, *GLOBAL_ZR,
                                base=GLOBAL_BASE[gw_id] + int(cmd.get("offset", 0)))
            print(f"OK spawn {cmd['n']}", flush=True)
        elif name == "herd_to" and role == "global":
            sim.adopt_scan()
            moved = sim.herd(sim.local_ids()[: int(cmd.get("n", 8))], *GLOBAL_XR[cmd["gw"]],
                             *GLOBAL_ZR)
            print(f"OK herd_to {len(moved)}", flush=True)
        elif name == "quiesce" and role == "global":
            jitter_task.cancel()
            deadline = time.monotonic() + float(cmd.get("drain_s", 10.0))
            while time.monotonic() < deadline and (plane._pending or plane._parked
                                                   or journal.in_flight_count()):
                await asyncio.sleep(0.1)
            print("OK quiesce", flush=True)
        elif name == "report":
            report = dict(gateway=gw_id, modules=foreign_modules(), spatial=type(ctl).__name__)
            if role == "trace":
                report.update(ledger=dict(plane.ledger), spans=[
                    {"name": s["name"], "trace": s["trace"], "tick": s["tick"]}
                    for s in P.tracing.recorder.snapshot() if s.get("trace")])
            elif role == "obs":
                report["digest"] = P.fleet_obs.build_local_digest()
            else:
                placement = fed_local_placement(P)
                report.update(
                    ledger=dict(plane.ledger), control=global_control_report(P, baseline),
                    placement=placement,
                    forensics=entity_forensics(P, [int(e) for e in placement
                                                   if not e.startswith("__")]),
                    pending=len(plane._pending), parked=len(plane._parked),
                    journal=journal.report(), events=plane.events[-400:])
            with open(report_path, "w") as f:
                json.dump(report, f)
            print("OK report", flush=True)
        elif name == "exit":
            break
    stop.set()
    if jitter_task is not None:
        jitter_task.cancel()
    fed_teardown_gateway(P, gw)


def live_child(role: str, gw_id: str, config: str, report_path: str, params: str) -> int:
    """``chip_smoke.py --live-child ROLE GW CONFIG REPORT PARAMS``: one of
    phase 17's child gateways (PARAMS: the role's parameters as JSON)."""
    import asyncio

    asyncio.run(live_child_main(role, gw_id, config, report_path, json.loads(params)))
    return 0


# ---- phase 18: scripts/abuse_soak.py, the edge plane under three attacker classes ----


@dataclasses.dataclass
class AbuseSoakParams:
    """scripts/abuse_soak.py's AbuseSoakParams."""
    attack_s: float = 14.0
    quiesce_s: float = 4.0
    honest: int = 8
    slow_readers: int = 3
    malformed: int = 3
    flood_ips: int = 3
    msg_rate: float = 30.0  # per honest client
    flood_rate: float = 150.0  # broadcasts/s to the slow readers
    flood_payload: int = 8192
    auth_deadline_ms: int = 1200
    rss_growth_mb_bound: float = 256.0
    seed: int = 0xAB05E
    out_path: str = ""


# scripts/abuse_soak.py's pins: the side planes off (the edge plane's own
# envelope), and its edge knobs (shipping semantics, the ladder's graces
# compressed so that a soak-scale flood walks it in seconds).
ABUSE_PINS = dict(development=True, balancer_enabled=False, partition_enabled=False,
                  device_guard_enabled=False, slo_enabled=False, trace_enabled=False,
                  federation_config="")
EDGE_KNOBS = dict(edge_send_queue_max_msgs=512, edge_send_queue_max_bytes=1 << 20,
                  edge_slow_grace_s=1.0, edge_quarantine_grace_s=0.5,
                  edge_transport_high_bytes=128 * 1024)
# Each attacker class's loopback source range: source i is PREFIX + (i + 1).
ATTACKER_SOURCES = {"slow_reader": "127.0.1.", "malformed_frame": "127.0.2.",
                    "connect_flood": "127.0.3."}
# The script's invariants, under its names, in its order.
ABUSE_INVARIANTS = (
    "honest_census_exact", "no_honest_disconnects", "all_survivors_authenticated",
    "honest_delivery_exact", "honest_traffic_flowed", "slow_readers_engaged",
    "slow_reader_ladder_dropped_to_resync", "slow_readers_quarantined",
    "slow_readers_structurally_disconnected", "malformed_sessions_ran",
    "malformed_counted_at_framing", "malformed_sessions_connection_fatal",
    "flood_reaped_at_auth_deadline", "flood_sources_banned", "flood_refused_after_ban",
    "honest_sources_never_banned", "quarantine_ledger_matches_metric",
    "malformed_ledger_matches_metric", "egress_drop_ledger_matches_metric",
    "reap_ledger_matches_metric", "no_envelope_breach", "rss_growth_bounded_mb")


def rss_mb() -> float:
    """scripts/abuse_soak.py's ``_rss_mb``: this process's resident set."""
    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE") / (1024.0 * 1024.0)


def hostile_bytes(r) -> bytes:
    """scripts/abuse_soak.py's ``_hostile_bytes``: one hostile frame drawn
    from ``r``: bad magic (framing-fatal at byte 0), a valid magic with an
    undefined compression tag, or valid framing around a garbage Packet."""
    import struct

    kind = r.randrange(3)
    if kind == 0:
        return b"XX" + bytes(r.randrange(256) for _ in range(16))
    if kind == 1:
        return b"CH" + struct.pack(">H", 32) + b"\x77" + bytes(32)
    body = bytes(r.randrange(256) for _ in range(r.randrange(8, 64)))
    return b"CH" + struct.pack(">H", len(body)) + b"\x00" + body


def malformed_rng(p: AbuseSoakParams, i: int):
    """The seeded stream of malformed-frame attacker ``i``."""
    from random import Random

    return Random(p.seed ^ (0x600D + i))


async def run_abuse_soak(P, p: AbuseSoakParams) -> dict:
    """scripts/abuse_soak.py's ``run_abuse_soak`` through one package's host
    modules: a real gateway (TCP listeners on loopback, the 1 ms pump, the
    unauth reaper) with no spatial controller, an honest fleet whose every
    forward is delivery-accounted at the GLOBAL owner, and an attack window
    in which slow readers, malformed-frame sessions and a connect flood run
    at once, each class from its own loopback range. The invariants and the
    report under the script's names; the chaos soak's client helpers are
    phase 14's copies (``soak_frame``, ``soak_auth``, ``soak_read_frames``)."""
    import asyncio
    import socket
    import struct

    inv_mod, edge = P.invariants, P.edge
    gs = P.settings.global_settings
    MT, CT = P.types.MessageType, P.types.ChannelType
    t_start = time.monotonic()

    # -- fresh runtime --
    P.channel.reset_channels()
    P.connection.reset_connections()
    P.data.reset_registries()
    P.ddos.reset_ddos()
    P.recovery.reset_recovery()
    P.settings.reset_global_settings()
    P.overload.reset_overload()
    P.federation.reset_federation()
    for name, value in ABUSE_PINS.items():
        setattr(gs, name, value)
    P.tracing.recorder.configure(enabled=False)
    for name, value in EDGE_KNOBS.items():
        setattr(gs, name, value)
    gs.auth_deadline_ms = p.auth_deadline_ms

    P.connection.init_connections(os.path.join(HERE, SERVER_FSM), os.path.join(HERE, CLIENT_FSM))
    P.channel.init_channels()
    P.ddos.init_anti_ddos()

    host = "127.0.0.1"
    server_srv = await P.server.start_listening(P.types.ConnectionType.SERVER, "tcp", f"{host}:0")
    server_port = server_srv.sockets[0].getsockname()[1]
    client_srv = await P.server.start_listening(P.types.ConnectionType.CLIENT, "tcp", f"{host}:0")
    client_port = client_srv.sockets[0].getsockname()[1]

    stop = asyncio.Event()
    send_stop = asyncio.Event()
    attack_over = asyncio.Event()
    tasks = [asyncio.ensure_future(P.server.flush_loop()),
             asyncio.ensure_future(P.ddos.unauth_reaper_loop())]

    async def connect_from(src_ip: str, rcvbuf: int = 0):
        """Connect to the CLIENT listener from a chosen loopback source; a
        small SO_RCVBUF makes 'stops reading' bite within soak-scale bytes."""
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        if rcvbuf:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, rcvbuf)
        sock.setblocking(False)
        sock.bind((src_ip, 0))
        try:
            await asyncio.get_running_loop().sock_connect(sock, (host, client_port))
        except OSError:
            sock.close()
            raise
        return await asyncio.open_connection(sock=sock)

    # -- master: GLOBAL owner + honest delivery drain + the flooder --
    m_reader, m_writer = await asyncio.open_connection(host, server_port)
    await soak_auth(P, m_reader, m_writer, "abuse-master")
    m_writer.write(soak_frame(P, MT.CREATE_CHANNEL, P.control_pb2.CreateChannelMessage(
        channelType=CT.GLOBAL).SerializeToString()))
    await m_writer.drain()

    drained: dict = {}

    def on_master_pack(mp) -> None:
        if mp.msgType < 100:
            return
        sfm = P.wire_pb2.ServerForwardMessage()
        try:
            sfm.ParseFromString(mp.msgBody)
            cid, seq = struct.unpack("<II", sfm.payload[:8])
        except Exception:
            return
        drained.setdefault(cid, set()).add(seq)

    tasks.append(asyncio.ensure_future(soak_read_frames(P, m_reader, on_master_pack, stop)))

    gch = P.channel.get_global_channel()
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and not gch.has_owner():
        await asyncio.sleep(0.05)
    if not gch.has_owner():
        raise RuntimeError("master never possessed GLOBAL")

    # -- honest fleet --
    sent: dict = {}
    honest_writers: list = []
    honest_drops = {"n": 0}

    async def honest_client(idx: int) -> None:
        reader, writer = await asyncio.open_connection(host, client_port)
        await soak_auth(P, reader, writer, f"honest-{idx}")
        honest_writers.append(writer)
        reader_task = asyncio.ensure_future(soak_read_frames(P, reader, lambda mp: None, stop))
        interval = 1.0 / p.msg_rate
        seq = 0
        try:
            while not stop.is_set():
                if reader_task.done():
                    honest_drops["n"] += 1
                    return
                if send_stop.is_set():
                    # Traffic cut off: hold the socket open quietly, the
                    # census needs this session alive at the end.
                    await asyncio.sleep(0.2)
                    continue
                writer.write(soak_frame(P, 100, struct.pack("<II", idx, seq)))
                await writer.drain()
                seq += 1
                sent[idx] = seq
                await asyncio.sleep(interval)
        except (ConnectionError, OSError):
            honest_drops["n"] += 1
        finally:
            reader_task.cancel()

    for idx in range(p.honest):
        tasks.append(asyncio.ensure_future(honest_client(idx)))
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and len(honest_writers) < p.honest:
        await asyncio.sleep(0.05)
    if len(honest_writers) < p.honest:
        raise RuntimeError("honest fleet failed to come up")
    up_s = time.monotonic() - t_start

    # Timeline zero: the edge ledgers re-zero as the metric baseline is
    # scraped, so delta against the baseline equals the ledger.
    edge.reset_edge()
    baseline = inv_mod.scrape()
    rss_base = rss_mb()
    rss_peak = {"mb": rss_base}
    envelope_breaches: list = []

    async def poller() -> None:
        while not stop.is_set():
            rss_peak["mb"] = max(rss_peak["mb"], rss_mb())
            cap_m, cap_b = gs.edge_send_queue_max_msgs, gs.edge_send_queue_max_bytes
            for conn in list(P.connection.all_connections().values()):
                if len(conn.send_queue) > cap_m:
                    envelope_breaches.append(f"conn {conn.id}: {len(conn.send_queue)} msgs")
                if conn.envelope.queue_bytes > cap_b:
                    envelope_breaches.append(f"conn {conn.id}: {conn.envelope.queue_bytes} bytes")
            await asyncio.sleep(0.2)

    tasks.append(asyncio.ensure_future(poller()))

    # -- attacker class 1: slow readers --
    slow_stats = {"subscribed": 0, "sockets": []}

    async def slow_reader(i: int) -> None:
        src = f"{ATTACKER_SOURCES['slow_reader']}{i + 1}"
        try:
            reader, writer = await connect_from(src, rcvbuf=8192)
        except OSError:
            return
        slow_stats["sockets"].append(writer)
        try:
            await soak_auth(P, reader, writer, f"slow-{i}")
            writer.write(soak_frame(P, MT.SUB_TO_CHANNEL, P.control_pb2.SubscribedToChannelMessage(
                subOptions=P.control_pb2.ChannelSubscriptionOptions(
                    dataAccess=1)).SerializeToString()))  # READ: shed-eligible
            await writer.drain()
            # Drain the sub ack, then go silent while the flood fills the socket.
            await asyncio.sleep(0.3)
            slow_stats["subscribed"] += 1
            await attack_over.wait()
        except (ConnectionError, OSError, TimeoutError):
            pass

    # -- attacker class 2: malformed frames --
    mal_stats = {"sessions": 0, "gateway_closed": 0}

    async def malformed_attacker(i: int) -> None:
        src = f"{ATTACKER_SOURCES['malformed_frame']}{i + 1}"
        r = malformed_rng(p, i)
        while not attack_over.is_set():
            try:
                reader, writer = await connect_from(src)
            except OSError:
                await asyncio.sleep(0.3)
                continue
            mal_stats["sessions"] += 1
            try:
                for _ in range(r.randrange(1, 4)):
                    writer.write(hostile_bytes(r))
                    await writer.drain()
                    await asyncio.sleep(0.02)
                data = await asyncio.wait_for(reader.read(4096), timeout=0.5)
                while data:
                    data = await asyncio.wait_for(reader.read(4096), timeout=0.5)
                mal_stats["gateway_closed"] += 1  # EOF: connection-fatal
            except asyncio.TimeoutError:
                pass  # lingered (a non-fatal stage); close our end
            except (ConnectionError, OSError):
                mal_stats["gateway_closed"] += 1
            finally:
                with contextlib.suppress(Exception):
                    writer.close()
            await asyncio.sleep(0.15)

    # -- attacker class 3: connect flood --
    flood_stats = {"sessions": 0, "reaped": 0, "refused": 0}

    async def connect_flood(i: int) -> None:
        src = f"{ATTACKER_SOURCES['connect_flood']}{i + 1}"
        while not attack_over.is_set():
            try:
                reader, writer = await connect_from(src)
            except OSError:
                flood_stats["refused"] += 1
                await asyncio.sleep(0.3)
                continue
            flood_stats["sessions"] += 1
            t0 = time.monotonic()
            try:
                # Never authenticate; just hold the socket.
                data = await asyncio.wait_for(reader.read(4096),
                                              timeout=p.auth_deadline_ms / 1000.0 + 2.0)
                while data:
                    data = await asyncio.wait_for(reader.read(4096), 1.0)
            except (asyncio.TimeoutError, ConnectionError, OSError):
                pass
            held_s = time.monotonic() - t0
            # Cut near or after the deadline: reaped; cut at once: refused
            # at accept (the IP ban landed).
            if held_s >= p.auth_deadline_ms / 1000.0 * 0.5:
                flood_stats["reaped"] += 1
            else:
                flood_stats["refused"] += 1
            with contextlib.suppress(Exception):
                writer.close()
            await asyncio.sleep(0.2)

    # -- the flood the slow readers must not keep up with --
    async def flooder() -> None:
        interval = 1.0 / p.flood_rate
        body = P.wire_pb2.ServerForwardMessage(payload=bytes(p.flood_payload)).SerializeToString()
        frame = P.protocol.encode_packet(P.wire_pb2.Packet(messages=[P.wire_pb2.MessagePack(
            channelId=0, msgType=100, msgBody=body,
            broadcast=10)]))  # ALL | ALL_BUT_OWNER: subscribers minus master
        while not attack_over.is_set():
            m_writer.write(frame)
            await m_writer.drain()
            await asyncio.sleep(interval)

    # -- attack window --
    attack_tasks = [asyncio.ensure_future(flooder())]
    attack_tasks += [asyncio.ensure_future(slow_reader(i)) for i in range(p.slow_readers)]
    attack_tasks += [asyncio.ensure_future(malformed_attacker(i)) for i in range(p.malformed)]
    attack_tasks += [asyncio.ensure_future(connect_flood(i)) for i in range(p.flood_ips)]
    tasks.extend(attack_tasks)

    await asyncio.sleep(p.attack_s)
    attack_over.set()
    for w in slow_stats["sockets"]:
        with contextlib.suppress(Exception):
            w.close()

    # -- quiesce: honest senders go on while the wreckage settles, then
    # traffic stops and the last frames drain into the master.
    await asyncio.sleep(p.quiesce_s)
    send_stop.set()
    await asyncio.sleep(0.3)  # let any mid-iteration write complete
    sent_final = dict(sent)
    await asyncio.sleep(1.0)  # let the last written frames reach the drain
    stop.set()
    await asyncio.sleep(0.1)

    # -- invariants --
    inv = inv_mod.InvariantChecker()
    d = inv_mod.delta(inv_mod.scrape(), baseline)
    rss_final = rss_mb()

    # 1. Honest census exact: the surviving connections are exactly
    # {master} + the honest fleet, all authenticated.
    survivors = {c.pit: c for c in P.connection.all_connections().values()
                 if not c.is_closing()}
    expected_pits = {"abuse-master"} | {f"honest-{i}" for i in range(p.honest)}
    inv.expect_equal("honest_census_exact", sorted(survivors), sorted(expected_pits))
    inv.expect_equal("no_honest_disconnects", honest_drops["n"], 0)
    inv.check("all_survivors_authenticated",
              all(c.state == P.types.ConnectionState.AUTHENTICATED for c in survivors.values()),
              str({pit: c.state.name for pit, c in survivors.items()}))

    # 2. Honest delivery accounting intact.
    missing = {idx: n - len(drained.get(idx, ()) & set(range(n)))
               for idx, n in sent_final.items()
               if len(drained.get(idx, set()) & set(range(n))) != n}
    inv.expect_equal("honest_delivery_exact", missing, {})
    total_sent = sum(sent_final.values())
    inv.expect_gt("honest_traffic_flowed", total_sent, 0)

    # 3. Every attacker dealt with, per class.
    led = edge.ledgers
    inv.expect_equal("slow_readers_engaged", slow_stats["subscribed"], p.slow_readers)
    inv.expect_gt("slow_reader_ladder_dropped_to_resync",
                  led.egress_drop_counts.get("slow_consumer", 0), 0)
    inv.expect_equal("slow_readers_quarantined",
                     led.quarantine_counts.get("slow_consumer", 0), p.slow_readers)
    inv.expect_equal("slow_readers_structurally_disconnected",
                     led.reap_counts.get("quarantine", 0), p.slow_readers)
    inv.expect_gt("malformed_sessions_ran", mal_stats["sessions"], 2)
    inv.expect_gt("malformed_counted_at_framing", led.malformed_counts.get("framing", 0), 0)
    inv.expect_gt("malformed_sessions_connection_fatal", mal_stats["gateway_closed"], 0)
    inv.expect_gt("flood_reaped_at_auth_deadline", led.reap_counts.get("auth_timeout", 0), 0)
    banned_ips, _ = P.ddos.blacklist_snapshot()
    flood_srcs = {f"{ATTACKER_SOURCES['connect_flood']}{i + 1}" for i in range(p.flood_ips)}
    inv.check("flood_sources_banned", flood_srcs <= set(banned_ips),
              f"banned={sorted(banned_ips)}")
    inv.expect_gt("flood_refused_after_ban", flood_stats["refused"], 0)
    inv.check("honest_sources_never_banned", "127.0.0.1" not in banned_ips,
              f"banned={sorted(banned_ips)}")

    # 4. Double entry: each edge counter's delta equals its ledger.
    def family(name: str, label: str) -> dict:
        return {dict(labels)[label]: int(v) for (n, labels), v in d.items() if n == name and v}

    metrics = {"quarantine": family("conn_quarantine_total", "reason"),
               "malformed": family("malformed_frames_total", "stage"),
               "egress_drops": family("egress_dropped_total", "reason"),
               "reaps": family("conn_reaped_total", "reason")}
    inv.expect_equal("quarantine_ledger_matches_metric", metrics["quarantine"],
                     led.quarantine_counts)
    inv.expect_equal("malformed_ledger_matches_metric", metrics["malformed"],
                     led.malformed_counts)
    inv.expect_equal("egress_drop_ledger_matches_metric", metrics["egress_drops"],
                     led.egress_drop_counts)
    inv.expect_equal("reap_ledger_matches_metric", metrics["reaps"], led.reap_counts)

    # 5. Resources bounded under attack.
    inv.expect_equal("no_envelope_breach", envelope_breaches[:8], [])
    rss_growth = rss_peak["mb"] - rss_base
    inv.expect_le("rss_growth_bounded_mb", round(rss_growth, 1), p.rss_growth_mb_bound)

    report = {
        "kind": "abuse_soak",
        "duration_s": round(time.monotonic() - t_start, 2),
        "up_s": round(up_s, 3),
        "phases": {"attack_s": p.attack_s, "quiesce_s": p.quiesce_s},
        "seed": p.seed,
        "attackers": {
            "classes": list(ATTACKER_SOURCES),
            "slow_reader": {"count": p.slow_readers,
                            **{k: v for k, v in slow_stats.items() if k != "sockets"}},
            "malformed_frame": {"count": p.malformed, **mal_stats},
            "connect_flood": {"ips": p.flood_ips, **flood_stats},
        },
        "edge": {
            "quarantine": dict(led.quarantine_counts),
            "malformed": dict(led.malformed_counts),
            "egress_drops": dict(led.egress_drop_counts),
            "reaps": dict(led.reap_counts),
            "banned_ips": sorted(banned_ips),
        },
        "metrics": metrics,
        "census": {"expected": sorted(expected_pits), "survivors": sorted(survivors),
                   "honest_disconnects": honest_drops["n"]},
        "delivery": {"honest_clients": p.honest, "frames_sent": total_sent,
                     "frames_drained": sum(len(v) for v in drained.values()),
                     "missing": missing},
        "rss": {"base_mb": round(rss_base, 1), "peak_mb": round(rss_peak["mb"], 1),
                "final_mb": round(rss_final, 1), "growth_mb": round(rss_growth, 1),
                "bound_mb": p.rss_growth_mb_bound},
        "invariants": inv.summary(),
    }

    stop.set()
    for t in tasks:
        t.cancel()
    await asyncio.sleep(0)
    for w in [m_writer, *honest_writers]:
        with contextlib.suppress(Exception):
            w.close()
    server_srv.close()
    client_srv.close()
    P.channel.reset_channels()
    P.connection.reset_connections()
    P.data.reset_registries()
    P.ddos.reset_ddos()
    P.recovery.reset_recovery()
    P.settings.reset_global_settings()
    P.overload.reset_overload()
    return report


def edge_child(report_path: str) -> int:
    """``chip_smoke.py --edge-child REPORT``: phase 18's soak at
    AbuseSoakParams() in a process of its own, which loads the port's host
    layers and nothing of torch, so its RSS is a gateway's own and no kernel
    can launch. The report is the soak's, with the boot's parts (``boot``)
    and the foreign modules loaded by its end (``modules``)."""
    import asyncio

    t0 = time.perf_counter()
    P = host_modules()
    boot = ready(time.perf_counter() - t0, None)
    report = asyncio.run(run_abuse_soak(P, AbuseSoakParams()))
    report.update(boot=boot, modules=foreign_modules())
    with open(report_path, "w") as f:
        json.dump(report, f)
    print("OK report", flush=True)
    return 0


# ---- the roles' dispatch ------------------------------------------------------------

ROLES = {
    "--fed-child": lambda a: fed_child(a[0], a[1]),
    "--crash-child": lambda a: crash_child(a[0], a[1], a[2], int(a[3])),
    "--live-child": lambda a: live_child(*a[:5]),
    "--edge-child": lambda a: edge_child(a[0]),
}


def run_role(argv: list, imports_s: float) -> int:
    """Run the host-grid role ``argv[0]`` with its arguments ``argv[1:]``;
    ``imports_s``: the seconds the script's imports took before it."""
    global IMPORTS_S
    IMPORTS_S = imports_s
    return ROLES[argv[0]](argv[1:])
