"""The port's replay tooling (channeld_tpu_torch/replay).

The counterparts of tests/test_replay.py on the port's runtime: the
harness replays a recorded session over real sockets against the port's
listener (the before-send hook rewrites each connection's sub), and the
CLI. ``python -m channeld_tpu_torch.replay dump`` prints what
``python -m channeld_tpu.replay dump`` prints for
examples/sessions/chat_demo.cpr, and ``run`` reports every connection
authenticated.
"""

from __future__ import annotations

import asyncio
import json
import os
import socket
import subprocess
import sys
import threading
import time

import pytest

from channeld_tpu_torch.core import connection as connection_mod
from channeld_tpu_torch.core.fsm import MessageFsm
from channeld_tpu_torch.core.server import flush_loop, start_listening
from channeld_tpu_torch.core.settings import global_settings
from channeld_tpu_torch.core.types import BroadcastType, ConnectionType, MessageType
from channeld_tpu_torch.models import testdata_pb2
from channeld_tpu_torch.protocol import control_pb2, wire_pb2
from channeld_tpu_torch.replay.harness import CaseConfig, ConnectionGroupConfig, ReplayClient
from channeld_tpu_torch.replay.session import ReplaySession
from channeld_tpu_torch.utils.anyutil import pack_any

from test_torch_gateway import PORT, REPO, fresh_runtime, port_globals

CHAT_DEMO = "examples/sessions/chat_demo.cpr"
OPEN_FSM = {
    "States": [{"Name": "OPEN", "MsgTypeWhitelist": "1-65535", "MsgTypeBlacklist": ""}],
    "Transitions": [],
}


@pytest.fixture(autouse=True)
def runtime(tmp_path):
    with port_globals(tmp_path):
        gch = fresh_runtime(PORT)
        global_settings.development = True
        connection_mod.set_fsm_templates(MessageFsm.from_dict(OPEN_FSM),
                                         MessageFsm.from_dict(OPEN_FSM))
        yield gch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def build_session(tmp_path) -> str:
    """Record: auth, sub (with a WRONG connId the hook must rewrite),
    two data updates."""
    s = ReplaySession()
    auth = control_pb2.AuthMessage(playerIdentifierToken="rec", loginToken="lt")
    sub = control_pb2.SubscribedToChannelMessage(
        connId=424242,
        subOptions=control_pb2.ChannelSubscriptionOptions(dataAccess=2, fanOutIntervalMs=20))
    upd = control_pb2.ChannelDataUpdateMessage(
        data=pack_any(testdata_pb2.TestChannelDataMessage(text="replayed")))
    for offset, msg_type, body in [
        (0, MessageType.AUTH, auth.SerializeToString()),
        (10_000_000, MessageType.SUB_TO_CHANNEL, sub.SerializeToString()),
        (20_000_000, MessageType.CHANNEL_DATA_UPDATE, upd.SerializeToString()),
        (30_000_000, MessageType.CHANNEL_DATA_UPDATE, upd.SerializeToString()),
    ]:
        packet = wire_pb2.Packet()
        packet.messages.add(channelId=0, broadcast=BroadcastType.NO_BROADCAST,
                            msgType=msg_type, msgBody=body)
        s.proto.packets.add(offsetTime=offset, packet=packet)
    path = str(tmp_path / "case.cpr")
    with open(path, "wb") as f:
        f.write(s.proto.SerializeToString())
    return path


class Gateway:
    """The port's CLIENT listener and GLOBAL tick on a loop thread."""

    def __init__(self, port: int):
        from channeld_tpu_torch.core.channel import get_global_channel

        self.loop, self.stop = asyncio.new_event_loop(), threading.Event()

        async def gateway():
            server = await start_listening(ConnectionType.CLIENT, "tcp", f":{port}")
            flusher = asyncio.ensure_future(flush_loop())
            gch = get_global_channel()
            gch.init_data(testdata_pb2.TestChannelDataMessage(text="seed"), None)
            try:
                while not self.stop.is_set():
                    gch.tick_once(gch.get_time())
                    await asyncio.sleep(0.005)
            finally:
                flusher.cancel()
                server.close()
                await server.wait_closed()

        def run():
            try:
                self.loop.run_until_complete(gateway())
            finally:
                self.loop.close()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        time.sleep(0.5)

    def close(self) -> None:
        self.stop.set()
        self.thread.join(timeout=5)


def test_replay_harness_end_to_end(tmp_path):
    cpr = build_session(tmp_path)
    port = free_port()
    gateway = Gateway(port)
    try:
        rc = ReplayClient(CaseConfig(
            channeld_addr=f"127.0.0.1:{port}",
            connection_groups=[ConnectionGroupConfig(
                cpr_file_path=cpr, connection_number=3, connect_interval=0.01,
                running_time=1.5, action_interval_multiplier=1.0, wait_auth_success=True,
                auth_only_once=True, sleep_end_of_session=0.05)],
        ))
        rewrote = []

        def rewrite_sub(msg, mp, client):
            assert msg.connId == 424242  # the recorded (wrong) id
            msg.connId = client.id
            rewrote.append(client.id)
            return True

        rc.before_send[MessageType.SUB_TO_CHANNEL] = (
            control_pb2.SubscribedToChannelMessage, rewrite_sub)
        stats = rc.run()
    finally:
        gateway.close()
    assert stats["packets_sent"] >= 9  # 3 conns x (auth + sub + 2 upd) - dups
    assert stats["messages_received"] > 0  # fan-outs made it back
    assert len(set(rewrote)) == 3  # every connection got its own rewrite
    assert (stats["connections"], stats["authenticated"]) == (3, 3)


def cli(package: str, *args) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m", f"{package}.replay", *args], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=120)


def test_replay_cli_dump_equals_the_jax_package():
    """The port's dump of chat_demo.cpr is the JAX package's, line for
    line."""
    port, jax = cli(PORT, "dump", CHAT_DEMO), cli("channeld_tpu", "dump", CHAT_DEMO)
    assert port.returncode == 0 and jax.returncode == 0, (port.stderr, jax.stderr)
    assert port.stdout == jax.stdout
    assert "AUTH" in port.stdout and "CHANNEL_DATA_UPDATE" in port.stdout
    assert "msgType histogram" in port.stdout


def test_replay_cli_run_authenticates_every_connection(tmp_path):
    """``run <case.json>`` replays chat_demo.cpr with 4 connections
    against the port's listener and prints its result as JSON."""
    port = free_port()
    case = tmp_path / "case.json"
    case.write_text(json.dumps({
        "channeldAddr": f"127.0.0.1:{port}",
        "connectionGroups": [{"cprFilePath": os.path.join(REPO, CHAT_DEMO),
                              "connectionNumber": 4, "connectInterval": "10ms",
                              "runningTime": "1s", "waitAuthSuccess": True,
                              "authOnlyOnce": True}]}))
    gateway = Gateway(port)
    try:
        out = cli(PORT, "run", str(case))
    finally:
        gateway.close()
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert (result["connections"], result["authenticated"]) == (4, 4)
    assert result["packets_sent"] >= 4 * 7  # every connection sent the whole session


def test_replay_cli_usage(capsys):
    from channeld_tpu_torch.replay.__main__ import main

    assert main([]) == 64
