"""Replay load-test harness (ref: pkg/replay/replay.go).

Replays recorded ``.cpr`` packet sessions against a live gateway: N
connections per group, staggered connects, per-packet timing scaled by
an interval multiplier, optional auth-once and wait-for-auth, and hook
points to rewrite channel ids / messages before sending — the reference's
load-test driver surface.

Case config JSON (same keys as the reference):

    {"channeldAddr": "127.0.0.1:12108",
     "connectionGroups": [{"cprFilePath": ..., "connectionNumber": 8,
       "connectInterval": "20ms", "runningTime": "10s",
       "actionIntervalMultiplier": 1.0, "waitAuthSuccess": true,
       "authOnlyOnce": true, "sleepEndOfSession": "0s"}]}
"""

from __future__ import annotations

import json
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..client import Client
from ..core.types import MessageType
from ..utils.logger import get_logger
from .session import ReplaySession

logger = get_logger("replay.harness")


def parse_duration(value) -> float:
    """Go-style durations ("20ms", "1.5s", "1m") or raw nanoseconds."""
    if isinstance(value, (int, float)):
        return float(value) / 1e9
    total = 0.0
    for num, unit in re.findall(r"([\d.]+)(ns|us|µs|ms|s|m|h)", value):
        total += float(num) * {
            "ns": 1e-9, "us": 1e-6, "µs": 1e-6, "ms": 1e-3,
            "s": 1.0, "m": 60.0, "h": 3600.0,
        }[unit]
    return total


@dataclass
class ConnectionGroupConfig:
    cpr_file_path: str = ""
    connection_number: int = 1
    connect_interval: float = 0.0
    running_time: float = 1.0
    sleep_end_of_session: float = 0.0
    action_interval_multiplier: float = 1.0
    wait_auth_success: bool = True
    auth_only_once: bool = True

    @classmethod
    def from_dict(cls, d: dict) -> "ConnectionGroupConfig":
        return cls(
            cpr_file_path=d.get("cprFilePath", ""),
            connection_number=d.get("connectionNumber", 1),
            connect_interval=parse_duration(d.get("connectInterval", 0)),
            running_time=parse_duration(d.get("runningTime", "1s")),
            sleep_end_of_session=parse_duration(d.get("sleepEndOfSession", 0)),
            action_interval_multiplier=d.get("actionIntervalMultiplier", 1.0),
            wait_auth_success=d.get("waitAuthSuccess", True),
            auth_only_once=d.get("authOnlyOnce", True),
        )


@dataclass
class CaseConfig:
    channeld_addr: str = "127.0.0.1:12108"
    connection_groups: list[ConnectionGroupConfig] = field(default_factory=list)


class ReplayClient:
    """(ref: replay.go ReplayClient)."""

    def __init__(self, case_config: CaseConfig):
        self.case_config = case_config
        self.sessions: list[ReplaySession] = [
            ReplaySession.load(g.cpr_file_path) for g in case_config.connection_groups
        ]
        # Hooks (ref: Set*Handler): rewrite or veto outgoing packs.
        self.alter_channel_id: Optional[Callable] = None
        # msg_type -> (template_cls, handler(msg, msg_pack, client) -> bool);
        # the recorded body is parsed into the template, the handler may
        # mutate it in place (e.g. rewrite connId to the replayer's own id)
        # or veto the send (ref: replay.go SetBeforeSendMessageEntry).
        self.before_send: dict[int, tuple] = {}
        self.stats_lock = threading.Lock()
        self.packets_sent = 0
        self.messages_received = 0
        self.authenticated = 0  # connections whose AUTH was answered

    @classmethod
    def from_config_file(cls, path: str) -> "ReplayClient":
        with open(path) as f:
            raw = json.load(f)
        cfg = CaseConfig(
            channeld_addr=raw.get("channeldAddr", "127.0.0.1:12108"),
            connection_groups=[
                ConnectionGroupConfig.from_dict(g)
                for g in raw.get("connectionGroups", [])
            ],
        )
        return cls(cfg)

    def run(self) -> dict:
        """Run every group to completion; returns aggregate stats."""
        threads = []
        for group, session in zip(self.case_config.connection_groups, self.sessions):
            for i in range(group.connection_number):
                t = threading.Thread(
                    target=self._run_connection, args=(group, session, i), daemon=True
                )
                threads.append(t)
                t.start()
                if group.connect_interval > 0:
                    time.sleep(group.connect_interval)
        for t in threads:
            t.join()
        return {
            "packets_sent": self.packets_sent,
            "messages_received": self.messages_received,
            "connections": len(threads),
            "authenticated": self.authenticated,
        }

    def _run_connection(self, group: ConnectionGroupConfig, session, index: int) -> None:
        try:
            client = Client(self.case_config.channeld_addr)
        except OSError as e:
            logger.error("replay connection %d failed to dial: %s", index, e)
            return
        received = [0]
        client.add_message_handler(
            MessageType.CHANNEL_DATA_UPDATE,
            lambda c, ch, m: received.__setitem__(0, received[0] + 1),
        )
        authed = [False]
        client.add_message_handler(
            MessageType.AUTH, lambda c, ch, m: authed.__setitem__(0, True)
        )

        deadline = time.time() + group.running_time
        first_pass = True
        try:
            while time.time() < deadline:
                for rp in session.proto.packets:
                    if time.time() >= deadline:
                        break
                    wait = rp.offsetTime / 1e9 * group.action_interval_multiplier
                    end = time.time() + wait
                    while time.time() < end:
                        client.tick(timeout=0.005)
                    for mp in rp.packet.messages:
                        if (
                            mp.msgType == MessageType.AUTH
                            and group.auth_only_once
                            and not first_pass
                        ):
                            continue
                        channel_id, send_it = mp.channelId, True
                        if self.alter_channel_id is not None:
                            channel_id, send_it = self.alter_channel_id(
                                mp.channelId, mp.msgType, mp, client
                            )
                        if not send_it:
                            continue
                        body = mp.msgBody
                        entry = self.before_send.get(mp.msgType)
                        if entry is not None:
                            template_cls, handler = entry
                            # A wrong template or corrupt recorded body must
                            # not kill the connection's whole remaining run
                            # (ref: replay.go:307-310 logs and skips).
                            try:
                                msg = template_cls()
                                msg.ParseFromString(body)
                                if not handler(msg, mp, client):
                                    continue
                                body = msg.SerializeToString()
                            except Exception:
                                # The hook exists because the recorded bytes
                                # are wrong as-is — skip rather than send them.
                                logger.exception(
                                    "before_send hook failed for msgType %d; "
                                    "skipping message", mp.msgType,
                                )
                                continue
                        client.send_raw(channel_id, mp.broadcast, mp.msgType, body)
                        with self.stats_lock:
                            self.packets_sent += 1
                    client.tick()
                    if first_pass and group.wait_auth_success:
                        end = time.time() + 3.0
                        while not authed[0] and time.time() < end:
                            client.tick(timeout=0.05)
                first_pass = False
                if group.sleep_end_of_session > 0:
                    time.sleep(group.sleep_end_of_session)
        finally:
            with self.stats_lock:
                self.messages_received += received[0]
                self.authenticated += authed[0]
            client.disconnect()
