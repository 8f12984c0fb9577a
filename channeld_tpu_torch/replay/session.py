"""Recording of client packet sessions (ref: pkg/channeld/connection.go:768-821).

Client packets are timestamped relative to the previous packet and persisted
as ``.cpr`` files on connection close when ``-erp`` is enabled.
"""

from __future__ import annotations

import os
import time

from ..protocol import replay_pb2, wire_pb2
from ..utils.logger import get_logger

logger = get_logger("replay")


class ReplaySession:
    def __init__(self):
        self.proto = replay_pb2.ReplaySession()
        self._last_time_ns = 0

    def record(self, packet: wire_pb2.Packet) -> None:
        now = time.time_ns()
        offset = 0 if self._last_time_ns == 0 else now - self._last_time_ns
        self._last_time_ns = now
        rp = self.proto.packets.add(offsetTime=offset)
        rp.packet.CopyFrom(packet)

    def persist(self, directory: str, conn_id: int) -> str | None:
        if not self.proto.packets:
            return None
        directory = directory or "."
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(
            directory, f"session_{conn_id}_{time.strftime('%Y%m%d%H%M%S')}.cpr"
        )
        with open(path, "wb") as f:
            f.write(self.proto.SerializeToString())
        logger.info("persisted replay session to %s", path)
        return path

    @classmethod
    def load(cls, path: str) -> "ReplaySession":
        s = cls()
        with open(path, "rb") as f:
            s.proto.ParseFromString(f.read())
        return s
