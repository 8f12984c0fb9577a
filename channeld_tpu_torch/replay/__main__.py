"""Replay tooling CLI: ``python -m channeld_tpu.replay <cmd>``.

    run <case.json>    replay recorded sessions against a live gateway
                       (the reference's load-test driver surface,
                       ref: pkg/replay/replay.go; same case-config JSON)
    dump <file.cpr>    inspect a recorded session: per-packet offset,
                       channel, msgType, body size — the quickest way to
                       see what a reference-recorded capture contains
"""

from __future__ import annotations

import json
import sys


def _dump(path: str) -> int:
    from ..core.types import MessageType
    from .session import ReplaySession

    session = ReplaySession.load(path)
    total_ns = 0
    counts: dict[int, int] = {}
    for i, rp in enumerate(session.proto.packets):
        total_ns += rp.offsetTime
        for pack in rp.packet.messages:
            counts[pack.msgType] = counts.get(pack.msgType, 0) + 1
            try:
                name = MessageType(pack.msgType).name
            except ValueError:
                name = f"USER_SPACE({pack.msgType})"
            print(f"{i:5d} +{rp.offsetTime / 1e6:9.2f}ms "
                  f"ch={pack.channelId:<8d} {name:<24s} "
                  f"{len(pack.msgBody)}B"
                  + (f" stub={pack.stubId}" if pack.stubId else "")
                  + (f" bcast={pack.broadcast}" if pack.broadcast else ""))
    print(f"-- {len(session.proto.packets)} packets, "
          f"{total_ns / 1e9:.2f}s span, msgType histogram: "
          f"{dict(sorted(counts.items()))}")
    return 0


def _run(path: str) -> int:
    from .harness import ReplayClient

    result = ReplayClient.from_config_file(path).run()
    print(json.dumps(result))
    return 0


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "dump":
        return _dump(argv[1])
    if len(argv) == 2 and argv[0] == "run":
        return _run(argv[1])
    print(__doc__, file=sys.stderr)
    return 64


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
