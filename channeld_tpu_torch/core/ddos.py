"""Anti-DDoS: auth-failure counters, IP/PIT blacklists, unauth-timeout
reaper (ref: pkg/channeld/ddos.go).
"""

from __future__ import annotations

import asyncio
import time
from typing import Optional

from ..utils.logger import security_logger
from . import events
from .auth import AuthResult
from .settings import global_settings
from .types import ConnectionState, ConnectionType

_failed_auth_counters: dict[str, int] = {}
_ip_blacklist: dict[str, float] = {}
_pit_blacklist: dict[str, float] = {}
# conn_id -> Connection, pending authentication.
_unauthenticated_connections: dict[int, object] = {}


def is_ip_banned(ip: Optional[str]) -> bool:
    return ip in _ip_blacklist


def is_pit_banned(pit: str) -> bool:
    return pit in _pit_blacklist


def ban_ip(ip: str) -> None:
    """The ONE write path for an IP ban: the blacklist entry plus its
    WAL record (doc/persistence.md) — a crash-restart must not hand
    attackers a clean slate."""
    from .wal import wal

    if ip not in _ip_blacklist and wal.enabled:
        wal.log_blacklist("ip", ip)
    _ip_blacklist[ip] = time.monotonic()


def ban_pit(pit: str) -> None:
    """The ONE write path for a PIT ban (see :func:`ban_ip`)."""
    from .wal import wal

    if pit not in _pit_blacklist and wal.enabled:
        wal.log_blacklist("pit", pit)
    _pit_blacklist[pit] = time.monotonic()


def blacklist_snapshot() -> tuple[list[str], list[str]]:
    """(banned ips, banned pits) for the gateway snapshot's extras."""
    return sorted(_ip_blacklist), sorted(_pit_blacklist)


def restore_blacklists(ips, pits) -> tuple[int, int]:
    """Boot-restore path (snapshot + WAL replay): re-arm persisted bans.
    Restored entries get a fresh monotonic stamp — ban age does not
    survive a restart, which errs on the side of keeping attackers out."""
    now = time.monotonic()
    n_ips = n_pits = 0
    for ip in ips:
        if ip not in _ip_blacklist:
            _ip_blacklist[ip] = now
            n_ips += 1
    for pit in pits:
        if pit not in _pit_blacklist:
            _pit_blacklist[pit] = now
            n_pits += 1
    if n_ips or n_pits:
        security_logger().info(
            "restored %d IP and %d PIT blacklist entries from durable "
            "state", n_ips, n_pits,
        )
    return n_ips, n_pits


def track_unauthenticated(conn) -> None:
    if global_settings.effective_auth_deadline_ms() > 0:
        _unauthenticated_connections[conn.id] = conn


def untrack_unauthenticated(conn_id: int) -> None:
    _unauthenticated_connections.pop(conn_id, None)


def on_auth_result(conn, result, pit: str = "") -> None:
    """Failed-auth accounting (ref: ddos.go:18-46). Called from the auth
    completion path for both outcomes; ``pit`` comes from the auth message
    (the connection only learns its PIT on success)."""
    if conn.connection_type == ConnectionType.SERVER:
        return
    if result == AuthResult.INVALID_LT:
        key = pit
        _failed_auth_counters[key] = _failed_auth_counters.get(key, 0) + 1
        limit = global_settings.max_failed_auth_attempts
        if limit > 0 and _failed_auth_counters[key] >= limit:
            ban_pit(key)
            security_logger().info("blacklisted PIT %s: too many failed auths", key)
            conn.close()
    elif result == AuthResult.INVALID_PIT:
        ip = conn.remote_ip()
        if ip is None:
            return
        _failed_auth_counters[ip] = _failed_auth_counters.get(ip, 0) + 1
        limit = global_settings.max_failed_auth_attempts
        if limit > 0 and _failed_auth_counters[ip] >= limit:
            ban_ip(ip)
            security_logger().info("blacklisted IP %s: too many failed auths", ip)
            conn.close()


def init_anti_ddos() -> None:
    """Wire the FSM-disallowed listener (ref: ddos.go:17-63).

    Auth results are routed through on_auth_result directly (our auth path
    knows the result), so only the FSM listener needs the event bus.
    """

    def _on_fsm_disallowed(data: events.FsmDisallowedData) -> None:
        conn = data.connection
        if conn.connection_type == ConnectionType.SERVER:
            return
        conn.fsm_disallowed_counter += 1
        limit = global_settings.max_fsm_disallowed
        if limit > 0 and conn.fsm_disallowed_counter >= limit:
            ban_pit(conn.pit)
            security_logger().info(
                "blacklisted PIT %s: too many FSM-disallowed messages", conn.pit
            )
            conn.close()

    events.fsm_disallowed.listen(_on_fsm_disallowed)


def check_unauth_conns_once() -> None:
    """Close + blacklist connections that never completed the FSM
    handshake within the auth window (ref: ddos.go:66-82; -auth-deadline,
    doc/edge_hardening.md). Each reap is double-entry counted
    (conn_reaped_total{reason=auth_timeout} == the core/edge.py ledger).
    Recovery-handle reconnects are exempt: a socket a live recovery
    handle has claimed is mid-resume — reaping (and worse, IP-banning)
    it would turn one transient disconnect into a permanent lockout."""
    timeout_s = global_settings.effective_auth_deadline_ms() / 1000.0
    if timeout_s <= 0:
        return
    now = time.monotonic()
    claimed = None  # built lazily: only a reap-candidate pays the scan
    for conn in list(_unauthenticated_connections.values()):
        if conn.is_closing():
            _unauthenticated_connections.pop(conn.id, None)
            continue
        if (
            conn.state == ConnectionState.UNAUTHENTICATED
            and now - conn.conn_time >= timeout_s
        ):
            if claimed is None:
                from .connection_recovery import _recover_handles

                claimed = {
                    h.new_conn for h in _recover_handles.values()
                    if h.new_conn is not None
                }
            if conn in claimed:
                continue
            ip = conn.remote_ip()
            if ip is not None:
                ban_ip(ip)
            conn.close()
            from .edge import ledgers as _edge_ledgers

            _edge_ledgers.count_reap("auth_timeout")
            security_logger().info(
                "closed and blacklisted unauthenticated connection from %s", ip
            )


async def unauth_reaper_loop() -> None:
    while True:
        check_unauth_conns_once()
        await asyncio.sleep(0.5)


def reset_ddos() -> None:
    """Test hook."""
    _failed_auth_counters.clear()
    _ip_blacklist.clear()
    _pit_blacklist.clear()
    _unauthenticated_connections.clear()
