"""Authentication providers (ref: pkg/channeld/auth.go).

``do_auth`` may be sync or async; the AUTH handler awaits async providers
in a task so a slow backend never stalls the channel tick — the analog of
the reference's goroutine-per-auth.
"""

from __future__ import annotations

import inspect
from typing import Optional, Protocol

from ..protocol import control_pb2

AuthResult = control_pb2.AuthResultMessage.AuthResult


class AuthProvider(Protocol):
    def do_auth(self, conn_id: int, pit: str, login_token: str): ...


class LoggingAuthProvider:
    """Logs and accepts everyone (ref: auth.go:13-24)."""

    def __init__(self):
        from ..utils.logger import get_logger

        self.logger = get_logger("auth")

    def do_auth(self, conn_id: int, pit: str, login_token: str):
        self.logger.info("auth: connId=%d pit=%s", conn_id, pit)
        return AuthResult.SUCCESSFUL


class AlwaysFailAuthProvider:
    """(ref: auth.go:26-31)."""

    def do_auth(self, conn_id: int, pit: str, login_token: str):
        return AuthResult.INVALID_LT


class FixedPasswordAuthProvider:
    """(ref: auth.go:33-42)."""

    def __init__(self, password: str):
        self.password = password

    def do_auth(self, conn_id: int, pit: str, login_token: str):
        if login_token == self.password:
            return AuthResult.SUCCESSFUL
        return AuthResult.INVALID_LT


_auth_provider: Optional[AuthProvider] = None


def set_auth_provider(provider: Optional[AuthProvider]) -> None:
    global _auth_provider
    _auth_provider = provider


def get_auth_provider() -> Optional[AuthProvider]:
    return _auth_provider


async def run_auth(provider: AuthProvider, conn_id: int, pit: str, lt: str):
    result = provider.do_auth(conn_id, pit, lt)
    if inspect.isawaitable(result):
        result = await result
    return result
