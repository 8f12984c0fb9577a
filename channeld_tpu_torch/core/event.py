"""Typed in-process event bus.

Capability parity with the reference event system
(ref: pkg/channeld/event.go:40-96): Listen / ListenOnce / ListenFor /
UnlistenFor / Wait / Broadcast, plus the set of global events declared
in event.go:10-31. Handlers run synchronously in broadcast order;
``wait()`` integrates with asyncio.
"""

from __future__ import annotations

import asyncio
from typing import Any, Callable, Generic, Optional, TypeVar

T = TypeVar("T")


class Event(Generic[T]):
    def __init__(self, name: str = ""):
        self.name = name
        # list of (owner, handler, once)
        self._handlers: list[tuple[Any, Callable[[T], None], bool]] = []
        self._waiters: list[asyncio.Future] = []

    def listen(self, handler: Callable[[T], None]) -> Callable[[T], None]:
        self._handlers.append((None, handler, False))
        return handler

    def listen_once(self, handler: Callable[[T], None]) -> None:
        self._handlers.append((None, handler, True))

    def listen_for(self, owner: Any, handler: Callable[[T], None]) -> None:
        self._handlers.append((owner, handler, False))

    def unlisten(self, handler: Callable[[T], None]) -> None:
        self._handlers = [h for h in self._handlers if h[1] is not handler]

    def unlisten_for(self, owner: Any) -> None:
        self._handlers = [h for h in self._handlers if h[0] is not owner]

    def broadcast(self, data: T) -> None:
        # Snapshot so handlers may (un)register during the broadcast; only
        # once-handlers that actually fired are pruned.
        fired = list(self._handlers)
        for owner, handler, once in fired:
            handler(data)
        fired_once = {id(h) for h in fired if h[2]}
        self._handlers = [h for h in self._handlers if id(h) not in fired_once]
        waiters, self._waiters = self._waiters, []
        for fut in waiters:
            if not fut.done():
                fut.set_result(data)

    async def wait(self, timeout: Optional[float] = None) -> T:
        """Await the next broadcast of this event."""
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._waiters.append(fut)
        if timeout is None:
            return await fut
        return await asyncio.wait_for(fut, timeout)

    def handler_count(self) -> int:
        return len(self._handlers)
