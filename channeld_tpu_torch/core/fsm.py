"""Per-connection finite-state-machine message filter.

Capability parity with the reference FSM (ref: pkg/fsm/fsm.go:13-171):
JSON-defined states carrying msg-type whitelists/blacklists written as
range specs ("1", "2-65535"), optional msg-type-triggered transitions,
and sequential ``move_to_next_state``. Each connection gets its own
copy (ref: pkg/channeld/connection.go:317-330) so transition state is
per-connection.

The reference JSON schema is accepted verbatim so existing
``*_fsm.json`` configs keep working:

    {"States": [{"Name": ..., "MsgTypeWhitelist": "1",
                 "MsgTypeBlacklist": ""}],
     "InitState": "INIT",
     "Transitions": [{"FromState": ..., "ToState": ..., "MsgType": 2}]}
"""

from __future__ import annotations

import copy
import json
from dataclasses import dataclass, field
from typing import Optional

from ..utils.ranges import RangeSet

# First user-space message type (ref: channeld.pb USER_SPACE_START);
# kept as a local constant so the FSM stays importable on its own.
USER_SPACE_START = 100


@dataclass
class FsmState:
    name: str
    allowed: RangeSet = field(default_factory=RangeSet)
    blocked: RangeSet = field(default_factory=RangeSet)
    # msg_type -> verdict memo. The range sets are immutable after load
    # and states are shared across per-connection clones, so one warm
    # cache serves every connection (two bisect walks per message
    # otherwise dominate the FSM's share of the receive path).
    _memo: dict = field(default_factory=dict, repr=False, compare=False)

    def is_allowed(self, msg_type: int) -> bool:
        v = self._memo.get(msg_type)
        if v is None:
            v = self._memo[msg_type] = (
                msg_type in self.allowed and msg_type not in self.blocked
            )
        return v


class MessageFsm:
    def __init__(
        self,
        states: list[FsmState],
        transitions: dict[tuple[str, int], str],
        init_state: Optional[str] = None,
    ):
        if not states:
            raise ValueError("FSM needs at least one state")
        self.states = states
        self._by_name = {s.name: s for s in states}
        self.transitions = transitions
        # Per-state transition table (msg_type -> target name): saves the
        # per-message (name, msg_type) tuple build in on_received.
        self._state_transitions: list[dict[int, str]] = [
            {mt: to for (frm, mt), to in transitions.items() if frm == s.name}
            for s in states
        ]
        # Whether any transition out of each state is triggered by a
        # user-space msgType; gates the batched-ingest fast path.
        self._state_user_transitions: list[bool] = [
            any(mt >= USER_SPACE_START for mt in table)
            for table in self._state_transitions
        ]
        self._init_index = 0
        if init_state is not None:
            if init_state not in self._by_name:
                raise KeyError(f"unknown InitState: {init_state}")
            self._init_index = states.index(self._by_name[init_state])
        self._current_index = self._init_index

    # ---- construction -------------------------------------------------

    @classmethod
    def from_dict(cls, spec: dict) -> "MessageFsm":
        states = [
            FsmState(
                name=s["Name"],
                allowed=RangeSet.parse(s.get("MsgTypeWhitelist", "")),
                blocked=RangeSet.parse(s.get("MsgTypeBlacklist", "")),
            )
            for s in spec.get("States", [])
        ]
        transitions = {
            (t["FromState"], int(t["MsgType"])): t["ToState"]
            for t in spec.get("Transitions", [])
        }
        return cls(states, transitions, init_state=spec.get("InitState"))

    @classmethod
    def load(cls, path: str) -> "MessageFsm":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def clone(self) -> "MessageFsm":
        """Fresh per-connection copy with state reset to the init state."""
        fsm = copy.copy(self)
        fsm._current_index = self._init_index
        return fsm

    # ---- runtime ------------------------------------------------------

    @property
    def current(self) -> FsmState:
        return self.states[self._current_index]

    def is_allowed(self, msg_type: int) -> bool:
        return self.current.is_allowed(msg_type)

    def on_received(self, msg_type: int) -> None:
        """Apply a msg-type-triggered transition, if one is defined."""
        table = self._state_transitions[self._current_index]
        if table:
            target = table.get(msg_type)
            if target is not None:
                self._move_to(target)

    def user_space_fast(self, msg_types) -> bool:
        """True when every msgType in ``msg_types`` is allowed in the
        current state and none can trigger a transition — the batched
        ingest path may then skip per-message FSM work (the per-message
        outcome would be: allowed, no state change)."""
        if self._state_user_transitions[self._current_index]:
            return False
        is_allowed = self.states[self._current_index].is_allowed
        for mt in msg_types:
            if not is_allowed(mt):
                return False
        return True

    def move_to_next_state(self) -> bool:
        """Advance to the next state in declaration order (auth success path)."""
        if self._current_index + 1 < len(self.states):
            self._current_index += 1
            return True
        return False

    def _move_to(self, name: str) -> None:
        state = self._by_name.get(name)
        if state is None:
            raise KeyError(f"unknown FSM state: {name}")
        self._current_index = self.states.index(state)
