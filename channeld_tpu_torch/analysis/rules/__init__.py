"""tpulint rule registry (doc/analysis.md#adding-a-rule)."""

from .accounting import DoubleEntryRule
from .affinity import (
    FenceDisciplineRule,
    LiveIterRule,
    OffLoopAsyncioRule,
    SharedStateRule,
    ThreadModelRule,
)
from .async_blocking import AsyncBlockingRule
from .excepts import ExceptHygieneRule
from .proto_drift import ProtoDriftRule
from .readback import HotPathReadbackRule
from .units import HistogramUnitsRule

ALL_RULES = (
    ProtoDriftRule,
    AsyncBlockingRule,
    HotPathReadbackRule,
    DoubleEntryRule,
    ExceptHygieneRule,
    HistogramUnitsRule,
    ThreadModelRule,
    SharedStateRule,
    OffLoopAsyncioRule,
    FenceDisciplineRule,
    LiveIterRule,
)


def make_rules(names: list[str] | None = None):
    rules = [cls() for cls in ALL_RULES]
    if names:
        wanted = set(names)
        unknown = wanted - {r.name for r in rules}
        if unknown:
            raise ValueError(f"unknown rule(s): {sorted(unknown)}")
        rules = [r for r in rules if r.name in wanted]
    return rules
