"""Cross-gateway federation plane (doc/federation.md).

The reference's distributed story is "N independent nodes" — gateways
scale only by splitting disjoint client populations, so the seamless
open world ends at one gateway's grid (scripts/federation_bench.py
documents the gap). This package shards the *world itself* across
gateway processes, CheetahGIS-style distributed spatial partitioning
with Spider-style transactional cross-node migration (PAPERS.md):

- :mod:`directory` — the shard directory: which gateway hosts which
  spatial cells, loaded from config and updatable at runtime.
- :mod:`trunk` — authenticated gateway<->gateway trunk links reusing
  the wire framing, with heartbeats, reconnect backoff and chaos hooks
  on egress.
- :mod:`plane` — the federation plane: cross-gateway handover (the
  PR 3 transactional journal extended over the trunk, deterministic
  abort back to the source gateway on trunk loss or remote refusal)
  and client redirect with pre-staged recovery handles.
- :mod:`control` — the global control plane (doc/global_control.md):
  fleet-level shard rebalancing (leader-planned per-cell migrations
  between gateways through the trunked handover machinery) and
  gateway-death failover (epoch-replicated shard state adopted by a
  surviving gateway, journal replay source-wins, staged handles
  re-staged so clients resume without re-auth).

Everything is disarmed (cheap no-ops at every hook site) until
``init_federation`` runs with a config.
"""

from .control import GlobalControlPlane, control, reset_global_control
from .directory import ShardDirectory, directory
from .plane import FederationPlane, init_federation, plane, reset_federation
from .trunk import TrunkLink, backoff_schedule

__all__ = [
    "FederationPlane",
    "GlobalControlPlane",
    "ShardDirectory",
    "TrunkLink",
    "backoff_schedule",
    "control",
    "directory",
    "init_federation",
    "plane",
    "reset_federation",
    "reset_global_control",
]
