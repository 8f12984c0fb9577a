"""Shard directory: cell -> gateway routing for a federated world.

One JSON config is shared verbatim by every gateway in the federation
(each passes its own id via ``-fed-id``):

.. code-block:: json

    {
      "secret": "trunk-shared-secret",
      "gateways": {
        "a": {"trunk": "127.0.0.1:15101", "client": "127.0.0.1:15001",
               "servers": [0]},
        "b": {"trunk": "127.0.0.1:15102", "client": "127.0.0.1:15002",
               "servers": [1]}
      }
    }

``servers`` lists the spatial-server indices (the same index space as
``SpatialRegion.serverIndex``, spatial/grid.py get_regions) whose
authority blocks the gateway hosts. The static cell -> server-index
mapping is geometric, so the directory answers ``gateway_of_cell`` by
asking the controller for the cell's server index (resolver attached at
``init_federation``) and looking the index up — except for cells with a
runtime override (``TrunkDirectoryUpdateMessage``), which win.
"""

from __future__ import annotations

import json
from typing import Callable, Optional

from ..utils.logger import get_logger

logger = get_logger("federation.directory")


class ShardDirectory:
    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.local_id: str = ""
        self.secret: str = ""
        self.gateways: dict[str, dict] = {}
        self._server_map: dict[int, str] = {}  # server index -> gateway id
        self._overrides: dict[int, str] = {}  # cell channel id -> gateway id
        self._override_version = 0
        self._resolver: Optional[Callable[[int], Optional[int]]] = None

    @property
    def active(self) -> bool:
        return bool(self.local_id and self.gateways)

    # ---- config ----------------------------------------------------------

    def load(self, path: str, local_id: str) -> None:
        with open(path) as f:
            cfg = json.load(f)
        self.load_dict(cfg, local_id)

    def load_dict(self, cfg: dict, local_id: str) -> None:
        gateways = cfg.get("gateways", {})
        if local_id not in gateways:
            raise ValueError(
                f"gateway id {local_id!r} not in federation config "
                f"(has {sorted(gateways)})"
            )
        self.local_id = local_id
        self.secret = cfg.get("secret", "")
        self.gateways = gateways
        self._server_map = {}
        for gw_id, g in gateways.items():
            for idx in g.get("servers", []):
                prev = self._server_map.get(int(idx))
                if prev is not None and prev != gw_id:
                    raise ValueError(
                        f"server index {idx} claimed by both {prev!r} "
                        f"and {gw_id!r}"
                    )
                self._server_map[int(idx)] = gw_id
        self._overrides = {}
        self._override_version = 0

    def attach_resolver(self, fn: Callable[[int], Optional[int]]) -> None:
        """``fn(cell_channel_id) -> server index`` (the controller's
        geometric mapping); None for ids outside the grid."""
        self._resolver = fn

    # ---- queries (hot path: one dict hit + arithmetic) -------------------

    def gateway_of_cell(self, cell_channel_id: int) -> Optional[str]:
        gw = self._overrides.get(cell_channel_id)
        if gw is not None:
            return gw
        if self._resolver is None:
            return None
        try:
            idx = self._resolver(cell_channel_id)
        except ValueError:
            return None  # outside the grid: nobody's (treated local)
        if idx is None:
            return None
        return self._server_map.get(idx)

    def is_local_cell(self, cell_channel_id: int) -> bool:
        gw = self.gateway_of_cell(cell_channel_id)
        # Unmapped cells count as local: a world without full directory
        # coverage degrades to pre-federation behavior, never to a
        # handover aimed at nobody.
        return gw is None or gw == self.local_id

    def local_server_indices(self) -> list[int]:
        return sorted(
            idx for idx, gw in self._server_map.items() if gw == self.local_id
        )

    def peers(self) -> list[str]:
        return sorted(g for g in self.gateways if g != self.local_id)

    def trunk_addr(self, gateway_id: str) -> Optional[str]:
        g = self.gateways.get(gateway_id)
        return g.get("trunk") if g else None

    def client_addr(self, gateway_id: str) -> Optional[str]:
        g = self.gateways.get(gateway_id)
        return g.get("client") if g else None

    # ---- runtime updates -------------------------------------------------

    def apply_update(self, overrides: dict[int, str], version: int) -> bool:
        """Apply a TrunkDirectoryUpdateMessage (or an operator call).
        Returns False for stale versions (monotonicity guard)."""
        if version <= self._override_version:
            logger.warning(
                "stale directory update v%d ignored (at v%d)",
                version, self._override_version,
            )
            return False
        self._override_version = version
        self._overrides.update(overrides)
        self._wal_log()
        logger.info(
            "directory updated to v%d: %d cell overrides active",
            version, len(self._overrides),
        )
        return True

    def _wal_log(self) -> None:
        """Directory versions are durable (doc/persistence.md): a
        crash-restarted gateway must not boot believing a pre-override
        shard map — its resurrection hello carries this version."""
        from ..core.wal import wal

        if wal.enabled:
            wal.log_directory(self._override_version, self._overrides)

    def replace_update(self, overrides: dict[int, str],
                       version: int) -> Optional[dict[int, str]]:
        """Full-map anti-entropy sync from the leader (partition heal):
        REPLACES the override map, so overrides minted by a partitioned
        concurrent leader are dropped rather than merely out-versioned.
        Returns the {cell: now-authoritative gateway} map of every cell
        whose mapping changed (for the control plane's cell lifecycle),
        or None for stale versions."""
        if version <= self._override_version:
            logger.warning(
                "stale directory replace v%d ignored (at v%d)",
                version, self._override_version,
            )
            return None
        old = self._overrides
        self._override_version = version
        self._overrides = dict(overrides)
        self._wal_log()
        changed: dict[int, str] = {}
        for cid in set(old) | set(overrides):
            if old.get(cid) != overrides.get(cid):
                gw = self.gateway_of_cell(cid)
                if gw is not None:
                    changed[cid] = gw
        logger.info(
            "directory replaced at v%d: %d cell overrides active, "
            "%d mappings changed", version, len(self._overrides),
            len(changed),
        )
        return changed

    @property
    def override_version(self) -> int:
        return self._override_version

    def overrides(self) -> dict[int, str]:
        """Copy of the active per-cell overrides (the control plane's
        directory re-sync to a returned gateway sends these verbatim)."""
        return dict(self._overrides)

    def server_index_of(self, cell_channel_id: int) -> Optional[int]:
        """The cell's geometric server index via the attached resolver;
        None outside the grid or before a resolver is attached."""
        if self._resolver is None:
            return None
        try:
            return self._resolver(cell_channel_id)
        except ValueError:
            return None

    def report(self) -> dict:
        return {
            "local_id": self.local_id,
            "gateways": sorted(self.gateways),
            "server_map": {str(k): v for k, v in sorted(self._server_map.items())},
            "overrides": {str(k): v for k, v in sorted(self._overrides.items())},
            "override_version": self._override_version,
        }


# The process-wide directory; grid.py consults it on every crossing
# whose dst might be remote (one attribute load when federation is off).
directory = ShardDirectory()
