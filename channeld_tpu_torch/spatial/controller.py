"""SpatialController: the pluggable spatial-partition boundary.

Capability parity with the reference (ref: pkg/channeld/spatial.go:17-74).
One process-wide controller instance is selected from a JSON config; the
static-grid host implementation lives in ``grid.py`` and the TPU-backed
implementation in ``tpu_controller.py`` — both plug in behind this seam
without touching the protocol path.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable, Optional, Protocol

from ..utils.logger import get_logger

logger = get_logger("spatial")


@dataclass
class SpatialInfo:
    """World position, left-handed Y-up (ref: channeld.proto SpatialInfo)."""

    x: float = 0.0
    y: float = 0.0
    z: float = 0.0


HandoverDataProvider = Callable[[int, int], Optional[dict]]
# (src_channel_id, dst_channel_id) -> {entityId: data message}


class SpatialController(Protocol):
    """(ref: spatial.go:17-35)."""

    def load_config(self, config: dict) -> None: ...
    def get_channel_id(self, info: SpatialInfo) -> int: ...
    def get_regions(self) -> list: ...
    def get_adjacent_channels(self, channel_id: int) -> list[int]: ...
    def query_channel_ids(self, query) -> dict[int, int]: ...
    def get_channel_id_with_offset(self, info: SpatialInfo, dx: float, dy: float, dz: float) -> int: ...
    def create_channels(self, ctx) -> list: ...
    def tick(self) -> None: ...
    def notify(self, old_info: SpatialInfo, new_info: SpatialInfo, handover_data_provider) -> None: ...


_spatial_controller: Optional[SpatialController] = None

# Name -> class, for config-selected controllers
# (ref: spatial.go:65-69 type switch on SpatialControllerType).
_controller_registry: dict[str, type] = {}


def register_spatial_controller_type(name: str, cls: type) -> None:
    _controller_registry[name] = cls


def get_spatial_controller() -> Optional[SpatialController]:
    return _spatial_controller


def set_spatial_controller(controller: Optional[SpatialController]) -> None:
    global _spatial_controller
    _spatial_controller = controller


def init_spatial_controller(config_path: Optional[str] = None) -> None:
    """Load the controller named in the config JSON
    (ref: spatial.go:40-74). No config -> no spatial features."""
    global _spatial_controller
    if config_path is None:
        from ..core.settings import global_settings

        config_path = global_settings.spatial_controller_config
    if not config_path:
        return
    with open(config_path) as f:
        spec = json.load(f)
    type_name = spec.get("SpatialControllerType", "")
    cls = _controller_registry.get(type_name)
    if cls is None:
        raise ValueError(f"unknown SpatialControllerType: {type_name}")
    controller = cls()
    controller.load_config(spec.get("Config", {}))
    _spatial_controller = controller
    logger.info("initialized spatial controller %s", type_name)


def reset_spatial_controller() -> None:
    """Test hook."""
    global _spatial_controller
    _spatial_controller = None
