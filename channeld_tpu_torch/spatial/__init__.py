"""Spatial layer: grid partitioning, AOI queries, entity channels, handover.

Reference counterpart: pkg/channeld/spatial.go, message_spatial.go, entity.go.
The decision-heavy paths (cell assignment, AOI masks, handover detection)
also have batched device implementations in channeld_tpu_torch.ops, served
by GPUSpatialController.
"""

from .controller import (
    SpatialController,
    SpatialInfo,
    get_spatial_controller,
    init_spatial_controller,
    register_spatial_controller_type,
    set_spatial_controller,
)
from .entity import EntityGroup, FlatEntityGroupController
from .grid import StaticGrid2DSpatialController
from .gpu_controller import GPUSpatialController

__all__ = [
    "SpatialController",
    "SpatialInfo",
    "get_spatial_controller",
    "init_spatial_controller",
    "register_spatial_controller_type",
    "set_spatial_controller",
    "EntityGroup",
    "FlatEntityGroupController",
    "StaticGrid2DSpatialController",
    "GPUSpatialController",
]
