"""repro_torch.configs — published and smoke configurations of the ported
architectures, the shape profiles and the mesh padding."""

from .base import (ARCH_IDS, SHAPES, ShapeProfile, apply_shape, get_config,
                   get_smoke_config, resolve_for_mesh, shape_skip_reason)

__all__ = ["ARCH_IDS", "SHAPES", "ShapeProfile", "apply_shape",
           "get_config", "get_smoke_config", "resolve_for_mesh",
           "shape_skip_reason"]
