"""repro_torch.configs — published and smoke configurations of the ported
architectures, and the shape profiles."""

from .base import (ARCH_IDS, SHAPES, ShapeProfile, apply_shape, get_config,
                   get_smoke_config, shape_skip_reason)

__all__ = ["ARCH_IDS", "SHAPES", "ShapeProfile", "apply_shape",
           "get_config", "get_smoke_config", "shape_skip_reason"]
