"""repro_torch.configs — published and smoke configurations of the ported
architectures."""

from .base import ARCH_IDS, get_config, get_smoke_config

__all__ = ["ARCH_IDS", "get_config", "get_smoke_config"]
