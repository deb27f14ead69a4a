"""repro_torch.serve — the continuous-batching serving engine and the
multi-tenant front over one table store."""

from .engine import Request, ServeEngine
from .tenants import TenantFront, TenantSpec

__all__ = ["Request", "ServeEngine", "TenantFront", "TenantSpec"]
