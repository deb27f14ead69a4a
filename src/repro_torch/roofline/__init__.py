"""repro_torch.roofline — the 3-term roofline of a step on the H100, from
the costs an ``OpCosts`` dispatch mode counts over it, and the PPA
kernels' bounds."""

from .analysis import (HW_H100, Roofline, active_params, analyze_costs,
                       model_flops)
from .op_costs import OpCosts, report_kernel

__all__ = ["HW_H100", "Roofline", "active_params", "analyze_costs",
           "model_flops", "OpCosts", "report_kernel"]
