"""repro_torch.core — the fixed-point datapath, the deployment NAFs and the
table artifact, with no framework beyond numpy (and torch for the exact
NAF functions)."""

from .datapath import DatapathPlan, FWLConfig, apply_shift, horner_body
from .functions import NAF_SPECS, NAFSpec, exact, get_naf
from .schemes import PPAScheme, PPATable, eval_table_int

__all__ = ["DatapathPlan", "FWLConfig", "NAFSpec", "NAF_SPECS", "PPAScheme",
           "PPATable", "apply_shift", "eval_table_int", "exact", "get_naf",
           "horner_body"]
