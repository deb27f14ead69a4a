"""repro_torch.core — the FQA compile path and the table artifact: the
fixed-point datapath, the NAF zoo, Remez fitting, the full-space candidate
scan on numpy or torch (:mod:`.searchspace`), the quantizers, TBW and the
other segmenters, the schemes and the hardware-constrained workflow."""

from .datapath import (DatapathPlan, FWLConfig, apply_shift, concat_add,
                       horner_body, horner_fixed)
from .fixed_point import (from_fixed, grid_for_interval, hamming_weight,
                          min_signed_digits, round_half_away, signed_bits,
                          to_fixed, trunc_shift)
from .functions import NAF_REGISTRY, NAFSpec, exact, get_naf
from .quantize import (FQAQuantizer, MLPLACQuantizer, PLACQuantizer,
                       QPAQuantizer, Quantizer, SegmentFit, make_quantizer)
from .registry import DEFAULT_SCHEMES, get_table
from .remez import fit_minimax, fit_minimax_batch, horner
from .schemes import (PPAScheme, PPATable, compile_ppa_table, eval_table_int,
                      table_mae_report)
from .searchspace import (SEARCH_BACKENDS, NumpySearchBackend, SearchBackend,
                          SegmentContext, TorchSearchBackend, resolve_backend)
from .segmentation import (Segment, SegmentEvaluator, bisection_segment,
                           estimate_tseg, nonuniform_segment,
                           sequential_segment, tbw_segment)
from .workflow import WorkflowResult, hardware_constrained_ppa

__all__ = [
    "DatapathPlan", "FWLConfig", "apply_shift", "concat_add", "horner_body",
    "horner_fixed",
    "from_fixed", "grid_for_interval", "hamming_weight", "min_signed_digits",
    "round_half_away", "signed_bits", "to_fixed", "trunc_shift",
    "NAF_REGISTRY", "NAFSpec", "exact", "get_naf",
    "FQAQuantizer", "MLPLACQuantizer", "PLACQuantizer", "QPAQuantizer",
    "Quantizer", "SegmentFit", "make_quantizer",
    "DEFAULT_SCHEMES", "get_table",
    "fit_minimax", "fit_minimax_batch", "horner",
    "PPAScheme", "PPATable", "compile_ppa_table", "eval_table_int",
    "table_mae_report",
    "SEARCH_BACKENDS", "NumpySearchBackend", "SearchBackend",
    "SegmentContext", "TorchSearchBackend", "resolve_backend",
    "Segment", "SegmentEvaluator", "bisection_segment", "estimate_tseg",
    "nonuniform_segment", "sequential_segment", "tbw_segment",
    "WorkflowResult", "hardware_constrained_ppa",
]
