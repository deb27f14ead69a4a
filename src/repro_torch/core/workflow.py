"""Hardware-constrained PPA workflow (paper Fig. 7).

For post-fabrication reconfigurable hardware the segment capacity SEG_t is
silicon-fixed; the goal flips from "min segments at MAE_t" to "min MAE at
SEG_t".  Because FQA yields the optimal MAE for any given segmentation, a
binary search over MAE_t terminates once SEG_hard == SEG_t (or the search
window shrinks below eps).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .datapath import FWLConfig
from .fixed_point import grid_for_interval, round_half_away
from .functions import get_naf
from .schemes import PPAScheme, PPATable, compile_ppa_table

__all__ = ["hardware_constrained_ppa", "WorkflowResult"]


@dataclasses.dataclass
class WorkflowResult:
    table: PPATable
    seg_t: int
    iterations: int
    mae_t_path: list


def hardware_constrained_ppa(
    naf: str,
    cfg: FWLConfig,
    scheme: PPAScheme,
    seg_t: int,
    *,
    eps: float = 1e-9,
    max_iter: int = 40,
    interval: Optional[Tuple[float, float]] = None,
    session=None,
    search_backend=None,
) -> WorkflowResult:
    """Maximize precision under a fixed hardware segment budget.

    Returns the lowest-MAE table with num_segments <= seg_t found by the
    Fig. 7 flow.  The quantization floor MAE_q lower-bounds the search.

    All binary-search iterations compile on one shared
    :class:`repro_torch.compiler.CompilerSession`: every window fit is a MAE_t-
    independent fact, so iteration k answers most of iteration k+1's probes
    from the interval cache instead of re-running the quantizer.
    ``search_backend`` (a name or a backend instance) is where the
    candidate scans run; it never changes the table.
    """
    from ..compiler import CompilerSession
    spec = get_naf(naf)
    interval = interval or spec.interval
    session = session or CompilerSession()
    x_int = grid_for_interval(interval[0], interval[1], cfg.w_in)
    f = spec(x_int.astype(np.float64) / (1 << cfg.w_in))
    f_q = round_half_away(f * (1 << cfg.w_out)) / (1 << cfg.w_out)
    mae_q = float(np.abs(f_q - f).max())

    lo = mae_q                      # unachievable-below floor
    hi = float(np.ptp(f)) / 2 + mae_q  # one segment always works here
    best: Optional[PPATable] = None
    path = []
    it = 0
    for it in range(1, max_iter + 1):
        mid = 0.5 * (lo + hi)
        try:
            tab = compile_ppa_table(naf, cfg, scheme, mae_t=mid,
                                    interval=interval, tseg=seg_t,
                                    session=session,
                                    search_backend=search_backend)
            segs = tab.num_segments
        except RuntimeError:
            segs = None  # infeasible at this MAE_t
        path.append((mid, segs))
        if segs is not None and segs <= seg_t:
            if best is None or tab.mae_hard < best.mae_hard:
                best = tab
            if segs == seg_t and (hi - lo) < eps:
                break
            hi = mid                # try a tighter target
        else:
            lo = mid                # too tight: need more segments
        if hi - lo < eps:
            break
    if best is None:
        raise RuntimeError(
            f"no table with <= {seg_t} segments found for {naf} / {cfg}")
    return WorkflowResult(table=best, seg_t=seg_t, iterations=it,
                          mae_t_path=path)
