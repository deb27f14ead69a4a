"""The paper's FWL design flow (Sec. III-C Steps 1-3).

A copy of the JAX package's ``core/fwl_search.py`` on the port's compiler.
Greedy per-unit FWL shrink: multipliers Mn -> M1 first (they dominate
area), then adders A1 -> An, fixing each FWL at the knee where the
coefficient LUT starts to grow.  The objective per the paper is "LUT
size"; stored LUT bits (segments x entry width, after coefficient
sharing) are used, optionally blended with the calibrated area model.
Every candidate compile's scan runs on ``search_backend`` (the card's
``TorchSearchBackend``, or the numpy golden backend), which changes no
table.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

from .datapath import FWLConfig
from .schemes import PPAScheme, PPATable, compile_ppa_table

__all__ = ["FWLSearchResult", "optimize_fwls"]


@dataclasses.dataclass
class FWLSearchResult:
    cfg: FWLConfig
    table: PPATable
    #: (step, cfg, segments, metric) of every candidate tried
    history: List[Tuple[str, FWLConfig, int, float]]


def _lut_metric(table: PPATable) -> float:
    cfg = table.cfg
    row_bits = sum(w + 2 for w in cfg.w_a) + (cfg.w_b + 2)
    return float(table.unique_lut_rows() * row_bits)


def optimize_fwls(
    naf: str,
    *,
    w_in: int,
    w_out: int,
    scheme: PPAScheme,
    mae_t: Optional[float] = None,
    metric: Callable[[PPATable], float] = _lut_metric,
    search_quantizer: str = "fqa_fast",
    min_fwl: int = 2,
    compile_kwargs: Optional[dict] = None,
    session=None,
    search_backend=None,
) -> FWLSearchResult:
    """Run the paper's Step 1-3 FWL flow and return the winning config.

    The shrink loop uses the cheaper ``fqa_fast`` search (base d-range);
    the final returned table is recompiled with the scheme's own quantizer.
    Every candidate compile runs on one shared
    :class:`repro_torch.compiler.CompilerSession`; window fits are FWL-
    config-dependent, so the savings come from *within* each candidate
    compile (warm-started probes, cached finalize fits).  ``search_backend``
    (a name or an instance; None: ``$REPRO_TORCH_SEARCH_BACKEND``, then
    numpy) is where every candidate scan runs.
    """
    from ..compiler import CompilerSession
    n = scheme.order
    compile_kwargs = dict(compile_kwargs or {})
    compile_kwargs.setdefault("search_backend", search_backend)
    session = session or CompilerSession()
    # Step 1: initialization
    big = max(w_in, w_out)
    cfg = FWLConfig(w_in=w_in, w_out=w_out,
                    w_a=tuple([big] * n), w_o=tuple([big] * (n - 1) + [w_out]),
                    w_b=w_out)
    search_scheme = dataclasses.replace(scheme, quantizer=search_quantizer)

    def compile_cfg(c: FWLConfig) -> PPATable:
        return compile_ppa_table(naf, c, search_scheme, mae_t=mae_t,
                                 session=session, **compile_kwargs)

    history: List[Tuple[str, FWLConfig, int, float]] = []
    table = compile_cfg(cfg)
    best_metric = metric(table)
    history.append(("init", cfg, table.num_segments, best_metric))

    def shrink(field: str, idx: Optional[int], step_name: str):
        nonlocal cfg, table, best_metric
        while True:
            if idx is None:
                cur = getattr(cfg, field)
                if cur <= min_fwl:
                    return
                new_cfg = cfg.replace(**{field: cur - 1})
            else:
                cur = getattr(cfg, field)[idx]
                if cur <= min_fwl:
                    return
                vals = list(getattr(cfg, field))
                vals[idx] = cur - 1
                new_cfg = cfg.replace(**{field: tuple(vals)})
            try:
                cand = compile_cfg(new_cfg)
            except RuntimeError:
                return  # MAE_t no longer reachable at this FWL
            m = metric(cand)
            history.append((step_name, new_cfg, cand.num_segments, m))
            if m > best_metric:  # LUT grew: fix the previous FWL
                return
            cfg, table, best_metric = new_cfg, cand, m

    # Step 2: multipliers Mn -> M1 (output FWLs, then the stage-1 coeff FWL)
    for i in range(n - 1, -1, -1):
        shrink("w_o", i, f"w_o[{i}]")
    shrink("w_a", 0, "w_a[0]")
    # Step 3: adders A1 -> An (coefficient FWLs of stages 2..n, then b)
    for i in range(1, n):
        shrink("w_a", i, f"w_a[{i}]")
    shrink("w_b", None, "w_b")

    # final compile with the real quantizer
    final = compile_ppa_table(naf, cfg, scheme, mae_t=mae_t, session=session,
                              **compile_kwargs)
    return FWLSearchResult(cfg=cfg, table=final, history=history)
