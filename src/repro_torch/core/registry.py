"""Compiled-table registry: the legacy façade over the table store.

Model configs reference activations by (naf, scheme, fwl) key; compiling
an FQA table takes seconds to minutes, so tables are cached under
``REPRO_TORCH_TABLE_CACHE`` (default: <repo>/artifacts/ppa_tables_torch).

The caching lives in :mod:`repro_torch.compiler.store` (content-addressed
memory + disk tiers); ``get_table`` and ``cache_dir`` are thin wrappers
over it, as in the JAX package.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Optional, Tuple

from .datapath import FWLConfig
from .schemes import PPAScheme, PPATable

__all__ = ["table_key", "get_table", "cache_dir", "DEFAULT_SCHEMES"]

# sensible default schemes per deployment precision (order/quantizer chosen
# from the paper's own conclusions: O2 for 16-bit out, Sm-O1 for 8-bit)
DEFAULT_SCHEMES = {
    8: (PPAScheme(order=1, m_shifters=4, quantizer="fqa"),
        FWLConfig(w_in=8, w_out=8, w_a=(8,), w_o=(8,), w_b=8)),
    16: (PPAScheme(order=2, quantizer="fqa"),
         FWLConfig(w_in=8, w_out=16, w_a=(8, 16), w_o=(16, 16), w_b=16)),
}


def cache_dir() -> Path:
    from ..compiler import cache_dir as _cache_dir
    return _cache_dir()


def table_key(naf: str, cfg: FWLConfig, scheme: PPAScheme,
              mae_t: Optional[float], interval: Optional[Tuple[float, float]]
              ) -> str:
    """Legacy (v2) addressing, kept for external references; the store keys
    on the full compile request (see repro_torch.compiler.CompileJob.key)."""
    blob = json.dumps({
        "naf": naf, "cfg": cfg.as_dict(),
        "scheme": [scheme.order, scheme.m_shifters, scheme.quantizer,
                   scheme.weight, scheme.segmenter],
        "mae_t": mae_t, "interval": interval, "v": 2,
    }, sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def get_table(naf: str, cfg: FWLConfig, scheme: PPAScheme = PPAScheme(),
              *, mae_t: Optional[float] = None,
              interval: Optional[Tuple[float, float]] = None,
              use_cache: bool = True) -> PPATable:
    from ..compiler import compile_table, default_store
    if not use_cache:
        return compile_table(naf, cfg, scheme, mae_t=mae_t, interval=interval)
    return default_store().compile_or_load(naf, cfg, scheme, mae_t=mae_t,
                                           interval=interval)
