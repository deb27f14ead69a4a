"""The PPA tables a served model deploys, shipped as JSON data.

One file per (NAF, output bit-width): ``<naf>-<bits>.json`` in the
``PPATable.to_json`` field set of the FQA compiler.  16-bit tables are the
FQA-O2 point (W_i=8, W_a=(8,16), W_o=(16,16), W_b=16), 8-bit tables the
FQA-S4-O1 point.  They are regenerated from the compiler by running
``tests/test_torch_tables.py`` as a script, and that test holds them equal
to a fresh compile.
"""

from __future__ import annotations

import functools
from pathlib import Path

from ..core.schemes import PPATable

__all__ = ["TABLE_DIR", "BITS", "NAFS", "load_table", "table_path"]

TABLE_DIR = Path(__file__).resolve().parent
BITS = (16, 8)
#: the NAF set of every deployment: gates, softmax exp2, SSM/RWKV decays
NAFS = ("sigmoid_wide", "tanh_wide", "gelu_inner", "softplus", "exp_neg",
        "exp2_frac")


def table_path(naf: str, bits: int) -> Path:
    if naf not in NAFS or bits not in BITS:
        raise ValueError(f"no shipped table for ({naf!r}, {bits}); "
                         f"NAFs {NAFS}, bits {BITS}")
    return TABLE_DIR / f"{naf}-{bits}.json"


@functools.lru_cache(maxsize=None)
def load_table(naf: str, bits: int) -> PPATable:
    """The shipped table for ``naf`` at ``bits`` output bits."""
    return PPATable.from_json(table_path(naf, bits).read_text())
