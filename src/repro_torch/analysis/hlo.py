"""The dry run's audit: the top memory and collective contributors of one
cell.

Counterpart of ``repro/analysis/hlo.py`` (``python -m repro_torch.analysis
--hlo <arch> <shape> ...``), with its columns and report format.  The
reference ranks the ops of the compiled HLO text; eager PyTorch compiles
none, so here the rows are what ``OpCosts`` counted over the cell's step
on the fake mesh (``launch/dryrun.py::count_cell``), one row a (kind,
where): ``kind`` the aten op or the reporting kernel (memory rows) or the
collective under the reference's names (collective rows), ``tag`` the
function of the port that ran it, ``x`` its calls and ``gib`` its bytes.
The memory rows add up to the cell's counted bytes.
"""

from __future__ import annotations

from typing import List, Tuple

from .report import render

__all__ = ["audit_cell", "main"]


def audit_cell(arch: str, shape: str, variant: str = "baseline",
               multi_pod: bool = False) -> Tuple[list, list]:
    """Count one dry-run cell and rank its memory / collective rows.

    Returns ``(mem_rows, coll_rows)``: lists of dicts sorted by bytes,
    largest first (``gib`` the bytes over all ``x`` calls)."""
    from ..launch.dryrun import count_cell
    costs, _meta, _mem = count_cell(arch, shape, multi_pod, variant,
                                    where=True)
    mem_rows, coll_rows = [], []
    for (coll, kind, tag), (nbytes, calls) in costs.rows.items():
        row = {"gib": nbytes / 2**30, "x": calls, "kind": kind, "tag": tag}
        (coll_rows if coll else mem_rows).append(row)
    mem_rows.sort(key=lambda r: r["gib"], reverse=True)
    coll_rows.sort(key=lambda r: r["gib"], reverse=True)
    return mem_rows, coll_rows


def main(argv: List[str], *, json_mode: bool = False) -> int:
    if len(argv) < 2:
        print("usage: python -m repro_torch.analysis --hlo <arch> <shape> "
              "[variant] [--multi-pod]")
        return 2
    arch, shape = argv[0], argv[1]
    variant = (argv[2] if len(argv) > 2 and not argv[2].startswith("--")
               else "baseline")
    multi = "--multi-pod" in argv
    mem, coll = audit_cell(arch, shape, variant, multi)
    pod = "multipod" if multi else "pod"
    for r in mem + coll:
        r["gib"] = f"{r['gib']:.3f}"
    render(f"hlo memory: {arch} x {shape} x {variant} ({pod})",
           mem[:14], ("gib", "x", "kind", "tag"), json_mode=json_mode)
    render(f"hlo collectives: {arch} x {shape} x {variant} ({pod})",
           coll[:10], ("gib", "x", "kind", "tag"), json_mode=json_mode)
    return 0
