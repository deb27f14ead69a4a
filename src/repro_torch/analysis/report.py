"""One report format for every analysis engine (lint / certify).

A copy of the JAX package's ``analysis/report.py``.  Each engine produces
a list of row dicts; :func:`render` prints them as an aligned text table
or a JSON document (``--json``), so CI logs and tooling consume a single
shape regardless of which engine ran.
"""

from __future__ import annotations

import json
import sys
from typing import Mapping, Sequence

__all__ = ["render"]


def render(section: str, rows: Sequence[Mapping], columns: Sequence[str],
           *, json_mode: bool = False, out=None) -> None:
    """Print ``rows`` (dicts) under a section header.

    ``columns`` picks and orders the fields; missing fields render empty.
    In JSON mode emits ``{"section": ..., "rows": [...]}`` on one line so
    multiple sections concatenate into a JSON-lines stream.
    """
    out = out or sys.stdout
    if json_mode:
        print(json.dumps({"section": section, "rows": list(rows)},
                         sort_keys=True, default=str), file=out)
        return
    print(f"\n=== {section} ===", file=out)
    if not rows:
        print("(none)", file=out)
        return
    table = [[str(r.get(c, "")) for c in columns] for r in rows]
    widths = [max(len(c), *(len(row[i]) for row in table))
              for i, c in enumerate(columns)]
    print("  ".join(c.ljust(w) for c, w in zip(columns, widths)), file=out)
    for row in table:
        print("  ".join(v.ljust(w) for v, w in zip(row, widths)), file=out)
