"""The numbers the check compares, and their limits.

Training (the first ``check_steps`` steps, program against reference):

  loss_gap     the widest relative gap of a step's loss
  grad_gap     the widest gap, over leaves, between the norms of the
               clipped first gradient, over the reference's norm of that
               leaf or of the median leaf, whichever is larger
  change_gap   the same for the norm of each leaf's change over the steps,
               leaving out leaves whose reference gradient is under a
               thousandth of the median leaf's (they move by round-off)

Serving: ``served_gap``, the widest gap by which a served token's logit
lies below the reference's best at its position, over a sample of the
requests the window finished.

A number passes when it is at most its limit; a missing or non-finite
number fails.  ``left_out`` counts the leaves the change leaves out; it
has no limit.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

__all__ = ["train_numbers", "judge"]


def _norm_gap(prog: Dict[str, float], ref: Dict[str, float],
              keep: List[str]) -> float:
    med = statistics.median(ref[k] for k in keep)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in keep)


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    leaves = sorted(ref["grad_norm"])
    med = statistics.median(ref["grad_norm"][k] for k in leaves)
    moving = [k for k in leaves if ref["grad_norm"][k] >= 1e-3 * med]
    return {"loss_gap": loss,
            "grad_gap": _norm_gap(prog["grad_norm"], ref["grad_norm"],
                                  leaves),
            "change_gap": _norm_gap(prog["change_norm"], ref["change_norm"],
                                    moving),
            "left_out": float(len(leaves) - len(moving))}


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {"value", "limit"}}) over every limited number."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        out[name] = {"value": v, "limit": limit}
    return ok, out
