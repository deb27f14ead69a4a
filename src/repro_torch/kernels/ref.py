"""The plain PyTorch version of the integer PPA datapath.

``torch.searchsorted(starts, x, right=True) - 1``, clamped to ``[0, S-1]``,
then a row gather and the shared ``horner_body`` on int32 tensors: the
counterpart of ``repro/kernels/ref.py``, and what the ``cuda_int`` kernel
is held against.  Bit-identical to the numpy golden model
(``core.schemes.eval_table_int``).
"""

from __future__ import annotations

import torch

from ..core.datapath import DatapathPlan, horner_body

__all__ = ["counts", "horner_int", "ppa_eval_ref"]

#: calls of the plain integer datapath (a served model on the card makes
#: none: ``chip_smoke.py`` checks that)
counts = {"plain": 0}


def horner_int(sel: torch.Tensor, x_int: torch.Tensor, plan: DatapathPlan
               ) -> torch.Tensor:
    """The Horner datapath given pre-selected coefficients ``sel`` of shape
    (..., n+1)."""
    planes = [sel[..., i] for i in range(plan.order + 1)]
    return horner_body(plan, planes, x_int.to(torch.int32))


def ppa_eval_ref(x_int: torch.Tensor, starts: torch.Tensor,
                 coefs: torch.Tensor, plan: DatapathPlan) -> torch.Tensor:
    """Evaluate the PPA datapath on int32 inputs of any shape."""
    counts["plain"] += 1
    x = x_int.to(torch.int32)
    idx = torch.clamp(
        torch.searchsorted(starts, x.contiguous(), right=True) - 1,
        0, starts.shape[0] - 1)
    return horner_int(coefs[idx], x, plan)
