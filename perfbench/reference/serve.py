"""The reference's reading of served tokens: one full forward pass over
each prompt with its served tokens, and the gap by which each served
token's logit lies below the best logit at its position."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .model import Precision, Reference

__all__ = ["served_gaps"]


@torch.no_grad()
def served_gaps(model: dict, params: dict,
                seqs: Sequence[Tuple[np.ndarray, List[int]]], device,
                control: bool = False) -> Tuple[float, int]:
    """(widest gap, tokens compared) over ``seqs`` (prompt ids, served
    tokens).  With ``control`` the tokens judged are those the float8
    control puts first at each position of the same sequences."""
    ref = Reference(model, device)
    ctl = Reference(model, device, Precision("fp8")) if control else None
    worst, count = 0.0, 0
    for prompt, out in seqs:
        p, n = len(prompt), len(out)
        ids = np.concatenate([np.asarray(prompt, np.int64),
                              np.asarray(out[:-1], np.int64)])
        seq = torch.as_tensor(ids, device=device)[None]
        lg = ref.logits(params, ref.hidden(params, seq)[0, p - 1:p - 1 + n])
        if ctl is None:
            tok = torch.as_tensor(np.asarray(out, np.int64), device=device)
        else:
            tok = ctl.logits(params, ctl.hidden(params, seq)[
                0, p - 1:p - 1 + n]).argmax(-1)
        gap = lg.amax(-1) - lg.gather(-1, tok[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
        count += n
    return worst, count
