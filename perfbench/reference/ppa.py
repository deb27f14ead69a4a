"""The PPA activations of the plain reference: a frozen copy of the FQA-O2
fixed-point datapath, independent of the program.

The tables in ``tables/`` are the 16-bit deployment tables the
configurations state (``act_impl="ppa"``: W_i=8, W_a=(8,16), W_o=(16,16),
W_b=16, order 2), copied as data.  Evaluation, in int64 torch:

    x_q  = floor(|x| 2^w_in + 0.5), signed again where the table has no
           symmetry, clamped into the table's interval [lo, hi)
    seg  = the last segment whose start is <= x_q
    h1   = (a1 x_q) >> s1;  g = (h1 << ug) + (a2 << ua);  h2 = (g x_q) >> s2
    y    = ((h2 << uh) + (b << ub)) >> d,  read at 2^-w_out

then the float conditioning of the function (saturation above the
interval, symmetry for negative inputs).  The gradient is the exact
function's (straight-through), as a hardware NAF unit is trained.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import torch

__all__ = ["Table", "table_eval", "gate", "act", "softmax"]

TABLE_DIR = Path(__file__).resolve().parent / "tables"

# symmetry and saturation of the three deployment functions
_META = {
    "sigmoid_wide": ("sigmoid", 1.0),
    "gelu_inner": ("sigmoid", 1.0),
    "exp2_frac": (None, None),
}
_LOG2E = float(torch.tensor(math.log2(math.e), dtype=torch.float32))
_CLAMP = -24.0
_SQRT2 = float(torch.tensor(math.sqrt(2.0), dtype=torch.float32))


class Table:
    """One table's integers and shift plan on a device."""

    def __init__(self, naf: str, device):
        d = json.loads((TABLE_DIR / f"{naf}-16.json").read_text())
        c = d["cfg"]
        self.naf = naf
        self.w_in, self.w_out = c["w_in"], c["w_out"]
        w_a, w_o, w_b = c["w_a"], c["w_o"], c["w_b"]
        if len(w_a) != 2 or c["round_mults"]:
            raise ValueError(f"{naf}: the reference runs the order-2 plan")
        # the shift plan of an order-2 Horner chain
        self.s1 = w_a[0] + self.w_in - w_o[0]
        wg = max(w_o[0], w_a[1])
        self.ug, self.ua = wg - w_o[0], wg - w_a[1]
        self.s2 = wg + self.w_in - w_o[1]
        ws = max(w_o[1], w_b)
        self.uh, self.ub, self.down = ws - w_o[1], ws - w_b, ws - self.w_out
        lo, hi = d["interval"]
        self.lo = int(math.ceil(lo * (1 << self.w_in) - 1e-12))
        self.hi = int(math.ceil(hi * (1 << self.w_in) - 1e-12))
        self.starts = torch.tensor(d["starts_int"], dtype=torch.int64,
                                   device=device)
        a = torch.tensor(d["a_int"], dtype=torch.int64, device=device)
        self.a1, self.a2 = a[:, 0].contiguous(), a[:, 1].contiguous()
        self.b = torch.tensor(d["b_int"], dtype=torch.int64, device=device)
        self.symmetry, self.sat_hi = _META[naf]


def _shift(v: torch.Tensor, sh: int) -> torch.Tensor:
    return v >> sh if sh > 0 else (v << -sh if sh < 0 else v)


def table_eval(t: Table, x: torch.Tensor) -> torch.Tensor:
    """T(x) in float32 for a float tensor ``x`` (no gradient)."""
    x = x.to(torch.float32)
    xf = x.abs() if t.symmetry else x
    q = torch.floor(xf.abs() * float(1 << t.w_in) + 0.5)
    q = torch.clamp(q, -2.0 ** 40, 2.0 ** 40).to(torch.int64)
    q = torch.where(xf < 0, -q, q)
    over = q >= t.hi
    q = torch.clamp(q, t.lo, t.hi - 1)
    seg = torch.clamp(torch.searchsorted(t.starts, q, right=True) - 1, 0,
                      t.starts.shape[0] - 1)
    h = _shift(t.a1[seg] * q, t.s1)
    g = _shift(h, -t.ug) + _shift(t.a2[seg], -t.ua)
    h = _shift(g * q, t.s2)
    y = _shift(_shift(h, -t.uh) + _shift(t.b[seg], -t.ub), t.down)
    y = y.to(torch.float32) / float(1 << t.w_out)
    if t.sat_hi is not None:
        y = torch.where(over, t.sat_hi, y)
    if t.symmetry == "sigmoid":
        y = torch.where(x < 0, 1.0 - y, y)
    return y


def _exact(naf: str, x: torch.Tensor) -> torch.Tensor:
    if naf == "sigmoid_wide":
        return torch.sigmoid(x)
    if naf == "gelu_inner":
        return 0.5 * (1.0 + torch.erf(x / _SQRT2))
    if naf == "exp2_frac":
        return torch.exp2(x)
    raise KeyError(naf)


class _Act(torch.autograd.Function):
    """T(x), or x T(x) with ``gated``; the exact function's derivative."""

    @staticmethod
    def forward(ctx, x, t, gated):
        ctx.save_for_backward(x)
        ctx.naf, ctx.gated = t.naf, gated
        y = table_eval(t, x)
        return (x.to(torch.float32) * y if gated else y).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            v = x.detach().to(torch.float32).requires_grad_(True)
            y = _exact(ctx.naf, v)
            if ctx.gated:
                y = v * y
            (dx,) = torch.autograd.grad(y, v, g.to(torch.float32))
        return dx.to(x.dtype), None, None


def act(t: Table, x: torch.Tensor) -> torch.Tensor:
    return _Act.apply(x, t, False)


def gate(t: Table, x: torch.Tensor) -> torch.Tensor:
    """x T(x): silu through ``sigmoid_wide``, gelu through ``gelu_inner``."""
    return _Act.apply(x, t, True)


def softmax(t: Table, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis of float32 ``x`` where ``valid``: e^x as
    2^k 2^f with 2^f from the ``exp2_frac`` table, after the row max, the
    exponent clamped at -24.  Differentiable (the table's part
    straight-through)."""
    x = torch.where(valid, x, -math.inf)
    m = torch.amax(x, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    s = torch.clamp_min((x - m) * _LOG2E, _CLAMP)
    k = torch.floor(s).detach()
    e = act(t, s - k) * torch.exp2(k)
    e = torch.where(valid, e, 0.0)
    return e / torch.clamp_min(e.sum(dim=-1, keepdim=True), 1e-30)
