"""Interval domain over scaled integers + abstract execution of the datapath.

The certifier does **not** re-implement the Horner chain.  It runs the one
shared ``horner_body`` code object (core/datapath.py) with :class:`Interval`
operands: every ``* + >> <<`` the datapath performs dispatches to the sound
interval transformer below, and the ``tap`` hook records the abstract value
of every named intermediate.  Analyzer/datapath drift is therefore
impossible by construction — there is no second model to diverge.

Soundness of the transformers (the containment property the hypothesis
tests check end-to-end):

* ``+`` / int-const ``+`` — endpoint-wise; exact for independent operands,
  an over-approximation (never an under-approximation) for correlated ones.
* ``*`` — corner products ``min/max(lo*lo, lo*hi, hi*lo, hi*hi)``.  For any
  concrete ``u in [ulo, uhi]``, ``v in [vlo, vhi]`` — including correlated
  pairs such as ``g`` and ``x`` — the product ``u*v`` is a monotone
  function of ``v`` for fixed ``u`` (and vice versa), hence bounded by a
  corner value.
* ``>> s`` (s >= 0) — arithmetic shift is floor division by ``2**s``,
  a monotone non-decreasing map, so the image endpoints bound the image.
* ``<< s`` — exact multiplication by ``2**s``, monotone.

``round_mults`` adds ``1 << (sh - 1)`` before the shift; that is an
int-const ``+`` and needs no special casing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

from ..core.datapath import DatapathPlan, FWLConfig, horner_body
from ..core.fixed_point import signed_bits

__all__ = ["Interval", "NodeBound", "abstract_horner", "trace_horner",
           "node_fwls"]


@dataclasses.dataclass(frozen=True)
class Interval:
    """Closed integer interval [lo, hi] with the operator subset the
    datapath body uses (``* + >> <<``, int constants on either side)."""

    lo: int
    hi: int

    def __post_init__(self):
        if self.lo > self.hi:
            raise ValueError(f"empty interval [{self.lo}, {self.hi}]")

    @classmethod
    def point(cls, v: int) -> "Interval":
        return cls(int(v), int(v))

    @classmethod
    def of(cls, a: int, b: int) -> "Interval":
        a, b = int(a), int(b)
        return cls(min(a, b), max(a, b))

    def hull(self, other: "Interval") -> "Interval":
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi))

    def contains(self, v: int) -> bool:
        return self.lo <= int(v) <= self.hi

    @property
    def bits(self) -> int:
        """Minimal signed (two's-complement) width holding the interval."""
        return signed_bits(self.lo, self.hi)

    # -- operator subset used by horner_body --------------------------------

    def _coerce(self, other):
        if isinstance(other, Interval):
            return other
        if isinstance(other, int):
            return Interval.point(other)
        return NotImplemented

    def __add__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return Interval(self.lo + o.lo, self.hi + o.hi)

    __radd__ = __add__

    def __mul__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        corners = (self.lo * o.lo, self.lo * o.hi,
                   self.hi * o.lo, self.hi * o.hi)
        return Interval(min(corners), max(corners))

    __rmul__ = __mul__

    def __rshift__(self, sh: int):
        if sh < 0:
            raise ValueError("negative shift count")
        return Interval(self.lo >> sh, self.hi >> sh)

    def __lshift__(self, sh: int):
        if sh < 0:
            raise ValueError("negative shift count")
        return Interval(self.lo << sh, self.hi << sh)


@dataclasses.dataclass(frozen=True)
class NodeBound:
    """Proven bound of one named datapath intermediate.

    name: node label from the ``horner_body`` tap (p1, h1, g1, ..., sum,
      out).  ``p{i}`` is the multiplier-i output *including* the
      ``round_mults`` addend, i.e. the physical value entering the
      truncation shifter — the widest register of stage i.
    fwl:  the node's fractional word length (fixed by the DatapathPlan).
    lo/hi: proven integer bounds at that FWL.
    bits: minimal signed width; ``iwl = bits - fwl`` integer bits required.
    """

    name: str
    fwl: int
    lo: int
    hi: int

    @property
    def bits(self) -> int:
        return signed_bits(self.lo, self.hi)

    @property
    def iwl(self) -> int:
        return self.bits - self.fwl

    def as_dict(self) -> dict:
        return {"name": self.name, "fwl": self.fwl, "lo": self.lo,
                "hi": self.hi, "bits": self.bits, "iwl": self.iwl}


def node_fwls(cfg: FWLConfig) -> Dict[str, int]:
    """FWL of every tapped node, mirroring ``DatapathPlan.from_config``.

    The FWLs are compile-time facts of the plan (not of the data): p_i is
    the raw product FWL, h_i the post-truncation FWL w_o[i-1], g_i the
    concat-adder FWL max(w_o[i-1], w_a[i]), sum the intercept-adder FWL
    max(w_o[n-1], w_b), out the declared w_out.
    """
    fwls = {"p1": cfg.w_a[0] + cfg.w_in, "h1": cfg.w_o[0]}
    cur = cfg.w_o[0]
    for i in range(1, cfg.order):
        wg = max(cur, cfg.w_a[i])
        fwls[f"g{i}"] = wg
        fwls[f"p{i + 1}"] = wg + cfg.w_in
        fwls[f"h{i + 1}"] = cfg.w_o[i]
        cur = cfg.w_o[i]
    fwls["sum"] = max(cur, cfg.w_b)
    fwls["out"] = cfg.w_out
    return fwls


def abstract_horner(
    cfg: FWLConfig,
    a_iv: Sequence[Interval],
    b_iv: Interval,
    x_iv: Interval,
) -> Dict[str, NodeBound]:
    """Abstractly execute the shared Horner body over interval operands.

    Args:
      cfg: the FWL configuration under certification.
      a_iv: per-stage coefficient-integer intervals (FWL cfg.w_a[i]).
      b_iv: intercept-integer interval (FWL cfg.w_b).
      x_iv: input-integer interval (FWL cfg.w_in).

    Returns:
      {node name: NodeBound} for every intermediate the tap observes.
    """
    n = cfg.order
    if len(a_iv) != n:
        raise ValueError(f"expected {n} coefficient intervals, got {len(a_iv)}")
    plan = DatapathPlan.from_config(cfg)
    fwls = node_fwls(cfg)
    bounds: Dict[str, NodeBound] = {}

    def tap(name: str, v: Interval):
        bounds[name] = NodeBound(name=name, fwl=fwls[name],
                                 lo=v.lo, hi=v.hi)

    sel = list(a_iv) + [b_iv]
    horner_body(plan, sel, x_iv, tap=tap)
    return bounds


def trace_horner(
    cfg: FWLConfig,
    a_int: Sequence[int],
    b_int: int,
    x_int: int,
) -> Tuple[int, Dict[str, int]]:
    """Concretely execute the shared body on python ints, recording every
    tapped intermediate.  The soundness property tests compare these traces
    against :func:`abstract_horner` bounds."""
    plan = DatapathPlan.from_config(cfg)
    trace: Dict[str, int] = {}

    def tap(name: str, v: int):
        trace[name] = int(v)

    sel = [int(a) for a in a_int] + [int(b_int)]
    out = horner_body(plan, sel, int(x_int), tap=tap)
    return int(out), trace


def join_bounds(
    per_segment: Sequence[Dict[str, NodeBound]],
) -> Dict[str, NodeBound]:
    """Hull-join per-segment node bounds into whole-table bounds."""
    joined: Dict[str, NodeBound] = {}
    for seg in per_segment:
        for name, nb in seg.items():
            if name in joined:
                j = joined[name]
                joined[name] = NodeBound(name=name, fwl=nb.fwl,
                                         lo=min(j.lo, nb.lo),
                                         hi=max(j.hi, nb.hi))
            else:
                joined[name] = nb
    return joined
