"""Datapath bit-width certification.

Two entry points, one abstract interpreter (:mod:`.intervals`):

* :func:`certify_table` — **exact** mode.  For a compiled
  :class:`~repro_torch.core.schemes.PPATable`, abstractly execute the shared
  Horner body per segment with the segment's exact integer coefficients
  and its exact integer x sub-range, hull-join the per-node bounds, and
  check every intermediate against the executor's carrier width.  This is
  the sound proof the CI gate and the ``TableStore`` stamp rely on: if the
  certificate reports ``ok`` then no input the kernel can see (kernels clip
  x to the table grid before evaluation) overflows any intermediate.
* :func:`certify_config` — **envelope** mode, a pre-compile *estimate*.
  Coefficient bounds come from minimax fits over a dyadic window family
  plus the quantizer's documented candidate margins, and the intercept
  bound from the error-flattening identity.  Sound relative to its
  assumptions (recorded in the certificate); compile the table and run
  exact mode for the binding proof.

Certificates serialize to JSON (``Certificate.to_json``); the store keeps
them next to the table artifact as ``<artifact>.cert.json`` with
version/key stamps checked on ``compile_or_load``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.datapath import FWLConfig
from ..core.fixed_point import grid_for_interval
from ..core.functions import NAFSpec, get_naf
from .intervals import Interval, NodeBound, abstract_horner, join_bounds

__all__ = ["CERT_VERSION", "KERNEL_CARRIER_BITS", "Violation", "Certificate",
           "certify_table", "certify_config"]

#: Certificate schema version — bump on any change to the JSON layout or
#: the abstract semantics, so stale certificates are re-proven.
CERT_VERSION = 1

#: Carrier width of the torch and CUDA executors (kernels/ops.py packs tables
#: into int32; the numpy golden model runs int64 and is never the binding
#: constraint for paper configs).
KERNEL_CARRIER_BITS = 32


@dataclasses.dataclass(frozen=True)
class Violation:
    """One intermediate whose proven bound exceeds the carrier width.

    ``x_lo``/``x_hi`` give the concrete (float) input sub-interval on which
    the overflow was proven possible — the "concrete violating interval"
    the CLI reports.
    """

    node: str
    bits: int
    carrier: int
    segment: Optional[int]
    x_lo: float
    x_hi: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def describe(self) -> str:
        seg = f" segment {self.segment}" if self.segment is not None else ""
        return (f"{self.node} needs {self.bits} bits > int{self.carrier}"
                f"{seg} on x in [{self.x_lo:.6g}, {self.x_hi:.6g}]")


@dataclasses.dataclass
class Certificate:
    """Machine-readable overflow-freedom proof for one (naf, cfg, scheme).

    ``nodes`` carries the hull-joined per-intermediate bounds (see
    :class:`~repro_torch.analysis.intervals.NodeBound`); ``ok`` iff no node
    exceeds ``carrier_bits``.  ``meta`` holds the store's stamps
    (artifact ``key``, ``CompileJob.VERSION`` as ``"v"``) in table mode.
    """

    cert_version: int
    mode: str                       # "table" (exact) | "envelope" (estimate)
    naf: str
    interval: Tuple[float, float]
    cfg: dict
    scheme_tag: str
    carrier_bits: int
    nodes: List[dict]
    violations: List[Violation]
    assumptions: List[str] = dataclasses.field(default_factory=list)
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations

    @property
    def max_iwl(self) -> int:
        return max((n["iwl"] for n in self.nodes), default=0)

    @property
    def max_bits(self) -> int:
        return max((n["bits"] for n in self.nodes), default=0)

    def widest_node(self) -> str:
        if not self.nodes:
            return ""
        return max(self.nodes, key=lambda n: n["bits"])["name"]

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["interval"] = list(self.interval)
        d["violations"] = [v.as_dict() for v in self.violations]
        return json.dumps(d, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "Certificate":
        d = json.loads(s)
        d["interval"] = tuple(d["interval"])
        d["violations"] = [Violation(**v) for v in d["violations"]]
        return Certificate(**d)

    def save(self, path: str | Path) -> None:
        Path(path).write_text(self.to_json())

    @staticmethod
    def load(path: str | Path) -> "Certificate":
        return Certificate.from_json(Path(path).read_text())


def _segment_windows(starts: np.ndarray, lo: int, hi: int):
    """Integer x sub-range [seg_lo, seg_hi] (inclusive) per segment.

    Mirrors ``eval_table_int``'s searchsorted-with-clip dispatch: inputs
    below ``starts[0]`` (the kernels clip to the grid, so only ``lo``
    itself can sit there) land in segment 0; the last segment runs to the
    end-exclusive grid bound ``hi - 1``.
    """
    S = starts.shape[0]
    for s in range(S):
        seg_lo = lo if s == 0 else int(starts[s])
        seg_hi = (int(starts[s + 1]) - 1) if s + 1 < S else hi - 1
        if seg_lo <= seg_hi:
            yield s, seg_lo, seg_hi


def certify_table(table, *, carrier_bits: int = KERNEL_CARRIER_BITS,
                  ) -> Certificate:
    """Exact per-segment certification of a compiled ``PPATable``."""
    cfg: FWLConfig = table.cfg
    xs, xe = table.interval
    lo = int(np.ceil(xs * (1 << cfg.w_in) - 1e-12))
    hi = int(np.ceil(xe * (1 << cfg.w_in) - 1e-12))
    per_seg: List[Dict[str, NodeBound]] = []
    violations: List[Violation] = []
    scale = float(1 << cfg.w_in)
    for s, seg_lo, seg_hi in _segment_windows(table.starts_int, lo, hi):
        a_iv = [Interval.point(int(table.a_int[s, i]))
                for i in range(table.order)]
        bounds = abstract_horner(cfg, a_iv, Interval.point(int(table.b_int[s])),
                                 Interval(seg_lo, seg_hi))
        per_seg.append(bounds)
        for nb in bounds.values():
            if nb.bits > carrier_bits:
                violations.append(Violation(
                    node=nb.name, bits=nb.bits, carrier=carrier_bits,
                    segment=s, x_lo=seg_lo / scale, x_hi=seg_hi / scale))
    joined = join_bounds(per_seg)
    return Certificate(
        cert_version=CERT_VERSION, mode="table", naf=table.naf,
        interval=(float(xs), float(xe)), cfg=cfg.as_dict(),
        scheme_tag=table.scheme.tag, carrier_bits=carrier_bits,
        nodes=[joined[k].as_dict() for k in sorted(joined)],
        violations=violations)


# -- envelope mode -----------------------------------------------------------

def _quantizer_margin(quantizer: str, cfg: FWLConfig, i: int,
                      m_shifters: Optional[int]) -> int:
    """Worst-case distance (in coefficient-integer ULPs at FWL w_a[i])
    between the rounded minimax coefficient and any candidate the named
    quantizer may select, mirroring core/quantize.py's constructions."""
    if quantizer == "fqa":
        # extended offset space around the snapped base: [-2^k, 2^(k+1)]
        return 1 << (cfg.d_bits(i) + 1)
    if quantizer == "fqa_fast":
        return 1 << cfg.d_bits(i)
    if quantizer == "qpa":
        return 2                    # fine_tune (default 1) + rounding
    if quantizer == "plac":
        return 1
    if quantizer == "mlplac":
        if i == 0 and m_shifters:
            scale = cfg.w_a[0] - min(m_shifters, cfg.w_a[0])
            return 2 << scale
        return 2
    raise ValueError(f"unknown quantizer {quantizer!r}")


def _coef_envelope(spec: NAFSpec, cfg: FWLConfig, order: int,
                   interval: Tuple[float, float], max_depth: int,
                   ) -> List[Tuple[float, float]]:
    """Real-coefficient bounds per stage from minimax fits over a dyadic
    window family (every segment the segmenter can emit is contained in a
    window of at most one extra halving — recorded as an assumption)."""
    xs, xe = interval
    bounds = [(np.inf, -np.inf)] * order
    for depth in range(max_depth + 1):
        parts = 1 << depth
        for k in range(parts):
            w_lo = xs + (xe - xs) * k / parts
            w_hi = xs + (xe - xs) * (k + 1) / parts
            gx = grid_for_interval(w_lo, w_hi, cfg.w_in)
            if gx.size < order + 2:
                continue
            x = gx.astype(np.float64) / (1 << cfg.w_in)
            from ..core.remez import fit_minimax
            coeffs, _b = fit_minimax(x, spec(x), order)
            for i in range(order):
                lo_i, hi_i = bounds[i]
                c = float(coeffs[i])
                bounds[i] = (min(lo_i, c), max(hi_i, c))
    return bounds


def certify_config(
    naf: str | NAFSpec,
    cfg: FWLConfig,
    scheme=None,
    *,
    interval: Optional[Tuple[float, float]] = None,
    carrier_bits: int = KERNEL_CARRIER_BITS,
    max_depth: int = 6,
) -> Certificate:
    """Envelope-mode (pre-compile) certification of a (naf, cfg, scheme).

    Coefficient intervals are minimax-fit envelopes over a dyadic window
    family widened by the quantizer's candidate margin; the intercept bound
    follows from the error-flattening step: the compiler picks b so the
    flattened output tracks f, hence |b| <= max|f| + max|h_pre| / 2**w_pre
    (+1 ULP rounding).  Both assumptions are recorded in the certificate —
    this mode estimates; :func:`certify_table` proves.
    """
    from ..core.schemes import PPAScheme
    spec = naf if isinstance(naf, NAFSpec) else get_naf(naf)
    scheme = scheme or PPAScheme(order=cfg.order)
    xs, xe = interval if interval is not None else spec.interval
    order = cfg.order

    env = _coef_envelope(spec, cfg, order, (xs, xe), max_depth)
    a_iv = []
    for i in range(order):
        lo_r, hi_r = env[i]
        if not np.isfinite(lo_r):
            lo_r = hi_r = 0.0
        margin = _quantizer_margin(scheme.quantizer, cfg, i,
                                   scheme.m_shifters)
        a_iv.append(Interval(
            int(np.floor(lo_r * (1 << cfg.w_a[i]))) - margin,
            int(np.ceil(hi_r * (1 << cfg.w_a[i]))) + margin))

    lo = int(np.ceil(xs * (1 << cfg.w_in) - 1e-12))
    hi = int(np.ceil(xe * (1 << cfg.w_in) - 1e-12))
    if lo >= hi:
        raise ValueError(f"empty input grid for interval [{xs}, {xe})")
    x_iv = Interval(lo, hi - 1)

    # phase 1: b = 0 exposes the pre-intercept bound h_pre
    probe = abstract_horner(cfg, a_iv, Interval.point(0), x_iv)
    h_pre = probe[f"h{order}"]
    w_pre = h_pre.fwl
    gx = np.arange(lo, hi, dtype=np.int64)
    f_max = float(np.abs(spec(gx.astype(np.float64) / (1 << cfg.w_in))).max())
    h_mag = max(abs(h_pre.lo), abs(h_pre.hi)) / float(1 << w_pre)
    b_mag = int(round((f_max + h_mag) * (1 << cfg.w_b))) + 1
    b_iv = Interval(-b_mag, b_mag)

    # phase 2: the reported run with the full intercept interval
    bounds = abstract_horner(cfg, a_iv, b_iv, x_iv)
    violations = [
        Violation(node=nb.name, bits=nb.bits, carrier=carrier_bits,
                  segment=None, x_lo=float(xs), x_hi=float(xe))
        for nb in bounds.values() if nb.bits > carrier_bits
    ]
    return Certificate(
        cert_version=CERT_VERSION, mode="envelope", naf=spec.name,
        interval=(float(xs), float(xe)), cfg=cfg.as_dict(),
        scheme_tag=scheme.tag, carrier_bits=carrier_bits,
        nodes=[bounds[k].as_dict() for k in sorted(bounds)],
        violations=violations,
        assumptions=[
            f"coefficient envelope: minimax fits over dyadic windows to "
            f"depth {max_depth} + {scheme.quantizer} candidate margins",
            "intercept bound: |b| <= max|f| + max|h_pre|/2^w_pre + 1 ULP "
            "(error-flattening identity)",
        ])
