"""Three-term roofline of one step, from the costs :class:`OpCosts`
counted over it.

Counterpart of ``repro/roofline/analysis.py``.  Terms (per step, whole
mesh):

  compute    = FLOPs / (chips x peak_FLOPs)
  memory     = bytes / (chips x HBM_bw)
  collective = collective_bytes / (chips x link_bw)

Sources: ``OpCosts`` (``op_costs.py``) counts what one eager call of a
step runs: matrix-product FLOPs, the bytes every materialised op reads
and writes (the CUDA kernels report their own), and the collectives'
bytes by kind.  No HLO text is parsed here, so the reference's
``collective_bytes(hlo_text)`` has no counterpart: the collectives are
counted where they run, from the ``c10d`` ops the dispatcher sees.

Hardware model (one NVIDIA H100 SXM, ``HW_H100``): the published dense
bf16 tensor-core rate and HBM bandwidth at the full 700 W power limit,
and NVLink's 450 GB/s each way to the other cards of a host (NVIDIA's
data sheet and the Hopper architecture white paper).  A card
set below 700 W runs slower under load: state its power limit beside a
share taken against these peaks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

__all__ = ["HW_H100", "Roofline", "analyze_costs", "model_flops",
           "active_params"]

HW_H100 = {
    "peak_flops": 989e12,      # bf16 dense, tensor cores, per card
    "hbm_bw": 3.35e12,         # bytes/s per card
    "link_bw": 450e9,          # bytes/s per card, NVLink, each way
}


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float                # per-device step flops (OpCosts)
    hlo_bytes: float                # per-device bytes accessed
    coll_bytes: Dict[str, int]      # per-device collective bytes by kind
    model_flops: float              # 6·N·D (dense) / 6·N_active·D (MoE)
    ideal_bytes: float = 0.0        # minimum HBM traffic (decode: params
    #                                 + KV cache read once, whole mesh)
    peak_flops: float = HW_H100["peak_flops"]
    hbm_bw: float = HW_H100["hbm_bw"]
    link_bw: float = HW_H100["link_bw"]

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return sum(self.coll_bytes.values()) / self.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / total counted flops across chips — recompute and
        padding waste."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def t_useful(self) -> float:
        """Useful work time: max(useful compute, ideal memory traffic).

        Compute-bound shapes score against the FLOPs roof; decode shapes
        (which can never be compute-bound) against the bandwidth roof of
        reading every active parameter and the KV cache exactly once."""
        t = self.model_flops / (self.chips * self.peak_flops)
        if self.ideal_bytes:
            t = max(t, self.ideal_bytes / (self.chips * self.hbm_bw))
        return t

    @property
    def roofline_fraction(self) -> float:
        """Useful work time / achievable step time (max of the 3 terms)."""
        t_step = max(self.t_compute, self.t_memory, self.t_collective)
        return self.t_useful / t_step if t_step else 0.0

    def measured_share(self, measured_s: float) -> float:
        """Useful work time / a measured step time (seconds)."""
        return self.t_useful / measured_s if measured_s else 0.0

    def as_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes,
            "model_flops": self.model_flops,
            "ideal_bytes": self.ideal_bytes,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def analyze_costs(costs, *, arch: str, shape: str, mesh_desc: str,
                  chips: int, model_fl: float, ideal_bytes: float = 0.0
                  ) -> Roofline:
    """The roofline of one step from its :class:`OpCosts` (counted on one
    rank: per device).  Every layer ran eagerly, so no trip count enters
    (the reference's ``analyze_compiled`` rebuilds them from loops)."""
    return Roofline(arch=arch, shape=shape, mesh=mesh_desc, chips=chips,
                    hlo_flops=float(costs.flops),
                    hlo_bytes=float(costs.bytes),
                    coll_bytes=dict(costs.coll_bytes), model_flops=model_fl,
                    ideal_bytes=ideal_bytes)


def model_flops(n_params_active: float, tokens: float,
                kind: str = "train") -> float:
    """6·N·D for training; 2·N·D for inference forward."""
    factor = 6.0 if kind == "train" else 2.0
    return factor * n_params_active * tokens


def active_params(cfg, specs) -> float:
    """Parameter count of a spec tree (``param_specs(cfg)``) weighted by
    MoE activation: routed expert weights count top_k / E of themselves
    (``repro/launch/specs.py::active_params``)."""
    from ..tree import leaves_with_path
    total = 0.0
    for path, p in leaves_with_path(specs):
        keys = path.split("/")
        n = 1.0
        for s in p.shape:
            n *= s
        if "moe" in keys and any(k in ("w_gate", "w_up", "w_down")
                                 for k in keys) and "shared" not in keys:
            n *= cfg.moe_topk / max(1, cfg.moe_experts)
        total += n
    return total
