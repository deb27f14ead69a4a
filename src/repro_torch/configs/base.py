"""Shape profiles and the arch registry.

Every ported architecture ships as ``repro_torch/configs/<id>.py``
exposing ``config()`` (the published dims) and ``smoke()`` (a reduced
same-family variant for CPU tests).  :func:`apply_shape` sets the
per-shape execution knobs of ``repro/configs/base.py``;
:func:`resolve_for_mesh` pads the sharded dimensions to a mesh's
multiples, as the reference's does.
"""

from __future__ import annotations

import dataclasses
import importlib
from math import gcd as _gcd
from typing import Dict, Optional

from ..models.common import pad_to
from ..models.config import ModelCfg

__all__ = ["ShapeProfile", "SHAPES", "ARCH_IDS", "get_config",
           "get_smoke_config", "apply_shape", "resolve_for_mesh",
           "shape_skip_reason"]


@dataclasses.dataclass(frozen=True)
class ShapeProfile:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeProfile] = {
    "train_4k": ShapeProfile("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeProfile("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeProfile("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeProfile("long_500k", "decode", 524288, 1),
}

#: every architecture of the reference: the ``dec`` family, the recurrent
#: kinds (``hyb``, ``rwkv``), the encoder-decoder (whisper) and the vision
#: prefix (internvl)
ARCH_IDS = (
    "moonshot-v1-16b-a3b", "kimi-k2-1t-a32b", "qwen3-14b", "internlm2-1.8b",
    "mistral-nemo-12b", "qwen2-7b", "hymba-1.5b", "rwkv6-3b",
    "whisper-medium", "internvl2-26b",
)

_SUBQUADRATIC = {"hymba-1.5b", "rwkv6-3b"}


def shape_skip_reason(arch: str, shape: str) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the documented skip."""
    if shape == "long_500k" and arch not in _SUBQUADRATIC:
        return ("full-attention arch: 524288-ctx needs sub-quadratic "
                "attention (assignment: run for SSM/hybrid only)")
    return None


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise ValueError(f"arch {arch!r} is not ported; ported: {ARCH_IDS}")
    return importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")


def get_config(arch: str) -> ModelCfg:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelCfg:
    return _module(arch).smoke()


def resolve_for_mesh(cfg: ModelCfg, tp: int = 16, fsdp: int = 16
                     ) -> ModelCfg:
    """Pad sharded dimensions up to mesh multiples; record the padding.

    With ``cfg.kv_shard == "seq"`` the KV heads stay unpadded (they are
    replicated over the model axis; the cache shards its sequence dim
    instead — flash-decode style)."""
    pads = []

    def pad(name, val, mult):
        new = pad_to(val, mult)
        if new != val:
            pads.append((name, val, new))
        return new

    n_q = pad("n_q", cfg.n_q, tp)
    n_kv = cfg.n_kv if cfg.kv_shard == "seq" else pad("n_kv", cfg.n_kv, tp)
    if n_q % n_kv:
        n_q = pad("n_q_gqa", n_q, n_kv * tp // _gcd(n_kv, tp))
    kw = dict(
        n_q=n_q,
        n_kv=n_kv,
        vocab=pad("vocab", cfg.vocab, tp),
    )
    if cfg.ssm_inner:
        kw["ssm_inner"] = pad("ssm_inner", cfg.ssm_inner, tp)
    # GQA grouping must stay integral after padding; model dims must divide
    assert kw["n_q"] % kw["n_kv"] == 0, (cfg.arch, kw)
    assert cfg.d_model % tp == 0, (cfg.arch, cfg.d_model, tp)
    assert cfg.d_ff % tp == 0, (cfg.arch, cfg.d_ff, tp)
    if cfg.moe_experts:
        assert cfg.moe_experts % tp == 0, (cfg.arch, cfg.moe_experts, tp)
    return cfg.replace(pad_info=tuple(pads), **kw)


def apply_shape(cfg: ModelCfg, shape: ShapeProfile) -> ModelCfg:
    """Per-shape execution knobs: flash attention for prefill and training
    at 16k tokens and beyond, the MoE mode and no recompute at decode,
    chunked cross entropy in training."""
    kw = {}
    if shape.kind in ("prefill", "train") and shape.seq_len >= 16384:
        kw["attn_impl"] = "flash"
    if shape.kind == "decode":
        kw["moe_mode"] = "token_gather"
        kw["remat"] = "none"
    else:
        kw["moe_mode"] = "weight_gather"
    if shape.kind == "train":
        # chunked CE so the (B, T, V) logits never fully materialize
        kw["ce_chunks"] = max(8, shape.seq_len // 512)
    return cfg.replace(**kw)
