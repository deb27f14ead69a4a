"""Model configuration dataclasses (construction lives in repro_torch.configs).

A copy of ``repro.models.config``; the only change is the default
activation backend, which on the card is the fused CUDA kernel."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["StageCfg", "ModelCfg"]


@dataclasses.dataclass(frozen=True)
class StageCfg:
    """One homogeneous stack of layers (scanned together).

    Heterogeneous models are sequences of stages: kimi = dense(1) + moe(60);
    hymba alternates global-attention and sliding-window hybrid stages so
    each stage's KV cache can be sized to its own window.
    """

    kind: str                 # dec | hyb | rwkv | enc | xdec
    n_layers: int
    window: Optional[int] = None   # sliding window (None = global)
    moe: bool = False


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    arch: str
    family: str               # dense | moe | ssm | hybrid | audio | vlm
    d_model: int
    n_q: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    stages: Tuple[StageCfg, ...]

    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"     # rmsnorm | layernorm
    gate: str = "silu"        # mlp nonlinearity

    # MoE
    moe_experts: int = 0
    moe_topk: int = 0
    moe_dff: int = 0
    moe_shared: int = 0
    router_score: str = "softmax"
    capacity_factor: float = 1.25
    moe_mode: str = "weight_gather"

    # SSM (hybrid)
    ssm_inner: int = 0
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_dt_rank: int = 64

    # RWKV
    rwkv_decay_lora: int = 64

    # encoder-decoder (audio) / vision prefix (vlm)
    enc_layers: int = 0
    enc_seq: int = 0
    vision_tokens: int = 0

    tie_embeddings: bool = True
    act_impl: str = "ppa"     # exact | ppa | ppa8  (paper's datapath default)
    act_backend: str = "cuda_fused"  # cuda_fused (fused CUDA kernel) |
    #                           cuda_int (integer CUDA kernel) | ref (plain
    #                           searchsorted+horner) | lut_index | lut_value;
    #                           the CUDA wrappers run plain on CPU tensors
    kv_shard: str = "heads"   # heads (pad kv to TP) | seq (flash-decode)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "dots"       # none | dots | full
    attn_impl: str = "dense"  # dense | flash
    flash_chunk: int = 1024
    ce_chunks: int = 8
    ssm_chunk: int = 256
    rwkv_chunk: int = 64

    # padding applied by a mesh resolution (documentation only)
    pad_info: Tuple[Tuple[str, int, int], ...] = ()

    @property
    def n_layers(self) -> int:
        return sum(s.n_layers for s in self.stages)

    def replace(self, **kw) -> "ModelCfg":
        return dataclasses.replace(self, **kw)
