"""moonshot-v1-16b-a3b [moe] — 48L d_model=2048 16H (GQA kv=16) d_ff=1408
(per expert) vocab=163840, MoE 64e top-6 (Moonlight lineage: first layer
dense, 2 shared experts, dense-layer FFN 8x the expert width).
[hf:moonshotai/Moonlight-16B-A3B; hf]"""

from ..models.config import ModelCfg, StageCfg


def config() -> ModelCfg:
    return ModelCfg(
        arch="moonshot-v1-16b-a3b", family="moe",
        d_model=2048, n_q=16, n_kv=16, head_dim=128,
        d_ff=11264,              # dense first layer (8x expert width)
        vocab=163840,
        stages=(StageCfg("dec", 1), StageCfg("dec", 47, moe=True)),
        moe_experts=64, moe_topk=6, moe_dff=1408, moe_shared=2,
        router_score="softmax",
        tie_embeddings=False,
    )


def smoke() -> ModelCfg:
    return ModelCfg(
        arch="moonshot-smoke", family="moe",
        d_model=64, n_q=4, n_kv=4, head_dim=16, d_ff=256, vocab=512,
        stages=(StageCfg("dec", 1), StageCfg("dec", 2, moe=True)),
        moe_experts=8, moe_topk=2, moe_dff=64, moe_shared=2,
        capacity_factor=2.0, tie_embeddings=False,
        act_impl="exact", ce_chunks=2, compute_dtype="float32",
    )
