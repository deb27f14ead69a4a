"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048
(per expert) vocab=163840, MoE 384e top-8.  Trillion-param MoE
(paper-table config, DeepSeek-V3 lineage: first layer dense with 18432
FFN, 1 shared expert, sigmoid router scores).  [arXiv:2501.kimi2;
unverified]"""

from ..models.config import ModelCfg, StageCfg


def config() -> ModelCfg:
    return ModelCfg(
        arch="kimi-k2-1t-a32b", family="moe",
        d_model=7168, n_q=64, n_kv=8, head_dim=128,
        d_ff=18432,              # dense first layer
        vocab=163840,
        stages=(StageCfg("dec", 1), StageCfg("dec", 60, moe=True)),
        moe_experts=384, moe_topk=8, moe_dff=2048, moe_shared=1,
        router_score="sigmoid",
        tie_embeddings=False,
        param_dtype="bfloat16",  # 1T params: bf16 master + factored opt
    )


def smoke() -> ModelCfg:
    return ModelCfg(
        arch="kimi-k2-smoke", family="moe",
        d_model=64, n_q=8, n_kv=2, head_dim=16, d_ff=192, vocab=512,
        stages=(StageCfg("dec", 1), StageCfg("dec", 2, moe=True)),
        moe_experts=16, moe_topk=4, moe_dff=48, moe_shared=1,
        router_score="sigmoid", capacity_factor=2.0, tie_embeddings=False,
        act_impl="exact", ce_chunks=2, compute_dtype="float32",
    )
