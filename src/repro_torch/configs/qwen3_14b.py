"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936, qk_norm, GQA.  [hf:Qwen/Qwen3-8B family; hf]"""

from ..models.config import ModelCfg, StageCfg


def config() -> ModelCfg:
    return ModelCfg(
        arch="qwen3-14b", family="dense",
        d_model=5120, n_q=40, n_kv=8, head_dim=128,
        d_ff=17408, vocab=151936,
        stages=(StageCfg("dec", 40),),
        qk_norm=True, rope_theta=1_000_000.0,
        tie_embeddings=False,
    )


def smoke() -> ModelCfg:
    return ModelCfg(
        arch="qwen3-14b-smoke", family="dense",
        d_model=64, n_q=4, n_kv=2, head_dim=16, d_ff=128, vocab=512,
        stages=(StageCfg("dec", 2),),
        qk_norm=True, tie_embeddings=False,
        act_impl="exact", ce_chunks=2, compute_dtype="float32",
    )
