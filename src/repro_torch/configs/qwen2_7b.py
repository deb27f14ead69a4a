"""qwen2-7b [dense] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064, GQA + QKV bias.  [arXiv:2407.10671; hf]"""

from ..models.config import ModelCfg, StageCfg


def config() -> ModelCfg:
    return ModelCfg(
        arch="qwen2-7b", family="dense",
        d_model=3584, n_q=28, n_kv=4, head_dim=128,
        d_ff=18944, vocab=152064,
        stages=(StageCfg("dec", 28),),
        qkv_bias=True, rope_theta=1_000_000.0,
        tie_embeddings=False,
    )


def smoke() -> ModelCfg:
    return ModelCfg(
        arch="qwen2-7b-smoke", family="dense",
        d_model=64, n_q=4, n_kv=2, head_dim=16, d_ff=128, vocab=512,
        stages=(StageCfg("dec", 2),),
        qkv_bias=True, tie_embeddings=False,
        act_impl="exact", ce_chunks=2, compute_dtype="float32",
    )
