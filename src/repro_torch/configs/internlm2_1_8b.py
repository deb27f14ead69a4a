"""internlm2-1.8b [dense] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544, GQA.  [arXiv:2403.17297; hf]"""

from ..models.config import ModelCfg, StageCfg


def config() -> ModelCfg:
    return ModelCfg(
        arch="internlm2-1.8b", family="dense",
        d_model=2048, n_q=16, n_kv=8, head_dim=128,
        d_ff=8192, vocab=92544,
        stages=(StageCfg("dec", 24),),
        tie_embeddings=False,
    )


def smoke() -> ModelCfg:
    return ModelCfg(
        arch="internlm2-1.8b-smoke", family="dense",
        d_model=64, n_q=4, n_kv=2, head_dim=16, d_ff=128, vocab=512,
        stages=(StageCfg("dec", 2),),
        tie_embeddings=False,
        act_impl="exact", ce_chunks=2, compute_dtype="float32",
    )
