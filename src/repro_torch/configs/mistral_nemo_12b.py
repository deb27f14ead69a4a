"""mistral-nemo-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, 128k ctx (rope theta 1e6).
[hf:mistralai/Mistral-Nemo-Base-2407; hf]"""

from ..models.config import ModelCfg, StageCfg


def config() -> ModelCfg:
    return ModelCfg(
        arch="mistral-nemo-12b", family="dense",
        d_model=5120, n_q=32, n_kv=8, head_dim=128,
        d_ff=14336, vocab=131072,
        stages=(StageCfg("dec", 40),),
        rope_theta=1_000_000.0,
        tie_embeddings=False,
    )


def smoke() -> ModelCfg:
    return ModelCfg(
        arch="mistral-nemo-12b-smoke", family="dense",
        d_model=64, n_q=4, n_kv=2, head_dim=16, d_ff=128, vocab=512,
        stages=(StageCfg("dec", 2),),
        rope_theta=1_000_000.0, tie_embeddings=False,
        act_impl="exact", ce_chunks=2, compute_dtype="float32",
    )
