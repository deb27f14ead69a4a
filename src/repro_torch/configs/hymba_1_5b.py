"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention + mamba heads per block.
Full (global) attention on layers 0, 15 and 31 as in the reference;
sliding-window (1024) everywhere else, so each stage's KV cache is sized
to its own window.  [arXiv:2411.13676; hf]"""

from ..models.config import ModelCfg, StageCfg

_SWA = 1024


def config() -> ModelCfg:
    return ModelCfg(
        arch="hymba-1.5b", family="hybrid",
        d_model=1600, n_q=25, n_kv=5, head_dim=64,
        d_ff=5504, vocab=32001,
        stages=(
            StageCfg("hyb", 1, window=None),      # layer 0: global
            StageCfg("hyb", 14, window=_SWA),
            StageCfg("hyb", 1, window=None),      # layer 15: global
            StageCfg("hyb", 15, window=_SWA),
            StageCfg("hyb", 1, window=None),      # layer 31: global
        ),
        ssm_inner=3200, ssm_state=16, ssm_conv=4, ssm_dt_rank=128,
        tie_embeddings=True,
    )


def smoke() -> ModelCfg:
    return ModelCfg(
        arch="hymba-smoke", family="hybrid",
        d_model=64, n_q=4, n_kv=2, head_dim=16, d_ff=128, vocab=512,
        stages=(StageCfg("hyb", 1, window=None),
                StageCfg("hyb", 2, window=8)),
        ssm_inner=128, ssm_state=8, ssm_dt_rank=16, ssm_chunk=8,
        tie_embeddings=True,
        act_impl="exact", ce_chunks=2, compute_dtype="float32",
    )
