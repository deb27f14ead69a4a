"""rwkv6-3b [ssm] — Finch: 32L d_model=2560 (attention-free) d_ff=8960
vocab=65536, data-dependent decay, 40 heads of 64.  Attention-free, so
decode carries O(1) state per sequence.  [arXiv:2404.05892; hf]"""

from ..models.config import ModelCfg, StageCfg


def config() -> ModelCfg:
    return ModelCfg(
        arch="rwkv6-3b", family="ssm",
        d_model=2560, n_q=40, n_kv=40, head_dim=64,
        d_ff=8960, vocab=65536,
        stages=(StageCfg("rwkv", 32),),
        rwkv_decay_lora=64,
        tie_embeddings=False,
    )


def smoke() -> ModelCfg:
    return ModelCfg(
        arch="rwkv6-smoke", family="ssm",
        d_model=64, n_q=4, n_kv=4, head_dim=16, d_ff=128, vocab=512,
        stages=(StageCfg("rwkv", 2),),
        rwkv_decay_lora=8, rwkv_chunk=8, tie_embeddings=False,
        act_impl="exact", ce_chunks=2, compute_dtype="float32",
    )
