"""internvl2-26b [vlm] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553.  The InternViT frontend is a stub, as in the reference: 256
precomputed patch embeddings (``batch["vision_embeds"]``) go before the
token stream.  [arXiv:2404.16821; hf]"""

from ..models.config import ModelCfg, StageCfg


def config() -> ModelCfg:
    return ModelCfg(
        arch="internvl2-26b", family="vlm",
        d_model=6144, n_q=48, n_kv=8, head_dim=128,
        d_ff=16384, vocab=92553,
        stages=(StageCfg("dec", 48),),
        vision_tokens=256,
        tie_embeddings=False,
    )


def smoke() -> ModelCfg:
    return ModelCfg(
        arch="internvl2-26b-smoke", family="vlm",
        d_model=64, n_q=4, n_kv=2, head_dim=16, d_ff=128, vocab=512,
        stages=(StageCfg("dec", 2),),
        vision_tokens=8, tie_embeddings=False,
        act_impl="exact", ce_chunks=2, compute_dtype="float32",
    )
