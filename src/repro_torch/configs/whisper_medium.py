"""whisper-medium [audio] — encoder-decoder, 24L encoder + 24L decoder,
d_model=1024 16H (kv=16) d_ff=4096 vocab=51865.  The conv frontend is a
stub, as in the reference: the encoder takes precomputed frame embeddings
(1500 frames, ``batch["enc_feats"]``).  LayerNorm and GELU, learned
encoder positions; the decoder's self-attention uses rope, as the
reference's does (in place of whisper's learned decoder positions).
[arXiv:2212.04356]"""

from ..models.config import ModelCfg, StageCfg


def config() -> ModelCfg:
    return ModelCfg(
        arch="whisper-medium", family="audio",
        d_model=1024, n_q=16, n_kv=16, head_dim=64,
        d_ff=4096, vocab=51865,
        stages=(StageCfg("xdec", 24),),
        enc_layers=24, enc_seq=1500,
        norm="layernorm", gate="gelu",
        tie_embeddings=True,
    )


def smoke() -> ModelCfg:
    return ModelCfg(
        arch="whisper-smoke", family="audio",
        d_model=64, n_q=4, n_kv=4, head_dim=16, d_ff=128, vocab=512,
        stages=(StageCfg("xdec", 2),),
        enc_layers=2, enc_seq=24,
        norm="layernorm", gate="gelu", tie_embeddings=True,
        act_impl="exact", ce_chunks=2, compute_dtype="float32",
    )
