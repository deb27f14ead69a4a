"""repro_torch.models — the models served and trained (``dec`` stages,
dense or MoE; ``hyb`` attention + SSM stages; ``rwkv`` stages; whisper's
``enc`` encoder and ``xdec`` cross decoder; internvl's vision prefix),
with their activations through an ActBundle."""

from .activations import ActBundle, make_acts, ppa_table_jobs
from .common import P, init_params, params_from_jax
from .config import ModelCfg, StageCfg
from .transformer import (decode_step, forward_hidden, init_cache, loss_fn,
                          param_specs, prefill, prepare_params)

__all__ = ["ActBundle", "ModelCfg", "P", "StageCfg",
           "decode_step", "forward_hidden", "init_cache", "init_params",
           "loss_fn", "make_acts", "param_specs", "params_from_jax",
           "ppa_table_jobs", "prefill", "prepare_params"]
