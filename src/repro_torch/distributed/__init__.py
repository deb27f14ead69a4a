"""repro_torch.distributed — sharding rules as DeviceMesh/DTensor
placements, pipeline parallelism, gradient compression, over
``torch.distributed`` process groups (NCCL on the card, gloo on the
CPU)."""

from .compression import ef_allreduce, ef_allreduce_tree, q8_decode, q8_encode
from .pipeline import bubble_fraction, pipeline_apply
from .sharding import (batch_shardings, cache_shardings, dp_axes_of,
                       make_ctx, make_rules, param_shardings)

__all__ = ["ef_allreduce", "ef_allreduce_tree", "q8_decode", "q8_encode",
           "bubble_fraction", "pipeline_apply",
           "batch_shardings", "cache_shardings", "dp_axes_of", "make_ctx",
           "make_rules", "param_shardings"]
