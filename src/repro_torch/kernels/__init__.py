"""repro_torch.kernels — the PPA activation datapath on Hopper: CUDA
kernels written by hand (``csrc/``: the integer and fused PPA kernels, the
softmax and its backward), their plain PyTorch versions, and the
model-facing ops with the backend registry."""

from typing import Dict

from . import fused, ppa, ref, softmax_ppa
from .ops import (Backend, TableConsts, available_backends, check_int32,
                  get_backend, make_ppa_fn, pack_table, plan_ints, ppa_act,
                  ppa_apply, ppa_gate, ppa_gate_act, ppa_softmax)

__all__ = ["Backend", "TableConsts", "available_backends", "check_int32",
           "get_backend", "make_ppa_fn", "pack_table", "plan_ints",
           "ppa_act", "ppa_apply", "ppa_gate", "ppa_gate_act", "ppa_softmax",
           "read_counts", "read_shape_counts", "read_variant_counts",
           "reset_counts"]

_COUNTS = {"ppa_int": ppa.counts, "ppa_fused": fused.counts,
           "softmax_ppa": softmax_ppa.counts,
           "softmax_ppa_bwd": softmax_ppa.bwd_counts, "ref": ref.counts}
_SHAPE_COUNTS = {"ppa_int": ppa.shape_counts,
                 "ppa_fused": fused.shape_counts,
                 "softmax_ppa": softmax_ppa.shape_counts,
                 "softmax_ppa_bwd": softmax_ppa.bwd_shape_counts}


def reset_counts() -> None:
    """Set every kernel's launch count and plain-call count to 0, and
    forget the launches by shape and by variant."""
    for c in _COUNTS.values():
        for k in c:
            c[k] = 0
    for c in (*_SHAPE_COUNTS.values(), fused.variant_counts):
        c.clear()


def read_shape_counts() -> Dict[str, Dict[tuple, int]]:
    """{kernel: {input shape: launches}} for the four kernels."""
    return {name: dict(c) for name, c in _SHAPE_COUNTS.items()}


def read_variant_counts() -> Dict[tuple, int]:
    """The fused kernel's launches by (input shape, dtype name, table's
    NAF, gate)."""
    return dict(fused.variant_counts)


def read_counts() -> Dict[str, Dict[str, int]]:
    """{kernel: {"launches": n, "plain": n}} (``ref`` has plain only)."""
    return {name: dict(c) for name, c in _COUNTS.items()}
