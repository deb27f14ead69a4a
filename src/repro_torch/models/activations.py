"""Activation implementation selection: exact torch ops vs FQA PPA tables.

An :class:`ActBundle` holds the callables every model block needs — silu,
gelu, sigmoid, tanh, softplus, exp-decay and softmax — each backed either
by the exact float op or by a shipped PPA table running the fixed-point
datapath (with straight-through gradients).

``make_acts(impl=...)``:
  "exact"  — torch ops (the float baseline)
  "ppa"    — 16-bit FQA-O2 tables (W_i=8 W_a=(8,16) W_o=(16,16) W_b=16)
  "ppa8"   — the 8-bit FQA-S4-O1 tables

The tables come from the shipped JSON (:mod:`repro_torch.tables`), or,
given ``store=``, from a :class:`~repro_torch.compiler.TableStore`: each
table is ``store.compile_or_load(...)`` (a hit, or a compile into it).  A
miss compiles on a ``TorchSearchBackend`` on the bundle's own device, so
tables packed for the card are searched on the card.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from ..core.datapath import FWLConfig
from ..core.schemes import PPAScheme
from ..core.searchspace import TorchSearchBackend
from ..device import resolve_device
from ..kernels.ops import (TableConsts, pack_table, ppa_act, ppa_gate_act,
                           ppa_softmax)
from ..tables import NAFS, load_table

__all__ = ["ActBundle", "make_acts", "ppa_table_jobs"]

Act = Callable[[torch.Tensor], torch.Tensor]

#: the activation backend when the caller names none: the fused CUDA
#: kernel (its plain version on CPU tensors)
DEFAULT_BACKEND = "cuda_fused"


@dataclasses.dataclass(frozen=True)
class ActBundle:
    impl: str
    sigmoid: Act
    tanh: Act
    gelu: Act          # full gelu(x) = x * Phi(x)
    silu: Act          # full silu(x) = x * sigmoid(x)
    softplus: Act
    exp_decay: Act     # e^-x for x >= 0 (SSM/RWKV decays)
    softmax: Callable  # (x, axis=-1, where=None)

    def gate(self, kind: str) -> Act:
        return {"silu": self.silu, "gelu": self.gelu,
                "sigmoid": self.sigmoid, "tanh": self.tanh}[kind]


def _exact_bundle() -> ActBundle:
    def softmax(x, axis=-1, where=None):
        if where is not None:
            x = torch.where(where, x, torch.finfo(x.dtype).min)
        return torch.softmax(x, dim=axis)
    return ActBundle(
        impl="exact",
        sigmoid=torch.sigmoid, tanh=torch.tanh,
        gelu=lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
        silu=torch.nn.functional.silu,
        softplus=lambda x: torch.logaddexp(x, torch.zeros_like(x)),
        exp_decay=lambda x: torch.exp(-x), softmax=softmax)


# deployment FWL points (paper Table VI/VII conclusions)
_CFG16 = FWLConfig(w_in=8, w_out=16, w_a=(8, 16), w_o=(16, 16), w_b=16)
_CFG8 = FWLConfig(w_in=8, w_out=8, w_a=(8,), w_o=(8,), w_b=8)
_SCHEME16 = PPAScheme(order=2, quantizer="fqa")
_SCHEME8 = PPAScheme(order=1, m_shifters=4, quantizer="fqa")


def _bits(impl: str) -> int:
    if impl in ("ppa", "ppa16"):
        return 16
    if impl == "ppa8":
        return 8
    raise ValueError(f"unknown activation impl {impl!r}")


def ppa_table_jobs(impl: str):
    """The (naf, FWLConfig, PPAScheme) set an ``impl`` deployment needs;
    empty for the exact float impl."""
    if impl == "exact":
        return []
    cfg, scheme = ((_CFG16, _SCHEME16) if _bits(impl) == 16
                   else (_CFG8, _SCHEME8))
    return [(naf, cfg, scheme) for naf in NAFS]


def _tc(naf: str, bits: int, device: torch.device, store=None
        ) -> TableConsts:
    cfg, scheme = (_CFG16, _SCHEME16) if bits == 16 else (_CFG8, _SCHEME8)
    table = (load_table(naf, bits) if store is None
             else store.compile_or_load(
                 naf, cfg, scheme,
                 search_backend=TorchSearchBackend(device)))
    if table.cfg != cfg or table.scheme != scheme:
        raise ValueError(f"shipped table {naf}-{bits} is not the "
                         f"{cfg} / {scheme.tag} deployment point")
    return pack_table(table, device)


def _ppa_bundle(bits: int, backend: str, device: torch.device,
                store=None) -> ActBundle:
    sig, tnh, phi, sp, en, e2 = (_tc(naf, bits, device, store)
                                 for naf in NAFS)

    def softmax(x, axis=-1, where=None):
        return ppa_softmax(e2, x, axis=axis, where=where, backend=backend)

    return ActBundle(
        impl=f"ppa{bits}",
        sigmoid=lambda x: ppa_act(sig, x, backend),
        tanh=lambda x: ppa_act(tnh, x, backend),
        gelu=lambda x: ppa_gate_act(phi, x, backend),
        silu=lambda x: ppa_gate_act(sig, x, backend),
        softplus=lambda x: ppa_act(sp, x, backend),
        exp_decay=lambda x: ppa_act(en, x, backend),
        softmax=softmax)


@functools.lru_cache(maxsize=None)
def _cached_bundle(impl: str, backend: str, device: torch.device, store
                   ) -> ActBundle:
    if impl == "exact":
        return _exact_bundle()
    return _ppa_bundle(_bits(impl), backend, device, store)


def make_acts(impl: str = "exact", backend=None, device=None,
              store=None) -> ActBundle:
    """The bundle for ``impl`` on ``device`` (None: the card) through
    ``backend`` (None: the fused CUDA kernel).  ``store``: a
    ``TableStore`` the tables resolve through (None: the shipped JSON).
    Cached per (impl, backend, device, store)."""
    return _cached_bundle(impl, backend or DEFAULT_BACKEND,
                          resolve_device(device),
                          None if impl == "exact" else store)
