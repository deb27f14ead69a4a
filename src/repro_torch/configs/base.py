"""Arch registry: every ported architecture ships as
``repro_torch/configs/<id>.py`` exposing ``config()`` (the published dims)
and ``smoke()`` (a reduced same-family variant for CPU tests)."""

from __future__ import annotations

import importlib

from ..models.config import ModelCfg

__all__ = ["ARCH_IDS", "get_config", "get_smoke_config"]

#: architectures whose every stage the port runs (dense ``dec`` only)
ARCH_IDS = ("internlm2-1.8b",)


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise ValueError(f"arch {arch!r} is not ported; ported: {ARCH_IDS}")
    return importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")


def get_config(arch: str) -> ModelCfg:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelCfg:
    return _module(arch).smoke()
