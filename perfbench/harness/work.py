"""The yardstick's arithmetic: the model's matrix-product parameters, the
attention pairs a mask lets through, the chip's published peaks, and the
percentile the tails use.

Model FLOPs count each weight product once a token (6x for a training
step, 2x for serving), the output head for every token whose logits the
work needs (every target token in training; one a prompt and one a
decoded token in serving), not the embedding lookup, and attention's score
and value products over the (query, key) pairs the mask lets through.
Recomputation and padding do not count.
"""

from __future__ import annotations

import math
from typing import Sequence

__all__ = ["PEAK_BF16", "HBM_BPS", "products", "causal_pairs",
           "train_flops", "percentile", "median"]

#: one NVIDIA H100 SXM, NVIDIA's data sheet: dense bf16 tensor-core rate
#: and HBM3 bandwidth, at the 700 W power limit
PEAK_BF16 = 989e12
HBM_BPS = 3.35e12


def products(m: dict) -> dict:
    """Weight-product parameters: per decoder token ("dec"), per encoder
    token ("enc": the encoder's layers and the decoder's cross-attention
    keys and values), and the head ("head")."""
    d, hq, hk, dh, f = (m["d_model"], m["n_q"], m["n_kv"], m["head_dim"],
                        m["d_ff"])
    attn = d * hq * dh * 2 + d * hk * dh * 2
    mlp = 3 * d * f if m["kind"] == "dec" else 2 * d * f
    dec = m["n_layers"] * (attn + mlp)
    enc = 0
    if m["kind"] == "xdec":
        dec += m["n_layers"] * 2 * d * hq * dh          # cross q and o
        enc = m["enc_layers"] * (attn + mlp) + m["n_layers"] * 2 * d * hk * dh
    return {"dec": dec, "enc": enc, "head": m["vocab"] * d}


def causal_pairs(t: int) -> int:
    return t * (t + 1) // 2


def train_flops(m: dict, rows: int, seq: int, enc: int) -> float:
    """Model FLOPs of one training step of ``rows`` x ``seq`` targets (and
    ``enc`` encoder frames a row)."""
    p = products(m)
    lin = 6.0 * rows * (seq * (p["dec"] + p["head"]) + enc * p["enc"])
    pairs = m["n_layers"] * causal_pairs(seq)
    if m["kind"] == "xdec":
        pairs += m["enc_layers"] * enc * enc + m["n_layers"] * seq * enc
    return lin + 3.0 * 4.0 * m["n_q"] * m["head_dim"] * rows * pairs


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile, linear between order statistics."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def median(values: Sequence[float]) -> float:
    return percentile(values, 50.0)
