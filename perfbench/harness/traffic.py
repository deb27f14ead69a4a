"""The one generator every traffic file feeds.

``kind: "train"``: step ``i``'s batch of ``batch`` rows of ``seq`` target
tokens (uniform ids; labels are the next tokens), and for an
encoder-decoder ``enc_frames`` frame embeddings a row, normal with
``frame_std``; every row of every step differs, and all of it is drawn on
the device from the seed.

``kind: "serve"``: a closed loop of ``clients`` clients, each sending its
next request as soon as its last one has finished.  Prompt and output
lengths are lognormal (``median``, ``sigma``) clipped to ``[min, max]``,
drawn once from ``pool_seed`` into a pool of ``pool`` requests that every
seed shares.  The pool is sent in blocks of ``clients`` requests; the
run's seed orders each block and draws the prompt ids.  So every seed
offers the same sizes, block by block, in another order, and a window
holds the same work whatever the seed.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from .weights import randint, randn

__all__ = ["train_batch", "length_pool", "requests"]


def train_batch(model: dict, traffic: dict, seed: int, step: int,
                device) -> Dict[str, torch.Tensor]:
    b, t = traffic["batch"], traffic["seq"]
    ids = randint(model["vocab"], (b, t + 1), seed, f"batch/{step}/tokens",
                  device)
    out = {"tokens": ids[:, :-1].contiguous(),
           "labels": ids[:, 1:].contiguous()}
    if traffic.get("enc_frames"):
        out["enc_feats"] = randn(
            (b, traffic["enc_frames"], model["d_model"]), seed,
            f"batch/{step}/frames", device, std=traffic["frame_std"])
    return out


def _lengths(rng: np.random.Generator, spec: dict, n: int) -> np.ndarray:
    x = rng.lognormal(np.log(spec["median"]), spec["sigma"], n)
    return np.clip(np.round(x), spec["min"], spec["max"]).astype(np.int64)


def length_pool(traffic: dict) -> Tuple[np.ndarray, np.ndarray]:
    """(prompt lengths, output lengths) of the shared pool."""
    rng = np.random.default_rng(traffic["pool_seed"])
    n = traffic["pool"]
    return _lengths(rng, traffic["prompt"], n), \
        _lengths(rng, traffic["output"], n)


def requests(model: dict, traffic: dict, seed: int
             ) -> Iterator[Tuple[np.ndarray, int]]:
    """(prompt ids int32, output length) of request 0, 1, 2, ..."""
    prompts, outputs = length_pool(traffic)
    block = traffic["clients"]
    shuffle = np.random.default_rng([int(seed), 1])
    n = len(prompts)
    order = np.concatenate([a + shuffle.permutation(min(block, n - a))
                            for a in range(0, n, block)])
    ids = np.random.default_rng([int(seed), 2])
    i = 0
    while True:
        j = order[i % len(order)]
        yield (ids.integers(0, model["vocab"], int(prompts[j]),
                            dtype=np.int64).astype(np.int32),
               int(outputs[j]))
        i += 1
