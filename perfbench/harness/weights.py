"""The weights and inputs of a run, drawn on the device from ``--seed``.

The tree's layout is the configuration's (and the program's): one stage of
stacked layers ``stages/s0_<kind>/...`` (a leading layer axis), ``wq``
(D, Hq, Dh), ``wo`` (Hq, Dh, D), MLP matrices (in, out), ``embed`` and
``lm_head`` (V, D), whisper's ``encoder`` {pos, stack, ln_f}.  Each leaf is
one ``torch.randn`` on a generator of its own, seeded by the run's seed
and the leaf's path, so a leaf can be drawn again alone and the same seed
gives the same tree on any run.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Tuple

import torch

__all__ = ["shapes", "leaf_seed", "draw_leaf", "draw_tree", "tree_paths",
           "get_path", "randn", "randint"]

Shape = Tuple[int, ...]


def _norm(m: dict, pre: str, lead: Shape, out: Dict[str, tuple]) -> None:
    out[f"{pre}/scale"] = (lead + (m["d_model"],), "ones")
    if m["norm"] == "layernorm":
        out[f"{pre}/bias"] = (lead + (m["d_model"],), "zeros")


def _attn(m: dict, pre: str, lead: Shape, out: Dict[str, tuple]) -> None:
    d, hq, hk, dh = m["d_model"], m["n_q"], m["n_kv"], m["head_dim"]
    out[f"{pre}/wq"] = (lead + (d, hq, dh), "normal")
    out[f"{pre}/wk"] = (lead + (d, hk, dh), "normal")
    out[f"{pre}/wv"] = (lead + (d, hk, dh), "normal")
    out[f"{pre}/wo"] = (lead + (hq, dh, d), "normal")


def _block(m: dict, pre: str, n: int, kind: str,
           out: Dict[str, tuple]) -> None:
    lead, d, f = (n,), m["d_model"], m["d_ff"]
    _norm(m, f"{pre}/ln1", lead, out)
    _attn(m, f"{pre}/attn", lead, out)
    _norm(m, f"{pre}/ln2", lead, out)
    if kind == "dec":
        out[f"{pre}/mlp/w_gate"] = (lead + (d, f), "normal")
        out[f"{pre}/mlp/w_up"] = (lead + (d, f), "normal")
        out[f"{pre}/mlp/w_down"] = (lead + (f, d), "normal")
    else:
        out[f"{pre}/mlp/w_up"] = (lead + (d, f), "normal")
        out[f"{pre}/mlp/b_up"] = (lead + (f,), "zeros")
        out[f"{pre}/mlp/w_down"] = (lead + (f, d), "normal")
        out[f"{pre}/mlp/b_down"] = (lead + (d,), "zeros")
    if kind == "xdec":
        _norm(m, f"{pre}/lnx", lead, out)
        _attn(m, f"{pre}/xattn", lead, out)


def shapes(m: dict) -> Dict[str, tuple]:
    """{path: (shape, init)} of the configuration's ``model`` dict."""
    out: Dict[str, tuple] = {}
    d = m["d_model"]
    out["embed"] = ((m["vocab"], d), "normal")
    _norm(m, "ln_f", (), out)
    _block(m, f"stages/s0_{m['kind']}", m["n_layers"], m["kind"], out)
    if not m["tie_embeddings"]:
        out["lm_head"] = ((m["vocab"], d), "normal")
    if m["enc_layers"]:
        out["encoder/pos"] = ((m["enc_seq"], d), "normal")
        _block(m, "encoder/stack", m["enc_layers"], "enc", out)
        _norm(m, "encoder/ln_f", (), out)
    return out


def leaf_seed(seed: int, path: str) -> int:
    h = hashlib.sha256(f"{int(seed)}:{path}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def randn(shape, seed: int, tag: str, device, dtype=torch.float32,
          std: float = 1.0) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, tag))
    return torch.randn(shape, generator=gen, device=device,
                       dtype=dtype).mul_(std)


def randint(high: int, shape, seed: int, tag: str, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, tag))
    return torch.randint(0, high, shape, generator=gen, device=device,
                         dtype=torch.int64).to(torch.int32)


def draw_leaf(m: dict, path: str, seed: int, device,
              dtype=torch.float32) -> torch.Tensor:
    shape, init = shapes(m)[path]
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    return randn(shape, seed, path, device, dtype, m["init_std"])


def _put(tree: dict, path: str, leaf) -> None:
    *head, last = path.split("/")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = leaf


def get_path(tree: dict, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def tree_paths(m: dict):
    return list(shapes(m))


def draw_tree(m: dict, seed: int, device, dtype=torch.float32) -> dict:
    """The whole weight tree as nested dicts, leaves in ``dtype``."""
    tree: dict = {}
    for path in shapes(m):
        _put(tree, path, draw_leaf(m, path, seed, device, dtype))
    return tree
