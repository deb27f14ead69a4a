"""The plain reference of the benchmark's configurations, in float32 torch.

It follows the configuration file, not the program: a decoder of ``dec``
blocks (internlm2: RMSNorm, RoPE, grouped-query attention under a causal
mask, a SwiGLU MLP, an untied head) or whisper's encoder-decoder
(LayerNorm with bias, an encoder of bidirectional blocks on frame
embeddings standardised per frame plus learned positions, a decoder of
self-attention, cross attention and a biased GELU MLP, the head tied to the
embedding).  Departures from the published models, the configuration's
own: the conv frontend is a stub (the encoder takes frame embeddings), and
self-attention applies RoPE in the encoder and the decoder in place of
whisper's sinusoidal and learned decoder positions.  The activations are
the configuration's PPA tables (``ppa.py``).

No cache, no batching of requests, no kernels: a full forward pass over
whole sequences.  Parameters are the benchmark's tree (``harness/
weights.py``), read as float32.  ``Precision("fp8")`` is the control: every
weight product takes its operands through float8 (e4m3 forward, e5m2
gradients, one scale a tensor).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from . import ppa

__all__ = ["Precision", "Reference", "strict_float32"]


def strict_float32() -> None:
    """Float32 products in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fake8(x: torch.Tensor, dtype) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = amax / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Q8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fake8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fake8(g, torch.float8_e5m2)


@dataclasses.dataclass(frozen=True)
class Precision:
    """``None``: float32 throughout; ``"fp8"``: the control."""

    mode: Optional[str] = None

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return _Q8.apply(x) if self.mode == "fp8" else x


class Reference:
    """The reference model of one configuration file (its ``model`` dict)."""

    def __init__(self, model: dict, device, prec: Precision = Precision()):
        self.m = model
        self.kind = model["kind"]
        self.prec = prec
        self.d, self.hq, self.hk = (model["d_model"], model["n_q"],
                                    model["n_kv"])
        self.dh = model["head_dim"]
        self.theta = float(model.get("rope_theta", 10000.0))
        gate_naf = {"silu": "sigmoid_wide", "gelu": "gelu_inner"}
        self.t_gate = ppa.Table(gate_naf[model["gate"]], device)
        self.t_exp2 = ppa.Table("exp2_frac", device)

    # ------------------------------------------------------------ blocks
    def mm(self, x, w):
        """``x @ w`` over the last axis of x and the first of w."""
        q = self.prec.q
        return torch.tensordot(q(x), q(w.to(torch.float32)),
                               dims=([x.dim() - 1], [0]))

    def norm(self, x, p):
        if self.m["norm"] == "rmsnorm":
            var = torch.mean(x * x, dim=-1, keepdim=True)
            return x * torch.rsqrt(var + 1e-6) * p["scale"].float()
        mu = x.mean(-1, keepdim=True)
        var = torch.square(x - mu).mean(-1, keepdim=True)
        return ((x - mu) * torch.rsqrt(var + 1e-5) * p["scale"].float()
                + p["bias"].float())

    def rope(self, x, pos):
        half = self.dh // 2
        freqs = 1.0 / (self.theta ** (torch.arange(
            0, self.dh, 2, dtype=torch.float64, device=x.device) / self.dh))
        ang = pos.to(torch.float32)[:, None] * freqs.to(torch.float32)
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

    def attn(self, p, x, kv=None, causal=True):
        """Self-attention of x (B, T, D) with RoPE, or cross attention to
        ``kv`` (B, S, D) without it; queries grouped over the KV heads."""
        b, t, _ = x.shape
        src = x if kv is None else kv
        s = src.shape[1]
        q = self.mm(x, p["wq"])                       # (B, T, Hq, Dh)
        k = self.mm(src, p["wk"])
        v = self.mm(src, p["wv"])
        if kv is None:
            pos = torch.arange(t, device=x.device)
            q, k = self.rope(q, pos), self.rope(k, pos)
        g = self.hq // self.hk
        qg = q.reshape(b, t, self.hk, g, self.dh)
        sc = torch.einsum("bthgd,bshd->bhgts", qg, k) / math.sqrt(self.dh)
        if causal and kv is None:
            valid = torch.ones(t, s, dtype=torch.bool,
                               device=x.device).tril()
        else:
            valid = torch.ones(t, s, dtype=torch.bool, device=x.device)
        w = ppa.softmax(self.t_exp2, sc, valid)
        o = torch.einsum("bhgts,bshd->bthgd", w, v).reshape(
            b, t, self.hq, self.dh)
        q8 = self.prec.q
        return torch.tensordot(q8(o), q8(p["wo"].float()),
                               dims=([2, 3], [0, 1]))

    def mlp(self, p, x):
        if "w_gate" in p:
            h = ppa.gate(self.t_gate, self.mm(x, p["w_gate"])) \
                * self.mm(x, p["w_up"])
            return self.mm(h, p["w_down"])
        h = self.mm(x, p["w_up"]) + p["b_up"].float()
        return self.mm(ppa.gate(self.t_gate, h), p["w_down"]) \
            + p["b_down"].float()

    def _dec_layer(self, h, p):
        h = h + self.attn(p["attn"], self.norm(h, p["ln1"]))
        return h + self.mlp(p["mlp"], self.norm(h, p["ln2"]))

    def _enc_layer(self, h, p):
        h = h + self.attn(p["attn"], self.norm(h, p["ln1"]), causal=False)
        return h + self.mlp(p["mlp"], self.norm(h, p["ln2"]))

    def _xdec_layer(self, h, enc, p):
        h = h + self.attn(p["attn"], self.norm(h, p["ln1"]))
        h = h + self.attn(p["xattn"], self.norm(h, p["lnx"]), kv=enc)
        return h + self.mlp(p["mlp"], self.norm(h, p["ln2"]))

    def _run(self, fn, *args):
        """A layer; under autograd recomputed in the backward, so that a
        row's activations fit beside float32 weights, gradients and
        moments."""
        if torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    @staticmethod
    def _layers(stack: dict, n: int):
        def pick(tree, j):
            return {k: (pick(v, j) if isinstance(v, dict) else v[j])
                    for k, v in tree.items()}
        return [pick(stack, j) for j in range(n)]

    # ----------------------------------------------------------- forward
    def encode(self, params, feats):
        enc = params["encoder"]
        f = feats.float()
        mu = f.mean(-1, keepdim=True)
        var = torch.square(f - mu).mean(-1, keepdim=True)
        h = (f - mu) * torch.rsqrt(var + 1e-6) + enc["pos"].float()[
            None, :f.shape[1]]
        for p in self._layers(enc["stack"], self.m["enc_layers"]):
            h = self._run(self._enc_layer, h, p)
        return self.norm(h, enc["ln_f"])

    def hidden(self, params, tokens, feats=None):
        """Final normed hidden (B, T, D) of token rows (B, T)."""
        h = params["embed"][tokens.long()].float()
        stack = params["stages"]["s0_" + self.kind]
        layers = self._layers(stack, self.m["n_layers"])
        if self.kind == "xdec":
            enc = self.encode(params, feats)
            for p in layers:
                h = self._run(self._xdec_layer, h, enc, p)
        else:
            for p in layers:
                h = self._run(self._dec_layer, h, p)
        return self.norm(h, params["ln_f"])

    def head(self, params):
        return params.get("lm_head", params["embed"])

    def logits(self, params, h):
        return self.mm(h, self.head(params).t())

    def nll_sum(self, params, tokens, labels, feats=None):
        """Summed next-token cross entropy of rows (B, T)."""
        h = self.hidden(params, tokens, feats)
        lg = self.logits(params, h)
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
        return torch.sum(lse - gold)
