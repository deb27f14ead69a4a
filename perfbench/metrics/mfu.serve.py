"""Model FLOPs of the tokens the window prefilled and decoded (2x the
weight products a token; the head once a prompt and once a decoded token;
attention's score and value products over the pairs the causal mask lets
through: L(L+1)/2 for a prompt of L, the context for a decoded token) over
the window, against the H100's 989 TFLOP/s dense bf16 peak, in percent."""

from perfbench.harness.work import PEAK_BF16, causal_pairs, products


def read(run):
    if not run["steps"]:
        return None
    m, w = run["model"], run["window"]
    p = products(m)
    per_pair = 4.0 * m["n_q"] * m["head_dim"] * m["n_layers"]
    fl = 0.0
    for s in run["steps"]:
        toks = sum(s["prefill"]) + len(s["decode"])
        heads = len(s["prefill"]) + len(s["decode"])
        pairs = sum(causal_pairs(n) for n in s["prefill"]) + sum(s["decode"])
        fl += 2.0 * (p["dec"] * toks + p["head"] * heads) + per_pair * pairs
    return 100.0 * fl / (w["t_close"] - w["t_open"]) / PEAK_BF16
