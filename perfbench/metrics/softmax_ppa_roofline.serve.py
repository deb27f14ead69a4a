"""The PPA softmax kernel's share of its memory roofline in the traced
serving steps: for every (query, key) pair the causal mask lets through
(L(L+1)/2 for a prompt of L, the context of a decoded token) and every
query head, the float32 score read and the probability written (8 bytes),
and the mask's byte a pair once; over 3.35 TB/s, against the device time
of the kernels named below, in percent."""

from perfbench.harness.work import HBM_BPS, causal_pairs

PATTERNS = ("softmax_warp_kernel", "softmax_block_kernel")


def read(run):
    tr = run["trace"]
    if tr is None:
        return None
    t = sum(b - a for n, a, b in tr["kernels"]
            if any(p in n for p in PATTERNS)) / 1e6
    if t <= 0:
        return None
    m = run["model"]
    pairs = sum(sum(causal_pairs(n) for n in s["prefill"]) + sum(s["decode"])
                for s in tr["steps"])
    need = m["n_layers"] * pairs * (8 * m["n_q"] + 1)
    return 100.0 * need / HBM_BPS / t
