"""The PPA softmax kernels' share of their memory roofline in the traced
training steps, forward and backward together: for every (query, key)
pair a mask lets through and every head, the forward reads the float32
score and writes the float32 probability (8 bytes), the backward reads
the score and the gradient and writes the score's gradient (12 bytes);
each reads the mask's byte a pair once.  Over 3.35 TB/s, against the
device time of the kernels named below, in percent."""

from perfbench.harness.work import HBM_BPS, causal_pairs

PATTERNS = ("softmax_warp_kernel", "softmax_block_kernel",
            "softmax_bwd_row_kernel", "softmax_bwd_warp_kernel",
            "softmax_bwd_block_kernel")


def read(run):
    tr = run["trace"]
    if tr is None:
        return None
    t = sum(b - a for n, a, b in tr["kernels"]
            if any(p in n for p in PATTERNS)) / 1e6
    if t <= 0:
        return None
    m, w = run["model"], run["work"]
    pairs = m["n_layers"] * causal_pairs(w["seq"])
    if m["kind"] == "xdec":
        pairs += (m["enc_layers"] * w["enc"] ** 2
                  + m["n_layers"] * w["seq"] * w["enc"])
    need = w["rows"] * pairs * (20 * m["n_q"] + 2) * len(tr["steps"])
    return 100.0 * need / HBM_BPS / t
