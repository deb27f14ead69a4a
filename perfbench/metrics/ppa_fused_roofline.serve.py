"""The fused PPA activation kernel's share of its memory roofline in the
traced serving steps: the bytes the gated activation needs for the
tokens the steps prefilled (each prompt's real length, not its padded
bucket) and decoded (the active requests' tokens), each bf16 input read
once and each output written once, over 3.35 TB/s, against the device
time of the kernels named below, in percent."""

from perfbench.harness.work import HBM_BPS

PATTERNS = ("ppa_fused_kernel",)
ITEM = 2


def read(run):
    tr = run["trace"]
    if tr is None:
        return None
    t = sum(b - a for n, a, b in tr["kernels"]
            if any(p in n for p in PATTERNS)) / 1e6
    if t <= 0:
        return None
    m = run["model"]
    toks = sum(sum(s["prefill"]) + len(s["decode"]) for s in tr["steps"])
    need = 2 * ITEM * m["d_ff"] * m["n_layers"] * toks
    return 100.0 * need / HBM_BPS / t
