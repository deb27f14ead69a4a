"""The fused PPA activation kernel's share of its memory roofline in the
traced training steps: the bytes the gated activation needs (each bf16
input read once, each output written once: the MLP's d_ff wide hidden of
every token of every layer, the encoder's frames included) over 3.35 TB/s,
against the device time of the kernels named below, in percent."""

from perfbench.harness.work import HBM_BPS

PATTERNS = ("ppa_fused_kernel",)
ITEM = 2   # bfloat16, the configurations' compute dtype


def read(run):
    tr = run["trace"]
    if tr is None:
        return None
    t = sum(b - a for n, a, b in tr["kernels"]
            if any(p in n for p in PATTERNS)) / 1e6
    if t <= 0:
        return None
    m, w = run["model"], run["work"]
    elems = m["d_ff"] * w["rows"] * (m["n_layers"] * w["seq"]
                                     + m["enc_layers"] * w["enc"])
    need = 2 * ITEM * elems * len(tr["steps"])
    return 100.0 * need / HBM_BPS / t
