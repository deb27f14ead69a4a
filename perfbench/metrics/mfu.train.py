"""Model FLOPs of the window's training steps (``harness/work.py``: 6x the
weight products a token, the head on every target, attention's pairs
under the mask, three times its forward) over the time of those steps,
against the H100's 989 TFLOP/s dense bf16 peak, in percent."""

from perfbench.harness.work import PEAK_BF16, train_flops


def read(run):
    if not run["steps"]:
        return None
    w, wk = run["window"], run["work"]
    fl = train_flops(run["model"], wk["rows"], wk["seq"], wk["enc"])
    return 100.0 * fl * len(run["steps"]) / (
        w["t_close"] - w["t_open"]) / PEAK_BF16
