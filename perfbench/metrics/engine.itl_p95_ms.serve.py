"""The 95th percentile of every gap between consecutive tokens of a
request submitted in the window, both tokens emitted in the window; a
token is stamped when the step that emitted it returns."""

from perfbench.harness.work import percentile


def read(run):
    close = run["window"]["t_close"]
    v = []
    for r in run["requests"]:
        s = [t for t in r["stamps"] if t <= close]
        v += [(b - a) * 1e3 for a, b in zip(s, s[1:])]
    return percentile(v, 95.0) if v else None
