"""Median wall time of the window's engine steps that admitted nothing:
the harness's span around ``ServeEngine.step()``."""

from perfbench.harness.work import median


def read(run):
    v = [(s["t1"] - s["t0"]) * 1e3 for s in run["steps"]
         if s.get("admitted") == 0]
    return median(v) if v else None
