"""The 95th percentile, over the requests submitted in the window, of the
time from ``submit()`` to the return of the step that emitted the first
token, on the harness's clock."""

from perfbench.harness.work import percentile


def read(run):
    v = [(r["stamps"][0] - r["t_submit"]) * 1e3 for r in run["requests"]
         if r["stamps"]]
    return percentile(v, 95.0) if v else None
