"""Target tokens of the optimizer steps completed in the window over the
time they took: from the window's open to the end of its last step, each
step ending with its metrics on the host."""


def read(run):
    if not run["steps"]:
        return None
    w = run["window"]
    return sum(s["tokens"] for s in run["steps"]) / (w["t_close"]
                                                      - w["t_open"])
