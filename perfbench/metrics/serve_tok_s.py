"""Tokens the engine emitted in the window (first tokens and decoded
tokens, of every request) over the window."""


def read(run):
    if not run["steps"]:
        return None
    w = run["window"]
    n = sum(len(s["prefill"]) + len(s["decode"]) for s in run["steps"])
    return n / (w["t_close"] - w["t_open"])
