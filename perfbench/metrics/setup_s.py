"""Set-up: from the process's start to the window's open (imports, the
kernels' build where it is not cached, weights, warm-up, the check's
first steps), on the host clock."""


def read(run):
    return run["setup_s"]
