"""idle.compress (%, device trace): 1 - device busy time (kernels, copies and
memsets) / wall time over the traced compress calls."""

from cvxbench.harness import readers


def read(run):
    return readers.idle_pct(run, "compress")
