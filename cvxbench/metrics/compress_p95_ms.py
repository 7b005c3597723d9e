"""compress_p95_ms (ms, host clock): the 95th percentile of the wall times
of all compress calls in the window.  The forward pass waits on each
snapshot's encode, so its tail is what a time step feels."""

from cvxbench.harness import readers


def read(run):
    return readers.p95_ms(run, "compress")
