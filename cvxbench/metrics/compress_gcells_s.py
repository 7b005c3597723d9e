"""compress_gcells_s (Gcells/s, host clock): the cells of all compress calls
in the window over the summed wall time of those calls, every call
counted."""

from cvxbench.harness import readers


def read(run):
    return readers.gcells_per_s(run, "compress")
