"""decompress_gcells_s (Gcells/s, host clock): the cells of all decompress
calls in the window over the summed wall time of those calls, each ending
after torch.cuda.synchronize()."""

from cvxbench.harness import readers


def read(run):
    return readers.gcells_per_s(run, "decompress")
