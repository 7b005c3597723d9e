"""compress_roofline (%, device trace): the least time of the traced compress
calls (harness/roofline.py: the volume read once, the container written
once, the forward cascade's FLOP, against the H100's published peaks) over
the device time of every kernel and memset they launched."""

from cvxbench.harness import readers


def read(run):
    return readers.roofline_pct(run, "compress")
