"""decompress_roofline (%, device trace): the least time of the traced
decompress calls (the container read once, the volume written once, the
inverse cascade's FLOP) over the device time of every kernel and memset
they launched."""

from cvxbench.harness import readers


def read(run):
    return readers.roofline_pct(run, "decompress")
