"""host_ms.compress (ms, program span): host time of the program's span
`cvx.assemble` (ops/codec.py `_assemble`, ops/rle_device.py, container.py)
a traced compress call."""

from cvxbench.harness import readers

SPAN = "cvx.assemble"


def read(run):
    return readers.span_ms(run, "compress", SPAN)
