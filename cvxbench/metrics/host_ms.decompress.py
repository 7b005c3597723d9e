"""host_ms.decompress (ms, program span): host time of the program's span
`cvx.plan` (ops/entropy_decode.py `plan`) a traced decompress call."""

from cvxbench.harness import readers

SPAN = "cvx.plan"


def read(run):
    return readers.span_ms(run, "decompress", SPAN)
