"""device_ms.emit (ms, device trace): device time a traced compress call of
the kernels and memsets launched under the program's emit spans (ops/pack.py)."""

from cvxbench.harness import readers

STAGES = ("cvx.chunk_bases", "cvx.emit_chunks", "cvx.emit_rows", "cvx.patch_extract")


def read(run):
    return readers.device_ms(run, "compress", STAGES)
