"""device_ms.rms (ms, device trace): device time a traced compress call of
the kernels and memsets launched directly under the program's span
`cvx.mulfac`: the global RMS's f64 sum on the card (ops/quant.py `sumsq`),
without its read-back, which waits in `cvx.mulfac_wait`."""

from cvxbench.harness import readers

STAGES = ("cvx.mulfac",)


def read(run):
    return readers.device_ms(run, "compress", STAGES)
