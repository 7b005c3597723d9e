"""device_ms.inverse (ms, device trace): device time a traced decompress call
of the kernels and memsets launched under the program's inverse spans
(ops/fused_inverse.py, ops/wavelet.py)."""

from cvxbench.harness import readers

STAGES = ("cvx.fused_inverse", "cvx.inverse", "cvx.stripe_fused_inverse",
          "cvx.block_fused_inverse")


def read(run):
    return readers.device_ms(run, "decompress", STAGES)
