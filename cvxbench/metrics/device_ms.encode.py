"""device_ms.encode (ms, device trace): device time a traced compress call
of the kernels and memsets launched under the program's RMS and encode
spans (ops/quant.py, ops/tokenize.py, ops/wavelet.py, ops/fused_compress.py)."""

from cvxbench.harness import readers

STAGES = ("cvx.mulfac", "cvx.fused_encode", "cvx.encode", "cvx.stripe_fused_encode",
          "cvx.block_encode", "cvx.block_encode_w", "cvx.compact_encode")


def read(run):
    return readers.device_ms(run, "compress", STAGES)
