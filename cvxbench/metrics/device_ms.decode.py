"""device_ms.decode (ms, device trace): device time a traced decompress call
of the kernels and memsets launched under the program's entropy-decode
spans (ops/entropy_decode.py), the decode's zeroing included."""

from cvxbench.harness import readers

STAGES = ("cvx.decode_maps", "cvx.decode_chase", "cvx.decode_emit", "cvx.overlay_raw")


def read(run):
    return readers.device_ms(run, "decompress", STAGES)
