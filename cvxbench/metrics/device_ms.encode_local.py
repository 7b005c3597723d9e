"""device_ms.encode_local (ms, device trace): device time a traced compress
call of the kernels and memsets launched under the encode stages that
`device_ms.encode` reads, in a local-RMS cell: at 32^3 `fused_encode_local`
(ops/tokenize.py, csrc/fused_encode.cu), which sums each block's squares in
float64 and scales it by its own mulfac.  A local compress launches nothing
under `cvx.mulfac`."""

from cvxbench.harness import readers, spec

STAGES = spec.load_metric("device_ms.encode").STAGES


def read(run):
    return readers.device_ms(run, "compress", STAGES)
