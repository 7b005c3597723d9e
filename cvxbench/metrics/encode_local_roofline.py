"""encode_local_roofline (%, device trace): the least time of a local-RMS
encode over its device time (`device_ms.encode_local`).

Counted for the function, whatever kernels implement it: the volume read
once (4 B a cell) at HBM_BPS; the forward 7/9 cascade's float32 FLOP
(`roofline.cascade_flops` on each axis of every whole block) at F32_FLOPS,
plus each block's float64 sum of squares (a multiply and an add a cell) at
F64_FLOPS, the H100 SXM's float64 peak off the tensor cores at 700 W.  The
least time is the larger of the bytes' time and the FLOP's."""

from cvxbench.harness import readers, roofline, spec

F64_FLOPS = 34e12


def least_time(shape, block):
    """Seconds of one local encode of a (nz, ny, nx) volume at `block`."""
    nz, ny, nx = shape
    cells = roofline.block_cells(shape, block)
    f32 = cells * sum(roofline.cascade_flops(n) for n in block if n > 1)
    tf = f32 / roofline.F32_FLOPS + 2 * cells / F64_FLOPS
    return max(4 * nz * ny * nx / roofline.HBM_BPS, tf)


def read(run):
    ms = readers.device_ms(run, "compress", spec.load_metric("device_ms.encode_local").STAGES)
    if not ms:
        return None
    return 100.0 * least_time(run.shape, run.block) / (ms / 1e3)
