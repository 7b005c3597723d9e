"""The least time a compress or a decompress can take on one H100.

Counted for the function, whatever kernels implement it, so that no later
fusion or removal of a kernel makes the count stale:

- bytes: a compress reads the volume once (4 B a cell) and writes its
  container once; a decompress reads the container once and writes the
  volume once;
- FLOP: the Antonini 7/9 cascade along each axis of every block, forward
  or inverse, as the short symmetric filters compute it (`cascade_flops`,
  copied from `chip_smoke.py`), over the cells of the whole blocks;
- peaks (NVIDIA's H100 SXM data sheet, at 700 W): 3.35 TB/s of HBM3 and
  67 TFLOP/s in float32 off the tensor cores.  The reference library's
  order of operations forbids fused multiply-adds and tensor cores.

The least time is the larger of bytes / HBM_BPS and FLOP / F32_FLOPS.
"""

from __future__ import annotations

HBM_BPS = 3.35e12
F32_FLOPS = 67e12


def cascade_flops(n, inverse=False):
    """f32 FLOP per sample of one axis' multi-level 7/9 cascade over n
    samples: an analysis lowpass output takes 4 pair adds, 5 multiplies
    and 4 adds (13 FLOP), a highpass one 3, 4 and 3 (10); synthesis swaps
    the two.  The levels are n, n - n // 2, ..., 2."""
    lo, hi = (10, 13) if inverse else (13, 10)
    total, m = 0, n
    while m >= 2:
        total += lo * (m - m // 2) + hi * (m // 2)
        m -= m // 2
    return total / n


def block_cells(shape, block):
    """Cells of the whole blocks that cover a (nz, ny, nx) volume."""
    (nz, ny, nx), (bx, by, bz) = shape, block
    return (-(-nz // bz) * bz) * (-(-ny // by) * by) * (-(-nx // bx) * bx)


def least_time(direction, shape, block, container_bytes):
    """(seconds, "bytes" or "operations") for one call."""
    nz, ny, nx = shape
    nbytes = 4 * nz * ny * nx + int(container_bytes)
    inverse = direction == "decompress"
    flops = block_cells(shape, block) * sum(
        cascade_flops(n, inverse) for n in block if n > 1)
    tb, tf = nbytes / HBM_BPS, flops / F32_FLOPS
    return (tb, "bytes") if tb >= tf else (tf, "operations")
