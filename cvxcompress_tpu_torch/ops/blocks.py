"""Volume <-> block-major layout (the reference's Block_Copy).

Copy_To_Block (Block_Copy.cpp:21-116) gathers a block and zero-pads the
partial edge blocks; Copy_From_Block (:136-212) scatters it back, clipped at
the volume edges.  Block index order is the reference raster order
ib = (iz*nby + iy)*nbx + ix (CvxCompress.cpp:321-328).  Counterparts:
`cvxcompress_tpu/ops/blocks.py`, `cvxcompress_tpu/oracle/codec.py:44-69`.
"""

from __future__ import annotations

import torch.nn.functional as F


def grid_shape(vol_shape, block):
    """(nbz, nby, nbx) ceil-div block counts of a (nz, ny, nx) volume."""
    (nz, ny, nx), (bx, by, bz) = vol_shape, block
    return (-(-nz // bz), -(-ny // by), -(-nx // bx))


def to_blocks(vol, block):
    """(nz, ny, nx) volume -> (nnn, bz, by, bx) zero-padded block batch."""
    bx, by, bz = block
    nz, ny, nx = vol.shape
    nbz, nby, nbx = grid_shape(vol.shape, block)
    v = F.pad(vol, (0, nbx * bx - nx, 0, nby * by - ny, 0, nbz * bz - nz))
    v = v.reshape(nbz, bz, nby, by, nbx, bx).permute(0, 2, 4, 1, 3, 5)
    return v.reshape(nbz * nby * nbx, bz, by, bx).contiguous()


def from_blocks(blocks, vol_shape, block):
    """(nnn, bz, by, bx) block batch -> (nz, ny, nx) volume, clipped."""
    bx, by, bz = block
    nz, ny, nx = vol_shape
    nbz, nby, nbx = grid_shape(vol_shape, block)
    v = blocks.reshape(nbz, nby, nbx, bz, by, bx).permute(0, 3, 1, 4, 2, 5)
    v = v.reshape(nbz * bz, nby * by, nbx * bx)
    return v[:nz, :ny, :nx].contiguous()
