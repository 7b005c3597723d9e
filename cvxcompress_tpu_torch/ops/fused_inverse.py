"""The decompress kernel: coefficient rows -> 32^3 inverse -> volume (K5 port).

`fused_inverse` launches csrc/fused_inverse.cu on CUDA tensors and runs
`fused_inverse_plain` on CPU tensors.  Its input is the block-major
coefficients as 128-cell rows (nrows, 128) f32, in one of two modes:
- dense (invmap None): rows is the whole (nnn*256, 128) buffer, as the
  device entropy decoder writes it (ops/entropy_decode.py);
- chunk-sparse: what the host decode uploads (ops/codec.py
  `sparse_chunks`), the non-zero chunks only, and invmap (nnn*256,) int32
  giving each chunk's row, where nrows (or any index past the rows) stands
  for an all-zero chunk.

TPU counterpart: `cvxcompress_tpu/ops/fused_inverse.py`
`stripe_fused_inverse` (:128), fed by `ops/codec.py:1068`
`_decompress_sparse`.  Kernel and plain version run the inverse cascade
in the native library's order (x, y, z; `wavelet.cascade_3d`), so the
volume equals native's parity decompress bit for bit.

`block_fused_inverse` (csrc/block_inverse.cu, plain version
`block_fused_inverse_plain`) is the 128^3 inverse (K8 port, counterpart of
`block_fused_inverse` :65): the dense block-major (nnn*16384, 128) buffer
the device entropy decoder writes -> the (nz, ny, nx) volume, dims
multiples of 128.  Kernel and plain version run the multi-level inverse
cascade in the native library's order (x, y, then z; `wavelet.cascade`),
so the volume equals native's parity decompress
(`cvx_decompress_inplace_parity_th`) bit for bit.

`stripe_fused_inverse` (csrc/stripe_fused.cu, plain version
`stripe_fused_inverse_plain`) is K5 at the other blocks of the JAX gate
`stripe_fused_ok` (16^3, (16, 16, 1), ...; ops/geometry.py): the dense
block-major (nnn, cells) coefficients -> the volume, native's parity
inverse cascade (`wavelet.cascade_3d`) bit for bit.
"""

from __future__ import annotations

import math

import torch

from . import _kernels, blocks, geometry, wavelet

BLOCK = (32, 32, 32)
CHUNK = 128
B128 = 128


def fused_inverse_plain(rows, invmap, vol_shape):
    """Plain PyTorch version of the kernel (same volume)."""
    if invmap is None:
        coeffs = rows.reshape(-1, 32, 32, 32)
    else:
        padded = torch.cat([rows, rows.new_zeros((1, CHUNK))])
        n = rows.shape[0]
        idx = invmap.to(torch.int64)
        idx = torch.where((idx < 0) | (idx > n), n, idx)
        coeffs = padded[idx].reshape(-1, 32, 32, 32)
    return blocks.from_blocks(wavelet.cascade_3d(coeffs, inverse=True), vol_shape, BLOCK)


def fused_inverse(rows, invmap, vol_shape):
    """(nz, ny, nx) f32 volume from the sparse chunk rows; see module doc."""
    if rows.device.type == "cpu":
        return fused_inverse_plain(rows, invmap, vol_shape)
    nz, ny, nx = vol_shape
    nbz, nby, nbx = blocks.grid_shape(vol_shape, BLOCK)
    nchunks = nbz * nby * nbx * (32 ** 3 // CHUNK)
    if rows.dim() != 2 or rows.shape[1] != CHUNK:
        raise ValueError(f"rows must be (n, {CHUNK}), got {tuple(rows.shape)}")
    if invmap is None:
        _kernels.check_cuda(rows, dtypes=(torch.float32,))
        if rows.shape[0] != nchunks:
            raise ValueError(f"dense rows hold {rows.shape[0]} chunks, "
                             f"{vol_shape} needs {nchunks}")
    else:
        _kernels.check_cuda(rows, invmap, dtypes=(torch.float32, torch.int32))
        if invmap.numel() != nchunks:
            raise ValueError(f"invmap has {invmap.numel()} chunks for {vol_shape}")
    _kernels.check_aligned(rows)  # 16-byte asynchronous copies
    vol = torch.empty(vol_shape, dtype=torch.float32, device=rows.device)
    _kernels.launch(
        "fused_inverse", rows.data_ptr(), rows.shape[0],
        None if invmap is None else invmap.data_ptr(), nx, ny, nz, vol.data_ptr(),
    )
    return vol


def block_inv_xy_plain(dense, vol_shape):
    """Plain version of pass 1: the x, then y inverse of every block, laid
    out as the volume."""
    t = wavelet.cascade(dense.reshape(-1, B128, B128, B128), 3, inverse=True)
    t = wavelet.cascade(t, 2, inverse=True)
    return blocks.from_blocks(t, vol_shape, (B128,) * 3)


def block_inv_z_plain(vol):
    """Plain version of pass 2: the z inverse of every block."""
    t = wavelet.cascade(blocks.to_blocks(vol, (B128,) * 3), 1, inverse=True)
    return blocks.from_blocks(t, vol.shape, (B128,) * 3)


def block_fused_inverse_plain(dense, vol_shape):
    """Plain PyTorch version of the 128^3 kernel (same volume)."""
    return block_inv_z_plain(block_inv_xy_plain(dense, vol_shape))


def _check_dims(vol_shape):
    if len(vol_shape) != 3 or any(n % B128 for n in vol_shape):
        raise ValueError(f"the 128^3 inverse needs (nz, ny, nx) multiples of "
                         f"{B128}, got {tuple(vol_shape)}")


def block_inv_xy(dense, vol_shape):
    """Pass 1 (kernel `block_inv_xy`): the x and y inverse of every z-slice,
    written to its place in a new (nz, ny, nx) volume."""
    _check_dims(vol_shape)
    nz, ny, nx = vol_shape
    if dense.numel() != nz * ny * nx:
        raise ValueError(f"dense holds {dense.numel()} cells, {tuple(vol_shape)} "
                         f"needs {nz * ny * nx}")
    if dense.device.type == "cpu":
        return block_inv_xy_plain(dense, vol_shape)
    _kernels.check_cuda(dense, dtypes=(torch.float32,))
    _kernels.check_aligned(dense)
    vol = torch.empty(vol_shape, dtype=torch.float32, device=dense.device)
    _kernels.launch("block_inv_xy", dense.data_ptr(), nx, ny, nz, vol.data_ptr())
    return vol


def block_inv_z(vol):
    """Pass 2 (kernel `block_inv_z`): the z inverse of every block, in place
    on a CUDA volume."""
    _check_dims(vol.shape)
    if vol.device.type == "cpu":
        return block_inv_z_plain(vol)
    _kernels.check_cuda(vol, dtypes=(torch.float32,))
    _kernels.check_aligned(vol)
    nz, ny, nx = vol.shape
    _kernels.launch("block_inv_z", nx, ny, nz, vol.data_ptr())
    return vol


def block_fused_inverse(dense, vol_shape):
    """(nz, ny, nx) f32 volume from the dense (nnn*16384, 128) coefficient
    rows of 128^3 blocks (dims multiples of 128); see the module doc."""
    return block_inv_z(block_inv_xy(dense, vol_shape))


def stripe_fused_inverse_plain(dense, vol_shape, block):
    """Plain PyTorch version of the fused stripe inverse (same volume)."""
    bx, by, bz = block
    coeffs = dense.reshape(-1, bz, by, bx)
    return blocks.from_blocks(wavelet.cascade_3d(coeffs, inverse=True), vol_shape, block)


def stripe_fused_inverse(dense, vol_shape, block):
    """(nz, ny, nx) f32 volume from the dense block-major coefficients
    (nnn * cells f32, as the device entropy decoder writes them) of a block
    of the "stripe_fused" route: the x, y, z inverse in one kernel
    (`stripe_fused_inverse`, csrc/stripe_fused.cu).  TPU counterpart:
    `stripe_fused_inverse` (`cvxcompress_tpu/ops/fused_inverse.py:128`)."""
    bx, by, bz = block
    cells = bx * by * bz
    nnn = math.prod(blocks.grid_shape(vol_shape, block))
    if dense.numel() != nnn * cells:
        raise ValueError(f"dense holds {dense.numel()} cells, {tuple(vol_shape)} "
                         f"in {block} blocks needs {nnn * cells}")
    if dense.device.type == "cpu":
        return stripe_fused_inverse_plain(dense, vol_shape, block)
    _kernels.check_cuda(dense, dtypes=(torch.float32,))
    _kernels.check_aligned(dense)  # 16-byte asynchronous copies
    if bx < 8 or by < 8 or cells < 128:
        raise ValueError(f"the fused stripe kernel takes blocks of bx, by >= 8 "
                         f"and >= 128 cells, got {block}")
    dev = dense.device
    nz, ny, nx = vol_shape
    vol = torch.empty(vol_shape, dtype=torch.float32, device=dev)
    _kernels.launch("stripe_fused_inverse", dense.data_ptr(), nx, ny, nz,
                    *geometry.log2_block(block), vol.data_ptr())
    return vol
