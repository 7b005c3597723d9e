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
`_decompress_sparse`.
"""

from __future__ import annotations

import torch

from . import _kernels, blocks, wavelet

BLOCK = (32, 32, 32)
CHUNK = 128


def fused_inverse_plain(rows, invmap, vol_shape):
    """Plain PyTorch version of the kernel (same volume)."""
    if invmap is None:
        coeffs = rows.reshape(-1, 32, 32, 32)
        return blocks.from_blocks(wavelet.inverse_blocks(coeffs), vol_shape, BLOCK)
    padded = torch.cat([rows, rows.new_zeros((1, CHUNK))])
    n = rows.shape[0]
    idx = invmap.to(torch.int64)
    idx = torch.where((idx < 0) | (idx > n), n, idx)
    coeffs = padded[idx].reshape(-1, 32, 32, 32)
    return blocks.from_blocks(wavelet.inverse_blocks(coeffs), vol_shape, BLOCK)


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
    op = wavelet.operator(32, inverse=True, device=rows.device)
    vol = torch.empty(vol_shape, dtype=torch.float32, device=rows.device)
    _kernels.launch(
        "fused_inverse", rows.data_ptr(), rows.shape[0],
        None if invmap is None else invmap.data_ptr(),
        op.data_ptr(), nx, ny, nz, vol.data_ptr(),
    )
    return vol
