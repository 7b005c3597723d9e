"""The decompress kernel: chunk-sparse rows -> 32^3 inverse -> volume (K5 port).

`fused_inverse` launches csrc/fused_inverse.cu on CUDA tensors and runs
`fused_inverse_plain` on CPU tensors.  Its input is what the host decode
uploads (ops/codec.py `sparse_chunks`): the non-zero 128-cell chunks of the
block-major coefficients as rows (nrows, 128) f32, and invmap (nnn*256,)
int32 giving each chunk's row, where nrows (or any index past the rows)
stands for an all-zero chunk.

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
    _kernels.check_cuda(rows, invmap, dtypes=(torch.float32, torch.int32))
    nz, ny, nx = vol_shape
    nbz, nby, nbx = blocks.grid_shape(vol_shape, BLOCK)
    if invmap.numel() != nbz * nby * nbx * (32 ** 3 // CHUNK):
        raise ValueError(f"invmap has {invmap.numel()} chunks for {vol_shape}")
    if rows.dim() != 2 or rows.shape[1] != CHUNK:
        raise ValueError(f"rows must be (n, {CHUNK}), got {tuple(rows.shape)}")
    op = wavelet.operator(32, inverse=True, device=rows.device)
    vol = torch.empty(vol_shape, dtype=torch.float32, device=rows.device)
    _kernels.launch(
        "fused_inverse", rows.data_ptr(), rows.shape[0], invmap.data_ptr(),
        op.data_ptr(), nx, ny, nz, vol.data_ptr(),
    )
    return vol
