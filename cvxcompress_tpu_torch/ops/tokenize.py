"""The compress kernel: 32^3 forward wavelet + scale + tokenize (K1 port).

`fused_encode` launches csrc/fused_encode.cu on a CUDA volume and runs
`fused_encode_plain` on a CPU volume.  Both return, for the (nnn) 32^3
blocks in raster order:

    coeffs (nnn, 32768) f32   UNSCALED wavelet coefficients, block-major
    desc   (nnn, 32768) int32 per-cell token descriptor (ops/rle_device.py)
    sizes  (nnn,) int32       payload bytes per block (4*cells when raw)
    raw    (nnn,) bool        raw-fallback flag

TPU counterpart: `cvxcompress_tpu/ops/tokenize_pallas.py`
`stripe_fused_encode` (:1056), whose kernel is `stripe_fused_tiles` (:939).
"""

from __future__ import annotations

import torch

from . import _kernels, blocks, rle_device, wavelet

BLOCK = (32, 32, 32)
CELLS = 32 * 32 * 32


def scaled(coeffs, mulfac):
    """fv = coeffs * mulfac in f32, one rounding (oracle/rle.py:63)."""
    return coeffs * torch.tensor(mulfac, dtype=torch.float32, device=coeffs.device)


def fused_encode_plain(vol, mulfac):
    """Plain PyTorch version of the kernel (same outputs)."""
    coeffs = wavelet.forward_blocks(blocks.to_blocks(vol, BLOCK))
    coeffs = coeffs.reshape(-1, CELLS)
    desc, sizes, raw = rle_device.tokenize(scaled(coeffs, mulfac))
    return coeffs, desc, sizes, raw


def fused_encode(vol, mulfac):
    """(nz, ny, nx) f32 volume -> (coeffs, desc, sizes, raw); see module doc."""
    if vol.device.type == "cpu":
        return fused_encode_plain(vol, mulfac)
    _kernels.check_cuda(vol, dtypes=(torch.float32,))
    nz, ny, nx = vol.shape
    nbz, nby, nbx = blocks.grid_shape(vol.shape, BLOCK)
    nnn = nbz * nby * nbx
    dev = vol.device
    op = wavelet.operator(32, inverse=False, device=dev)
    coeffs = torch.empty((nnn, CELLS), dtype=torch.float32, device=dev)
    desc = torch.empty((nnn, CELLS), dtype=torch.int32, device=dev)
    sizes = torch.empty((nnn,), dtype=torch.int32, device=dev)
    raw = torch.empty((nnn,), dtype=torch.bool, device=dev)
    _kernels.launch(
        "fused_encode", vol.data_ptr(), nx, ny, nz, op.data_ptr(), float(mulfac),
        coeffs.data_ptr(), desc.data_ptr(), sizes.data_ptr(), raw.data_ptr(),
    )
    return coeffs, desc, sizes, raw
