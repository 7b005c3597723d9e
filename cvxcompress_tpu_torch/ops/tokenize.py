"""The compress kernel: 32^3 forward wavelet + scale + tokenize (K1 and K9
port).

`fused_encode` launches csrc/fused_encode.cu on a CUDA volume and runs
`fused_encode_plain` on a CPU volume.  Both return, for the (nnn) 32^3
blocks in raster order:

    coeffs  (nnn, 32768) f32   UNSCALED wavelet coefficients, block-major
    desc    (nnn, 32768) int32 per-cell token descriptor (ops/rle_device.py)
    sizes   (nnn,) int32       payload bytes per block (4*cells when raw)
    raw     (nnn,) bool        raw-fallback flag
    mulfacs (nnn,) f32         the mulfac each block was quantized with

Under the global RMS every block has the given mulfac; under the local RMS
each block's comes from its own coefficients (ops/quant.py `local_rms`),
and the kernel launches as `fused_encode_local`.

TPU counterpart: `cvxcompress_tpu/ops/tokenize_pallas.py`
`stripe_fused_encode` (:1056), whose kernel is `stripe_fused_tiles` (:939;
the local branch `_kernel_stripe_fused_local` :907).
"""

from __future__ import annotations

import torch

from . import _kernels, blocks, quant, rle_device, wavelet

BLOCK = (32, 32, 32)
CELLS = 32 * 32 * 32


def scaled(coeffs, mulfac):
    """fv = coeffs * mulfac in f32, one rounding (oracle/rle.py:63); `mulfac`
    is one number or one per row of `coeffs`."""
    m = torch.as_tensor(mulfac, dtype=torch.float32, device=coeffs.device)
    return coeffs * (m[:, None] if m.dim() else m)


def fused_encode_plain(vol, mulfac=None, *, scale=None):
    """Plain PyTorch version of the kernel (same outputs)."""
    local = quant.is_local(mulfac, scale)
    coeffs = wavelet.forward_blocks(blocks.to_blocks(vol, BLOCK))
    coeffs = coeffs.reshape(-1, CELLS)
    if local:
        mulfacs = quant.mulfac_from_rms(quant.local_rms(coeffs), scale)
    else:
        mulfacs = torch.full((coeffs.shape[0],), mulfac, dtype=torch.float32,
                             device=coeffs.device)
    desc, sizes, raw = rle_device.tokenize(scaled(coeffs, mulfacs))
    return coeffs, desc, sizes, raw, mulfacs


def fused_encode(vol, mulfac=None, *, scale=None):
    """(nz, ny, nx) f32 volume -> (coeffs, desc, sizes, raw, mulfacs); see
    the module doc.  Global RMS: every block at `mulfac`.  Local RMS: give
    `scale` instead, and each block's mulfac is 1/(rms*scale) of its own
    coefficients."""
    local = quant.is_local(mulfac, scale)
    if vol.device.type == "cpu":
        return fused_encode_plain(vol, mulfac, scale=scale)
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
    mulfacs = torch.empty((nnn,), dtype=torch.float32, device=dev)
    _kernels.launch(
        "fused_encode_local" if local else "fused_encode",
        vol.data_ptr(), nx, ny, nz, op.data_ptr(), float(scale if local else mulfac),
        coeffs.data_ptr(), desc.data_ptr(), sizes.data_ptr(), raw.data_ptr(),
        mulfacs.data_ptr(),
    )
    return coeffs, desc, sizes, raw, mulfacs
