"""The 128^3 compress kernel: whole-block forward wavelet + scale + tokenize
(K6 port).

`block_encode` launches csrc/block_encode.cu on a CUDA volume and runs
`block_encode_plain` on a CPU volume.  Both return, for the (nnn) 128^3
blocks in raster order:

    coeffs      (nnn, 2^21) f32    UNSCALED wavelet coefficients, block-major
                                   (z, y, x inside a block)
    desc        (nnn, 2^21) int32  per-cell token descriptor (ops/rle_device.py)
    chunk_bytes (nnn*16384,) int32 payload bytes per 128-cell chunk (0 in a
                                   raw-fallback block)
    sizes       (nnn,) int32       payload bytes per block (4*cells when raw)
    raw         (nnn,) bool        raw-fallback flag

the contract of ops/tokenize.py `fused_encode` plus `chunk_bytes`, as the
JAX `tokenize_desc_block` returns it, except that the coefficients are
unscaled (raw blocks store them; the emit kernel rescales).

TPU counterpart: `cvxcompress_tpu/ops/fused_compress.py`
`tokenize_block_fused` (:422), global branch, kernel `_kernel_block` (:291).
"""

from __future__ import annotations

import torch

from . import _kernels, blocks, rle_device, wavelet
from .tokenize import scaled

B = 128
BLOCK = (B, B, B)
CELLS = B ** 3
CHUNK = 128


def fused_path_ok(vol_shape, block):
    """(128, 128, 128) blocks over block-aligned volume dims (the JAX gate,
    `fused_compress.py:49-56`)."""
    return tuple(block) == BLOCK and all(n % B == 0 for n in vol_shape)


def _finish(desc, chunk_bytes, sizes):
    """The raw-fallback decision on the block sums (XLA in the JAX package,
    `fused_compress.py:613-617`)."""
    raw = sizes > rle_device.RAW_BYTES_PER_CELL * CELLS
    sizes = torch.where(raw, rle_device.RAW_BYTES_PER_CELL * CELLS, sizes)
    chunk_bytes.view(raw.shape[0], -1).masked_fill_(raw[:, None], 0)
    return desc, chunk_bytes, sizes, raw


def tokenize_plain(fv):
    """The kernel's tokenize stage, plain: PRE-SCALED block-major (nnn, 2^21)
    coefficients -> (desc, chunk_bytes, sizes, raw)."""
    desc, _, _ = rle_device.tokenize(fv)
    chunk_bytes = (desc & 7).view(-1, CHUNK).sum(1, dtype=torch.int32)
    sizes = chunk_bytes.view(fv.shape[0], -1).sum(1, dtype=torch.int32)
    return _finish(desc, chunk_bytes, sizes)


def fwd_z_plain(vol):
    """Plain version of pass 1: the z cascade of every block, block-major."""
    op = wavelet.operator(B, inverse=False, device=vol.device)
    t = torch.einsum("nzyx,Zz->nZyx", blocks.to_blocks(vol, BLOCK), op)
    return t.reshape(-1, CELLS).contiguous()


def encode_xy_plain(tmp, mulfac):
    """Plain version of pass 2: the x, then y cascade and the tokenize."""
    op = wavelet.operator(B, inverse=False, device=tmp.device)
    t = torch.einsum("nzyx,Xx->nzyX", tmp.view(-1, B, B, B), op)
    coeffs = torch.einsum("nzyx,Yy->nzYx", t, op).reshape(-1, CELLS).contiguous()
    return (coeffs, *tokenize_plain(scaled(coeffs, mulfac)))


def block_encode_plain(vol, mulfac):
    """Plain PyTorch version of the kernel (same outputs; the kernel's axis
    order z, x, y, as the JAX `_kernel_block`)."""
    return encode_xy_plain(fwd_z_plain(vol), mulfac)


def fwd_z(vol):
    """Pass 1 (kernel `block_fwd_z`): the z cascade of every block, into a
    block-major (nnn, 2^21) f32 buffer.  Dims must be multiples of 128."""
    if vol.dim() != 3 or not fused_path_ok(vol.shape, BLOCK):
        raise ValueError(f"the 128^3 encode needs (nz, ny, nx) multiples of {B}, "
                         f"got {tuple(vol.shape)}")
    if vol.device.type == "cpu":
        return fwd_z_plain(vol)
    _kernels.check_cuda(vol, dtypes=(torch.float32,))
    nz, ny, nx = vol.shape
    nnn = (nz // B) * (ny // B) * (nx // B)
    tmp = torch.empty((nnn, CELLS), dtype=torch.float32, device=vol.device)
    op = wavelet.operator(B, inverse=False, device=vol.device)
    _kernels.launch("block_fwd_z", vol.data_ptr(), nx, ny, nz, op.data_ptr(),
                    tmp.data_ptr())
    return tmp


def encode_xy(tmp, mulfac, out=None):
    """Pass 2 (kernel `block_encode_xy`): the x and y cascades and the
    tokenize of every z-slice -> (coeffs, desc, chunk_bytes, sizes, raw).

    The kernel writes the coefficients into `out`, by default in place over
    `tmp` (each CTA holds its slice in shared memory before it writes).
    """
    if tmp.device.type == "cpu":
        return encode_xy_plain(tmp, mulfac)
    _kernels.check_cuda(tmp, dtypes=(torch.float32,))
    nnn = tmp.shape[0]
    dev = tmp.device
    coeffs = tmp if out is None else out
    _kernels.check_cuda(coeffs, dtypes=(torch.float32,))
    if tmp.shape != (nnn, CELLS) or coeffs.shape != tmp.shape:
        raise ValueError(f"encode_xy takes (nnn, {CELLS}) buffers, got "
                         f"{tuple(tmp.shape)} and {tuple(coeffs.shape)}")
    op = wavelet.operator(B, inverse=False, device=dev)
    scratch = torch.empty(1 + nnn * B, dtype=torch.int32, device=dev)
    desc = torch.empty((nnn, CELLS), dtype=torch.int32, device=dev)
    chunk_bytes = torch.empty(nnn * (CELLS // CHUNK), dtype=torch.int32, device=dev)
    sizes = torch.empty(nnn, dtype=torch.int32, device=dev)
    _kernels.launch(
        "block_encode_xy", tmp.data_ptr(), op.data_ptr(), float(mulfac), nnn,
        scratch.data_ptr(), coeffs.data_ptr(), desc.data_ptr(),
        chunk_bytes.data_ptr(), sizes.data_ptr(),
    )
    return (coeffs, *_finish(desc, chunk_bytes, sizes))


def block_encode(vol, mulfac):
    """(nz, ny, nx) f32 volume -> (coeffs, desc, chunk_bytes, sizes, raw);
    see the module doc.  Dims must be multiples of 128 (`fused_path_ok`)."""
    return encode_xy(fwd_z(vol), mulfac)
