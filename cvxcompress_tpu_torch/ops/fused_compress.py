"""The 128^3 compress kernels: whole-block forward wavelet + scale +
tokenize (K6 port; the local RMS, K10a, K10b and K11).

`block_encode` launches csrc/block_encode.cu (and under the local RMS
csrc/block_encode_local.cu) on a CUDA volume and runs `block_encode_plain`
on a CPU volume.  Both return, for the (nnn) 128^3 blocks in raster order:

    coeffs      (nnn, 2^21) f32    UNSCALED wavelet coefficients, block-major
                                   (z, y, x inside a block)
    desc        (nnn, 2^21) int32  per-cell token descriptor (ops/rle_device.py)
    chunk_bytes (nnn*16384,) int32 payload bytes per 128-cell chunk (0 in a
                                   raw-fallback block)
    sizes       (nnn,) int32       payload bytes per block (4*cells when raw)
    raw         (nnn,) bool        raw-fallback flag
    mulfacs     (nnn,) f32         the mulfac each block was quantized with

the contract of ops/tokenize.py `fused_encode` plus `chunk_bytes`, as the
JAX `tokenize_desc_block` returns it, except that the coefficients are
unscaled (raw blocks store them; the emit kernel rescales).

Global RMS: `fwd_z` (kernel `block_fwd_z`, the z cascade) and `encode_xy`
(`block_encode_xy`, the x and y cascades and the tokenize).  Local RMS: a
block's mulfac needs all its coefficients before any slice is tokenized, so
after `fwd_z` come `casc_local` (`block_casc_local`: the x and y cascades
and one f64 sum of squares per z-slice) and `scale_tok` (`block_scale_tok`:
the block's mulfac from its 128 slice sums, then the tokenize).

TPU counterpart: `cvxcompress_tpu/ops/fused_compress.py`
`tokenize_block_fused` (:422): the global branch, kernel `_kernel_block`
(:291); the local branch, `_kernel_block_casc_local` (:312) and
`_kernel_scale_tok` (:395), or `_kernel_block_local1` (:361) in one kernel.

`block_encode_w` (csrc/block_encode_w.cu; the encode under
`CVX_FUSED_W=1`, ops/geometry.py) splits the same encode at x,z | y
instead of z | x,y, as the JAX package's two-kernel path does: `fwd_xz`
(kernel `block_fwd_xz`, K16a `forward_xz` :71: the z, then the x cascade,
into a volume-order (nz, ny, nx) plane) and `encode_y` (`block_encode_y`,
K16b `tokenize_fused_y` :144: the y cascade and the tokenize of every
z-slice).  Same axis order, same per-line cascades, so its coefficients
and descriptors equal `block_encode`'s bit for bit; the same outputs.

Every pass runs the multi-level 7/9 cascade along its axis, on the card
(csrc/block_common.cuh `cascade_lines`) and in the plain versions
(`wavelet.cascade`) with the same f32 operations in the same order, so
kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import torch

from . import _kernels, blocks, quant, rle_device, wavelet
from .tokenize import raw_fallback, tokenize_blocks_plain

B = 128
BLOCK = (B, B, B)
CELLS = B ** 3
CHUNK = 128
SLICES, THREADS = quant.SUMSQ_ORDER[CELLS]  # one CTA of 256 threads per z-slice


def fused_path_ok(vol_shape, block):
    """(128, 128, 128) blocks over block-aligned volume dims (the JAX gate,
    `fused_compress.py:49-56`)."""
    return tuple(block) == BLOCK and all(n % B == 0 for n in vol_shape)


def fwd_z_plain(vol):
    """Plain version of pass 1: the z cascade of every block, block-major."""
    t = wavelet.cascade(blocks.to_blocks(vol, BLOCK), 1, inverse=False)
    return t.reshape(-1, CELLS)


def _xy_plain(tmp):
    t = wavelet.cascade(tmp.view(-1, B, B, B), 3, inverse=False)
    return wavelet.cascade(t, 2, inverse=False).reshape(-1, CELLS)


def encode_xy_plain(tmp, mulfac):
    """Plain version of pass 2: the x, then y cascade and the tokenize."""
    coeffs = _xy_plain(tmp)
    return (coeffs, *tokenize_blocks_plain(coeffs, mulfac),
            torch.full((coeffs.shape[0],), mulfac, dtype=torch.float32,
                       device=coeffs.device))


def casc_local_plain(tmp):
    """Plain version of `casc_local`: (coeffs, partials (nnn, 128) f64)."""
    coeffs = _xy_plain(tmp)
    partials = quant.cta_sumsq(coeffs.view(-1, CELLS // SLICES), THREADS)
    return coeffs, partials.view(-1, SLICES)


def scale_tok_plain(coeffs, partials, scale):
    """Plain version of `scale_tok`: (desc, chunk_bytes, sizes, raw,
    mulfacs)."""
    mulfacs = quant.mulfac_from_rms(quant.rms_of_partials(partials, CELLS), scale)
    return (*tokenize_blocks_plain(coeffs, mulfacs), mulfacs)


def block_encode_plain(vol, mulfac=None, *, scale=None):
    """Plain PyTorch version of the kernels (same outputs; the kernels' axis
    order z, x, y, as the JAX `_kernel_block`)."""
    local = quant.is_local(mulfac, scale)
    tmp = fwd_z_plain(vol)
    if local:
        coeffs, partials = casc_local_plain(tmp)
        return (coeffs, *scale_tok_plain(coeffs, partials, scale))
    return encode_xy_plain(tmp, mulfac)


def fwd_xz_plain(vol):
    """Plain version of `fwd_xz`: the z, then the x cascade of every block,
    in volume order."""
    nz, ny, nx = vol.shape
    t = wavelet.cascade(vol.reshape(nz // B, B, ny, nx), 1, inverse=False)
    return wavelet.cascade(t.view(nz, ny, nx // B, B), 3, inverse=False).view(nz, ny, nx)


def encode_y_plain(plane, mulfac):
    """Plain version of `encode_y`: the y cascade of the x,z plane, block
    major, then the tokenize."""
    t = wavelet.cascade(blocks.to_blocks(plane, BLOCK), 2, inverse=False)
    coeffs = t.reshape(-1, CELLS)
    return (coeffs, *tokenize_blocks_plain(coeffs, mulfac),
            torch.full((coeffs.shape[0],), mulfac, dtype=torch.float32,
                       device=coeffs.device))


def _check_volume(vol):
    if vol.dim() != 3 or not fused_path_ok(vol.shape, BLOCK):
        raise ValueError(f"the 128^3 encode needs (nz, ny, nx) multiples of {B}, "
                         f"got {tuple(vol.shape)}")


def fwd_xz(vol):
    """K16a (kernel `block_fwd_xz`): the z, then the x cascade of every
    128^3 block -> the (nz, ny, nx) f32 plane, volume order.  Dims must be
    multiples of 128."""
    _check_volume(vol)
    if vol.device.type == "cpu":
        return fwd_xz_plain(vol)
    _kernels.check_cuda(vol, dtypes=(torch.float32,))
    _kernels.check_aligned(vol)
    nz, ny, nx = vol.shape
    plane = torch.empty_like(vol)
    _kernels.launch("block_fwd_xz", vol.data_ptr(), nx, ny, nz, plane.data_ptr())
    return plane


def encode_y(plane, mulfac):
    """K16b (kernel `block_encode_y`): the y cascade of every z-slice of the
    x,z plane, then its tokenize at the global `mulfac` -> (coeffs, desc,
    chunk_bytes, sizes, raw, mulfacs) as `block_encode`'s."""
    _check_volume(plane)
    if plane.device.type == "cpu":
        return encode_y_plain(plane, mulfac)
    _kernels.check_cuda(plane, dtypes=(torch.float32,))
    _kernels.check_aligned(plane)
    nz, ny, nx = plane.shape
    nnn = plane.numel() // CELLS
    coeffs = torch.empty((nnn, CELLS), dtype=torch.float32, device=plane.device)
    scratch, desc, chunk_bytes, sizes, mulfacs = _tokenize_outputs(nnn, plane.device)
    _kernels.launch(
        "block_encode_y", plane.data_ptr(), nx, ny, float(mulfac),
        nnn, scratch.data_ptr(), coeffs.data_ptr(), desc.data_ptr(),
        chunk_bytes.data_ptr(), sizes.data_ptr(), mulfacs.data_ptr(),
    )
    return (coeffs, *raw_fallback(desc, chunk_bytes, sizes), mulfacs)


def block_encode_w(vol, mulfac):
    """The 128^3 encode split at x,z | y (`CVX_FUSED_W=1`, global RMS):
    `fwd_xz`, then `encode_y`; the outputs of `block_encode`."""
    return encode_y(fwd_xz(vol), mulfac)


def fwd_z(vol):
    """Pass 1 (kernel `block_fwd_z`): the z cascade of every block, into a
    block-major (nnn, 2^21) f32 buffer.  Dims must be multiples of 128."""
    _check_volume(vol)
    if vol.device.type == "cpu":
        return fwd_z_plain(vol)
    _kernels.check_cuda(vol, dtypes=(torch.float32,))
    _kernels.check_aligned(vol)
    nz, ny, nx = vol.shape
    nnn = (nz // B) * (ny // B) * (nx // B)
    tmp = torch.empty((nnn, CELLS), dtype=torch.float32, device=vol.device)
    _kernels.launch("block_fwd_z", vol.data_ptr(), nx, ny, nz, tmp.data_ptr())
    return tmp


def _check_slices(tmp, out):
    _kernels.check_cuda(tmp, out, dtypes=(torch.float32, torch.float32))
    _kernels.check_aligned(tmp, out)
    if tmp.dim() != 2 or tmp.shape[1] != CELLS or out.shape != tmp.shape:
        raise ValueError(f"the 128^3 passes take (nnn, {CELLS}) buffers, got "
                         f"{tuple(tmp.shape)} and {tuple(out.shape)}")


def encode_xy(tmp, mulfac, out=None):
    """Pass 2 (kernel `block_encode_xy`): the x and y cascades and the
    tokenize of every z-slice -> (coeffs, desc, chunk_bytes, sizes, raw,
    mulfacs).

    The kernel writes the coefficients into `out`, by default in place over
    `tmp` (each CTA holds its slice in shared memory before it writes).
    """
    if tmp.device.type == "cpu":
        return encode_xy_plain(tmp, mulfac)
    coeffs = tmp if out is None else out
    _check_slices(tmp, coeffs)
    nnn = tmp.shape[0]
    scratch, desc, chunk_bytes, sizes, mulfacs = _tokenize_outputs(nnn, tmp.device)
    _kernels.launch(
        "block_encode_xy", tmp.data_ptr(), float(mulfac), nnn,
        scratch.data_ptr(), coeffs.data_ptr(), desc.data_ptr(),
        chunk_bytes.data_ptr(), sizes.data_ptr(), mulfacs.data_ptr(),
    )
    return (coeffs, *raw_fallback(desc, chunk_bytes, sizes), mulfacs)


def _tokenize_outputs(nnn, dev):
    """The look-back scratch and the tokenize's outputs of nnn blocks; the
    launchers zero what needs it.  The scratch fits both launchers: the
    ticket and a status word a slice (`block_encode_xy`, `block_encode_y`),
    or the ticket, a pad word, a 64-bit mulfac word a block and a status
    word a slice (`block_scale_tok`)."""
    return (torch.empty(2 + 2 * nnn + nnn * B, dtype=torch.int32, device=dev),
            torch.empty((nnn, CELLS), dtype=torch.int32, device=dev),
            torch.empty(nnn * (CELLS // CHUNK), dtype=torch.int32, device=dev),
            torch.empty(nnn, dtype=torch.int32, device=dev),
            torch.empty(nnn, dtype=torch.float32, device=dev))


def casc_local(tmp):
    """Local-RMS pass 2 (kernel `block_casc_local`): the x and y cascades of
    every z-slice -> (coeffs, partials).  On the card the coefficients
    replace `tmp` in place; partials (nnn, 128) f64 holds the sum of
    squares of each (block, z) slice."""
    if tmp.device.type == "cpu":
        return casc_local_plain(tmp)
    _check_slices(tmp, tmp)
    nnn = tmp.shape[0]
    partials = torch.empty((nnn, SLICES), dtype=torch.float64, device=tmp.device)
    _kernels.launch("block_casc_local", tmp.data_ptr(), nnn, partials.data_ptr())
    return tmp, partials


def scale_tok(coeffs, partials, scale):
    """Local-RMS pass 3 (kernel `block_scale_tok`): each block's mulfac from
    its slice sums, then the tokenize of every z-slice -> (desc,
    chunk_bytes, sizes, raw, mulfacs)."""
    if coeffs.device.type == "cpu":
        return scale_tok_plain(coeffs, partials, scale)
    _check_slices(coeffs, coeffs)
    nnn = coeffs.shape[0]
    _kernels.check_cuda(partials, dtypes=(torch.float64,))
    if partials.shape != (nnn, SLICES):
        raise ValueError(f"partials must be ({nnn}, {SLICES}), got "
                         f"{tuple(partials.shape)}")
    scratch, desc, chunk_bytes, sizes, mulfacs = _tokenize_outputs(nnn, coeffs.device)
    _kernels.launch(
        "block_scale_tok", coeffs.data_ptr(), partials.data_ptr(), float(scale),
        nnn, scratch.data_ptr(), desc.data_ptr(), chunk_bytes.data_ptr(),
        sizes.data_ptr(), mulfacs.data_ptr(),
    )
    return (*raw_fallback(desc, chunk_bytes, sizes), mulfacs)


def block_encode(vol, mulfac=None, *, scale=None):
    """(nz, ny, nx) f32 volume -> (coeffs, desc, chunk_bytes, sizes, raw,
    mulfacs); see the module doc.  Global RMS: every block at `mulfac`.
    Local RMS: give `scale` instead (each block's mulfac is 1/(rms*scale)
    of its own coefficients).  Dims must be multiples of 128
    (`fused_path_ok`)."""
    local = quant.is_local(mulfac, scale)
    tmp = fwd_z(vol)
    if local:
        coeffs, partials = casc_local(tmp)
        return (coeffs, *scale_tok(coeffs, partials, scale))
    return encode_xy(tmp, mulfac)
