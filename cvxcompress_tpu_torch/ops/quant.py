"""Global and local RMS and the quantization contract
(`cvxcompress_tpu/ops/quant.py`).

Global RMS (CvxCompress.cpp:73-117): float64 accumulation of the sum of
squares, sqrt, cast to float32, then `container.compute_glob_mulfac`.

Local RMS (CvxCompress.cpp:119-142, 343-348): each block's mulfac comes
from the RMS of its own wavelet coefficients.  The encode kernels sum the
squares in float64, as the native host codec does
(native/cvx_host.cpp:654-656), so the table almost always equals the native
library's bit for bit; f64 adds cost the card nothing beside the
transforms, and a float32 sum over 2^21 cells would drift from native's by
many ulps.  The order of the sum is fixed, with no atomics, and `local_rms`
repeats it exactly, so a kernel's table and its plain version's agree bit
for bit: a CTA's thread t adds the squares of its 64 cells in turn; the
threads' sums meet in a halving tree over each warp's 32 lanes (lane i +
lane i+16, then i + i+8, ...) and the warps' sums in the same tree.  At
32^3 one CTA of 512 threads reduces the block, thread t = 32 w + x the
z-lines (y, x) of y = 2w and 2w + 1 from z = 0 up (`zline_order`, the
cells its registers hold after the z cascade); at 128^3 one CTA of 256
threads reduces each z-slice, thread t its 64 consecutive cells, and the
128 slice sums add in slice order; at the other fused stripe blocks
lane l of a warp adds cell l of each 32-cell segment of its span, the
lanes meet in the halving tree, then the spans and a cluster's CTAs add
in turn (`stripe_rms`).  The JAX package sums in float32 trees; the
tables agree to its own contract between paths, rtol 1e-5.

Quantization (Run_Length_Encode_Slow.cpp:203-207): i = trunc(mulfac * c)
toward zero with x86 cvttps semantics — NaN and values outside the int32
range map to INT32_MIN.  A plain float -> int cast saturates or is
undefined out of range, so the in-range mask is explicit here and in the
CUDA kernels (`cvxcompress_tpu/ops/tokenize_pallas.py:125-129`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import container as ctn

INT32_MIN = -2147483648


def global_rms_host(vol):
    """Reference-exact global RMS of a host volume (float64 accumulation)."""
    v = np.asarray(vol, dtype=np.float32)
    acc = np.sum(np.square(v, dtype=np.float64))
    return np.float32(np.sqrt(acc / v.size))


def global_mulfac(vol, scale):
    """mulfac = 1/(rms*scale) of a (nz, ny, nx) f32 tensor or array.

    Host data takes the reference's exact numpy reduction.  A CUDA tensor
    is reduced on the card, still in float64 (`sumsq`), so only the
    summation order differs from the host's (a last-bit difference in the
    f64 sum, which the f32 cast almost always absorbs) and the volume never
    leaves the card.
    """
    if isinstance(vol, torch.Tensor) and vol.device.type != "cpu":
        return mulfac_from_sumsq(sumsq(vol).item(), vol.numel(), scale)
    host = vol.numpy() if isinstance(vol, torch.Tensor) else vol
    return ctn.compute_glob_mulfac(global_rms_host(host), scale)


def sumsq(vol):
    """The f64 sum of squares of a tensor, on its device (0-dim, not read
    back): what `global_mulfac` reduces a CUDA volume to."""
    return torch.sum(torch.square(vol.to(torch.float64)))


def mulfac_from_sumsq(acc, n, scale):
    """The global mulfac from an f64 sum of squares `acc` over `n` cells."""
    return ctn.compute_glob_mulfac(np.float32(math.sqrt(float(acc) / n)), scale)


# cells per block -> (z-slices reduced by one CTA each, threads of a CTA)
SUMSQ_ORDER = {32 ** 3: (1, 512), 128 ** 3: (128, 256)}


def zline_order(coeffs):
    """Block-major (n, 32768) coefficients of 32^3 blocks in the order the
    32^3 encode kernel's threads hold them (csrc/fused_encode.cu): thread
    t = 32 w + x its z-lines (y, x) of y = 2w, then 2w + 1, each from z = 0
    up, 64 cells a thread, thread after thread."""
    n = coeffs.shape[0]
    return coeffs.view(n, 32, 16, 2, 32).permute(0, 2, 4, 3, 1).reshape(n, -1)


def _halve(x):
    """Pairwise halving tree over the last dim (a power of two)."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def cta_sumsq(rows, threads):
    """f64 sum of squares of each row of (n, m) f32, in one CTA's order
    (module doc): `threads` threads of m / threads consecutive cells."""
    n, m = rows.shape
    sq = rows.to(torch.float64).square().view(n, threads, m // threads)
    acc = torch.zeros((n, threads), dtype=torch.float64, device=rows.device)
    for i in range(sq.shape[2]):
        acc = acc + sq[:, :, i]
    return _halve(_halve(acc.view(n, threads // 32, 32)))


def rms_of_partials(partials, cells):
    """(n, slices) f64 slice sums -> (n,) f32 RMS: the slices add in order,
    then sqrt(sum / cells) in f64, rounded to f32 (as native)."""
    acc = torch.zeros(partials.shape[0], dtype=torch.float64, device=partials.device)
    for k in range(partials.shape[1]):
        acc = acc + partials[:, k]
    return torch.sqrt(acc / cells).to(torch.float32)


def local_rms(coeffs):
    """Per-block RMS of block-major (n, cells) f32 coefficients, in the
    encode kernels' order of summation (module doc): (n,) f32."""
    n, cells = coeffs.shape
    slices, threads = SUMSQ_ORDER[cells]
    if cells == 32 ** 3:
        coeffs = zline_order(coeffs)
    partials = cta_sumsq(coeffs.reshape(n * slices, -1), threads)
    return rms_of_partials(partials.view(n, slices), cells)


STRIPE_TILE = 1 << 14  # cells of a tile of csrc/stripe_fused.cu's tile kernels


def stripe_layout(cells):
    """(ranks, span) of csrc/stripe_fused.cu at blocks of `cells` cells: a
    block of at most STRIPE_TILE cells lies in one CTA of 16 warps, each
    warp's 1,024 cells in spans of min(cells, 1024); a larger one across a
    cluster of min(8, cells / STRIPE_TILE) CTAs (ranks) of 8 warps, a span
    per warp."""
    if cells <= STRIPE_TILE:
        return 1, min(cells, STRIPE_TILE // 16)
    ranks = min(8, cells // STRIPE_TILE)
    return ranks, cells // (ranks * 8)


def stripe_rms(coeffs):
    """Per-block RMS of block-major (n, cells) f32 coefficients in the fused
    stripe kernels' order (csrc/stripe_fused.cu, `stripe_layout`): in each
    span, lane l adds the f64 square of cell 32 j + l of each 32-cell
    segment j in turn, the 32 lanes meet in a halving tree; a CTA's spans
    add in turn, then the cluster's CTAs in rank order; sqrt(sum / cells)
    in f64, rounded to f32.  (n,) f32."""
    n, cells = coeffs.shape
    ranks, span = stripe_layout(cells)
    sq = coeffs.to(torch.float64).square().view(n, cells // span, span // 32, 32)
    acc = torch.zeros((n, cells // span, 32), dtype=torch.float64, device=coeffs.device)
    for j in range(span // 32):
        acc = acc + sq[:, :, j]
    spans = _halve(acc).view(n, ranks, -1)
    parts = torch.zeros((n, ranks), dtype=torch.float64, device=coeffs.device)
    for k in range(spans.shape[2]):
        parts = parts + spans[:, :, k]
    return rms_of_partials(parts, cells)


def block_table(plane, block, mulfac=None, *, scale=None):
    """The (nnn,) f32 mulfac table of the stripe route (ops/geometry.py) from
    its volume-order coefficient plane (nzp, nyp, nxp).  Global RMS:
    `mulfac` for every block.  Local RMS (`scale`): `mulfac_from_rms` of each
    block's RMS, the square root of its f64 sum of squares over its cells,
    rounded to f32 as native's.  The JAX package sums in f32
    (`cvxcompress_tpu/ops/quant.py:36-46`), so no kernel is owed; the tables
    agree to rtol 1e-5."""
    bx, by, bz = block
    nzp, nyp, nxp = plane.shape
    view = plane.view(nzp // bz, bz, nyp // by, by, nxp // bx, bx)
    nnn = view.shape[0] * view.shape[2] * view.shape[4]
    if not is_local(mulfac, scale):
        return torch.full((nnn,), float(mulfac), dtype=torch.float32,
                          device=plane.device)
    ss = view.to(torch.float64).square().sum((1, 3, 5)).reshape(nnn)
    return mulfac_from_rms(torch.sqrt(ss / (bx * by * bz)).to(torch.float32), scale)


def is_local(mulfac, scale):
    """An encode's mode from its arguments: the global RMS takes the one
    `mulfac`, the local RMS the `scale` its blocks' mulfacs derive from;
    exactly one of the two is given."""
    if (mulfac is None) == (scale is None):
        raise ValueError("give the global mulfac, or the scale for the local RMS "
                         "(exactly one)")
    return scale is not None


def mulfac_from_rms(rms, scale):
    """mulfac = 1/(rms*scale) in f32, elementwise, with the guards of
    CvxCompress.cpp:291-295: 1.0 where rms == 0 or the result is not finite
    (a NaN block, an RMS so small the quotient overflows)."""
    one = torch.ones_like(rms)
    mf = one / (rms * torch.tensor(scale, dtype=torch.float32, device=rms.device))
    mf = torch.where(rms == 0.0, one, mf)
    return torch.where(torch.isfinite(mf), mf, one)


def quantize(fv):
    """cvttps(fv): int32 truncation toward zero, INT32_MIN when out of range."""
    in_range = (fv >= -2147483648.0) & (fv < 2147483648.0)
    tr = torch.trunc(torch.where(in_range, fv, torch.zeros_like(fv)))
    return torch.where(
        in_range, tr.to(torch.int32), torch.full_like(fv, INT32_MIN, dtype=torch.int32)
    )
