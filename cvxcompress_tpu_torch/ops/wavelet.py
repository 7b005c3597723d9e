"""The Antonini 7/9 multi-level wavelet: the native cascade and dense operators.

Every route runs the multi-level cascade itself, operation for operation
the native library's parity cascade (`native/cvx_host.cpp`
`wav_fwd_axis_parity`, `wav_inv_axis_parity`): the 32^3, 128^3 and fused
stripe kernels in csrc/cascade.cuh, and the stripe, patch and compact
routes through `forward_3d_volume`, `forward_blocks` and `inverse_blocks`,
which launch csrc/plane_cascade.cu for a CUDA tensor (`plane_cascade_fwd`,
`plane_cascade_inv`).  `cascade_axis` / `cascade` / `cascade_3d` and
`forward_3d_volume_plain` are the plain versions, one f32 multiply or add
per op, so kernels and plain versions agree bit for bit.  The JAX package
runs the stripe route's transforms as dense XLA products instead
(`cvxcompress_tpu/ops/wavelet.py:249`, `cvxcompress_tpu/ops/codec.py:
1151-1169`), which spread a non-finite cell over its whole line.

The dense per-axis operators stay as a yardstick and for the tests: the
full multi-level 1D transform along an axis is a linear operator, so one
dense n x n matrix per axis length is composed in float64 from the
per-level analysis / synthesis operators (mirror rules of
Wavelet_Transform_Slow.cpp:71-134,201-259).  Taps, mirrors, the level
schedule and the composition are copies of `cvxcompress_tpu/oracle/
wavelet.py` and `cvxcompress_tpu/ops/wavelet.py:47-129`;
tests/test_torch_wavelet.py holds the operators bit-equal to those.  A
product with them must run in full f32 (a TF32 contraction keeps ~3
decimal digits and breaks the 1e-5 transform contract,
CvxCompress.cpp:597): `full_f32` sets it and restores the caller's
setting on exit.
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import _kernels, blocks

F32 = np.float32


@contextlib.contextmanager
def full_f32():
    """f32 matmuls in full f32 inside (no TF32, precision "highest"); the
    caller's setting comes back on exit.  A caller who set it through
    PyTorch's newer per-backend API (`torch.backends.cuda.matmul.
    fp32_precision`) keeps that API: reading the older one then raises."""
    try:
        prev = torch.get_float32_matmul_precision()
    except RuntimeError:
        prev = None
    if prev is not None:
        torch.set_float32_matmul_precision("highest")
        try:
            yield
        finally:
            torch.set_float32_matmul_precision(prev)
        return
    matmul = torch.backends.cuda.matmul
    prev = matmul.fp32_precision
    matmul.fp32_precision = "ieee"
    try:
        yield
    finally:
        matmul.fp32_precision = prev

# Analysis lowpass (9 taps, symmetric) / highpass (7 taps).
# Wavelet_Transform_Slow.cpp:21-30
AL = np.array(
    [
        8.526986790094000e-001,
        3.774028556126500e-001,
        -1.106244044184200e-001,
        -2.384946501938001e-002,
        3.782845550699501e-002,
    ],
    dtype=F32,
)
AH = np.array(
    [
        7.884856164056601e-001,
        -4.180922732222101e-001,
        -4.068941760955800e-002,
        6.453888262893799e-002,
    ],
    dtype=F32,
)

# Synthesis lowpass / highpass. Wavelet_Transform_Slow.cpp:136-145
SL = np.array(
    [
        7.884856164056601e-001,
        4.180922732222101e-001,
        -4.068941760955800e-002,
        -6.453888262893799e-002,
    ],
    dtype=F32,
)
SH = np.array(
    [
        8.526986790094000e-001,
        -3.774028556126500e-001,
        -1.106244044184200e-001,
        2.384946501938001e-002,
        3.782845550699501e-002,
    ],
    dtype=F32,
)


def mirr(idx, n):
    """Forward mirror: chained whole-sample symmetric extension (MIRR, :59-67)."""
    v = np.abs(np.asarray(idx))
    v = np.where(v >= n, 2 * n - 2 - v, v)
    v = np.abs(v)
    v = np.where(v >= n, 2 * n - 2 - v, v)
    return v


def mirr_sl(idx, nl):
    """Inverse mirror for the lowpass band (MIRR_SL, :178-188)."""
    v = np.asarray(idx)
    for _ in range(3):
        v = np.abs(v)
        v = np.where(v >= nl, 2 * nl - 1 - v, v)
    return v


def mirr_sh(idx, nl, nh):
    """Inverse mirror for the highpass band, half-offset (MIRR_SH, :189-199)."""
    v = np.asarray(idx) - nl
    for _ in range(3):
        v = np.where(v < 0, -v - 1, v)
        v = np.where(v >= nh, 2 * nh - 2 - v, v)
    return nl + v


def level_schedule(dim):
    """Per-axis level lengths: dim, dim - dim//2, ..., 2 (:80, :212)."""
    out = []
    n = dim
    while n >= 2:
        out.append(n)
        n = n - n // 2
    return out


def _level_matrix_forward(n):
    """Single-level n x n analysis operator (float64), rows in [L | H]."""
    al = AL.astype(np.float64)
    ah = AH.astype(np.float64)
    m = np.zeros((n, n), dtype=np.float64)
    nh = n // 2
    nl = n - nh
    for ix in range(nl):
        i0 = 2 * ix
        m[ix, i0] += al[0]
        for off in (1, 2, 3, 4):
            m[ix, mirr(i0 - off, n)] += al[off]
            m[ix, mirr(i0 + off, n)] += al[off]
    for ix in range(nh):
        i0 = 2 * ix + 1
        m[nl + ix, i0] += ah[0]
        for off in (1, 2, 3):
            m[nl + ix, mirr(i0 - off, n)] += ah[off]
            m[nl + ix, mirr(i0 + off, n)] += ah[off]
    return m


def _level_matrix_inverse(n):
    """Single-level n x n synthesis operator (float64), Us79 (:230-248)."""
    sl = SL.astype(np.float64)
    sh = SH.astype(np.float64)
    m = np.zeros((n, n), dtype=np.float64)
    nh = n // 2
    nl = n - nh
    for k in range(nl):
        m[2 * k, k] += sl[0]
        m[2 * k, mirr_sl(k - 1, nl)] += sl[2]
        m[2 * k, mirr_sl(k + 1, nl)] += sl[2]
        m[2 * k, mirr_sh(nl + k - 1, nl, nh)] += sh[1]
        m[2 * k, mirr_sh(nl + k, nl, nh)] += sh[1]
        m[2 * k, mirr_sh(nl + k - 2, nl, nh)] += sh[3]
        m[2 * k, mirr_sh(nl + k + 1, nl, nh)] += sh[3]
    for k in range(nh):
        m[2 * k + 1, mirr_sl(k, nl)] += sl[1]
        m[2 * k + 1, mirr_sl(k + 1, nl)] += sl[1]
        m[2 * k + 1, mirr_sl(k - 1, nl)] += sl[3]
        m[2 * k + 1, mirr_sl(k + 2, nl)] += sl[3]
        m[2 * k + 1, nl + k] += sh[0]
        m[2 * k + 1, mirr_sh(nl + k - 1, nl, nh)] += sh[2]
        m[2 * k + 1, mirr_sh(nl + k + 1, nl, nh)] += sh[2]
        m[2 * k + 1, mirr_sh(nl + k - 2, nl, nh)] += sh[4]
        m[2 * k + 1, mirr_sh(nl + k + 2, nl, nh)] += sh[4]
    return m


@functools.lru_cache(maxsize=None)
def forward_matrix(dim):
    """Composed multi-level analysis operator W_dim (read-only float64)."""
    w = np.eye(dim, dtype=np.float64)
    for n in level_schedule(dim):
        m = np.eye(dim, dtype=np.float64)
        m[:n, :n] = _level_matrix_forward(n)
        w = m @ w
    w.setflags(write=False)
    return w


@functools.lru_cache(maxsize=None)
def inverse_matrix(dim):
    """Composed multi-level synthesis operator W^-1_dim (read-only float64)."""
    w = np.eye(dim, dtype=np.float64)
    for n in reversed(level_schedule(dim)):
        m = np.eye(dim, dtype=np.float64)
        m[:n, :n] = _level_matrix_inverse(n)
        w = m @ w
    w.setflags(write=False)
    return w


def operator(dim, inverse, device):
    """The f32 (dim, dim) operator as a tensor on `device`."""
    m = inverse_matrix(dim) if inverse else forward_matrix(dim)
    return torch.tensor(np.asarray(m, dtype=F32), device=device)


# The cascade's taps as f32 per device: 0-dim tensors keep every product in
# f32 (a Python float would leave the promotion to the backend).
@functools.lru_cache(maxsize=None)
def _taps(device):
    dev = torch.device(device)
    return tuple(tuple(torch.tensor(c, device=dev) for c in f)
                 for f in (AL, AH, SL, SH))


@functools.lru_cache(maxsize=None)
def _ext_runs(n, inverse):
    """The gather that extends one level of length n by its mirrors, so
    every tap is a strided slice of the result, as runs (a, b) of
    consecutive source cells.  Forward: ext[i] = t[mirr(i - 4, n)], 2 nl + 7
    cells (output j's taps are ext[2j + k], k = 0..8).  Inverse: the lowpass
    run extL[i] = t[mirr_sl(i - 1, nl)] (nl + 3 cells), then the highpass
    run extH[i] = t[mirr_sh(nl + i - 2, nl, nh)] (nl + 4 cells); output pair
    k's taps are extL[k + c] and extH[k + c]."""
    nh = n // 2
    nl = n - nh
    if inverse:
        idx = np.concatenate([mirr_sl(np.arange(nl + 3) - 1, nl),
                              mirr_sh(nl + np.arange(nl + 4) - 2, nl, nh)])
    else:
        idx = mirr(np.arange(2 * nl + 7) - 4, n)
    runs = [[int(idx[0]), int(idx[0]) + 1]]
    for i in idx[1:]:
        if i == runs[-1][1]:
            runs[-1][1] += 1
        else:
            runs.append([int(i), int(i) + 1])
    return tuple((a, b) for a, b in runs)


def _extend(t, n, inverse):
    """t[..., :n] extended by `_ext_runs` (slices joined along the last
    axis: a copy, no gather)."""
    return torch.cat([t[..., a:b] for a, b in _ext_runs(n, inverse)], -1)


def _fwd_level(x, n):
    """One analysis level over x[..., :n] in place: [lowpass | highpass] in
    wav_fwd_axis_parity's order (pair sum first, then the outer taps in)."""
    (al, ah, _, _) = _taps(x.device)
    nh = n // 2
    nl = n - nh
    ext = _extend(x, n, False)

    def tap(k, m):  # x[k] of the first m outputs: ext[2j + k]
        return ext[..., k:k + 2 * m - 1:2]

    a = tap(0, nl) + tap(8, nl)
    a *= al[4]
    for k in (3, 2, 1):
        p = tap(4 - k, nl) + tap(4 + k, nl)
        p *= al[k]
        a += p
    a += tap(4, nl) * al[0]
    # the highpass output j is centred on 2j + 1: its taps are ext[2j + 5 + k]
    b = tap(2, nh) + tap(8, nh)
    b *= ah[3]
    for k in (2, 1):
        p = tap(5 - k, nh) + tap(5 + k, nh)
        p *= ah[k]
        b += p
    b += tap(5, nh) * ah[0]
    x[..., :nl] = a
    x[..., nl:n] = b


def _inv_level(x, n):
    """One synthesis level over x[..., :n] in place, interleaving the bands
    in wav_inv_axis_parity's order."""
    (_, _, sl, sh) = _taps(x.device)
    nh = n // 2
    nl = n - nh
    ext = _extend(x, n, True)
    el, eh = ext[..., :nl + 3], ext[..., nl + 3:]

    def L(c, m):  # lowpass tap c (k - 1 + c) of the first m pairs
        return el[..., c:c + m]

    def H(c, m):  # highpass tap c (nl + k - 2 + c) of the first m pairs
        return eh[..., c:c + m]

    ev = H(0, nl) + H(3, nl)
    ev *= sh[3]
    for p in ((L(0, nl) + L(2, nl)) * sl[2], (H(1, nl) + H(2, nl)) * sh[1],
              L(1, nl) * sl[0]):
        ev += p
    od = H(0, nh) + H(4, nh)
    od *= sh[4]
    for p in ((L(0, nh) + L(3, nh)) * sl[3], (H(1, nh) + H(3, nh)) * sh[2],
              (L(1, nh) + L(2, nh)) * sl[1], H(2, nh) * sh[0]):
        od += p
    x[..., 0:n:2] = ev
    x[..., 1:n:2] = od


def cascade_axis(t, inverse):
    """The multi-level 7/9 cascade along the last axis of an f32 tensor
    (levels `level_schedule`, forward n down to 2, inverse 2 up to n): the
    plain version of the kernels' cascade, operation for operation the
    native library's parity cascade.  Returns a new tensor in t's memory
    layout (a `movedim` view keeps its physical order: no transpose)."""
    x = t.clone()
    levels = level_schedule(x.shape[-1])
    for n in reversed(levels) if inverse else levels:
        (_inv_level if inverse else _fwd_level)(x, n)
    return x


def cascade(t, dim, inverse):
    """`cascade_axis` along `dim` of `t`; a contiguous tensor of t's shape."""
    return cascade_axis(t.movedim(dim, -1), inverse).movedim(-1, dim).contiguous()


def cascade_3d(t, inverse):
    """The x, then y, then z cascade of a (n, bz, by, bx) f32 block batch, in
    both directions the native library's axis order (`wav_fwd_block_ex`,
    `wav_inv_block_ex`, native/cvx_host.cpp:197-221): the plain version of
    the 32^3 and fused stripe kernels."""
    for d in (3, 2, 1):
        t = cascade(t, d, inverse)
    return t


def forward_3d_volume_plain(vol, block):
    """Plain PyTorch version of `forward_3d_volume`: zero-pad, then
    `cascade` along x, y and z of the plane's block axes (bit-equal to
    `cascade_3d` of `blocks.to_blocks`; bz == 1 has no level)."""
    bx, by, bz = block
    nbz, nby, nbx = blocks.grid_shape(vol.shape, block)
    nzp, nyp, nxp = nbz * bz, nby * by, nbx * bx
    nz, ny, nx = vol.shape
    a = F.pad(vol, (0, nxp - nx, 0, nyp - ny, 0, nzp - nz))
    a = cascade(a.reshape(nzp, nyp, nbx, bx), 3, inverse=False)
    a = cascade(a.reshape(nzp, nby, by, nxp), 2, inverse=False)
    a = cascade(a.reshape(nbz, bz, nyp * nxp), 1, inverse=False)
    return a.reshape(nzp, nyp, nxp)


def forward_blocks_of_volume_plain(vol, block):
    """Plain version of `forward_blocks_of_volume`: `cascade_3d` of the
    zero-padded block batch."""
    return cascade_3d(blocks.to_blocks(vol, block), inverse=False)


def inverse_to_volume_plain(coeffs, shape, block):
    """Plain version of `inverse_to_volume`: `cascade_3d(inverse=True)` of
    the block batch, then the relayout to the clipped volume."""
    bx, by, bz = block
    c = coeffs.reshape(-1, bz, by, bx)
    return blocks.from_blocks(cascade_3d(c, inverse=True), shape, block)


# -- the kernels' pass plan (csrc/plane_cascade.cu) ----------------------------

PLAN_LTILE = 14  # log2 of the cells of a tile (64 KiB of f32): PC_LTILE
# the layouts a pass reads or writes (the launcher's PC_VOL .. PC_CLIP) and
# the buffers (input, output, scratch): a plan names a side buffer * 4 + layout
VOL, PLANE, BLOCKS, CLIP = range(4)
IN, OUT, SCRATCH = range(3)


def pass_plan(block):
    """The kernels' passes for `block` = (bx, by, bz): (class, passes), each
    pass (axes, (ltz, lty, ltx), lnb): the axes it runs (1 x, 2 y, 4 z), the
    log2 edges of its tile's box in a block, and log2 of the whole blocks a
    tile holds (the box is then the block); a tile is 2^PLAN_LTILE cells.
    Class "a": a block of at most a tile, one pass; "b": a (by, bx) face
    of at most a tile, x + y, then z; "c": x, y and z apart."""
    lbx, lby, lbz = (int(b).bit_length() - 1 for b in block)
    t, lc, lf = PLAN_LTILE, lbx + lby + lbz, lbx + lby
    if lc <= t:
        return "a", ((3 | (4 if lbz else 0), (lbz, lby, lbx), t - lc),)
    if lf <= t:
        passes = ((3, (t - lf, lby, lbx), 0),)
        cls = "b"
    else:
        passes = ((1, (0, t - lbx, lbx), 0), (2, (0, lby, t - lby), 0))
        cls = "c"
    if lbz:
        ltx = min(lbx, t - lbz)
        passes += ((4, (lbz, t - lbz - ltx, ltx), 0),)
    return cls, passes


def launch_plan(block, inverse, layout=PLANE):
    """`pass_plan` as the launcher takes it: an int32 array of 7 a pass,
    (axes, ltz, lty, ltx, lnb, source, destination).  Forward: the volume
    (its strides) into the output in `layout` (PLANE or BLOCKS), the later
    passes in place there.  Inverse: block-major coefficients in, the
    passes before the last into the block-major scratch, the last into the
    clipped volume."""
    _, passes = pass_plan(block)
    rows, src = [], IN * 4 + (BLOCKS if inverse else VOL)
    for k, (axes, box, lnb) in enumerate(passes):
        last = k == len(passes) - 1
        if inverse:
            dst = OUT * 4 + CLIP if last else SCRATCH * 4 + BLOCKS
        else:
            dst = OUT * 4 + layout
        rows.append((axes, *box, lnb, src, dst))
        src = dst
    return np.asarray(rows, dtype=np.int32)


def _padded(shape, block):
    """The (nzp, nyp, nxp) shape of a volume's whole blocks."""
    return tuple(g * b for g, b in zip(blocks.grid_shape(shape, block), block[::-1]))


def _launch(name, t, block, shape, plan, out_shape):
    """Launch `plane_cascade_fwd` / `_inv` on the f32 CUDA tensor `t` (the
    (nz, ny, nx) volume, any strides; or the contiguous padded block-major
    coefficients) by the passes of `plan`, into a new tensor of
    `out_shape`; a scratch of the padded cells where a pass before the
    last writes one."""
    fwd = name == "plane_cascade_fwd"
    padded = _padded(shape, block)
    if (t.device.type != "cuda" or t.dtype != torch.float32
            or (t.dim() != 3 if fwd else t.numel() != math.prod(padded))):
        raise ValueError(f"{name} takes a CUDA f32 {'volume' if fwd else 'block batch'} "
                         f"for {shape} at {block}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    out = torch.empty(out_shape, dtype=torch.float32, device=t.device)
    scratch = None
    if (plan[:, 5:] >> 2 == SCRATCH).any():
        scratch = torch.empty(padded, dtype=torch.float32, device=t.device)
    strides = (*t.stride(),) if fwd else ()
    _kernels.launch(name, t.data_ptr(), *strides, *shape, *block,
                    plan.ctypes.data, len(plan), out.data_ptr(),
                    None if scratch is None else scratch.data_ptr())
    return out


def forward_3d_volume(vol, block):
    """Forward transform of a (nz, ny, nx) f32 volume in VOLUME order: the
    zero-padded (nzp, nyp, nxp) coefficient plane, each block's
    coefficients at its own place (`cvxcompress_tpu/ops/wavelet.py:249`
    without the TPU's x-pad to 128 lanes), native's parity cascade x, then
    y, then z; an axis of length 1 is skipped.  On a CUDA tensor (any view)
    the kernel `plane_cascade_fwd`; on a CPU tensor the plain version."""
    if vol.device.type == "cpu":
        return forward_3d_volume_plain(vol, block)
    return _launch("plane_cascade_fwd", vol, block, tuple(vol.shape),
                   launch_plan(block, False, PLANE), _padded(vol.shape, block))


def forward_blocks_of_volume(vol, block):
    """Forward transform of a (nz, ny, nx) f32 volume BLOCK-MAJOR: the
    (nnn, bz, by, bx) coefficients of its zero-padded blocks in raster
    order.  On a CUDA tensor (any view) the kernel `plane_cascade_fwd`,
    reading the volume and writing the batch (no relayout); on a CPU tensor
    the plain version."""
    if vol.device.type == "cpu":
        return forward_blocks_of_volume_plain(vol, block)
    bx, by, bz = block
    nnn = int(np.prod(blocks.grid_shape(vol.shape, block)))
    return _launch("plane_cascade_fwd", vol, block, tuple(vol.shape),
                   launch_plan(block, False, BLOCKS), (nnn, bz, by, bx))


def inverse_to_volume(coeffs, shape, block):
    """Inverse transform of block-major coefficients ((nnn, cells) or
    (nnn, bz, by, bx), raster order) into the (nz, ny, nx) volume, clipped
    at its edges.  On a CUDA tensor the kernel `plane_cascade_inv`, writing
    the volume itself (no relayout); on a CPU tensor the plain version."""
    shape = tuple(int(n) for n in shape)
    if coeffs.device.type == "cpu":
        return inverse_to_volume_plain(coeffs, shape, block)
    return _launch("plane_cascade_inv", coeffs.contiguous(), block, shape,
                   launch_plan(block, True), shape)


def forward_blocks(batch):
    """Forward transform of a (n, bz, by, bx) f32 block batch: `cascade_3d`
    on the CPU, on the card `plane_cascade_fwd` on the batch viewed as the
    volume (n * bz, by, bx)."""
    if batch.device.type == "cpu":
        return cascade_3d(batch, inverse=False)
    n, bz, by, bx = batch.shape
    return forward_3d_volume(batch.reshape(n * bz, by, bx),
                             (bx, by, bz)).view(n, bz, by, bx)


def inverse_blocks(coeffs):
    """Inverse transform of a (n, bz, by, bx) f32 coefficient batch:
    `cascade_3d(inverse=True)` on the CPU, on the card `plane_cascade_inv`
    into the batch viewed as the volume (n * bz, by, bx)."""
    if coeffs.device.type == "cpu":
        return cascade_3d(coeffs, inverse=True)
    n, bz, by, bx = coeffs.shape
    return inverse_to_volume(coeffs, (n * bz, by, bx), (bx, by, bz)).view(n, bz, by, bx)
