"""The Antonini 7/9 multi-level wavelet as dense per-axis operators.

The full multi-level 1D transform along an axis is a linear operator, so
one dense n x n matrix per axis length is composed in float64 from the
per-level analysis / synthesis operators (mirror rules of
Wavelet_Transform_Slow.cpp:71-134,201-259).  Taps, mirrors, the level
schedule and the composition are copies of `cvxcompress_tpu/oracle/
wavelet.py` and `cvxcompress_tpu/ops/wavelet.py:47-129`;
tests/test_torch_wavelet.py holds the operators bit-equal to those.

`forward_blocks` / `inverse_blocks` are the plain PyTorch transforms of a
(n, bz, by, bx) block batch, three f32 contractions in the reference's axis
order x -> y -> z: the transforms themselves on the stripe route (with
`forward_3d_volume`), where the JAX package runs them as XLA products too.
The 32^3, 128^3 and fused stripe kernels (csrc/cascade.cuh) run the
multi-level cascade itself instead, and `cascade_axis` / `cascade` /
`cascade_3d` are their plain versions: the native library's parity
cascade (`native/cvx_host.cpp` `wav_fwd_axis_parity`,
`wav_inv_axis_parity`) one f32 multiply or add per op.  The matmuls
must run in full f32: a TF32 contraction keeps ~3 decimal digits and breaks
the 1e-5 transform contract (CvxCompress.cpp:597), so each runs inside
`full_f32`, which restores the caller's setting on exit (the JAX package
passes its precision on every product instead, `cvxcompress_tpu/ops/
wavelet.py:148-202`).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import blocks

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


def _apply_3d(blocks, inverse):
    bz, by, bx = blocks.shape[-3:]
    dev = blocks.device
    out = blocks
    with full_f32():
        if bx > 1:
            out = torch.einsum("nzyx,Xx->nzyX", out, operator(bx, inverse, dev))
        if by > 1:
            out = torch.einsum("nzyx,Yy->nzYx", out, operator(by, inverse, dev))
        if bz > 1:
            out = torch.einsum("nzyx,Zz->nZyx", out, operator(bz, inverse, dev))
    return out.contiguous()


def forward_blocks(blocks):
    """Forward transform of a (n, bz, by, bx) f32 block batch (plain)."""
    return _apply_3d(blocks, inverse=False)


def inverse_blocks(coeffs):
    """Inverse transform of a (n, bz, by, bx) f32 coefficient batch (plain)."""
    return _apply_3d(coeffs, inverse=True)


def forward_3d_volume(vol, block):
    """Forward transform of a (nz, ny, nx) volume in VOLUME order: the
    zero-padded (nzp, nyp, nxp) coefficient plane, each block's
    coefficients at its own place (`cvxcompress_tpu/ops/wavelet.py:249`
    without the TPU's x-pad to 128 lanes).  The x, then y, then z
    contractions as torch einsums (library products, as the JAX package
    leaves them to XLA); an axis of length 1 is skipped."""
    bx, by, bz = block
    nbz, nby, nbx = blocks.grid_shape(vol.shape, block)
    nzp, nyp, nxp = nbz * bz, nby * by, nbx * bx
    nz, ny, nx = vol.shape
    a = F.pad(vol, (0, nxp - nx, 0, nyp - ny, 0, nzp - nz))
    dev = vol.device
    with full_f32():
        a = torch.einsum("zybx,Xx->zybX", a.reshape(nzp, nyp, nbx, bx),
                         operator(bx, False, dev))
        a = torch.einsum("zgyx,Yy->zgYx", a.reshape(nzp, nby, by, nxp),
                         operator(by, False, dev))
        if bz > 1:
            a = torch.einsum("hzr,Zz->hZr", a.reshape(nbz, bz, nyp * nxp),
                             operator(bz, False, dev))
    return a.reshape(nzp, nyp, nxp).contiguous()


# The cascade's taps as f32 per device: 0-dim tensors keep every product in
# f32 (a Python float would leave the promotion to the backend).
@functools.lru_cache(maxsize=None)
def _taps(device):
    dev = torch.device(device)
    return tuple(tuple(torch.tensor(c, device=dev) for c in f)
                 for f in (AL, AH, SL, SH))


@functools.lru_cache(maxsize=None)
def _level_index(n, inverse, device):
    """The mirrored tap indices of one level of length n, per tap offset:
    forward {lo: {k: mirr(2i + k)}, hi: {k: mirr(2i + 1 + k)}}; inverse
    {sl: {c: mirr_sl(k + c)}, sh: {c: mirr_sh(nl + k + c)}}, k the output
    pair (nl pairs; the odd outputs take the first nh)."""
    nh = n // 2
    nl = n - nh
    dev = torch.device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

    if not inverse:
        lo, hi = 2 * np.arange(nl), 2 * np.arange(nh) + 1
        return ({k: t(mirr(lo + k, n)) for k in range(-4, 5)},
                {k: t(mirr(hi + k, n)) for k in range(-3, 4)})
    k = np.arange(nl)
    return ({c: t(mirr_sl(k + c, nl)) for c in range(-1, 3)},
            {c: t(mirr_sh(nl + k + c, nl, nh)) for c in range(-2, 3)})


def _fwd_level(x, n):
    """One analysis level over x[..., :n] in place: [lowpass | highpass] in
    wav_fwd_axis_parity's order (pair sum first, then the outer taps in)."""
    (al, ah, _, _), (lo, hi) = _taps(x.device), _level_index(n, False, x.device)
    t = x[..., :n]

    def pair(ix, k):
        return t.index_select(-1, ix[-k]) + t.index_select(-1, ix[k])

    a = pair(lo, 4) * al[4]
    for k in (3, 2, 1):
        a = a + pair(lo, k) * al[k]
    a = a + t.index_select(-1, lo[0]) * al[0]
    b = pair(hi, 3) * ah[3]
    for k in (2, 1):
        b = b + pair(hi, k) * ah[k]
    b = b + t.index_select(-1, hi[0]) * ah[0]
    x[..., :n] = torch.cat([a, b], -1)


def _inv_level(x, n):
    """One synthesis level over x[..., :n] in place, interleaving the bands
    in wav_inv_axis_parity's order."""
    (_, _, sl, sh), (L, H) = _taps(x.device), _level_index(n, True, x.device)
    nh = n // 2
    t = x[..., :n]

    def g(ix, c, m):
        return t.index_select(-1, ix[c][:m])

    nl = n - nh
    ev = (g(H, -2, nl) + g(H, 1, nl)) * sh[3]
    ev = ev + (g(L, -1, nl) + g(L, 1, nl)) * sl[2]
    ev = ev + (g(H, -1, nl) + g(H, 0, nl)) * sh[1]
    ev = ev + g(L, 0, nl) * sl[0]
    od = (g(H, -2, nh) + g(H, 2, nh)) * sh[4]
    od = od + (g(L, -1, nh) + g(L, 2, nh)) * sl[3]
    od = od + (g(H, -1, nh) + g(H, 1, nh)) * sh[2]
    od = od + (g(L, 0, nh) + g(L, 1, nh)) * sl[1]
    od = od + g(H, 0, nh) * sh[0]
    x[..., 0:n:2] = ev
    x[..., 1:n:2] = od


def cascade_axis(t, inverse):
    """The multi-level 7/9 cascade along the last axis of an f32 tensor
    (levels `level_schedule`, forward n down to 2, inverse 2 up to n): the
    plain version of the 128^3 kernels' cascade, operation for operation the
    native library's parity cascade.  Returns a new tensor."""
    x = t.contiguous().clone()
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
