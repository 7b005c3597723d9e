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
order x -> y -> z.  They are the specification the CUDA kernels in
ops/tokenize.py and ops/fused_inverse.py are compared with.  The matmuls
must run in full f32: a TF32 contraction keeps ~3 decimal digits and breaks
the 1e-5 transform contract (CvxCompress.cpp:597), so this module pins
`torch.backends.cuda.matmul.allow_tf32 = False` (PyTorch's own default).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

F32 = np.float32

torch.backends.cuda.matmul.allow_tf32 = False

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
