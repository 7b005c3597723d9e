"""The benchmark's plain reference codec, in plain PyTorch operations.

What the program's compress and decompress are held to: a straight
statement of the reference library's semantics (CvxCompress::Compress,
CvxCompress.cpp:231-427; ::Decompress, :463-571), vectorized over blocks
so that it runs on a whole snapshot in about a second on a card, and
imports nothing of the program.

- Global RMS: the float64 sum of float64 squares, sqrt, cast to float32,
  then `container.compute_glob_mulfac` (CvxCompress.cpp:73-117, :291-295).
  Local RMS: each block's mulfac from the float64 RMS of its own
  coefficients (:119-142, :343-348).
- Transform: the Antonini 7/9 multi-level cascade per axis, x, then y,
  then z (Wavelet_Transform_Slow.cpp:261-301), each product and sum a
  float32 operation of its own (no fused multiply-add), in the order of
  the reference library's plain-AVX kernels (forward: the al4 pair, al3,
  al2, al1, the al0 centre; inverse even: sh3, sl2, sh1, sl0; odd: sh4,
  sl3, sh2, sl1, sh0; Wavelet_Transform_Slow.cpp:398-448, :588-696), which
  is the order the native host codec's parity build pins.
- Entropy stage: i = trunc(mulfac * c) with cvttps semantics, and the
  token grammar of `rle.py` (the frozen oracle), written for all blocks at
  once: every group of 8 classified, every token's bytes computed and
  scattered to its place.  A block whose payload would pass its raw size
  is stored raw (:350-360).
- Decode: float(i) * (1 / mulfac) in one float32 rounding, the scaled
  float for a VLESC4 token, the unscaled coefficients of a raw block, then
  the inverse cascade.

`dtype` runs the transforms in another precision (the benchmark's control
runs them in bfloat16); the grammar and the container stay as they are.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import container as ctn

F32 = np.float32
INT32_MIN = -2147483648
MAX_RUN24 = (1 << 24) - 1
ROW_CELLS = 1 << 26  # cells of the block rows transformed at once

# Wavelet_Transform_Slow.cpp:21-30 (analysis) and :136-145 (synthesis)
AL = [F32(v) for v in (8.526986790094000e-001, 3.774028556126500e-001,
                       -1.106244044184200e-001, -2.384946501938001e-002,
                       3.782845550699501e-002)]
AH = [F32(v) for v in (7.884856164056601e-001, -4.180922732222101e-001,
                       -4.068941760955800e-002, 6.453888262893799e-002)]
SL = [F32(v) for v in (7.884856164056601e-001, 4.180922732222101e-001,
                       -4.068941760955800e-002, -6.453888262893799e-002)]
SH = [F32(v) for v in (8.526986790094000e-001, -3.774028556126500e-001,
                       -1.106244044184200e-001, 2.384946501938001e-002,
                       3.782845550699501e-002)]

# token codes as bytes (Run_Length_Escape_Codes.hxx:8-14)
B_RLESC1, B_RLESC3 = 0x7F, 0x7D
B_VLESC2, B_VLESC3, B_VLESC4 = 0x83, 0x81, 0x80
B_VLESC2_8X, B_VLESC3_8X = 0x82, 0x7E


def level_schedule(dim):
    """Per-axis level lengths: dim, dim - dim // 2, ..., 2 (:80, :212)."""
    out, n = [], dim
    while n >= 2:
        out.append(n)
        n -= n // 2
    return out


def _mirr(v, n):
    v = np.abs(v)
    v = np.where(v >= n, 2 * n - 2 - v, v)
    v = np.abs(v)
    return np.where(v >= n, 2 * n - 2 - v, v)


def _mirr_sl(v, nl):
    for _ in range(3):
        v = np.abs(v)
        v = np.where(v >= nl, 2 * nl - 1 - v, v)
    return v


def _mirr_sh(v, nl, nh):
    v = v - nl
    for _ in range(3):
        v = np.where(v < 0, -v - 1, v)
        v = np.where(v >= nh, 2 * nh - 2 - v, v)
    return nl + v


class _Axis:
    """Index tensors and constants of one axis length on one device."""

    def __init__(self, n, device, dtype):
        self.levels = []
        for m in level_schedule(n):
            nh, nl = m // 2, m - m // 2
            ev, od = 2 * np.arange(nl), 2 * np.arange(nh) + 1
            kl, kh = np.arange(nl), np.arange(nh)

            def ix(a):
                return torch.as_tensor(np.asarray(a, np.int64), device=device)

            fwd_lo = {o: ix(_mirr(ev + o, m)) for o in range(-4, 5)}
            fwd_hi = {o: ix(_mirr(od + o, m)) for o in range(-3, 4)}
            inv_sl = {o: ix(_mirr_sl(kl + o, nl)) for o in (-1, 0, 1, 2)}
            inv_sh_e = {o: ix(_mirr_sh(nl + kl + o, nl, nh)) for o in (-2, -1, 0, 1)}
            inv_sl_o = {o: ix(_mirr_sl(kh + o, nl)) for o in (-1, 0, 1, 2)}
            inv_sh_o = {o: ix(_mirr_sh(nl + kh + o, nl, nh)) for o in (-2, -1, 1, 2)}
            self.levels.append(dict(m=m, nl=nl, nh=nh, fwd_lo=fwd_lo, fwd_hi=fwd_hi,
                                    inv_sl=inv_sl, inv_sh_e=inv_sh_e, inv_sl_o=inv_sl_o,
                                    inv_sh_o=inv_sh_o, even=ix(ev), odd=ix(od)))
        self.c = {k: [torch.tensor(float(v), dtype=dtype, device=device) for v in vals]
                  for k, vals in (("AL", AL), ("AH", AH), ("SL", SL), ("SH", SH))}


class Transform:
    """The 3D cascade over (nb, bz, by, bx) block batches, on one device in
    one precision (float32 unless told otherwise)."""

    def __init__(self, block, device, dtype=torch.float32):
        self.block = tuple(block)
        self.dtype = dtype
        bx, by, bz = self.block
        # tensor dims of a (nb, bz, by, bx) batch: x is 3, y 2, z 1
        self.axes = [(d, _Axis(n, device, dtype)) for d, n in ((3, bx), (2, by), (1, bz))
                     if n > 1]

    def forward(self, blocks):
        out = blocks.to(self.dtype).clone()
        for dim, ax in self.axes:
            for lv in ax.levels:
                _fwd_level(out, dim, lv, ax.c)
        return out

    def inverse(self, coeffs):
        out = coeffs.to(self.dtype).clone()
        for dim, ax in self.axes:
            for lv in reversed(ax.levels):
                _inv_level(out, dim, lv, ax.c)
        return out


def _fwd_level(out, dim, lv, c):
    """One forward level along `dim`, in place, in the parity order."""
    t = out.narrow(dim, 0, lv["m"]).clone()

    def g(idx):
        return t.index_select(dim, idx)

    lo, hi = lv["fwd_lo"], lv["fwd_hi"]
    al, ah = c["AL"], c["AH"]
    acc = al[4] * (g(lo[-4]) + g(lo[4]))
    acc = acc + al[3] * (g(lo[-3]) + g(lo[3]))
    acc = acc + al[2] * (g(lo[-2]) + g(lo[2]))
    acc = acc + al[1] * (g(lo[-1]) + g(lo[1]))
    acc = acc + al[0] * g(lo[0])
    out.narrow(dim, 0, lv["nl"]).copy_(acc)
    acc = ah[3] * (g(hi[-3]) + g(hi[3]))
    acc = acc + ah[2] * (g(hi[-2]) + g(hi[2]))
    acc = acc + ah[1] * (g(hi[-1]) + g(hi[1]))
    acc = acc + ah[0] * g(hi[0])
    out.narrow(dim, lv["nl"], lv["nh"]).copy_(acc)


def _inv_level(out, dim, lv, c):
    """One inverse level along `dim`, in place, in the parity order."""
    t = out.narrow(dim, 0, lv["m"]).clone()

    def g(idx):
        return t.index_select(dim, idx)

    sl, sh = c["SL"], c["SH"]
    a, b = lv["inv_sl"], lv["inv_sh_e"]
    acc = sh[3] * (g(b[-2]) + g(b[1]))
    acc = acc + sl[2] * (g(a[-1]) + g(a[1]))
    acc = acc + sh[1] * (g(b[-1]) + g(b[0]))
    acc = acc + sl[0] * g(a[0])
    out.index_copy_(dim, lv["even"], acc)
    a, b = lv["inv_sl_o"], lv["inv_sh_o"]
    acc = sh[4] * (g(b[-2]) + g(b[2]))
    acc = acc + sl[3] * (g(a[-1]) + g(a[2]))
    acc = acc + sh[2] * (g(b[-1]) + g(b[1]))
    acc = acc + sl[1] * (g(a[0]) + g(a[1]))
    acc = acc + sh[0] * t.narrow(dim, lv["nl"], lv["nh"])
    out.index_copy_(dim, lv["odd"], acc)


def grid(shape, block):
    """(nbz, nby, nbx) blocks over a (nz, ny, nx) volume (CvxCompress.cpp:279-282)."""
    (nz, ny, nx), (bx, by, bz) = shape, block
    return -(-nz // bz), -(-ny // by), -(-nx // bx)


def block_slab(vol, block, iz, iy):
    """The row of blocks (iz, iy, all ix) as an (nbx, bz, by, bx) batch, by
    one reshape of the volume when the row lies whole inside it."""
    nz, ny, nx = vol.shape
    bx, by, bz = block
    nbx = -(-nx // bx)
    z0, y0 = iz * bz, iy * by
    src = vol[z0:z0 + bz, y0:y0 + by]
    if src.shape[0] == bz and src.shape[1] == by and nx % bx == 0:
        return src.reshape(bz, by, nbx, bx).permute(2, 0, 1, 3).contiguous()
    pad = torch.zeros((bz, by, nbx * bx), dtype=torch.float32, device=vol.device)
    pad[:src.shape[0], :src.shape[1], :nx] = src
    return pad.reshape(bz, by, nbx, bx).permute(2, 0, 1, 3).contiguous()


def global_mulfac(vol, scale):
    """The header mulfac under the global RMS: the float64 sum of float64
    squares, in slabs of z so that no float64 copy of the volume is made."""
    acc = 0.0
    step = max(1, (1 << 26) // max(1, vol[0].numel()))
    for z0 in range(0, vol.shape[0], step):
        acc += float(torch.sum(torch.square(vol[z0:z0 + step].to(torch.float64))))
    rms = F32(math.sqrt(acc / vol.numel()))
    return ctn.compute_glob_mulfac(rms, scale)


def local_mulfacs(coeffs, scale):
    """Each block's mulfac from the float64 RMS of its coefficients (the
    oracle's `compute_local_rms`), 1.0 for an all-zero block or where
    1 / (rms * scale) is not finite."""
    n = coeffs.shape[0]
    acc = torch.sum(torch.square(coeffs.reshape(n, -1).to(torch.float64)), dim=1)
    rms = torch.sqrt(acc / coeffs[0].numel()).to(torch.float32)
    mf = torch.ones_like(rms) / (rms * torch.tensor(F32(scale), device=rms.device))
    return torch.where((rms == 0) | ~torch.isfinite(mf), torch.ones_like(mf), mf)


def quantize(mulfac, c):
    """(fv, iv): fv = mulfac * c in float32, iv = trunc(fv) toward zero,
    INT32_MIN where fv is NaN or outside the int32 range (cvttps,
    Run_Length_Encode_Slow.cpp:203-204).  `mulfac` is a float or an (n,)
    tensor of one per block."""
    if isinstance(mulfac, torch.Tensor):
        m = mulfac.view(-1, *([1] * (c.dim() - 1)))
    else:
        m = torch.tensor(F32(mulfac), device=c.device)
    fv = m * c
    ok = (fv >= -2147483648.0) & (fv < 2147483648.0)
    iv = torch.where(ok, torch.trunc(torch.where(ok, fv, torch.zeros_like(fv))),
                     torch.full_like(fv, INT32_MIN)).to(torch.int32)
    return fv, iv


def _run_bytes(run):
    """Bytes of the tokens of a zero run (runs of 2^24 cells and more are
    split: at most one split, as no block has more than 2^24 cells)."""
    k = torch.where(run > MAX_RUN24, (run - 1) // MAX_RUN24, torch.zeros_like(run))
    rem = run - k * MAX_RUN24
    one = torch.where(rem == 0, 0, torch.where(rem == 1, 1, torch.where(rem < 256, 2, 4)))
    return 4 * k + one, k, rem


def _put(stream, at, vals):
    stream.index_put_((at,), vals.to(torch.uint8))


def _put_le(stream, at, v, nbytes):
    for b in range(nbytes):
        _put(stream, at + b, (v >> (8 * b)) & 0xFF)


def _put_runs(stream, at, k, rem):
    if bool((k > 1).any()):
        raise ValueError("a zero run of more than 2^25 cells")
    s = k == 1
    _put(stream, at[s], torch.full_like(at[s], B_RLESC3))
    for b in range(1, 4):
        _put(stream, at[s] + b, torch.full_like(at[s], 0xFF))
    at = at + 4 * k
    m = rem == 1
    _put(stream, at[m], torch.zeros_like(at[m]))
    m = (rem >= 2) & (rem < 256)
    _put(stream, at[m], torch.full_like(at[m], B_RLESC1))
    _put(stream, at[m] + 1, rem[m])
    m = rem >= 256
    _put(stream, at[m], torch.full_like(at[m], B_RLESC3))
    _put_le(stream, at[m] + 1, rem[m], 3)


def encode(fv, iv):
    """The token streams of n blocks at once (the grammar of rle.encode).

    fv, iv: (n, cells) float32 and int32 in block order.  Returns (sizes
    int64 (n,), stream uint8 (sizes.sum(),)), the blocks' payloads back to
    back, and `f32_lane`: which cells a VLESC4 token carries as a float.
    """
    n, cells = iv.shape
    dev = iv.device
    if cells % 8:
        raise ValueError("the encoder operates on groups of 8 values")
    fi = iv.to(torch.float32).view(n, -1, 8)
    is_zero = fi == 0
    is_byte = (fi > -125) & (fi < 125)
    is_short = (fi >= -32768) & (fi <= 32767)
    is_i3 = (fi >= -8388608) & (fi <= 8388607)
    nzeros = is_zero.sum(-1)
    nbytes = is_byte.sum(-1)
    nshorts = is_short.sum(-1)
    nozero = nzeros == 0
    allbyte = nozero & (nbytes == 8)
    allshort = nozero & ~allbyte & is_short.all(-1) & (nbytes + (8 - nbytes) * 3 > 17)
    alli3 = (nozero & ~allbyte & ~allshort & is_i3.all(-1)
             & (nbytes + (nshorts - nbytes) * 3 + (8 - nshorts) * 4 > 25))
    grouped = allbyte | allshort | alli3
    mixed = (nzeros < 8) & ~grouped
    lane0 = torch.zeros(8, dtype=torch.bool, device=dev)
    lane0[0] = True
    # a token opens at lane 0 of a grouped group and at every non-zero lane
    # of a mixed one; kinds 0-2 the group fast paths, 3-6 one lane
    opens = (grouped[..., None] & lane0) | (mixed[..., None] & ~is_zero)
    gkind = torch.where(allbyte, 0, torch.where(allshort, 1, 2))
    lkind = torch.where(is_byte, 3, torch.where(is_short, 4, torch.where(is_i3, 5, 6)))
    kind = torch.where(grouped[..., None], gkind[..., None], lkind)
    idx = torch.nonzero(opens.reshape(-1)).squeeze(1)
    kind = kind.reshape(-1)[idx]
    plen = torch.tensor([8, 17, 25, 1, 3, 4, 5], device=dev)[kind]
    blk = idx // cells
    pos = idx % cells
    end = pos + torch.where(kind < 3, 8, 1)
    first = torch.ones_like(blk, dtype=torch.bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = torch.zeros_like(end)
    prev[1:] = end[:-1]
    prev = torch.where(first, torch.zeros_like(prev), prev)
    rbytes, rk, rrem = _run_bytes(pos - prev)
    evlen = rbytes + plen
    last_end = torch.zeros(n, dtype=torch.int64, device=dev)
    last_end.scatter_reduce_(0, blk, end, reduce="amax")
    tbytes, tk, trem = _run_bytes(cells - last_end)
    evsum = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(0, blk, evlen)
    sizes = evsum + tbytes
    base = torch.cumsum(sizes, 0) - sizes
    evcum = torch.cumsum(evlen, 0) - evlen
    evbase = torch.cumsum(evsum, 0) - evsum
    off = base[blk] + evcum - evbase[blk]
    stream = torch.zeros(int(sizes.sum()), dtype=torch.uint8, device=dev)
    _put_runs(stream, off, rk, rrem)
    _put_runs(stream, base + evsum, tk, trem)
    at = off + rbytes
    flat_iv = iv.reshape(-1)
    for kd, code, width in ((0, None, 1), (1, B_VLESC2_8X, 2), (2, B_VLESC3_8X, 3)):
        m = kind == kd
        a, lanes = at[m], idx[m]
        if code is not None:
            _put(stream, a, torch.full_like(a, code))
            a = a + 1
        for j in range(8):
            _put_le(stream, a + width * j, flat_iv[lanes + j], width)
    for kd, code, width in ((3, None, 1), (4, B_VLESC2, 2), (5, B_VLESC3, 3)):
        m = kind == kd
        a, lanes = at[m], idx[m]
        if code is not None:
            _put(stream, a, torch.full_like(a, code))
            a = a + 1
        _put_le(stream, a, flat_iv[lanes], width)
    m = kind == 6
    a, lanes = at[m], idx[m]
    _put(stream, a, torch.full_like(a, B_VLESC4))
    _put_le(stream, a + 1, fv.reshape(-1)[lanes].view(torch.int32), 4)
    return sizes, stream


def dequantize(fv, iv, mulfac):
    """What a decoder gives for the coded cells: float(i) * (1 / mulfac) in
    one float32 rounding, the scaled float of a VLESC4 token (a value
    outside the 24-bit range) times 1 / mulfac, 0 for a zero
    (Run_Length_Encode_Slow.cpp:388-527)."""
    if isinstance(mulfac, torch.Tensor):
        m = mulfac.view(-1, *([1] * (iv.dim() - 1)))
    else:
        m = torch.tensor(F32(mulfac), device=iv.device)
    scalefac = torch.ones_like(m) / m
    fi = iv.to(torch.float32)
    f32_lane = (fi < -8388608) | (fi > 8388607)
    return torch.where(f32_lane, fv, fi) * scalefac


class Codec:
    """The reference codec of one geometry on one device.

    `compress(vol)` gives the container (uint8 ndarray) and, unless told
    not to, the volume a decoder makes of it, worked out from the same
    quantized coefficients.  Blocks go through in rows of whole blocks
    (one z-y row at a time) so that the working set stays near
    ROW_CELLS cells.
    """

    def __init__(self, shape, block, scale, use_local_rms=False, device="cpu",
                 dtype=torch.float32):
        if not ctn.is_valid_block_size(*block):
            raise ValueError(f"invalid block size {tuple(block)}")
        self.shape, self.block, self.scale = tuple(shape), tuple(block), scale
        self.use_local_rms = use_local_rms
        self.device = torch.device(device)
        self.tf = Transform(block, self.device, dtype)

    def _rows(self):
        """Groups of whole block rows (iz, iy) of about `row_cells` cells."""
        nbz, nby, nbx = grid(self.shape, self.block)
        cells = self.block[0] * self.block[1] * self.block[2]
        per = max(1, ROW_CELLS // (nbx * cells))
        rows = [(iz, iy) for iz in range(nbz) for iy in range(nby)]
        return [rows[i:i + per] for i in range(0, len(rows), per)]

    def compress(self, vol, decode=True):
        """(container, volume or None) of a (nz, ny, nx) float32 tensor."""
        vol = vol.to(self.device, torch.float32)
        if tuple(vol.shape) != self.shape:
            raise ValueError(f"volume {tuple(vol.shape)} is not the codec's {self.shape}")
        mulfac = F32(1.0) if self.use_local_rms else global_mulfac(vol, self.scale)
        bx, by, bz = self.block
        cells = bx * by * bz
        out = torch.empty_like(vol) if decode else None
        sizes, raws, streams, tables = [], [], [], []
        for rows in self._rows():
            blocks = torch.cat([block_slab(vol, self.block, iz, iy) for iz, iy in rows])
            c = self.tf.forward(blocks).to(torch.float32).reshape(blocks.shape[0], -1)
            m = local_mulfacs(c, self.scale) if self.use_local_rms else mulfac
            fv, iv = quantize(m, c)
            sz, st = encode(fv, iv)
            raw = sz > 4 * cells
            if bool(raw.any()):
                st = _with_raw(sz, st, raw, c)
                sz = torch.where(raw, 4 * cells, sz)
            sizes.append(sz)
            raws.append(raw)
            streams.append(st)
            if self.use_local_rms:
                tables.append(m)
            if decode:
                d = torch.where(raw[:, None], c, dequantize(fv, iv, m))
                v = self.tf.inverse(d.view(blocks.shape)).to(torch.float32)
                self._scatter(out, v, rows)
        nz, ny, nx = self.shape
        hdr = ctn.Header(nx, ny, nz, bx, by, bz, mulfac, self.use_local_rms)
        data = ctn.pack_stream(hdr, torch.cat(sizes).cpu().numpy(),
                               torch.cat(raws).cpu().numpy(),
                               torch.cat(streams).cpu().numpy(),
                               torch.cat(tables).cpu().numpy() if tables else None)
        return data, out

    def _scatter(self, out, v, rows):
        """Write the blocks of `rows` back into the volume, clipped at its
        edges (Copy_From_Block, Block_Copy.cpp:136-212)."""
        nz, ny, nx = self.shape
        bx, by, bz = self.block
        nbx = -(-nx // bx)
        v = v.view(len(rows), nbx, bz, by, bx)
        for k, (iz, iy) in enumerate(rows):
            z0, y0 = iz * bz, iy * by
            dst = out[z0:z0 + bz, y0:y0 + by]
            row = v[k].permute(1, 2, 0, 3).reshape(bz, by, nbx * bx)
            dst.copy_(row[:dst.shape[0], :dst.shape[1], :nx])


def _with_raw(sizes, stream, raw, coeffs):
    """The payload stream with each raw block's coded bytes replaced by its
    unscaled coefficients (CvxCompress.cpp:359)."""
    parts, off = [], 0
    for b, (s, r) in enumerate(zip(sizes.tolist(), raw.tolist())):
        parts.append(coeffs[b].contiguous().view(torch.uint8) if r else stream[off:off + s])
        off += s
    return torch.cat(parts)
