"""Device entropy decoder: the parallel parse of the RLE/escape grammar.

Counterpart of `cvxcompress_tpu/ops/entropy_decode.py`.  The host plans
(`plan`: the container's block payloads copied back to back into 32-byte
aligned subsegments, one blob, one upload); the card then runs three
kernels, each with its plain PyTorch version in this module:

  1. `parse_maps` (csrc/decode_maps.cu): per subsegment, the token-start
     masks M[p] ("byte p starts a token when the subsegment is entered at
     offset e", 25 bits) and the packed transfer maps P[e] = NV*32 + T
     (exit offset T and value count NV for every entry offset e).  The XLA
     stage of `_parse_stages` (:336); no Pallas kernel there.
  2. `chase` (csrc/decode_chase.cu, replaces K18 `_chase_pallas` :258):
     the cross-subsegment recurrence.  Every block start resets the state,
     so each block is an independent chain: entry e = T[k][e], cursor
     c = min(c + NV[k][e], cells).  The kernel walks short chains a warp
     each and scans pieces of long ones; the plain version is the JAX
     default, the log-depth Sklansky scan (:396-487).
  3. `emit` (csrc/decode_emit.cu, replaces K4 `_emit_values_pallas` :733
     and the scatter after it, `decode_to_blocks` :884-898): every token
     start decodes its token and writes its dequantized values into the
     zeroed dense block-major buffer (nnn, cells) at block*cells + cursor.

Raw-fallback blocks are overlaid with one `index_copy_` (`overlay_raw`).

Each wrapper launches its kernel for a CUDA tensor and runs the plain
version for a CPU tensor; nothing falls back.

Byte-exactness: a value is float(int) * scalefac (or the escaped f32 *
scalefac) with one f32 rounding, as the host decoders compute it; the
dense buffer is bit-identical to theirs for any valid container.  The plan
carries one scalefac per block, np.float32(1) / mulfac computed on the host
(the header's global mulfac repeated, or the local-RMS `blkmulfac` table),
as the JAX `plan` does (:200-209).  On a corrupt stream a group-of-8 token
may run past its block's payload; its values then go to the block whose
chain started the token, with that block's scalefac, where the JAX device
decoder uses the block (and the scalefac) of the byte that carries the
value.  Writes of one chain therefore never land in another block, every
live target is unique, and the kernel needs no atomics.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import container as ctn
from . import _kernels, rle_host

SEG = 512  # segment bytes (the JAX package's row; the plan keeps its shape)
W = 32  # subsegment bytes (the parse unit; > max token length 25)
SPS = SEG // W
E = 25  # entry offsets: the longest token (VLESC3_8x) is 25 bytes
LOOK = 25  # lookahead bytes a token may read past its first byte + 1

_LENGTHS = ((127, 2), (125, 4), (-125, 3), (-127, 4), (-126, 17), (126, 25),
            (-128, 5))

PAD = W  # zero bytes after the stream (>= LOOK): every lookahead stays in it
_ALIGN = 16  # blob field alignment (any dtype view of a field is legal)
MAX_CELLS = 1 << 26  # P packs min(NV, cells) * 32 + T in an int32: cells below it


def _align(n):
    return -(-n // _ALIGN) * _ALIGN


def plan(data):
    """Host planning: container -> the decode plan (one blob of arrays).

    Returns None when the container's spans are degenerate (the caller's
    host engine decides then), else a dict with, as numpy views of one
    uint8 `blob`: `segs` (nseg, SEG) u8, the aligned payload stream (plus
    PAD zero bytes after it in the blob), `sub_block` (nsub,) i32 (nnn for
    padding), `sub_reset` (nsub,) bool, `starts` (nchains,) i32 (the
    subsegments with sub_reset), `scalefac` (nnn,) f32 (each block's
    1/mulfac), `raw_ids` (nraw,) i64 and `raw_rows` (nraw, cells) f32 (None
    when no block is raw); `hdr`, `cells` and `layout` (field -> (offset,
    dtype, shape)).

    Spans come from the argsorted offset table, so a payload in any block
    order decodes.  The cost is one native ragged memcpy of the payload
    into the blob plus O(nsub) span arithmetic: no per-block Python loop.
    """
    hdr, blkoffs, blkmulfac, payload_base = ctn.unpack(data)
    nnn = hdr.grid[3]
    cells = hdr.bx * hdr.by * hdr.bz
    payload = np.frombuffer(memoryview(data), dtype=np.uint8)[payload_base:]
    avail = payload.size

    offs64 = np.asarray(blkoffs, dtype=np.int64)
    is_raw = offs64 < 0
    offs = offs64 & ~ctn.RAW_FLAG
    # a block ends where the next-larger offset starts
    order = np.argsort(offs, kind="stable")
    ends = np.empty(nnn, dtype=np.int64)
    ends[order[:-1]] = offs[order[1:]]
    ends[order[-1]] = avail
    sizes = np.where(is_raw, 4 * cells, ends - offs)
    if (sizes <= 0).any() or (offs + sizes > avail).any():
        return None

    rle = ~is_raw
    asz = np.where(rle, -(-sizes // W) * W, 0)  # W-aligned stream extents
    base = np.cumsum(asz) - asz
    total = int(asz.sum())
    nsub = max(SPS, -(-total // W))
    nseg = -(-nsub // SPS)
    nsub = nseg * SPS
    rle_ids = np.nonzero(rle)[0]
    raw_ids = np.nonzero(is_raw)[0]

    sub_block = np.full(nsub, nnn, dtype=np.int32)
    # raw blocks take no stream bytes: the RLE blocks' runs are contiguous
    sub_block[: total // W] = np.repeat(rle_ids.astype(np.int32), asz[rle_ids] // W)
    sub_reset = np.zeros(nsub, dtype=bool)
    sub_reset[total // W:] = True  # padding subsegments restart (inert)
    sub_reset[base[rle_ids] // W] = True
    starts = np.flatnonzero(sub_reset).astype(np.int32)

    fields = [
        ("stream", np.uint8, (nsub * W + PAD,)),
        ("raw_rows", np.float32, (raw_ids.size, cells)),
        ("sub_block", np.int32, (nsub,)),
        ("starts", np.int32, (starts.size,)),
        ("scalefac", np.float32, (nnn,)),
        ("raw_ids", np.int64, (raw_ids.size,)),
        ("sub_reset", np.bool_, (nsub,)),
    ]
    layout, off = {}, 0
    for name, dt, shape in fields:
        layout[name] = (off, dt, shape)
        off = _align(off + int(np.prod(shape)) * np.dtype(dt).itemsize)
    blob = np.zeros(off, dtype=np.uint8)  # zeroed: stream tails, padding

    def view(name):
        o, dt, shape = layout[name]
        n = int(np.prod(shape)) * np.dtype(dt).itemsize
        return blob[o: o + n].view(dt).reshape(shape)

    # the RLE payloads into the stream (each tail zeroed up to W) and the
    # raw blocks' coefficients into their rows: one native ragged copy
    o_raw = layout["raw_rows"][0]
    rowb = 4 * cells
    rle_host.ragged_copy_fill(
        payload,
        np.concatenate([offs[rle_ids], offs[raw_ids]]),
        blob,
        np.concatenate([base[rle_ids], o_raw + rowb * np.arange(raw_ids.size)]),
        np.concatenate([sizes[rle_ids], np.full(raw_ids.size, rowb)]),
        W,
    )
    view("sub_block")[:] = sub_block
    view("starts")[:] = starts
    mulfacs = blkmulfac if hdr.use_local_rms else np.float32(hdr.glob_mulfac)
    view("scalefac")[:] = np.float32(1.0) / mulfacs  # on the host: see decode_emit.cu
    view("raw_ids")[:] = raw_ids
    view("sub_reset")[:] = sub_reset
    return {
        "segs": view("stream")[: nsub * W].reshape(nseg, SEG),
        "sub_block": view("sub_block"),
        "sub_reset": view("sub_reset"),
        "starts": view("starts"),
        "scalefac": view("scalefac"),
        "hdr": hdr,
        "cells": cells,
        "raw_ids": view("raw_ids"),
        "raw_rows": view("raw_rows") if raw_ids.size else None,
        "blob": blob,
        "layout": layout,
    }


_TORCH_DTYPES = {np.uint8: torch.uint8, np.int32: torch.int32,
                 np.int64: torch.int64, np.float32: torch.float32,
                 np.bool_: torch.bool}


def upload(p, device):
    """One host-to-device copy of the plan blob; its fields as views."""
    return fields(torch.from_numpy(p["blob"]).to(device), p["layout"])


def fields(blob, layout, base=0):
    """A plan's fields as views of the uint8 tensor `blob`, which holds the
    plan's blob at byte `base` (a multiple of the field alignment): several
    plans can share one upload (ops/codec.py `decompress_many`)."""
    if base % _ALIGN:
        raise ValueError(f"a plan's blob must start on a {_ALIGN}-byte boundary")
    out = {}
    for name, (o, dt, shape) in layout.items():
        n = int(np.prod(shape)) * np.dtype(dt).itemsize
        o += base
        out[name] = blob[o: o + n].view(_TORCH_DTYPES[dt]).reshape(shape)
    return out


# ---------------------------------------------------------------------------
# plain PyTorch versions (the kernels' specification; the CPU path)
# ---------------------------------------------------------------------------


def _token_planes(stream, n, cells):
    """Byte planes of the first n stream bytes: (B, sv, ln, vals).

    B holds n + LOOK bytes as i32 (plane k is B[k:k+n]); sv is the signed
    first byte, ln the token length and vals the number of cells the token
    covers if it starts there (`_parse_stages` :356-365).
    """
    B = stream[: n + LOOK].to(torch.int32)
    sv = B[:n] - 256 * (B[:n] >= 128).to(torch.int32)
    ln = torch.ones_like(sv)
    for code, tl in _LENGTHS:
        ln = torch.where(sv == code, tl, ln)
    vals = torch.ones_like(sv)
    vals = torch.where(sv == 127, B[1: n + 1], vals)  # RLESC1: run in [0, 255]
    run3 = B[1: n + 1] | (B[2: n + 2] << 8) | (B[3: n + 3] << 16)
    vals = torch.where(sv == 125, torch.clamp_max(run3, cells), vals)  # RLESC3
    vals = torch.where((sv == -126) | (sv == 126), 8, vals)  # group of 8
    return B, sv, ln, vals


def parse_maps_plain(stream, nsub, cells):
    """Plain version of `parse_maps`: (M (nsub, W) i32, P (nsub, E) i32).

    A transliteration of `_parse_stages` :344-394 and the packing at :444.
    `stream` holds nsub*W bytes followed by >= LOOK zero bytes.
    """
    n = nsub * W
    _, _, ln, vals = _token_planes(stream, n, cells)
    ln_s = ln.reshape(nsub, W)
    cols = []
    for p in range(W):
        col = torch.full((nsub,), 1 << p if p < E else 0, dtype=torch.int32,
                         device=stream.device)
        for tl in (1, 2, 3, 4, 5, 17, 25):
            if p - tl >= 0:
                col = col | torch.where(ln_s[:, p - tl] == tl, cols[p - tl], 0)
        cols.append(col)
    M = torch.stack(cols, dim=1)

    nxt = torch.arange(W, dtype=torch.int32, device=stream.device)[None, :] + ln_s
    cross = (nxt >= W).to(torch.int32)
    exit_off = nxt - W
    vals_s = vals.reshape(nsub, W)
    T = torch.empty((nsub, E), dtype=torch.int32, device=stream.device)
    NV = torch.empty_like(T)
    for e in range(E):
        bits = (M >> e) & 1
        T[:, e] = (bits * cross * exit_off).sum(dim=1).to(torch.int32)
        NV[:, e] = torch.clamp_max((bits * vals_s).sum(dim=1), cells).to(torch.int32)
    return M, NV * 32 + T


def chase_plain(P, sub_reset, cells):
    """Plain version of `chase`: (e32, c32) (nsub,) i32.

    A transliteration of the JAX package's default, the Sklansky scan of
    `_parse_stages` :409-487 (nsub a multiple of SPS).  Its table lookup
    `out[..., e] = ptab[..., idx[..., e]]` (:411-414, a compare-mask-reduce
    over a (..., E, E) mask) is written as the gather it computes.
    """
    nsub = P.shape[0]
    nseg = nsub // SPS
    dev = P.device
    eye = torch.arange(E, dtype=torch.int32, device=dev)

    def combine(p1, r1, p2, r2):
        """Apply map p1 then p2 (a reset in p2's span discards p1)."""
        g = torch.gather(p2, -1, (p1 & 31).long().expand_as(p2))
        p = torch.clamp_max((p1 >> 5) + (g >> 5), cells) * 32 + (g & 31)
        return torch.where(r2[..., None], p2, p), r1 | r2

    def sklansky(p, r, axis_len):
        lead = p.shape[:-2]
        s = 1
        while s < axis_len:
            g2 = 2 * s
            pv = p.reshape(*lead, axis_len // g2, g2, E)
            rv = r.reshape(*lead, axis_len // g2, g2)
            cp, cr = combine(pv[..., s - 1: s, :], rv[..., s - 1: s],
                             pv[..., s:, :], rv[..., s:])
            p = torch.cat([pv[..., :s, :], cp], dim=-2).reshape(*lead, axis_len, E)
            r = torch.cat([rv[..., :s], cr], dim=-1).reshape(*lead, axis_len)
            s = g2
        return p, r

    P3 = P.reshape(nseg, SPS, E)
    R2 = sub_reset.reshape(nseg, SPS)
    identP = eye[None, :].expand(nseg, E)
    # level 1: the SPS submaps of each segment; a reset bakes in f_k(0)
    Pb = torch.where(R2[:, :, None], P3[:, :, 0:1], P3)
    inc1, _ = sklansky(Pb, R2, SPS)
    excl = torch.cat([identP[:, None, :], inc1[:, :-1, :]], dim=1)
    pref = torch.where(R2[:, :, None], 0, excl)  # state map before sub k
    curP = inc1[:, -1, :]
    # level 2: the segment maps, padded to a power of two with identities
    r_seg = R2.any(dim=1)
    n2 = 1 << max(0, (int(nseg) - 1).bit_length())
    padP = torch.cat([curP, eye[None, :].expand(n2 - nseg, E)], dim=0)
    padR = torch.cat([r_seg, r_seg.new_zeros(n2 - nseg)], dim=0)
    inc2, _ = sklansky(padP, padR, n2)
    prev_p = torch.cat([identP[:1], inc2[: nseg - 1]], dim=0)
    eseg = prev_p[:, 0] & 31
    cseg = prev_p[:, 0] >> 5
    # level 3: each segment's entry through its submap prefixes
    post = torch.cumsum(R2.to(torch.int32), dim=1) > 0
    sel = torch.gather(pref, 2, eseg.long()[:, None, None].expand(nseg, SPS, 1))[:, :, 0]
    e32 = (sel & 31).reshape(nsub)
    pv = sel >> 5
    c32 = torch.where(post, pv, torch.clamp_max(cseg[:, None] + pv, cells))
    return e32.to(torch.int32), c32.reshape(nsub).to(torch.int32)


def chase_sequential(P, sub_reset, cells):
    """The chase's own semantics (`_chase_pallas` :295-304), one step at a
    time in numpy: the reference the tests hold both versions to."""
    P = np.asarray(P)
    reset = np.asarray(sub_reset)
    e32 = np.empty(P.shape[0], np.int32)
    c32 = np.empty(P.shape[0], np.int32)
    e = c = 0
    for k in range(P.shape[0]):
        if reset[k]:
            e = c = 0
        e32[k], c32[k] = e, c
        e, c = P[k, e] & 31, min(c + (P[k, e] >> 5), cells)
    return e32, c32


def emit_plain(stream, M, e32, c32, sub_block, scalefac, nnn, cells):
    """Plain version of `emit`: the dense (nnn, cells) f32 coefficients.

    `_emit_values` :513-597 with the block-major target of
    `decode_to_blocks` :884-898 (block*cells + pos; pos >= cells or
    block >= nnn is dropped), into a zeroed buffer; each value times its
    block's entry of the (nnn,) `scalefac`.  Group-of-8 values go to the
    block of their token's first byte (module docstring).
    """
    nsub = M.shape[0]
    n = nsub * W
    dev = stream.device
    B, sv, _, vals = _token_planes(stream, n, cells)
    is_start = (M >> e32[:, None]) & 1
    tv = vals.reshape(nsub, W) * is_start
    p_excl = torch.cumsum(tv, dim=1) - tv
    out_base = torch.clamp_max(c32[:, None].long() + p_excl, cells).reshape(n)
    start = is_start.reshape(n) == 1
    blk = sub_block.long()[:, None].expand(nsub, W).reshape(n)
    sf = scalefac[blk.clamp_max(nnn - 1)]  # blocks >= nnn are dropped below

    def plane(k):
        return B[k: k + n]

    plain = (sv > -125) & (sv < 125)
    v16 = plane(1) | (plane(2) << 8)
    v16 = v16 - ((v16 >> 15) << 16)
    v24 = plane(1) | (plane(2) << 8) | (plane(3) << 16)
    v24 = v24 - ((v24 >> 23) << 24)
    bits = (plane(1).long() | (plane(2).long() << 8) | (plane(3).long() << 16)
            | (plane(4).long() << 24))
    fraw = (bits - (bits >= 2**31).long() * 2**32).to(torch.int32).view(torch.float32)
    val1 = torch.where(plain, sv, 0)
    val1 = torch.where(sv == -125, v16, val1)
    val1 = torch.where(sv == -127, v24, val1)
    val1f = torch.where(sv == -128, fraw, val1.to(torch.float32))
    single = start & (plain | (sv == -125) | (sv == -127) | (sv == -128))

    i1 = torch.nonzero(single)[:, 0]
    blks, poss, valv = [blk[i1]], [out_base[i1]], [val1f[i1] * sf[i1]]
    for code, width in ((-126, 2), (126, 3)):  # VLESC2_8x, VLESC3_8x
        s = torch.nonzero(start & (sv == code))[:, 0]
        for j in range(8):
            q = s + 1 + width * j
            v = B[q] | (B[q + 1] << 8)
            if width == 2:
                v = v - ((v >> 15) << 16)
            else:
                v = v | (B[q + 2] << 16)
                v = v - ((v >> 23) << 24)
            blks.append(blk[s])
            poss.append(out_base[s] + j)
            valv.append(v.to(torch.float32) * sf[s])
    b, pos, val = torch.cat(blks), torch.cat(poss), torch.cat(valv)
    live = (pos < cells) & (b < nnn)
    out = torch.zeros((nnn, cells), dtype=torch.float32, device=dev)
    out.view(-1)[(b * cells + pos)[live]] = val[live]
    return out


# ---------------------------------------------------------------------------
# wrappers: the kernel for a CUDA tensor, the plain version for a CPU tensor
# ---------------------------------------------------------------------------


def _check_stream(stream, nsub):
    if stream.dim() != 1 or stream.numel() < nsub * W + LOOK:
        raise ValueError(
            f"stream must hold nsub*{W} + {LOOK} bytes, got {tuple(stream.shape)}")


def parse_maps(stream, nsub, cells):
    """(M, P) of every subsegment; see parse_maps_plain."""
    _check_stream(stream, nsub)
    if not 0 < cells < MAX_CELLS:
        raise ValueError(f"cells must lie in (0, {MAX_CELLS}), got {cells}")
    if stream.device.type == "cpu":
        return parse_maps_plain(stream, nsub, cells)
    _kernels.check_cuda(stream, dtypes=(torch.uint8,))
    _kernels.check_aligned(stream)  # upload: the blob's first field
    M = torch.empty((nsub, W), dtype=torch.int32, device=stream.device)
    P = torch.empty((nsub, E), dtype=torch.int32, device=stream.device)
    _kernels.launch("decode_maps", stream.data_ptr(), nsub, cells,
                    M.data_ptr(), P.data_ptr())
    return M, P


CHASE_PIECE = 128  # subsegments a warp of csrc/decode_chase.cu walks, at most
CHASE_UNIT = 8  # pieces a CTA of it takes (its look-back's unit), at most
WALK_MEAN = 16  # the walk's longest mean chain, in subsegments
WALK_CELLS = 32 ** 3  # the walk's largest block


def chase_walks(nsub, nchains, cells):
    """Whether the chase kernel walks the chains, a warp each, rather than
    scanning pieces of them: when they average at most WALK_MEAN
    subsegments (a smooth volume's 32^3 blocks average ~4) and the blocks
    hold at most WALK_CELLS cells.  A walk takes about as long as the
    longest chain, and a block's chain holds at most 4 * cells / W + 1
    subsegments (a block over 4 bytes a cell is stored raw): over such
    blocks no walk is longer than 4,097 steps, whatever the data."""
    return nsub <= WALK_MEAN * nchains and cells <= WALK_CELLS


def chase_shape(nsub):
    """The pieces' shape: CHASE_PIECE subsegments a warp and CHASE_UNIT
    warps a CTA, or for a short stream pieces of a multiple of 32 that give
    ~2,048 of them (the card holds 16 warps, a piece each, on each of its
    132 SMs) in units of 4 pieces, so that the walks are short and run at
    once."""
    piece = min(CHASE_PIECE, 32 * -(-nsub // (2048 * 32)))
    return piece, CHASE_UNIT if piece == CHASE_PIECE else 4


def chase(P, sub_reset, starts, cells):
    """(e32, c32): each subsegment's entry offset and output cursor.

    `starts` lists the subsegments where sub_reset holds, in order, and
    must begin with 0 (the plan's chains).  The kernel walks each chain, a
    warp a chain from its start, or when `chase_walks` says no, scans
    pieces of subsegments, a unit of them a CTA (`chase_shape`), and joins
    the units by a decoupled look-back; the plain version is the JAX
    package's Sklansky scan.
    """
    if P.dim() != 2 or P.shape[1] != E or sub_reset.shape != (P.shape[0],):
        raise ValueError(f"P must be (nsub, {E}) with a reset per subsegment")
    if P.device.type == "cpu":
        return chase_plain(P, sub_reset, cells)
    _kernels.check_cuda(P, sub_reset, starts,
                        dtypes=(torch.int32, torch.bool, torch.int32))
    nsub, nchains = P.shape[0], starts.numel()
    e32 = torch.empty(nsub, dtype=torch.int32, device=P.device)
    c32 = torch.empty(nsub, dtype=torch.int32, device=P.device)
    piece = warps = 0  # the walk
    scratch = None
    if not chase_walks(nsub, nchains, cells):
        piece, warps = chase_shape(nsub)
        # the ticket and the status words, held until the launch is queued
        scratch = torch.empty(1 + -(-nsub // (warps * piece)) * E, dtype=torch.int32,
                              device=P.device)
    _kernels.launch("decode_chase", P.data_ptr(), sub_reset.data_ptr(), starts.data_ptr(),
                    nchains, nsub, piece, warps, cells,
                    None if scratch is None else scratch.data_ptr(), e32.data_ptr(),
                    c32.data_ptr())
    return e32, c32


def emit(stream, M, e32, c32, sub_block, scalefac, nnn, cells):
    """Dense (nnn, cells) f32 coefficients; see emit_plain.  `scalefac` is
    the plan's (nnn,) f32 table."""
    nsub = M.shape[0]
    _check_stream(stream, nsub)
    if M.shape != (nsub, W) or not (e32.shape == c32.shape == sub_block.shape
                                    == (nsub,)):
        raise ValueError(f"M must be (nsub, {W}); e32, c32 and sub_block need "
                         "one entry per subsegment")
    if scalefac.shape != (nnn,):
        raise ValueError(f"scalefac must be ({nnn},), got {tuple(scalefac.shape)}")
    if not 0 < cells < MAX_CELLS:
        raise ValueError(f"cells must lie in (0, {MAX_CELLS}), got {cells}")
    if stream.device.type == "cpu":
        return emit_plain(stream, M, e32, c32, sub_block, scalefac, nnn, cells)
    _kernels.check_cuda(stream, M, e32, c32, sub_block, scalefac,
                        dtypes=(torch.uint8,) + (torch.int32,) * 4
                        + (torch.float32,))
    _kernels.check_aligned(stream)  # upload: the blob's first field
    out = torch.zeros((nnn, cells), dtype=torch.float32, device=stream.device)
    _kernels.launch("decode_emit", stream.data_ptr(), M.data_ptr(),
                    e32.data_ptr(), c32.data_ptr(), sub_block.data_ptr(), nsub,
                    scalefac.data_ptr(), cells, nnn, out.data_ptr())
    return out


def overlay_raw(dense, raw_rows, raw_ids):
    """Raw-fallback blocks' coefficients (unscaled, CvxCompress.cpp:552-555)
    into the dense buffer, in place (`overlay_raw` :902, XLA there)."""
    if raw_ids.numel():
        dense.index_copy_(0, raw_ids, raw_rows)
    return dense

