"""The entropy grammar as per-cell tensors, and the host payload assembly.

`tokenize` is the plain PyTorch statement of what the compress kernel
(ops/tokenize.py) computes after the transform: quantize, classify, vote
the group-of-8 fast-path modes, find the zero runs (reset at each block
start) and give every cell the byte cost of the token it opens.  It follows
`cvxcompress_tpu/ops/rle_device.py:79-265` (`_classify`, `_group_modes`,
`_run_structure`, `_cost`, `tokenize_desc`), on block-major (n, cells)
tensors instead of the TPU's tile layouts.

Token grammar (oracle/rle.py, Run_Length_Escape_Codes.hxx:8-14): a plain
byte in (-125, 125) 1 B; a zero run 1 B ([0]) at length 1, 2 B below 256,
4 B up to 2^24-1 (longer runs split); VLESC2 3 B; VLESC3 4 B; VLESC4 5 B;
VLESC2_8x 17 B and VLESC3_8x 25 B over a group of 8.  A run's token lands
on the run's last zero cell, so every token's bytes come in cell order.

Per-cell descriptor (int32): cost (3 b) | run_end << 3 | min(run_len,
2^24-1) << 4 — the JAX package's layout, so kernel and plain version are
compared bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from . import quant

MAX_RUN24 = (1 << 24) - 1
RAW_BYTES_PER_CELL = 4


def classify(iv):
    """(izero, is_byte, is_short, is_i3); byte is the exclusive (-125, 125)."""
    izero = iv == 0
    is_byte = (iv > -125) & (iv < 125)  # zero lanes count, as in ref :215
    is_short = (iv >= -32768) & (iv <= 32767)
    is_i3 = (iv >= -8388608) & (iv <= 8388607)
    return izero, is_byte, is_short, is_i3


def group_modes(izero, is_byte, is_short, is_i3):
    """Per-cell group mode: 0 mixed / 1 all-byte / 2 8x short / 3 8x int24.

    Selection guards of Run_Length_Encode_Slow.cpp:216,231,246 (a packed
    group must beat the per-lane tokens).
    """
    n, c = izero.shape

    def count(m):
        return m.reshape(n, c // 8, 8).sum(-1, dtype=torch.int32)

    nzero, nb, ns, n3 = count(izero), count(is_byte), count(is_short), count(is_i3)
    nozero = nzero == 0
    allbyte = nozero & (nb == 8)
    allshort = nozero & ~allbyte & (ns == 8) & (nb + (8 - nb) * 3 > 17)
    alli3 = (
        nozero & ~allbyte & ~allshort & (n3 == 8)
        & (nb + (ns - nb) * 3 + (8 - ns) * 4 > 25)
    )
    mode = torch.zeros_like(nzero)
    mode = torch.where(alli3, 3, mode)
    mode = torch.where(allshort, 2, mode)
    mode = torch.where(allbyte, 1, mode)
    return mode.repeat_interleave(8, dim=1)


def run_structure(member):
    """(run_end, run_len) of the zero runs of each (n, cells) row."""
    n, c = member.shape
    idx = torch.arange(c, dtype=torch.int32, device=member.device).expand(n, c)
    lastnm = torch.cummax(torch.where(member, -1, idx), dim=1).values
    nxt = torch.cat([member[:, 1:], torch.zeros_like(member[:, :1])], dim=1)
    return member & ~nxt, idx - lastnm


def cost(mode, izero, is_byte, is_short, is_i3, run_end, run_len):
    """Per-cell token size in bytes (0 for a zero that does not end a run)."""
    lane0 = (torch.arange(izero.shape[-1], device=izero.device) % 8 == 0)[None, :]
    runcost = torch.where(
        run_len == 1, 1,
        torch.where(run_len < 256, 2, torch.where(run_len <= MAX_RUN24, 4, 5)),
    )
    out = torch.full_like(mode, 5)  # VLESC4: out of int24 range, NaN
    out = torch.where(is_i3 & ~is_short, 4, out)
    out = torch.where(is_short & ~is_byte, 3, out)
    out = torch.where(is_byte & ~izero, 1, out)
    out = torch.where(izero, torch.where(run_end, runcost, 0), out)
    out = torch.where(mode == 3, torch.where(lane0, 4, 3), out)
    out = torch.where(mode == 2, torch.where(lane0, 3, 2), out)
    out = torch.where(mode == 1, 1, out)
    return out.to(torch.int32)


def tokenize(fv):
    """Tokenize PRE-SCALED block-major coefficients (n, cells) f32.

    Returns desc (n, cells) int32, sizes (n,) int32 per-block payload bytes
    (4*cells for a raw block) and raw (n,) bool, the raw fallback taken when
    the stream would exceed 4*cells (CvxCompress.cpp:350-360).
    """
    cells = fv.shape[1]
    iv = quant.quantize(fv)
    izero, is_byte, is_short, is_i3 = classify(iv)
    mode = group_modes(izero, is_byte, is_short, is_i3)
    run_end, run_len = run_structure(izero)
    cst = cost(mode, izero, is_byte, is_short, is_i3, run_end, run_len)
    desc = cst | (run_end.to(torch.int32) << 3) | (
        torch.clamp(run_len, max=MAX_RUN24) << 4
    )
    sizes = cst.sum(1, dtype=torch.int32)
    raw = sizes > RAW_BYTES_PER_CELL * cells
    sizes = torch.where(raw, RAW_BYTES_PER_CELL * cells, sizes)
    return desc, sizes, raw


def assemble_payload_blockorder(stream_h, sizes_h, raw_h, raw_bytes_h, cells):
    """Host: container payload from a BLOCK-ORDERED stream of non-raw blocks.

    A numpy copy of `cvxcompress_tpu/ops/rle_device.py:820`.  With no raw
    blocks the stream IS the payload; raw blocks (absent from the stream)
    splice in as the stream's non-raw runs shift right past each raw span.
    `raw_bytes_h` holds one 4*cells-byte row per raw block, in block order.
    """
    sizes = np.asarray(sizes_h, dtype=np.int64)
    raw = np.asarray(raw_h, dtype=bool)
    total = int(sizes.sum())
    flat = np.ascontiguousarray(stream_h, dtype=np.uint8).reshape(-1)
    if not raw.any():
        return flat[:total], total
    out = np.empty(total, dtype=np.uint8)
    block_base = np.cumsum(sizes) - sizes
    nr_sizes = np.where(raw, 0, sizes)
    src_base = np.cumsum(nr_sizes) - nr_sizes
    # contiguous runs of non-raw blocks copy as single spans
    nr = np.flatnonzero(~raw)
    if nr.size:
        run_first = np.r_[True, np.diff(nr) != 1]
        starts = nr[run_first]
        run_id = np.cumsum(run_first) - 1
        run_bytes = np.bincount(run_id, weights=nr_sizes[nr]).astype(np.int64)
        for b, n in zip(starts, run_bytes):
            d0, s0 = block_base[b], src_base[b]
            out[d0:d0 + n] = flat[s0:s0 + n]
    rb = np.ascontiguousarray(raw_bytes_h, dtype=np.uint8)
    for i, b in enumerate(np.nonzero(raw)[0]):
        out[block_base[b]:block_base[b] + 4 * cells] = rb[i]
    return out, total
