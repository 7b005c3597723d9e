"""Inputs for the chunk-sparse emit (csrc/block_emit.cu: `pack.emit_chunks`
and its rows mode `pack.emit_rows`) at the places its window walk can go
wrong: a window is 32 consecutive chunks (or rows), its live chunks found by
a ballot and taken 32 / LPC at a time (LPC = 16 lanes for a 128-cell chunk,
8 for a 64-cell one).  Shared by the CPU tests (tests/test_torch_chunk_emit.py,
a numpy model of the walk) and the card's (tests/test_torch_cuda.py).  The
data is made from seeds with numpy; the descriptors and chunk counts come
from the port's plain tokenize (no jax)."""

import numpy as np
import torch

from cvxcompress_tpu_torch.ops import blocks, geometry, tokenize

# name -> (block, volume shape, kinds): the volume is cut into `block`
# blocks of one kind each, in raster order ("zero": all zero, so its only
# token, the run's, lies in its last chunk; "raw": over 4 bytes a cell;
# "sparse", "dense": every token class, some zero runs across chunks)
CASES = {
    # every block raw: no chunk holds a byte
    "all_dead": ((8, 8, 8), (8, 16, 64), ("raw",)),
    # 32^3 all-zero blocks: the only live chunk of each 256 is chunk 255,
    # lane 31 of its window
    "lane31_only": ((32, 32, 32), (32, 32, 64), ("zero",)),
    # 8^3 blocks, 8 a window: zero blocks (one live chunk), raw blocks (none)
    # and sparse ones, so windows hold odd counts of live chunks and raw
    # blocks between live ones
    "odd_and_raw": ((8, 8, 8), (16, 16, 64), ("zero", "sparse", "raw", "zero", "dense",
                                              "raw", "sparse", "zero", "raw")),
    # 13 blocks of 4 chunks: the last window holds 20 chunks, 12 lanes past
    # the end
    "tail_window": ((8, 8, 8), (8, 8, 104), ("sparse", "dense", "zero")),
    # 64-cell chunks (LPC 8, four chunks a step) through the stripe map
    "stripe_8x8x1": ((8, 8, 1), (3, 24, 40), ("sparse", "zero", "dense", "raw")),
    # the stripe map at 8^3 and (128, 8, 8)
    "stripe_8": ((8, 8, 8), (16, 24, 40), ("dense", "sparse", "zero", "raw")),
    "stripe_128x8x8": ((128, 8, 8), (16, 16, 256), ("sparse", "zero", "dense")),
    # 32^3 block-major with a raw block
    "block32_raw": ((32, 32, 32), (32, 64, 64), ("sparse", "raw", "dense", "zero")),
}
# the stripe route's cases read a volume-order plane through the map; the
# rest block-major coefficients
STRIPE = ("stripe_8x8x1", "stripe_8", "stripe_128x8x8")
# rows mode takes 128-cell chunks
ROWS = tuple(k for k in CASES if k != "stripe_8x8x1")


def _fill(rng, kind, cells):
    if kind == "zero":
        return np.zeros(cells, np.float32)
    if kind == "raw":  # VLESC4 everywhere: 5 bytes a cell
        return np.full(cells, 3e9, np.float32) * rng.choice([-1, 1], cells)
    v = rng.standard_normal(cells) * rng.choice([0.3, 3.0, 300.0, 3e4, 1e7, 3e9], cells)
    v[rng.random(cells) < (0.9 if kind == "sparse" else 0.3)] = 0.0
    if kind == "sparse":
        v[: cells // 3] = 0.0  # a long run across chunks
    return v.astype(np.float32)


def make(name, device="cpu"):
    """The case's emit inputs on `device`: dict(coeffs, mulfacs, desc,
    chunk_bytes, chunk_base, total, block), `coeffs` the volume-order plane
    and `block` set for the stripe route's cases, else block-major (nnn,
    cells) coefficients and `block` None; the table is per block (one
    mulfac a block, 10^-1 to 10^1)."""
    block, shape, kinds = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name) + 100)
    nnn = int(np.prod(blocks.grid_shape(shape, block)))
    cells = block[0] * block[1] * block[2]
    mulfacs = (10.0 ** rng.uniform(-1, 1, nnn)).astype(np.float32)
    bm = np.stack([_fill(rng, kinds[i % len(kinds)], cells) / mulfacs[i]
                   for i in range(nnn)]).astype(np.float32)
    coeffs = torch.from_numpy(bm)
    mf = torch.from_numpy(mulfacs)
    if name in STRIPE:
        plane = blocks.from_blocks(coeffs, shape, block)
        desc, cb, _, _ = tokenize.tokenize_stripe_plain(plane, mf, block)
        coeffs = plane
    else:
        desc, cb, _, _ = tokenize.tokenize_blocks_plain(coeffs, mf)
        block = None
    cb64 = cb.to(torch.int64)
    out = dict(coeffs=coeffs, mulfacs=mf, desc=desc, chunk_bytes=cb,
               chunk_base=torch.cumsum(cb64, 0) - cb64)
    out = {k: v.to(device) for k, v in out.items()}
    return dict(out, total=int(cb64.sum()), block=block)


def rows_of(c, seed=7):
    """The case's chunks as gathered rows for `emit_rows`, in a shuffled
    order: every chunk that holds a token before the raw decision (so the
    rows of a raw block's chunks, whose counts are 0, are among them), each
    with its 128 coefficients and descriptors.  Returns (rows, drows, ids)."""
    desc = c["desc"]
    nnn, cells = desc.shape
    held = ((desc & 7).view(-1, 128).sum(1) > 0).nonzero().view(-1)
    ids = held[torch.from_numpy(np.random.default_rng(seed).permutation(held.numel()))
               .to(held.device)]
    cpb = cells // 128
    cell = (ids % cpb)[:, None] * 128 + torch.arange(128, device=desc.device)
    if c["block"] is None:
        rows = c["coeffs"].reshape(-1, 128)[ids]
    else:
        rows = c["coeffs"].reshape(-1)[geometry.stripe_addr(
            ids[:, None] // cpb, cell, c["coeffs"].shape, c["block"])]
    return rows.contiguous(), desc.view(-1, 128)[ids].contiguous(), ids.to(torch.int32)
