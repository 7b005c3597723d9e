"""Inputs for `patch_extract` (csrc/patch_extract.cu) at the places its walk
can go wrong: tiles of 256 chunks, a warp a window of 32 chunk counts, the
live lanes ranked by a ballot, the tiles' counts joined by a decoupled
look-back.  Shared by the CPU tests (tests/test_torch_patch_walk.py, a
numpy model of the launch) and the card's (tests/test_torch_cuda.py).  The
data is made from seeds with numpy; the descriptors and chunk counts come
from the port's plain tokenize of a volume-order plane (no jax)."""

import numpy as np
import torch

from cvxcompress_tpu_torch.ops import blocks, tokenize

# name -> (block (bx, by, bz), volume shape (nz, ny, nx), kinds): the
# volume is cut into `block` blocks of one kind each, in raster order
# ("zero": all zero, so its only token, the run's, lies in its last chunk;
# "raw": over 4 bytes a cell, so its chunks count 0; "sparse", "dense":
# every token class, zero runs across chunks)
CASES = {
    # the patch route's blocks, small planes: 128 // bx x-rows a chunk
    "block_8x16x8": ((8, 16, 8), (24, 48, 72), ("sparse", "zero", "dense", "raw", "sparse")),
    "block_16": ((16, 16, 16), (32, 48, 64), ("dense", "sparse", "zero", "raw")),
    "block_32": ((32, 32, 32), (64, 64, 96), ("sparse", "dense", "zero")),
    "block_64": ((64, 64, 64), (64, 64, 128), ("sparse", "zero")),
    # every block raw: no chunk is live
    "no_live": ((16, 16, 16), (16, 32, 32), ("raw",)),
    # every chunk live (the launcher's shape for half the chunks live or
    # more), at 8 chunks a block (the x-neighbour copy order) and 32
    "all_live": ((8, 16, 8), (32, 64, 96), ("dense",)),
    "all_live_16": ((16, 16, 16), (32, 64, 64), ("dense",)),
    # the last block all zero: its last window holds one live chunk, lane 31
    "last_window_one": ((32, 32, 32), (32, 32, 96), ("dense", "sparse", "zero")),
    # raw blocks between live ones, their chunks counting 0
    "raw_between": ((16, 16, 16), (16, 32, 96), ("sparse", "raw", "dense", "raw", "zero",
                                                 "sparse")),
}


def _fill(rng, kind, cells):
    if kind == "zero":
        return np.zeros(cells, np.float32)
    if kind == "raw":  # VLESC4 everywhere: 5 bytes a cell
        return np.full(cells, 3e9, np.float32) * rng.choice([-1, 1], cells)
    if kind == "dense":  # small values, every cell but a few non-zero
        v = rng.standard_normal(cells) * rng.choice([3.0, 300.0, 3e4], cells)
        v[rng.random(cells) < 0.05] = 0.0
        return v.astype(np.float32)
    v = rng.standard_normal(cells) * rng.choice([0.3, 3.0, 300.0, 3e4, 1e7, 3e9], cells)
    v[rng.random(cells) < 0.9] = 0.0
    v[: cells // 3] = 0.0  # a long run across chunks
    return v.astype(np.float32)


def make(name, device="cpu"):
    """The case's `patch_extract` inputs on `device`: dict(plane, desc,
    chunk_bytes, block, nlive): the volume-order (nz, ny, nx) plane of
    UNSCALED coefficients, its block-major descriptors and chunk counts
    (`tokenize_stripe_plain` at one mulfac a block, 10^-1 to 10^1, raw
    blocks' counts 0), the number of live chunks."""
    block, shape, kinds = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name) + 300)
    nnn = int(np.prod(blocks.grid_shape(shape, block)))
    cells = block[0] * block[1] * block[2]
    mulfacs = (10.0 ** rng.uniform(-1, 1, nnn)).astype(np.float32)
    bm = np.stack([_fill(rng, kinds[i % len(kinds)], cells) / mulfacs[i]
                   for i in range(nnn)]).astype(np.float32)
    plane = blocks.from_blocks(torch.from_numpy(bm), shape, block)
    desc, cb, _, _ = tokenize.tokenize_stripe_plain(plane, torch.from_numpy(mulfacs), block)
    out = dict(plane=plane, desc=desc, chunk_bytes=cb)
    out = {k: v.to(device) for k, v in out.items()}
    return dict(out, block=block, nlive=int((cb > 0).sum()))
