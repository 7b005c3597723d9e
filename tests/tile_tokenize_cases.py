"""Inputs that straddle the tile seams of csrc/tokenize_compact.cu
(`tokenize_compact`, K14) and csrc/block_encode_local.cu (`block_scale_tok`,
K10b): 16,384-cell tiles, a block over many of them, and the two
decoupled look-backs (the zero run inside a block, the live-row count over
the whole grid), shared by the CPU tests (tests/test_torch_tile_tokenize.py,
a numpy model of the kernels' tile work) and the card's
(tests/test_torch_cuda.py).  numpy only: no jax, no torch."""

import numpy as np

TILE = 1 << 14  # cells per tile (ops/tokenize.py `TILE`)
SLICE_CELLS = 1 << 21  # a 128^3 block


def _noise(rng, n, amp, zero_share):
    v = (rng.standard_normal(n) * amp).astype(np.float32)
    v[rng.random(n) < zero_share] = 0.0
    return v


def compact_case(kind):
    """(coeffs (nnn, cells) f32, mulfacs (nnn,) f32) for tokenize_compact:
    "stretch": two 128^3 blocks (128 tiles each): non-zero cells on tile
    edges, an all-zero stretch of 90 tiles inside block 0 (tiles with no
    live chunk between live ones), a run that ends in a tile's first cell
    and one that ends in its last; block 1 all zero but one cell;
    "256": one 256^3 block over 1,024 tiles, a few cells far apart;
    "small_blocks": five 32^3 blocks (two a tile, the last tile half full)
    of sparse noise, one all zero, one with live chunks only at its end;
    "raw": 1,024-cell blocks (16 a tile, 3 tiles) of wide values, some
    blocks raw (over 4 bytes a cell), some not;
    "nan": two 128^3 blocks, a NaN cell and INT32_MIN-sized values in a
    tile of noise, the rest zero."""
    rng = np.random.default_rng({"stretch": 1, "256": 2, "small_blocks": 3, "raw": 4,
                                 "nan": 5}[kind])
    if kind == "stretch":
        c = np.zeros((2, SLICE_CELLS), np.float32)
        c[0, 5] = 3.0
        c[0, TILE - 1] = -2.0  # the last cell of tile 0
        c[0, 2 * TILE] = 7.0  # the first cell of tile 2
        c[0, 2 * TILE + 1: 3 * TILE] = _noise(rng, TILE - 1, 30, 0.8)
        c[0, 94 * TILE + 300] = 1.5  # after a stretch of 90 zero tiles
        c[0, 127 * TILE - 1] = 4.0
        c[1, SLICE_CELLS - 1] = -9.0
        return c, np.array([1.0, 0.5], np.float32)
    if kind == "256":
        c = np.zeros((1, 1 << 24), np.float32)
        c[0, 3] = 2.0
        c[0, 300 * TILE + 77] = -5.0
        c[0, 1000 * TILE - 1] = 1.0
        c[0, 1020 * TILE: 1020 * TILE + 512] = _noise(rng, 512, 50, 0.5)
        return c, np.array([1.0], np.float32)
    if kind == "small_blocks":
        cells = 1 << 15
        c = _noise(rng, 5 * cells, 20, 0.97).reshape(5, cells)
        c[2] = 0.0
        c[3, : cells - 200] = 0.0
        return c, np.array([1.0, 0.25, 1.0, 3.0, 1.0], np.float32)
    if kind == "raw":
        c = _noise(rng, 48 * 1024, 1e4, 0.02).reshape(48, 1024)
        c[::3] *= 1e-3
        return c, np.full(48, 1e4, np.float32)
    if kind == "nan":
        c = np.zeros((2, SLICE_CELLS), np.float32)
        c[0, 40 * TILE: 41 * TILE] = _noise(rng, TILE, 10, 0.6)
        c[0, 40 * TILE + 123] = np.nan
        c[0, 40 * TILE + 500: 40 * TILE + 508] = 3e9  # out of range: INT32_MIN
        c[1, 7] = 1.0
        return c, np.array([1.0, 1.0], np.float32)
    raise ValueError(kind)


COMPACT_KINDS = ("stretch", "256", "small_blocks", "raw", "nan")


def local_case(kind):
    """(coeffs (nnn, 2^21) f32, scale) for block_scale_tok (its partials are
    the plain slice sums of the coefficients):
    "stretch": block 0 non-zero in slices 0, 3 (its first and last cells)
    and 100 only (a zero stretch of 96 slices), block 1 all zero but its
    last cell, block 2 all zero (rms 0: mulfac 1.0);
    "raw_nan": block 0 zero but a NaN cell and a few values (rms NaN:
    mulfac 1.0), block 1 noise at a scale that makes it raw."""
    rng = np.random.default_rng({"stretch": 6, "raw_nan": 7}[kind])
    if kind == "stretch":
        c = np.zeros((3, SLICE_CELLS), np.float32)
        c[0, 100: 140] = _noise(rng, 40, 1, 0.0)
        c[0, 3 * TILE] = 2.0
        c[0, 4 * TILE - 1] = -3.0
        c[0, 100 * TILE + 5000: 100 * TILE + 5400] = _noise(rng, 400, 0.5, 0.5)
        c[1, SLICE_CELLS - 1] = 1.0
        return c, 1e-2
    if kind == "raw_nan":
        c = np.zeros((2, SLICE_CELLS), np.float32)
        c[0, 17 * TILE + 3] = np.nan
        c[0, 60 * TILE: 60 * TILE + 64] = 5.0
        c[1] = rng.standard_normal(SLICE_CELLS).astype(np.float32)
        return c, 1e-8
    raise ValueError(kind)


LOCAL_KINDS = ("stretch", "raw_nan")
