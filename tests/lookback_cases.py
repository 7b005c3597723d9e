"""Inputs that straddle the seams of the decoupled look-backs of
csrc/decode_chase.cu (pieces and units of `entropy_decode.chase_shape`)
and csrc/tokenize_stripe.cu (16,384-cell tiles), shared by the
CPU tests (tests/test_torch_lookback.py) and the card's
(tests/test_torch_cuda.py).  numpy only: no jax, no torch."""

import numpy as np

E = 25  # entry offsets of the chase (ops/entropy_decode.py `E`)
SPS = 16  # subsegments per segment: the plain chase takes multiples of it
TILE = 1 << 14  # cells per tile of the stripe tokenize (ops/tokenize.py `TILE`)
STRIPE_BLOCK = (256, 256, 8)  # 2^19 cells: 32 tiles a block
STRIPE_SHAPE = (8, 256, 768)  # three such blocks side by side along x


def chase_case(nsub, piece, seed, cells):
    """(P (nsub, 25) i32, sub_reset (nsub,) bool, cells) whose chains are
    1, piece - 1, piece, piece + 1 and 2 * piece + 1 rows long, then resets
    on, one row before and one row after piece boundaries, at random places,
    and a long chain over many pieces; the rows past the chains are reset
    rows, as the plan pads (ops/entropy_decode.py `plan`).  Counts in
    [0, 600) against `cells` saturate within a chain of a few pieces when
    cells is small."""
    assert nsub % SPS == 0
    rng = np.random.default_rng(seed)
    T = rng.integers(0, E, (nsub, E))
    NV = rng.integers(0, 600, (nsub, E))
    reset = np.zeros(nsub, bool)
    k = 0
    for n in (1, piece - 1, piece, piece + 1, 2 * piece + 1):
        reset[k] = True
        k += n
    edges = np.arange(piece * (k // piece + 2), nsub // 2, piece)
    reset[k] = True
    reset[edges[::5]] = True
    reset[edges[1::5] - 1] = True
    reset[edges[2::5] + 1] = True
    reset[rng.integers(k, nsub // 2, 8)] = True
    reset[nsub // 2] = True  # then one chain over the rest but its padding
    pad = nsub - nsub // 16
    reset[pad:] = True
    return (NV * 32 + T).astype(np.int32), reset, cells


def chase_cases(shape_of):
    """The chase cases: short streams (the kernel's pieces of 32) and one
    long enough for its pieces of 128; `shape_of(nsub)` is the kernel's
    (piece, pieces a unit) (`entropy_decode.chase_shape`)."""
    out = {}
    for name, nsub, cells in (("short", 4096, 1 << 21), ("short_saturating", 4096, 4096),
                              ("long", 196 * 1024, 1 << 21)):
        out[name] = chase_case(nsub, shape_of(nsub)[0], len(out), cells)
    return out


def stripe_case(kind):
    """Block-major (3, 2^19) coefficients of three (256, 256, 8) blocks (32
    tiles each) and their mulfac table, one seam of the tokenize's
    look-back per block:
    "stretches": all-zero stretches of 20 and of 10 tiles, the second to
    the block's end, between non-zero cells, and a tile of noise;
    "last_tile": one non-zero cell in the block's last tile (a run of
    ~508,000 zeros before it), the next block all zero;
    "tile_edge": runs that end exactly on tile edges (a non-zero first cell
    of a tile after a zero stretch; a non-zero last cell of a tile before
    one), runs of 255 and 256 cells and one cell before the block's end."""
    rng = np.random.default_rng({"stretches": 1, "last_tile": 2, "tile_edge": 3}[kind])
    c = np.zeros((3, 1 << 19), np.float32)
    if kind == "stretches":
        c[0, 7] = 3.0
        c[0, TILE - 1] = -2.0
        c[0, 21 * TILE + 100] = 5.0
        noise = (rng.standard_normal(TILE) * 40).astype(np.float32)
        noise[rng.random(TILE) < 0.7] = 0.0
        c[1, 3 * TILE: 4 * TILE] = noise
        c[1, 14 * TILE + 5] = 1.0
        c[2, 31 * TILE] = 9.0
    elif kind == "last_tile":
        c[0, 31 * TILE + 777] = 4.0
        c[2, 0] = 1.0
        c[2, 31 * TILE + TILE - 1] = -1.0
    else:
        c[0, 5 * TILE] = 2.0
        c[0, 8 * TILE - 1] = 3.0
        c[0, 8 * TILE + 255] = 1.0
        c[0, 8 * TILE + 512] = 1.0
        c[1, 2 * TILE - 1] = 1.0
        c[1, 2 * TILE] = 1.0
        c[1, 4 * TILE + 3: 4 * TILE + 11] = 200.0
        c[2, (1 << 19) - 2] = 6.0
    return c, np.array([1.0, 2.0, 0.5], np.float32)
