"""Block geometry: the gates of the encode routes, the JAX package's encode
switches, and the stripe map.

Every block the reference accepts (`container.is_valid_block_size`,
CvxCompress.cpp:54-71: bx, by powers of two in [8, 256], bz one too or 1)
compresses on one of four routes by its geometry (ops/codec.py `route`,
`compress`):

- "fused32": (32, 32, 32) blocks, any volume (ops/tokenize.py `fused_encode`);
- "block128": (128, 128, 128) blocks over dims that are multiples of 128
  (ops/fused_compress.py `block_encode`);
- "stripe_fused": the other blocks where the JAX gate `stripe_fused_ok`
  holds (16^3, (16, 16, 1), (64, 32, 32), ...): one kernel from the volume
  to the tokens (ops/tokenize.py `stripe_fused_encode`), one back
  (ops/fused_inverse.py `stripe_fused_inverse`);
- "stripe": the rest (8^3, 64^3, 256^3, (128, 8, 8), (8, 8, 1), ...): the
  forward transform in volume order, then `tokenize_stripe` and
  `emit_chunks` reading the plane through the stripe map (`stripe_addr`).

The JAX package's TPU routes (`cvxcompress_tpu/ops/codec.py:328-440`
`_encode_device`) run K1 and K6 at their geometries, K1 where
`stripe_fused_ok`, K13 where only `stripe_path_ok` holds, K12 on a
block-major relayout elsewhere; the stripe map makes that relayout needless
here.  Chunks hold min(128, cells) cells (`rle_device.chunk_cells`).

The JAX package's encode switches, read on every compress with its values
and precedence (`codec.py:621-627`, then `:341-421`), select three more
encode routes (ops/codec.py `encode_route`); decompress never reads them:

- `CVX_FUSED_COMPACT=1` where `compact_ok` (first): "compact", the
  block-major transform, then `tokenize_compact` (K14) and the rows emit;
- `CVX_STRIPE=patch` where `patch_ok`: "patch", the stripe route's encode,
  then `patch_extract` (K17) and the rows emit;
- `CVX_FUSED_W` (`fused_w_mode`) at aligned 128^3: "1" under the global
  RMS is "block128_w" (K16a `block_fwd_xz` + K16b `block_encode_y`);
  "block", the default, is "block128"; "1" under the local RMS and any
  other value are the stripe route (the JAX package's K12, or K15 under
  `CVX_VOLUME_COMPRESS=1`: `tokenize_stripe` computes both).
"""

from __future__ import annotations

import math
import os

import torch

from .. import container as ctn
from . import blocks


def check_block(block):
    """The block as a tuple; ValueError unless the reference's
    Is_Valid_Block_Size accepts it."""
    block = tuple(int(b) for b in block)
    if len(block) != 3 or not ctn.is_valid_block_size(*block):
        raise ValueError(
            f"block {block} fails Is_Valid_Block_Size: bx and by must be powers "
            "of two in [8, 256], bz one too or 1 (CvxCompress.cpp:54-71)"
        )
    return block


def stripe_fused_ok(vol_shape, block):
    """The JAX gate of the fused stripe kernels K1 and K5
    (`cvxcompress_tpu/ops/tokenize_pallas.py:831` `stripe_fused_ok`, with
    `stripe_path_ok` :728 and `wavelet.padded_nbx` :280), on a valid block:
    bx < 128, by a multiple of 128 // bx, and a (bz * by, W) f32 block row
    within 3 MiB, W the x extent padded to a multiple of 128."""
    bx, by, bz = block
    if bx >= 128 or by % (128 // bx):
        return False
    k = 128 // bx
    w = -(-blocks.grid_shape(vol_shape, block)[2] // k) * k * bx
    return bz * by * w * 4 <= 3 << 20


TR = 1024  # chunk rows per tile of the JAX tokenize kernels (tokenize_pallas.TR)


def fused_compact_on():
    """`CVX_FUSED_COMPACT=1` (`cvxcompress_tpu/ops/codec.py:103-106`)."""
    return os.environ.get("CVX_FUSED_COMPACT") == "1"


def stripe_mode():
    """`CVX_STRIPE` ("seg" when unset, `codec.py:248`); only "patch"
    selects a route of its own."""
    return os.environ.get("CVX_STRIPE", "seg")


def fused_w_mode():
    """`CVX_FUSED_W` ("block" when unset, `codec.py:312`): "1" the two-pass
    x,z | y encode, "block" the whole-block one, anything else off."""
    return os.environ.get("CVX_FUSED_W", "block")


def compact_ok(vol_shape, block):
    """The JAX gate of K14 (`codec.py:624-627`): 128-cell chunks and at
    least 2 * TR of them."""
    cells = block[0] * block[1] * block[2]
    nchunks = math.prod(blocks.grid_shape(vol_shape, block)) * cells // 128
    return cells >= 128 and nchunks >= 2 * TR


def patch_ok(block):
    """The JAX gate `stripe_path_ok` (`tokenize_pallas.py:728-738`), the
    patch route's: bx < 128, by >= 8 and by a multiple of 128 // bx, so a
    128-cell chunk is 128 // bx whole x-rows of one block column."""
    bx, by, _ = block
    return 8 <= bx < 128 and by >= 8 and by % (128 // bx) == 0


def plane_shape(vol_shape, block):
    """(nzp, nyp, nxp): the volume padded to whole blocks."""
    nbz, nby, nbx = blocks.grid_shape(vol_shape, block)
    bx, by, bz = block
    return (nbz * bz, nby * by, nbx * bx)


def stripe_addr(blk, cell, vol_shape, block):
    """Offset in the flat volume-order plane (`plane_shape`) of block `blk`'s
    block-local cell `cell` (z, y, x inside the block, x fastest); integer
    tensors, broadcast.  The counterpart of `cvxcompress_tpu/ops/codec.py:151`
    `stripe_rowmap` without the TPU's x-pad to 128 lanes, and of
    `map_origin` + `map_cell` in csrc/stripe_map.cuh."""
    bx, by, bz = block
    nbz, nby, nbx = blocks.grid_shape(vol_shape, block)
    _, nyp, nxp = plane_shape(vol_shape, block)
    bxi, byi, bzi = blk % nbx, (blk // nbx) % nby, blk // (nbx * nby)
    x, y, z = cell % bx, (cell // bx) % by, cell // (bx * by)
    return ((bzi * bz + z) * nyp + byi * by + y) * nxp + bxi * bx + x


def log2_block(block):
    """log2 of bx, by, bz (powers of two)."""
    return tuple(b.bit_length() - 1 for b in block)


def map_args(vol_shape, block):
    """The stripe map as the kernels take it (csrc/stripe_map.cuh): log2 of
    bx, by, bz, then nbx, nby, nxp, nyp."""
    _, nby, nbx = blocks.grid_shape(vol_shape, block)
    _, nyp, nxp = plane_shape(vol_shape, block)
    return (*log2_block(block), nbx, nby, nxp, nyp)


def gather_blocks(plane, ids, vol_shape, block):
    """(len(ids), cells) block-major coefficients of blocks `ids` of a
    volume-order plane, through `stripe_addr`."""
    cells = block[0] * block[1] * block[2]
    ids = torch.as_tensor(ids, dtype=torch.int64, device=plane.device)
    cell = torch.arange(cells, dtype=torch.int64, device=plane.device)
    return plane.reshape(-1)[stripe_addr(ids[:, None], cell[None, :], vol_shape,
                                         block)]
