"""The compress kernel: 32^3 forward wavelet + scale + tokenize (K1 and K9
port).

`fused_encode` launches csrc/fused_encode.cu on a CUDA volume and runs
`fused_encode_plain` on a CPU volume.  Both return, for the (nnn) 32^3
blocks in raster order:

    coeffs      (nnn, 32768) f32   UNSCALED wavelet coefficients, block-major
    desc        (nnn, 32768) int32 per-cell token descriptor (ops/rle_device.py)
    chunk_bytes (nnn * 256,) int32 payload bytes per 128-cell chunk (0 when
                                   raw), what `pack.emit_chunks` takes
    sizes       (nnn,) int32       payload bytes per block (4*cells when raw)
    raw         (nnn,) bool        raw-fallback flag
    mulfacs     (nnn,) f32         the mulfac each block was quantized with

(the order of `stripe_fused_encode`'s outputs).

Under the global RMS every block has the given mulfac; under the local RMS
each block's comes from its own coefficients (ops/quant.py `local_rms`),
and the kernel launches as `fused_encode_local`.  Kernel and plain version
run the multi-level 7/9 cascade in the native library's order (x, y, z;
`wavelet.cascade_3d`), so they agree bit for bit and the coefficients are
those of native's parity codec (`cvx_compress_parity_th`).

TPU counterpart: `cvxcompress_tpu/ops/tokenize_pallas.py`
`stripe_fused_encode` (:1056), whose kernel is `stripe_fused_tiles` (:939;
the local branch `_kernel_stripe_fused_local` :907).

Every other geometry (ops/geometry.py) runs `stripe_fused_encode` (one
kernel from the volume to the tokens, csrc/stripe_fused.cu, where the JAX
gate `stripe_fused_ok` holds: the K1 and K9 port at 16^3, (16, 16, 1), ...)
or `encode`: the transform (`wavelet.forward_3d_volume`, kernel
`plane_cascade_fwd`), the mulfac table, then the kernel `tokenize_stripe` (the volume-order plane read through the
stripe map, csrc/tokenize_stripe.cu: the K13 port, and of K12 and K12').

Under `CVX_FUSED_COMPACT=1` (ops/geometry.py) `compact_encode` runs instead:
the block-major transform (`wavelet.forward_blocks_of_volume`, kernel
`plane_cascade_fwd` from the volume into the block batch) and the table, then `tokenize_compact` (csrc/tokenize_compact.cu, the K14 port), which also
compacts the live chunks into rows for `pack.emit_rows`.
"""

from __future__ import annotations

import math

import torch

from . import _kernels, blocks, geometry, quant, rle_device, wavelet

BLOCK = (32, 32, 32)
CELLS = 32 * 32 * 32


def scaled(coeffs, mulfac):
    """fv = coeffs * mulfac in f32, one rounding (oracle/rle.py:63); `mulfac`
    is one number or one per row of `coeffs`."""
    m = torch.as_tensor(mulfac, dtype=torch.float32, device=coeffs.device)
    return coeffs * (m[:, None] if m.dim() else m)


def fused_encode_plain(vol, mulfac=None, *, scale=None):
    """Plain PyTorch version of the kernel (same outputs)."""
    local = quant.is_local(mulfac, scale)
    coeffs = wavelet.cascade_3d(blocks.to_blocks(vol, BLOCK), inverse=False)
    coeffs = coeffs.reshape(-1, CELLS)
    if local:
        mulfacs = quant.mulfac_from_rms(quant.local_rms(coeffs), scale)
    else:
        mulfacs = torch.full((coeffs.shape[0],), mulfac, dtype=torch.float32,
                             device=coeffs.device)
    return (coeffs, *tokenize_blocks_plain(coeffs, mulfacs), mulfacs)


def fused_encode(vol, mulfac=None, *, scale=None):
    """(nz, ny, nx) f32 volume -> (coeffs, desc, chunk_bytes, sizes, raw,
    mulfacs); see the module doc.  Global RMS: every block at `mulfac`.
    Local RMS: give `scale` instead, and each block's mulfac is
    1/(rms*scale) of its own coefficients."""
    local = quant.is_local(mulfac, scale)
    if vol.device.type == "cpu":
        return fused_encode_plain(vol, mulfac, scale=scale)
    _kernels.check_cuda(vol, dtypes=(torch.float32,))
    nz, ny, nx = vol.shape
    nbz, nby, nbx = blocks.grid_shape(vol.shape, BLOCK)
    nnn = nbz * nby * nbx
    dev = vol.device
    coeffs = torch.empty((nnn, CELLS), dtype=torch.float32, device=dev)
    desc, chunk_bytes, sizes = _outputs(nnn, CELLS, dev)
    raw = torch.empty((nnn,), dtype=torch.bool, device=dev)
    mulfacs = torch.empty((nnn,), dtype=torch.float32, device=dev)
    _kernels.launch(
        "fused_encode_local" if local else "fused_encode",
        vol.data_ptr(), nx, ny, nz, float(scale if local else mulfac),
        coeffs.data_ptr(), desc.data_ptr(), chunk_bytes.data_ptr(), sizes.data_ptr(),
        raw.data_ptr(), mulfacs.data_ptr(),
    )
    return coeffs, desc, chunk_bytes, sizes, raw, mulfacs


# -- every other geometry ------------------------------------------------------

TILE = 1 << 14  # cells per tile of csrc/tokenize_stripe.cu and tokenize_compact.cu


def raw_fallback(desc, chunk_bytes, sizes):
    """The raw-fallback decision on the block sums of an (n, cells) tokenize
    (the XLA epilogues of `tokenize_desc_fast2`, `cvxcompress_tpu/ops/
    tokenize_pallas.py:487-491`, and of the 128^3 path, `fused_compress.py:
    613-617`): a block over 4*cells bytes is stored raw, its chunks count 0
    bytes.  Returns (desc, chunk_bytes, sizes, raw)."""
    return (desc, *_raw_decision(chunk_bytes, sizes, desc.shape[1]))


def _raw_decision(chunk_bytes, sizes, cells):
    """(chunk_bytes, sizes, raw) after the raw-fallback decision of blocks
    of `cells` cells; chunk_bytes is zeroed in place in the raw blocks."""
    raw = sizes > rle_device.RAW_BYTES_PER_CELL * cells
    sizes = torch.where(raw, rle_device.RAW_BYTES_PER_CELL * cells, sizes)
    chunk_bytes.view(sizes.numel(), -1).masked_fill_(raw[:, None], 0)
    return chunk_bytes, sizes, raw


def tokenize_blocks_plain(coeffs, mulfacs):
    """The tokenize of block-major UNSCALED (n, cells) coefficients, each
    block at its entry of the (n,) table, plain: (desc, chunk_bytes per
    min(128, cells)-cell chunk, sizes, raw)."""
    n, cells = coeffs.shape
    desc, _, _ = rle_device.tokenize(scaled(coeffs, mulfacs))
    chunk_bytes = (desc & 7).view(-1, rle_device.chunk_cells(cells)).sum(
        1, dtype=torch.int32)
    sizes = chunk_bytes.view(n, -1).sum(1, dtype=torch.int32)
    return raw_fallback(desc, chunk_bytes, sizes)


def tokenize_stripe_plain(plane, mulfacs, block):
    """Plain PyTorch version of `tokenize_stripe`: the plane gathered to
    block-major, then `tokenize_blocks_plain`."""
    coeffs = blocks.to_blocks(plane, block).view(mulfacs.shape[0], -1)
    return tokenize_blocks_plain(coeffs, mulfacs)


def _outputs(nnn, cells, dev):
    """Empty (desc, chunk_bytes, sizes) of a tokenize."""
    return (torch.empty((nnn, cells), dtype=torch.int32, device=dev),
            torch.empty(nnn * cells // rle_device.chunk_cells(cells),
                        dtype=torch.int32, device=dev),
            torch.empty(nnn, dtype=torch.int32, device=dev))


def tokenize_stripe(plane, mulfacs, block):
    """Tokenize the UNSCALED coefficients of a volume-order (nzp, nyp, nxp)
    f32 plane (ops/wavelet.py `forward_3d_volume`), each block at its entry
    of the (nnn,) f32 mulfac table, read in place through the stripe map
    (kernel `tokenize_stripe`, csrc/tokenize_stripe.cu: the K13 port, and of
    K12 and K12' at the blocks where the JAX package relayouts first).

    Returns, block-major, desc (nnn, cells) int32, chunk_bytes (nnn * cells /
    chunk,) int32 per min(128, cells)-cell chunk (0 in a raw block), sizes
    (nnn,) int32 (4*cells when raw) and raw (nnn,) bool.  The plain version
    runs for a CPU tensor.  TPU counterparts:
    `tokenize_pallas.tokenize_desc_stripe_fast` (:1228), whose volume-order
    descriptors and per-(row, block column) counts are TPU layouts (held
    against these through `stripe_rowmap` in tests/test_torch_stripe.py),
    and `tokenize_desc_fast2` (:478) on chunk-major coefficients
    (tests/test_torch_generic.py)."""
    if plane.dim() != 3 or any(n % b for n, b in zip(plane.shape, block[::-1])):
        raise ValueError(f"the plane must be (nzp, nyp, nxp) in whole {block} "
                         f"blocks, got {tuple(plane.shape)}")
    if plane.device.type == "cpu":
        return tokenize_stripe_plain(plane, mulfacs, block)
    _kernels.check_cuda(plane, mulfacs, dtypes=(torch.float32, torch.float32))
    cells = block[0] * block[1] * block[2]
    nnn = plane.numel() // cells
    if mulfacs.shape != (nnn,):
        raise ValueError(f"the mulfac table must be ({nnn},), got "
                         f"{tuple(mulfacs.shape)}")
    if plane.data_ptr() % 16:  # the kernel copies boxes of it by TMA
        plane = plane.clone()
    desc, chunk_bytes, sizes = _outputs(nnn, cells, plane.device)
    scratch = torch.empty(1 + -(-nnn * cells // TILE), dtype=torch.int32,
                          device=plane.device)
    _kernels.launch("tokenize_stripe", plane.data_ptr(), mulfacs.data_ptr(), nnn,
                    *geometry.map_args(plane.shape, block), scratch.data_ptr(),
                    desc.data_ptr(), chunk_bytes.data_ptr(), sizes.data_ptr())
    return raw_fallback(desc, chunk_bytes, sizes)


def encode(vol, block, mulfac=None, *, scale=None):
    """The forward transform, the mulfac table and the tokenize of a
    (nz, ny, nx) volume at a block of the "stripe" route (ops/geometry.py):
    (plane, desc, chunk_bytes, sizes, raw, mulfacs), the plane the
    volume-order coefficients.  The transform is native's cascade (kernel
    `plane_cascade_fwd`, ops/wavelet.py; XLA products in the JAX package),
    the local RMS PyTorch ops (ops/quant.py `block_table`), the tokenize the
    kernel `tokenize_stripe` (the plain versions on the CPU)."""
    plane = wavelet.forward_3d_volume(vol, block)
    mulfacs = quant.block_table(plane, block, mulfac, scale=scale)
    return (plane, *tokenize_stripe(plane, mulfacs, block), mulfacs)


def stripe_fused_encode_plain(vol, block, mulfac=None, *, scale=None):
    """Plain PyTorch version of `stripe_fused_encode` (same outputs)."""
    local = quant.is_local(mulfac, scale)
    coeffs = wavelet.cascade_3d(blocks.to_blocks(vol, block), inverse=False)
    coeffs = coeffs.reshape(coeffs.shape[0], -1)
    if local:
        mulfacs = quant.mulfac_from_rms(quant.stripe_rms(coeffs), scale)
    else:
        mulfacs = torch.full((coeffs.shape[0],), mulfac, dtype=torch.float32,
                             device=coeffs.device)
    return (coeffs, *tokenize_blocks_plain(coeffs, mulfacs), mulfacs)


def stripe_fused_encode(vol, block, mulfac=None, *, scale=None):
    """(nz, ny, nx) f32 volume -> (coeffs, desc, chunk_bytes, sizes, raw,
    mulfacs) at a block of the "stripe_fused" route (ops/geometry.py): the
    forward transform, each block's mulfac and the tokenize in one kernel
    (csrc/stripe_fused.cu; K1 and K9 port at those blocks), launched as
    `stripe_fused_encode`, or under the local RMS (give `scale` instead of
    `mulfac`: each block's mulfac is 1/(rms*scale) of its own coefficients,
    summed as ops/quant.py `stripe_rms`) as `stripe_fused_encode_local`.
    `coeffs` are the UNSCALED block-major (nnn, cells) coefficients,
    native's parity cascade (`wavelet.cascade_3d`) bit for bit; the rest as
    `tokenize_stripe`.  TPU counterpart:
    `tokenize_pallas.stripe_fused_encode` (:1056)."""
    local = quant.is_local(mulfac, scale)
    if vol.device.type == "cpu":
        return stripe_fused_encode_plain(vol, block, mulfac, scale=scale)
    _kernels.check_cuda(vol, dtypes=(torch.float32,))
    bx, by, bz = block
    cells = bx * by * bz
    if bx < 8 or by < 8 or cells < 128:
        raise ValueError(f"the fused stripe kernel takes blocks of bx, by >= 8 "
                         f"and >= 128 cells, got {block}")
    nz, ny, nx = vol.shape
    nnn = math.prod(blocks.grid_shape(vol.shape, block))
    dev = vol.device
    coeffs = torch.empty((nnn, cells), dtype=torch.float32, device=dev)
    desc, chunk_bytes, sizes = _outputs(nnn, cells, dev)
    mulfacs = torch.empty((nnn,), dtype=torch.float32, device=dev)
    _kernels.launch(
        "stripe_fused_encode_local" if local else "stripe_fused_encode",
        vol.data_ptr(), nx, ny, nz, *geometry.log2_block(block),
        float(scale if local else mulfac),
        coeffs.data_ptr(), desc.data_ptr(), chunk_bytes.data_ptr(),
        sizes.data_ptr(), mulfacs.data_ptr(),
    )
    return (coeffs, *raw_fallback(desc, chunk_bytes, sizes), mulfacs)


# -- the compacting tokenize (CVX_FUSED_COMPACT=1) ------------------------------


def tokenize_compact_plain(coeffs, mulfacs):
    """Plain PyTorch version of `tokenize_compact` (same outputs; its rows
    exactly the live ones)."""
    nnn, cells = coeffs.shape
    desc, chunk_bytes, sizes, raw = tokenize_blocks_plain(coeffs, mulfacs)
    # the live rows are those before the raw-fallback decision
    cb = (desc & 7).view(-1, 128).sum(1, dtype=torch.int32)
    ids = torch.nonzero(cb > 0).view(-1)
    nrows = torch.tensor([ids.numel()], dtype=torch.int32, device=coeffs.device)
    return (chunk_bytes, sizes, raw, coeffs.view(-1, 128)[ids],
            desc.view(-1, 128)[ids], ids.to(torch.int32), cb[ids], nrows)


def tokenize_compact(coeffs, mulfacs):
    """Tokenize block-major UNSCALED (nnn, cells) f32 coefficients (cells >=
    128), each block at its entry of the (nnn,) f32 table, and compact the
    live 128-cell chunks (byte count not 0) into rows, in chunk order
    (kernel `tokenize_compact`, csrc/tokenize_compact.cu: the K14 port).

    Returns chunk_bytes (nchunks,) int32 and sizes (nnn,) int32 and raw
    (nnn,) bool after the raw-fallback decision (as `tokenize_stripe`'s),
    then the rows: coefficients (R, 128) f32, descriptors (R, 128) int32,
    chunk ids (R,) int32, byte counts (R,) int32, and nrows (1,) int32, the
    number of live rows n.  The kernel's R is nchunks (rows past n are not
    written); the plain version, which runs for a CPU tensor, returns n
    rows.  A raw block's live chunks keep their rows (their chunk_bytes is
    0).  TPU counterpart: `tokenize_pallas.tokenize_compact_fast` (:1365),
    whose rows are scaled and padded to 8 per tile."""
    nnn, cells = coeffs.shape
    if cells < 128 or cells & (cells - 1) or mulfacs.shape != (nnn,):
        raise ValueError(f"tokenize_compact takes (nnn, 2^k >= 128) coefficients and "
                         f"an (nnn,) table, got {tuple(coeffs.shape)} and "
                         f"{tuple(mulfacs.shape)}")
    if coeffs.device.type == "cpu":
        return tokenize_compact_plain(coeffs, mulfacs)
    _kernels.check_cuda(coeffs, mulfacs, dtypes=(torch.float32, torch.float32))
    if coeffs.data_ptr() % 16:  # the kernel copies its tiles by bulk copies
        coeffs = coeffs.clone()
    dev = coeffs.device
    nchunks = coeffs.numel() // 128
    _, chunk_bytes, sizes = _outputs(nnn, cells, dev)
    rows = torch.empty((nchunks, 128), dtype=torch.float32, device=dev)
    drows = torch.empty((nchunks, 128), dtype=torch.int32, device=dev)
    ids = torch.empty(nchunks, dtype=torch.int32, device=dev)
    row_bytes = torch.empty(nchunks, dtype=torch.int32, device=dev)
    nrows = torch.zeros(1, dtype=torch.int32, device=dev)
    # the ticket, then two status words a tile
    scratch = torch.empty(1 + 2 * -(-coeffs.numel() // TILE), dtype=torch.int32,
                          device=dev)
    _kernels.launch(
        "tokenize_compact", coeffs.data_ptr(), mulfacs.data_ptr(), nnn,
        cells.bit_length() - 1, scratch.data_ptr(), chunk_bytes.data_ptr(),
        sizes.data_ptr(), rows.data_ptr(), drows.data_ptr(), ids.data_ptr(),
        row_bytes.data_ptr(), nrows.data_ptr(),
    )
    return (*_raw_decision(chunk_bytes, sizes, cells), rows, drows, ids, row_bytes,
            nrows)


def compact_encode(vol, block, mulfac=None, *, scale=None):
    """The encode under `CVX_FUSED_COMPACT=1` (ops/geometry.py `compact_ok`
    blocks): the forward transform block-major (kernel `plane_cascade_fwd`
    from the volume into the block batch, where the JAX `_stage_w_pallas`, `cvxcompress_tpu/
    ops/codec.py:71-100`, runs XLA products), the mulfac table as the stripe
    route's (`quant.block_table`), then `tokenize_compact`.  Returns (coeffs (nnn, cells), mulfacs, then
    `tokenize_compact`'s outputs)."""
    bx, by, _ = block
    coeffs = wavelet.forward_blocks_of_volume(vol, block)
    coeffs = coeffs.reshape(coeffs.shape[0], -1)
    mulfacs = quant.block_table(coeffs.view(-1, by, bx), block, mulfac, scale=scale)
    return (coeffs, mulfacs, *tokenize_compact(coeffs, mulfacs))
