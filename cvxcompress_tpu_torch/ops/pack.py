"""The payload emitter: tokens -> block-ordered byte stream (the K2 + K3
and K7 port).

`emit_chunks` launches csrc/block_emit.cu on CUDA tensors and runs
`emit_chunks_plain` on CPU tensors, for every geometry: the 32^3 blocks
of ops/tokenize.py `fused_encode`, the 128^3 blocks of
ops/fused_compress.py, ops/tokenize.py `stripe_fused_encode` and the stripe
route's `encode`.  The stream is laid out by min(128, cells)-cell chunk:
each chunk's tokens land at its own base, the exclusive cumsum of the
chunk byte counts (0 in raw blocks), and the kernel reads only the chunks
whose count is not 0.  The output is the dense (total,) uint8 payload of
the non-raw blocks in container block order; raw-fallback blocks are
absent and the host splices their coefficients in
(`rle_device.assemble_payload_blockorder`).  TPU counterparts:
`pack_pallas.pack_staging` (:515) inside `rle_device.pack_active` (:401),
and at 32^3 `pack_pallas.pack_staging_seg` (:479) and
`pack_pallas.tile_compact` (:605) inside
`rle_device.pack_active_stripe_seg` (:547).

`emit_rows` (the same kernel in its rows mode) writes that stream from
gathered chunk rows instead, as K7 does in the JAX package's
`pack_compacted` (`rle_device.py:969`) and patch `pack_active`: row r holds
chunk ids[r], whose tokens land at its chunk base with its block's mulfac.
The rows come from `patch_extract` (csrc/patch_extract.cu; K17
`pack_pallas.patch_extract` :94, under `CVX_STRIPE=patch`), which gathers
the live chunks of the stripe route's volume-order plane, or from
ops/tokenize.py `tokenize_compact` (K14, under `CVX_FUSED_COMPACT=1`).
"""

from __future__ import annotations

import torch

from . import _kernels, blocks, geometry, quant, rle_device
from .tokenize import scaled


def _byte(v, k):
    return (v >> (8 * k)) & 0xFF


def token_bytes(coeffs, mulfacs, desc):
    """The five byte planes of every cell's (<= 5-byte) token, and its cost;
    `mulfacs` holds one mulfac per row of `coeffs`.

    Byte values follow the grammar of oracle/rle.py; a packed group splits
    per lane (VLESC2_8x = lane 0 [code, i16] + lanes 1..7 [i16]).  Mirrors
    `cvxcompress_tpu/ops/rle_device.py:_planes`.
    """
    fv = scaled(coeffs, mulfacs)
    iv = quant.quantize(fv)
    izero, is_byte, is_short, is_i3 = rle_device.classify(iv)
    mode = rle_device.group_modes(izero, is_byte, is_short, is_i3)
    cost = desc & 7
    rl = desc >> 4  # non-negative: run_len < 2^24
    lane0 = (torch.arange(iv.shape[-1], device=iv.device) % 8 == 0)[None, :]
    pb, ps, p3 = mode == 1, mode == 2, mode == 3
    cb = is_byte & ~izero
    cs = is_short & ~is_byte
    c3 = is_i3 & ~is_short
    fvb = fv.view(torch.int32)
    b0, b1, b2 = _byte(iv, 0), _byte(iv, 1), _byte(iv, 2)

    def sel(*pairs):
        out = pairs[-1]
        for i in range(len(pairs) - 3, -1, -2):
            out = torch.where(pairs[i], pairs[i + 1], out)
        return out

    run_code = torch.where(cost == 1, 0, torch.where(cost == 2, 127, 125))
    plane0 = sel(
        pb, b0,
        ps, torch.where(lane0, 0x82, b0),
        p3, torch.where(lane0, 0x7E, b0),
        izero, run_code,
        cb, b0,
        cs, 0x83,
        c3, 0x81,
        torch.full_like(iv, 0x80),
    )
    plane1 = sel(
        ps, torch.where(lane0, b0, b1),
        p3, torch.where(lane0, b0, b1),
        izero, _byte(rl, 0),
        cs | c3, b0,
        _byte(fvb, 0),
    )
    plane2 = sel(
        ps, b1,  # read only for lane 0 (cost 3)
        p3, torch.where(lane0, b1, b2),
        izero, _byte(rl, 1),
        cs | c3, b1,
        _byte(fvb, 1),
    )
    plane3 = sel(p3, b2, izero, _byte(rl, 2), c3, b2, _byte(fvb, 2))
    plane4 = torch.where(izero, 0, _byte(fvb, 3))  # split run: trailing [0]
    return (plane0, plane1, plane2, plane3, plane4), cost


def chunk_bases(chunk_bytes):
    """Each chunk's base in the stream: the exclusive cumsum of the (nchunks,)
    int32 chunk byte counts, as int64."""
    cb = chunk_bytes.to(torch.int64)
    return torch.cumsum(cb, 0) - cb


def _check_table(mulfacs, nnn):
    if mulfacs.shape != (nnn,):
        raise ValueError(f"the mulfac table must be ({nnn},), got "
                         f"{tuple(mulfacs.shape)}")


def _emit_rows_plain(rows, row_mulfacs, drows, row_bytes, row_base, total):
    """The stream of chunk rows: row r's tokens at row_base[r] unless
    row_bytes[r] is 0 (a raw block's chunk)."""
    planes, cost = token_bytes(rows, row_mulfacs, drows)
    cost = torch.where((row_bytes == 0)[:, None], 0, cost)
    pos = row_base[:, None] + (torch.cumsum(cost, dim=1) - cost)
    out = torch.zeros(total, dtype=torch.uint8, device=rows.device)
    for k, plane in enumerate(planes):
        m = cost > k
        out[pos[m] + k] = plane[m].to(torch.uint8)
    return out


def emit_chunks_plain(coeffs, mulfacs, desc, chunk_bytes, chunk_base, total,
                      block=None):
    """Plain PyTorch version of the chunk kernel (same stream)."""
    if block is not None:
        coeffs = blocks.to_blocks(coeffs, block)
    chunk = rle_device.chunk_cells(desc.shape[1])
    rows = coeffs.reshape(-1, chunk)
    per_chunk = mulfacs.repeat_interleave(rows.shape[0] // mulfacs.numel())
    return _emit_rows_plain(rows, per_chunk, desc.reshape(-1, chunk), chunk_bytes,
                            chunk_base, total)


def emit_chunks(coeffs, mulfacs, desc, chunk_bytes, chunk_base, total,
                block=None):
    """Block-ordered payload stream (total,) uint8 of the non-raw blocks.

    coeffs f32 unscaled: block-major (nnn, cells), or, with `block` given,
    the stripe route's volume-order (nzp, nyp, nxp) plane, which the kernel
    reads through the stripe map (ops/geometry.py); mulfacs (nnn,) f32, desc
    (nnn, cells) int32 block-major, chunk_bytes (nchunks,) int32 per
    min(128, cells)-cell chunk (0 for every chunk of a raw block), chunk_base
    (nchunks,) int64 the exclusive cumsum of chunk_bytes; `total` is their
    sum.
    """
    nnn, cells = desc.shape
    _check_table(mulfacs, nnn)
    if coeffs.device.type == "cpu":
        return emit_chunks_plain(coeffs, mulfacs, desc, chunk_bytes, chunk_base,
                                 total, block)
    _kernels.check_cuda(
        coeffs, mulfacs, desc, chunk_bytes, chunk_base,
        dtypes=(torch.float32, torch.float32, torch.int32, torch.int32,
                torch.int64),
    )
    chunk = rle_device.chunk_cells(cells)
    nchunks = chunk_bytes.numel()
    if (coeffs.numel() != nchunks * chunk or desc.numel() != coeffs.numel()
            or chunk_base.numel() != nchunks or cells & (cells - 1)):
        raise ValueError(f"{nchunks} chunks of {chunk} cells need "
                         f"{nchunks * chunk} coefficients and descriptors and "
                         f"{nchunks} bases, got {coeffs.numel()}, {desc.numel()}, "
                         f"{chunk_base.numel()}")
    stripe = (1, *geometry.map_args(coeffs.shape, block)) if block else (0,) * 8
    out = torch.empty(total, dtype=torch.uint8, device=coeffs.device)
    _kernels.launch(
        "block_emit", coeffs.data_ptr(), mulfacs.data_ptr(), desc.data_ptr(),
        chunk_bytes.data_ptr(), chunk_base.data_ptr(), nchunks,
        chunk.bit_length() - 1, (cells // chunk).bit_length() - 1, *stripe,
        out.data_ptr(),
    )
    return out


def _lcpb(nchunks, nnn):
    """log2 of the chunks per block."""
    return (nchunks // nnn).bit_length() - 1


def emit_rows_plain(rows, drows, ids, mulfacs, chunk_bytes, chunk_base, total):
    """Plain PyTorch version of `emit_rows` (same stream)."""
    ids = ids.to(torch.int64)
    mf = mulfacs[ids >> _lcpb(chunk_bytes.numel(), mulfacs.numel())]
    return _emit_rows_plain(rows, mf, drows, chunk_bytes[ids], chunk_base[ids], total)


def emit_rows(rows, drows, ids, mulfacs, chunk_bytes, chunk_base, total):
    """Block-ordered payload stream (total,) uint8 from gathered chunk rows.

    rows (n, 128) f32 UNSCALED coefficients and drows (n, 128) int32
    descriptors of chunks ids (n,) int32 (any order); mulfacs (nnn,) f32,
    chunk_bytes (nchunks,) int32 (0 for a raw block's chunk: its row writes
    nothing), chunk_base (nchunks,) int64 their exclusive cumsum, `total`
    their sum.  Every chunk whose count is not 0 must have one row.  Kernel
    `block_emit_rows` (csrc/block_emit.cu rows mode); the plain version
    runs for CPU tensors.
    """
    if rows.device.type == "cpu":
        return emit_rows_plain(rows, drows, ids, mulfacs, chunk_bytes, chunk_base,
                               total)
    _kernels.check_cuda(
        rows, drows, ids, mulfacs, chunk_bytes, chunk_base,
        dtypes=(torch.float32, torch.int32, torch.int32, torch.float32, torch.int32,
                torch.int64),
    )
    n = ids.numel()
    nchunks = chunk_bytes.numel()
    if (rows.shape != (n, 128) or drows.shape != (n, 128)
            or chunk_base.numel() != nchunks or nchunks % mulfacs.numel()):
        raise ValueError(f"{n} rows need (n, 128) coefficients and descriptors and "
                         f"{nchunks} bases, got {tuple(rows.shape)}, "
                         f"{tuple(drows.shape)}, {chunk_base.numel()}")
    out = torch.empty(total, dtype=torch.uint8, device=rows.device)
    _kernels.launch(
        "block_emit_rows", rows.data_ptr(), drows.data_ptr(), ids.data_ptr(), n,
        mulfacs.data_ptr(), chunk_bytes.data_ptr(), chunk_base.data_ptr(),
        _lcpb(nchunks, mulfacs.numel()), out.data_ptr(),
    )
    return out


PATCH_TILE = 256  # chunks a tile of csrc/patch_extract.cu


def patch_extract_plain(plane, desc, chunk_bytes, block, nlive):
    """Plain PyTorch version of `patch_extract` (same rows)."""
    ids = torch.nonzero(chunk_bytes > 0).view(-1)
    if ids.numel() != nlive:
        raise ValueError(f"{ids.numel()} live chunks, {nlive} given")
    cpb = desc.shape[1] // 128
    cell = (ids % cpb)[:, None] * 128 + torch.arange(128, device=plane.device)
    rows = plane.reshape(-1)[geometry.stripe_addr(ids[:, None] // cpb, cell,
                                                  plane.shape, block)]
    return rows, desc.view(-1, 128)[ids], ids.to(torch.int32)


def patch_extract(plane, desc, chunk_bytes, block, nlive):
    """The live chunks' rows of the stripe route (K17 port, kernel
    `patch_extract`, csrc/patch_extract.cu): for each chunk whose byte count
    is not 0, in chunk order, its 128 UNSCALED coefficients gathered from the
    volume-order (nzp, nyp, nxp) plane (128 // bx x-rows of one block column
    when `geometry.patch_ok`; any 128-cell chunk through the stripe map) and
    its 128 descriptors of the block-major desc (nnn, cells).  `nlive` is
    the number of live chunks (from the codec's one read-back).  Returns
    rows (nlive, 128) f32, drows (nlive, 128) int32, ids (nlive,) int32.
    One launch, no other kernel: it counts the live chunks, ranks them
    across tiles of PATCH_TILE chunks by a decoupled look-back on a scratch
    the launcher zeroes, and copies each once.  The plain version runs for
    CPU tensors."""
    nnn, cells = desc.shape
    if (cells < 128 or plane.numel() != nnn * cells
            or chunk_bytes.numel() != nnn * cells // 128):
        raise ValueError(f"patch_extract takes 128-cell chunks of a whole plane, got "
                         f"{cells} cells per block, plane {tuple(plane.shape)}, "
                         f"{chunk_bytes.numel()} chunks")
    if plane.device.type == "cpu":
        return patch_extract_plain(plane, desc, chunk_bytes, block, nlive)
    _kernels.check_cuda(plane, desc, chunk_bytes,
                        dtypes=(torch.float32, torch.int32, torch.int32))
    _kernels.check_aligned(desc)
    if plane.data_ptr() % 16:  # the kernel reads the plane as float4s
        plane = plane.clone()
    rows = torch.empty((nlive, 128), dtype=torch.float32, device=plane.device)
    drows = torch.empty((nlive, 128), dtype=torch.int32, device=plane.device)
    ids = torch.empty(nlive, dtype=torch.int32, device=plane.device)
    if nlive == 0:
        return rows, drows, ids
    nchunks = chunk_bytes.numel()
    scratch = torch.empty(1 + -(-nchunks // PATCH_TILE), dtype=torch.int32,
                          device=plane.device)
    _kernels.launch(
        "patch_extract", plane.data_ptr(), desc.data_ptr(), chunk_bytes.data_ptr(),
        nchunks, nlive, *geometry.map_args(plane.shape, block), scratch.data_ptr(),
        rows.data_ptr(), drows.data_ptr(), ids.data_ptr(),
    )
    return rows, drows, ids
