"""The codec: compress on the device; decompress on the device or the host.

Compress (CvxCompress::Compress semantics, CvxCompress.cpp:231-427), one
straight path, its kernels chosen by the block geometry (`route`,
ops/geometry.py):
  1. the global RMS: mulfac from the volume (ops/quant.py); under the local
     RMS (CvxCompress.cpp:343-348) each block's mulfac comes from its own
     coefficients instead, and the header's is 1.0;
  2. the encode: transform, each block's mulfac into an (nnn,) table,
     tokenize, per-block sizes and (but at 32^3) per-chunk byte counts
     ("fused32", 32^3: ops/tokenize.py `fused_encode`; "block128", 128^3
     over dims that are multiples of 128: ops/fused_compress.py
     `block_encode`; "stripe_fused", 16^3, (16, 16, 1), ...: one kernel,
     ops/tokenize.py `stripe_fused_encode`; "stripe", every other block:
     the transform as library products, then the kernel `tokenize_stripe`,
     ops/tokenize.py `encode`); the JAX package's encode switches select
     three more routes (`encode_route`, ops/geometry.py): "block128_w"
     (`CVX_FUSED_W=1`: ops/fused_compress.py `block_encode_w`), "patch"
     (`CVX_STRIPE=patch`: the stripe route's encode) and "compact"
     (`CVX_FUSED_COMPACT=1`: ops/tokenize.py `compact_encode`);
  3. one small read-back of the per-block sizes, raw flags and mulfacs (on
     the patch and compact routes with the number of live chunks);
  4. the exclusive cumsum of the chunks' byte counts gives every chunk's
     base in the stream;
  5. the emit kernel writes a stream of exactly that many bytes, each
     live chunk's tokens from its coefficients and its block's entry of the
     table (ops/pack.py `emit_chunks`; on the stripe route it
     reads the volume-order coefficients through the stripe map; on the
     patch route `pack.patch_extract` first gathers the live chunks' rows,
     and there and on the compact route `pack.emit_rows` writes the stream
     from the rows);
  6. one device-to-host copy of the stream (plus the raw blocks'
     coefficients, when there are any);
  7. the host assembles the container (ops/rle_device.py, container.py),
     with the `blkmulfac` table under the local RMS.

Decompress has two engines, as in the JAX package (`cvxcompress_tpu/ops/
codec.py:1490-1523`):
- "device" (`decompress_device`): the host plans (ops/entropy_decode.py
  `plan`: the payload copied into aligned rows, ∝ compressed bytes) and
  uploads one blob (each block's scalefac in it); the device parses the
  stream (decode_maps, decode_chase), emits the coefficients into a dense
  block-major buffer (decode_emit), overlays the raw blocks and runs the
  inverse on it (32^3: `fused_inverse`; aligned 128^3:
  `block_fused_inverse`; the "stripe_fused" blocks: `stripe_fused_inverse`;
  every other block: the inverse as library products, the XLA branch of
  the JAX `_inverse_from_plane`);
- "host": the native library decodes every block on the host (with the
  container's `blkmulfac` under the local RMS), only the non-zero
  min(128, cells)-cell chunks go up to the device (`sparse_chunks`), and the
  inverse runs there (at every block but 32^3 after one `index_copy_` of
  the chunks into a zeroed dense buffer).

Each stage runs inside a `torch.profiler.record_function` span named
"cvx.<stage>", so a profiler trace attributes host and device time to the
stages.

Everything runs on the CUDA card unless the caller asks for the CPU
(`device="cpu"`, where the plain PyTorch versions of the kernels run); on
a machine without a card the default raises.  `compress` and `decompress`
run inside `torch.cuda.device` of the volume's or the target's card, so
every launch and allocation goes to that card and its current stream.
Every block the reference accepts runs, with the global or the local RMS;
any other raises ValueError.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.profiler import record_function

from .. import container as ctn
from ..utils import io
from . import (
    blocks, entropy_decode, fused_compress, fused_inverse, geometry, pack, quant,
    rle_device, rle_host, tokenize, wavelet,
)

BLOCK = (32, 32, 32)


def route(vol_shape, block):
    """The encode route of a valid block: "fused32" (32^3 blocks),
    "block128" (128^3 over dims that are multiples of 128), "stripe_fused"
    (`geometry.stripe_fused_ok`) or "stripe" (the rest); ops/geometry.py."""
    block = tuple(block)
    if block == BLOCK:
        return "fused32"
    if fused_compress.fused_path_ok(vol_shape, block):
        return "block128"
    if geometry.stripe_fused_ok(vol_shape, block):
        return "stripe_fused"
    return "stripe"


def encode_route(vol_shape, block, use_local_rms):
    """The encode route under the JAX package's switches (ops/geometry.py,
    `cvxcompress_tpu/ops/codec.py:621-627`, then `:341-421`): "compact"
    (`CVX_FUSED_COMPACT=1` where `geometry.compact_ok`), "patch"
    (`CVX_STRIPE=patch` where `geometry.patch_ok`), at aligned 128^3
    "block128_w" (`CVX_FUSED_W=1`, global RMS) or "stripe" (`CVX_FUSED_W`
    neither "1" nor "block", or "1" with the local RMS); else `route`."""
    block = tuple(block)
    if geometry.fused_compact_on() and geometry.compact_ok(vol_shape, block):
        return "compact"
    if geometry.stripe_mode() == "patch" and geometry.patch_ok(block):
        return "patch"
    path = route(vol_shape, block)
    if path == "block128":
        mode = geometry.fused_w_mode()
        if mode == "1":
            return "stripe" if use_local_rms else "block128_w"
        if mode != "block":
            return "stripe"
    return path


def device_guard(device):
    """`torch.cuda.device(device)` for a CUDA device, a null context for the
    CPU: kernels launch, and tensors are made, on that card."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _target(device):
    """The torch device to run on: "cuda" unless the caller names another;
    a CUDA device on a machine without a card raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} (the default) needs a CUDA "
                           "card and there is none; pass device='cpu' to run "
                           "the plain PyTorch versions on the CPU")
    return device


def _device_volume(vol, device):
    """The volume as a contiguous f32 tensor: a tensor on its own device, a
    numpy volume uploaded to `device`."""
    if isinstance(vol, torch.Tensor):
        t = vol
    else:
        t = torch.from_numpy(np.ascontiguousarray(vol, dtype=np.float32))
        t = t.to(device)
    if t.dim() != 3:
        raise ValueError(f"volume must be (nz, ny, nx), got {tuple(t.shape)}")
    return t.to(torch.float32).contiguous()


def compress(vol, scale, block=BLOCK, use_local_rms=False, device=None):
    """Compress a (nz, ny, nx) f32 volume. Returns (container uint8, ratio).

    `vol` is a numpy array or a torch tensor; a tensor brings its own device,
    a numpy volume goes to `device` ("cuda" when None).  On "cuda" the
    kernels run, on "cpu" their plain PyTorch versions.  `block` is (32, 32,
    32) by default, or any block Is_Valid_Block_Size accepts (bx, by powers
    of two in [8, 256], bz one too or 1; ValueError otherwise).  With
    `use_local_rms` each block is quantized with 1/(rms*scale) of its own
    wavelet coefficients (the reference's Compress(..., use_local_RMS=true)),
    and the container carries the per-block table.  The JAX package's
    encode switches select the route (`encode_route`); every route gives a
    container any decoder reads.
    """
    block = geometry.check_block(block)
    if isinstance(vol, torch.Tensor):
        if device is not None and torch.device(device) != vol.device:
            raise ValueError(
                f"volume lies on {vol.device}, but device={device!r} was given"
            )
        dev = vol.device
    else:
        dev = _target(device)
    with device_guard(dev):
        return _compress(vol, scale, block, use_local_rms, dev)


def _compress(vol, scale, block, use_local_rms, device):
    cells = block[0] * block[1] * block[2]
    with record_function("cvx.volume_h2d"):
        t = _device_volume(vol, device)
    nz, ny, nx = t.shape
    path = encode_route(t.shape, block, use_local_rms)
    if use_local_rms:
        # header mulfac 1.0; each block's comes from the scale
        mulfac, args = np.float32(1.0), dict(scale=scale)
    else:
        with record_function("cvx.mulfac"):
            mulfac = quant.global_mulfac(
                t if isinstance(vol, torch.Tensor) else vol, scale
            )
        args = dict(mulfac=mulfac)
    nlive = None  # the live chunks' count, on the rows routes
    if path == "fused32":
        with record_function("cvx.fused_encode"):
            coeffs, desc, chunk_bytes, sizes, raw, mulfacs = tokenize.fused_encode(
                t, **args)
    elif path == "block128":
        with record_function("cvx.block_encode"):
            coeffs, desc, chunk_bytes, sizes, raw, mulfacs = (
                fused_compress.block_encode(t, **args))
    elif path == "block128_w":
        with record_function("cvx.block_encode_w"):
            coeffs, desc, chunk_bytes, sizes, raw, mulfacs = (
                fused_compress.block_encode_w(t, mulfac))
    elif path == "stripe_fused":
        with record_function("cvx.stripe_fused_encode"):
            coeffs, desc, chunk_bytes, sizes, raw, mulfacs = (
                tokenize.stripe_fused_encode(t, block, **args))
    elif path == "compact":
        with record_function("cvx.compact_encode"):
            (coeffs, mulfacs, chunk_bytes, sizes, raw, rows, drows, ids, _,
             nlive) = tokenize.compact_encode(t, block, **args)
    else:
        with record_function("cvx.encode"):
            coeffs, desc, chunk_bytes, sizes, raw, mulfacs = tokenize.encode(
                t, block, **args)
        if path == "patch":
            nlive = (chunk_bytes > 0).sum(dtype=torch.int32).view(1)
    with record_function("cvx.sizes_readback"):
        parts = [sizes, raw.to(torch.int32), mulfacs.view(torch.int32)]
        sr = torch.cat(parts + ([] if nlive is None else [nlive])).cpu().numpy()
    nnn = sizes.numel()
    sizes_h, raw_h = sr[:nnn].astype(np.int64), sr[nnn:2 * nnn].astype(bool)
    mulfacs_h = sr[2 * nnn:3 * nnn].view(np.float32)
    total = int(sizes_h[~raw_h].sum())
    with record_function("cvx.chunk_bases"):
        base = pack.chunk_bases(chunk_bytes)
    if path in ("patch", "compact"):
        n = int(sr[3 * nnn])
        if path == "patch":
            with record_function("cvx.patch_extract"):
                rows, drows, ids = pack.patch_extract(coeffs, desc, chunk_bytes,
                                                      block, n)
        with record_function("cvx.emit_rows"):
            stream = pack.emit_rows(rows[:n], drows[:n], ids[:n], mulfacs,
                                    chunk_bytes, base, total)
    else:
        with record_function("cvx.emit_chunks"):
            stream = pack.emit_chunks(
                coeffs, mulfacs, desc, chunk_bytes, base, total,
                block if path == "stripe" else None)
    with record_function("cvx.stream_d2h"):
        stream_h = stream.cpu().numpy()
        raw_bytes_h = None
        if raw_h.any():
            # raw blocks store the UNSCALED coefficients (CvxCompress.cpp:359)
            if path in ("stripe", "patch"):
                rc = geometry.gather_blocks(coeffs, np.flatnonzero(raw_h), t.shape,
                                            block)
            else:
                rc = coeffs[raw]
            raw_bytes_h = rc.cpu().numpy().view(np.uint8)
    with record_function("cvx.assemble"):
        payload, _ = rle_device.assemble_payload_blockorder(
            stream_h, sizes_h, raw_h, raw_bytes_h, cells
        )
        hdr = ctn.Header(nx, ny, nz, *block, mulfac, use_local_rms)
        data = ctn.pack_stream(hdr, sizes_h, raw_h, payload,
                               mulfacs_h if use_local_rms else None)
    return data, (nx * ny * nz * 4) / data.size


def sparse_chunks(coeffs):
    """Host: dense (nnn, cells) coefficients -> (rows, invmap).

    rows (n, chunk) f32 are the non-zero chunks of min(128, cells) cells in
    order; invmap (nchunks,) int32 maps every chunk to its row, with n for
    an all-zero chunk.  Only the non-zero data travels to the device.
    """
    chunk = rle_device.chunk_cells(coeffs.shape[1])
    flat = coeffs.reshape(-1, chunk)
    idx = np.flatnonzero(rle_host.chunk_flags(flat, chunk))
    invmap = np.full(flat.shape[0], idx.size, dtype=np.int32)
    invmap[idx] = np.arange(idx.size, dtype=np.int32)
    return np.ascontiguousarray(flat[idx]), invmap


def _inverse(dense, hdr):
    """The inverse of the container's geometry on the dense block-major
    coefficients: a kernel at 32^3, aligned 128^3 and the "stripe_fused"
    blocks, else the inverse transform as library products (the JAX package's XLA branch of
    `_inverse_from_plane`, `cvxcompress_tpu/ops/codec.py:1151-1169`), then
    the block-major -> volume relayout."""
    shape = (hdr.nz, hdr.ny, hdr.nx)
    block = (hdr.bx, hdr.by, hdr.bz)
    path = route(shape, block)
    if path == "fused32":
        with record_function("cvx.fused_inverse"):
            return fused_inverse.fused_inverse(dense.view(-1, 128), None, shape)
    if path == "block128":
        with record_function("cvx.block_fused_inverse"):
            return fused_inverse.block_fused_inverse(dense.view(-1, 128), shape)
    if path == "stripe_fused":
        with record_function("cvx.stripe_fused_inverse"):
            return fused_inverse.stripe_fused_inverse(dense, shape, block)
    with record_function("cvx.inverse"):
        coeffs = dense.view(-1, hdr.bz, hdr.by, hdr.bx)
        return blocks.from_blocks(wavelet.inverse_blocks(coeffs), shape, block)


def decompress_device(data, device):
    """The device engine (`cvxcompress_tpu/ops/codec.py:1235`): the volume
    as a tensor on `device`, or None when `plan` rejects the container's
    spans.  The container is already validated."""
    with record_function("cvx.plan"):
        p = entropy_decode.plan(data)
    if p is None:
        return None
    hdr, cells = p["hdr"], p["cells"]
    with record_function("cvx.plan_h2d"):
        b = entropy_decode.upload(p, device)
    nsub = b["sub_block"].numel()
    with record_function("cvx.decode_maps"):
        M, P = entropy_decode.parse_maps(b["stream"], nsub, cells)
    with record_function("cvx.decode_chase"):
        e32, c32 = entropy_decode.chase(P, b["sub_reset"], b["starts"], cells)
    with record_function("cvx.decode_emit"):
        dense = entropy_decode.emit(b["stream"], M, e32, c32, b["sub_block"],
                                    b["scalefac"], hdr.grid[3], cells)
    with record_function("cvx.overlay_raw"):
        entropy_decode.overlay_raw(dense, b["raw_rows"], b["raw_ids"])
    return _inverse(dense, hdr)


def _decode_host(data, hdr, blkoffs, blkmulfac, payload_base, device):
    """The host engine: native decode, chunk-sparse upload, inverse."""
    raw = np.frombuffer(memoryview(data), dtype=np.uint8)
    shape = (hdr.nz, hdr.ny, hdr.nx)
    with record_function("cvx.decode_host"):
        coeffs = rle_host.decode_payloads(
            raw[payload_base:], blkoffs, hdr.glob_mulfac,
            hdr.bx * hdr.by * hdr.bz, blkmulfac,
        )
    with record_function("cvx.sparse_chunks"):
        rows, invmap = sparse_chunks(coeffs)
    if (hdr.bx, hdr.by, hdr.bz) == BLOCK:
        with record_function("cvx.chunks_h2d"):
            rows_t = torch.from_numpy(rows).to(device)
            invmap_t = torch.from_numpy(invmap).to(device)
        with record_function("cvx.fused_inverse"):
            return fused_inverse.fused_inverse(rows_t, invmap_t, shape)
    with record_function("cvx.chunks_h2d"):
        rows_t = torch.from_numpy(rows).to(device)
        ids_t = torch.from_numpy(np.flatnonzero(invmap < rows.shape[0])).to(device)
    with record_function("cvx.densify"):
        dense = torch.zeros((invmap.size, rows.shape[1]), dtype=torch.float32,
                            device=device)
        dense.index_copy_(0, ids_t, rows_t)
    return _inverse(dense, hdr)


ENGINES = ("auto", "device", "host")


def decompress(data, device="cuda", engine="auto"):
    """Decompress a container to a (nz, ny, nx) f32 tensor on `device`
    ("cuda" by default, "cpu" for the plain PyTorch versions).

    engine:
      "auto"   -- the device engine when `device` is CUDA, the host engine
                  on the CPU (where the native decoder is the faster one);
      "device" -- the device entropy decoder (its plain versions on the
                  CPU); a container whose spans `plan` rejects raises
                  ValueError;
      "host"   -- native host decode, chunk-sparse upload, inverse.
    Under "auto" a container the device engine rejects takes the host
    engine.  Accepts containers of this port, of the JAX package, of the
    oracle and of the native library; the container is validated
    structurally first.  Global- and local-RMS containers take the same
    path; a local one's blocks dequantize with their own `blkmulfac`.
    """
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    io.validate(data)
    device = _target(device)
    with device_guard(device):
        return _decompress(data, device, engine)


def _decompress(data, device, engine):
    hdr, blkoffs, blkmulfac, payload_base = ctn.unpack(data)
    if engine == "device" or (engine == "auto" and device.type == "cuda"):
        out = decompress_device(data, device)
        if out is not None:
            return out
        if engine == "device":
            raise ValueError("container not decodable on the device engine "
                             "(degenerate payload spans)")
    return _decode_host(data, hdr, blkoffs, blkmulfac, payload_base, device)
