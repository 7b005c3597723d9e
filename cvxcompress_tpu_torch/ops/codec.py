"""The codec: compress on the device, host entropy decode + device inverse.

Compress (CvxCompress::Compress semantics, CvxCompress.cpp:231-427), one
straight path:
  1. mulfac from the global RMS (ops/quant.py);
  2. fused_encode (ops/tokenize.py): transform, tokenize, per-block sizes;
  3. one small read-back of the per-block sizes and raw flags;
  4. the exclusive cumsum of the non-raw blocks' sizes gives every block's
     base in the stream;
  5. emit_payload (ops/pack.py) writes a stream of exactly that many bytes;
  6. one device-to-host copy of the stream (plus the raw blocks'
     coefficients, when there are any);
  7. the host assembles the container (ops/rle_device.py, container.py).

Decompress (the JAX package's `engine="host"`, `cvxcompress_tpu/ops/
codec.py:1490-1523`): the native library decodes every block on the host,
only the non-zero 128-cell chunks go up to the device (`sparse_chunks`),
and fused_inverse (ops/fused_inverse.py) runs the inverse there.

Each stage runs inside a `torch.profiler.record_function` span named
"cvx.<stage>", so a profiler trace attributes host and device time to the
stages.

This slice covers 32^3 blocks with the global RMS; other block shapes and
the local RMS raise NotImplementedError (see ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from .. import container as ctn
from ..utils import io
from . import fused_inverse, pack, quant, rle_device, rle_host, tokenize

BLOCK = (32, 32, 32)
CELLS = 32 * 32 * 32
CHUNK = 128


def _check_slice(block, use_local_rms):
    if tuple(block) != BLOCK or use_local_rms:
        raise NotImplementedError(
            f"block={tuple(block)}, use_local_rms={use_local_rms}: this port "
            "covers 32^3 blocks with the global RMS only; the rest is "
            "still to be ported (ROADMAP.md)"
        )


def _device_volume(vol, device):
    """The volume as a contiguous f32 tensor on its device."""
    if isinstance(vol, torch.Tensor):
        if device is not None and torch.device(device) != vol.device:
            raise ValueError(
                f"volume lies on {vol.device}, but device={device!r} was given"
            )
        t = vol
    else:
        device = torch.device(device or "cpu")
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but no CUDA device")
        t = torch.from_numpy(np.ascontiguousarray(vol, dtype=np.float32))
        t = t.to(device)
    if t.dim() != 3:
        raise ValueError(f"volume must be (nz, ny, nx), got {tuple(t.shape)}")
    return t.to(torch.float32).contiguous()


def compress(vol, scale, block=BLOCK, use_local_rms=False, device=None):
    """Compress a (nz, ny, nx) f32 volume. Returns (container uint8, ratio).

    `vol` is a numpy array or a torch tensor; a tensor brings its own device,
    a numpy volume goes to `device` ("cpu" when None).  On the CPU the plain
    PyTorch versions of the kernels run, on "cuda" the kernels.
    """
    _check_slice(block, use_local_rms)
    with record_function("cvx.volume_h2d"):
        t = _device_volume(vol, device)
    nz, ny, nx = t.shape
    with record_function("cvx.mulfac"):
        mulfac = quant.global_mulfac(
            t if isinstance(vol, torch.Tensor) else vol, scale
        )
    with record_function("cvx.fused_encode"):
        coeffs, desc, sizes, raw = tokenize.fused_encode(t, mulfac)
    with record_function("cvx.sizes_readback"):
        sr = torch.stack([sizes, raw.to(torch.int32)]).cpu().numpy()
    sizes_h, raw_h = sr[0].astype(np.int64), sr[1].astype(bool)
    with record_function("cvx.emit_payload"):
        nr_sizes = torch.where(raw, 0, sizes).to(torch.int64)
        base = torch.cumsum(nr_sizes, 0) - nr_sizes
        total = int(sizes_h[~raw_h].sum())
        stream = pack.emit_payload(coeffs, mulfac, desc, base, raw, total)
    with record_function("cvx.stream_d2h"):
        stream_h = stream.cpu().numpy()
        raw_bytes_h = None
        if raw_h.any():
            # raw blocks store the UNSCALED coefficients (CvxCompress.cpp:359)
            raw_bytes_h = coeffs[raw].cpu().numpy().view(np.uint8)
    with record_function("cvx.assemble"):
        payload, _ = rle_device.assemble_payload_blockorder(
            stream_h, sizes_h, raw_h, raw_bytes_h, CELLS
        )
        hdr = ctn.Header(nx, ny, nz, *BLOCK, mulfac, False)
        data = ctn.pack_stream(hdr, sizes_h, raw_h, payload)
    return data, (nx * ny * nz * 4) / data.size


def sparse_chunks(coeffs):
    """Host: dense (nnn, cells) coefficients -> (rows, invmap).

    rows (n, 128) f32 are the non-zero chunks in order; invmap (nchunks,)
    int32 maps every chunk to its row, with n for an all-zero chunk.  Only
    the non-zero data travels to the device.
    """
    flat = coeffs.reshape(-1, CHUNK)
    idx = np.flatnonzero(rle_host.chunk_flags(flat, CHUNK))
    invmap = np.full(flat.shape[0], idx.size, dtype=np.int32)
    invmap[idx] = np.arange(idx.size, dtype=np.int32)
    return np.ascontiguousarray(flat[idx]), invmap


def decompress(data, device="cpu"):
    """Decompress a container to a (nz, ny, nx) f32 tensor on `device`.

    Accepts containers of this port, of the JAX package, of the oracle and
    of the native library (the decode is offset-table driven).  The
    container is validated structurally first.
    """
    io.validate(data)
    hdr, blkoffs, _, payload_base = ctn.unpack(data)
    _check_slice((hdr.bx, hdr.by, hdr.bz), hdr.use_local_rms)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device")
    raw = np.frombuffer(memoryview(data), dtype=np.uint8)
    with record_function("cvx.decode_host"):
        coeffs = rle_host.decode_payloads(
            raw[payload_base:], blkoffs, hdr.glob_mulfac, CELLS
        )
    with record_function("cvx.sparse_chunks"):
        rows, invmap = sparse_chunks(coeffs)
    with record_function("cvx.chunks_h2d"):
        rows_t = torch.from_numpy(rows).to(device)
        invmap_t = torch.from_numpy(invmap).to(device)
    with record_function("cvx.fused_inverse"):
        return fused_inverse.fused_inverse(
            rows_t, invmap_t, (hdr.nz, hdr.ny, hdr.nx)
        )
