"""The compressed bitstream container format, a frozen copy for the benchmark.

A copy of `cvxcompress_tpu_torch/container.py` as it stood when the
benchmark was written.  The yardstick keeps its own copy so that no later
change to the program can move what the benchmark holds it to.

Layout (written by the reference at CvxCompress.cpp:284-316,421-422 and
parsed at :473-517):

    offset   field
    0        uint32 nx, ny, nz
    12       uint32 bx, by, bz
    24       float32 glob_mulfac      1/(global_rms*scale); 1.0 if rms==0,
                                      non-finite, or local-RMS mode
    28       uint32 flags             bit0 = use_local_RMS
    32       int64  blkoff[nnn]       byte offset of each block's payload;
                                      MSB set => block stored raw
                                      (uncompressed wavelet coefficients)
    32+8nnn  [float32 blkmulfac[nnn]] only when local-RMS
    then     payload bytes
    total  = 32 + 8*nnn + sum(payload) + 7 slack (+4*nnn if local RMS)

nnn = ceil(nx/bx)*ceil(ny/by)*ceil(nz/bz), block index raster-ordered x
fastest then y then z (CvxCompress.cpp:279-282,321-328).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

F32 = np.float32

HEADER_BYTES = 32
SLACK_BYTES = 7  # decoder 8-byte-lookahead slack (CvxCompress.cpp:421)
RAW_FLAG = np.int64(np.uint64(0x8000000000000000).view(np.int64))
FLAG_LOCAL_RMS = 1

MIN_B = 8
MAX_B = 256


def is_valid_block_size(bx, by, bz):
    """Power-of-two blocks in [8, 256]; bz == 1 allowed for 2D volumes.

    Reference: CvxCompress::Is_Valid_Block_Size (CvxCompress.cpp:54-71).
    """

    def p2ok(v):
        return MIN_B <= v <= MAX_B and (v & (v - 1)) == 0

    return p2ok(bx) and p2ok(by) and (bz == 1 or p2ok(bz))


def block_grid(nx, ny, nz, bx, by, bz):
    """(nbx, nby, nbz, nnn) ceil-div block counts (CvxCompress.cpp:279-282)."""
    nbx = -(-nx // bx)
    nby = -(-ny // by)
    nbz = -(-nz // bz)
    return nbx, nby, nbz, nbx * nby * nbz


def compute_glob_mulfac(global_rms, scale):
    """mulfac = 1/(rms*scale) in float32, with the Inf/0 guards.

    Reference: CvxCompress.cpp:291-295.
    """
    rms = F32(global_rms)
    if rms != 0.0:
        with np.errstate(divide="ignore", over="ignore"):
            mf = F32(1.0) / (rms * F32(scale))
    else:
        mf = F32(1.0)
    if not math.isfinite(float(mf)):
        mf = F32(1.0)
    return F32(mf)


@dataclass
class Header:
    nx: int
    ny: int
    nz: int
    bx: int
    by: int
    bz: int
    glob_mulfac: np.float32
    use_local_rms: bool

    @property
    def grid(self):
        return block_grid(self.nx, self.ny, self.nz, self.bx, self.by, self.bz)


def pack(header, payloads, raw_flags, blkmulfac=None):
    """Assemble the container from per-block payloads (block order).

    `payloads` is a sequence of bytes-like per-block streams, `raw_flags`
    marks blocks stored as raw coefficients.  Returns a uint8 ndarray of
    exactly the reference-accounted length (`pack_stream` of the
    concatenated payloads).
    """
    nnn = header.grid[3]
    if len(payloads) != nnn or len(raw_flags) != nnn:
        raise ValueError(f"{len(payloads)} payloads and {len(raw_flags)} raw flags "
                         f"for {nnn} blocks")
    sizes = np.array([len(p) for p in payloads], dtype=np.int64)
    stream = np.frombuffer(b"".join(bytes(p) for p in payloads), dtype=np.uint8)
    return pack_stream(header, sizes, raw_flags, stream, blkmulfac)


def pack_stream(header, sizes, raw_flags, stream, blkmulfac=None):
    """Assemble the container from a pre-concatenated payload stream.

    `sizes` (nnn,) int per-block payload sizes in block order, `stream` the
    concatenated payload bytes (uint8 ndarray, length >= sum(sizes)),
    `raw_flags` (nnn,) bool.
    """
    nnn = header.grid[3]
    sizes = np.asarray(sizes, dtype=np.int64)
    if sizes.shape != (nnn,):
        raise ValueError(f"sizes shape {sizes.shape} != ({nnn},)")
    offs = np.cumsum(sizes) - sizes
    blkoffs = np.where(np.asarray(raw_flags, dtype=bool), offs | RAW_FLAG, offs)

    total_payload = int(sizes.sum())
    length = HEADER_BYTES + 8 * nnn + total_payload + SLACK_BYTES
    if header.use_local_rms:
        length += 4 * nnn

    out = np.zeros(length, dtype=np.uint8)
    head = np.array(
        [header.nx, header.ny, header.nz, header.bx, header.by, header.bz],
        dtype=np.uint32,
    )
    out[0:24] = head.view(np.uint8)
    out[24:28] = np.array([header.glob_mulfac], dtype=F32).view(np.uint8)
    out[28:32] = np.array(
        [FLAG_LOCAL_RMS if header.use_local_rms else 0], dtype=np.uint32
    ).view(np.uint8)
    pos = HEADER_BYTES
    out[pos : pos + 8 * nnn] = blkoffs.view(np.uint8)
    pos += 8 * nnn
    if header.use_local_rms:
        if blkmulfac is None or len(blkmulfac) != nnn:
            raise ValueError("local-RMS container needs nnn block mulfacs")
        out[pos : pos + 4 * nnn] = np.asarray(blkmulfac, dtype=F32).view(np.uint8)
        pos += 4 * nnn
    out[pos : pos + total_payload] = np.asarray(stream, dtype=np.uint8)[
        :total_payload
    ]
    return out


def unpack(data):
    """Parse a container (ours, the JAX package's or reference-produced).

    Returns (Header, blkoffs int64[nnn] with RAW flag intact,
    blkmulfac or None, payload_base_offset_in_data).
    """
    data = np.frombuffer(memoryview(data), dtype=np.uint8)
    if data.size < HEADER_BYTES:
        raise ValueError(f"container too short: {data.size} bytes")
    head = data[0:24].view(np.uint32)
    nx, ny, nz, bx, by, bz = (int(v) for v in head)
    if not is_valid_block_size(bx, by, bz):
        raise ValueError(f"corrupt container: invalid block size {(bx, by, bz)}")
    if min(nx, ny, nz) <= 0:
        raise ValueError(f"corrupt container: invalid dims {(nx, ny, nz)}")
    glob_mulfac = data[24:28].view(F32)[0]
    flags = int(data[28:32].view(np.uint32)[0])
    use_local = bool(flags & FLAG_LOCAL_RMS)
    hdr = Header(nx, ny, nz, bx, by, bz, glob_mulfac, use_local)
    nnn = hdr.grid[3]
    pos = HEADER_BYTES
    blkoffs = data[pos : pos + 8 * nnn].view(np.int64).copy()
    pos += 8 * nnn
    blkmulfac = None
    if use_local:
        blkmulfac = data[pos : pos + 4 * nnn].view(F32).copy()
        pos += 4 * nnn
    return hdr, blkoffs, blkmulfac, pos
