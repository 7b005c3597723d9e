"""Sharded compression: z-slab shards, one shared mulfac, a deterministic merge.

The PyTorch counterpart of `cvxcompress_tpu/parallel/sharded.py`.  The
reference is single-process; the codec splits across devices and hosts
with two global couplings only (SURVEY.md §2): the scalar global RMS (a sum
reduction) and the container's byte-offset table (a prefix sum over the
blocks' sizes).  Both are associative, so a sharded compress decomposes
exactly:

  1. split the volume into contiguous Z-SLABS on block boundaries
     (`plan_shards`): no block straddles two shards;
  2. reduce the slabs' f64 sums of squares to one global mulfac
     (`partial_sumsq`, `mulfac_from_sumsq`);
  3. compress each slab into a SEGMENT, a container of the slab at the
     shared mulfac, on the WHOLE volume's encode route (`compress_shard`;
     a slab's own shape could pick another route and so other floats);
  4. merge: rebase each segment's offset table by the payload before it
     and concatenate (`merge_segments`), byte-identical to one compress of
     the whole volume at that mulfac.

`split_segments` is the merge's inverse, on ranges of whole z block rows:
the sharded decompress (parallel/compress.py) decodes the slabs apart.
`plan_shards`, `partial_sumsq`, `mulfac_from_sumsq` and `merge_segments`
are numpy copies of the JAX module's (importing it imports jax);
tests/test_torch_sharded.py holds them equal.
"""

from __future__ import annotations

import numpy as np

from .. import container as ctn
from ..ops import codec

F32 = np.float32


def plan_shards(vol_shape, block, num_shards):
    """Contiguous z-slab shard plan: list of (z0, z1) cell ranges.

    Slabs are multiples of bz (blocks never straddle shards); trailing
    shards may be empty for tiny volumes.
    """
    nz, _, _ = vol_shape
    bz = block[2]
    nbz = -(-nz // bz)
    per = -(-nbz // num_shards)
    plan = []
    for s in range(num_shards):
        b0, b1 = min(s * per, nbz), min((s + 1) * per, nbz)
        plan.append((b0 * bz, min(b1 * bz, nz)))
    return plan


def partial_sumsq(vol_slab):
    """f64 sum of squares of a host slab (the all-reduce operand)."""
    return float(np.sum(np.square(np.asarray(vol_slab, F32), dtype=np.float64)))


def mulfac_from_sumsq(total_sumsq, total_cells, scale):
    """Global mulfac from the reduced sum of squares (reference math)."""
    rms = F32(np.sqrt(total_sumsq / total_cells))
    return ctn.compute_glob_mulfac(rms, scale)


def compress_shard(vol_slab, scale, block, glob_mulfac, use_local_rms=False,
                   device=None, vol_shape=None):
    """Compress one z-slab into a segment (a container for the slab) at the
    shared `glob_mulfac`, on the encode route of the whole volume of shape
    `vol_shape` (the slab's own when None).  `vol_slab` is a numpy array or
    a tensor (which brings its device); a numpy slab goes to `device`."""
    block = tuple(block)
    shape = tuple(vol_shape) if vol_shape is not None else tuple(vol_slab.shape)
    (data, _), = codec.compress_many(
        [vol_slab], scale, block, use_local_rms,
        glob_mulfacs=[None if use_local_rms else glob_mulfac], device=device,
        _route=codec.encode_route(shape, block, use_local_rms))
    return data


def merge_segments(segments, vol_shape, block, glob_mulfac, use_local_rms):
    """Merge z-slab segments into the full-volume container.

    Byte-identical to compressing the whole volume in one process with the
    same mulfac: the block raster order (x fastest, z slowest,
    CvxCompress.cpp:321-328) makes shard block ranges contiguous, so the
    merged offset table is each segment's table rebased by the running
    payload size.
    """
    nz, ny, nx = vol_shape
    bx, by, bz = block
    hdr = ctn.Header(nx, ny, nz, bx, by, bz, F32(glob_mulfac), use_local_rms)
    nnn = hdr.grid[3]

    offs = np.empty(nnn, dtype=np.int64)
    mfs = np.empty(nnn, dtype=F32) if use_local_rms else None
    payloads = []
    pos = 0
    base = np.int64(0)
    for seg in segments:
        shdr, soffs, smf, pbase = ctn.unpack(seg)
        assert (shdr.nx, shdr.ny) == (nx, ny) and (
            shdr.bx, shdr.by, shdr.bz
        ) == (bx, by, bz)
        snnn = shdr.grid[3]
        raw_bits = soffs & ctn.RAW_FLAG
        plain = soffs & ~ctn.RAW_FLAG
        offs[pos : pos + snnn] = (plain + base) | raw_bits
        if use_local_rms:
            mfs[pos : pos + snnn] = smf
        payload = np.asarray(seg, np.uint8)[
            pbase : seg.size - ctn.SLACK_BYTES
        ]
        payloads.append(payload)
        base += payload.size
        pos += snnn
    assert pos == nnn, (pos, nnn)

    stream = np.concatenate(payloads) if payloads else np.zeros(0, np.uint8)
    sizes = np.diff(np.r_[(offs & ~ctn.RAW_FLAG), base])
    # pack_stream recomputes offsets from sizes; equivalent by construction
    return ctn.pack_stream(hdr, sizes, offs < 0, stream, mfs)


def block_sizes(data):
    """(hdr, plain offsets, raw flags, sizes, payload base) of a container:
    each block's payload bytes, the distance from its offset to the next
    larger one (the reference writes payloads in any order,
    CvxCompress.cpp:370-374)."""
    data = np.frombuffer(memoryview(data), dtype=np.uint8)
    hdr, offs, _, pbase = ctn.unpack(data)
    plain = offs & ~ctn.RAW_FLAG
    order = np.argsort(plain, kind="stable")
    ends = np.r_[plain[order][1:], data.size - ctn.SLACK_BYTES - pbase]
    sizes = np.empty_like(plain)
    sizes[order] = ends - plain[order]
    return hdr, plain, offs < 0, sizes, pbase


def split_segments(data, row_ranges):
    """Cut a container into slab containers on ranges of whole z block rows.

    `row_ranges` lists (r0, r1) with 0 <= r0 < r1 <= nbz; slab k holds the
    blocks of z block rows r0..r1-1: its header's nz is the slab's cells in
    z, its offsets are rebased to its own payload (raw flags kept), and
    under the local RMS it keeps its slice of the table.  `merge_segments`
    of the slabs of ranges that tile [0, nbz) gives back a block-ordered
    container byte for byte.
    """
    data = np.frombuffer(memoryview(data), dtype=np.uint8)
    hdr, plain, raw, sizes, pbase = block_sizes(data)
    mfs = ctn.unpack(data)[2]
    nbx, nby, nbz, _ = hdr.grid
    per = nbx * nby
    out = []
    for r0, r1 in row_ranges:
        if not 0 <= r0 < r1 <= nbz:
            raise ValueError(f"row range {(r0, r1)} outside [0, {nbz})")
        b0, b1 = r0 * per, r1 * per
        o, s = plain[b0:b1] + pbase, sizes[b0:b1]
        if np.array_equal(o[1:], o[:-1] + s[:-1]):  # block-ordered: one slice
            stream = data[o[0]:o[0] + int(s.sum())]
        else:
            stream = np.concatenate([data[a:a + n] for a, n in zip(o, s)])
        shdr = ctn.Header(hdr.nx, hdr.ny, min(r1 * hdr.bz, hdr.nz) - r0 * hdr.bz,
                          hdr.bx, hdr.by, hdr.bz, hdr.glob_mulfac, hdr.use_local_rms)
        out.append(ctn.pack_stream(shdr, s, raw[b0:b1], stream,
                                   None if mfs is None else mfs[b0:b1]))
    return out


def compress_sharded(vol, scale, block=(32, 32, 32), num_shards=2,
                     use_local_rms=False, device=None):
    """The sharded dataflow in one process (tests, demos): the
    partial sums of squares reduced, each non-empty shard compressed on
    `device` ("cuda" when None) in turn, the segments merged.  Returns
    (container, ratio), byte-equal to `codec.compress` of the volume."""
    vol = np.ascontiguousarray(vol, dtype=F32)
    block = tuple(block)
    plan = plan_shards(vol.shape, block, num_shards)
    if use_local_rms:
        glob_mulfac = F32(1.0)
    else:
        total = sum(partial_sumsq(vol[z0:z1]) for z0, z1 in plan)
        glob_mulfac = mulfac_from_sumsq(total, vol.size, scale)
    segments = [
        compress_shard(vol[z0:z1], scale, block, glob_mulfac, use_local_rms,
                       device=device, vol_shape=vol.shape)
        for z0, z1 in plan
        if z1 > z0
    ]
    data = merge_segments(segments, vol.shape, block, glob_mulfac, use_local_rms)
    return data, vol.size * 4 / data.size
