"""Block-data-parallel compress and decompress over a mesh of devices.

The PyTorch counterpart of `cvxcompress_tpu/parallel/compress.py`, the
multi-device replacement of the reference's OpenMP fan-out over blocks
(CvxCompress.cpp:318).  A mesh (parallel/mesh.py) is a tuple of devices;
shard k is a contiguous z-slab of whole blocks (`sharded.plan_shards`) on
device k, run by the port's own codec and kernels there, each shard on a
pooled CUDA stream of its own (pipeline.py), so shards on several cards,
or several shards on one card, overlap.  The two couplings of the
algorithm:

  * the global RMS, a sum reduction: a numpy volume takes the reference's
    f64 host reduction (`quant.global_rms_host`, as the single compress);
    a volume on a card the f64 sums of its shards on their devices, added
    in f64 (`distributed_sumsq`); the local RMS needs none (header 1.0);
  * the payload offset table, a prefix sum: each shard's segment is a
    container of its slab, and `sharded.merge_segments` rebases and
    concatenates them.

Every shard encodes on the WHOLE volume's route (`codec.encode_route`),
and every slab decodes on its inverse (`codec.route`), so the containers
are byte-identical across mesh sizes and to `codec.compress` (every
route's transform is native's cascade, on the card and on the CPU).

`decompress` cuts the container into ranges of whole z block rows
balanced on payload bytes (`decode_ranges`), decodes each slab's
container (`sharded.split_segments`) on its device, and joins the slabs
along z on the mesh's first device.  Beside the codec's "cvx.<stage>"
profiler spans, the layer's own: "cvx.mulfac" (the reduction),
"cvx.merge_segments", "cvx.split_segments", "cvx.join_slabs".

Not ported: the JAX module's `_stage1`/`_stage2` (TPU SPMD pack layouts at
static caps), `_inv_stage`/`_decode_inv_stage` (`shard_map` programs) and
its host-decode branch for raw blocks (the device engine overlays raw
blocks itself, `entropy_decode.overlay_raw`).  Its decode cut is
block-granular and balanced on subsegments (`_shard_decode_plan`); this
one cuts on block rows, since the port's inverse kernels take volume-shaped
slabs.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import pipeline
from ..ops import codec, geometry, quant
from ..utils import io, profiling
from . import mesh as meshlib
from . import sharded

F32 = np.float32


def distributed_sumsq(slabs):
    """The f64 sum of squares of a sharded volume: each slab's `quant.sumsq`
    on its own device (numpy slabs on the CPU), all launched before any is
    read back, then added in f64 in shard order.  A Python float."""
    parts = [quant.sumsq(s if isinstance(s, torch.Tensor)
                         else torch.from_numpy(np.asarray(s, dtype=F32)))
             for s in slabs]
    total = 0.0
    for p in parts:
        total += float(p)
    return total


def _shard_streams(devices):
    """One stream per shard (None on the CPU): the k-th shard on a card
    takes the k-th stream of that card's pool."""
    seen, out = {}, []
    for d in devices:
        if d.type != "cuda":
            out.append(None)
            continue
        k = seen[d] = seen.get(d, -1) + 1
        out.append(pipeline._streams(d, k + 1)[k])
    return out


def _ready(t):
    """An event on the current stream of a CUDA tensor's device, recorded
    now (None for host data): a pooled stream reads `t` after it."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return ev


def compress(vol, scale, block=(32, 32, 32), use_local_rms=False, mesh=None):
    """Sharded compress of a (nz, ny, nx) f32 volume over `mesh` (a list of
    devices, `make_mesh()` of every card when None).  Returns (container,
    ratio), byte-identical to `codec.compress` of the volume (module doc).

    `vol` is a numpy array or a tensor; a shard of a tensor is a z-slab
    view, copied only when its mesh device is another.  Every shard's
    encode launches (`codec.compress_stage`) before any shard's emit and
    copies (`compress_finish`), so the devices and streams overlap; empty
    shards (fewer block rows than shards) are skipped.
    """
    block = geometry.check_block(block)
    mesh = meshlib.make_mesh(mesh)
    if isinstance(vol, torch.Tensor):
        vol = vol.to(torch.float32).contiguous()
    else:
        vol = np.ascontiguousarray(vol, dtype=F32)
    if vol.ndim != 3:
        raise ValueError(f"volume must be (nz, ny, nx), got {tuple(vol.shape)}")
    shape = tuple(vol.shape)
    shards = []
    for (z0, z1), dev in zip(sharded.plan_shards(shape, block, len(mesh)), mesh):
        if z1 > z0:
            s = vol[z0:z1]
            if isinstance(s, torch.Tensor) and s.device != dev:
                s = s.to(dev)
            shards.append((s, dev, _ready(s)))
    with profiling.span("cvx.mulfac"):
        if use_local_rms:
            mulfac = F32(1.0)
        elif isinstance(vol, torch.Tensor) and vol.device.type != "cpu":
            mulfac = quant.mulfac_from_sumsq(
                distributed_sumsq([s for s, _, _ in shards]), vol.numel(), scale)
        else:
            mulfac = quant.global_mulfac(vol, scale)
    route = codec.encode_route(shape, block, use_local_rms)
    streams = _shard_streams([d for _, d, _ in shards])
    batches = []
    for (s, dev, ev), st in zip(shards, streams):
        with codec.device_guard(dev), pipeline._on(st):
            pipeline._adopt([s], ev, st)
            batches.append(codec.compress_stage(
                [s], scale, block, use_local_rms,
                [None if use_local_rms else mulfac], device=dev, _route=route))
    segments = []
    for b, (_, dev, _), st in zip(batches, shards, streams):
        with codec.device_guard(dev), pipeline._on(st):
            segments.append(codec.compress_finish(b)[0][0])
    with profiling.span("cvx.merge_segments"):
        data = sharded.merge_segments(segments, shape, block, mulfac, use_local_rms)
    return data, shape[0] * shape[1] * shape[2] * 4 / data.size


def decode_ranges(data, n_shards):
    """The sharded decompress's cut: at most `n_shards` non-empty ranges
    (r0, r1) of whole z block rows, tiling them, each ending at the row
    boundary nearest to its share k / n_shards of the payload bytes (the
    bytes stand in for the parse's work)."""
    hdr, _, _, sizes, _ = sharded.block_sizes(data)
    nbx, nby, nbz, _ = hdr.grid
    rows = np.cumsum(sizes.reshape(nbz, nbx * nby).sum(axis=1))
    cuts = [0]
    for k in range(1, n_shards):
        t = k * float(rows[-1]) / n_shards
        r = int(np.searchsorted(rows, t))  # the first row reaching t
        before = float(rows[r - 1]) if r else 0.0
        c = r + 1 if float(rows[r]) - t < t - before else r
        cuts.append(min(max(c, cuts[-1]), nbz))
    cuts.append(nbz)
    return [(a, b) for a, b in zip(cuts, cuts[1:]) if b > a]


def decompress(data, mesh=None, engine="auto"):
    """Sharded decompress of a container over `mesh`: the (nz, ny, nx) f32
    volume as a tensor on the mesh's first device.

    One range (a one-device mesh, or one block row) delegates to
    `codec.decompress`.  Otherwise the container's slabs (`decode_ranges`,
    `sharded.split_segments`) decode on their devices, each on its own
    stream, with the codec's `engine` ("auto": the device engine on a card,
    the host engine on the CPU; "device"; "host") and the whole volume's
    inverse route; then they join along z.  Each volume element equals the
    single decompress's on the kernel routes and the CPU.
    """
    if engine not in codec.ENGINES:
        raise ValueError(f"engine must be one of {codec.ENGINES}, got {engine!r}")
    hdr = io.validate(data)
    mesh = meshlib.make_mesh(mesh)
    ranges = decode_ranges(data, len(mesh))
    if len(ranges) == 1:
        return codec.decompress(data, device=mesh[0], engine=engine)
    path = codec.route((hdr.nz, hdr.ny, hdr.nx), (hdr.bx, hdr.by, hdr.bz))
    devs = mesh[:len(ranges)]
    streams = _shard_streams(devs)
    with profiling.span("cvx.split_segments"):
        slabs = sharded.split_segments(data, ranges)
    outs = []
    for slab, dev, st in zip(slabs, devs, streams):
        with codec.device_guard(dev), pipeline._on(st):
            outs.append((codec._decompress(slab, dev, engine, path),
                         pipeline._done_event(st)))
    with profiling.span("cvx.join_slabs"):
        parts = []
        for (v, ev), dev in zip(outs, devs):
            with codec.device_guard(dev):
                parts.append(pipeline._hand_back(v, ev).to(mesh[0]))
        with codec.device_guard(mesh[0]):
            return torch.cat(parts, dim=0)
