"""Multi-process sharded compression on `torch.distributed`.

The PyTorch counterpart of `cvxcompress_tpu/parallel/multihost.py` (which
runs on `jax.distributed`).  Each process owns a contiguous z-slab of
blocks (`sharded.plan_shards`) and compresses it with the port's codec on
its own device; the only traffic between processes is an 8-byte f64
sum-of-squares all-reduce before the compress and the segment gather
after it (SURVEY.md §2).

Usage, one process per rank (torch.distributed needs its address, world
size and rank given; nothing tells a program of a cluster):

    import torch.distributed as dist
    dist.init_process_group("gloo", init_method="tcp://host:port",
                            world_size=n, rank=r)      # or "nccl"
    data = multihost.compress(local_slab, scale, block, vol_shape=shape)
    # the container on rank 0, None elsewhere

Both collectives carry host data, so they run on a gloo group: the default
group when it is gloo, else one made once by `dist.new_group(backend=
"gloo")` (NCCL refuses two ranks on one card, and would copy host data to
the card and back).  Segments differ in length: each rank pads its
segment to the longest, and the lengths travel alongside, as the JAX
module does.

Two gather modes:
  * "allgather": rank 0 merges the gathered segments and returns the
    container, every other rank None;
  * "files": each rank writes `<file_prefix>.seg<rank>` and returns its
    path; `merge_segment_files` merges them (after the caller's barrier),
    the pattern of snapshot archives on shared storage.
Without an initialized group the module runs as one process (rank 0 of 1).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import container as ctn
from ..ops import quant
from . import sharded

_GLOO = {}  # the default group -> its gloo group, made on first use


def _pcount():
    """(world size, rank); (1, 0) when no process group is initialized."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _host_group():
    """The gloo group the host collectives run on (module doc)."""
    import torch.distributed as dist

    if dist.get_backend() == "gloo":
        return None
    world = dist.group.WORLD
    if world not in _GLOO:
        _GLOO[world] = dist.new_group(backend="gloo")
    return _GLOO[world]


def _local_sumsq(slab):
    """The f64 sum of squares of this rank's slab: numpy's on the host,
    `quant.sumsq` on the card for a CUDA tensor."""
    if isinstance(slab, torch.Tensor) and slab.device.type != "cpu":
        return float(quant.sumsq(slab.to(torch.float32)))
    host = slab.numpy() if isinstance(slab, torch.Tensor) else slab
    return sharded.partial_sumsq(host)


def compress(local_slab, scale, block=(32, 32, 32), use_local_rms=False,
             vol_shape=None, gather="allgather", file_prefix=None, device=None):
    """Compress this rank's z-slab; gather and merge on rank 0.

    `local_slab` is this rank's contiguous z-slab (block-aligned but on the
    last rank), a numpy array (compressed on `device`, "cuda" when None) or
    a tensor (on its own device).  `vol_shape` is the GLOBAL volume shape,
    required with more than one process; the slab encodes on its route.
    Returns the container on rank 0 and None elsewhere ("allgather"), or
    this rank's segment file ("files").
    """
    import torch.distributed as dist

    if gather not in ("allgather", "files"):
        raise ValueError(f"gather must be 'allgather' or 'files', got {gather!r}")
    if gather == "files" and not file_prefix:
        raise ValueError("gather='files' needs file_prefix")
    nproc, rank = _pcount()
    if vol_shape is None:
        if nproc > 1:
            raise ValueError("vol_shape is required with more than one process")
        vol_shape = tuple(local_slab.shape)
    vol_shape = tuple(int(n) for n in vol_shape)
    block = tuple(block)

    if use_local_rms:
        glob_mulfac = np.float32(1.0)
    else:
        ss = _local_sumsq(local_slab)
        if nproc > 1:
            t = torch.tensor([ss], dtype=torch.float64)
            dist.all_reduce(t, group=_host_group())
            ss = float(t[0])
        glob_mulfac = sharded.mulfac_from_sumsq(ss, int(np.prod(vol_shape)), scale)

    segment = sharded.compress_shard(local_slab, scale, block, glob_mulfac,
                                     use_local_rms, device=device, vol_shape=vol_shape)

    if gather == "files":
        path = f"{file_prefix}.seg{rank}"
        segment.tofile(path)
        return path
    if nproc == 1:
        return sharded.merge_segments([segment], vol_shape, block, glob_mulfac,
                                      use_local_rms)

    group = _host_group()
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(nproc)]
    dist.all_gather(lens, torch.tensor([segment.size], dtype=torch.int64), group=group)
    lens = [int(n) for n in lens]
    padded = torch.zeros(max(lens), dtype=torch.uint8)
    padded[: segment.size] = torch.from_numpy(segment)
    bufs = [torch.empty(max(lens), dtype=torch.uint8) for _ in range(nproc)]
    dist.all_gather(bufs, padded, group=group)
    if rank != 0:
        return None
    segments = [b[:n].numpy() for b, n in zip(bufs, lens)]
    return sharded.merge_segments(segments, vol_shape, block, glob_mulfac, use_local_rms)


def merge_segment_files(paths, vol_shape, block, scale=None, use_local_rms=False):
    """Merge per-rank segment files into one container.

    The shared glob_mulfac is read back from the first segment's header;
    every other segment's header must agree (same mulfac, block dims and
    RMS mode) or the merge raises ValueError: segments compressed at
    different scales would otherwise merge silently into a corrupt
    container.  `scale` is accepted for the JAX module's signature and not
    read.
    """
    del scale
    segments = [np.fromfile(p, dtype=np.uint8) for p in paths]
    hdr = ctn.unpack(segments[0])[0]
    for p, seg in zip(paths[1:], segments[1:]):
        h = ctn.unpack(seg)[0]
        same = (
            h.glob_mulfac.view(np.uint32) == hdr.glob_mulfac.view(np.uint32)
            and (h.bx, h.by, h.bz) == (hdr.bx, hdr.by, hdr.bz)
            and h.use_local_rms == hdr.use_local_rms
        )
        if not same:
            raise ValueError(
                f"segment {p} header mismatch: mulfac/block/RMS-mode differ "
                f"from {paths[0]}"
            )
    return sharded.merge_segments(segments, vol_shape, block, hdr.glob_mulfac,
                                  use_local_rms)

