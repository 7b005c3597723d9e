"""Streaming and batched codec entry points for snapshot sequences.

The PyTorch counterpart of `cvxcompress_tpu/pipeline.py`.  The production
shape of this codec is RTM wavefield snapshot streams: one volume per
time step, compressed on the fly (forward pass) and decompressed in
reverse order (backward pass).  The overlap is ACROSS volumes, by CUDA
streams:

  * `compress_stream` / `decompress_stream`: a thread pool whose workers
    each run on a CUDA stream of their own, so one volume's upload,
    read-backs and host assembly overlap another's kernels (PyTorch's ops,
    the kernel launches and the native library release the GIL);
  * `compress_batched` / `decompress_batched`: K volumes a call
    (ops/codec.py `compress_many`, `decompress_many`): one read-back of the
    K sizes bundles and one copy of the K streams, or one upload of the K
    decode plans;
  * `compress_stream_batched` / `decompress_stream_batched`: batches of K,
    dispatched ahead of the host work of earlier batches (at most
    `lookahead` batches in flight), each on a CUDA stream of its own, the
    copies non-blocking into page-locked memory and waited on by events
    only when the host needs the bytes.

The CUDA streams come from a pool per device kept across calls (the
caching allocator keeps its free blocks per stream, so the same streams
reuse the same memory).  Every function keeps its input order and
consumes its input lazily.  A
CUDA tensor the caller made is read on another stream only after an event
recorded on the caller's stream, and `record_stream` keeps the caching
allocator from handing its memory out while that read is pending; a
volume handed back on the card reaches the caller's stream the same way.
On the CPU (device="cpu") the same functions run the plain versions, with
no streams.  Containers are byte-equal to `compress` of the same volume,
volumes bit-equal to `decompress` on the same engine.
"""

from __future__ import annotations

import collections
import concurrent.futures as _cf
import contextlib
import itertools
import threading

import torch

from .ops import codec


def _windowed(ex, fn, items, window):
    """Submit at most `window` items ahead, yielding results in order.

    Pulls from `items` lazily so an unbounded stream (the RTM snapshot
    use case) holds at most `window` volumes in flight at any time.
    """
    items = iter(items)
    futs = collections.deque()
    try:
        while True:
            while len(futs) < window:
                try:
                    futs.append(ex.submit(fn, next(items)))
                except StopIteration:
                    break
            if not futs:
                return
            yield futs.popleft().result()
    finally:
        for f in futs:
            f.cancel()


def _batches(items, batch):
    buf = []
    for it in items:
        buf.append(it)
        if len(buf) == batch:
            yield buf
            buf = []
    if buf:
        yield buf


def _on(stream):
    """Make `stream` current (a null context on the CPU, stream None)."""
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)


_POOL_LOCK = threading.Lock()
_POOL = {}  # device -> its CUDA streams, made on first use


def _streams(device, n):
    """The first n CUDA streams of `device`'s pool, the same ones call after
    call: the caching allocator keeps its free blocks per stream, so the
    encode's and decode's buffers are reused across calls."""
    with _POOL_LOCK:
        pool = _POOL.setdefault(device, [])
        while len(pool) < n:
            pool.append(torch.cuda.Stream(device))
        return pool[:n]


def _worker_streams(n):
    """stream(device): the calling worker thread's own stream, one of the
    pool's first n (None on the CPU)."""
    local, slots = threading.local(), itertools.count()

    def stream(device):
        if device.type != "cuda":
            return None
        if not hasattr(local, "slot"):
            local.slot = next(slots)
        return _streams(device, n)[local.slot % n]

    return stream


def _caller_event(vols):
    """An event on the caller's current stream, recorded when the first of
    `vols` that is a CUDA tensor is handed over; None when none is."""
    for v in vols:
        if isinstance(v, torch.Tensor) and v.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(v.device))
            return ev
    return None


def _adopt(vols, ev, stream):
    """Let `stream` read the caller's CUDA tensors among `vols` (made before
    the event `ev` on the caller's stream)."""
    if ev is None:
        return
    stream.wait_event(ev)
    for v in vols:
        if isinstance(v, torch.Tensor) and v.is_cuda:
            v.record_stream(stream)


def _done_event(stream):
    """An event recorded on `stream` now (None on the CPU)."""
    if stream is None:
        return None
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def _hand_back(vol, ev):
    """Hand a volume made on a worker stream (finished at event `ev`) to
    the caller's current stream."""
    if ev is not None:
        cur = torch.cuda.current_stream(vol.device)
        cur.wait_event(ev)
        vol.record_stream(cur)
    return vol


def _volume_device(v, device):
    return v.device if isinstance(v, torch.Tensor) else codec._target(device)


def compress_stream(volumes, scale, block=(32, 32, 32), use_local_rms=False,
                    workers=6, device=None):
    """Compress an iterable of volumes, pipelined; yields (container, ratio)
    in input order.  At most workers+1 volumes are in flight (the input
    iterable is consumed lazily).  Each worker thread runs its volumes on
    a CUDA stream of its own.  Tensors bring their device, numpy volumes
    go to `device` ("cuda" when None)."""
    stream = _worker_streams(workers)

    def run(item):
        v, ev = item
        s = stream(_volume_device(v, device))
        with _on(s):
            _adopt([v], ev, s)
            return codec.compress(v, scale, block, use_local_rms,
                                  device=None if isinstance(v, torch.Tensor) else device)

    items = ((v, _caller_event([v])) for v in volumes)
    with _cf.ThreadPoolExecutor(workers) as ex:
        yield from _windowed(ex, run, items, workers + 1)


def decompress_stream(containers, workers=6, device="cuda", engine="auto"):
    """Decompress an iterable of containers, pipelined; yields volumes
    (tensors on `device`) in input order.  At most workers+1 containers are
    in flight.  Each worker thread runs on a CUDA stream of its own; a
    volume reaches the caller's stream through an event."""
    stream = _worker_streams(workers)
    dev = codec._target(device)

    def run(d):
        s = stream(dev)
        with _on(s):
            vol = codec.decompress(d, device=dev, engine=engine)
            return vol, _done_event(s)

    with _cf.ThreadPoolExecutor(workers) as ex:
        for vol, ev in _windowed(ex, run, containers, workers + 1):
            yield _hand_back(vol, ev)


def compress_batched(volumes, scale, block=(32, 32, 32), use_local_rms=False,
                     with_ratio=False, glob_mulfacs=None, device=None):
    """Compress a batch of volumes with ONE read-back of the sizes and ONE
    device-to-host copy of the streams (`codec.compress_many`).

    Returns a list of containers (or (container, ratio) pairs when
    `with_ratio`), byte-equal to per-volume `compress`.  Volumes on the
    card never leave it.  `glob_mulfacs` (optional, one per volume)
    overrides the header mulfacs: the multi-device layer's contract (the
    global RMS reduced across shards before any shard compresses).
    """
    res = codec.compress_many(list(volumes), scale, block, use_local_rms,
                              glob_mulfacs=glob_mulfacs, device=device)
    return res if with_ratio else [d for d, _ in res]


def _per_container(containers, device, to_host):
    """The fallback of the batched decompresses: one `decompress` each on
    the same device."""
    for d in containers:
        vol = codec.decompress(d, device=device)
        yield vol.cpu().numpy() if to_host else vol


def decompress_batched(containers, to_host=True, device="cuda"):
    """Decompress a batch of same-geometry containers with ONE upload of
    their plans (`codec.decompress_many`, the device engine).

    Returns volumes in input order: host numpy arrays (one device-to-host
    copy for the batch), or tensors on `device` when `to_host=False` (the
    RTM backward-pass shape).  Mixed geometries, or a container whose spans
    the device engine's plan rejects, fall back to per-container
    `decompress` on the same device.
    """
    containers = list(containers)
    out = codec.decompress_many(containers, device, to_host)
    if out is None:
        out = list(_per_container(containers, device, to_host))
    return out


class _Ring:
    """The pool's first n CUDA streams of a device, taken in turn (none on
    the CPU)."""

    def __init__(self, n):
        self.n, self.i = n, 0

    def next(self, device):
        if device.type != "cuda":
            return None
        self.i += 1
        return _streams(device, self.n)[self.i % self.n]


def compress_stream_batched(volumes, scale, block=(32, 32, 32),
                            use_local_rms=False, batch=4, lookahead=1,
                            glob_mulfacs=None, device=None):
    """Batched streaming compress: yields (container, ratio) in input
    order, consuming the volume stream `batch` at a time.

    `glob_mulfacs` (optional iterable, consumed in lockstep with
    `volumes`) overrides the per-volume header mulfacs (the multi-device
    layer's contract).

    Dispatch ahead: batch i+1's mulfacs and encodes (`codec.compress_stage`)
    launch BEFORE batch i's emits, stream copy and host assembly
    (`codec.compress_finish`), each batch on its own CUDA stream, so the
    card encodes the next batch while the host waits for and assembles
    this one.  At most `lookahead` + 1 batches are in flight, each holding
    its encode's outputs on the card until its finish.
    """
    ring = _Ring(lookahead + 1)
    paired = zip(volumes, itertools.repeat(None) if glob_mulfacs is None
                 else glob_mulfacs)
    pending = collections.deque()

    def stage(chunk):
        vols = [v for v, _ in chunk]
        dev = codec.batch_device(vols, device)
        s = ring.next(dev)
        ev = _caller_event(vols)
        with _on(s):
            _adopt(vols, ev, s)
            b = codec.compress_stage(vols, scale, block, use_local_rms,
                                     [g for _, g in chunk], dev)
        return s, b

    def finish(s, b):
        with _on(s):
            return codec.compress_finish(b)

    for chunk in _batches(paired, batch):
        pending.append(stage(chunk))
        while len(pending) > lookahead:
            yield from finish(*pending.popleft())
    while pending:
        yield from finish(*pending.popleft())


def decompress_stream_batched(containers, batch=4, to_host=True, lookahead=1,
                              device="cuda"):
    """Batched streaming decompress: yields volumes in input order.

    The host plans batch i+1 (`codec.decompress_many_prepare`) and launches
    its upload and decodes (`decompress_many_dispatch`, on a CUDA stream of
    the batch's own) before it waits for batch i, whose volumes come back
    to page-locked memory in one non-blocking copy (`to_host`, numpy
    arrays) or reach the caller's stream on the card.  Mixed geometries or
    a plan rejected fall back to per-container `decompress`.
    """
    dev = codec._target(device)
    ring = _Ring(lookahead + 1)
    pending = collections.deque()

    def dispatch(chunk):
        prep = codec.decompress_many_prepare(chunk, dev)
        if prep is None:
            return chunk, None
        s = ring.next(dev)
        with _on(s):
            vols = codec.decompress_many_dispatch(prep)
            if to_host:
                host, ev = codec.fetch(torch.stack(vols))
                return chunk, (host, ev, prep)
            return chunk, (vols, _done_event(s), prep)

    def finish(chunk, res):
        if res is None:
            yield from _per_container(chunk, dev, to_host)
            return
        out, ev, _ = res
        if to_host:
            codec.wait(ev)
            yield from out.numpy()
        else:
            for v in out:
                yield _hand_back(v, ev)

    for chunk in _batches(containers, batch):
        pending.append(dispatch(chunk))
        while len(pending) > lookahead:
            yield from finish(*pending.popleft())
    while pending:
        yield from finish(*pending.popleft())
