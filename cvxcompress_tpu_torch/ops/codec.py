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
     the transform (kernel `plane_cascade_fwd`), then the kernel
     `tokenize_stripe`, ops/tokenize.py `encode`); the JAX package's encode switches select
     three more routes (`encode_route`, ops/geometry.py): "block128_w"
     (`CVX_FUSED_W=1`: ops/fused_compress.py `block_encode_w`), "patch"
     (`CVX_STRIPE=patch`: the stripe route's encode) and "compact"
     (`CVX_FUSED_COMPACT=1`: ops/tokenize.py `compact_encode`);
  3. one small read-back of the per-block sizes, raw flags and mulfacs (on
     the patch and compact routes with the number of live chunks), a
     non-blocking copy into page-locked memory waited on by an event;
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
     coefficients, when there are any), into page-locked memory;
  7. the host assembles the container (ops/rle_device.py, container.py),
     with the `blkmulfac` table under the local RMS.
`compress_many` runs K volumes through the same steps with one read-back
(3) and one copy (6) for all K: `compress_stage` is steps 1-3 without
waiting, `compress_finish` the rest, so a pipeline can stage the next
batch before it finishes this one (pipeline.py); `compress` is
`compress_many` of one volume.

Decompress has two engines, as in the JAX package (`cvxcompress_tpu/ops/
codec.py:1490-1523`):
- "device" (`decompress_device`): the host plans the spans, O(blocks)
  (ops/entropy_decode.py `device_plan`: a copy table and the small
  fields, each block's scalefac among them), uploads that head and
  the container's payload as it is, and the kernel `plan_layout` lays the
  plan's blob out on the card (the payload in aligned rows, the
  subsegment tables); the device parses the
  stream (decode_maps, decode_chase), emits the coefficients into a dense
  block-major buffer (decode_emit), overlays the raw blocks and runs the
  inverse on it (32^3: `fused_inverse`; aligned 128^3:
  `block_fused_inverse`; the "stripe_fused" blocks: `stripe_fused_inverse`;
  every other block: `plane_cascade_inv`, straight into the volume, where
  the JAX `_inverse_from_plane` runs XLA products and a relayout);
- "host": the native library decodes every block on the host (with the
  container's `blkmulfac` under the local RMS), only the non-zero
  min(128, cells)-cell chunks go up to the device (`sparse_chunks`), and the
  inverse runs there (at every block but 32^3 after one `index_copy_` of
  the chunks into a zeroed dense buffer).

`decompress_many` decodes K containers of one geometry on the device
engine with one upload of their K heads and payloads.

Each stage and each host wait on the card runs inside a span named
"cvx.<stage>" (`utils/profiling.span`: a `record_function` while a
profiler records, a flag check otherwise), and each public half inside one
of its own name ("cvx.compress_stage", ...), so a trace attributes host
and device time to the stages and names the host time between them; a
wait's span ends in "_wait" and encloses no launch but the copy it waits
for.  The spans the benchmark times on the host whole ("cvx.assemble",
"cvx.plan") hold no span inside: a span's own cost under a trace would
land in theirs.

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

from .. import container as ctn
from ..utils import io, profiling
from . import (
    entropy_decode, fused_compress, fused_inverse, geometry, pack, quant, rle_device,
    rle_host, tokenize, wavelet,
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


def host_buffer(n, dtype, device):
    """An empty (n,) host tensor for an asynchronous copy from or to
    `device`: page-locked when `device` is a card."""
    return torch.empty(n, dtype=dtype, pin_memory=torch.device(device).type == "cuda")


def fetch(t):
    """Start one device-to-host copy of `t` into page-locked memory on the
    current stream.  Returns (host tensor, event): read the host tensor
    only after `event.synchronize()`; event is None for a CPU tensor."""
    if t.device.type == "cpu":
        return t, None
    host = host_buffer(t.numel(), t.dtype, t.device).view(t.shape)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def wait(ev):
    """Wait for a `fetch` (no-op for None)."""
    if ev is not None:
        ev.synchronize()


def batch_device(vols, device):
    """The one device a batch runs on: the tensors' own (all the same, and
    `device` if given), else `device` ("cuda" when None)."""
    devs = {v.device for v in vols if isinstance(v, torch.Tensor)}
    if len(devs) > 1:
        raise ValueError(f"the volumes lie on several devices: {sorted(map(str, devs))}")
    if devs:
        dev = devs.pop()
        if device is not None and torch.device(device) != dev:
            raise ValueError(f"the volumes lie on {dev}, but device={device!r} was given")
        return dev
    return _target(device)


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
    container any decoder reads.  One volume through `compress_many`'s
    stages.
    """
    return compress_many([vol], scale, block, use_local_rms, device=device)[0]


def compress_many(vols, scale, block=BLOCK, use_local_rms=False, glob_mulfacs=None,
                  device=None, _route=None):
    """Compress K volumes. Returns [(container uint8, ratio)], each byte-equal
    to `compress` of that volume (the same launches on the same inputs).

    The K global-RMS sums (CUDA tensors), then the K encodes launch back to
    back; ONE read-back brings all K sizes bundles, the K emits launch, and
    ONE device-to-host copy into page-locked memory brings all K streams
    (`compress_stage`, `compress_finish`).  `glob_mulfacs` (optional, one
    per volume, None entries allowed) overrides the header mulfacs, the
    multi-device layer's contract (the global RMS reduced across shards).
    Tensors bring their device (one for the batch), numpy volumes go to
    `device` ("cuda" when None).  `_route` (internal) forces the encode
    route: a z-slab shard of a larger volume encodes on the whole volume's
    (parallel/compress.py), whatever its own shape would pick.
    """
    return compress_finish(compress_stage(vols, scale, block, use_local_rms,
                                          glob_mulfacs, device, _route))


@profiling.traced("cvx.compress_stage")
def compress_stage(vols, scale, block=BLOCK, use_local_rms=False, glob_mulfacs=None,
                   device=None, _route=None):
    """The first half of `compress_many`, on the current stream: upload the
    numpy volumes, the header mulfacs (one read-back of the K f64 sums of
    the CUDA tensors), the K encodes, then a non-blocking copy of their K
    sizes bundles into page-locked memory.  Returns the batch for
    `compress_finish`; the host does not wait for the encodes."""
    block = geometry.check_block(block)
    vols = list(vols)
    if glob_mulfacs is None:
        glob_mulfacs = [None] * len(vols)
    elif len(glob_mulfacs) != len(vols):
        raise ValueError(f"{len(glob_mulfacs)} mulfacs for {len(vols)} volumes")
    dev = batch_device(vols, device)
    with device_guard(dev):
        with profiling.span("cvx.volume_h2d"):
            ts = [_device_volume(v, dev) for v in vols]
        with profiling.span("cvx.mulfac"):
            mfs = _header_mulfacs(vols, ts, scale, use_local_rms, glob_mulfacs)
        ctxs = [_encode(t, scale, block, use_local_rms, m, _route)
                for t, m in zip(ts, mfs)]
        with profiling.span("cvx.sizes_readback"):
            sr, ev = fetch(torch.cat([c.pop("bundle") for c in ctxs])) if ctxs \
                else (None, None)
    return dict(device=dev, ctxs=ctxs, sizes=sr, event=ev)


@profiling.traced("cvx.compress_finish")
def compress_finish(batch):
    """The second half of `compress_many`: wait for the sizes bundles, launch
    the K emits, ONE device-to-host copy of every stream (and the raw
    blocks' coefficients), then the host assembles the K containers."""
    ctxs = batch["ctxs"]
    if not ctxs:
        return []
    with device_guard(batch["device"]):
        with profiling.span("cvx.sizes_readback"):
            with profiling.span("cvx.sizes_wait"):
                wait(batch["event"])
            sr, off = batch["sizes"].numpy(), 0
            for c in ctxs:
                _read_sizes(c, sr[off:off + c["bundle_len"]])
                off += c["bundle_len"]
        parts = [_emit(c) for c in ctxs]
        with profiling.span("cvx.stream_d2h"):
            flat, ev = fetch(torch.cat([x for p in parts for x in p]))
            with profiling.span("cvx.stream_wait"):
                wait(ev)
            flat = flat.numpy()
    out, off = [], 0
    with profiling.span("cvx.assemble"):
        for c in ctxs:
            n = c["total"] + c["raw_bytes"]
            out.append(_assemble(c, flat[off:off + n]))
            off += n
    return out


def _header_mulfacs(vols, ts, scale, use_local_rms, glob_mulfacs):
    """Each volume's header mulfac (np.float32): 1.0 under the local RMS
    (each block's then comes from its own coefficients), the caller's
    override, else `quant.global_mulfac`'s: a numpy volume (or a CPU
    tensor) by the reference's f64 reduction on the host, a CUDA tensor by
    its f64 sum on the card, the sums of all of them read back in one
    copy."""
    out = [None] * len(vols)
    card = []
    for i, (v, t, g) in enumerate(zip(vols, ts, glob_mulfacs)):
        if use_local_rms:
            out[i] = np.float32(1.0)
        elif g is not None:
            out[i] = np.float32(g)
        elif t.device.type != "cpu" and isinstance(v, torch.Tensor):
            card.append(i)
        else:
            with profiling.span("cvx.mulfac_host"):
                out[i] = quant.global_mulfac(t if isinstance(v, torch.Tensor) else v,
                                             scale)
    if card:
        acc = torch.stack([quant.sumsq(ts[i]) for i in card])
        with profiling.span("cvx.mulfac_wait"):
            acc = acc.cpu().numpy()
        for i, a in zip(card, acc):
            out[i] = quant.mulfac_from_sumsq(a, ts[i].numel(), scale)
    return out


def _encode(t, scale, block, use_local_rms, mulfac, path=None):
    """Launch one volume's encode on the current stream, the route's
    kernels (`path`, else `encode_route` of its shape) at the header
    `mulfac` (or each block's, under the local RMS).
    Returns its context: the encode's outputs, and `bundle`, its sizes,
    raw flags and mulfacs (on the patch and compact routes with the number
    of live chunks) as one int32 tensor, what the emit needs read back."""
    path = path or encode_route(t.shape, block, use_local_rms)
    args = dict(scale=scale) if use_local_rms else dict(mulfac=mulfac)
    c = dict(shape=tuple(t.shape), block=block, path=path, mulfac=mulfac,
             use_local=use_local_rms, nlive=None)
    if path == "fused32":
        with profiling.span("cvx.fused_encode"):
            out = tokenize.fused_encode(t, **args)
    elif path == "block128":
        with profiling.span("cvx.block_encode"):
            out = fused_compress.block_encode(t, **args)
    elif path == "block128_w":
        with profiling.span("cvx.block_encode_w"):
            out = fused_compress.block_encode_w(t, mulfac)
    elif path == "stripe_fused":
        with profiling.span("cvx.stripe_fused_encode"):
            out = tokenize.stripe_fused_encode(t, block, **args)
    elif path == "compact":
        with profiling.span("cvx.compact_encode"):
            (coeffs, mulfacs, chunk_bytes, sizes, raw, rows, drows, ids, _,
             c["nlive"]) = tokenize.compact_encode(t, block, **args)
        out = (coeffs, None, chunk_bytes, sizes, raw, mulfacs)
        c.update(rows=rows, drows=drows, ids=ids)
    else:
        with profiling.span("cvx.encode"):
            out = tokenize.encode(t, block, **args)
    coeffs, desc, chunk_bytes, sizes, raw, mulfacs = out
    c.update(coeffs=coeffs, desc=desc, chunk_bytes=chunk_bytes, mulfacs=mulfacs)
    with profiling.span("cvx.bundle"):
        if path == "patch":
            c["nlive"] = (chunk_bytes > 0).sum(dtype=torch.int32).view(1)
        parts = [sizes, raw.to(torch.int32), mulfacs.view(torch.int32)]
        c["bundle"] = torch.cat(parts + ([] if c["nlive"] is None else [c["nlive"]]))
    c["bundle_len"] = c["bundle"].numel()
    return c


def _read_sizes(c, sr):
    """Host: one volume's tables from its read-back bundle `sr` (int32):
    per-block sizes, raw flags and mulfacs, the stream's bytes `total` and,
    on the patch and compact routes, the live chunks `live`."""
    nnn = c["mulfacs"].numel()
    sizes_h, raw_h = sr[:nnn].astype(np.int64), sr[nnn:2 * nnn].astype(bool)
    c.update(sizes_h=sizes_h, raw_h=raw_h, mulfacs_h=sr[2 * nnn:3 * nnn].view(np.float32),
             total=int(sizes_h[~raw_h].sum()),
             live=int(sr[3 * nnn]) if c["nlive"] is not None else None)


def _emit(c):
    """Launch one volume's emit from its tables (`_read_sizes`): the chunk
    bases, the live rows on the patch route, the emit kernel.  Returns the
    uint8 device tensors to bring back: the stream, then the raw blocks'
    UNSCALED coefficients (CvxCompress.cpp:359) when any.  The context
    keeps only the host tables after this."""
    total, raw_h, n = c["total"], c["raw_h"], c["live"]
    path, block = c["path"], c["block"]
    coeffs, desc, chunk_bytes = c.pop("coeffs"), c.pop("desc"), c.pop("chunk_bytes")
    mulfacs = c.pop("mulfacs")
    with profiling.span("cvx.chunk_bases"):
        base = pack.chunk_bases(chunk_bytes)
    if path in ("patch", "compact"):
        if path == "patch":
            with profiling.span("cvx.patch_extract"):
                rows, drows, ids = pack.patch_extract(coeffs, desc, chunk_bytes,
                                                      block, n)
        else:
            rows, drows, ids = c.pop("rows"), c.pop("drows"), c.pop("ids")
        with profiling.span("cvx.emit_rows"):
            stream = pack.emit_rows(rows[:n], drows[:n], ids[:n], mulfacs,
                                    chunk_bytes, base, total)
    else:
        with profiling.span("cvx.emit_chunks"):
            stream = pack.emit_chunks(
                coeffs, mulfacs, desc, chunk_bytes, base, total,
                block if path == "stripe" else None)
    out = [stream]
    ids = np.flatnonzero(raw_h)
    if ids.size:
        with profiling.span("cvx.raw_gather"):
            if path in ("stripe", "patch"):
                rc = geometry.gather_blocks(coeffs, ids, c["shape"], block)
            else:
                rc = coeffs.index_select(0, torch.from_numpy(ids).to(coeffs.device))
            out.append(rc.reshape(-1).view(torch.uint8))
    c["raw_bytes"] = 4 * rc.numel() if ids.size else 0
    return out


def _assemble(c, flat):
    """Host: the container of one volume from its stream and raw bytes
    (`flat`, as `_emit` listed them) -> (container, ratio)."""
    block = c["block"]
    cells = block[0] * block[1] * block[2]
    total = c["total"]
    raw_bytes = flat[total:].reshape(-1, 4 * cells) if c["raw_bytes"] else None
    payload, _ = rle_device.assemble_payload_blockorder(
        flat[:total], c["sizes_h"], c["raw_h"], raw_bytes, cells)
    nz, ny, nx = c["shape"]
    hdr = ctn.Header(nx, ny, nz, *block, c["mulfac"], c["use_local"])
    data = ctn.pack_stream(hdr, c["sizes_h"], c["raw_h"], payload,
                           c["mulfacs_h"] if c["use_local"] else None)
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


def _inverse(dense, hdr, path=None):
    """The inverse of the container's geometry on the dense block-major
    coefficients: a kernel at 32^3, aligned 128^3 and the "stripe_fused"
    blocks, else `wavelet.inverse_to_volume` (kernel `plane_cascade_inv`,
    which also writes the volume from the block-major coefficients, where
    the JAX package's `_inverse_from_plane` runs XLA products and a
    relayout, `cvxcompress_tpu/ops/codec.py:1151-1169`).  `path` forces the
    route (a slab
    of a larger volume decodes on the whole volume's), else `route`."""
    shape = (hdr.nz, hdr.ny, hdr.nx)
    block = (hdr.bx, hdr.by, hdr.bz)
    path = path or route(shape, block)
    if path == "fused32":
        with profiling.span("cvx.fused_inverse"):
            return fused_inverse.fused_inverse(dense.view(-1, 128), None, shape)
    if path == "block128":
        with profiling.span("cvx.block_fused_inverse"):
            return fused_inverse.block_fused_inverse(dense.view(-1, 128), shape)
    if path == "stripe_fused":
        with profiling.span("cvx.stripe_fused_inverse"):
            return fused_inverse.stripe_fused_inverse(dense, shape, block)
    with profiling.span("cvx.inverse"):
        return wavelet.inverse_to_volume(dense, shape, block)


def decompress_device(data, device, path=None):
    """The device engine (`cvxcompress_tpu/ops/codec.py:1235`): the volume
    as a tensor on `device`, or None when `plan` rejects the container's
    spans.  The container is already validated; `path` as `_inverse`'s."""
    with profiling.span("cvx.plan"):
        p = entropy_decode.device_plan(data)
    if p is None:
        return None
    with profiling.span("cvx.plan_h2d"):
        up, blob = entropy_decode.upload_plan(p, device)
    with profiling.span("cvx.plan_layout"):
        b = entropy_decode.plan_layout(up, blob, p)
    return _decode_planned(p, b, path)


def _decode_planned(p, b, path=None):
    """The device engine's launches on a plan `p` whose fields `b` lie on
    the device: parse, chase, emit, the raw blocks, the inverse."""
    hdr, cells = p["hdr"], p["cells"]
    nsub = b["sub_block"].numel()
    with profiling.span("cvx.decode_maps"):
        M, P = entropy_decode.parse_maps(b["stream"], nsub, cells)
    with profiling.span("cvx.decode_chase"):
        e32, c32 = entropy_decode.chase(P, b["sub_reset"], b["starts"], cells)
    with profiling.span("cvx.decode_emit"):
        dense = entropy_decode.emit(b["stream"], M, e32, c32, b["sub_block"],
                                    b["scalefac"], hdr.grid[3], cells)
    with profiling.span("cvx.overlay_raw"):
        entropy_decode.overlay_raw(dense, b["raw_rows"], b["raw_ids"])
    return _inverse(dense, hdr, path)


def decompress_many(datas, device="cuda", to_host=True):
    """Decompress K containers of one geometry on the device engine.

    The host plans all K (`entropy_decode.device_plan`) and
    packs each head and each container's payload into ONE buffer
    (page-locked for a card), ONE host-to-device copy takes it up, and the
    K layouts (`plan_layout`), decodes and inverses launch back to back
    (`decompress_many_prepare`, `decompress_many_dispatch`).  Returns K
    volumes, each bit-equal to `decompress(data, device, engine="device")`:
    host numpy arrays (one device-to-host copy for the batch) when
    `to_host`, else tensors on `device`.  Returns None when the geometries
    differ or a container's spans are degenerate; the caller then
    decompresses each one by one.
    """
    device = _target(device)
    with device_guard(device):
        prep = decompress_many_prepare(datas, device)
        if prep is None:
            return None
        vols = decompress_many_dispatch(prep)
        if not to_host or not vols:
            return vols
        with profiling.span("cvx.volume_d2h"):
            host, ev = fetch(torch.stack(vols))
            with profiling.span("cvx.volume_wait"):
                wait(ev)
    return list(host.numpy())


@profiling.traced("cvx.decompress_many_prepare")
def decompress_many_prepare(datas, device):
    """The host half of `decompress_many`: the K containers validated,
    their plans' spans and heads, each head and payload packed into one
    host buffer for `device` (no device work).  None when a container's
    spans are degenerate or the geometries differ."""
    datas = list(datas)
    with profiling.span("cvx.validate"):
        for d in datas:
            io.validate(d)
    plans = []
    with profiling.span("cvx.plan"):
        for d in datas:
            p = entropy_decode.device_plan(d)
            if p is None:
                return None
            plans.append(p)
    geoms = {(p["hdr"].nz, p["hdr"].ny, p["hdr"].nx, p["hdr"].bx, p["hdr"].by,
              p["hdr"].bz) for p in plans}
    if len(geoms) > 1:
        return None
    # each upload (head, then payload) and each blob on a 16-byte boundary
    ups = np.array([p["head"].size + entropy_decode._align(p["payload"].size)
                    for p in plans], dtype=np.int64)
    blobs = np.array([p["size"] for p in plans], dtype=np.int64)
    with profiling.span("cvx.plan_pack"):
        host = host_buffer(int(ups.sum()), torch.uint8, device)
        h = host.numpy()
        o = 0
        for p, n in zip(plans, ups):
            head, payload = p["head"], p["payload"]
            h[o: o + head.size] = head
            h[o + head.size: o + head.size + payload.size] = payload
            o += int(n)
    return dict(device=torch.device(device), plans=plans, ups=ups, blobs=blobs,
                host=host)


@profiling.traced("cvx.decompress_many_dispatch")
def decompress_many_dispatch(prep):
    """The device half of `decompress_many` on the current stream: ONE
    host-to-device copy of the packed heads and payloads, then for each
    container its `plan_layout`, its decode and its inverse.  Returns the K
    volumes (tensors; no host sync)."""
    host, ups, blobs = prep["host"], prep["ups"], prep["blobs"]
    with device_guard(prep["device"]):
        with profiling.span("cvx.plan_h2d"):
            up = torch.empty(host.numel(), dtype=torch.uint8, device=prep["device"])
            up.copy_(host, non_blocking=True)
            blob = torch.empty(int(blobs.sum()), dtype=torch.uint8,
                               device=prep["device"])
        out = []
        for p, a, n, b, m in zip(prep["plans"], np.cumsum(ups) - ups, ups,
                                 np.cumsum(blobs) - blobs, blobs):
            with profiling.span("cvx.plan_layout"):
                f = entropy_decode.plan_layout(up[int(a): int(a + n)],
                                               blob[int(b): int(b + m)], p)
            out.append(_decode_planned(p, f))
        return out


def _decode_host(data, hdr, blkoffs, blkmulfac, payload_base, device, path=None):
    """The host engine: native decode, chunk-sparse upload, inverse."""
    raw = np.frombuffer(memoryview(data), dtype=np.uint8)
    shape = (hdr.nz, hdr.ny, hdr.nx)
    with profiling.span("cvx.decode_host"):
        coeffs = rle_host.decode_payloads(
            raw[payload_base:], blkoffs, hdr.glob_mulfac,
            hdr.bx * hdr.by * hdr.bz, blkmulfac,
        )
    with profiling.span("cvx.sparse_chunks"):
        rows, invmap = sparse_chunks(coeffs)
    if (hdr.bx, hdr.by, hdr.bz) == BLOCK:
        with profiling.span("cvx.chunks_h2d"):
            rows_t = torch.from_numpy(rows).to(device)
            invmap_t = torch.from_numpy(invmap).to(device)
        with profiling.span("cvx.fused_inverse"):
            return fused_inverse.fused_inverse(rows_t, invmap_t, shape)
    with profiling.span("cvx.chunks_h2d"):
        rows_t = torch.from_numpy(rows).to(device)
        ids_t = torch.from_numpy(np.flatnonzero(invmap < rows.shape[0])).to(device)
    with profiling.span("cvx.densify"):
        dense = torch.zeros((invmap.size, rows.shape[1]), dtype=torch.float32,
                            device=device)
        dense.index_copy_(0, ids_t, rows_t)
    return _inverse(dense, hdr, path)


ENGINES = ("auto", "device", "host")


@profiling.traced("cvx.decompress")
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
    with profiling.span("cvx.validate"):
        io.validate(data)
    device = _target(device)
    with device_guard(device):
        return _decompress(data, device, engine)


def _decompress(data, device, engine, path=None):
    with profiling.span("cvx.validate"):
        hdr, blkoffs, blkmulfac, payload_base = ctn.unpack(data)
    if engine == "device" or (engine == "auto" and device.type == "cuda"):
        out = decompress_device(data, device, path)
        if out is not None:
            return out
        if engine == "device":
            raise ValueError("container not decodable on the device engine "
                             "(degenerate payload spans)")
    return _decode_host(data, hdr, blkoffs, blkmulfac, payload_base, device, path)
