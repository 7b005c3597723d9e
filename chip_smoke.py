#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels (csrc/, nvcc for sm_90a) and the native host library
(make -C native), then, for each of the ported paths:

- config A, the reference CI input: the (352, 416, 320) sinusoid at scale
  1e-2 with 32^3 blocks (phases 2 and 3);
- config B, the JAX package's bench config B: the (384, 384, 384) sinusoid
  at scale 1e-2 with 128^3 blocks (phases 2b and 3b);
- both with the local RMS, `use_local_rms=True` (phases 2c, 3c and 3d; the
  kernels also on a "ramp" volume whose block RMS span 10^4, with an
  all-zero, a ~1e-38 and a NaN block, and the 128^3 local kernels on the
  (512, 256, 256) volume whose upper half is zero; the ratio and the
  mulfac table held against the native library's local codec run in the
  same script);
- every other block geometry (phases 2d and 3e): the kernels of the
  stripe route (`tokenize_stripe`) and of the fused stripe route
  (`stripe_fused_encode`, `_local`, `stripe_fused_inverse`) and
  `block_emit` at A with 8^3, 64^3, 256^3 and (64, 32, 32) blocks, on a
  (512, 256, 256) volume whose upper half is zero, and at the bench's
  256^3 volume S with 16^3, (16, 16, 1), (8, 8, 1) and (128, 8, 8) blocks
  (sinusoid and ramp), and N(0,1) noise on (100, 130, 75) at 8^3, 16^3,
  64^3 and (64, 32, 32) (edge blocks); then A at 8^3, 64^3 and 256^3 and
  S at the sweep's blocks, global and local, through the public API: the
  size within 1 % of native's codec run here and, at S, within max(64 B,
  1 %) of the JAX package's codec on the same input (level 3,
  `tools/jax_quality_s.py`), every quantized
  coefficient equal to native's or one step from it where the port's
  scaled value sits on the step, err within 2 % and SNR within 0.2 dB of
  the reference where no coefficient steps (else within what the steps
  can move them), containers decoding both ways;
- the JAX package's opt-in encode routes (phases 2e and 3f): under
  CVX_FUSED_W=1 at B (`block_fwd_xz` + `block_encode_y`, the 128^3 encode
  split at x,z | y, held bit-equal to `block_encode`'s z | x,y and timed
  beside it; `block_fwd_xz` also beside one two-operator einsum),
  CVX_FUSED_W=0 at B (`tokenize_stripe`, K15's home), CVX_STRIPE=patch at
  A with 32^3 and 64^3 blocks (`patch_extract` and `block_emit_rows`; in
  phase 2e also on A's ramp, A's N(0,1) noise, every chunk live, and A at
  (8, 16, 8)) and CVX_FUSED_COMPACT=1 at A, A-local, B and the
  half-zero volume at 256^3 blocks (`tokenize_compact` and
  `block_emit_rows`), each kernel against its plain
  version and the rows emit against the in-place one; each switch through
  the public API: its kernels launch, the container byte-equal to the
  default route's where the coefficients are, else the ratio within 1 % of
  native's and the CI bars; and an 8^3 compress under the caller's
  set_float32_matmul_precision("high") equal to one under "highest";
- the RTM snapshot path (phase 3g), on volumes born on the card:
  `compress_many` of 4 A volumes, 2 A-local and 2 B volumes and
  `decompress_many` of their containers (device engine), the four stream
  functions of `pipeline` over 8 A volumes (workers 4; batch 4,
  lookahead 1), a `DeviceSnapshotStack` at A fed the 8 volumes (append,
  get, to_container, from_container, a forced capacity overflow, pop in
  reverse) and one at B of 2: every container byte-equal to a single
  compress, every volume bit-equal to a single device-engine decompress,
  the kernels' launches on each path, and the times a volume of a batch
  against single calls, of an append and of a get;

and holds `plan_layout` byte-equal to its plain version and to the host's
`plan` on every container it decodes and on snapshot 0 of the benchmark's
radial traffic at its three configurations (cvxbench/), timed there beside
the host's plan; `decode_chase`, the route the wrapper picks and each of its two
routes (the walk, the pieces), bit-equal to its plain version on every
container it decodes and, with the chase's one-step semantics, on two
synthetic inputs of 2^20 subsegments (one chain; resets at random places
and on and beside the kernel's piece seams) and times a device-engine
decompress of B's noise container through the public API (phase 2b);

it compares every kernel of the path with its plain PyTorch version at the
path's shapes (`fused_encode`, `fused_encode_local` with their chunk
counts, and `fused_inverse`, dense and chunk-sparse, bit for bit on A's
sinusoid, noise, the ramp and a (100, 130, 75) volume whose nx % 4 != 0
takes the encode's 4-byte copy route; `block_emit` over the 32^3 encode's
chunk counts, bit for bit and against the native encoder block by block,
at A and A-local; the seven 128^3 transform launches bit for bit, on the
B sinusoid, noise and ramp; each transform within 1e-5 of the f64 dense operator; the
card's decompress of A's and B's containers bit-equal to native's parity
decompress, and A's container against native's parity codec's) (also on
an N(0,1) noise volume of the same shape, the
decoder's heavy case, and against the native encoder and decoder), then
drives the path once through the public API on the default device —
compress on the card, decompress with the device engine (entropy parse,
emit and inverse on the card) — and checks the quality bars, the launch
counts (set to 0 just before the drive, read just after), the host
engine's agreement and the interop with the native C ABI.  It imports
nothing of JAX.

Output: the card's name and power limit first, progress lines, then on
the line before the last a JSON object with each kernel's launches, error,
time beside its plain version's and its bound (the least time the card
could take for the same work; the decode kernels also with the profiler's
device time of each alone, the emit's zeroing apart, on A's CI and noise
containers and B's noise container, and the noise containers' bounds),
and on the last line
{"ok": true, "device": {...}}.  Any failed check raises (exit code != 0)
and prints no result; so does a machine without a CUDA card.  Profiler
traces of one compress + decompress per timed global-RMS config (and the
local 3c, 3d) go to build/chip_smoke_trace_<config>.json.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SHAPE = (352, 416, 320)  # (nz, ny, nx), the reference CI volume
SCALE = 1e-2
PERIODS = 10
REF_RATIO = 1148.6  # the JAX package's record on this input
TRANSFORM_TOL = 1e-5  # relative RMS, the reference's fast-vs-slow bar
NOISE_SCALE = 1e-1  # N(0,1) at this scale: ~4:1, the decoder's heavy case
DECODE_SPANS = ("cvx.plan", "cvx.plan_h2d", "cvx.plan_layout", "cvx.decode_maps",
                "cvx.decode_chase", "cvx.decode_emit", "cvx.overlay_raw")
BLOCK_A = (32, 32, 32)
SHAPE_U = (100, 130, 75)  # nx % 4 != 0: the 32^3 encode's 4-byte copy route
SHAPE_B = (384, 384, 384)  # bench config B (bench.py:589, :595)
BLOCK_B = (128, 128, 128)
# the JAX package's record on config B (BENCH_dev_r05.json, B_north_star_128c)
REF_B = dict(ratio=21411.6, err=3.511e-5, snr=89.1)
# H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s, f32 and f64 FLOP/s off
# the tensor cores
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12
KERNELS_A = ("fused_encode", "block_emit", "fused_inverse")
DECODE_KERNELS = ("decode_maps", "decode_chase", "decode_emit")
CHASE_BYTES = 100 + 1 + 8  # a subsegment's P and reset flag in, e32 and c32 out
KERNELS_B = ("block_fwd_z", "block_encode_xy", "block_emit", "block_inv_xy",
             "block_inv_z")
# the local-RMS paths: config A and B with use_local_rms=True
KERNELS_C = ("fused_encode_local", "block_emit", "fused_inverse")
KERNELS_D = ("block_fwd_z", "block_casc_local", "block_scale_tok", "block_emit",
             "block_inv_xy", "block_inv_z")
# the other geometries (phases 2d and 3e): the half-zero volume (its upper
# half along z all zero: one 256^3 block is a single run of 2^24 zeros), and
# the bench's volume S at the sweep's blocks (bench.py:422-445)
SHAPE_HALF = (512, 256, 256)
SHAPE_S = (256, 256, 256)
BLOCKS_A = ((8, 8, 8), (64, 64, 64), (256, 256, 256), (64, 32, 32))
# S at the sweep's blocks: both RMS modes at the blocks A does not take;
# at 8^3, 64^3, 256^3 (A's routes) the local RMS only
CASES_S = tuple((b, lo) for b in ((16, 16, 16), (128, 8, 8), (16, 16, 1), (8, 8, 1))
                for lo in (False, True)) + tuple(
    (b, True) for b in ((8, 8, 8), (64, 64, 64), (256, 256, 256)))
# the JAX package's codec on S (bytes, err, SNR dB): `JAX_PLATFORMS=cpu
# python tools/jax_quality_s.py` on a CPU (XLA)
REF_S = {
    "16x16x16 global": (216103, 0.0003270732853401842, 69.70709853377342),
    "16x16x16 local": (234535, 0.000351934777868908, 69.07075628931146),
    "128x8x8 global": (103207, 0.00018228027870118967, 74.78520632131162),
    "128x8x8 local": (112039, 0.0001933118133898046, 74.27483210378094),
    "16x16x1 global": (847399, 0.00038376255445204336, 68.31874807446135),
    "16x16x1 local": (1113895, 9.200214287967732e-05, 80.72404114222344),
    "8x8x1 global": (3368999, 0.0007773148925392432, 62.188060231747535),
    "8x8x1 local": (4453415, 0.000248869315914388, 72.08057291961866),
    "8x8x8 global": (1105959, 0.0008049647860530091, 61.88446235680083),
    "8x8x8 local": (1249319, 0.0007801947779379127, 62.1559392173812),
    "64x64x64 global": (13639, 8.601733880332726e-05, 81.30827995475228),
    "64x64x64 local": (13895, 9.332846156004555e-05, 80.59971786172257),
    "256x256x256 global": (1353, 2.1824866929534375e-05, 93.22096791184774),
    "256x256x256 local": (1342, 2.3583944809376807e-05, 92.54767100292284),
}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")
    print(f"  ok: {msg}", flush=True)


def sinusoid(nz, ny, nx, periods):
    """vol[z, y, x] = sin(z*pi*periods/nz) (Test_With_Generated_Input.cpp)."""
    z = np.sin(np.arange(nz) * np.pi * periods / nz).astype(np.float32)
    return np.broadcast_to(z[:, None, None], (nz, ny, nx)).copy()


def same(a, b):
    """Bit-equal float tensors, a NaN matching a NaN (a NaN block's sums)."""
    na = a.isnan()
    return bool((na == b.isnan()).all()) and bool((a[~na] == b[~na]).all())


def bits_same(a, b):
    """f32 tensors equal bit for bit outside their NaNs, NaN where the other
    is NaN (a NaN's payload is the card's)."""
    import torch

    na = a.isnan()
    return bool(torch.equal(na, b.isnan())) and bool(torch.equal(
        a[~na].view(torch.int32), b[~na].view(torch.int32)))


def rel_rms(a, b):
    a = a.double()
    b = b.double()
    return float(((a - b) ** 2).mean().sqrt() / ((b**2).mean().sqrt() + 1e-30))


def err_snr(orig, recon):
    o = np.asarray(orig, dtype=np.float64)
    d = o - np.asarray(recon, dtype=np.float64)
    err = np.sqrt(np.mean(d * d)) / np.sqrt(np.mean(o * o))
    return float(err), float(-20.0 * np.log10(err))


def cuda_ms(fn, iters):
    """Mean device time of fn() over `iters` runs, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(fn, iters, match):
    """Device time per call of fn's kernels (and memsets) whose name holds
    `match`, a string or a tuple of them, each launched once a call: the
    sum over them of the profiler's mean per launch, without the host's
    launch overhead (a mean over the records there are: CUPTI sometimes
    loses one)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    match = (match,) if isinstance(match, str) else match
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total / e.count for e in prof.key_averages()
               if e.count and any(m in e.key for m in match)) / 1e3


def bound(nbytes, flops, flops64=0):
    """The least time for the work: bytes over HBM, f32 and f64 FLOP over
    their peaks."""
    tb = nbytes / HBM_BPS * 1e3
    tf = (flops / F32_FLOPS + flops64 / F64_FLOPS) * 1e3
    return dict(bound_ms=max(tb, tf), bound_by="bytes" if tb >= tf else "operations")


def cascade_flops(n, inverse=False):
    """f32 FLOP per sample of one axis' multi-level Antonini 7/9 cascade over
    n samples, as short symmetric filters compute it (native/cvx_host.cpp):
    an analysis lowpass output takes 4 pair adds, 5 multiplies and 4 adds
    (13 FLOP), a highpass one 3, 4 and 3 (10); synthesis swaps the two, an
    even output 10 and an odd one 13.  The levels are n, n - n//2, ..., 2.
    The 32^3 and 128^3 kernels run this cascade; the fused stripe kernels
    apply the composed dense operator instead, and the bound counts the
    function's work, not theirs."""
    lo, hi = (10, 13) if inverse else (13, 10)
    total, m = 0, n
    while m >= 2:
        total += lo * (m - m // 2) + hi * (m // 2)
        m -= m // 2
    return total / n


def emit_chunks_bytes(desc, chunk_bytes, total):
    """The least bytes `block_emit` moves: every chunk count; the
    descriptors and base of the live chunks (a raw block's count 0); the
    coefficients of their groups of 8 that hold a token; the table; the
    stream out."""
    nnn, cells = desc.shape
    live = chunk_bytes > 0
    groups = ((desc.view(-1, 8) & 7).sum(1) > 0).view(live.numel(), -1) & live[:, None]
    chunk = cells * nnn // live.numel()
    return (4 * live.numel() + (4 * chunk + 8) * int(live.sum())
            + 32 * int(groups.sum()) + 4 * nnn + total)


def dense_f64(t, dims, inverse, b=128):
    """The f64 dense operator (`wavelet.forward_matrix` / `inverse_matrix`)
    along `dims` of a (n, b, b, b) block batch, in f64 on t's device: the
    level-2 reference of the 128^3 kernels, which run the cascade itself."""
    import torch
    from cvxcompress_tpu_torch.ops import wavelet

    m = wavelet.inverse_matrix(b) if inverse else wavelet.forward_matrix(b)
    op = torch.tensor(m, dtype=torch.float64, device=t.device)
    out = t.view(-1, b, b, b).double()
    spec = {1: "nzyx,Zz->nZyx", 2: "nzyx,Yy->nzYx", 3: "nzyx,Xx->nzyX"}
    for d in dims:
        out = torch.einsum(spec[d], out, op)
    return out


def rel_rms_finite(got, ref, nnn):
    """rel_rms over the blocks (nnn equal rows) whose reference is finite
    (the ramp's NaN block stays NaN in every version); (error, blocks left
    out)."""
    g, r = got.reshape(nnn, -1), ref.reshape(nnn, -1)
    fin = r.isfinite().all(1)
    return rel_rms(g[fin], r[fin]), int((~fin).sum())


def hold(label, name, got, plain, ref64, nnn):
    """A 128^3 launch bit-equal to its plain version (a NaN matching a NaN)
    and within 1e-5 of the f64 dense operator on its own input."""
    check(same(got, plain), f"{label}: {name} bit-equal to its plain version")
    e, out = rel_rms_finite(got, ref64, nnn)
    check(e < TRANSFORM_TOL, f"{label}: {name} rel RMS {e:.3e} < 1e-5 of the f64 "
          f"dense operator ({out} non-finite blocks left out)")


def u32_differ(a, b):
    """Cells whose f32 bits differ (NaN payloads included)."""
    import torch

    return int((a.contiguous().view(torch.int32) != b.contiguous().view(torch.int32)).sum())


def block32(label, v, scale, local):
    """`fused_encode` (or `fused_encode_local`) and `fused_inverse` (dense
    and chunk-sparse, on the encode's coefficients) on the volume `v`,
    each bit-equal to its plain version (coefficients and volumes as
    uint32; descriptors, sizes, raw flags and the table equal) and within
    1e-5 of the f64 dense operator (`dense_f64`, the non-finite blocks or
    cells left out)."""
    import torch
    from cvxcompress_tpu_torch.ops import blocks, codec, fused_inverse, quant, tokenize

    vt = torch.from_numpy(v).cuda()
    args = dict(scale=scale) if local else dict(mulfac=quant.global_mulfac(v, scale))
    name = "fused_encode_local" if local else "fused_encode"
    k = tokenize.fused_encode(vt, **args)
    p = tokenize.fused_encode_plain(vt, **args)
    torch.cuda.synchronize()
    nnn = k[0].shape[0]
    nd = u32_differ(k[0], p[0])
    check(nd == 0, f"{label}: {name} coefficients uint32-equal to its plain version "
          f"({nd} of {k[0].numel()} cells differ)")
    check(all(torch.equal(a, b) for a, b in zip(k[1:], p[1:])),
          f"{label}: {name} descriptors, chunk counts, sizes, raw flags "
          f"({int(k[4].sum())} raw of {nnn}) and table (mulfacs {float(k[5].min()):.4g} "
          f"to {float(k[5].max()):.4g}) equal to its plain version's")
    del p
    e, out = rel_rms_finite(
        k[0], dense_f64(blocks.to_blocks(vt, BLOCK_A), (3, 2, 1), False, 32), nnn)
    check(e < TRANSFORM_TOL, f"{label}: {name} rel RMS {e:.3e} < 1e-5 of the f64 dense "
          f"operator ({out} non-finite blocks left out)")
    del vt
    rows = k[0].view(-1, fused_inverse.CHUNK)
    rows_h, invmap_h = codec.sparse_chunks(k[0].cpu().numpy())
    srows, sinv = torch.from_numpy(rows_h).cuda(), torch.from_numpy(invmap_h).cuda()
    vp = fused_inverse.fused_inverse_plain(rows, None, v.shape)
    for mode, vk in (("dense", fused_inverse.fused_inverse(rows, None, v.shape)),
                     (f"chunk-sparse, {rows_h.shape[0]} of {invmap_h.size} chunks",
                      fused_inverse.fused_inverse(srows, sinv, v.shape))):
        torch.cuda.synchronize()
        nd = u32_differ(vk, vp)
        check(nd == 0, f"{label}: fused_inverse ({mode}) volume uint32-equal to its "
              f"plain version ({nd} of {vk.numel()} cells differ)")
    ref = blocks.from_blocks(dense_f64(rows, (3, 2, 1), True, 32), v.shape, BLOCK_A)
    fin = ref.isfinite()
    e = rel_rms(vk[fin], ref[fin])
    check(e < TRANSFORM_TOL, f"{label}: fused_inverse rel RMS {e:.3e} < 1e-5 of the f64 "
          f"dense operator ({int((~fin).sum())} non-finite cells left out)")
    del k, rows, srows, sinv, vp, vk, ref
    torch.cuda.empty_cache()


def einsum3(t, shape, block, inverse):
    """One torch.einsum with the three f32 operators of `block` = (bx, by,
    bz) in full f32 over a (nz, ny, nx) volume of whole blocks: the library
    call timed beside the transform kernels (`library_ms`; the port never
    calls it).  Forward: the volume in, its coefficients out in volume
    order; inverse: block-major coefficients in, the volume out."""
    import torch
    from cvxcompress_tpu_torch.ops import wavelet

    bx, by, bz = block
    nz, ny, nx = shape
    g = (nz // bz, ny // by, nx // bx)
    ox, oy, oz = (wavelet.operator(n, inverse, t.device) for n in block)
    with wavelet.full_f32():
        if inverse:
            out = torch.einsum("abczyx,Zz,Yy,Xx->aZbYcX", t.view(*g, bz, by, bx),
                               oz, oy, ox)
        else:
            out = torch.einsum("azbycx,Zz,Yy,Xx->aZbYcX",
                               t.view(g[0], bz, g[1], by, g[2], bx), oz, oy, ox)
    return out.reshape(shape)


def einsum_xz(t, shape, block):
    """One torch.einsum with the x and z f32 operators of `block` in full
    f32 over a (nz, ny, nx) volume of whole blocks, volume order out:
    `block_fwd_xz`'s function (K16a), the library call timed beside it."""
    import torch
    from cvxcompress_tpu_torch.ops import wavelet

    bx, by, bz = block
    nz, ny, nx = shape
    ox, oz = (wavelet.operator(n, False, t.device) for n in (bx, bz))
    with wavelet.full_f32():
        out = torch.einsum("azbycx,Zz,Xx->aZbycX",
                           t.view(nz // bz, bz, ny // by, by, nx // bx, bx), oz, ox)
    return out.reshape(shape)


C32, C128 = cascade_flops(32), cascade_flops(128)
C32_INV, C128_INV = cascade_flops(32, inverse=True), cascade_flops(128, inverse=True)


def synthetic_chase(kind, dev):
    """(P, sub_reset, starts, cells) of a synthetic chase of 2^20 subsegments
    with random maps (exits in [0, 25), counts in [0, 8)), cells = 2^21:
    "chain", one chain (its counts saturate at cells after ~600,000 rows);
    "resets", resets at random places (1 in 500), on every third boundary of
    the kernel's pieces and one row before and after others (the look-back's
    seams)."""
    import torch

    from cvxcompress_tpu_torch.ops import entropy_decode

    n, piece = 1 << 20, entropy_decode.CHASE_PIECE
    rng = np.random.default_rng(20 if kind == "chain" else 21)
    P = (rng.integers(0, 8, (n, 25)) * 32 + rng.integers(0, 25, (n, 25))).astype(np.int32)
    reset = np.zeros(n, bool)
    reset[0] = True
    if kind == "resets":
        reset[rng.random(n) < 1 / 500] = True
        edges = np.arange(piece, n, piece)
        reset[edges[::3]] = True
        reset[edges[1::7] - 1] = True
        reset[edges[2::11] + 1] = True
    starts = np.flatnonzero(reset).astype(np.int32)
    return (torch.from_numpy(P).to(dev), torch.from_numpy(reset).to(dev),
            torch.from_numpy(starts).to(dev), 1 << 21)


def chase_routes(P, reset, starts, cells):
    """decode_chase's outputs on each of its two routes, the walk and the
    pieces (`entropy_decode.chase_walks` forced each way): [(route, e32,
    c32)]."""
    from cvxcompress_tpu_torch.ops import entropy_decode

    picks = entropy_decode.chase_walks
    out = []
    try:
        for route, walk in (("walk", True), ("pieces", False)):
            entropy_decode.chase_walks = lambda *_, w=walk: w
            out.append((route, *entropy_decode.chase(P, reset, starts, cells)))
    finally:
        entropy_decode.chase_walks = picks
    return out


def ramp(vol, b):
    """`vol` with its b^3 blocks scaled by 10^-(block index mod 5) (block RMS
    10^4 apart) and the guard cases in three blocks: all-zero (rms 0), ~1e-38
    (1/(rms * scale) overflows) and one NaN (rms NaN); each gets mulfac 1.0
    (the NaN spreads through its block as the cascade or the einsums carry
    it)."""
    nz, ny, nx = vol.shape
    nb = (-(-nz // b), -(-ny // b), -(-nx // b))
    k = np.arange(np.prod(nb)) % 5
    f = np.kron((10.0 ** -k).astype(np.float32).reshape(nb), np.ones((b, b, b), np.float32))
    v = vol * f[:nz, :ny, :nx]
    v[:b, :b, b:2 * b] = 0.0
    v[:b, :b, 2 * b:3 * b] = np.float32(1e-38)
    v[:b, b:2 * b, :b] = 0.5
    v[b // 2, b + b // 2, b // 2] = np.nan
    return v


def wall_ms(fn, runs):
    """Median host-clock time of fn() (which synchronises) over `runs`."""
    times = []
    for _ in range(runs):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times), times


def profiled(run_compress, run_decompress, tag, card, tries=4):
    """One profiled compress + decompress (`run_decompress` synchronises):
    host spans (ms), device busy and idle share of the window, span
    `cvx.window`; the trace goes to build/.

    CUPTI may lose the device records of a profiling session's first
    activities: the trace then holds the runtime call (cudaMemcpyAsync,
    cudaLaunchKernel) with its correlation id but no copy or kernel with
    that id.  So each session first makes a few small launches, and the
    window counts only when every launch, copy and set issued in it has its
    device record; else it is profiled again, `tries` times at most, and the
    idle share is None: not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"chip_smoke_trace_{tag.replace(' ', '_')}.json")
    issue = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            warm = torch.zeros(1, device="cuda")
            for _ in range(8):
                warm.add_(1.0)
            torch.cuda.synchronize()
            with record_function("cvx.window"):
                run_compress()
                run_decompress()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        win = next(e for e in events
                   if e.get("cat") == "user_annotation" and e.get("name") == "cvx.window")
        t0, t1 = win["ts"], win["ts"] + win["dur"]
        calls = {e["args"]["correlation"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and t0 <= e["ts"] <= t1 and e["name"].startswith(issue)}
        device = [e for e in events
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                  and e["args"].get("correlation") in calls]
        lost = len(calls) - len({e["args"]["correlation"] for e in device})
        if not lost:
            break
        print(f"  config {tag}: try {attempt}: the trace lacks the device records of "
              f"{lost} of the window's {len(calls)} launches, copies and sets")
    cpu_t = torch.autograd.DeviceType.CPU
    spans = {ev.key: round(ev.cpu_time_total / 1e3, 3) for ev in prof.key_averages()
             if ev.key.startswith("cvx.") and ev.key != "cvx.window"
             and ev.device_type == cpu_t}
    # device busy = union of the window's kernels', copies' and sets' intervals
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in device):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    window_us = t1 - t0
    idle = None if lost else 1.0 - busy_us / window_us
    dev_ms = {}
    for e in device:
        dev_ms[e["name"]] = dev_ms.get(e["name"], 0.0) + e["dur"] / 1e3
    print(f"  config {tag}: device ms by kernel or copy: " + ", ".join(
        f"{k[:48]} {ms:.3f}" for k, ms in sorted(dev_ms.items(), key=lambda kv: -kv[1])[:12]))
    print(f"  config {tag}: profiled window {window_us / 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms, idle share "
          f"{'not measured (records lost)' if idle is None else f'{idle:.4f}'} on {card}")
    print(f"  config {tag}: host spans (ms): {spans}")
    return spans, idle


def card_sinusoid(torch, dev, shape, phase, local=False):
    """sin(z*pi*PERIODS/nz + phase) broadcast over (y, x), born on the card;
    `local` scales its lower half by 1e-3 (block RMS far apart)."""
    nz = shape[0]
    z = torch.arange(nz, dtype=torch.float32, device=dev) * np.float32(np.pi * PERIODS / nz)
    v = torch.sin(z + np.float32(phase))[:, None, None].expand(shape).contiguous()
    if local:
        v[: nz // 2] *= 1e-3
    return v


def phase_3g(torch, cvt, codec, pipeline, kernels, dev, card):
    """The batched codecs, the streams and the snapshot stack at full width
    (A's shape at 32^3, B's at 128^3), on volumes born on the card: every
    container byte-equal to a single compress, every volume bit-equal to a
    single device-engine decompress; the times a volume of a batch against
    single calls (host clock, medians of 3), of an append and a get; the
    launches of each kernel on each path."""
    from cvxcompress_tpu_torch import DeviceSnapshotStack

    res = {"card": card}

    def counted(tag, fn, expect):
        kernels.reset_counts()
        out = fn()
        torch.cuda.synchronize()
        cnt = {k: v for k, v in kernels.launches.items() if v}
        print(f"  3g launches, {tag}: {cnt}")
        check(all(cnt.get(k, 0) == n for k, n in expect.items()),
              f"3g {tag}: launches {expect}")
        res.setdefault("launches", {})[tag] = cnt
        return out

    def per_volume_ms(tag, fn, k):
        med, times = wall_ms(lambda: (fn(), torch.cuda.synchronize()), 3)
        res.setdefault("ms_per_volume", {})[tag] = med / k
        print(f"  3g {tag}: {med / k:.3f} ms a volume (median of 3 runs of {k}: "
              f"{[round(x, 2) for x in times]} ms) on {card}")

    def equal_vols(a, b):
        return all(bits_same(x, y) for x, y in zip(a, b)) and len(a) == len(b)

    dec_kernels = dict(decode_maps=1, decode_chase=1, decode_emit=1)
    A = [card_sinusoid(torch, dev, SHAPE, 0.7 * j) for j in range(8)]
    AL = [card_sinusoid(torch, dev, SHAPE, 0.3 + 0.7 * j, local=True) for j in range(2)]
    B = [card_sinusoid(torch, dev, SHAPE_B, 0.5 * j) for j in range(2)]
    groups = (("A", A[:4], BLOCK_A, False, dict(fused_encode=4, block_emit=4),
               dict(fused_inverse=4)),
              ("A-local", AL, BLOCK_A, True, dict(fused_encode_local=2, block_emit=2),
               dict(fused_inverse=2)),
              ("B", B, BLOCK_B, False,
               dict(block_fwd_z=2, block_encode_xy=2, block_emit=2),
               dict(block_inv_xy=2, block_inv_z=2)))
    singles = {}
    for tag, vols, block, local, enc, inv in groups:
        ds = [cvt.compress(v, SCALE, block=block, use_local_rms=local)[0] for v in vols]
        singles[tag] = ds
        got = counted(f"compress_many {tag} x{len(vols)}",
                      lambda: codec.compress_many(vols, SCALE, block, local), enc)
        check(all(np.array_equal(d, g) for d, (g, _) in zip(ds, got)),
              f"3g compress_many {tag} x{len(vols)}: every container byte-equal to "
              "a single compress")
        refs = [cvt.decompress(d, engine="device") for d in ds]
        k = len(ds)
        outs = counted(f"decompress_many {tag} x{k}",
                       lambda: codec.decompress_many(ds, "cuda", to_host=False),
                       {**{n: k * c for n, c in dec_kernels.items()}, **inv})
        check(equal_vols(outs, refs), f"3g decompress_many {tag} x{k}: every volume "
              "bit-equal to a single device-engine decompress")
        del outs, refs
    sa = singles["A"]
    per_volume_ms("compress A single", lambda: [cvt.compress(v, SCALE) for v in A[:4]], 4)
    per_volume_ms("compress_many A x4", lambda: codec.compress_many(A[:4], SCALE), 4)
    per_volume_ms("decompress A single (device engine)",
                  lambda: [cvt.decompress(d, engine="device") for d in sa], 4)
    per_volume_ms("decompress_many A x4 (on the card)",
                  lambda: codec.decompress_many(sa, "cuda", to_host=False), 4)
    per_volume_ms("decompress A single + .cpu()",
                  lambda: [cvt.decompress(d, engine="device").cpu() for d in sa], 4)
    per_volume_ms("decompress_many A x4 to host",
                  lambda: codec.decompress_many(sa, "cuda", to_host=True), 4)

    # the streams over 8 A volumes: order kept, containers and volumes equal
    ds8 = sa + [cvt.compress(v, SCALE)[0] for v in A[4:]]
    refs8 = [cvt.decompress(d, engine="device") for d in ds8]
    torch.cuda.synchronize()
    for tag, fn in (
            ("compress_stream workers=4",
             lambda: list(pipeline.compress_stream(iter(A), SCALE, workers=4))),
            ("compress_stream_batched batch=4 lookahead=1",
             lambda: list(pipeline.compress_stream_batched(iter(A), SCALE, batch=4,
                                                           lookahead=1)))):
        got = counted(tag + " x8", fn, dict(fused_encode=8, block_emit=8))
        check(len(got) == 8 and all(np.array_equal(d, g) for d, (g, _) in zip(ds8, got)),
              f"3g {tag} x8: containers in order, byte-equal to single compresses")
        per_volume_ms(tag, fn, 8)
    per_volume_ms("compress A single x8", lambda: [cvt.compress(v, SCALE) for v in A], 8)
    for tag, fn in (
            ("decompress_stream workers=4",
             lambda: list(pipeline.decompress_stream(iter(ds8), workers=4,
                                                     engine="device"))),
            ("decompress_stream_batched batch=4 lookahead=1 (on the card)",
             lambda: list(pipeline.decompress_stream_batched(
                 iter(ds8), batch=4, lookahead=1, to_host=False)))):
        outs = counted(tag + " x8", fn, {**{n: 8 for n in dec_kernels}, "fused_inverse": 8})
        check(equal_vols(outs, refs8), f"3g {tag} x8: volumes in order, bit-equal to "
              "single device-engine decompresses")
        del outs
        per_volume_ms(tag, fn, 8)
    outs = list(pipeline.decompress_stream_batched(iter(ds8), batch=4, lookahead=1))
    check(equal_vols([torch.from_numpy(o).to(dev) for o in outs], refs8),
          "3g decompress_stream_batched to host x8: numpy volumes bit-equal")
    del outs
    per_volume_ms("decompress_stream_batched batch=4 lookahead=1 to host",
                  lambda: list(pipeline.decompress_stream_batched(iter(ds8), batch=4,
                                                                  lookahead=1)), 8)
    per_volume_ms("decompress A single x8 (device engine)",
                  lambda: [cvt.decompress(d, engine="device") for d in ds8], 8)
    # a probe of the worker threads' cost: the interpreter's switch interval
    # (5 ms by default) bounds how soon a thread that left the GIL for a
    # short call gets it back while another runs Python
    interval = sys.getswitchinterval()
    try:
        sys.setswitchinterval(1e-4)
        per_volume_ms("compress_stream workers=4, switch interval 0.1 ms (probe)",
                      lambda: list(pipeline.compress_stream(iter(A), SCALE, workers=4)),
                      8)
        per_volume_ms("decompress_stream workers=4, switch interval 0.1 ms (probe)",
                      lambda: list(pipeline.decompress_stream(iter(ds8), workers=4,
                                                              engine="device")), 8)
    finally:
        sys.setswitchinterval(interval)

    # the snapshot stack at A, 32^3: 8 volumes born on the card
    st = DeviceSnapshotStack(SHAPE, SCALE)
    app, get = [], []
    kernels.reset_counts()
    for v in A:
        t = time.perf_counter()
        st.append(v)
        torch.cuda.synchronize()
        app.append((time.perf_counter() - t) * 1e3)
    st.flush()
    res.setdefault("launches", {})["stack append x8"] = {
        k: n for k, n in kernels.launches.items() if n}
    check(kernels.launches["fused_encode"] == 8, "3g stack: 8 appends, 8 fused_encode")
    kernels.reset_counts()
    gets = []
    for i in range(8):
        t = time.perf_counter()
        gets.append(st.get(i))
        torch.cuda.synchronize()
        get.append((time.perf_counter() - t) * 1e3)
    res["launches"]["stack get x8"] = {k: n for k, n in kernels.launches.items() if n}
    check(kernels.launches["fused_inverse"] == 8, "3g stack: 8 gets, 8 fused_inverse")
    res["append_ms"], res["get_ms"] = statistics.median(app), statistics.median(get)
    print(f"  3g stack A: append median {res['append_ms']:.3f} ms "
          f"{[round(x, 2) for x in app]}, get median {res['get_ms']:.3f} ms "
          f"{[round(x, 2) for x in get]} on {card}")
    res["nbytes"], res["ratio"] = st.nbytes(), st.ratio()
    print(f"  3g stack A: {len(st)} snapshots hold {res['nbytes']} B on the card, "
          f"ratio {res['ratio']:.1f} on {card}")
    for i in (0, 3, 7):  # through the host: native's encoder on 47 M cells each
        c = st.to_container(i)
        check(np.array_equal(c, ds8[i]), f"3g stack: to_container({i}) byte-equal to "
              "the single compress of its volume")
        check(bits_same(gets[i], cvt.decompress(c, engine="device")),
              f"3g stack: get({i}) bit-equal to decompress(to_container({i}), "
              "engine='device')")
    j = st.from_container(ds8[5])
    check(bits_same(st.get(j), refs8[5]), "3g stack: from_container of a port container, "
          "get bit-equal to its device-engine decompress")
    check(bits_same(st.pop(), gets[5]) and len(st) == 8,
          "3g stack: popped the from_container snapshot")
    spike = torch.zeros(SHAPE, device=dev)
    spike[0, 0, 0] = 1.0
    st2 = DeviceSnapshotStack(SHAPE, SCALE, max_pending=1)
    st2.append(spike)
    st2.append(A[0])
    st2.flush()
    check(st2._snaps[1][3] > st2._snaps[0][0].shape[0]
          and st2._snaps[1][0].shape[0] >= st2._snaps[1][3]
          and bits_same(st2.get(1), gets[0]),
          f"3g stack: forced capacity overflow ({st2._snaps[1][3]} live chunks over "
          f"a capacity of {st2._snaps[0][0].shape[0]}) compacted again, get "
          "bit-equal")
    del st2
    pops = []
    for i in reversed(range(8)):
        t = time.perf_counter()
        p = st.pop()
        torch.cuda.synchronize()
        pops.append((time.perf_counter() - t) * 1e3)
        check(bits_same(p, gets[i]), f"3g stack: pop {i} equals get({i})")
    res["pop_ms"] = statistics.median(pops)
    del gets, refs8

    # a 128^3 stack at B, 2 snapshots
    sb = DeviceSnapshotStack(SHAPE_B, SCALE, BLOCK_B)
    kernels.reset_counts()
    for v in B:
        sb.append(v)
    torch.cuda.synchronize()
    check(kernels.launches["block_encode_xy"] == 2, "3g stack B: 2 appends, "
          "2 block_encode_xy")
    for i in range(2):
        c = sb.to_container(i)
        check(np.array_equal(c, singles["B"][i]), f"3g stack B: to_container({i}) "
              "byte-equal to the single compress")
        check(bits_same(sb.get(i), cvt.decompress(c, engine="device")),
              f"3g stack B: get({i}) bit-equal to its device-engine decompress")
    res["B_nbytes"], res["B_ratio"] = sb.nbytes(), sb.ratio()
    print(f"  3g stack B: 2 snapshots hold {res['B_nbytes']} B, ratio "
          f"{res['B_ratio']:.1f} on {card}")
    return res


SHAPE_U128 = (320, 384, 384)  # unaligned 128^3: the stripe route, slabs 1-2 aligned
MH_TIMEOUT = 300  # seconds a multihost worker may take

MH_WORKER = r"""
import json, sys, time
sys.path.insert(0, {root!r})
import torch
import torch.distributed as dist
dist.init_process_group("gloo", init_method={addr!r}, world_size=2, rank={rank})
import chip_smoke as cs
from cvxcompress_tpu_torch.ops import _kernels
from cvxcompress_tpu_torch.parallel import multihost, sharded
vol = cs.sinusoid(*cs.SHAPE, cs.PERIODS)
z0, z1 = sharded.plan_shards(cs.SHAPE, cs.BLOCK_A, 2)[{rank}]
slab = vol[z0:z1]  # this process's half of A
out = {{}}
for mode in ("allgather", "allgather", "files"):  # the first: warm-up
    dist.barrier()
    _kernels.reset_counts()
    t = time.perf_counter()
    r = multihost.compress(slab, cs.SCALE, cs.BLOCK_A, vol_shape=cs.SHAPE, gather=mode,
                           file_prefix={prefix!r} + ".part", device="cuda:0")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    launches = {{k: v for k, v in _kernels.launches.items() if v}}
    if mode == "files":
        dist.barrier()
        if {rank} == 0:
            r = multihost.merge_segment_files(
                [{prefix!r} + ".part.seg0", {prefix!r} + ".part.seg1"], cs.SHAPE,
                cs.BLOCK_A)
        ms_merged = (time.perf_counter() - t) * 1e3
    else:
        ms_merged = ms
    if {rank} == 0:
        r.tofile({prefix!r} + "." + mode)
    else:
        assert r is None or mode == "files"
    out[mode] = dict(ms=ms, ms_merged=ms_merged, launches=launches)
print("MH " + json.dumps(out), flush=True)
dist.destroy_process_group()
"""


def differing_blocks(a, b):
    """Blocks whose payload (or raw flag) differs between two containers of
    one geometry."""
    from cvxcompress_tpu_torch.parallel import sharded

    _, pa, ra, sa, ba = sharded.block_sizes(a)
    _, pb, rb, sb, bb = sharded.block_sizes(b)
    return sum(1 for i in range(sa.size) if ra[i] != rb[i] or sa[i] != sb[i]
               or not np.array_equal(a[ba + pa[i]:ba + pa[i] + sa[i]],
                                     b[bb + pb[i]:bb + pb[i] + sb[i]]))


def multihost_pair(card):
    """Two processes on cuda:0 over gloo, each compressing its half of A in
    both gather modes; returns (containers by mode, their reports, wall s)."""
    import socket

    root = os.path.dirname(os.path.abspath(__file__))
    prefix = os.path.join(root, "build", "chip_smoke_mh")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        addr = f"tcp://127.0.0.1:{so.getsockname()[1]}"
    t = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", MH_WORKER.format(root=root, addr=addr, rank=r,
                                                prefix=prefix)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=MH_TIMEOUT)[0])
    finally:
        for p in procs:  # no worker outlives the phase
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t
    for r, (p, lg) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"3h multihost rank {r} exited 0"
              + ("" if p.returncode == 0 else f" (log tail: {lg[-2000:]!r})"))
    reps = [json.loads(next(x for x in lg.splitlines() if x.startswith("MH "))[3:])
            for lg in logs]
    datas = {m: np.fromfile(f"{prefix}.{m}", dtype=np.uint8) for m in ("allgather", "files")}
    return datas, reps, wall


def phase_3h(torch, cvt, codec, kernels, dev, card):
    """The multi-device layer at full width: `parallel.compress` and
    `decompress` over four shards on cuda:0 and over the default mesh, at A,
    A-local, B (one empty shard) and the unaligned 128^3 volume, from numpy
    and from the card, against the single codec; the launches per sharded
    call; two processes on cuda:0 (`parallel.multihost`, gloo) in both
    gather modes; `module_tests --quick` and the integration test at k = 1
    on the card; the times of the sharded calls at A against single calls
    (host clock, medians of turns)."""
    from cvxcompress_tpu_torch import module_tests
    from cvxcompress_tpu_torch.parallel import compress as pc
    from cvxcompress_tpu_torch.parallel import mesh as ml
    from cvxcompress_tpu_torch.parallel import sharded

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import integration_test_torch

    res = {"card": card, "launches": {}, "differing_blocks": {}, "mulfac_flips": {}}
    m4 = ml.make_mesh(["cuda:0"] * 4)
    mdef = ml.make_mesh()
    check(mdef == tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count())),
          f"3h make_mesh(): every visible card, {mdef}")

    def counted(tag, fn, expect):
        kernels.reset_counts()
        out = fn()
        torch.cuda.synchronize()
        cnt = {k: v for k, v in kernels.launches.items() if v}
        print(f"  3h launches, {tag}: {cnt}")
        check(all(cnt.get(k, 0) == n for k, n in expect.items()), f"3h {tag}: launches "
              f"{expect}")
        res["launches"][tag] = cnt
        return out

    def level3(tag, got, ref, v):
        """Level 3 of ROADMAP.md: the size within max(64 B, 1 %), the sharded
        container's round trip no worse than the single one's."""
        nd = differing_blocks(got, ref)
        res["differing_blocks"][tag] = nd
        print(f"  3h {tag}: {nd} of {sharded.block_sizes(ref)[3].size} blocks differ "
              f"from the single compress ({got.size} B against {ref.size} B)")
        check(abs(got.size - ref.size) <= max(64, 0.01 * ref.size),
              f"3h {tag}: size within max(64 B, 1 %) of the single compress's")
        eg = err_snr(v, codec.decompress(got, engine="device").cpu().numpy())[0]
        er = err_snr(v, codec.decompress(ref, engine="device").cpu().numpy())[0]
        check(eg <= er * 1.01 + 1e-7, f"3h {tag}: round-trip err {eg:.4e} within 1 % "
              f"of the single container's {er:.4e}")

    configs = (
        ("A", sinusoid(*SHAPE, PERIODS), BLOCK_A, False,
         ("fused_encode", "block_emit"), ("fused_inverse",)),
        ("A-local", None, BLOCK_A, True, ("fused_encode_local", "block_emit"),
         ("fused_inverse",)),
        ("B", sinusoid(*SHAPE_B, PERIODS), BLOCK_B, False,
         ("block_fwd_z", "block_encode_xy", "block_emit"), ("block_inv_xy", "block_inv_z")),
        ("U128", sinusoid(*SHAPE_U128, PERIODS), BLOCK_B, False,
         ("plane_cascade_fwd", "tokenize_stripe", "block_emit"), ("plane_cascade_inv",)),
    )
    vol_a = configs[0][1]
    singles = {}
    for tag, v, block, local, enc, inv in configs:
        v = vol_a if v is None else v
        vt = torch.from_numpy(v).to(dev)
        n_enc, n_def = (sum(z1 > z0 for z0, z1 in sharded.plan_shards(v.shape, block, k))
                        for k in (4, len(mdef)))
        single = codec.compress(v, SCALE, block, local)[0]
        single_t = codec.compress(vt, SCALE, block, local)[0]
        singles[tag] = single
        for src, vin, ref in (("numpy", v, single), ("card", vt, single_t)):
            for mtag, mesh, n in (("4 shards on cuda:0", m4, n_enc),
                                  ("default mesh", mdef, n_def)):
                ctag = f"{tag} compress from {src}, {mtag}"
                got = counted(ctag, lambda: pc.compress(vin, SCALE, block, local,
                                                        mesh=mesh)[0],
                              {k: n for k in enc})
                flip = (ctn_mulfac(cvt, got) != ctn_mulfac(cvt, ref))
                if flip:  # the f64 partial sums' order moved the f32 mulfac
                    res["mulfac_flips"][ctag] = [float(ctn_mulfac(cvt, got)),
                                                 float(ctn_mulfac(cvt, ref))]
                    print(f"  3h {ctag}: the header mulfac flipped, "
                          f"{res['mulfac_flips'][ctag]}: held at level 3")
                if not flip:  # every route runs native's cascade, slabs too
                    check(np.array_equal(got, ref), f"3h {ctag}: container byte-equal "
                          f"to codec.compress ({n} shards)")
                elif np.array_equal(got, ref):
                    res["differing_blocks"][ctag] = 0
                    print(f"  ok: 3h {ctag}: container byte-equal to codec.compress")
                else:
                    level3(ctag, got, ref, v)
        del vt
        ref_vol = codec.decompress(single, engine="device")
        n_dec = len(pc.decode_ranges(single, 4))
        check(tag != "A" or (n_enc == 4 and n_dec == 4), "3h A: 4 shards, 4 slabs")
        check(tag != "B" or (n_enc == 3 and n_dec == 3), "3h B: 3 shards (one of 4 "
              "empty), 3 slabs")
        for mtag, mesh, n in (("4 shards on cuda:0", m4, n_dec),
                              ("default mesh", mdef, len(pc.decode_ranges(single, len(mdef))))):
            dtag = f"{tag} decompress, {mtag}"
            out = counted(dtag, lambda: pc.decompress(single, mesh=mesh),
                          {k: n for k in DECODE_KERNELS + inv})
            check(out.shape == ref_vol.shape and out.device == torch.device(mesh[0]),
                  f"3h {dtag}: shape {tuple(out.shape)} on {mesh[0]}")
            check(bits_same(out, ref_vol), f"3h {dtag}: bit-equal to "
                  "codec.decompress (device engine)")
            del out
        del ref_vol

    # two processes on cuda:0 over gloo, each with half of A
    datas, reps, wall = multihost_pair(card)
    for mode, d in datas.items():
        check(np.array_equal(d, singles["A"]), f"3h multihost {mode}: two processes' "
              "container byte-equal to codec.compress of A")
    for r, rep in enumerate(reps):
        for mode in ("allgather", "files"):
            check(rep[mode]["launches"].get("fused_encode") == 1
                  and rep[mode]["launches"].get("block_emit") == 1,
                  f"3h multihost rank {r} {mode}: its half on fused_encode and "
                  "block_emit, once each")
    res["multihost"] = dict(wall_s=wall, ranks=reps)
    print(f"  3h multihost: two processes {wall:.1f} s wall (start, CUDA, warm-up); "
          f"compress {[round(rep['allgather']['ms'], 2) for rep in reps]} ms "
          f"(allgather), {[round(rep['files']['ms_merged'], 2) for rep in reps]} ms "
          f"(files, merged) on {card}")

    # the staged module tests and the integration test on the card
    t = time.perf_counter()
    failed = module_tests.run("cuda", quick=True)
    check(not failed, f"3h module_tests --quick on the card ({failed or 'all passed'}, "
          f"{time.perf_counter() - t:.1f} s)")
    it = integration_test_torch.run(ks=(1,), device="cuda")[0]
    check(it["ok"], f"3h integration test k = 1 on the card: err {it['err']:.4e}, "
          f"SNR {it['snr_db']:.2f} dB, ratio {it['ratio']:.1f}")
    res["integration_k1"] = it

    # the times at A: single calls against one and four shards, in turns
    vt = torch.from_numpy(vol_a).to(dev)
    data = singles["A"]
    variants = {
        "compress from numpy, single": lambda: codec.compress(vol_a, SCALE),
        "compress from numpy, 4 shards": lambda: pc.compress(vol_a, SCALE, mesh=m4),
        "compress on the card, single": lambda: codec.compress(vt, SCALE),
        "compress on the card, 1 shard": lambda: pc.compress(vt, SCALE, mesh=["cuda:0"]),
        "compress on the card, 4 shards": lambda: pc.compress(vt, SCALE, mesh=m4),
        "decompress, single (device engine)":
            lambda: codec.decompress(data, engine="device"),
        "decompress, 1 shard": lambda: pc.decompress(data, mesh=["cuda:0"]),
        "decompress, 4 shards": lambda: pc.decompress(data, mesh=m4),
    }
    times = {k: [] for k in variants}
    for _ in range(5):
        for k, fn in variants.items():
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t) * 1e3)
    res["ms"] = {k: statistics.median(v) for k, v in times.items()}
    for k, v in times.items():
        print(f"  3h A {k}: {res['ms'][k]:.3f} ms (median of 5 in turns: "
              f"{[round(x, 2) for x in v]}) on {card}")
    # where a sharded call's time goes: one profiled compress + decompress,
    # single and over four shards, the card's volume
    res["profile"] = {}
    for ptag, mesh in (("single", None), ("4 shards", m4)):
        comp = (lambda: codec.compress(vt, SCALE)) if mesh is None else (
            lambda: pc.compress(vt, SCALE, mesh=mesh))
        dec = (lambda: codec.decompress(data, engine="device")) if mesh is None else (
            lambda: pc.decompress(data, mesh=mesh))
        spans, idle = profiled(comp, lambda: (dec(), torch.cuda.synchronize()),
                               f"3h A {ptag}", card)
        res["profile"][ptag] = dict(spans_ms=spans, idle_share=idle)
    return res


def fault8_inputs():
    """The inputs where dense products spread a non-finite cell over its
    line, or overflow (ROADMAP.md fault 8): (name, volume, block)."""
    out = []
    for name, shape, block, cell, val in (
            ("NaN (8, 8, 8) 8^3", (8, 8, 8), (8, 8, 8), (0, 3, 4), np.nan),
            ("inf (8, 8, 8) 8^3", (8, 8, 8), (8, 8, 8), (0, 3, 4), np.inf),
            ("3e38 (8, 8, 8) 8^3", (8, 8, 8), (8, 8, 8), (4, 4, 4), 3e38),
            ("NaN (8, 8, 128) (128, 8, 8)", (8, 8, 128), (128, 8, 8), (0, 3, 4), np.nan)):
        z, y, x = np.meshgrid(*(np.arange(n) for n in shape), indexing="ij")
        v = (np.sin(0.7 * z) + np.cos(0.3 * y) * np.sin(0.11 * x)).astype(np.float32)
        v[cell] = np.float32(val)
        out.append((name, v, block))
    return out


def equal_but_nan_bits(a, b):
    """f32 arrays bit-equal but for the bits of a NaN (the card makes the
    canonical NaN where x86 keeps an operand's payload)."""
    nan = np.isnan(b)
    return bool(np.array_equal(np.isnan(a), nan)) and bool(np.array_equal(
        a[~nan].view(np.uint32), b[~nan].view(np.uint32)))


TOOLS_3I = (
    ("test_compression_torch", ["--nz", "51", "--ny", "101", "--nx", "151", "--block",
                                "8,8,8", "--iters", "3", "--out", "build/3i.cvx",
                                "--dump-error", "build/3i_err.bin", "--dump-slices",
                                "build/3i_slice"]),
    ("gen_empty_volume_torch", ["build/3i_empty.bin", "64", "64", "64"]),
    ("compress_seam_basin_torch", ["--results", "build/3i_seam.csv"]),
    ("profile_trace_torch", ["--logdir", "build/3i_trace"]),
    ("scaling_bench_torch", ["--sizes", "1,2,4", "--out", "build/3i_scaling.json"]),
    ("module_tests", ["--quick"]),
)
# runs a tool as __main__ and reports whether it imported jax
TOOL_RUNNER = """
import runpy, sys
sys.path.insert(0, {root!r})
sys.argv = [{path!r}, *{args!r}]
code = 0
try:
    if {path!r}.endswith(".py"):
        runpy.run_path({path!r}, run_name="__main__")
    else:
        runpy.run_module({path!r}, run_name="__main__", alter_sys=True)
except SystemExit as e:
    code = e.code or 0
print("JAX_IMPORTED", "jax" in sys.modules, flush=True)
sys.exit(code)
"""


def phase_3i(torch, cvt, kernels, dev, card, vol, res_h):
    """The stripe, patch and compact routes on native's cascade
    (csrc/plane_cascade.cu): `plane_cascade_fwd` into the plane and into the
    block batch, and `plane_cascade_inv` from the batch into the clipped
    volume (and on a batch, module tests [4]), bit-equal to their plain
    versions at A-8^3, A-64^3, A-256^3, S-(128, 8, 8), S-(8, 8, 1) and the
    unaligned 128^3 (a misaligned view at A-8^3 too), timed at A beside the
    plain versions, einsum3 and the relayouts they replace; the
    three routes' containers at A-8^3 and A-64^3 byte-equal to native's
    parity codec and their decompress bit-equal to native's parity
    decompress, fault 8's inputs the same but for NaN bits; phase 3h's
    stripe slabs with no differing block; the new tools and the module
    tests (stages [4] and [7] included) as subprocesses on the card.
    Returns (the kernels' report rows, results)."""
    import torch.nn.functional as F
    from cvxcompress_tpu_torch import container as ctn
    from cvxcompress_tpu_torch.ops import blocks, rle_host, wavelet

    res = {"card": card, "kernels": {}, "containers": {}, "tools": {}}
    rows = {}
    vol_s = sinusoid(*SHAPE_S, PERIODS)
    cases = (("A-8^3", vol, (8, 8, 8)), ("A-64^3", vol, (64, 64, 64)),
             ("A-256^3", vol, (256, 256, 256)), ("S-(128, 8, 8)", vol_s, (128, 8, 8)),
             ("S-(8, 8, 1)", vol_s, (8, 8, 1)),
             ("U128", sinusoid(*SHAPE_U128, PERIODS), (128, 128, 128)))
    for label, v, block in cases:
        vt = torch.from_numpy(v).to(dev)
        views = [("", vt)]
        if label == "A-8^3":
            flat = torch.zeros(v.size + 1, device=dev)
            views.append((" (a view at a 4-byte offset)", flat[1:].view(v.shape).copy_(vt)))
        for vtag, vin in views:
            for kern, plain_fn, lay in (
                    (wavelet.forward_3d_volume, wavelet.forward_3d_volume_plain, "plane"),
                    (wavelet.forward_blocks_of_volume, wavelet.forward_blocks_of_volume_plain,
                     "block batch")):
                out = kern(vin, block)
                plain = plain_fn(vin, block)
                torch.cuda.synchronize()
                nd = u32_differ(out, plain)
                check(nd == 0, f"3i {label}{vtag}: plane_cascade_fwd into the {lay} "
                      f"uint32-equal to {plain_fn.__name__} ({nd} of {out.numel()} cells "
                      "differ)")
                if lay == "plane":
                    got = out
                else:
                    cb = out
                del plain
        del views, out
        inv = wavelet.inverse_to_volume(cb, v.shape, block)
        inv_plain = wavelet.inverse_to_volume_plain(cb, v.shape, block)
        torch.cuda.synchronize()
        nd = u32_differ(inv, inv_plain)
        check(nd == 0, f"3i {label}: plane_cascade_inv into the volume uint32-equal to "
              f"inverse_to_volume_plain ({nd} of {inv.numel()} cells differ)")
        del inv, inv_plain
        inv = wavelet.inverse_blocks(cb)
        inv_plain = wavelet.cascade_3d(cb, inverse=True)
        torch.cuda.synchronize()
        nd = u32_differ(inv, inv_plain)
        check(nd == 0, f"3i {label}: plane_cascade_inv on the block batch uint32-equal to "
              f"cascade_3d ({nd} of {inv.numel()} cells differ)")
        del inv, inv_plain
        if label.startswith("A"):  # the main path's cells: timed
            cells = got.numel()
            flops = sum(cascade_flops(n) for n in block if n > 1) * cells
            flops_inv = sum(cascade_flops(n, True) for n in block if n > 1) * cells
            nzp, nyp, nxp = got.shape
            nz, ny, nx = v.shape
            padded = F.pad(vt, (0, nxp - nx, 0, nyp - ny, 0, nzp - nz))
            fwd = dict(
                max_abs_err=0.0,
                ms=cuda_ms(lambda: wavelet.forward_3d_volume(vt, block), 10),
                plain_ms=cuda_ms(lambda: wavelet.forward_3d_volume_plain(vt, block), 2),
                **bound(4 * v.size + 4 * cells, flops),
                library_ms=cuda_ms(lambda: einsum3(padded, got.shape, block, False), 10),
                library_call="einsum3: one three-operator torch.einsum (full f32) "
                             "over the zero-padded volume",
                blocks_ms=cuda_ms(lambda: wavelet.forward_blocks_of_volume(vt, block), 10),
                blocks_plain_ms=cuda_ms(
                    lambda: wavelet.forward_blocks_of_volume_plain(vt, block), 2),
                relayout_then_batch_ms=cuda_ms(
                    lambda: wavelet.forward_blocks(blocks.to_blocks(vt, block)), 10))
            # the inverse writes the clipped volume: the padded coefficients
            # in, the volume out
            inv = dict(
                max_abs_err=0.0,
                ms=cuda_ms(lambda: wavelet.inverse_to_volume(cb, v.shape, block), 10),
                plain_ms=cuda_ms(
                    lambda: wavelet.inverse_to_volume_plain(cb, v.shape, block), 2),
                **bound(4 * cells + 4 * v.size, flops_inv),
                library_ms=cuda_ms(lambda: einsum3(cb, got.shape, block, True), 10),
                library_call="einsum3 inverse: one three-operator torch.einsum "
                             "(full f32), block-major in, the padded volume out",
                batch_then_relayout_ms=cuda_ms(lambda: blocks.from_blocks(
                    wavelet.inverse_blocks(cb), v.shape, block), 10))
            del padded
            for k, r in (("plane_cascade_fwd", fwd), ("plane_cascade_inv", inv)):
                res["kernels"].setdefault(k, {})[label] = r
                print(f"  3i {label}: {k} kernel {r['ms']:.4f} ms, plain "
                      f"{r['plain_ms']:.3f} ms, einsum3 {r['library_ms']:.4f} ms, bound "
                      f"{r['bound_ms']:.4f} ms ({r['bound_by']}) on {card}")
            print(f"  3i {label}: plane_cascade_fwd into the block batch "
                  f"{fwd['blocks_ms']:.4f} ms (to_blocks, then the kernel on the batch: "
                  f"{fwd['relayout_then_batch_ms']:.4f}); plane_cascade_inv on the batch, "
                  f"then from_blocks: {inv['batch_then_relayout_ms']:.4f} ms on {card}")
        del vt, got, cb
        torch.cuda.empty_cache()
    # the report rows: A-64^3 (the cell whose drive their launches count),
    # the other A cells beside
    for k, by in res["kernels"].items():
        rows[k] = dict(by["A-64^3"])
        rows[k]["inputs"] = {lab: dict(ms=r["ms"], plain_ms=r["plain_ms"],
                                       bound_ms=r["bound_ms"], library_ms=r["library_ms"])
                             for lab, r in by.items()}
    # the kernels' registers, shared memory and spills as ptxas reported them
    res["ptxas"], on = [], False
    for line in kernels.build_info.get("log", "").splitlines():
        if line.startswith("== "):
            on = line[3:].strip() == "plane_cascade.cu"
        elif on and ("registers" in line or "spill" in line):
            res["ptxas"].append(line.strip())
    print(f"  3i plane_cascade.cu ptxas: {res['ptxas']}")

    # the three routes' containers against native's parity codec
    switches = ("CVX_FUSED_COMPACT", "CVX_STRIPE", "CVX_FUSED_W")

    def parity(tag, v, block, env):
        for k in switches:
            os.environ.pop(k, None)
        os.environ.update(env)
        try:
            kernels.reset_counts()
            d, _ = cvt.compress(v, SCALE, block=block)
            o = cvt.decompress(d).cpu().numpy()
            torch.cuda.synchronize()
            cnt = dict(kernels.launches)
        finally:
            for k in env:
                os.environ.pop(k)
        check(cnt["plane_cascade_fwd"] == 1 and cnt["plane_cascade_inv"] == 1,
              f"3i {tag}: plane_cascade_fwd and plane_cascade_inv launched once each")
        nd, _ = rle_host.host_compress_parity(v, SCALE, block=block)
        nv = rle_host.host_decompress_parity(nd)
        if np.array_equal(np.asarray(d), nd):
            print(f"  ok: 3i {tag}: container ({d.size} B) byte-equal to native "
                  "cvx_compress_parity_th's")
        else:  # a NaN's bits may differ: the card makes the canonical NaN
            hd, offs, mf, pb = ctn.unpack(d)
            _, noffs, nmf, npb = ctn.unpack(nd)
            cells = block[0] * block[1] * block[2]
            theirs = rle_host.decode_payloads(nd[npb:], noffs, hd.glob_mulfac, cells, nmf)
            check(bool(np.isnan(theirs).any()) and np.array_equal(
                np.asarray(d[:pb]), nd[:npb]) and equal_but_nan_bits(
                rle_host.decode_payloads(d[pb:], offs, hd.glob_mulfac, cells, mf), theirs),
                f"3i {tag}: header, offsets and every coefficient ({d.size} B) equal "
                "to native's parity container's but for the bits of its NaNs")
        n = int((o.view(np.uint32) != nv.view(np.uint32)).sum())
        check(n == 0 or (bool(np.isnan(nv).any()) and equal_but_nan_bits(o, nv)),
              f"3i {tag}: decompress bit-equal to native cvx_decompress_inplace_"
              f"parity_th's ({n} of {nv.size} cells differ{', all NaN' if n else ''})")
        res["containers"][tag] = dict(bytes=int(d.size), raw_blocks=int(
            (ctn.unpack(d)[1] < 0).sum()))

    for tag, block, env in (("A-8^3 stripe", (8, 8, 8), {}),
                            ("A-8^3 compact", (8, 8, 8), {"CVX_FUSED_COMPACT": "1"}),
                            ("A-64^3 stripe", (64, 64, 64), {}),
                            ("A-64^3 patch", (64, 64, 64), {"CVX_STRIPE": "patch"}),
                            ("A-64^3 compact", (64, 64, 64), {"CVX_FUSED_COMPACT": "1"})):
        parity(tag, vol, block, env)
    for tag, v, block in fault8_inputs():
        parity(f"fault 8, {tag}", v, block, {})

    # phase 3h's stripe route (the unaligned 128^3 slabs): no differing block
    # (a flipped header mulfac, held at level 3 there, left out)
    diff = {k: n for k, n in res_h["differing_blocks"].items()
            if n and k not in res_h["mulfac_flips"]}
    check(not diff, f"3i phase 3h's sharded stripe route: no differing block "
          f"({len(res_h['differing_blocks'])} comparisons, {diff or 'all 0'})")

    # the tools and the module tests as subprocesses on the card
    root = os.path.dirname(os.path.abspath(__file__))
    for f in ("build/3i_seam.csv",):
        if os.path.exists(os.path.join(root, f)):
            os.remove(os.path.join(root, f))
    for tool, args in TOOLS_3I:
        path = ("cvxcompress_tpu_torch.module_tests" if tool == "module_tests"
                else os.path.join(root, "tools", f"{tool}.py"))
        t = time.perf_counter()
        p = subprocess.run([sys.executable, "-c", TOOL_RUNNER.format(
            root=root, path=path, args=args)], cwd=root, capture_output=True, text=True,
            timeout=300)
        wall = time.perf_counter() - t
        out = p.stdout
        print(f"  3i {tool} {' '.join(args)}: exit {p.returncode}, {wall:.1f} s on {card}")
        for line in out.splitlines()[-12:]:
            print(f"    | {line}")
        check("JAX_IMPORTED False" in out, f"3i {tool}: imported no jax")
        if tool == "scaling_bench_torch":
            with open(os.path.join(root, "build/3i_scaling.json")) as fh:
                rep = json.load(fh)
            ok = rep["all_checks_and_projections_meet_target"]
            check(p.returncode == (0 if ok else 1) and all(
                e["matches_single_chip"] for c in rep["cases"].values()
                for e in c["mesh"].values()),
                f"3i {tool}: every mesh size matches the single call; exit "
                f"{p.returncode} follows its report ({ok})")
            res["tools"][tool] = dict(exit=p.returncode, wall_s=wall, report=rep)
            continue
        check(p.returncode == 0, f"3i {tool}: exit 0" + (
            "" if p.returncode == 0 else f" (stderr tail {p.stderr[-1500:]!r})"))
        res["tools"][tool] = dict(exit=p.returncode, wall_s=wall,
                                  stdout_tail=out.splitlines()[-12:])
        if tool == "module_tests":
            res["tools"][tool]["stdout"] = out
    with open(os.path.join(root, "build/3i_seam.csv")) as fh:
        seam = fh.read().splitlines()
    check(seam[0] == "scale,ratio,rel_error,snr_db,compress_mcs,decompress_mcs"
          and len(seam) == 6, "3i compress_seam_basin_torch: the JAX tool's header and "
          "5 rows")
    mt = res["tools"]["module_tests"]["stdout"]
    check(all(f"[OK]\033[0m {st}" in mt for st in ("[4] transform throughput",
                                                   "[7] block layout throughput")),
          "3i module_tests --quick: stages [4] and [7] ran and passed")
    return rows, res


def ctn_mulfac(cvt, data):
    return cvt.container.unpack(data)[0].glob_mulfac.view(np.uint32)


def main():
    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card, flush=True)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import cvxcompress_tpu_torch as cvt
    from cvxcompress_tpu_torch import pipeline
    from cvxcompress_tpu_torch.ops import (
        _kernels, blocks, codec, entropy_decode, fused_compress, fused_inverse,
        pack, quant, rle_device, rle_host, tokenize, wavelet,
    )
    from cvxbench.harness import generator

    check("jax" not in sys.modules, "the port imported no jax")
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")

    # -- phase 1: build ---------------------------------------------------
    print(f"  at {time.perf_counter() - t_start:.1f} s", flush=True)
    print("phase 1: build", flush=True)
    t = time.perf_counter()
    _kernels.lib()
    print(f"  kernels built in {_kernels.build_info['seconds']:.1f} s "
          f"({_kernels.build_info['path']})")
    for line in _kernels.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())
    rle_host.lib()
    print(f"  native library: {rle_host.SO_PATH} {rle_host.build_info or '(prebuilt)'}")
    print(f"  build phase {time.perf_counter() - t:.1f} s (native library included)")
    # the port runs no matmul (every transform is a cascade kernel); the
    # einsum3 yardstick sets full f32 itself (phase 3f holds a container made
    # under the caller's TF32)
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "the port's import left PyTorch's f32 matmul defaults (allow_tf32 False, "
          "precision 'highest')")

    # -- phase 2: each kernel against its plain version, CI shape ---------
    print(f"  at {time.perf_counter() - t_start:.1f} s", flush=True)
    print("phase 2: kernels vs plain versions at", SHAPE, flush=True)
    vol = sinusoid(*SHAPE, PERIODS)
    vt = torch.from_numpy(vol).to(dev)
    mulfac = quant.global_mulfac(vol, SCALE)
    report = {}

    # the 32^3 kernels bit-equal to their plain versions on A's sinusoid,
    # noise, the ramp and a volume with nx % 4 != 0 (the encode's 4-byte
    # copy route); the local-RMS encode in phase 2c
    vol_u = np.random.default_rng(1).standard_normal(SHAPE_U, dtype=np.float32)
    inputs32 = (("A", vol, SCALE), ("A noise", np.random.default_rng(2).standard_normal(
        SHAPE, dtype=np.float32), NOISE_SCALE), ("A ramp", ramp(vol, 32), SCALE),
        (f"unaligned {SHAPE_U} noise", vol_u, NOISE_SCALE))
    for label, v, sc in inputs32:
        block32(label, v, sc, local=False)
    ck, dk, cbk, sk, rk, mk = tokenize.fused_encode(vt, mulfac)
    cp, _, cbp, *_ = tokenize.fused_encode_plain(vt, mulfac)
    torch.cuda.synchronize()
    d2, s2, r2 = rle_device.tokenize(tokenize.scaled(ck, mulfac))
    check(torch.equal(sk, s2) and torch.equal(rk, r2) and torch.equal(dk, d2),
          "fused_encode descriptors, sizes and raw flags bit-equal to the plain "
          "tokenize of its coefficients")
    check(torch.equal(cbk, cbp), f"fused_encode chunk counts ({int((cbk > 0).sum())} "
          f"live of {cbk.numel()} chunks) bit-equal to fused_encode_plain's")
    cells = ck.numel()
    report["fused_encode"] = dict(
        max_abs_err=float((ck - cp).abs().max()),
        ms=cuda_ms(lambda: tokenize.fused_encode(vt, mulfac), 20),
        plain_ms=cuda_ms(lambda: tokenize.fused_encode_plain(vt, mulfac), 3),
        # volume in; coefficients, descriptors and chunk counts out; three
        # cascades and the scale per cell (the tokenize's integer work is
        # not counted)
        **bound(4 * vol.size + 8 * cells + 4 * cbk.numel() + 9 * sk.numel(),
                (3 * C32 + 1) * cells),
        library_ms=cuda_ms(lambda: einsum3(vt, SHAPE, BLOCK_A, False), 20),
        library_call="one three-operator torch.einsum (full f32): the transform, "
                     "no tokenize",
    )
    del cp, cbp, d2, s2, r2

    base = pack.chunk_bases(cbk)
    total = int(cbk.sum())
    stk = pack.emit_chunks(ck, mk, dk, cbk, base, total)
    stp = pack.emit_chunks_plain(ck, mk, dk, cbk, base, total)
    check(torch.equal(stk, stp), f"block_emit stream at 32^3 ({total} B) bit-equal to "
          "plain")
    streams, nsizes, nraw = rle_host.encode_payloads(ck.cpu().numpy(), mulfac)
    native = np.concatenate([s for s, r in zip(streams, nraw) if not r])
    check(np.array_equal(nraw, rk.cpu().numpy())
          and np.array_equal(nsizes, sk.cpu().numpy().astype(np.int64)),
          "native cvx_encode_payloads sizes/raw equal the kernel's")
    check(np.array_equal(native, stk.cpu().numpy()),
          "stream bit-equal to native cvx_encode_payloads, block by block")
    report["block_emit"] = dict(
        max_abs_err=float((stk.int() - stp.int()).abs().max()) if total else 0.0,
        ms=cuda_ms(lambda: pack.emit_chunks(ck, mk, dk, cbk, base, total), 20),
        plain_ms=cuda_ms(
            lambda: pack.emit_chunks_plain(ck, mk, dk, cbk, base, total), 3),
        **bound(emit_chunks_bytes(dk, cbk, total), 0),
        # the chunk bases: the exclusive cumsum the codec runs before the emit
        base_ms=cuda_ms(lambda: pack.chunk_bases(cbk), 20),
    )
    report["block_emit"]["inputs"] = {"A 32^3": {k: report["block_emit"][k] for k in (
        "ms", "plain_ms", "bound_ms", "base_ms")}}
    del ck, dk, cbk, mk, stk, stp

    data, _ = codec.compress(vt, SCALE)
    del vt

    # the device entropy decoder: each kernel against its plain version on
    # a container (the main path's shapes, timed for the report)
    def decode_stages(label, cont, iters, plain_iters, device=False):
        """Each decode kernel against its plain version on `cont`, on the
        blob `plan_layout` writes (`layout_stage`); returns the dense
        coefficients, the errors, {kernel: (ms, plain ms)} by CUDA events
        through the wrappers (with `device`, also each kernel's device time
        alone, the profiler's, and the emit's zeroing), the bounds and
        `layout_stage`'s times."""
        hdr, blkoffs, _, pbase = cvt.container.unpack(cont)
        p, b, layout = layout_stage(label, cont, iters, plain_iters, device)
        nsub, cells, nnn = b["sub_block"].numel(), p["cells"], hdr.grid[3]
        sf = b["scalefac"]
        stream, reset, starts, sblk = (b["stream"], b["sub_reset"], b["starts"],
                                       b["sub_block"])
        chain = np.diff(np.append(p["starts"], nsub)).max()
        print(f"  {label}: {len(cont)} B, {nsub} subsegments, "
              f"{starts.numel()} chains (longest {chain}), "
              f"{p['raw_ids'].size} raw blocks, cells {cells}", flush=True)
        Mk, Pk = entropy_decode.parse_maps(stream, nsub, cells)
        Mp, Pp = entropy_decode.parse_maps_plain(stream, nsub, cells)
        check(torch.equal(Mk, Mp) and torch.equal(Pk, Pp),
              f"{label}: decode_maps M and P bit-equal to the plain version")
        ek, ck = entropy_decode.chase(Pk, reset, starts, cells)
        ep, cp = entropy_decode.chase_plain(Pk, reset, cells)
        check(torch.equal(ek, ep) and torch.equal(ck, cp),
              f"{label}: decode_chase e32 and c32 bit-equal to the plain "
              "(Sklansky) version")
        routes = chase_routes(Pk, reset, starts, cells)
        check(all(torch.equal(e, ep) and torch.equal(c, cp) for _, e, c in routes),
              f"{label}: decode_chase's walk and piece routes bit-equal to the plain "
              "version (the wrapper's pick: "
              f"{'walk' if entropy_decode.chase_walks(nsub, starts.numel(), cells) else 'pieces'})")
        del routes
        dk = entropy_decode.emit(stream, Mk, ek, ck, sblk, sf, nnn, cells)
        dp = entropy_decode.emit_plain(stream, Mk, ek, ck, sblk, sf, nnn, cells)
        check(torch.equal(dk.view(torch.int32), dp.view(torch.int32)),
              f"{label}: decode_emit dense coefficients equal to the plain "
              "version as uint32")
        del dp
        entropy_decode.overlay_raw(dk, b["raw_rows"], b["raw_ids"])
        nat = rle_host.decode_payloads(cont[pbase:], blkoffs, hdr.glob_mulfac, cells,
                                       cvt.container.unpack(cont)[2])
        check(np.array_equal(dk.cpu().numpy().view(np.uint32), nat.view(np.uint32)),
              f"{label}: dense coefficients equal to native decode_payloads "
              "as uint32")
        errs = dict(
            decode_maps=float(max((Mk - Mp).abs().max(), (Pk - Pp).abs().max())),
            decode_chase=float(max((ek - ep).abs().max(), (ck - cp).abs().max())),
            decode_emit=float((dk - torch.from_numpy(nat).to(dev)).abs().max()),
        )
        del Mp, Pp, nat
        runs = dict(
            decode_maps=(lambda: entropy_decode.parse_maps(stream, nsub, cells),
                         lambda: entropy_decode.parse_maps_plain(stream, nsub, cells)),
            decode_chase=(lambda: entropy_decode.chase(Pk, reset, starts, cells),
                          lambda: entropy_decode.chase_plain(Pk, reset, cells)),
            decode_emit=(lambda: entropy_decode.emit(stream, Mk, ek, ck, sblk, sf, nnn,
                                                     cells),
                         lambda: entropy_decode.emit_plain(stream, Mk, ek, ck, sblk, sf,
                                                           nnn, cells)),
        )
        times = {k: (cuda_ms(run, iters), cuda_ms(plain, plain_iters))
                 for k, (run, plain) in runs.items()}
        if device:  # the chase: its walk, or its pieces and their memset
            names = dict(decode_maps="decode_maps",
                         decode_chase=("decode_walk", "decode_chase", "Memset"),
                         decode_emit="decode_emit")
            for k, (run, _) in runs.items():
                times[k] += (device_ms(run, iters, names[k]),)
            times["decode_emit"] += (
                device_ms(runs["decode_emit"][0], iters, ("FillFunctor", "Memset")),)
        # bytes: stream in, M (32 x 4 B) and P (25 x 4 B) per subsegment out;
        # P and the reset flags in, e32 and c32 out; stream, M, e32, c32,
        # sub_block and the scalefac table in, the dense buffer out (zeroed
        # and written once)
        bounds = dict(
            decode_maps=bound(nsub * (32 + 128 + 100), 0),
            decode_chase=bound(nsub * CHASE_BYTES, 0),
            decode_emit=bound(nsub * (32 + 128 + 12) + 4 * nnn * (cells + 1), 0),
        )
        for k, (ms, pms, *dms) in times.items():
            print(f"  {label}: {k} kernel {ms:.4f} ms"
                  + "".join(f", device {x:.4f}" for x in dms[:1])
                  + "".join(f" (zeroing {x:.4f})" for x in dms[1:])
                  + f", plain {pms:.3f} ms, bound {bounds[k]['bound_ms']:.4f} ms on {card}")
        return dk, errs, times, bounds, layout

    def layout_stage(label, cont, iters, plain_iters, device=False):
        """`plan_layout` on `cont` as the codec runs it (`device_plan`,
        `upload_plan`) into a blob of 0xAB bytes (every byte is written),
        against its plain version on the same upload and the host's
        `plan`, byte for byte; returns the plan, the blob's fields and the
        kernel's times (CUDA events; with `device` the profiler's), its
        plain version's, its bound (the payload and the head read once,
        the blob written once) and the host's plan both ways, wall clock to
        a synchronize: `plan` and `upload` against `device_plan`,
        `upload_plan` and `plan_layout`."""
        s = entropy_decode.device_plan(cont)
        check(s is not None, f"{label}: device_plan accepts the container")
        up, blob = entropy_decode.upload_plan(s, dev)
        b = entropy_decode.plan_layout(up, blob.fill_(0xAB), s)
        plain = entropy_decode.plan_layout_plain(up, torch.full_like(blob, 0xCD), s)
        check(torch.equal(blob, plain)
              and np.array_equal(blob.cpu().numpy(), entropy_decode.plan(cont)["blob"]),
              f"{label}: plan_layout's blob ({blob.numel()} B from {s['nrow']} rows) "
              "byte-equal to its plain version's and to the host plan's")
        del plain

        def run():
            entropy_decode.plan_layout(up, blob, s)

        def host_plan():
            entropy_decode.upload(entropy_decode.plan(cont), dev)
            torch.cuda.synchronize()

        def device_plan():
            q = entropy_decode.device_plan(cont)
            entropy_decode.plan_layout(*entropy_decode.upload_plan(q, dev), q)
            torch.cuda.synchronize()

        r = dict(ms=cuda_ms(run, iters),
                 plain_ms=cuda_ms(lambda: entropy_decode.plan_layout_plain(up, blob, s),
                                  plain_iters),
                 **bound(s["payload"].size + s["head"].size + s["size"], 0),
                 host_plan_ms=wall_ms(host_plan, 5)[0],
                 device_plan_ms=wall_ms(device_plan, 5)[0])
        if device:
            r["device_ms"] = device_ms(run, iters, "plan_layout")
        dev_s = f", device {r['device_ms']:.4f}" if device else ""
        print(f"  {label}: plan_layout kernel {r['ms']:.4f} ms{dev_s}"
              f", plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms; the plan "
              f"{r['host_plan_ms']:.2f} ms on the host (with its upload), "
              f"{r['device_plan_ms']:.2f} ms laid out on the card, on {card}", flush=True)
        return s, b, r

    dense, errs, times, bounds, layout = decode_stages("CI container", data, 20, 3,
                                                       device=True)
    noise = np.random.default_rng(0).standard_normal(SHAPE, dtype=np.float32)
    ndata, nratio = cvt.compress(noise, NOISE_SCALE)
    del noise
    print(f"  noise container: N(0,1) {SHAPE} at scale {NOISE_SCALE}, "
          f"ratio {nratio:.2f}")
    _, nerrs, ntimes, nbounds, nlayout = decode_stages("noise container", ndata, 5, 1,
                                                       device=True)
    del ndata
    torch.cuda.empty_cache()
    # plan_layout also at the benchmark's radial snapshots (cvxbench: snapshot 0 of
    # the rtm-radial mix, the configurations' shape, block and mode)
    radial = {}
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "cvxbench",
                           "traffic", "rtm-radial.json")) as fh:
        traffic = json.load(fh)
    for cname in ("ci-k2-b32", "ci-k2-b64", "ci-k2-b32-local"):
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "cvxbench",
                               "configs", f"{cname}.json")) as fh:
            cfg = json.load(fh)
        vr = generator.Generator(traffic, cfg["shape"], 20251019, dev).snapshot(0)
        rdata, _ = cvt.compress(vr, cfg["scale"], block=tuple(cfg["block"]),
                                use_local_rms=cfg["use_local_rms"])
        del vr
        torch.cuda.empty_cache()
        radial[f"{cname} rtm-radial"] = layout_stage(
            f"{cname} rtm-radial container", rdata, 20, 3, device=True)[2]
        del rdata
        torch.cuda.empty_cache()
    report["plan_layout"] = dict(
        max_abs_err=0.0,  # byte-equal, checked
        noise_ms=nlayout["ms"], noise_plain_ms=nlayout["plain_ms"],
        noise_device_ms=nlayout["device_ms"], noise_bound_ms=nlayout["bound_ms"],
        inputs=radial, **layout)
    for k in DECODE_KERNELS:
        report[k] = dict(max_abs_err=max(errs[k], nerrs[k]), ms=times[k][0],
                         plain_ms=times[k][1], device_ms=times[k][2],
                         noise_ms=ntimes[k][0], noise_plain_ms=ntimes[k][1],
                         noise_device_ms=ntimes[k][2],
                         noise_bound_ms=nbounds[k]["bound_ms"], **bounds[k])
    report["decode_emit"].update(zeroing_device_ms=times["decode_emit"][3],
                                 noise_zeroing_device_ms=ntimes["decode_emit"][3])

    # the chase's look-back at scale: one chain of 2^20 subsegments, and
    # 2^20 with resets at random places and on and beside its piece seams
    chase_inputs = {}
    for kind in ("chain", "resets"):
        P, reset, starts, cells = synthetic_chase(kind, dev)
        ek, ck = entropy_decode.chase(P, reset, starts, cells)
        ep, cp = entropy_decode.chase_plain(P, reset, cells)
        routes = chase_routes(P, reset, starts, cells)
        torch.cuda.synchronize()
        se, sc = entropy_decode.chase_sequential(P.cpu().numpy(), reset.cpu().numpy(),
                                                 cells)
        check(all(torch.equal(e, ep) and torch.equal(c, cp)
                  for e, c in [(ek, ck)] + [r[1:] for r in routes])
              and np.array_equal(ek.cpu().numpy(), se)
              and np.array_equal(ck.cpu().numpy(), sc),
              f"synthetic {kind} ({starts.numel()} chains, {int((ck == cells).sum())} "
              "counts saturated): decode_chase e32 and c32, the wrapper's pick and both "
              "routes, bit-equal to chase_plain and chase_sequential")
        del routes
        chase_inputs[f"synthetic {kind}"] = dict(
            ms=cuda_ms(lambda: entropy_decode.chase(P, reset, starts, cells), 20),
            plain_ms=cuda_ms(lambda: entropy_decode.chase_plain(P, reset, cells), 3),
            **bound(P.shape[0] * CHASE_BYTES, 0))
        r = chase_inputs[f"synthetic {kind}"]
        print(f"  synthetic {kind}: decode_chase kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms on {card}")
        del P, reset, starts, ek, ck, ep, cp
    report["decode_chase"]["inputs"] = chase_inputs

    # fused_inverse: the dense mode the device engine feeds it (reported),
    # and the chunk-sparse mode of the host engine
    rows = dense.view(-1, fused_inverse.CHUNK)
    vk = fused_inverse.fused_inverse(rows, None, SHAPE)
    vp = fused_inverse.fused_inverse_plain(rows, None, SHAPE)
    torch.cuda.synchronize()
    nd = u32_differ(vk, vp)
    check(nd == 0, f"fused_inverse (dense) on the CI container's coefficients uint32-equal "
          f"to its plain version ({nd} cells differ)")
    report["fused_inverse"] = dict(
        max_abs_err=float((vk - vp).abs().max()),
        ms=cuda_ms(lambda: fused_inverse.fused_inverse(rows, None, SHAPE), 20),
        plain_ms=cuda_ms(
            lambda: fused_inverse.fused_inverse_plain(rows, None, SHAPE), 3),
        **bound(4 * rows.numel() + 4 * vol.size, 3 * C32_INV * rows.numel()),
        library_ms=cuda_ms(lambda: einsum3(rows, SHAPE, BLOCK_A, True), 20),
        library_call="one three-operator torch.einsum (full f32)",
    )
    rows_h, invmap_h = codec.sparse_chunks(dense.cpu().numpy())
    srows, sinv = torch.from_numpy(rows_h).to(dev), torch.from_numpy(invmap_h).to(dev)
    vs = fused_inverse.fused_inverse(srows, sinv, SHAPE)
    nd = u32_differ(vs, vp)
    check(nd == 0, f"fused_inverse (chunk-sparse, {rows_h.shape[0]} of {invmap_h.size} "
          f"chunks) uint32-equal to the dense plain version ({nd} cells differ)")
    # the host engine's mode: the live chunks and the map in, the volume out
    report["fused_inverse"].update(
        chunk_sparse_ms=cuda_ms(lambda: fused_inverse.fused_inverse(srows, sinv, SHAPE), 20),
        chunk_sparse_bound_ms=bound(4 * srows.numel() + 4 * sinv.numel() + 4 * vol.size,
                                    3 * C32_INV * rows.numel())["bound_ms"])
    print(f"  fused_inverse chunk-sparse kernel {report['fused_inverse']['chunk_sparse_ms']:.4f}"
          f" ms, bound {report['fused_inverse']['chunk_sparse_bound_ms']:.4f} ms on {card}")
    del vk, vp, vs, dense, rows, srows, sinv
    torch.cuda.empty_cache()

    # -- phase 2b: the 128^3 kernels against their plain versions, config B
    print(f"  at {time.perf_counter() - t_start:.1f} s", flush=True)
    print("phase 2b: 128^3 kernels vs plain versions at", SHAPE_B, flush=True)

    def block_kernels(label, volb, scale, iters, plain_iters, native, time_decompress=False):
        """The five 128^3 launches against their plain versions on `volb`,
        and the decode kernels at cells = 2^21 on its container; returns
        the 128^3 kernels' report and the decode kernels' times."""
        vtb = torch.from_numpy(volb).to(dev)
        mf = quant.global_mulfac(volb, scale)
        out = {}
        tk = fused_compress.fwd_z(vtb)
        tp = fused_compress.fwd_z_plain(vtb)
        torch.cuda.synchronize()
        ncell, nnn = tk.numel(), tk.shape[0]
        hold(label, "block_fwd_z", tk, tp,
             dense_f64(blocks.to_blocks(vtb, BLOCK_B), (1,), False), nnn)
        out["block_fwd_z"] = dict(
            max_abs_err=float((tk - tp).abs().max()),
            ms=cuda_ms(lambda: fused_compress.fwd_z(vtb), iters),
            plain_ms=cuda_ms(lambda: fused_compress.fwd_z_plain(vtb), plain_iters),
            **bound(8 * ncell, C128 * ncell))
        # the library call: one three-operator einsum, the whole forward
        # transform of both launches (no tokenize)
        lib_fwd = cuda_ms(lambda: einsum3(vtb, volb.shape, BLOCK_B, False), iters)
        del tp
        buf = torch.empty_like(tk)
        ck, dk, cbk, sk, rk, mk = fused_compress.encode_xy(tk, mf, out=buf)
        cp = fused_compress.encode_xy_plain(tk, mf)[0]
        torch.cuda.synchronize()
        hold(label, "block_encode_xy coefficients", ck, cp,
             dense_f64(tk, (3, 2), False), nnn)
        err_xy = float((ck - cp).abs().max())
        del cp
        d2, cb2, s2, r2 = tokenize.tokenize_blocks_plain(ck, mf)
        check(torch.equal(dk, d2) and torch.equal(cbk, cb2) and torch.equal(sk, s2)
              and torch.equal(rk, r2), f"{label}: block_encode_xy desc, chunk_bytes, "
              "sizes and raw bit-equal to the plain tokenize of its coefficients")
        del d2, cb2, s2, r2
        nchunks = cbk.numel()
        out["block_encode_xy"] = dict(
            max_abs_err=err_xy,
            ms=cuda_ms(lambda: fused_compress.encode_xy(tk, mf, out=buf), iters),
            plain_ms=cuda_ms(lambda: fused_compress.encode_xy_plain(tk, mf),
                             plain_iters),
            # slice in; coefficients, descriptors and chunk counts out; two
            # cascades and the scale per cell
            **bound(12 * ncell + 4 * nchunks + 4 * sk.numel(), (2 * C128 + 1) * ncell))
        del tk, buf
        cb64 = cbk.to(torch.int64)
        cbase = torch.cumsum(cb64, 0) - cb64
        total = int(cb64.sum())
        stk = pack.emit_chunks(ck, mk, dk, cbk, cbase, total)
        stp = pack.emit_chunks_plain(ck, mk, dk, cbk, cbase, total)
        check(torch.equal(stk, stp), f"{label}: block_emit stream ({total} B, "
              f"{int(rk.sum())} raw blocks) bit-equal to the plain version")
        if native:
            streams, nsizes, nraw = rle_host.encode_payloads(ck.cpu().numpy(), mf)
            nat = np.concatenate([s for s, r in zip(streams, nraw) if not r])
            check(np.array_equal(nsizes, sk.cpu().numpy())
                  and np.array_equal(nat, stk.cpu().numpy()),
                  f"{label}: stream bit-equal to native cvx_encode_payloads on the "
                  "kernel's coefficients")
        out["block_emit"] = dict(
            max_abs_err=float((stk.int() - stp.int()).abs().max()) if total else 0.0,
            ms=cuda_ms(lambda: pack.emit_chunks(ck, mk, dk, cbk, cbase, total), iters),
            plain_ms=cuda_ms(
                lambda: pack.emit_chunks_plain(ck, mk, dk, cbk, cbase, total),
                plain_iters),
            **bound(emit_chunks_bytes(dk, cbk, total), 0))
        del ck, dk, cbk, mk, stk, stp, cbase
        bdata, bratio = codec.compress(vtb, scale, block=BLOCK_B)
        del vtb
        torch.cuda.empty_cache()
        print(f"  {label}: container {bdata.size} B, ratio {bratio:.1f}")
        bdense, berrs, btimes, bbounds, _ = decode_stages(
            f"{label} container", bdata, iters, plain_iters, device=time_decompress)
        if time_decompress:  # where the chase shows end to end
            dms, druns = wall_ms(lambda: (cvt.decompress(bdata, engine="device"),
                                          torch.cuda.synchronize()), 5)
            e2e[f"{label} decompress_ms"] = dms
            print(f"  {label}: device-engine decompress through the API {dms:.2f} ms "
                  f"(median; runs {', '.join(f'{x:.2f}' for x in druns)}) on {card}",
                  flush=True)
        rows = bdense.view(-1, fused_inverse.CHUNK)
        xk = fused_inverse.block_inv_xy(rows, volb.shape)
        xp = fused_inverse.block_inv_xy_plain(rows, volb.shape)
        torch.cuda.synchronize()
        hold(label, "block_inv_xy", blocks.to_blocks(xk, BLOCK_B),
             blocks.to_blocks(xp, BLOCK_B), dense_f64(rows, (3, 2), True), nnn)
        out["block_inv_xy"] = dict(
            max_abs_err=float((xk - xp).abs().max()),
            ms=cuda_ms(lambda: fused_inverse.block_inv_xy(rows, volb.shape), iters),
            plain_ms=cuda_ms(lambda: fused_inverse.block_inv_xy_plain(rows, volb.shape),
                             plain_iters),
            **bound(8 * ncell, 2 * C128_INV * ncell))
        lib_inv = cuda_ms(lambda: einsum3(rows, volb.shape, BLOCK_B, True), iters)
        del xp
        zp = fused_inverse.block_inv_z_plain(xk)
        zk = fused_inverse.block_inv_z(xk.clone())
        torch.cuda.synchronize()
        hold(label, "block_inv_z", blocks.to_blocks(zk, BLOCK_B),
             blocks.to_blocks(zp, BLOCK_B),
             dense_f64(blocks.to_blocks(xk, BLOCK_B), (1,), True), nnn)
        check(same(zk, fused_inverse.block_fused_inverse_plain(rows, volb.shape)),
              f"{label}: block_fused_inverse (both launches) bit-equal to "
              "block_fused_inverse_plain")
        scratch = xk.clone()
        out["block_inv_z"] = dict(
            max_abs_err=float((zk - zp).abs().max()),
            ms=cuda_ms(lambda: fused_inverse.block_inv_z(scratch), iters),
            plain_ms=cuda_ms(lambda: fused_inverse.block_inv_z_plain(xk), plain_iters),
            **bound(8 * ncell, C128_INV * ncell))
        del xk, zk, zp, scratch, rows, bdense
        torch.cuda.empty_cache()
        for k, lib in (("block_fwd_z", lib_fwd), ("block_encode_xy", lib_fwd),
                       ("block_inv_xy", lib_inv), ("block_inv_z", lib_inv)):
            out[k].update(library_ms=lib, library_call="one three-operator "
                          "torch.einsum (full f32): the transform of both launches"
                          + (", no tokenize" if k == "block_encode_xy" else ""))
        print(f"  {label}: library einsum3 forward {lib_fwd:.4f} ms, inverse "
              f"{lib_inv:.4f} ms on {card}")
        for k, r in out.items():
            print(f"  {label}: {k} kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms,"
                  f" bound {r['bound_ms']:.4f} ms ({r['bound_by']}) on {card}")
        return out, btimes, bbounds

    e2e = {}  # end-to-end times taken in the kernel phases
    vol_b = sinusoid(*SHAPE_B, PERIODS)
    breport, *_ = block_kernels("config B", vol_b, SCALE, 10, 2, native=True)
    # block_emit's row is A's (the main path), B's an input beside it
    report["block_emit"]["inputs"]["B"] = breport.pop("block_emit")
    report.update(breport)
    noise_b = np.random.default_rng(0).standard_normal(SHAPE_B, dtype=np.float32)
    nreport, nbtimes, nbbounds = block_kernels("config B noise", noise_b, NOISE_SCALE, 3,
                                               1, native=False, time_decompress=True)
    for k in DECODE_KERNELS:
        report[k].setdefault("inputs", {})["B noise container"] = dict(
            ms=nbtimes[k][0], plain_ms=nbtimes[k][1], device_ms=nbtimes[k][2],
            bound_ms=nbbounds[k]["bound_ms"])
    del noise_b
    report["block_emit"]["inputs"]["B noise"] = nreport.pop("block_emit")
    for k, r in nreport.items():
        report[k].update(noise_ms=r["ms"], noise_plain_ms=r["plain_ms"])
        if "library_ms" in r:
            report[k].update(noise_library_ms=r["library_ms"])

    def transforms_ramp(label, v):
        """The four K6/K8 launches on the ramp (block RMS 10^4 apart, an
        all-zero, a ~1e-38 and a NaN block): each bit-equal to its plain
        version and within 1e-5 of the f64 operator; the forward's
        coefficients feed the inverse."""
        vt = torch.from_numpy(v).to(dev)
        tk = fused_compress.fwd_z(vt)
        torch.cuda.synchronize()
        nnn = tk.shape[0]
        hold(label, "block_fwd_z", tk, fused_compress.fwd_z_plain(vt),
             dense_f64(blocks.to_blocks(vt, BLOCK_B), (1,), False), nnn)
        mf = quant.global_mulfac(v, SCALE)
        ck = fused_compress.encode_xy(tk, mf, out=torch.empty_like(tk))[0]
        torch.cuda.synchronize()
        hold(label, "block_encode_xy coefficients", ck,
             fused_compress.encode_xy_plain(tk, mf)[0], dense_f64(tk, (3, 2), False),
             nnn)
        del tk
        rows = ck.view(-1, fused_inverse.CHUNK)
        xk = fused_inverse.block_inv_xy(rows, v.shape)
        torch.cuda.synchronize()
        hold(label, "block_inv_xy", blocks.to_blocks(xk, BLOCK_B), blocks.to_blocks(
             fused_inverse.block_inv_xy_plain(rows, v.shape), BLOCK_B),
             dense_f64(rows, (3, 2), True), nnn)
        zk = fused_inverse.block_inv_z(xk.clone())
        torch.cuda.synchronize()
        hold(label, "block_inv_z", blocks.to_blocks(zk, BLOCK_B), blocks.to_blocks(
             fused_inverse.block_inv_z_plain(xk), BLOCK_B),
             dense_f64(blocks.to_blocks(xk, BLOCK_B), (1,), True), nnn)
        del vt, ck, rows, xk, zk
        torch.cuda.empty_cache()

    transforms_ramp("config B ramp", ramp(vol_b, 128))
    print(f"  config B noise container: decode_chase {nbtimes['decode_chase'][0]:.4f}"
          f" ms (one chain per block at cells = 2^21) on {card}")

    # -- phase 2c: the local-RMS kernels against their plain versions ------
    print(f"  at {time.perf_counter() - t_start:.1f} s", flush=True)
    print("phase 2c: local-RMS kernels vs plain versions at", SHAPE, "and", SHAPE_B,
          flush=True)

    def local_a(label, v, iters, plain_iters):
        """fused_encode_local and block_emit at its table, on `v` at A's
        shape; returns the encode's report and the emit's."""
        vt = torch.from_numpy(v).to(dev)
        ck, dk, cbk, sk, rk, mk = tokenize.fused_encode(vt, scale=SCALE)
        cp, _, cbp, *_ = tokenize.fused_encode_plain(vt, scale=SCALE)
        torch.cuda.synchronize()
        check(torch.equal(cbk, cbp), f"{label}: fused_encode_local chunk counts "
              f"({int((cbk > 0).sum())} live of {cbk.numel()}) bit-equal to "
              "fused_encode_plain's")
        del cbp
        fin = torch.isfinite(cp).all(1)
        err = float((ck[fin] - cp[fin]).abs().max())
        del cp
        mp = quant.mulfac_from_rms(quant.local_rms(ck), SCALE)
        check(torch.equal(mk, mp), f"{label}: fused_encode_local table bit-equal to the "
              f"plain local RMS of its coefficients (mulfacs {float(mk.min()):.4g} to "
              f"{float(mk.max()):.4g})")
        d2, s2, r2 = rle_device.tokenize(tokenize.scaled(ck, mk))
        check(torch.equal(dk, d2) and torch.equal(sk, s2) and torch.equal(rk, r2),
              f"{label}: fused_encode_local descriptors, sizes and raw flags "
              f"({int(rk.sum())} raw) bit-equal to the plain tokenize at the table")
        del d2, s2, r2
        base = pack.chunk_bases(cbk)
        total = int(cbk.sum())
        stk = pack.emit_chunks(ck, mk, dk, cbk, base, total)
        check(torch.equal(stk, pack.emit_chunks_plain(ck, mk, dk, cbk, base, total)),
              f"{label}: block_emit stream at 32^3 ({total} B) at the table bit-equal "
              "to plain")
        streams, nsizes, nraw = rle_host.encode_payloads(ck.cpu().numpy(),
                                                         mk.cpu().numpy())
        native = np.concatenate([st for st, r in zip(streams, nraw) if not r])
        check(np.array_equal(nsizes, sk.cpu().numpy()) and np.array_equal(
              native, stk.cpu().numpy()), f"{label}: stream bit-equal to native "
              "cvx_encode_payloads on the kernel's coefficients and table")
        cells = ck.numel()
        emit = dict(ms=cuda_ms(lambda: pack.emit_chunks(ck, mk, dk, cbk, base, total),
                               iters),
                    plain_ms=cuda_ms(lambda: pack.emit_chunks_plain(ck, mk, dk, cbk, base,
                                                                    total), plain_iters),
                    **bound(emit_chunks_bytes(dk, cbk, total), 0))
        del ck, dk, cbk, stk
        return emit, dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: tokenize.fused_encode(vt, scale=SCALE), iters),
            plain_ms=cuda_ms(lambda: tokenize.fused_encode_plain(vt, scale=SCALE),
                             plain_iters),
            # fused_encode's bytes and FLOP, the f64 square and add of every
            # coefficient
            **bound(4 * v.size + 8 * cells + cells // 32 + 9 * sk.numel(),
                    (3 * C32 + 1) * cells, 2 * cells),
            library_ms=cuda_ms(lambda: einsum3(vt, v.shape, BLOCK_A, False), iters),
            library_call="one three-operator torch.einsum (full f32): the transform, "
                         "no table, no tokenize")

    def local_b(label, v, iters, plain_iters):
        """block_casc_local, block_scale_tok and emit_chunks at the table on
        `v` at B's shape; returns the two kernels' reports."""
        vt = torch.from_numpy(v).to(dev)
        tk = fused_compress.fwd_z(vt)
        del vt
        cp, _ = fused_compress.casc_local_plain(tk)
        ck, pk = fused_compress.casc_local(tk.clone())
        torch.cuda.synchronize()
        hold(label, "block_casc_local coefficients", ck, cp,
             dense_f64(tk, (3, 2), False), ck.shape[0])
        fin = torch.isfinite(cp).all(1)
        err_c = float((ck[fin] - cp[fin]).abs().max())
        del cp
        pp = quant.cta_sumsq(ck.view(-1, 128 * 128), 256).view(-1, 128)
        check(same(pk, pp), f"{label}: block_casc_local slice sums bit-equal to the "
              "plain sums of its coefficients (NaN where the NaN block's are)")
        dk, cbk, sk, rk, mk = fused_compress.scale_tok(ck, pk, SCALE)
        dp, cbp, sp, rp, mp = fused_compress.scale_tok_plain(ck, pk, SCALE)
        check(torch.equal(mk, mp) and torch.equal(dk, dp) and torch.equal(cbk, cbp)
              and torch.equal(sk, sp) and torch.equal(rk, rp),
              f"{label}: block_scale_tok table (mulfacs {float(mk.min()):.4g} to "
              f"{float(mk.max()):.4g}), descriptors, chunk bytes, sizes and raw flags "
              f"({int(rk.sum())} raw) bit-equal to the plain version")
        del dp, cbp, sp, rp, mp
        cb64 = cbk.to(torch.int64)
        cbase = torch.cumsum(cb64, 0) - cb64
        total = int(cb64.sum())
        stk = pack.emit_chunks(ck, mk, dk, cbk, cbase, total)
        check(torch.equal(stk, pack.emit_chunks_plain(ck, mk, dk, cbk, cbase, total)),
              f"{label}: block_emit stream ({total} B) at the table bit-equal to plain")
        streams, nsizes, nraw = rle_host.encode_payloads(ck.cpu().numpy(),
                                                         mk.cpu().numpy())
        parts = [st for st, r in zip(streams, nraw) if not r]
        native = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
        check(np.array_equal(nsizes, sk.cpu().numpy()) and np.array_equal(
              native, stk.cpu().numpy()), f"{label}: stream bit-equal to native "
              "cvx_encode_payloads on the kernel's coefficients and table")
        del stk, dk, cbk, cbase
        ncell, nnn = ck.numel(), ck.shape[0]
        scratch = tk.clone()
        out = {
            "block_casc_local": dict(
                max_abs_err=err_c,
                ms=cuda_ms(lambda: fused_compress.casc_local(scratch), iters),
                plain_ms=cuda_ms(lambda: fused_compress.casc_local_plain(tk),
                                 plain_iters),
                # slice in and coefficients out, the slice sums out; two
                # cascades per cell, the f64 square and add
                **bound(8 * ncell + 8 * nnn * 128, 2 * C128 * ncell, 2 * ncell)),
            "block_scale_tok": dict(
                max_abs_err=0.0,
                ms=cuda_ms(lambda: fused_compress.scale_tok(ck, pk, SCALE), iters),
                plain_ms=cuda_ms(lambda: fused_compress.scale_tok_plain(ck, pk, SCALE),
                                 plain_iters),
                # coefficients and slice sums in; descriptors, chunk counts,
                # sizes and the table out; the scale per cell
                **bound(8 * ncell + 8 * nnn * 128 + ncell // 32 + 8 * nnn, ncell)),
        }
        del ck, pk, tk, scratch
        torch.cuda.empty_cache()
        return out

    for label, v, sc in inputs32:
        block32(label, v, sc, local=True)
    del inputs32, vol_u
    emit_local, enc_local = local_a("config A local", vol, 20, 3)
    report["block_emit"]["inputs"]["A-local 32^3"] = emit_local
    lrep = {"fused_encode_local": enc_local}
    rep_ramp = local_a("config A local ramp", ramp(vol, 32), 3, 1)[1]
    lrep["fused_encode_local"].update(ramp_ms=rep_ramp["ms"],
                                      ramp_plain_ms=rep_ramp["plain_ms"])
    lrep.update(local_b("config B local", vol_b, 10, 2))
    for k, r in local_b("config B local ramp", ramp(vol_b, 128), 3, 1).items():
        lrep[k].update(ramp_ms=r["ms"], ramp_plain_ms=r["plain_ms"])
    # whole all-zero blocks: the slices' zero-run look-back walks far
    vol_half = sinusoid(*SHAPE_HALF, PERIODS)
    vol_half[SHAPE_HALF[0] // 2:] = 0.0
    for k, r in local_b("half-zero 128^3 local", vol_half, 3, 1).items():
        lrep[k].update(half_zero_ms=r["ms"], half_zero_plain_ms=r["plain_ms"],
                       half_zero_bound_ms=r["bound_ms"])
    for k, r in lrep.items():
        print(f"  {k} kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}) on {card}")
    report.update(lrep)

    # -- phase 2d: the other geometries' kernels against their plain versions
    print(f"  at {time.perf_counter() - t_start:.1f} s", flush=True)
    print("phase 2d: stripe_fused_encode(_local), stripe_fused_inverse, tokenize_stripe "
          "and block_emit vs plain versions at", SHAPE, SHAPE_HALF, "and", SHAPE_S,
          flush=True)

    def generic_kernels(label, v, block, local, iters, plain_iters, half=False,
                        parity=False, view=False):
        """The route's encode kernel (`stripe_fused_encode(_local)` or
        `tokenize_stripe`) and block_emit against their plain versions on
        `v` at `block` (the tokenize and the emit on the encode's own
        coefficients and table), the stream against the native encoder, the
        decode kernels on the container and, on the fused stripe route,
        `stripe_fused_inverse` on its decoded coefficients, each fused
        stripe launch bit-equal to its plain version; with `parity` the
        card's container byte-equal to native `cvx_compress_parity_th`'s and
        its decompress to `cvx_decompress_inplace_parity_th`'s; with `view`
        the volume at a misaligned view (the 4-byte copy route); returns the
        kernels' reports."""
        vt = torch.from_numpy(v).to(dev)
        if view:
            vt = torch.zeros(v.size + 1, device=dev)[1:].view(v.shape)
            vt.copy_(torch.from_numpy(v))
        args = dict(scale=SCALE) if local else dict(mulfac=quant.global_mulfac(v, SCALE))
        fused = codec.route(v.shape, block) == "stripe_fused"
        bx, by, bz = block
        casc = sum(cascade_flops(n) for n in block if n > 1)
        if fused:
            kname = "stripe_fused_encode_local" if local else "stripe_fused_encode"
            c, dk, cbk, sk, rk, mk = tokenize.stripe_fused_encode(vt, block, **args)
            cp, *_, mp = tokenize.stripe_fused_encode_plain(vt, block, **args)
            torch.cuda.synchronize()
            check(bits_same(c, cp), f"{label}: {kname} coefficients bit-equal to the "
                  f"plain version's, native's parity cascade ({int(c.isnan().sum())} NaN "
                  "cells, where the plain version's are)")
            fin = torch.isfinite(cp)
            err_c = float((c[fin] - cp[fin]).abs().max())
            del cp, fin
            check(torch.equal(mk, mp), f"{label}: {kname} table (mulfacs "
                  f"{float(mk.min()):.4g} to {float(mk.max()):.4g}) bit-equal to the "
                  "plain version's (`quant.stripe_rms` of the same coefficients)")
            plain = tokenize.tokenize_blocks_plain(c, mk)
            cbm, sb = c, None

            def enc():
                return tokenize.stripe_fused_encode(vt, block, **args)

            def enc_plain():
                return tokenize.stripe_fused_encode_plain(vt, block, **args)
        else:
            kname, err_c = "tokenize_stripe", 0.0
            c, dk, cbk, sk, rk, mk = tokenize.encode(vt, block, **args)
            plain = tokenize.tokenize_stripe_plain(c, mk, block)
            cbm, sb = blocks.to_blocks(c, block).view(mk.numel(), -1), block

            def enc():
                return tokenize.tokenize_stripe(c, mk, block)

            def enc_plain():
                return tokenize.tokenize_stripe_plain(c, mk, block)
        nnn, nchunks, ncell = mk.numel(), cbk.numel(), c.numel()
        check(all(torch.equal(a, b) for a, b in zip((dk, cbk, sk, rk), plain)),
              f"{label}: {kname} descriptors, chunk bytes, sizes and raw flags "
              f"({int(rk.sum())} raw of {nnn} blocks) bit-equal to the plain tokenize "
              "of its coefficients and table")
        del plain
        if half:
            check(not bool(rk.any()) and int(sk[-1]) == 5
                  and int(dk[-1, -1]) == 5 | 8 | (rle_device.MAX_RUN24 << 4),
                  f"{label}: the all-zero 256^3 block is one run of 2^24 zeros, 5 bytes "
                  "(an RLESC3 of 2^24 - 1 and a trailing [0])")
        cb64 = cbk.to(torch.int64)
        cbase = torch.cumsum(cb64, 0) - cb64
        total = int(cb64.sum())
        stk = pack.emit_chunks(c, mk, dk, cbk, cbase, total, sb)
        stp = pack.emit_chunks_plain(c, mk, dk, cbk, cbase, total, sb)
        check(torch.equal(stk, stp), f"{label}: block_emit stream ({total} B) "
              "bit-equal to the plain version")
        streams, nsizes, nraw = rle_host.encode_payloads(cbm.cpu().numpy(),
                                                         mk.cpu().numpy())
        del cbm
        parts = [st for st, r in zip(streams, nraw) if not r]
        nat = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
        check(np.array_equal(nsizes, sk.cpu().numpy()) and np.array_equal(
              nraw, rk.cpu().numpy()) and np.array_equal(nat, stk.cpu().numpy()),
              f"{label}: sizes, raw flags and stream bit-equal to native "
              "cvx_encode_payloads on the encode's coefficients and table")
        del streams, parts, nat
        if fused:  # volume in; coefficients, descriptors, counts, table out
            enc_bound = bound(4 * v.size + 8 * ncell + 4 * nchunks + 9 * nnn,
                              (casc + 1) * ncell, 2 * ncell if local else 0)
        else:  # coefficients and the table in; descriptors, counts out
            enc_bound = bound(8 * ncell + 4 * nchunks + 9 * nnn, 0)
        lib = {}
        whole = all(n % b == 0 for n, b in zip(v.shape, block[::-1]))
        if fused and not whole:
            lib = dict(library_ms=None, library_call="none: the volume is not whole blocks")
        elif fused:  # the transform alone, as one library call
            lib = dict(library_ms=cuda_ms(lambda: einsum3(vt, v.shape, block, False), iters),
                       library_call="one three-operator torch.einsum (full f32): the "
                                    "transform, no table, no tokenize")
        out = {
            kname: dict(
                max_abs_err=err_c, ms=cuda_ms(enc, iters),
                plain_ms=cuda_ms(enc_plain, plain_iters), **enc_bound, **lib),
            "block_emit": dict(
                max_abs_err=float((stk.int() - stp.int()).abs().max()) if total else 0.0,
                ms=cuda_ms(lambda: pack.emit_chunks(c, mk, dk, cbk, cbase, total, sb),
                           iters),
                plain_ms=cuda_ms(lambda: pack.emit_chunks_plain(c, mk, dk, cbk, cbase,
                                                                total, sb), plain_iters),
                **bound(emit_chunks_bytes(dk, cbk, total), 0)),
        }
        del c, dk, cbk, sk, rk, mk, stk, stp, cbase, vt
        torch.cuda.empty_cache()
        d, r = cvt.compress(v, SCALE, block=block, use_local_rms=local)
        print(f"  {label}: container {d.size} B, ratio {r:.1f}")
        if parity:
            nd, _ = rle_host.host_compress_parity(v, SCALE, block=block)
            check(np.array_equal(np.asarray(d), nd), f"{label}: the card's container "
                  f"({d.size} B) byte-equal to native cvx_compress_parity_th's ({nd.size} B)")
            out_v = cvt.decompress(d).cpu().numpy()
            nv = rle_host.host_decompress_parity(nd)
            ndiff = int((out_v.view(np.uint32) != nv.view(np.uint32)).sum())
            check(ndiff == 0, f"{label}: the card's decompress equal to native "
                  f"cvx_decompress_inplace_parity_th's ({ndiff} of {nv.size} cells differ)")
            del nd, out_v, nv
        dense = decode_stages(f"{label} container", d, 3, 1)[0]
        if fused:
            vk = fused_inverse.stripe_fused_inverse(dense, v.shape, block)
            vp = fused_inverse.stripe_fused_inverse_plain(dense, v.shape, block)
            torch.cuda.synchronize()
            fin = torch.isfinite(vp)
            check(bits_same(vk, vp), f"{label}: stripe_fused_inverse bit-equal to its "
                  f"plain version on the decoded coefficients ({int((~fin).sum())} "
                  "non-finite cells, where the plain version's are)")
            casc_inv = sum(cascade_flops(n, inverse=True) for n in block if n > 1)
            out["stripe_fused_inverse"] = dict(
                max_abs_err=float((vk[fin] - vp[fin]).abs().max()),
                ms=cuda_ms(lambda: fused_inverse.stripe_fused_inverse(dense, v.shape,
                                                                      block), iters),
                plain_ms=cuda_ms(lambda: fused_inverse.stripe_fused_inverse_plain(
                    dense, v.shape, block), plain_iters),
                # coefficients in, volume out
                **bound(4 * dense.numel() + 4 * v.size, casc_inv * dense.numel()),
                library_ms=cuda_ms(lambda: einsum3(dense, v.shape, block, True), iters)
                if whole else None,
                library_call="one three-operator torch.einsum (full f32)" if whole
                else "none: the volume is not whole blocks")
            del vk, vp
        del dense
        torch.cuda.empty_cache()
        for k, rep in out.items():
            print(f"  {label}: {k} kernel {rep['ms']:.4f} ms, plain {rep['plain_ms']:.3f}"
                  f" ms, bound {rep['bound_ms']:.4f} ms ({rep['bound_by']}) on {card}")
        return out

    vol_s = sinusoid(*SHAPE_S, PERIODS)
    noise_u = np.random.default_rng(3).standard_normal(SHAPE_U, dtype=np.float32)
    vol_mib = sinusoid(64, 128, 128, PERIODS)  # one cluster of 8 CTAs a block
    generic = {}
    for label, v, block, local, half, extra in (
            ("A 8^3", vol, (8, 8, 8), False, False, {}),
            ("A 8^3 local ramp", ramp(vol, 8), (8, 8, 8), True, False, {}),
            ("A 256^3", vol, (256, 256, 256), False, False, {}),
            ("A 256^3 local ramp", ramp(vol, 256), (256, 256, 256), True, False, {}),
            ("half-zero 256^3", vol_half, (256, 256, 256), False, True, {}),
            ("A 64^3", vol, (64, 64, 64), False, False, {}),
            ("A 64^3 local ramp", ramp(vol, 64), (64, 64, 64), True, False, {}),
            ("A 64x32x32", vol, (64, 32, 32), False, False, dict(parity=True)),
            ("A 64x32x32 local ramp", ramp(vol, 64), (64, 32, 32), True, False, {}),
            ("A 64x32x32 noise", np.random.default_rng(4).standard_normal(
                SHAPE, dtype=np.float32) * np.float32(NOISE_SCALE), (64, 32, 32), False,
             False, {}),
            ("A 64x32x32 misaligned view", vol, (64, 32, 32), False, False,
             dict(view=True)),
            (f"unaligned {SHAPE_U} noise 8^3", noise_u, (8, 8, 8), False, False, {}),
            (f"unaligned {SHAPE_U} noise 64^3", noise_u, (64, 64, 64), False, False, {}),
            (f"unaligned {SHAPE_U} noise 16^3", noise_u, (16, 16, 16), True, False, {}),
            (f"unaligned {SHAPE_U} noise 64x32x32", noise_u, (64, 32, 32), False, False,
             {}),
            ("1 MiB 64^3 on (64, 128, 128)", vol_mib, (64, 64, 64), False, False, {}),
            ("1 MiB 64^3 on (64, 128, 128) local ramp", ramp(vol_mib, 64), (64, 64, 64),
             True, False, {}),
            ("S 16^3", vol_s, (16, 16, 16), False, False, dict(parity=True)),
            ("S 16^3 local", vol_s, (16, 16, 16), True, False, {}),
            ("S 16^3 local ramp", ramp(vol_s, 16), (16, 16, 16), True, False, {}),
            ("S 16^3 misaligned view", vol_s, (16, 16, 16), False, False, dict(view=True)),
            ("S 16x16x1", vol_s, (16, 16, 1), False, False, {}),
            ("S 16x16x1 local ramp", ramp(vol_s, 16), (16, 16, 1), True, False, {}),
            ("S 8x8x1", vol_s, (8, 8, 1), False, False, {}),
            ("S 128x8x8", vol_s, (128, 8, 8), False, False, {})):
        generic[label] = generic_kernels(label, v, block, local, 5, 1, half, **extra)
        print(f"  {label} done at {time.perf_counter() - t_start:.1f} s", flush=True)
    # each kernel's row at its cell (K13 at A-64^3, K1 at S-16^3), every
    # input's numbers beside it (B for block_emit)
    for k, cell in (("tokenize_stripe", "A 64^3"), ("stripe_fused_encode", "S 16^3"),
                    ("stripe_fused_encode_local", "S 16^3 local"),
                    ("stripe_fused_inverse", "S 16^3")):
        report[k] = dict(generic[cell][k])
    for k in ("tokenize_stripe", "stripe_fused_encode", "stripe_fused_encode_local",
              "stripe_fused_inverse", "block_emit"):
        report[k].setdefault("inputs", {}).update({
            label: {f: r[k][f] for f in ("ms", "plain_ms", "bound_ms", "library_ms")
                    if f in r[k]}
            for label, r in generic.items() if k in r})
    # the stripe tokenize on the unaligned noise's 64^3 plane, edge blocks
    # (its public route is the fused stripe kernel's, held above)
    label = f"unaligned {SHAPE_U} noise 64^3 plane"
    vt = torch.from_numpy(noise_u).to(dev)
    c, dk, cbk, sk, rk, mk = tokenize.encode(vt, (64, 64, 64),
                                             quant.global_mulfac(noise_u, SCALE))
    check(all(torch.equal(a, b) for a, b in zip(
        (dk, cbk, sk, rk), tokenize.tokenize_stripe_plain(c, mk, (64, 64, 64)))),
          f"{label}: tokenize_stripe descriptors, chunk bytes, sizes and raw flags "
          f"({int(rk.sum())} raw of {mk.numel()} blocks) bit-equal to the plain version")
    report["tokenize_stripe"]["inputs"][label] = dict(
        ms=cuda_ms(lambda: tokenize.tokenize_stripe(c, mk, (64, 64, 64)), 5),
        plain_ms=cuda_ms(lambda: tokenize.tokenize_stripe_plain(c, mk, (64, 64, 64)), 1),
        **bound(8 * c.numel() + 4 * cbk.numel() + 9 * mk.numel(), 0))
    print(f"  {label}: tokenize_stripe kernel "
          f"{report['tokenize_stripe']['inputs'][label]['ms']:.4f} ms on {card}")
    del noise_u, vol_mib, vt, c, dk, cbk, sk, rk, mk

    # -- phase 2e: the opt-in encode routes' kernels against their plain
    # versions (the JAX package's CVX_FUSED_W=1, CVX_STRIPE=patch and
    # CVX_FUSED_COMPACT=1 routes, ops/geometry.py)
    print(f"  at {time.perf_counter() - t_start:.1f} s", flush=True)
    print("phase 2e: block_fwd_xz, block_encode_y, patch_extract, tokenize_compact and "
          "block_emit_rows vs plain versions at", SHAPE, "and", SHAPE_B, flush=True)
    t_phase = time.perf_counter()
    optin = {}

    def native_stream(coeffs, mf, stream, label):
        """The stream against native cvx_encode_payloads on block-major
        coefficients and their table."""
        streams, _, nraw = rle_host.encode_payloads(coeffs.cpu().numpy(),
                                                    mf.cpu().numpy())
        parts = [st for st, r in zip(streams, nraw) if not r]
        nat = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
        check(np.array_equal(nat, stream.cpu().numpy()), f"{label}: stream bit-equal to "
              "native cvx_encode_payloads on the kernels' coefficients and table")

    def rows_emit(label, rows, drows, ids, mk, cbk, cbase, total, in_place, iters):
        """The rows emit against its plain version and the in-place emit's
        stream; returns its report."""
        stk = pack.emit_rows(rows, drows, ids, mk, cbk, cbase, total)
        stp = pack.emit_rows_plain(rows, drows, ids, mk, cbk, cbase, total)
        check(torch.equal(stk, stp) and torch.equal(stk, in_place),
              f"{label}: block_emit_rows stream ({total} B, {ids.numel()} rows) "
              "bit-equal to the plain version and to the in-place block_emit's")
        groups = int(((drows.view(-1, 8) & 7).sum(1) > 0).sum())
        return stk, dict(
            max_abs_err=0.0,
            ms=cuda_ms(lambda: pack.emit_rows(rows, drows, ids, mk, cbk, cbase, total),
                       iters),
            plain_ms=cuda_ms(lambda: pack.emit_rows_plain(rows, drows, ids, mk, cbk,
                                                          cbase, total), 1),
            # per row its descriptors, id, count and base, the coefficients
            # of its groups with a token; the table; the stream out
            **bound(ids.numel() * (512 + 16) + 32 * groups + 4 * mk.numel() + total, 0))

    def fused_w_kernels(label, v, scale, iters, timed=True):
        """K16a + K16b at B against their plain versions and against
        block_encode (z | x,y) on the same volume; with `timed`, the two
        splits timed in turns (z|xy, xz|y, xz|y, z|xy) and the kernels'
        report returned."""
        vtb = torch.from_numpy(v).to(dev)
        mf = quant.global_mulfac(v, scale)
        plane = fused_compress.fwd_xz(vtb)
        pp_ = fused_compress.fwd_xz_plain(vtb)
        torch.cuda.synchronize()
        nnn = plane.numel() // 128 ** 3
        hold(label, "block_fwd_xz", blocks.to_blocks(plane, BLOCK_B),
             blocks.to_blocks(pp_, BLOCK_B),
             dense_f64(blocks.to_blocks(vtb, BLOCK_B), (1, 3), False), nnn)
        fin = pp_.isfinite()
        err_xz = float((plane[fin] - pp_[fin]).abs().max())
        del pp_
        ck, dk, cbk, sk, rk, mk = fused_compress.encode_y(plane, mf)
        cp = fused_compress.encode_y_plain(plane, mf)[0]
        torch.cuda.synchronize()
        hold(label, "block_encode_y coefficients", ck, cp,
             dense_f64(blocks.to_blocks(plane, BLOCK_B), (2,), False), nnn)
        fin = cp.isfinite()
        err_y = float((ck[fin] - cp[fin]).abs().max())
        del cp
        plain = tokenize.tokenize_blocks_plain(ck, mf)
        check(all(torch.equal(a, b) for a, b in zip((dk, cbk, sk, rk), plain)),
              f"{label}: block_encode_y desc, chunk_bytes, sizes and raw bit-equal to "
              "the plain tokenize of its coefficients")
        del plain
        ref = fused_compress.block_encode(vtb, mf)
        # every bit, but a NaN (the ramp's NaN block) matching a NaN
        ndiff = int(((ck.view(torch.int32) != ref[0].view(torch.int32))
                     & ~(ck.isnan() & ref[0].isnan())).sum())
        ddiff = int((dk != ref[1]).sum())
        same_all = all(torch.equal(a, b) for a, b in zip((cbk, sk, rk, mk), ref[2:]))
        print(f"  {label}: x,z | y against z | x,y (block_encode): {ndiff} coefficients "
              f"and {ddiff} descriptors differ of {ck.numel()}")
        check(ndiff == 0 and ddiff == 0 and same_all, f"{label}: block_fwd_xz + "
              "block_encode_y coefficients, descriptors, counts, sizes, raw flags and "
              "table bit-equal to block_encode's (z | x,y)")
        del ref
        if not timed:
            return None
        ncell = ck.numel()
        split_ms = [cuda_ms(lambda: fused_compress.block_encode(vtb, mf), iters),
                    cuda_ms(lambda: fused_compress.block_encode_w(vtb, mf), iters),
                    cuda_ms(lambda: fused_compress.block_encode_w(vtb, mf), iters),
                    cuda_ms(lambda: fused_compress.block_encode(vtb, mf), iters)]
        print(f"  {label}: whole encode in turns z|xy {split_ms[0]:.4f}, xz|y "
              f"{split_ms[1]:.4f}, xz|y {split_ms[2]:.4f}, z|xy {split_ms[3]:.4f} ms "
              f"on {card}")
        out = {
            "block_fwd_xz": dict(
                max_abs_err=err_xz, ms=cuda_ms(lambda: fused_compress.fwd_xz(vtb), iters),
                plain_ms=cuda_ms(lambda: fused_compress.fwd_xz_plain(vtb), 1),
                library_ms=cuda_ms(lambda: einsum_xz(vtb, v.shape, BLOCK_B), iters),
                library_call="one two-operator torch.einsum (full f32), x and z",
                einsum3_ms=cuda_ms(lambda: einsum3(vtb, v.shape, BLOCK_B, False), iters),
                # volume in, plane out; two cascades per cell
                **bound(8 * ncell, 2 * C128 * ncell)),
            "block_encode_y": dict(
                max_abs_err=err_y,
                ms=cuda_ms(lambda: fused_compress.encode_y(plane, mf), iters),
                plain_ms=cuda_ms(lambda: fused_compress.encode_y_plain(plane, mf), 1),
                # plane in; coefficients, descriptors, chunk counts, sizes
                # and table out; one cascade and the scale per cell
                **bound(12 * ncell + 4 * cbk.numel() + 8 * nnn, (C128 + 1) * ncell)),
        }
        if label == "config B":
            cb64 = cbk.to(torch.int64)
            total = int(cb64.sum())
            stk = pack.emit_chunks(ck, mk, dk, cbk, torch.cumsum(cb64, 0) - cb64, total)
            native_stream(ck, mk, stk, label)
            out["split_ms"] = split_ms
        del plane, ck, dk, cbk, vtb
        torch.cuda.empty_cache()
        return out

    rep = fused_w_kernels("config B", vol_b, SCALE, 10)
    optin["split_ms"] = rep.pop("split_ms")
    noise_b = np.random.default_rng(0).standard_normal(SHAPE_B, dtype=np.float32)
    nrep = fused_w_kernels("config B noise", noise_b, NOISE_SCALE, 3)
    del noise_b
    for k, r in rep.items():
        r.update(noise_ms=nrep[k]["ms"], noise_plain_ms=nrep[k]["plain_ms"])
        if "library_ms" in nrep[k]:
            r.update(noise_library_ms=nrep[k]["library_ms"])
    optin.update(rep)
    fused_w_kernels("config B ramp", ramp(vol_b, 128), SCALE, 1, timed=False)

    def patch_kernels(label, v, block, iters, scale=SCALE):
        """patch_extract and the rows emit on the stripe route's encode of
        `v` at `block` (the route CVX_STRIPE=patch takes)."""
        vt = torch.from_numpy(v).to(dev)
        c, dk, cbk, sk, rk, mk = tokenize.encode(vt, block, quant.global_mulfac(v, scale))
        del vt
        n = int((cbk > 0).sum())
        launched = _kernels.launches["patch_extract"]
        rows, drows, ids = pack.patch_extract(c, dk, cbk, block, n)
        check(_kernels.launches["patch_extract"] == launched + 1,
              f"{label}: patch_extract is one launch")
        plain = pack.patch_extract_plain(c, dk, cbk, block, n)
        check(torch.equal(rows.view(torch.int32), plain[0].view(torch.int32))
              and all(torch.equal(a, b) for a, b in zip((drows, ids), plain[1:])),
              f"{label}: patch_extract rows (as int32: NaN payloads too), descriptors "
              f"and ids ({n} live of "
              f"{cbk.numel()} chunks) bit-equal to the plain version")
        del plain
        cb64 = cbk.to(torch.int64)
        cbase = torch.cumsum(cb64, 0) - cb64
        total = int(cb64.sum())
        in_place = pack.emit_chunks(c, mk, dk, cbk, cbase, total, block)
        stk, erep = rows_emit(label, rows, drows, ids, mk, cbk, cbase, total, in_place,
                              iters)
        native_stream(blocks.to_blocks(c, block).view(mk.numel(), -1), mk, stk, label)
        in_place_ms = cuda_ms(lambda: pack.emit_chunks(c, mk, dk, cbk, cbase, total,
                                                       block), iters)
        out = {
            "patch_extract": dict(
                max_abs_err=0.0,
                ms=cuda_ms(lambda: pack.patch_extract(c, dk, cbk, block, n), iters),
                plain_ms=cuda_ms(lambda: pack.patch_extract_plain(c, dk, cbk, block, n),
                                 1),
                # every chunk's count; per live chunk 1 KiB in, 1 KiB and
                # its id out
                **bound(4 * cbk.numel() + n * (2048 + 4), 0)),
            "block_emit_rows": erep,
        }
        print(f"  {label}: block_emit in place {in_place_ms:.4f} ms, rows mode "
              f"{erep['ms']:.4f} ms (+ patch_extract {out['patch_extract']['ms']:.4f}) "
              f"on {card}")
        out["block_emit_rows"].update(in_place_ms=in_place_ms, in_place_bound_ms=bound(
            emit_chunks_bytes(dk, cbk, total), 0)["bound_ms"])
        del c, dk, cbk, rows, drows, ids, stk, in_place
        torch.cuda.empty_cache()
        return out

    def compact_kernels(label, v, block, local, iters):
        """tokenize_compact and the rows emit on the compact route's encode
        of `v` at `block`."""
        vt = torch.from_numpy(v).to(dev)
        args = dict(scale=SCALE) if local else dict(mulfac=quant.global_mulfac(v, SCALE))
        (coeffs, mk, cbk, sk, rk, rows, drows, ids, rbytes,
         nrows) = tokenize.compact_encode(vt, block, **args)
        del vt
        plain = tokenize.tokenize_compact_plain(coeffs, mk)
        n = int(nrows[0])
        same_rows = torch.equal(rows[:n].view(torch.int32), plain[3].view(torch.int32)) \
            and all(torch.equal(a[:n], b) for a, b in zip((drows, ids, rbytes), plain[4:7]))
        check(n == plain[3].shape[0] and same_rows and all(
            torch.equal(a, b) for a, b in zip((cbk, sk, rk), plain[:3])),
              f"{label}: tokenize_compact chunk counts, sizes, raw flags "
              f"({int(rk.sum())} raw) and {n} live rows (coefficients, descriptors, ids, "
              "counts, in chunk order) bit-equal to the plain version")
        del plain
        cb64 = cbk.to(torch.int64)
        cbase = torch.cumsum(cb64, 0) - cb64
        total = int(cb64.sum())
        desc = tokenize.tokenize_blocks_plain(coeffs, mk)[0]
        in_place = pack.emit_chunks(coeffs, mk, desc, cbk, cbase, total)
        in_place_ms = cuda_ms(lambda: pack.emit_chunks(coeffs, mk, desc, cbk, cbase,
                                                       total), iters)
        in_place_bound_ms = bound(emit_chunks_bytes(desc, cbk, total), 0)["bound_ms"]
        del desc
        stk, erep = rows_emit(label, rows[:n], drows[:n], ids[:n], mk, cbk, cbase, total,
                              in_place, iters)
        native_stream(coeffs, mk, stk, label)
        ncell, nchunks, nnn = coeffs.numel(), cbk.numel(), mk.numel()
        out = {
            "tokenize_compact": dict(
                max_abs_err=0.0,
                ms=cuda_ms(lambda: tokenize.tokenize_compact(coeffs, mk), iters),
                plain_ms=cuda_ms(lambda: tokenize.tokenize_compact_plain(coeffs, mk), 1),
                # coefficients and table in; chunk counts, sizes, the live
                # rows (1 KiB, id and count each) out
                **bound(4 * ncell + 4 * nnn + 4 * nchunks + 4 * nnn + n * (1024 + 8), 0)),
            "block_emit_rows": erep,
        }
        erep.update(in_place_ms=in_place_ms, in_place_bound_ms=in_place_bound_ms)
        print(f"  {label}: block_emit in place {in_place_ms:.4f} ms, rows mode "
              f"{erep['ms']:.4f} ms on {card}")
        del coeffs, rows, drows, ids, stk, in_place
        torch.cuda.empty_cache()
        return out

    prep = {}
    noise_a = np.random.default_rng(0).standard_normal(SHAPE, dtype=np.float32)
    for label, v, block, scale in (
            ("A 32^3", vol, (32, 32, 32), SCALE), ("A 64^3", vol, (64, 64, 64), SCALE),
            ("A 32^3 ramp", ramp(vol, 32), (32, 32, 32), SCALE),
            # every chunk live
            ("A 32^3 noise", noise_a, (32, 32, 32), NOISE_SCALE),
            ("A (8, 16, 8)", vol, (8, 16, 8), SCALE)):
        prep[label] = patch_kernels(f"patch {label}", v, block, 5, scale)
    del noise_a
    crep = {}
    for label, v, block, local in (("A", vol, (32, 32, 32), False),
                                   ("A-local", vol, (32, 32, 32), True),
                                   ("B", vol_b, BLOCK_B, False),
                                   # two blocks of 1,024 tiles each, the second all zero
                                   ("half-zero 256^3", vol_half, (256, 256, 256), False)):
        crep[label] = compact_kernels(f"compact {label}", v, block, local, 5)
    del vol_half
    optin["patch_extract"] = dict(prep["A 32^3"]["patch_extract"])
    optin["block_emit_rows"] = dict(prep["A 32^3"]["block_emit_rows"])
    optin["tokenize_compact"] = dict(crep["A"]["tokenize_compact"])
    for k, reps in (("patch_extract", prep), ("tokenize_compact", crep)):
        optin[k]["inputs"] = {lb: {f: r[k][f] for f in ("ms", "plain_ms", "bound_ms")}
                              for lb, r in reps.items()}
    optin["block_emit_rows"]["inputs"] = {
        f"{route} {lb}": {f: r["block_emit_rows"][f]
                         for f in ("ms", "in_place_ms", "plain_ms", "bound_ms",
                                   "in_place_bound_ms")}
        for route, reps in (("patch", prep), ("compact", crep)) for lb, r in reps.items()}

    # K15's home: tokenize_stripe at B, the route CVX_FUSED_W=0 takes
    vtb = torch.from_numpy(vol_b).to(dev)
    c, dk, cbk, sk, rk, mk = tokenize.encode(vtb, BLOCK_B,
                                             quant.global_mulfac(vol_b, SCALE))
    del vtb
    check(all(torch.equal(a, b) for a, b in zip(
        (dk, cbk, sk, rk), tokenize.tokenize_stripe_plain(c, mk, BLOCK_B))),
          "B under CVX_FUSED_W=0 (K15's home): tokenize_stripe descriptors, chunk bytes, "
          "sizes and raw flags bit-equal to the plain version")
    report["tokenize_stripe"]["inputs"]["B (K15)"] = dict(
        ms=cuda_ms(lambda: tokenize.tokenize_stripe(c, mk, BLOCK_B), 10),
        plain_ms=cuda_ms(lambda: tokenize.tokenize_stripe_plain(c, mk, BLOCK_B), 1),
        **bound(8 * c.numel() + 4 * cbk.numel() + 9 * mk.numel(), 0))
    print(f"  B (K15): tokenize_stripe kernel "
          f"{report['tokenize_stripe']['inputs']['B (K15)']['ms']:.4f} ms on {card}")
    del c, dk, cbk, sk, rk, mk
    torch.cuda.empty_cache()
    for k, r in optin.items():
        if k != "split_ms":
            print(f"  {k} kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}) on {card}")
    split_ms = optin.pop("split_ms")
    report.update(optin)
    print(f"  phase 2e {time.perf_counter() - t_phase:.1f} s", flush=True)

    # The native codec is serial here (no OpenMP runtime), so its
    # references run in worker threads (ctypes releases the GIL), none of
    # them while a timed path runs; each (input, block, mode) once a run.
    pool = ThreadPoolExecutor(max_workers=6)
    natives = {}

    def native_ref(v, prefix, block, local):
        """A future of native's container of `v` (the input named `prefix`)
        at `block`, its ratio, its decode, err and SNR; one per key a run."""
        key = (prefix, tuple(block), local)

        def run():
            dn, rn = rle_host.host_compress(v, SCALE, block=block, use_local_rms=local)
            on = rle_host.host_decompress(dn)
            return dn, rn, on, *err_snr(v, on)

        if key not in natives:
            natives[key] = pool.submit(run)
        return natives[key]

    # native's parity codec at A (the 32^3 path's arithmetic), off the timed paths
    native_parity_a = pool.submit(rle_host.host_compress_parity, vol, SCALE)

    # -- phase 3: the main path through the public API, config A ---------
    print(f"  at {time.perf_counter() - t_start:.1f} s", flush=True)
    print("phase 3: main path A, compress -> decompress (default device, engine "
          "auto = device) on", name, flush=True)
    _kernels.reset_counts()
    data, ratio = cvt.compress(vol, SCALE, block=(32, 32, 32))
    out = cvt.decompress(data)
    torch.cuda.synchronize()
    counts_a = dict(_kernels.launches)
    print(f"  launches on main path A: {counts_a}")
    check(all(counts_a[k] > 0 for k in KERNELS_A + DECODE_KERNELS)
          and counts_a["plan_layout"] == 1,
          "every kernel of path A launched on it, plan_layout once")
    out_h = out.cpu().numpy()
    check(out_h.shape == SHAPE and bool(np.isfinite(out_h).all()),
          f"decompressed volume finite, shape {SHAPE}")
    err, snr = err_snr(vol, out_h)
    check(err < 2e-4 and snr > 75.0, f"err {err:.4e} < 2e-4, SNR {snr:.2f} dB > 75")
    check(abs(ratio - REF_RATIO) / REF_RATIO < 0.01,
          f"ratio {ratio:.1f} within 1% of {REF_RATIO}")
    out_host = cvt.decompress(data, engine="host")
    e = rel_rms(out.cpu(), out_host.cpu())
    check(e < TRANSFORM_TOL, f"engine device within rel RMS {e:.3e} of engine host")
    # the 32^3 path runs the native parity cascade (x, y, z): both engines'
    # volumes are native's parity decompress, bit for bit
    par = rle_host.host_decompress_parity(data)
    for eng, o in (("device", out_h), ("host", out_host.cpu().numpy())):
        nd = int((o.view(np.uint32) != par.view(np.uint32)).sum())
        check(nd == 0, f"engine {eng}: A's decompress bit-equal to native "
              f"cvx_decompress_inplace_parity_th ({nd} of {o.size} cells differ)")
    dpar, rpar = native_parity_a.result()
    mf_port = cvt.container.unpack(data)[0].glob_mulfac
    mf_nat = cvt.container.unpack(dpar)[0].glob_mulfac
    nb = int((dpar[:min(dpar.size, data.size)] != data[:min(dpar.size, data.size)]).sum())
    print(f"  A's container {data.size} B against native cvx_compress_parity_th's "
          f"{dpar.size} B (ratio {rpar:.1f}): {nb} bytes differ; mulfac {mf_port!r} "
          f"(port, host f64 sum) and {mf_nat!r} (native)")
    if mf_port == mf_nat:
        check(np.array_equal(data, dpar), "with equal mulfacs, A's container equals "
              "native cvx_compress_parity_th's byte for byte")
    nat = rle_host.host_decompress(data)
    e = rel_rms(torch.from_numpy(nat), torch.from_numpy(out_h))
    check(e < TRANSFORM_TOL, f"port container decodes under native "
          f"cvx_decompress_outofplace within rel RMS {e:.3e}")
    dn, rn, on, *_ = native_ref(vol, "A", (32, 32, 32), False).result()
    outn = cvt.decompress(dn, engine="device").cpu()
    e = rel_rms(outn, torch.from_numpy(on))
    check(e < TRANSFORM_TOL, f"native cvx_compress container (ratio {rn:.1f}) "
          f"decodes on the device engine within rel RMS {e:.3e} of native")
    del out, out_host, outn

    def timed_path(tag, v, block, d, local=False, runs=5, profile=True):
        """Medians of `runs`: compress (numpy in), compress (volume on the
        card), decompress on both engines; then, with `profile`, one
        profiled compress + decompress."""
        vdev = torch.from_numpy(v).to(dev)

        def run_compress():
            cvt.compress(v, SCALE, block=block, use_local_rms=local)

        def run_compress_resident():  # a volume already on the card
            cvt.compress(vdev, SCALE, block=block, use_local_rms=local)

        def run_decompress(engine="auto"):
            cvt.decompress(d, engine=engine)
            torch.cuda.synchronize()

        run_compress()
        run_compress_resident()
        run_decompress("host")
        res = {}
        mcells = v.size / 1e6
        for key, fn in (("compress", run_compress),
                        ("compress_resident", run_compress_resident),
                        ("decompress", run_decompress),
                        ("decompress_host_engine", lambda: run_decompress("host"))):
            med, times = wall_ms(fn, runs)
            res[f"{key}_ms"] = med
            print(f"  config {tag}: {key} median {med:.2f} ms "
                  f"({mcells / med * 1e3:.0f} MC/s) runs {[round(x, 2) for x in times]}"
                  f" on {card}")
        if not profile:
            return res
        spans, idle = profiled(run_compress, run_decompress, tag, card)
        check(all(sp in spans for sp in DECODE_SPANS),
              f"config {tag}: the profiled decompress ran the device engine's "
              f"spans {DECODE_SPANS}")
        check("cvx.decode_host" not in spans and "cvx.sparse_chunks" not in spans,
              f"config {tag}: the profiled decompress did no per-cell host work "
              "(no cvx.decode_host, no cvx.sparse_chunks)")
        res.update(spans_ms=spans, device_idle_share=idle)
        return res

    res_a = timed_path("A", vol, (32, 32, 32), data)
    check("cvx.fused_inverse" in res_a["spans_ms"], "config A: inverse span ran")

    # -- phase 3b: the main path through the public API, config B --------
    print(f"  at {time.perf_counter() - t_start:.1f} s", flush=True)
    print("phase 3b: main path B (128^3 blocks), compress -> decompress (default "
          "device, engine auto = device) on", name, flush=True)
    _kernels.reset_counts()
    data_b, ratio_b = cvt.compress(vol_b, SCALE, block=BLOCK_B)
    out_b = cvt.decompress(data_b)
    torch.cuda.synchronize()
    counts_b = dict(_kernels.launches)
    print(f"  launches on main path B: {counts_b}")
    check(all(counts_b[k] > 0 for k in KERNELS_B + DECODE_KERNELS),
          "every kernel of path B launched on it")
    check(out_b.device.type == "cuda", "the default device is the card")
    ob = out_b.cpu().numpy()
    check(ob.shape == SHAPE_B and bool(np.isfinite(ob).all()),
          f"decompressed volume finite, shape {SHAPE_B}")
    err_b, snr_b = err_snr(vol_b, ob)
    check(err_b < 2e-4 and snr_b > 75.0,
          f"err {err_b:.4e} < 2e-4 (JAX record {REF_B['err']}), SNR {snr_b:.2f} dB > 75 "
          f"(JAX record {REF_B['snr']})")
    check(abs(ratio_b - REF_B["ratio"]) / REF_B["ratio"] < 0.01,
          f"ratio {ratio_b:.1f} within 1% of {REF_B['ratio']}")
    e = rel_rms(out_b, cvt.decompress(data_b, engine="host"))
    check(e < TRANSFORM_TOL, f"engine device within rel RMS {e:.3e} of engine host")
    e = rel_rms(torch.from_numpy(rle_host.host_decompress(data_b)), torch.from_numpy(ob))
    check(e < TRANSFORM_TOL, f"port container decodes under native "
          f"cvx_decompress_outofplace within rel RMS {e:.3e}")
    nd = int((rle_host.host_decompress_parity(data_b).view(np.uint32)
              != ob.view(np.uint32)).sum())
    check(nd == 0, "the card's decompress of B's container bit-equal to native "
          f"cvx_decompress_inplace_parity_th ({nd} of {ob.size} cells differ)")
    del out_b, ob
    res_b = timed_path("B", vol_b, BLOCK_B, data_b)
    check("cvx.block_fused_inverse" in res_b["spans_ms"], "config B: inverse span ran")

    # -- phases 3c and 3d: the local-RMS paths through the public API ------
    def local_path(tag, v, prefix, block, kernels, ref_ratio):
        """compress(use_local_rms=True) -> decompress on the default device,
        held against the native library's local codec run here."""
        print(f"  at {time.perf_counter() - t_start:.1f} s", flush=True)
        print(f"phase {tag}: local-RMS path, block {block}, compress -> decompress "
              "(default device, engine auto = device) on", name, flush=True)
        _kernels.reset_counts()
        d, r = cvt.compress(v, SCALE, block=block, use_local_rms=True)
        o = cvt.decompress(d)
        torch.cuda.synchronize()
        counts = dict(_kernels.launches)
        print(f"  launches on local path {tag}: {counts}")
        check(all(counts[k] > 0 for k in kernels + DECODE_KERNELS),
              f"every kernel of local path {tag} launched on it")
        check(counts["fused_encode"] == counts["block_encode_xy"] == 0,
              "no global-RMS encode kernel launched")
        oh = o.cpu().numpy()
        check(oh.shape == v.shape and bool(np.isfinite(oh).all()),
              f"decompressed volume finite, shape {v.shape}")
        err_l, snr_l = err_snr(v, oh)
        check(err_l < 2e-4 and snr_l > 75.0, f"err {err_l:.4e} < 2e-4, SNR "
              f"{snr_l:.2f} dB > 75")
        dn, rn, on, *_ = native_ref(v, prefix, block, True).result()
        check(abs(r - rn) / rn < 0.01, f"ratio {r:.1f} within 1% of native "
              f"cvx_compress_th(use_local_RMS=1) here, {rn:.1f} ({ref_ratio} on a CPU)")
        hdr, _, mf, _ = cvt.container.unpack(d)
        mfn = cvt.container.unpack(dn)[2]
        rt = float(np.max(np.abs(mf.astype(np.float64) / mfn - 1.0)))
        check(hdr.use_local_rms and hdr.glob_mulfac == 1.0 and rt < 1e-5,
              f"local container: header mulfac 1.0, table within rtol {rt:.2e} of "
              f"native's ({int((mf == mfn).sum())} of {mf.size} bit-equal)")
        e = rel_rms(o, cvt.decompress(d, engine="host"))
        check(e < TRANSFORM_TOL, f"engine device within rel RMS {e:.3e} of engine host")
        e = rel_rms(torch.from_numpy(rle_host.host_decompress(d)), torch.from_numpy(oh))
        check(e < TRANSFORM_TOL, f"port container decodes under native "
              f"cvx_decompress_outofplace within rel RMS {e:.3e}")
        outn = cvt.decompress(dn, engine="device").cpu()
        e = rel_rms(outn, torch.from_numpy(on))
        check(e < TRANSFORM_TOL, f"native local container (ratio {rn:.1f}) decodes "
              f"on the device engine within rel RMS {e:.3e} of native")
        del o, oh, outn
        decode_stages(f"local {tag} container", d, 3, 1)
        torch.cuda.empty_cache()
        res = timed_path(tag, v, block, d, local=True, runs=3)
        return counts, dict(ratio=r, err=err_l, snr_db=snr_l, native_ratio=rn,
                            table_rtol=rt, **res)

    counts_c, res_c = local_path("3c", vol, "A", (32, 32, 32), KERNELS_C, 1104.6)
    counts_d, res_d = local_path("3d", vol_b, "B", BLOCK_B, KERNELS_D, 21266.9)

    # -- phase 3e: every other geometry through the public API -------------
    print(f"  at {time.perf_counter() - t_start:.1f} s", flush=True)
    print("phase 3e: the other geometries, compress -> decompress (default device, "
          "engine auto = device), held against native run here and the JAX package's "
          "record, on", name, flush=True)

    def steps(v, block, local, dn):
        """The port's quantized coefficients against native's container dn
        (its decode times each block's mulfac, rounded), raw blocks left
        out: (coefficients that differ, the largest |difference|, the
        largest distance of a differing one's scaled value |fv| from the
        step max(|q|, |q_native|) over its block's largest |fv|, and what
        the steps can move the reconstruction: kappa * ||steps|| / ||v||,
        kappa the inverse operators' 2-norms, each step 1/mulfac of its
        block).  A transform difference within its 1e-5 contract moves a
        quantized value only where the scaled value sits on a step."""
        vt = torch.from_numpy(v).to(dev)
        args = dict(scale=SCALE) if local else dict(mulfac=quant.global_mulfac(v, SCALE))
        if codec.route(v.shape, block) == "stripe_fused":
            c, *_, raw, mf = tokenize.stripe_fused_encode(vt, block, **args)
        else:
            c, *_, raw, mf = tokenize.encode(vt, block, **args)
            c = blocks.to_blocks(c, block).view(mf.numel(), -1)
        del vt
        hdr, blkoffs, blkmf, pbase = cvt.container.unpack(dn)
        mfn = (np.full(blkoffs.size, hdr.glob_mulfac, np.float32) if blkmf is None
               else blkmf)
        qn = torch.from_numpy(rle_host.decode_payloads(
            dn[pbase:], blkoffs, hdr.glob_mulfac, c.shape[1], blkmf))
        live = ~raw & torch.from_numpy(blkoffs >= 0).to(dev)
        qn = qn.to(dev)[live].double().mul_(torch.from_numpy(mfn).to(dev)[live][:, None])
        qn = qn.round_()
        fv = (c[live] * mf[live][:, None]).double()
        del c
        d = quant.quantize(fv.float()).double() - qn
        diff = d != 0
        n = int(diff.sum())
        if not n:
            return 0, 0.0, 0.0, 0.0
        step = torch.maximum(fv.trunc().abs(), qn.abs())
        dist = ((fv.abs() - step).abs() / fv.abs().amax(1, keepdim=True))[diff]
        norm2 = float((diff.sum(1).double() / mf[live].double() ** 2).sum())
        kappa = float(np.prod([np.linalg.norm(wavelet.inverse_matrix(b), 2)
                               for b in block]))
        return (n, float(d.abs().max()), float(dist.max()),
                kappa * norm2 ** 0.5 / float(np.sqrt(np.square(v, dtype=np.float64).sum())))

    def generic_path(tag, v, block, local, timed, ref, jax_ref):
        """compress -> decompress of `v` at `block` on the default device:
        the route's launches; the size within 1 % of native's codec on the
        same input (`ref`, the future of `native_ref`) and, where given,
        within max(64 B, 1 %) of the JAX package's record `jax_ref` (level
        3: its dense products round otherwise than native's cascade, which
        the port runs on every route); the quantized
        coefficients against native's (`steps`); err and SNR within 2 % and
        0.2 dB of native's where no coefficient steps, else within what the
        steps can move them, and of the JAX record where neither the port's
        nor the JAX package's coefficients step; interop both ways; with
        `timed`, the medians of 3 (and, under the global RMS, one profiled
        window)."""
        names = (("stripe_fused_encode_local" if local else "stripe_fused_encode",
                  "stripe_fused_inverse")
                 if codec.route(v.shape, block) == "stripe_fused" else
                 ("plane_cascade_fwd", "tokenize_stripe", "plane_cascade_inv"))
        _kernels.reset_counts()
        d, r = cvt.compress(v, SCALE, block=block, use_local_rms=local)
        o = cvt.decompress(d)
        torch.cuda.synchronize()
        counts = dict(_kernels.launches)
        under_native = pool.submit(rle_host.host_decompress, d)
        want = {k: 1 for k in (*names, "block_emit", "plan_layout", *DECODE_KERNELS)}
        check(counts == {k: want.get(k, 0) for k in counts},
              f"{tag}: one launch each of {', '.join(names)}, block_emit and the decode "
              "kernels, none else")
        oh = o.cpu().numpy()
        del o
        check(oh.shape == v.shape and bool(np.isfinite(oh).all()),
              f"{tag}: decompressed volume finite, shape {v.shape}")
        err_g, snr_g = err_snr(v, oh)
        dn, rn, on, err_n, snr_n = ref.result()
        size_r, err_r, snr_r = jax_ref or (dn.size, err_n, snr_n)
        check(abs(d.size - dn.size) <= 0.01 * dn.size,
              f"{tag}: ratio {r:.1f} ({d.size} B) within 1 % of native's {dn.size} B "
              f"({(d.size - dn.size) / dn.size:+.4%})")
        if jax_ref:  # the JAX package's dense products: level 3 of ROADMAP.md
            check(abs(d.size - size_r) <= max(64, 0.01 * size_r),
                  f"{tag}: {d.size} B within max(64 B, 1 %) of the JAX package's "
                  f"{size_r} B ({(d.size - size_r) / size_r:+.4%})")
        n, dmax, dist, moved = steps(v, block, local, dn)
        check(dmax <= 1 and dist <= 1e-5,
              f"{tag}: quantized coefficients equal to native's but {n}, each one step "
              f"away where the port's scaled value sits within {dist:.2e} (<= 1e-5) of "
              f"the step, relative to its block's largest")
        # err and SNR against native's: equal coefficients leave only the
        # transforms' last bits (2 %, 0.2 dB); steps move the reconstruction
        # by at most `moved` (and the transforms' rounding, 1e-6), so err by
        # at most as much
        if n:
            tol = moved + 1e-6
            ok = abs(err_g - err_n) <= tol and abs(snr_g - snr_n) <= 20 * np.log10(
                1 + tol / min(err_g, err_n))
            bar = f"within the {tol:.3e} the steps can move err from native's"
        else:
            ok = abs(err_g / err_n - 1) <= 0.02 and abs(snr_g - snr_n) <= 0.2
            bar = "within 2 % and 0.2 dB of native's"
        check(ok, f"{tag}: err {err_g:.4e}, SNR {snr_g:.2f} dB {bar} ({err_n:.4e}, "
              f"{snr_n:.2f} dB)")
        if jax_ref:
            # against the JAX record: 2 %, 0.2 dB where neither the port's
            # coefficients step from native's nor the JAX package's (its err
            # over 2 % from native's; tests/test_torch_generic.py shows such
            # steps at (8, 8, 1) under the local RMS); else the steps decide
            jax_steps = abs(err_r / err_n - 1) > 0.02
            if n or jax_steps:
                print(f"  {tag}: err {err_g:.4e}, SNR {snr_g:.2f} dB beside the JAX "
                      f"package's {err_r:.4e}, {snr_r:.2f} dB: not held to 2 %, the "
                      f"{'port' if n else 'JAX package'}'s coefficients step")
            else:
                check(abs(err_g / err_r - 1) <= 0.02 and abs(snr_g - snr_r) <= 0.2,
                      f"{tag}: err {err_g:.4e}, SNR {snr_g:.2f} dB within 2 % and "
                      f"0.2 dB of the JAX package's {err_r:.4e}, {snr_r:.2f} dB")
        e1 = rel_rms(torch.from_numpy(under_native.result()), torch.from_numpy(oh))
        e2 = rel_rms(cvt.decompress(dn, engine="device").cpu(), torch.from_numpy(on))
        check(e1 < TRANSFORM_TOL and e2 < TRANSFORM_TOL,
              f"{tag}: the port's container decodes under native (rel RMS {e1:.3e}), "
              f"native's on the device engine ({e2:.3e})")
        res = dict(ratio=r, err=err_g, snr_db=snr_g, native_ratio=rn, native_err=err_n,
                   native_snr_db=snr_n, steps=n)
        if jax_ref:
            res.update(jax_bytes=size_r, jax_err=err_r, jax_snr_db=snr_r)
        if local:
            mf, mfn = cvt.container.unpack(d)[2], cvt.container.unpack(dn)[2]
            rt = float(np.max(np.abs(mf.astype(np.float64) / mfn - 1.0)))
            check(rt < 1e-5, f"{tag}: table within rtol {rt:.2e} of native's "
                  f"({int((mf == mfn).sum())} of {mf.size} bit-equal)")
            res["table_rtol"] = rt
        del dn, on
        if timed:
            e = rel_rms(torch.from_numpy(oh), cvt.decompress(d, engine="host").cpu())
            check(e < TRANSFORM_TOL, f"{tag}: engine device within rel RMS {e:.3e} "
                  "of engine host")
            res.update(timed_path(tag, v, block, d, local=local, runs=3,
                                  profile=not local))
        torch.cuda.empty_cache()
        return counts, res

    counts_e, res_e = {}, {}
    # timed: every A case; at S the fused stripe route's 16^3 under the global RMS
    for v, cases, prefix, timed in (
            (vol, tuple((b, lo) for b in BLOCKS_A for lo in (False, True)), "A", None),
            (vol_s, CASES_S, "S", ("16x16x16 global",))):
        cases = [(f"{'x'.join(map(str, b))} {'local' if lo else 'global'}", b, lo)
                 for b, lo in cases]
        refs = {key: native_ref(v, prefix, b, lo) for key, b, lo in cases}
        if timed is None:  # every reference made before the first timed path
            # (B's for phase 3f too)
            native_ref(vol_b, "B", BLOCK_B, False)
            for f in (*refs.values(), *natives.values()):
                f.result()
        print(f"  {prefix}: native references submitted, at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        for key, b, lo in cases:
            tag = f"{prefix} {key}"
            counts_e[tag], res_e[tag] = generic_path(
                tag, v, b, lo, timed is None or key in timed, refs.pop(key),
                REF_S[key] if prefix == "S" else None)
            print(f"  {tag} done at {time.perf_counter() - t_start:.1f} s", flush=True)
    del vol_s

    # -- phase 3f: the JAX package's encode switches through the public API
    print(f"  at {time.perf_counter() - t_start:.1f} s", flush=True)
    print("phase 3f: the opt-in encode routes (CVX_FUSED_W, CVX_STRIPE=patch, "
          "CVX_FUSED_COMPACT), compress -> decompress (default device, engine auto = "
          "device) on", name, flush=True)
    t_phase = time.perf_counter()
    switches = ("CVX_FUSED_COMPACT", "CVX_STRIPE", "CVX_FUSED_W")
    default_encode = ("fused_encode", "fused_encode_local", "block_fwd_z",
                      "block_encode_xy", "block_casc_local", "block_scale_tok",
                      "stripe_fused_encode", "stripe_fused_encode_local", "block_emit")

    def switch_path(tag, env, v, prefix, block, local, kernels, same_as=None,
                    ref_ratio=None):
        """compress -> decompress of `v` at `block` under the switch `env`:
        the route's kernels launch and no default encode kernel; the
        container equal to `same_as` (the default route's, where the
        coefficients are the same) or else the ratio within 1 % of native's
        on the same input (and of `ref_ratio`, the JAX record) and the CI
        bars; both engines; interop with native."""
        for k in switches:
            os.environ.pop(k, None)
        os.environ.update(env)
        try:
            _kernels.reset_counts()
            d, r = cvt.compress(v, SCALE, block=block, use_local_rms=local)
            o = cvt.decompress(d)
            torch.cuda.synchronize()
            counts = dict(_kernels.launches)
            vdev = torch.from_numpy(v).to(dev)
            ms, _ = wall_ms(lambda: (cvt.compress(vdev, SCALE, block=block,
                                                  use_local_rms=local),
                                     torch.cuda.synchronize()), 3)
            del vdev
        finally:
            for k in env:
                os.environ.pop(k)
        print(f"  {tag}: launches {({k: n for k, n in counts.items() if n})}")
        check(all(counts[k] > 0 for k in kernels + DECODE_KERNELS)
              and not any(counts[k] for k in default_encode if k not in kernels),
              f"{tag}: {', '.join(kernels)} and the decode kernels launched, no other "
              "encode kernel")
        oh = o.cpu().numpy()
        del o
        check(oh.shape == v.shape and bool(np.isfinite(oh).all()),
              f"{tag}: decompressed volume finite, shape {v.shape}")
        err_s, snr_s = err_snr(v, oh)
        dn, rn, on, err_n, snr_n = native_ref(v, prefix, block, local).result()
        if same_as is not None:
            check(np.array_equal(d, same_as), f"{tag}: container ({d.size} B) byte-equal "
                  "to the default route's")
        else:
            check(err_s < 2e-4 and snr_s > 75.0, f"{tag}: err {err_s:.4e} < 2e-4, SNR "
                  f"{snr_s:.2f} dB > 75")
            check(abs(r - rn) / rn < 0.01 and (ref_ratio is None
                                               or abs(r - ref_ratio) / ref_ratio < 0.01),
                  f"{tag}: ratio {r:.1f} within 1 % of native's {rn:.1f}"
                  + (f" and of {ref_ratio}" if ref_ratio else ""))
        e1 = rel_rms(torch.from_numpy(oh), cvt.decompress(d, engine="host").cpu())
        e2 = rel_rms(torch.from_numpy(rle_host.host_decompress(d)), torch.from_numpy(oh))
        e3 = rel_rms(cvt.decompress(dn, engine="device").cpu(), torch.from_numpy(on))
        check(max(e1, e2, e3) < TRANSFORM_TOL, f"{tag}: engine device within rel RMS "
              f"{e1:.3e} of engine host; the container under native {e2:.3e}; native's "
              f"on the device engine {e3:.3e}")
        print(f"  {tag}: ratio {r:.1f}, err {err_s:.4e}, SNR {snr_s:.2f} dB; compress of "
              f"the volume on the card, median of 3, {ms:.2f} ms on {card}")
        torch.cuda.empty_cache()
        return counts, dict(ratio=r, err=err_s, snr_db=snr_s, native_ratio=rn,
                            compress_resident_ms=ms, **({} if same_as is None else
                                                        {"container_equal": True}))

    def default_container(v, block):
        for k in switches:
            os.environ.pop(k, None)
        return cvt.compress(v, SCALE, block=block)[0]

    counts_f, res_f = {}, {}
    for tag, env, v, prefix, block, local, kernels, equal_to, ref in (
            ("B CVX_FUSED_W=1", {"CVX_FUSED_W": "1"}, vol_b, "B", BLOCK_B, False,
             ("block_fwd_xz", "block_encode_y", "block_emit"), data_b, None),
            ("B CVX_FUSED_W=0", {"CVX_FUSED_W": "0"}, vol_b, "B", BLOCK_B, False,
             ("plane_cascade_fwd", "tokenize_stripe", "block_emit"), None, REF_B["ratio"]),
            ("A CVX_STRIPE=patch", {"CVX_STRIPE": "patch"}, vol, "A", (32, 32, 32), False,
             ("plane_cascade_fwd", "tokenize_stripe", "patch_extract", "block_emit_rows"),
             None, REF_RATIO),
            ("A-64^3 CVX_STRIPE=patch", {"CVX_STRIPE": "patch"}, vol, "A", (64, 64, 64),
             False, ("plane_cascade_fwd", "tokenize_stripe", "patch_extract",
                     "block_emit_rows", "plane_cascade_inv"),
             default_container(vol, (64, 64, 64)), None),
            ("A CVX_FUSED_COMPACT=1", {"CVX_FUSED_COMPACT": "1"}, vol, "A", (32, 32, 32),
             False, ("plane_cascade_fwd", "tokenize_compact", "block_emit_rows"), None,
             REF_RATIO),
            ("A-local CVX_FUSED_COMPACT=1", {"CVX_FUSED_COMPACT": "1"}, vol, "A",
             (32, 32, 32), True, ("plane_cascade_fwd", "tokenize_compact",
                                  "block_emit_rows"), None, None),
            ("B CVX_FUSED_COMPACT=1", {"CVX_FUSED_COMPACT": "1"}, vol_b, "B", BLOCK_B,
             False, ("plane_cascade_fwd", "tokenize_compact", "block_emit_rows"), None,
             REF_B["ratio"])):
        counts_f[tag], res_f[tag] = switch_path(tag, env, v, prefix, block, local,
                                                kernels, equal_to, ref)
    pool.shutdown()

    # the caller's TF32: the stripe route's transform is a cascade, no matmul
    d_hi = default_container(vol, (8, 8, 8))
    torch.set_float32_matmul_precision("high")
    try:
        d_tf = cvt.compress(vol, SCALE, block=(8, 8, 8))[0]
        kept = torch.get_float32_matmul_precision()
    finally:
        torch.set_float32_matmul_precision("highest")
    check(kept == "high" and np.array_equal(d_tf, d_hi),
          "A-8^3 under the caller's set_float32_matmul_precision('high'): container "
          "equal to the one made under 'highest', the caller's setting kept")
    res_f["tf32_container_equal"] = True
    print(f"  phase 3f {time.perf_counter() - t_phase:.1f} s", flush=True)

    # -- phase 3g: the batched codecs, the streams and the snapshot stack --
    print(f"  at {time.perf_counter() - t_start:.1f} s", flush=True)
    print("phase 3g: compress_many / decompress_many, the streams and "
          "DeviceSnapshotStack at", SHAPE, "and", SHAPE_B, "on", name, flush=True)
    t_phase = time.perf_counter()
    res_g = phase_3g(torch, cvt, codec, pipeline, _kernels, dev, card)
    print(f"  phase 3g {time.perf_counter() - t_phase:.1f} s", flush=True)
    check("jax" not in sys.modules, "the port imported no jax after phase 3g")

    # -- phase 3h: the multi-device layer ----------------------------------
    print(f"  at {time.perf_counter() - t_start:.1f} s", flush=True)
    print("phase 3h: parallel.compress / decompress over 4 shards on one card and "
          "the default mesh, multihost in two processes, module_tests --quick, the "
          "integration test, on", name, flush=True)
    t_phase = time.perf_counter()
    res_h = phase_3h(torch, cvt, codec, _kernels, dev, card)
    print(f"  phase 3h {time.perf_counter() - t_phase:.1f} s", flush=True)
    check("jax" not in sys.modules, "the port imported no jax after phase 3h")

    # -- phase 3i: the stripe, patch and compact routes on native's cascade,
    # the tools, the module tests' throughput stages
    print(f"  at {time.perf_counter() - t_start:.1f} s", flush=True)
    print("phase 3i: plane_cascade_fwd / plane_cascade_inv against their plain "
          "versions, the stripe, patch and compact routes against native's parity "
          "codec, fault 8's inputs, the tools and module_tests --quick, on", name,
          flush=True)
    t_phase = time.perf_counter()
    rows_i, res_i = phase_3i(torch, cvt, _kernels, dev, card, vol, res_h)
    report.update(rows_i)
    print(f"  phase 3i {time.perf_counter() - t_phase:.1f} s", flush=True)
    check("jax" not in sys.modules, "the port imported no jax after phase 3i")

    for k, r in report.items():
        print(f"  {k}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}) on {card}")

    meta = {
        "fused_encode": ("csrc/fused_encode.cu",
                         "cvxcompress_tpu/ops/tokenize_pallas.py:939", None),
        "fused_inverse": ("csrc/fused_inverse.cu",
                          "cvxcompress_tpu/ops/fused_inverse.py:128", None),
        "decode_maps": ("csrc/decode_maps.cu",
                        "cvxcompress_tpu/ops/entropy_decode.py:336", None),
        "decode_chase": ("csrc/decode_chase.cu",
                         "cvxcompress_tpu/ops/entropy_decode.py:258", None),
        "decode_emit": ("csrc/decode_emit.cu",
                        "cvxcompress_tpu/ops/entropy_decode.py:733",
                        "cvxcompress_tpu/ops/codec.py:856"),
        # no TPU kernel: the host plan's ragged copy and subsegment tables
        "plan_layout": ("csrc/plan_layout.cu",
                        "none (the host plan, cvxcompress_tpu/ops/entropy_decode.py:140)",
                        None),
        "block_fwd_z": ("csrc/block_encode.cu",
                        "cvxcompress_tpu/ops/fused_compress.py:422", None),
        "block_encode_xy": ("csrc/block_encode.cu",
                            "cvxcompress_tpu/ops/fused_compress.py:422", None),
        "block_emit": ("csrc/block_emit.cu",
                       "cvxcompress_tpu/ops/pack_pallas.py:515",
                       "cvxcompress_tpu/ops/pack_pallas.py:479, "
                       "cvxcompress_tpu/ops/pack_pallas.py:605"),
        "block_inv_xy": ("csrc/block_inverse.cu",
                         "cvxcompress_tpu/ops/fused_inverse.py:65", None),
        "block_inv_z": ("csrc/block_inverse.cu",
                        "cvxcompress_tpu/ops/fused_inverse.py:65", None),
        "fused_encode_local": ("csrc/fused_encode.cu",
                               "cvxcompress_tpu/ops/tokenize_pallas.py:907", None),
        "block_casc_local": ("csrc/block_encode_local.cu",
                             "cvxcompress_tpu/ops/fused_compress.py:312",
                             "cvxcompress_tpu/ops/fused_compress.py:361"),
        "block_scale_tok": ("csrc/block_encode_local.cu",
                            "cvxcompress_tpu/ops/fused_compress.py:395",
                            "cvxcompress_tpu/ops/fused_compress.py:361"),
        "tokenize_stripe": ("csrc/tokenize_stripe.cu",
                            "cvxcompress_tpu/ops/tokenize_pallas.py:744",
                            "cvxcompress_tpu/ops/tokenize_pallas.py:437, "
                            "cvxcompress_tpu/ops/tokenize_pallas.py:391, "
                            "cvxcompress_tpu/ops/tokenize_pallas.py:1170"),
        "stripe_fused_encode": ("csrc/stripe_fused.cu",
                                "cvxcompress_tpu/ops/tokenize_pallas.py:939", None),
        "stripe_fused_encode_local": ("csrc/stripe_fused.cu",
                                      "cvxcompress_tpu/ops/tokenize_pallas.py:907", None),
        "stripe_fused_inverse": ("csrc/stripe_fused.cu",
                                 "cvxcompress_tpu/ops/fused_inverse.py:128", None),
        "block_fwd_xz": ("csrc/block_encode_w.cu",
                         "cvxcompress_tpu/ops/fused_compress.py:71", None),
        "block_encode_y": ("csrc/block_encode_w.cu",
                           "cvxcompress_tpu/ops/fused_compress.py:144", None),
        "patch_extract": ("csrc/patch_extract.cu",
                          "cvxcompress_tpu/ops/pack_pallas.py:94", None),
        "block_emit_rows": ("csrc/block_emit.cu",
                            "cvxcompress_tpu/ops/pack_pallas.py:515", None),
        "tokenize_compact": ("csrc/tokenize_compact.cu",
                             "cvxcompress_tpu/ops/tokenize_pallas.py:1313", None),
        # no Pallas kernel: the XLA products of the stripe route's transforms
        "plane_cascade_fwd": ("csrc/plane_cascade.cu",
                              "cvxcompress_tpu/ops/wavelet.py:249", None),
        "plane_cascade_inv": ("csrc/plane_cascade.cu",
                              "cvxcompress_tpu/ops/codec.py:1151", None),
    }
    kernels = []
    for k, r in report.items():
        src, rep, also = meta[k]
        # launches on the path's own drive: the switches' drives for their
        # kernels (B under CVX_FUSED_W=1, A under CVX_STRIPE=patch and
        # CVX_FUSED_COMPACT=1), the local paths for theirs, config B for the
        # other 128^3 kernels, A at 64^3 for the stripe tokenize, S at 16^3
        # for the fused stripe kernels, A for the rest (block_emit included)
        launches = (counts_f["B CVX_FUSED_W=1"][k]
                    if k in ("block_fwd_xz", "block_encode_y")
                    else counts_f["A CVX_STRIPE=patch"][k]
                    if k in ("patch_extract", "block_emit_rows")
                    else counts_f["A CVX_FUSED_COMPACT=1"][k] if k == "tokenize_compact"
                    else counts_e["A 64x64x64 global"][k]
                    if k in ("tokenize_stripe", "plane_cascade_fwd", "plane_cascade_inv") else
                    counts_e["S 16x16x16 local"][k] if k == "stripe_fused_encode_local"
                    else counts_e["S 16x16x16 global"][k] if k.startswith("stripe_fused")
                    else counts_c[k] if k == "fused_encode_local" else
                    counts_a[k] if k in KERNELS_A else
                    counts_d[k] if k in KERNELS_D and k not in KERNELS_B else
                    counts_b[k] if k in KERNELS_B else counts_a[k])
        # a library call only for the transform kernels (einsum3; the x, z
        # einsum for block_fwd_xz); no single PyTorch call computes the
        # others' functions (PERF.md)
        row = {"name": k, "route": "cuda",
               "source": f"cvxcompress_tpu_torch/{src}", "replaces": rep,
               "launches": launches, "max_abs_err": r["max_abs_err"],
               "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r.get("library_ms")}
        for extra in ("noise_ms", "noise_plain_ms", "ramp_ms", "ramp_plain_ms", "inputs",
                      "in_place_ms", "library_call", "noise_library_ms", "einsum3_ms",
                      "chunk_sparse_ms", "chunk_sparse_bound_ms", "device_ms",
                      "noise_device_ms", "noise_bound_ms", "zeroing_device_ms",
                      "noise_zeroing_device_ms", "half_zero_ms", "half_zero_plain_ms",
                      "half_zero_bound_ms", "base_ms", "host_plan_ms", "device_plan_ms"):
            if extra in r:
                row[extra] = r[extra]
        if also:
            row["also_replaces"] = also
        sharded = {tag: cnt[k] for tag, cnt in res_h["launches"].items() if cnt.get(k)}
        if sharded:  # phase 3h: the launches of each sharded call
            row["sharded_launches"] = sharded
        kernels.append(row)
    print(f"  chip_smoke.py ran {time.perf_counter() - t_start:.1f} s on {card}")
    print(card)
    print(json.dumps({"kernels": kernels, "card": card,
                      "config_a": dict(ratio=ratio, err=err, snr_db=snr, **res_a),
                      "config_b": dict(ratio=ratio_b, err=err_b, snr_db=snr_b,
                                       **res_b),
                      "config_a_local": res_c, "config_b_local": res_d,
                      "other_geometries": res_e, "optin_routes": res_f,
                      "kernel_phase_e2e_ms": e2e, "batched_streams_snapshots": res_g,
                      "multi_device": res_h, "plane_cascade_tools": res_i,
                      "encode_128_split_ms": dict(zip(
                          ("z|xy", "xz|y", "xz|y again", "z|xy again"), split_ms))}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
