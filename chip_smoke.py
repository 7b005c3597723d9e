#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels (csrc/, nvcc for sm_90a) and the native host library
(make -C native), compares every kernel of the main path with its plain
PyTorch version at the reference CI shape, then drives the main path once
through the public API — compress the (352, 416, 320) sinusoid at scale
1e-2 with 32^3 blocks on the card, decompress it (host entropy decode +
inverse on the card) — and checks the quality bars, the launch counts and
the interop with the native C ABI.  It imports nothing of JAX.

Output: the card's name and power limit first, progress lines, then on
the line before the last a JSON object with each kernel's launches, error
and time beside its plain version's, and on the last line
{"ok": true, "device": {...}}.  Any failed check raises (exit code != 0)
and prints no result; so does a machine without a CUDA card.  A profiler
trace of one compress + decompress goes to build/chip_smoke_trace.json.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

SHAPE = (352, 416, 320)  # (nz, ny, nx), the reference CI volume
SCALE = 1e-2
PERIODS = 10
REF_RATIO = 1148.6  # the JAX package's record on this input
TRANSFORM_TOL = 1e-5  # relative RMS, the reference's fast-vs-slow bar


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")
    print(f"  ok: {msg}", flush=True)


def sinusoid(nz, ny, nx, periods):
    """vol[z, y, x] = sin(z*pi*periods/nz) (Test_With_Generated_Input.cpp)."""
    z = np.sin(np.arange(nz) * np.pi * periods / nz).astype(np.float32)
    return np.broadcast_to(z[:, None, None], (nz, ny, nx)).copy()


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


def wall_ms(fn, runs):
    """Median host-clock time of fn() (which synchronises) over `runs`."""
    times = []
    for _ in range(runs):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times), times


def main():
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
    from cvxcompress_tpu_torch.ops import (
        _kernels, codec, fused_inverse, pack, quant, rle_device, rle_host,
        tokenize,
    )

    check("jax" not in sys.modules, "the port imported no jax")
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")

    # -- phase 1: build ---------------------------------------------------
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

    # -- phase 2: each kernel against its plain version, CI shape ---------
    print("phase 2: kernels vs plain versions at", SHAPE, flush=True)
    vol = sinusoid(*SHAPE, PERIODS)
    vt = torch.from_numpy(vol).to(dev)
    mulfac = quant.global_mulfac(vol, SCALE)
    report = {}

    ck, dk, sk, rk = tokenize.fused_encode(vt, mulfac)
    cp, dp, sp, rp = tokenize.fused_encode_plain(vt, mulfac)
    torch.cuda.synchronize()
    e = rel_rms(ck, cp)
    check(e < TRANSFORM_TOL, f"fused_encode coefficients rel RMS {e:.3e} < 1e-5")
    d2, s2, r2 = rle_device.tokenize(tokenize.scaled(ck, mulfac))
    check(torch.equal(sk, s2) and torch.equal(rk, r2),
          "fused_encode sizes/raw bit-equal to the plain tokenize of its coefficients")
    check(torch.equal(dk, d2), "fused_encode descriptors bit-equal likewise")
    report["fused_encode"] = dict(
        max_abs_err=float((ck - cp).abs().max()),
        ms=cuda_ms(lambda: tokenize.fused_encode(vt, mulfac), 20),
        plain_ms=cuda_ms(lambda: tokenize.fused_encode_plain(vt, mulfac), 3),
    )
    del cp, dp, sp, rp, d2, s2, r2

    nr = torch.where(rk, 0, sk).to(torch.int64)
    base = torch.cumsum(nr, 0) - nr
    total = int(nr.sum())
    stk = pack.emit_payload(ck, mulfac, dk, base, rk, total)
    stp = pack.emit_payload_plain(ck, mulfac, dk, base, rk, total)
    check(torch.equal(stk, stp), f"emit_payload stream ({total} B) bit-equal to plain")
    streams, nsizes, nraw = rle_host.encode_payloads(ck.cpu().numpy(), mulfac)
    native = np.concatenate([s for s, r in zip(streams, nraw) if not r])
    check(np.array_equal(nraw, rk.cpu().numpy())
          and np.array_equal(nsizes, sk.cpu().numpy().astype(np.int64)),
          "native cvx_encode_payloads sizes/raw equal the kernel's")
    check(np.array_equal(native, stk.cpu().numpy()),
          "stream bit-equal to native cvx_encode_payloads, block by block")
    report["emit_payload"] = dict(
        max_abs_err=float((stk.int() - stp.int()).abs().max()) if total else 0.0,
        ms=cuda_ms(lambda: pack.emit_payload(ck, mulfac, dk, base, rk, total), 20),
        plain_ms=cuda_ms(
            lambda: pack.emit_payload_plain(ck, mulfac, dk, base, rk, total), 3),
    )
    del ck, dk, stk, stp

    data, _ = codec.compress(vt, SCALE)
    hdr, blkoffs, _, pbase = cvt.container.unpack(data)
    dec = rle_host.decode_payloads(data[pbase:], blkoffs, hdr.glob_mulfac,
                                   codec.CELLS)
    rows_h, invmap_h = codec.sparse_chunks(dec)
    rows, invmap = torch.from_numpy(rows_h).to(dev), torch.from_numpy(invmap_h).to(dev)
    vk = fused_inverse.fused_inverse(rows, invmap, SHAPE)
    vp = fused_inverse.fused_inverse_plain(rows, invmap, SHAPE)
    torch.cuda.synchronize()
    e = rel_rms(vk, vp)
    check(e < TRANSFORM_TOL, f"fused_inverse rel RMS {e:.3e} < 1e-5 "
          f"({rows_h.shape[0]} of {invmap_h.size} chunks non-zero)")
    report["fused_inverse"] = dict(
        max_abs_err=float((vk - vp).abs().max()),
        ms=cuda_ms(lambda: fused_inverse.fused_inverse(rows, invmap, SHAPE), 20),
        plain_ms=cuda_ms(
            lambda: fused_inverse.fused_inverse_plain(rows, invmap, SHAPE), 3),
    )
    del vk, vp, vt

    # -- phase 3: the main path through the public API --------------------
    print("phase 3: main path, compress -> decompress on", name, flush=True)
    _kernels.reset_counts()
    data, ratio = cvt.compress(vol, SCALE, block=(32, 32, 32), device="cuda")
    out = cvt.decompress(data, device="cuda")
    torch.cuda.synchronize()
    counts = dict(_kernels.launches)
    print(f"  launches on the main path: {counts}")
    check(all(counts[k] > 0 for k in report), "every kernel launched on the main path")
    out_h = out.cpu().numpy()
    check(out_h.shape == SHAPE and bool(np.isfinite(out_h).all()),
          f"decompressed volume finite, shape {SHAPE}")
    err, snr = err_snr(vol, out_h)
    check(err < 2e-4 and snr > 75.0, f"err {err:.4e} < 2e-4, SNR {snr:.2f} dB > 75")
    check(abs(ratio - REF_RATIO) / REF_RATIO < 0.01,
          f"ratio {ratio:.1f} within 1% of {REF_RATIO}")
    nat = rle_host.host_decompress(data)
    e = rel_rms(torch.from_numpy(nat), torch.from_numpy(out_h))
    check(e < TRANSFORM_TOL, f"port container decodes under native "
          f"cvx_decompress_outofplace within rel RMS {e:.3e}")
    dn, rn = rle_host.host_compress(vol, SCALE)
    outn = cvt.decompress(dn, device="cuda").cpu().numpy()
    e = rel_rms(torch.from_numpy(outn), torch.from_numpy(rle_host.host_decompress(dn)))
    check(e < TRANSFORM_TOL, f"native cvx_compress container (ratio {rn:.1f}) "
          f"decodes in the port within rel RMS {e:.3e} of native")

    def run_compress():
        cvt.compress(vol, SCALE, device="cuda")

    vdev = torch.from_numpy(vol).to(dev)

    def run_compress_resident():  # a volume already on the card
        cvt.compress(vdev, SCALE)

    def run_decompress():
        cvt.decompress(data, device="cuda")
        torch.cuda.synchronize()

    run_compress()
    run_compress_resident()
    c_med, c_all = wall_ms(run_compress, 5)
    r_med, r_all = wall_ms(run_compress_resident, 5)
    d_med, d_all = wall_ms(run_decompress, 5)
    mcells = vol.size / 1e6
    print(f"  compress   median {c_med:.2f} ms ({mcells / c_med * 1e3:.0f} MC/s) "
          f"runs {[round(x, 2) for x in c_all]} on {card}")
    print(f"  compress (volume on the card) median {r_med:.2f} ms "
          f"({mcells / r_med * 1e3:.0f} MC/s) runs {[round(x, 2) for x in r_all]} "
          f"on {card}")
    print(f"  decompress median {d_med:.2f} ms ({mcells / d_med * 1e3:.0f} MC/s) "
          f"runs {[round(x, 2) for x in d_all]} on {card}")
    for k, r in report.items():
        print(f"  {k}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms "
              f"on {card}")

    # one profiled compress + decompress: host spans, kernel device time,
    # device idle share of the window
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run_compress()
        run_decompress()
        window_us = (time.perf_counter() - t) * 1e6
    trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "chip_smoke_trace.json"))
    cpu_t, cuda_t = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    spans = {ev.key: round(ev.cpu_time_total / 1e3, 3) for ev in prof.key_averages()
             if ev.key.startswith("cvx.") and ev.device_type == cpu_t}
    # device busy = union of the kernels' and copies' intervals (user spans
    # mirrored onto the device timeline and profiler bookkeeping excluded)
    busy = sorted(
        (ev.time_range.start, ev.time_range.end) for ev in prof.events()
        if ev.device_type == cuda_t and not ev.name.startswith("cvx.")
        and not getattr(ev, "is_user_annotation", False)
        and ev.name != "Activity Buffer Request"
    )
    busy_us, end = 0.0, float("-inf")
    for a, b in busy:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    idle = 1.0 - busy_us / window_us
    print(prof.key_averages().table(sort_by="cpu_time_total", row_limit=25))
    print(f"  profiled window {window_us / 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms, idle share {idle:.4f} on {card}")
    print(f"  host spans (ms): {spans}")

    meta = {
        "fused_encode": ("csrc/fused_encode.cu",
                         "cvxcompress_tpu/ops/tokenize_pallas.py:939", None),
        "emit_payload": ("csrc/emit_payload.cu",
                         "cvxcompress_tpu/ops/pack_pallas.py:479",
                         "cvxcompress_tpu/ops/pack_pallas.py:605"),
        "fused_inverse": ("csrc/fused_inverse.cu",
                          "cvxcompress_tpu/ops/fused_inverse.py:128", None),
    }
    kernels = []
    for k, r in report.items():
        src, rep, also = meta[k]
        row = {"name": k, "route": "cuda",
               "source": f"cvxcompress_tpu_torch/{src}", "replaces": rep,
               "launches": counts[k], "max_abs_err": r["max_abs_err"],
               "ms": r["ms"], "plain_ms": r["plain_ms"]}
        if also:
            row["also_replaces"] = also
        kernels.append(row)
    print(json.dumps({"kernels": kernels, "compress_ms": c_med,
                      "compress_resident_ms": r_med, "decompress_ms": d_med, "ratio": ratio, "err": err,
                      "snr_db": snr, "card": card, "spans_ms": spans,
                      "device_idle_share": idle}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
