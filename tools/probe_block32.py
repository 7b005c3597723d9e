#!/usr/bin/env python3
"""Break the 32^3 kernels' time down on one NVIDIA card.

    python3 tools/probe_block32.py

At config A (the (352, 416, 320) sinusoid, scale 1e-2, 32^3 blocks) it
times, with CUDA events (chip_smoke.py `cuda_ms`):
- the shipped launches `fused_encode`, `fused_encode_local` and
  `fused_inverse` (dense and chunk-sparse);
- the design they had before the cascade (tools/probe_block32.cu
  `probe_old_fwd`, `probe_old_inv`: one CTA per block, a dense 32x32
  operator per axis) cut into its phases: the load alone; the load and the coefficient store;
  the load, the three passes and the store; the whole kernel; the load of
  the coefficients with one and with two tokenize walks (the walk's cost
  is the difference); the inverse's gather and store alone, and whole;
- the shipped kernels' design cut the same way (`probe_new_fwd`,
  `probe_new_inv`: the TMA copies and the coefficient store alone; with
  the three cascades; the copies, the store and one or two tokenizes of
  the coefficient plane; the inverse's copies and volume store alone), and
  `fused_encode` on its 4-byte cp.async route (A at a misaligned view).
Prints the card's name and power limit, one line per time, and on the last
line one JSON object with the times in ms.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (helpers only; its main() is not run)

OLD_FWD = ("load alone", "load, coefficient store", "load, 3 passes, store",
           "whole kernel", "load, 1 tokenize walk", "load, 2 tokenize walks")
OLD_INV = ("gather, volume store", "whole kernel")
NEW_FWD = ("copies, coefficient store", "copies, 3 cascades, store",
           "copies, store, 1 tokenize", "copies, store, 2 tokenizes")


def build():
    from cvxcompress_tpu_torch.ops import _kernels

    out = os.path.join(ROOT, "build", "probe")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libprobe32.so")
    res = subprocess.run([_kernels._nvcc(), *_kernels.ARCH_FLAGS, "-std=c++17", "-O3",
                          "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v", "-I",
                          _kernels.SRC_DIR, "-o", so,
                          os.path.join(ROOT, "tools", "probe_block32.cu")],
                         capture_output=True, text=True)
    for line in (res.stdout + res.stderr).splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("  ptxas:", line.strip())
    if res.returncode:
        raise RuntimeError("nvcc failed")
    lib = ctypes.CDLL(so)
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.probe_old_fwd.argtypes = [i, vp, i, i, i, vp, f, vp, vp, vp, vp]
    lib.probe_old_inv.argtypes = [i, vp, vp, i, i, i, vp, vp]
    lib.probe_new_fwd.argtypes = [i, vp, i, i, i, f, vp, vp, vp, vp]
    lib.probe_new_inv.argtypes = [vp, i, i, i, vp, vp]
    return lib


def main():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from cvxcompress_tpu_torch.ops import blocks, codec, fused_inverse, quant, tokenize
    from cvxcompress_tpu_torch.ops import wavelet

    lib = build()
    dev = torch.device("cuda")
    vol = cs.sinusoid(*cs.SHAPE, cs.PERIODS)
    vt = torch.from_numpy(vol).to(dev)
    nz, ny, nx = vol.shape
    mf = quant.global_mulfac(vol, cs.SCALE)
    st = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    nnn = vol.size // 32 ** 3
    fop = wavelet.operator(32, False, dev)
    iop = wavelet.operator(32, True, dev)
    coeffs = torch.empty((nnn, 32 ** 3), dtype=torch.float32, device=dev)
    desc = torch.empty((nnn, 32 ** 3), dtype=torch.int32, device=dev)
    sizes = torch.empty(nnn, dtype=torch.int32, device=dev)
    out = torch.empty_like(vt)

    def run(rc):
        if rc:
            raise RuntimeError(f"probe launch failed: {rc}")

    def old_fwd(v, src):
        return lambda: run(lib.probe_old_fwd(v, src.data_ptr(), nx, ny, nz, fop.data_ptr(),
                                             mf, coeffs.data_ptr(), desc.data_ptr(),
                                             sizes.data_ptr(), st()))

    ck, dk, _, sk, _, _ = tokenize.fused_encode(vt, mf)
    old_fwd(3, vt)()
    torch.cuda.synchronize()
    e = cs.rel_rms(coeffs, ck)
    cs.check(e < cs.TRANSFORM_TOL, f"the earlier design's coefficients within rel RMS "
             f"{e:.3e} of the shipped kernel's")
    cs.check(torch.equal(sizes, sk), "the earlier design's sizes equal the shipped's")
    plane = blocks.from_blocks(ck.view(-1, 32, 32, 32), vol.shape, (32, 32, 32))
    rows = ck.view(-1, 128)
    flat = torch.empty(vol.size + 1, dtype=torch.float32, device=dev)
    misaligned = flat[1:].view(vol.shape)
    misaligned.copy_(vt)
    cs.check(torch.equal(tokenize.fused_encode(misaligned, mf)[0], ck),
             "the 4-byte route's coefficients equal the TMA route's")
    run(lib.probe_new_fwd(1, vt.data_ptr(), nx, ny, nz, mf, coeffs.data_ptr(),
                          desc.data_ptr(), sizes.data_ptr(), st()))
    cs.check(torch.equal(coeffs, ck), "the probe's cascades equal fused_encode's")
    rows_h, invmap_h = codec.sparse_chunks(rows.cpu().numpy())
    srows, sinv = torch.from_numpy(rows_h).to(dev), torch.from_numpy(invmap_h).to(dev)
    res = {}
    timed = {
        "fused_encode": lambda: tokenize.fused_encode(vt, mf),
        "fused_encode_local": lambda: tokenize.fused_encode(vt, scale=cs.SCALE),
        "fused_inverse dense": lambda: fused_inverse.fused_inverse(rows, None, vol.shape),
        "fused_inverse chunk-sparse": lambda: fused_inverse.fused_inverse(
            srows, sinv, vol.shape),
        **{f"earlier encode: {name}": old_fwd(v, plane if v >= 4 else vt)
           for v, name in enumerate(OLD_FWD)},
        **{f"earlier inverse: {name}": (lambda v=v: run(lib.probe_old_inv(
            v, rows.data_ptr(), iop.data_ptr(), nx, ny, nz, out.data_ptr(), st())))
           for v, name in enumerate(OLD_INV)},
        **{f"this encode: {name}": (lambda m=m: run(lib.probe_new_fwd(
            m, (plane if m >= 2 else vt).data_ptr(), nx, ny, nz, mf, coeffs.data_ptr(),
            desc.data_ptr(), sizes.data_ptr(), st())))
           for m, name in enumerate(NEW_FWD)},
        "this encode: the 4-byte cp.async route (A at a misaligned view)":
            lambda: tokenize.fused_encode(misaligned, mf),
        "this inverse: copies, volume store": lambda: run(lib.probe_new_inv(
            rows.data_ptr(), nx, ny, nz, out.data_ptr(), st())),
    }
    for name, fn in timed.items():
        res[name] = cs.cuda_ms(fn, 20)
        print(f"  {name}: {res[name]:.4f} ms on {card}", flush=True)
    res["fused_encode again"] = cs.cuda_ms(timed["fused_encode"], 20)
    print(f"  fused_encode again: {res['fused_encode again']:.4f} ms on {card}")
    print(json.dumps({"card": card, "config": "A", "ms": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
