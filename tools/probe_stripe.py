#!/usr/bin/env python3
"""Break the fused stripe kernels' earlier design down on one NVIDIA card.

    python3 tools/probe_stripe.py

Builds tools/probe_stripe.cu (the fused stripe kernels as they were before
the parity cascade: dense per-axis operator products, 16,384-cell tiles in
shared memory or, for a block over a tile, one CTA per block in device
memory, a 64-cell tokenize walk per thread, with a mask of the phases to
keep) and times with CUDA events (chip_smoke.py `cuda_ms`), at S-16^3 (the
256^3 sinusoid, 16^3 blocks) and A-(64, 32, 32) (config A's sinusoid):
the encode's load alone; with the x pass; x and y; x, y and z; with the
coefficient store; the whole kernel (table and tokenize); the load, the
store and the tokenize without the passes; the same under the local RMS
(whole kernel); the inverse's load alone, with the volume store, with the
x pass, x and y, and whole.  Each whole kernel's outputs are held within
1e-5 (relative RMS) of this checkout's.  Prints the card's name and power
limit, one line per time, and on the last line one JSON object with the
times in ms.
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

X, Y, Z, STORE, TOK = 1, 2, 4, 8, 16
ENCODE = {"load alone": 0, "load, x": X, "load, x, y": X | Y, "load, x, y, z": X | Y | Z,
          "load, x, y, z, coefficient store": X | Y | Z | STORE,
          "whole kernel": X | Y | Z | STORE | TOK,
          "load, coefficient store, table and tokenize": STORE | TOK}
INVERSE = {"load alone": 0, "load, volume store": STORE, "load, x, store": X | STORE,
           "load, x, y, store": X | Y | STORE, "whole kernel": X | Y | Z | STORE}


def build():
    from cvxcompress_tpu_torch.ops import _kernels

    out = os.path.join(ROOT, "build", "probe")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libprobe_stripe.so")
    res = subprocess.run([_kernels._nvcc(), *_kernels.ARCH_FLAGS, "-std=c++17", "-O3",
                          "-Xcompiler", "-fPIC", "-shared", "-I", _kernels.SRC_DIR, "-o", so,
                          os.path.join(ROOT, "tools", "probe_stripe.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        print(res.stdout + res.stderr)
        raise RuntimeError("nvcc failed")
    lib = ctypes.CDLL(so)
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.probe_old_encode.argtypes = [i, i, vp, i, i, i, i, i, i, vp, vp, vp, f, vp, vp, vp,
                                     vp, vp, vp]
    lib.probe_old_inverse.argtypes = [i, vp, i, i, i, i, i, i, vp, vp, vp, vp, vp, vp]
    return lib


def main():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    import math

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from cvxcompress_tpu_torch.ops import blocks, fused_inverse, geometry, quant, tokenize
    from cvxcompress_tpu_torch.ops import wavelet

    lib = build()
    dev = torch.device("cuda")
    st = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def run(rc):
        if rc:
            raise RuntimeError(f"probe launch failed: cudaError {rc}")

    res = {}
    for cell, shape, block in (("S-16^3", cs.SHAPE_S, (16, 16, 16)),
                               ("A-(64, 32, 32)", cs.SHAPE, (64, 32, 32))):
        vol = cs.sinusoid(*shape, cs.PERIODS)
        vt = torch.from_numpy(vol).to(dev)
        nz, ny, nx = shape
        cells = math.prod(block)
        nnn = math.prod(blocks.grid_shape(shape, block))
        mf = quant.global_mulfac(vol, cs.SCALE)
        lg = geometry.log2_block(block)
        fops = [wavelet.operator(n, False, dev).t().contiguous() for n in block]
        iops = [wavelet.operator(n, True, dev).t().contiguous() for n in block]
        coeffs = torch.empty((nnn, cells), dtype=torch.float32, device=dev)
        desc = torch.empty((nnn, cells), dtype=torch.int32, device=dev)
        cbytes = torch.empty(nnn * cells // 128, dtype=torch.int32, device=dev)
        sizes = torch.empty(nnn, dtype=torch.int32, device=dev)
        mfs = torch.empty(nnn, dtype=torch.float32, device=dev)
        out = torch.empty_like(vt)
        work = torch.empty_like(coeffs)

        def enc(parts, local=False):
            return lambda: run(lib.probe_old_encode(
                parts, int(local), vt.data_ptr(), nx, ny, nz, *lg,
                *(o.data_ptr() for o in fops), cs.SCALE if local else mf, coeffs.data_ptr(),
                desc.data_ptr(), cbytes.data_ptr(), sizes.data_ptr(), mfs.data_ptr(), st()))

        this = tokenize.stripe_fused_encode(vt, block, mf)
        enc(31)()
        torch.cuda.synchronize()
        e = cs.rel_rms(coeffs, this[0])
        cs.check(e < cs.TRANSFORM_TOL, f"{cell}: the earlier encode within rel RMS {e:.3e} "
                 "of this checkout's")
        dense = this[0].contiguous()

        def inv(parts):
            return lambda: run(lib.probe_old_inverse(
                parts, dense.data_ptr(), nx, ny, nz, *lg, *(o.data_ptr() for o in iops),
                work.data_ptr(), out.data_ptr(), st()))

        inv(15)()
        torch.cuda.synchronize()
        e = cs.rel_rms(out, fused_inverse.stripe_fused_inverse(dense, shape, block))
        cs.check(e < cs.TRANSFORM_TOL, f"{cell}: the earlier inverse within rel RMS "
                 f"{e:.3e} of this checkout's")
        timed = {**{f"encode: {k}": enc(p) for k, p in ENCODE.items()},
                 "encode: whole kernel, local RMS": enc(31, True),
                 **{f"inverse: {k}": inv(p) for k, p in INVERSE.items()}}
        res[cell] = {}
        for name, fn in timed.items():
            res[cell][name] = cs.cuda_ms(fn, 20)
            print(f"  {cell} {name}: {res[cell][name]:.4f} ms on {card}", flush=True)
        del vt, coeffs, desc, work, out, dense, this
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "ms": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
