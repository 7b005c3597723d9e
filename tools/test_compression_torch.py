#!/usr/bin/env python3
"""File-driven compress/decompress benchmark with error-volume dumps, on the
PyTorch port.

The port's counterpart of `tools/test_compression.py`, itself the
reference's Test_Compression CLI (Test_Compression.cpp:53-230): reads a raw
float32 volume (or synthesizes the radial test volume), round-trips it at a
given scale and block, reports timings, ratio and SNR, and optionally
writes the container, the error volume and text XZ slices of the input,
output and error (:24-39, :194-208).  On the card a stage is timed by CUDA
events (`utils/profiling.Timer`), elsewhere by the host clock; the best of
`--iters` round trips is reported.

    python tools/test_compression_torch.py --nz 51 --ny 101 --nx 151
        [--file vol.bin] [--scale 1e-2] [--block 32,32,32] [--local-rms]
        [--out compressed.cvx] [--dump-error err.bin] [--dump-slices PREFIX]
        [--iters N] [--device cuda|cpu] [--backend torch|native|oracle]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def dump_xz_slice(path, vol, y=None):
    """Text dump of the XZ plane at mid-y (Test_Compression.cpp:24-39)."""
    nz, ny, nx = vol.shape
    y = ny // 2 if y is None else y
    with open(path, "w") as f:
        for z in range(nz):
            for x in range(nx):
                f.write(f"{x} {z} {vol[z, y, x]:.6e}\n")
            f.write("\n")


def rel_error(vol, out):
    """(relative RMS error, SNR in dB) of `out` against `vol`, in f64."""
    o = vol.astype(np.float64)
    d = o - out.astype(np.float64)
    err = float(np.sqrt((d * d).mean()) / np.sqrt((o * o).mean()))
    return err, (float(-20 * np.log10(err)) if err > 0 else float("inf"))


def roundtrip(vol, scale, block, local_rms, device, backend, iters=1):
    """`iters` round trips on `device` / `backend`; returns (container,
    ratio, numpy volume out, best compress s, best decompress s)."""
    import cvxcompress_tpu_torch as cvt
    from cvxcompress_tpu_torch.utils import profiling

    t = profiling.Timer(device if backend == "torch" else "cpu")
    for _ in range(iters):
        with t.stage("c"):
            data, ratio = cvt.compress(vol, scale, block=block, use_local_rms=local_rms,
                                       device=device, backend=backend)
        with t.stage("d"):
            out = cvt.decompress(data, device=device, backend=backend)
    out = out.cpu().numpy() if hasattr(out, "cpu") else np.asarray(out)
    return data, ratio, out, t.best("c"), t.best("d")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--file", help="raw f32 volume (x fastest); synthetic if omitted")
    ap.add_argument("--nz", type=int, default=51)
    ap.add_argument("--ny", type=int, default=101)
    ap.add_argument("--nx", type=int, default=151)
    ap.add_argument("--scale", type=float, default=1e-2)
    ap.add_argument("--block", default="32,32,32")
    ap.add_argument("--local-rms", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="torch")
    ap.add_argument("--out", help="write the container here")
    ap.add_argument("--dump-error", help="write |in-out| as raw f32")
    ap.add_argument("--dump-slices", help="prefix for XZ-slice text dumps")
    ap.add_argument("--iters", type=int, default=1)
    args = ap.parse_args(argv)

    from cvxcompress_tpu_torch.utils import io as cio
    from cvxcompress_tpu_torch.utils import volumes

    if args.file:
        vol = volumes.read_raw(args.file, args.nz, args.ny, args.nx)
    else:
        vol = volumes.radial_volume(args.nz, args.ny, args.nx)
    block = tuple(int(v) for v in args.block.split(","))
    data, ratio, out, tc, td = roundtrip(vol, args.scale, block, args.local_rms,
                                         args.device, args.backend, args.iters)
    err, snr = rel_error(vol, out)
    mc = vol.size / 1e6
    print(f"volume {vol.shape}, block {block}, scale {args.scale}, "
          f"backend {args.backend}, device {args.device}")
    print(f"compress   {tc*1e3:9.2f} ms  {mc/tc:9.1f} MC/s  ratio {ratio:.2f}:1")
    print(f"decompress {td*1e3:9.2f} ms  {mc/td:9.1f} MC/s")
    print(f"error {err:.3e}  SNR {snr:.1f} dB")

    if args.out:
        cio.save(args.out, data)
        print(f"wrote {args.out} ({data.size} bytes)")
    if args.dump_error:
        np.abs(vol - out).astype(np.float32).tofile(args.dump_error)
        print(f"wrote {args.dump_error}")
    if args.dump_slices:
        dump_xz_slice(args.dump_slices + "_input.txt", vol)
        dump_xz_slice(args.dump_slices + "_output.txt", out)
        dump_xz_slice(args.dump_slices + "_error.txt", np.abs(vol - out))
        print(f"wrote {args.dump_slices}_{{input,output,error}}.txt")
    return 0


if __name__ == "__main__":
    sys.exit(main())
