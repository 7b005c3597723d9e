#!/usr/bin/env python
"""The JAX package's codec on the bench's 256^3 sinusoid at the sweep's blocks.

`chip_smoke.py` phase 3e holds the PyTorch/CUDA port's size, error and SNR
on this input against these numbers, the JAX package being the port's
reference; this script is how they were made.  For each block and RMS mode
it runs `cvxcompress_tpu.ops.codec.compress` and `decompress` (XLA; on a
machine without a TPU the CPU) and the native host codec on
sin(z*pi*10/256) broadcast over (256, 256, 256) at scale 1e-2, and prints
one JSON line: {"<block> <mode>": {"bytes", "ratio", "err", "snr_db",
"native_bytes", "native_err", "native_snr_db"}, ...}.

Usage: JAX_PLATFORMS=cpu python tools/jax_quality_s.py [--blocks 16x16x1,8x8x1]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

SHAPE = (256, 256, 256)
SCALE = 1e-2
BLOCKS = ("16x16x16", "128x8x8", "16x16x1", "8x8x1", "8x8x8", "64x64x64",
          "256x256x256")


def sinusoid(nz, ny, nx, periods=10):
    z = np.sin(np.arange(nz) * np.pi * periods / nz).astype(np.float32)
    return np.broadcast_to(z[:, None, None], (nz, ny, nx)).copy()


def err_snr(orig, recon):
    o = np.asarray(orig, np.float64)
    d = o - np.asarray(recon, np.float64)
    err = float(np.sqrt(np.mean(d * d)) / np.sqrt(np.mean(o * o)))
    return err, float(-20.0 * np.log10(err))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", default=",".join(BLOCKS))
    ap.add_argument("--modes", default="global,local")
    args = ap.parse_args()
    from cvxcompress_tpu.ops import codec as jcodec
    from cvxcompress_tpu_torch.ops import rle_host

    vol = sinusoid(*SHAPE)
    out = {}
    for name in args.blocks.split(","):
        block = tuple(int(b) for b in name.split("x"))
        for mode in args.modes.split(","):
            local = mode == "local"
            d, r = jcodec.compress(vol, SCALE, block=block, use_local_rms=local)
            err, snr = err_snr(vol, jcodec.decompress(d))
            dn, _ = rle_host.host_compress(vol, SCALE, block=block, use_local_rms=local)
            nerr, nsnr = err_snr(vol, rle_host.host_decompress(dn))
            out[f"{name} {mode}"] = dict(
                bytes=int(d.size), ratio=float(r), err=err, snr_db=snr,
                native_bytes=int(dn.size), native_err=nerr, native_snr_db=nsnr)
            print(f"{name} {mode}: {out[f'{name} {mode}']}", file=sys.stderr, flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
