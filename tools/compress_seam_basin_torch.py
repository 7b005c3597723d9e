#!/usr/bin/env python3
"""Scale-sweep benchmark writing a results CSV (Compress_SEAM_Basin analog),
on the PyTorch port.

The port's counterpart of `tools/compress_seam_basin.py`.  The reference
CLI (Compress_SEAM_Basin.cpp:22-173) loops a SEAM Basin velocity volume
over quantization scales and appends (scale, ratio, error, snr,
throughputs) rows to results.txt; this tool does the same over a raw file
(`--file`) or the synthetic radial volume.  Throughputs are MCells/s from
CUDA events on the card (`utils/profiling.Timer`), the host clock
elsewhere.

    python tools/compress_seam_basin_torch.py [--file vol.bin --nz .. --ny ..
        --nx ..] [--scales 1e-1,3e-2,1e-2,3e-3,1e-3] [--block 32,32,32]
        [--results results.txt] [--device cuda|cpu]
        [--backend torch|native|oracle]
"""

from __future__ import annotations

import argparse
import os
import sys

_TOOLS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(_TOOLS, ".."), _TOOLS]

HEADER = "scale,ratio,rel_error,snr_db,compress_mcs,decompress_mcs\n"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--file")
    ap.add_argument("--nz", type=int, default=128)
    ap.add_argument("--ny", type=int, default=192)
    ap.add_argument("--nx", type=int, default=192)
    ap.add_argument("--scales", default="1e-1,3e-2,1e-2,3e-3,1e-3")
    ap.add_argument("--block", default="32,32,32")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="torch")
    ap.add_argument("--results", default="results.txt")
    args = ap.parse_args(argv)

    from cvxcompress_tpu_torch.utils import volumes
    from test_compression_torch import rel_error, roundtrip

    if args.file:
        vol = volumes.read_raw(args.file, args.nz, args.ny, args.nx)
    else:
        vol = volumes.radial_volume(args.nz, args.ny, args.nx)
    block = tuple(int(v) for v in args.block.split(","))
    scales = [float(s) for s in args.scales.split(",")]

    write_header = not os.path.exists(args.results)
    with open(args.results, "a") as f:
        if write_header:
            f.write(HEADER)
        for scale in scales:
            _, ratio, out, tc, td = roundtrip(vol, scale, block, False, args.device,
                                              args.backend)
            err, snr = rel_error(vol, out)
            mc = vol.size / 1e6
            row = (f"{scale:g},{ratio:.3f},{err:.4e},{snr:.2f},"
                   f"{mc/tc:.1f},{mc/td:.1f}")
            print(row)
            f.write(row + "\n")
    print(f"appended {len(scales)} rows to {args.results}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
