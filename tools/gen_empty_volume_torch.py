#!/usr/bin/env python3
"""Write an all-zero raw float32 volume file (gen_empty_volume.cpp:10-46),
with the PyTorch port's `utils/volumes`.

The port's counterpart of `tools/gen_empty_volume.py`: the same file.  The
file is then read back and round-tripped through the codec on `--device` /
`--backend` (a zero volume compresses to one zero run a block and decodes
to zeros), so a fresh checkout shows it can write and read the reference's
raw format.

    python tools/gen_empty_volume_torch.py OUT.bin NX NY NZ
        [--device cuda|cpu] [--backend torch|native|oracle]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("nx", type=int)
    ap.add_argument("ny", type=int)
    ap.add_argument("nz", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="torch")
    args = ap.parse_args(argv)

    import cvxcompress_tpu_torch as cvt
    from cvxcompress_tpu_torch.utils import volumes

    nx, ny, nz = args.nx, args.ny, args.nz
    volumes.write_raw(args.out, volumes.empty_volume(nz, ny, nx))
    print(f"wrote {args.out}: {nx} x {ny} x {nz} zeros ({4*nx*ny*nz} bytes)")
    vol = volumes.read_raw(args.out, nz, ny, nx)
    data, _ = cvt.compress(vol, 1e-2, device=args.device, backend=args.backend)
    out = cvt.decompress(data, device=args.device, backend=args.backend)
    out = out.cpu().numpy() if hasattr(out, "cpu") else np.asarray(out)
    ok = not out.any()
    print(f"round trip on {args.backend}/{args.device}: {data.size} bytes, "
          f"{'zeros' if ok else 'NOT zeros'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
