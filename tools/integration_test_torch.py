#!/usr/bin/env python3
"""The CI-gating integration test on the PyTorch port: round trips at the
reference's quality bars.

The port's counterpart of `tools/integration_test.py`, itself the
reference's Test_With_Generated_Input (Test_With_Generated_Input.cpp:
19-126): three growing sinusoid volumes, scale 1e-2, 32^3 blocks,
asserting rel error < 2e-4 and SNR > 75 dB (:121-122), after a NaN scan of
the input (:63-65).

    python tools/integration_test_torch.py [--full] [--device cpu]
        [--backend torch|native|oracle]

default: k = 1, (nz, ny, nx) = (352, 416, 320); --full: k = 1, 2, 3 (each
dim times k), as the reference.  `run_case` takes any size: the signal
varies along z only, so (352, 32, 32), one block column of k = 1, meets
the same bars on the CPU.  Exit code 0 iff every case passes.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

BARS = dict(err=2e-4, snr_db=75.0)  # Test_With_Generated_Input.cpp:121-122


def run_case(nz, ny, nx, device="cuda", backend="torch"):
    """One round trip of the (nz, ny, nx) CI sinusoid at scale 1e-2, 32^3
    blocks.  Returns a dict: ratio, err, snr_db, compress and decompress
    MC/s, ok (both bars held)."""
    import cvxcompress_tpu_torch as cvt
    from cvxcompress_tpu_torch.utils import profiling, volumes

    vol = volumes.sinusoid_volume(nz, ny, nx)
    if np.isnan(vol).any():
        raise ValueError("NaN in the generated input")
    kw = dict(device=device) if backend == "torch" else {}
    t = profiling.Timer(device if backend == "torch" else "cpu")
    with t.stage("c"):
        data, ratio = cvt.compress(vol, 1e-2, block=(32, 32, 32), backend=backend, **kw)
    with t.stage("d"):
        out = cvt.decompress(data, backend=backend, **kw)
    out = out.cpu().numpy() if hasattr(out, "cpu") else np.asarray(out)
    o = vol.astype(np.float64)
    d = o - out.astype(np.float64)
    err = float(np.sqrt((d * d).mean()) / np.sqrt((o * o).mean()))
    snr = float(-20 * np.log10(err)) if err > 0 else float("inf")
    return dict(shape=(nz, ny, nx), ratio=float(ratio), err=err, snr_db=snr,
                compress_mcells_s=t.report("c", vol.size)["mcells_s"],
                decompress_mcells_s=t.report("d", vol.size)["mcells_s"],
                ok=bool(err < BARS["err"] and snr > BARS["snr_db"]))


def run(ks=(1,), device="cuda", backend="torch"):
    """The reference's cases k in `ks`: (352k, 416k, 320k); prints a line
    each and returns the results."""
    out = []
    for k in ks:
        r = run_case(352 * k, 416 * k, 320 * k, device, backend)
        nz, ny, nx = r["shape"]
        print(f"[{nx}x{ny}x{nz}] ratio {r['ratio']:.1f}:1  "
              f"compress {r['compress_mcells_s']:.0f} MC/s  "
              f"decompress {r['decompress_mcells_s']:.0f} MC/s  "
              f"error {r['err']:.3e}  SNR {r['snr_db']:.1f} dB  "
              f"{'PASS' if r['ok'] else 'FAIL'}", flush=True)
        out.append(r)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="torch")
    args = ap.parse_args(argv)
    res = run((1, 2, 3) if args.full else (1,), args.device, args.backend)
    return 0 if all(r["ok"] for r in res) else 1


if __name__ == "__main__":
    sys.exit(main())
