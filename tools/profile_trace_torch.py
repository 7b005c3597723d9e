#!/usr/bin/env python3
"""Capture a `torch.profiler` trace of the compress pipeline, on the PyTorch
port.

The port's counterpart of `tools/profile_trace.py`, the analog of the
reference's optional PAPI hardware-counter hooks (CvxCompress.cpp:21-27,
787-801): where the reference samples FLOP counters around its hot loops,
this captures a trace of the codec's stages ("cvx.<stage>" spans, and on
the card every kernel) through `utils/profiling.device_trace`, written as
`<logdir>/trace.json` for chrome://tracing or Perfetto.  A warm-up round
trip first, outside the trace, builds the kernels.

    python tools/profile_trace_torch.py [--logdir build/cvx_trace]
        [--nz 128 --ny 128 --nx 128] [--block 32,32,32] [--scale 1e-2]
        [--iters 3] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, _REPO)


def span_counts(trace_path):
    """{name: count} of the "cvx.*" spans of a chrome trace."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    out = {}
    for e in events:
        name = e.get("name", "")
        if name.startswith("cvx."):
            out[name] = out.get(name, 0) + 1
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--logdir", default=os.path.join(_REPO, "build", "cvx_trace"))
    ap.add_argument("--nz", type=int, default=128)
    ap.add_argument("--ny", type=int, default=128)
    ap.add_argument("--nx", type=int, default=128)
    ap.add_argument("--block", default="32,32,32")
    ap.add_argument("--scale", type=float, default=1e-2)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="torch", choices=["torch"],
                    help="the trace is of the torch backend's stages")
    args = ap.parse_args(argv)

    import cvxcompress_tpu_torch as cvt
    from cvxcompress_tpu_torch.utils import profiling, volumes

    block = tuple(int(v) for v in args.block.split(","))
    vol = volumes.radial_volume(args.nz, args.ny, args.nx)

    # warm up outside the trace (the kernels' build, the first allocations)
    data, ratio = cvt.compress(vol, args.scale, block=block, device=args.device)
    cvt.decompress(data, device=args.device)

    with profiling.device_trace(args.logdir):
        for _ in range(args.iters):
            data, ratio = cvt.compress(vol, args.scale, block=block, device=args.device)
            cvt.decompress(data, device=args.device)

    path = os.path.join(args.logdir, "trace.json")
    spans = span_counts(path)
    print(f"ratio {ratio:.1f}:1; trace written to {path}; "
          f"{sum(spans.values())} cvx.* spans: {', '.join(sorted(spans))}")
    return 0 if spans else 1


if __name__ == "__main__":
    sys.exit(main())
