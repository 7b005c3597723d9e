#!/usr/bin/env python3
"""Time the decode chase and the stripe tokenize of an earlier checkout
against this one's, in turns, on one NVIDIA card.

    git archive <commit> | tar -x -C build/parent    # the earlier checkout
    python3 tools/ab_chase_stripe.py --parent build/parent [--variants JSON]

Builds the earlier checkout's `cvxcompress_tpu_torch/csrc/decode_chase.cu`
(a warp walks each chain; it takes the chain starts) and
`tokenize_stripe.cu` into a library of their own under build/ab_parent/,
and launches both libraries' kernels through their C interfaces, with
preallocated outputs:

- `decode_chase` on config A's CI container, A's and B's N(0,1) noise
  containers (chip_smoke.py `SHAPE`, `SHAPE_B`, `NOISE_SCALE`) and the two
  synthetic inputs of chip_smoke.py `synthetic_chase` (one chain of 2^20
  rows; 2^20 rows with resets at random places and at piece boundaries);
- `tokenize_stripe` on the transform's plane and table (ops/tokenize.py
  `encode`) of A at 8^3, 64^3 and 256^3 (and their local ramps), the
  half-zero 256^3 volume, B at 128^3 (the CVX_FUSED_W=0 route), the 256^3
  volume S at (8, 8, 1) and (128, 8, 8), and the unaligned (100, 130, 75)
  noise at 8^3 and 64^3.

Each earlier output is held bit-equal to this checkout's, and this one's
to the plain version (`chase_plain`, `tokenize_stripe_plain`), then the
two are timed in the order earlier, this, this, earlier, with CUDA events
(chip_smoke.py `cuda_ms`), and each of the two alone by the profiler's
device time of its kernel.  This checkout's chase runs the route its
wrapper picks (`entropy_decode.chase_walks`); the other route ("other
route") is held and timed once between the turns.  `--variants` maps names to text substitutions
of this checkout's sources, {"name": {"decode_chase.cu": [[old, new], ...],
"tokenize_stripe.cu": [...], "piece": 256}}: each is built into
build/ab_variants/<name>/, held bit-equal and timed after this checkout's
first turn; "piece" (optional) replaces the chase's largest piece,
ops/entropy_decode.py `CHASE_PIECE`, in the launch's piece length (0: the
walk), and "warps" its pieces a unit (`chase_shape`); with
"probe": true a variant that leaves out part of the work is timed and its
outputs are not held (a probe of where the time goes).  Prints the
card's name and power limit, one line per input, and on the last line one
JSON object with the times in ms.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import ab_common  # noqa: E402
import chip_smoke as cs  # noqa: E402  (helpers only; its main() is not run)

_VP, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# the earlier chase's C signature: a warp walks each chain from its start
PARENT_SIGNATURES = {
    "cvx_decode_chase": [_VP, _VP, _I64, _I64, _I, _VP, _VP, _VP],
    "cvx_tokenize_stripe": [_VP, _VP, _I64, _I, _I, _I, _I64, _I64, _I64, _I64, _VP, _VP,
                            _VP, _VP, _VP],
}
FILES = ("decode_chase.cu", "tokenize_stripe.cu")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="the earlier checkout's root")
    ap.add_argument("--variants", default="{}", help="JSON: name -> file -> [[old, new]]")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", choices=("decode_chase", "tokenize_stripe"),
                    help="time one of the two kernels only")
    args = ap.parse_args()
    card = ab_common.card()
    print(card, flush=True)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import cvxcompress_tpu_torch as cvt
    from cvxcompress_tpu_torch.ops import _kernels, entropy_decode, geometry, quant, tokenize

    dev = torch.device("cuda")
    this_sigs = {f"cvx_{k}": _kernels._SIGNATURES[f"cvx_{k}"]
                 for k in ("decode_chase", "tokenize_stripe")}
    variants = json.loads(args.variants)
    libs = {"earlier": ab_common.build_parent(args.parent, FILES, "libparent_cs",
                                              PARENT_SIGNATURES),
            "this": ab_common.build_lib([os.path.join(_kernels.SRC_DIR, f) for f in FILES],
                                        os.path.join(ROOT, "build", "ab_this", "lib.so"),
                                        this_sigs)}
    for name, subs in variants.items():
        libs[name] = ab_common.build_variant(name, subs, FILES, this_sigs)
    libs["other route"] = libs["this"]  # the chase's other route

    def order_of(keys):
        return ["earlier", "this", *[k for k in keys if k not in ("earlier", "this")],
                "this", "earlier"]

    def call(lib, name, *a):
        rc = getattr(libs[lib], f"cvx_{name}")(*a, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{lib} {name} failed: cudaError {rc}")

    def turns(label, run, iters, kernel, keys):
        t = ab_common.turns(order_of(keys), run, iters)
        dev_t = {lib: cs.device_ms(lambda: run(lib), iters, kernel)
                 for lib in ("earlier", "this")}
        print(f"  {label}: " + ", ".join(f"{k} " + " / ".join(f"{x:.4f}" for x in v)
                                         for k, v in t.items())
              + f" ms; device time earlier {dev_t['earlier']:.4f}, this "
              f"{dev_t['this']:.4f} ms on {card}", flush=True)
        return dict(t, device_ms=dev_t)

    res = {}
    # -- the chase ---------------------------------------------------------
    chase_inputs = []
    containers = (
        ("A CI container", lambda: cs.sinusoid(*cs.SHAPE, cs.PERIODS), cs.BLOCK_A, cs.SCALE),
        ("A noise container", lambda: np.random.default_rng(0).standard_normal(
            cs.SHAPE, dtype=np.float32), cs.BLOCK_A, cs.NOISE_SCALE),
        ("B noise container", lambda: np.random.default_rng(0).standard_normal(
            cs.SHAPE_B, dtype=np.float32), cs.BLOCK_B, cs.NOISE_SCALE))
    for label, vol, block, scale in containers if args.only != "tokenize_stripe" else ():
        data, _ = cvt.compress(vol(), scale, block=block)
        p = entropy_decode.plan(data)
        b = entropy_decode.upload(p, dev)
        nsub, cells = b["sub_block"].numel(), p["cells"]
        _, P = entropy_decode.parse_maps(b["stream"], nsub, cells)
        chase_inputs.append((label, P, b["sub_reset"], b["starts"], cells))
        del data
    for kind in ("chain", "resets") if args.only != "tokenize_stripe" else ():
        chase_inputs.append((f"synthetic {kind}", *cs.synthetic_chase(kind, dev)))
    for label, P, reset, starts, cells in chase_inputs:
        nsub = P.shape[0]
        ep, cp = entropy_decode.chase_plain(P, reset, cells)
        e32 = torch.empty(nsub, dtype=torch.int32, device=dev)
        c32 = torch.empty_like(e32)
        out = (e32.data_ptr(), c32.data_ptr())
        # each library's launch arguments; this checkout's (and its variants')
        # chase on the route its wrapper picks, "other route" on the other
        walks = entropy_decode.chase_walks(nsub, starts.numel(), cells)
        args_of, scratch = {}, []
        for lib in libs:
            piece, warps = entropy_decode.chase_shape(nsub)
            spec = variants.get(lib, {})
            piece = min(spec.get("piece", piece), 32 * -(-nsub // (2048 * 32)))
            warps = spec.get("warps", warps)
            if walks != (lib == "other route") or piece == 0:
                piece = warps = 0
            scratch.append(torch.empty(1 + -(-nsub // max(1, warps * piece)) * 25,
                                       dtype=torch.int32, device=dev))
            args_of[lib] = (P.data_ptr(), reset.data_ptr(), starts.data_ptr(),
                            starts.numel(), nsub, piece, warps, cells,
                            scratch[-1].data_ptr(), *out)
        args_of["earlier"] = (P.data_ptr(), starts.data_ptr(), starts.numel(), nsub, cells,
                              *out)

        def run(lib):
            call(lib, "decode_chase", *args_of[lib])

        for lib in libs:
            e32.fill_(-1)
            run(lib)
            torch.cuda.synchronize()
            if variants.get(lib, {}).get("probe"):
                continue
            cs.check(torch.equal(e32, ep) and torch.equal(c32, cp),
                     f"{label}: {lib} decode_chase bit-equal to chase_plain")
        longest = int(np.diff(np.append(starts.cpu().numpy(), nsub)).max())
        res[f"decode_chase {label}"] = turns(
            f"decode_chase {label} ({nsub} subsegments, longest chain {longest}, this "
            f"{'walks' if walks else 'scans pieces'})", run, args.iters,
            ("decode_", "Memset"), libs)
        del e32, c32, scratch, args_of
    del chase_inputs
    torch.cuda.empty_cache()

    # -- the tokenize ------------------------------------------------------
    vol_a = cs.sinusoid(*cs.SHAPE, cs.PERIODS)
    vol_half = cs.sinusoid(*cs.SHAPE_HALF, cs.PERIODS)
    vol_half[cs.SHAPE_HALF[0] // 2:] = 0.0
    vol_s = cs.sinusoid(*cs.SHAPE_S, cs.PERIODS)
    noise_u = np.random.default_rng(3).standard_normal(cs.SHAPE_U, dtype=np.float32)
    cases = [("A-8^3", vol_a, (8, 8, 8), False), ("A-8^3 local ramp", None, (8, 8, 8), True),
             ("A-64^3", vol_a, (64, 64, 64), False),
             ("A-64^3 local ramp", None, (64, 64, 64), True),
             ("A-256^3", vol_a, (256, 256, 256), False),
             ("A-256^3 local ramp", None, (256, 256, 256), True),
             ("half-zero 256^3", vol_half, (256, 256, 256), False),
             ("B (K15)", cs.sinusoid(*cs.SHAPE_B, cs.PERIODS), cs.BLOCK_B, False),
             ("S-(8, 8, 1)", vol_s, (8, 8, 1), False),
             ("S-(128, 8, 8)", vol_s, (128, 8, 8), False),
             ("unaligned noise 8^3", noise_u, (8, 8, 8), False),
             ("unaligned noise 64^3", noise_u, (64, 64, 64), False)]
    tok_libs = [k for k in libs if k != "other route"]
    for label, v, block, local in cases if args.only != "decode_chase" else ():
        if v is None:
            v = cs.ramp(vol_a, block[0])
        vt = torch.from_numpy(v).to(dev)
        kw = dict(scale=cs.SCALE) if local else dict(mulfac=quant.global_mulfac(v, cs.SCALE))
        plane, *_, mk = tokenize.encode(vt, block, **kw)
        del vt
        plain = tokenize.tokenize_stripe_plain(plane, mk, block)
        cells = math.prod(block)
        nnn = mk.numel()
        desc, cb, sizes = tokenize._outputs(nnn, cells, dev)
        scratch = torch.empty(1 + -(-nnn * cells // tokenize.TILE), dtype=torch.int32,
                              device=dev)
        margs = geometry.map_args(plane.shape, block)

        def run(lib):
            call(lib, "tokenize_stripe", plane.data_ptr(), mk.data_ptr(), nnn, *margs,
                 scratch.data_ptr(), desc.data_ptr(), cb.data_ptr(), sizes.data_ptr())

        for lib in tok_libs:
            desc.fill_(-1)
            run(lib)
            got = tokenize.raw_fallback(desc, cb.clone(), sizes.clone())
            torch.cuda.synchronize()
            if variants.get(lib, {}).get("probe"):
                continue
            cs.check(all(torch.equal(a, b) for a, b in zip(got, plain)),
                     f"{label}: {lib} tokenize_stripe bit-equal to tokenize_stripe_plain")
        del plain
        res[f"tokenize_stripe {label}"] = turns(f"tokenize_stripe {label}", run,
                                                max(3, args.iters // (1 + (cells >> 18))),
                                                ("tokenize_stripe", "Memset"), tok_libs)
        del plane, mk, desc, cb, sizes, scratch
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "turns": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
