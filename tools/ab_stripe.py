#!/usr/bin/env python3
"""Time the fused stripe kernels of an earlier checkout against this one's,
in turns, on one NVIDIA card.

    git archive <commit> | tar -x -C build/parent    # the earlier checkout
    python3 tools/ab_stripe.py --parent build/parent

Builds the earlier checkout's `cvxcompress_tpu_torch/csrc/stripe_fused.cu`
(launches that take the dense per-axis operators, transposed) into a
library of its own under build/ab_parent/, and times
`stripe_fused_encode`, `stripe_fused_encode_local` and
`stripe_fused_inverse` of both at S-16^3 and S-(16, 16, 1) (the 256^3
sinusoid) and A-(64, 32, 32) (config A's sinusoid; the local encode on
its ramp too, chip_smoke.py `ramp`) in the order earlier, this, this,
earlier, with CUDA events (chip_smoke.py `cuda_ms`).  Each earlier output
is held within 1e-5 (relative RMS) of this checkout's (the earlier dense
products differ from the cascade in their last bits).  Prints the card's
name and power limit, progress lines, and on the last line one JSON object
with the times in ms.
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

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the earlier launches' C signatures: three operator pointers after the log2
# block edges; the inverse also a scratch buffer
PARENT_SIGNATURES = {
    "cvx_stripe_fused_encode": [_VP, _I, _I, _I, _I, _I, _I, _VP, _VP, _VP, _F, _VP, _VP,
                                _VP, _VP, _VP, _VP],
    "cvx_stripe_fused_encode_local": [_VP, _I, _I, _I, _I, _I, _I, _VP, _VP, _VP, _F, _VP,
                                      _VP, _VP, _VP, _VP, _VP],
    "cvx_stripe_fused_inverse": [_VP, _I, _I, _I, _I, _I, _I, _VP, _VP, _VP, _VP, _VP,
                                 _VP],
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="the earlier checkout's root")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    card = ab_common.card()
    print(card, flush=True)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from cvxcompress_tpu_torch.ops import blocks, fused_inverse, geometry, quant, tokenize
    from cvxcompress_tpu_torch.ops import wavelet

    plib = ab_common.build_parent(args.parent, ("stripe_fused.cu",), "libparent_stripe",
                                  PARENT_SIGNATURES)
    dev = torch.device("cuda")

    def call(name, *a):
        rc = getattr(plib, f"cvx_{name}")(*a, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"earlier {name} failed: cudaError {rc}")

    vol_s = cs.sinusoid(*cs.SHAPE_S, cs.PERIODS)
    vol_a = cs.sinusoid(*cs.SHAPE, cs.PERIODS)
    cases = (("S-16^3", vol_s, (16, 16, 16)), ("S-(16, 16, 1)", vol_s, (16, 16, 1)),
             ("A-(64, 32, 32)", vol_a, (64, 32, 32)),
             ("A-(64, 32, 32) ramp", cs.ramp(vol_a, 64), (64, 32, 32)))
    res = {}
    for cell, vol, block in cases:
        vt = torch.from_numpy(vol).to(dev)
        nz, ny, nx = vol.shape
        cells = math.prod(block)
        nnn = math.prod(blocks.grid_shape(vol.shape, block))
        lg = geometry.log2_block(block)
        mf = quant.global_mulfac(vol, cs.SCALE)
        fops = [wavelet.operator(n, False, dev).t().contiguous() for n in block]
        iops = [wavelet.operator(n, True, dev).t().contiguous() for n in block]
        outs = (torch.empty((nnn, cells), dtype=torch.float32, device=dev),
                torch.empty((nnn, cells), dtype=torch.int32, device=dev),
                torch.empty(nnn * cells // 128, dtype=torch.int32, device=dev),
                torch.empty(nnn, dtype=torch.int32, device=dev),
                torch.empty(nnn, dtype=torch.float32, device=dev))

        def p_encode(local):
            call("stripe_fused_encode_local" if local else "stripe_fused_encode",
                 vt.data_ptr(), nx, ny, nz, *lg, *(o.data_ptr() for o in fops),
                 cs.SCALE if local else mf, *(o.data_ptr() for o in outs))

        def t_encode(local):
            return (tokenize.stripe_fused_encode(vt, block, scale=cs.SCALE) if local
                    else tokenize.stripe_fused_encode(vt, block, mf))

        ramp = cell.endswith("ramp")
        dense = None
        for local in (True,) if ramp else (False, True):
            p_encode(local)
            this = t_encode(local)
            torch.cuda.synchronize()
            fin = torch.isfinite(this[0]).all(1)
            e = cs.rel_rms(outs[0][fin], this[0][fin])
            cs.check(e < cs.TRANSFORM_TOL, f"{cell}: earlier encode (local {local}) within "
                     f"rel RMS {e:.3e} of this one")
            if not local:
                dense = this[0]
        vol_p = torch.empty_like(vt)
        work = torch.empty_like(dense) if dense is not None else None

        def p_inverse():
            call("stripe_fused_inverse", dense.data_ptr(), nx, ny, nz, *lg,
                 *(o.data_ptr() for o in iops), work.data_ptr(), vol_p.data_ptr())

        pairs = {f"stripe_fused_encode_local {cell}": (lambda: p_encode(True),
                                                       lambda: t_encode(True))}
        if not ramp:
            p_inverse()
            this = fused_inverse.stripe_fused_inverse(dense, vol.shape, block)
            torch.cuda.synchronize()
            e = cs.rel_rms(vol_p, this)
            cs.check(e < cs.TRANSFORM_TOL, f"{cell}: earlier inverse within rel RMS "
                     f"{e:.3e} of this one")
            pairs = {f"stripe_fused_encode {cell}": (lambda: p_encode(False),
                                                     lambda: t_encode(False)),
                     **pairs,
                     f"stripe_fused_inverse {cell}": (p_inverse, lambda: fused_inverse.
                                                      stripe_fused_inverse(dense, vol.shape,
                                                                           block))}
        for name, (earlier, this) in pairs.items():
            fns = {"earlier": earlier, "this": this}
            t = ab_common.turns(ab_common.ORDER, lambda k: fns[k](), args.iters)
            res[name] = dict(earlier_ms=t["earlier"], this_ms=t["this"])
            print(f"  {name}: earlier {t['earlier'][0]:.4f}, this {t['this'][0]:.4f}, "
                  f"this {t['this'][1]:.4f}, earlier {t['earlier'][1]:.4f} ms on {card}",
                  flush=True)
        del vt, outs, dense, work, vol_p
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "turns": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
