#!/usr/bin/env python3
"""Time variants of csrc/stripe_fused.cu against each other on one NVIDIA
card, each built from a copy of the source with text substitutions.

    python3 tools/variants_stripe.py '{"base": [], "lb2": [["A", "B"]], ...}'

The argument maps each variant's name to a list of [old, new] pairs, each
replacing every `old` in the copied source with `new` (["FILE", path]
starts from the file at `path`, relative to the repo root, instead).  Each
variant is built into build/variants/<name>/ and launched through its C
interface directly, with preallocated outputs, at S-16^3 and S-(16, 16, 1)
(the 256^3 sinusoid) and A-(64, 32, 32) (config A's sinusoid): the encode
twice, the local encode and the inverse, with CUDA events (chip_smoke.py
`cuda_ms`), beside whether each output equals the shipped kernels' bit for
bit.  First it times the shipped wrappers, by events and by the profiler's
device time.  Prints the card's name and power limit and one line per
variant and cell.
"""

from __future__ import annotations

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
SIGNATURES = {
    "cvx_stripe_fused_encode": [_VP, _I, _I, _I, _I, _I, _I, _F, _VP, _VP, _VP, _VP, _VP, _VP],
    "cvx_stripe_fused_encode_local": [_VP, _I, _I, _I, _I, _I, _I, _F, _VP, _VP, _VP, _VP,
                                      _VP, _VP],
    "cvx_stripe_fused_inverse": [_VP, _I, _I, _I, _I, _I, _I, _VP, _VP],
}


def build(name, subs):
    return ab_common.build_variant(name, {"stripe_fused.cu": subs}, ("stripe_fused.cu",),
                                   SIGNATURES, subdir="variants")


def main():
    variants = json.loads(sys.argv[1]) if len(sys.argv) > 1 else {"base": []}
    card = ab_common.card()
    print(card, flush=True)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from cvxcompress_tpu_torch.ops import blocks, fused_inverse, geometry, quant, tokenize

    libs = {n: build(n, subs) for n, subs in variants.items()}
    dev = torch.device("cuda")
    st = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    vol_s = cs.sinusoid(*cs.SHAPE_S, cs.PERIODS)
    vol_a = cs.sinusoid(*cs.SHAPE, cs.PERIODS)
    for cell, vol, block in (("S-16^3", vol_s, (16, 16, 16)),
                             ("S-(16, 16, 1)", vol_s, (16, 16, 1)),
                             ("A-(64, 32, 32)", vol_a, (64, 32, 32))):
        vt = torch.from_numpy(vol).to(dev)
        nz, ny, nx = vol.shape
        cells = math.prod(block)
        nnn = math.prod(blocks.grid_shape(vol.shape, block))
        lg = geometry.log2_block(block)
        mf = quant.global_mulfac(vol, cs.SCALE)
        ref = tokenize.stripe_fused_encode(vt, block, mf)
        refl = tokenize.stripe_fused_encode(vt, block, scale=cs.SCALE)
        vref = fused_inverse.stripe_fused_inverse(ref[0], vol.shape, block)

        def w_enc():
            return tokenize.stripe_fused_encode(vt, block, mf)

        def w_inv():
            return fused_inverse.stripe_fused_inverse(ref[0], vol.shape, block)

        print(f"{cell} shipped wrappers: encode {cs.cuda_ms(w_enc, 20):.4f} ms (device "
              f"{cs.device_ms(w_enc, 10, 'sf_'):.4f}), inverse {cs.cuda_ms(w_inv, 20):.4f} "
              f"(device {cs.device_ms(w_inv, 10, 'sf_'):.4f}) on {card}", flush=True)
        outs = (torch.empty((nnn, cells), device=dev),
                torch.empty((nnn, cells), dtype=torch.int32, device=dev),
                torch.empty(nnn * cells // 128, dtype=torch.int32, device=dev),
                torch.empty(nnn, dtype=torch.int32, device=dev),
                torch.empty(nnn, device=dev))
        vo = torch.empty_like(vt)
        for name, lib in libs.items():
            def enc(local=False, lib=lib):
                fn = lib.cvx_stripe_fused_encode_local if local else lib.cvx_stripe_fused_encode
                rc = fn(vt.data_ptr(), nx, ny, nz, *lg, cs.SCALE if local else mf,
                        *(o.data_ptr() for o in outs), st())
                if rc:
                    raise RuntimeError(f"{name}: encode failed: cudaError {rc}")

            def inv(lib=lib):
                rc = lib.cvx_stripe_fused_inverse(ref[0].data_ptr(), nx, ny, nz, *lg,
                                                  vo.data_ptr(), st())
                if rc:
                    raise RuntimeError(f"{name}: inverse failed: cudaError {rc}")

            enc()
            torch.cuda.synchronize()
            same = (torch.equal(outs[0].view(torch.int32), ref[0].view(torch.int32))
                    and torch.equal(outs[1], ref[1]))
            enc(True)
            torch.cuda.synchronize()
            same_l = torch.equal(outs[4], refl[5]) and torch.equal(outs[1], refl[1])
            inv()
            torch.cuda.synchronize()
            same_i = torch.equal(vo.view(torch.int32), vref.view(torch.int32))
            t = [cs.cuda_ms(enc, 20), cs.cuda_ms(lambda: enc(True), 20), cs.cuda_ms(inv, 20),
                 cs.cuda_ms(enc, 20)]
            print(f"  {cell} {name}: encode {t[0]:.4f} / {t[3]:.4f}, local {t[1]:.4f}, "
                  f"inverse {t[2]:.4f} ms (bit-equal to the shipped: {same}, {same_l}, "
                  f"{same_i}) on {card}", flush=True)
        del vt, outs, vo, ref, refl, vref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
