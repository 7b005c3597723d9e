#!/usr/bin/env python3
"""Time the 32^3 kernels of an earlier checkout against this one's, in
turns, on one NVIDIA card.

    git archive <commit> | tar -x -C build/parent    # the earlier checkout
    python3 tools/ab_block32.py --parent build/parent

Builds the earlier checkout's `cvxcompress_tpu_torch/csrc/fused_encode.cu`
and `fused_inverse.cu` (with its `common.cuh`: launches that take the
composed dense operator, `wavelet.operator(32, ...)`) into a library of
their own under build/ab_parent/, and times `fused_encode`,
`fused_encode_local` and `fused_inverse` (dense and chunk-sparse) of both
at config A (the (352, 416, 320) sinusoid, scale 1e-2, 32^3 blocks) in the
order earlier, this, this, earlier, with CUDA events (chip_smoke.py
`cuda_ms`).  Each earlier output is held within 1e-5 (relative RMS) of
this checkout's (the two transforms differ in their last bits, so the
earlier descriptors, sizes and table are reported equal or not).  Prints
the card's name and power limit, progress lines, and on the last line one
JSON object with the times in ms.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import ab_common  # noqa: E402
import chip_smoke as cs  # noqa: E402  (helpers only; its main() is not run)

_VP, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# the earlier launches' C signatures: the operator pointer after the dims
PARENT_SIGNATURES = {
    "cvx_fused_encode": [_VP, _I, _I, _I, _VP, _F, _VP, _VP, _VP, _VP, _VP, _VP],
    "cvx_fused_encode_local": [_VP, _I, _I, _I, _VP, _F, _VP, _VP, _VP, _VP, _VP, _VP],
    "cvx_fused_inverse": [_VP, _I64, _VP, _VP, _I, _I, _I, _VP, _VP],
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
    from cvxcompress_tpu_torch.ops import codec, fused_inverse, quant, tokenize, wavelet

    plib = ab_common.build_parent(args.parent, ("fused_encode.cu", "fused_inverse.cu"),
                                  "libparent32", PARENT_SIGNATURES)
    dev = torch.device("cuda")
    vol = cs.sinusoid(*cs.SHAPE, cs.PERIODS)
    vt = torch.from_numpy(vol).to(dev)
    nz, ny, nx = vol.shape
    nnn = vol.size // 32 ** 3
    mf = quant.global_mulfac(vol, cs.SCALE)
    fop = wavelet.operator(32, False, dev)
    iop = wavelet.operator(32, True, dev)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def call(name, *a):
        rc = getattr(plib, f"cvx_{name}")(*a, stream())
        if rc:
            raise RuntimeError(f"earlier {name} failed: cudaError {rc}")

    outs = {local: (torch.empty((nnn, 32 ** 3), dtype=torch.float32, device=dev),
                    torch.empty((nnn, 32 ** 3), dtype=torch.int32, device=dev),
                    torch.empty(nnn, dtype=torch.int32, device=dev),
                    torch.empty(nnn, dtype=torch.uint8, device=dev),
                    torch.empty(nnn, dtype=torch.float32, device=dev))
            for local in (False, True)}

    def p_encode(local):
        c, d, s, r, m = outs[local]
        call("fused_encode_local" if local else "fused_encode", vt.data_ptr(), nx, ny, nz,
             fop.data_ptr(), cs.SCALE if local else mf, c.data_ptr(), d.data_ptr(),
             s.data_ptr(), r.data_ptr(), m.data_ptr())

    ck = None
    for local in (False, True):
        p_encode(local)
        this = (tokenize.fused_encode(vt, scale=cs.SCALE) if local
                else tokenize.fused_encode(vt, mf))
        torch.cuda.synchronize()
        name = "fused_encode_local" if local else "fused_encode"
        c, d, s, r, m = outs[local]
        e = cs.rel_rms(c, this[0])
        cs.check(e < cs.TRANSFORM_TOL, f"earlier {name} within rel RMS {e:.3e} of this one")
        same = (torch.equal(d, this[1]) and torch.equal(s, this[3])
                and torch.equal(r.bool(), this[4]) and torch.equal(m, this[5]))
        print(f"  earlier {name}: descriptors, sizes, raw flags and table "
              f"{'equal' if same else 'differ (the coefficients differ in their last bits)'}")
        if not local:
            ck = this[0]
    rows = ck.view(-1, 128)
    rows_h, invmap_h = codec.sparse_chunks(ck.cpu().numpy())
    srows, sinv = torch.from_numpy(rows_h).to(dev), torch.from_numpy(invmap_h).to(dev)
    vol_p = torch.empty_like(vt)

    def p_inverse(sparse):
        r, m = (srows, sinv) if sparse else (rows, None)
        call("fused_inverse", r.data_ptr(), r.shape[0], None if m is None else m.data_ptr(),
             iop.data_ptr(), nx, ny, nz, vol_p.data_ptr())

    for sparse in (False, True):
        p_inverse(sparse)
        this = fused_inverse.fused_inverse(*((srows, sinv) if sparse else (rows, None)),
                                           vol.shape)
        torch.cuda.synchronize()
        e = cs.rel_rms(vol_p, this)
        mode = "chunk-sparse" if sparse else "dense"
        cs.check(e < cs.TRANSFORM_TOL, f"earlier fused_inverse ({mode}) within rel RMS "
                 f"{e:.3e} of this one")

    pairs = {
        "fused_encode": (lambda: p_encode(False), lambda: tokenize.fused_encode(vt, mf)),
        "fused_encode_local": (lambda: p_encode(True),
                               lambda: tokenize.fused_encode(vt, scale=cs.SCALE)),
        "fused_inverse dense": (lambda: p_inverse(False), lambda: fused_inverse.fused_inverse(
            rows, None, vol.shape)),
        "fused_inverse chunk-sparse": (lambda: p_inverse(True),
                                       lambda: fused_inverse.fused_inverse(srows, sinv,
                                                                           vol.shape)),
    }
    res = {}
    for name, (earlier, this) in pairs.items():
        fns = {"earlier": earlier, "this": this}
        t = ab_common.turns(ab_common.ORDER, lambda k: fns[k](), args.iters)
        res[name] = dict(earlier_ms=t["earlier"], this_ms=t["this"])
        print(f"  {name}: earlier {t['earlier'][0]:.4f}, this {t['this'][0]:.4f}, this "
              f"{t['this'][1]:.4f}, earlier {t['earlier'][1]:.4f} ms on {card}", flush=True)
    print(json.dumps({"card": card, "config": "A", "chunk_sparse_rows": rows_h.shape[0],
                      "turns": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
