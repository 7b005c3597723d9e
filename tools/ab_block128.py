#!/usr/bin/env python3
"""Time the 128^3 transform launches of an earlier checkout against this
one's, in turns, on one NVIDIA card.

    git archive <commit> | tar -x -C build/parent    # the earlier checkout
    python3 tools/ab_block128.py --parent build/parent

Builds the earlier checkout's `cvxcompress_tpu_torch/csrc/block_encode.cu`
and `block_inverse.cu` (whose launches take the composed dense operator,
`wavelet.operator(128, ...)`) into a library of their own under
build/ab_parent/, and times `block_fwd_z`, `block_encode_xy`, `block_inv_xy`
and `block_inv_z` of both at config B (the (384, 384, 384) sinusoid, scale
1e-2, 128^3 blocks) in the order earlier, this, this, earlier, with CUDA
events (chip_smoke.py `cuda_ms`).  Each earlier output is held within 1e-5
(relative RMS) of this checkout's.  Prints the card's name and power limit,
progress lines, and on the last line one JSON object with the times in ms.
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
# the earlier launches' C signatures: the operator pointer after the inputs
PARENT_SIGNATURES = {
    "cvx_block_fwd_z": [_VP, _I, _I, _I, _VP, _VP, _VP],
    "cvx_block_encode_xy": [_VP, _VP, _F, _I64, _VP, _VP, _VP, _VP, _VP, _VP, _VP],
    "cvx_block_inv_xy": [_VP, _VP, _I, _I, _I, _VP, _VP],
    "cvx_block_inv_z": [_VP, _I, _I, _I, _VP, _VP],
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
    from cvxcompress_tpu_torch.ops import fused_compress, fused_inverse, quant, wavelet

    plib = ab_common.build_parent(args.parent, ("block_encode.cu", "block_inverse.cu"),
                                  "libparent128", PARENT_SIGNATURES)
    dev = torch.device("cuda")
    vol = cs.sinusoid(*cs.SHAPE_B, cs.PERIODS)
    vt = torch.from_numpy(vol).to(dev)
    nz, ny, nx = vol.shape
    nnn = vol.size // 128 ** 3
    mf = quant.global_mulfac(vol, cs.SCALE)
    fop = wavelet.operator(128, False, dev)
    iop = wavelet.operator(128, True, dev)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def call(name, *a):
        rc = getattr(plib, f"cvx_{name}")(*a, stream())
        if rc:
            raise RuntimeError(f"earlier {name} failed: cudaError {rc}")

    tmp_p = torch.empty((nnn, 128 ** 3), dtype=torch.float32, device=dev)
    scratch = torch.empty(1 + nnn * 128, dtype=torch.int32, device=dev)
    desc = torch.empty((nnn, 128 ** 3), dtype=torch.int32, device=dev)
    cb = torch.empty(nnn * 128 ** 3 // 128, dtype=torch.int32, device=dev)
    sizes = torch.empty(nnn, dtype=torch.int32, device=dev)
    mfs = torch.empty(nnn, dtype=torch.float32, device=dev)
    coeffs_p = torch.empty_like(tmp_p)
    vol_p = torch.empty_like(vt)

    def p_fwd_z():
        call("block_fwd_z", vt.data_ptr(), nx, ny, nz, fop.data_ptr(), tmp_p.data_ptr())

    def p_encode_xy():
        call("block_encode_xy", tmp_p.data_ptr(), fop.data_ptr(), float(mf), nnn,
             scratch.data_ptr(), coeffs_p.data_ptr(), desc.data_ptr(), cb.data_ptr(),
             sizes.data_ptr(), mfs.data_ptr())

    tk = fused_compress.fwd_z(vt)
    buf = torch.empty_like(tk)
    ck = fused_compress.encode_xy(tk, mf, out=buf)[0].clone()
    rows = ck.view(-1, 128)

    def p_inv_xy():
        call("block_inv_xy", rows.data_ptr(), iop.data_ptr(), nx, ny, nz, vol_p.data_ptr())

    def p_inv_z():
        call("block_inv_z", iop.data_ptr(), nx, ny, nz, vol_p.data_ptr())

    p_fwd_z()
    p_encode_xy()
    p_inv_xy()
    xk = fused_inverse.block_inv_xy(rows, vol.shape)
    torch.cuda.synchronize()
    for name, a, b in (("block_fwd_z", tmp_p, tk), ("block_encode_xy", coeffs_p, ck),
                       ("block_inv_xy", vol_p, xk)):
        e = cs.rel_rms(a, b)
        cs.check(e < cs.TRANSFORM_TOL, f"earlier {name} within rel RMS {e:.3e} of this one")
    scratch_v = xk.clone()
    p_inv_z()
    zk = fused_inverse.block_inv_z(xk.clone())
    torch.cuda.synchronize()
    e = cs.rel_rms(vol_p, zk)
    cs.check(e < cs.TRANSFORM_TOL, f"earlier block_inv_z within rel RMS {e:.3e} of this one")

    pairs = {
        "block_fwd_z": (p_fwd_z, lambda: fused_compress.fwd_z(vt)),
        "block_encode_xy": (p_encode_xy, lambda: fused_compress.encode_xy(tk, mf, out=buf)),
        "block_inv_xy": (p_inv_xy, lambda: fused_inverse.block_inv_xy(rows, vol.shape)),
        "block_inv_z": (p_inv_z, lambda: fused_inverse.block_inv_z(scratch_v)),
    }
    res = {}
    for name, (earlier, this) in pairs.items():
        fns = {"earlier": earlier, "this": this}
        t = ab_common.turns(ab_common.ORDER, lambda k: fns[k](), args.iters)
        res[name] = dict(earlier_ms=t["earlier"], this_ms=t["this"])
        print(f"  {name}: earlier {t['earlier'][0]:.4f}, this {t['this'][0]:.4f}, this "
              f"{t['this'][1]:.4f}, earlier {t['earlier'][1]:.4f} ms on {card}", flush=True)
    print(json.dumps({"card": card, "config": "B", "turns": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
