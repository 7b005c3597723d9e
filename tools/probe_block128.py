#!/usr/bin/env python3
"""Break the 128^3 transform launches' time down on one NVIDIA card.

    python3 tools/probe_block128.py

At config B (the (384, 384, 384) sinusoid, 128^3 blocks) it times, with
CUDA events (chip_smoke.py `cuda_ms`):
- the shipped launches `block_fwd_z`, `block_encode_xy`, `block_inv_xy`,
  `block_inv_z`, and `block_scale_tok` (the same slice tokenize as
  `block_encode_xy`, without the cascades);
- `block_fwd_z`'s slab round trip with 0, 1, 2 and 4 column cascades, one
  row cascade and one inverse column cascade (tools/probe_block128.cu
  `probe_slab`): the copies alone, and the marginal cost of a cascade pass
  at three CTAs per SM;
- `block_fwd_z` as one persistent CTA per SM double-buffering its slabs
  with cp.async (`probe_fwd_z_persistent`), held bit-equal to the shipped
  launch.
Prints the card's name and power limit, one line per time, and on the last
line one JSON object with the times in ms.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (helpers only; its main() is not run)

VARIANTS = ("copies only", "1 column cascade", "2 column cascades",
            "4 column cascades", "1 row cascade", "1 inverse column cascade")


def build():
    from cvxcompress_tpu_torch.ops import _kernels

    out = os.path.join(ROOT, "build", "probe")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libprobe128.so")
    subprocess.run([_kernels._nvcc(), *_kernels.ARCH_FLAGS, "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v", "-I",
                    _kernels.SRC_DIR, "-o", so,
                    os.path.join(ROOT, "tools", "probe_block128.cu")], check=True)
    lib = ctypes.CDLL(so)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_slab.argtypes = [i, vp, i, i, i, vp, vp]
    lib.probe_fwd_z_persistent.argtypes = [vp, i, i, i, i, vp, vp]
    return lib


def main():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from cvxcompress_tpu_torch.ops import fused_compress, fused_inverse, quant

    lib = build()
    dev = torch.device("cuda")
    vol = cs.sinusoid(*cs.SHAPE_B, cs.PERIODS)
    vt = torch.from_numpy(vol).to(dev)
    nz, ny, nx = vol.shape
    mf = quant.global_mulfac(vol, cs.SCALE)
    st = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    out = torch.empty((vol.size // 128 ** 3, 128 ** 3), dtype=torch.float32, device=dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def run(rc):
        if rc:
            raise RuntimeError(f"probe launch failed: {rc}")

    tk = fused_compress.fwd_z(vt)
    run(lib.probe_fwd_z_persistent(vt.data_ptr(), nx, ny, nz, sms, out.data_ptr(), st()))
    torch.cuda.synchronize()
    cs.check(torch.equal(out, tk), "persistent block_fwd_z bit-equal to the shipped one")
    buf = torch.empty_like(tk)
    ck = fused_compress.encode_xy(tk, mf, out=buf)[0].clone()
    _, partials = fused_compress.casc_local(tk.clone())
    rows = ck.view(-1, 128)
    xk = fused_inverse.block_inv_xy(rows, vol.shape)
    scratch = xk.clone()
    res = {}
    timed = {
        "block_fwd_z": lambda: fused_compress.fwd_z(vt),
        "block_encode_xy": lambda: fused_compress.encode_xy(tk, mf, out=buf),
        "block_inv_xy": lambda: fused_inverse.block_inv_xy(rows, vol.shape),
        "block_inv_z": lambda: fused_inverse.block_inv_z(scratch),
        "block_scale_tok": lambda: fused_compress.scale_tok(ck, partials, cs.SCALE),
        **{f"slab, {name}": (lambda v=v: run(lib.probe_slab(
            v, vt.data_ptr(), nx, ny, nz, out.data_ptr(), st())))
           for v, name in enumerate(VARIANTS)},
        f"block_fwd_z persistent ({sms} CTAs, cp.async double buffer)":
            lambda: run(lib.probe_fwd_z_persistent(vt.data_ptr(), nx, ny, nz, sms,
                                                   out.data_ptr(), st())),
    }
    for name, fn in timed.items():
        res[name] = cs.cuda_ms(fn, 20)
        print(f"  {name}: {res[name]:.4f} ms on {card}", flush=True)
    res["block_fwd_z again"] = cs.cuda_ms(timed["block_fwd_z"], 20)
    print(f"  block_fwd_z again: {res['block_fwd_z again']:.4f} ms on {card}")
    print(json.dumps({"card": card, "config": "B", "ms": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
