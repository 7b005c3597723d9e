#!/usr/bin/env python3
"""Time an earlier checkout's plane transforms (`plane_cascade_fwd`,
`plane_cascade_inv`) against this one's, in turns, on one NVIDIA card.

    git archive <commit> | tar -x -C build/parent    # the earlier checkout
    python3 tools/ab_plane.py --parent build/parent

Builds the earlier checkout's `cvxcompress_tpu_torch/csrc/plane_cascade.cu`
into build/ab_parent/libparent_plane.so, and launches both builds through
their C interfaces with preallocated outputs at A-8^3, A-64^3 and A-256^3
(config A's sinusoid, chip_smoke.py `SHAPE`):

- forward into the volume-order plane (the stripe and patch routes);
- forward into the block-major batch (the compact route and the snapshot
  stack): the earlier turn is `blocks.to_blocks` of the volume and its
  kernel on that batch, as its callers ran it;
- inverse of the block-major coefficients into the volume: the earlier
  turn is its kernel on the batch and `blocks.from_blocks`, as its decode
  ran it; this one's writes the volume itself.

Each earlier output is held uint32-equal to this one's, then the pairs are
timed in the order earlier, this, this, earlier with CUDA events
(chip_smoke.py `cuda_ms`), beside the bound (chip_smoke.py `bound`), and
each of this build's passes alone by the profiler's device time of its
launch.  `--variants` maps names to text substitutions of this checkout's
plane_cascade.cu, {"name": {"plane_cascade.cu": [[old, new], ...]}}, each
built under build/ab_variants/ and timed in turns with this build (this,
variant, variant, this), held uint32-equal to it unless `"probe": true`
(a probe that leaves out part of the work); `"plan_ltile": n` builds the
variant's plans for tiles of 2^n cells.  Prints the card's name and
power limit, this build's ptxas lines for plane_cascade.cu, one line per
pair, and on the last line one JSON object with the times in ms.
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
# the earlier launches: the volume's (or the batch's) strides and shape, the
# block, the output
PARENT_SIGNATURES = {
    f"cvx_plane_cascade_{d}": [_VP, _I64, _I64, _I64, _I, _I, _I, _I, _I, _I, _VP, _VP]
    for d in ("fwd", "inv")
}
CELLS = (("A-8^3", (8, 8, 8)), ("A-64^3", (64, 64, 64)), ("A-256^3", (256, 256, 256)))


def ptxas_lines(log, source="plane_cascade.cu"):
    """The register and shared-memory lines of `source` in an nvcc -Xptxas -v
    log (_kernels.build_info["log"])."""
    out, on = [], False
    for line in log.splitlines():
        if line.startswith("== "):
            on = line[3:].strip() == source
        elif on and ("registers" in line or "spill" in line or "Compiling" in line):
            out.append(line.strip())
    return out


def pass_ms(fn, iters=5):
    """The profiler's mean device ms of each `pc_pass` launch of one fn()
    call, in launch order (the earlier build's kernels have other names)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if "pc_pass" in e.name and e.device_time_total > 0]
    if not ev or len(ev) % iters:
        return []
    k = len(ev) // iters
    return [round(sum(e.device_time_total for e in ev[i::k]) / iters / 1e3, 4)
            for i in range(k)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="the earlier checkout's root")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--variants", default="{}",
                    help="JSON: name -> {plane_cascade.cu: [[old, new]], probe: bool}")
    args = ap.parse_args()
    card = ab_common.card()
    print(card, flush=True)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from cvxcompress_tpu_torch.ops import _kernels, blocks, wavelet

    plib = ab_common.build_parent(args.parent, ("plane_cascade.cu",), "libparent_plane",
                                  PARENT_SIGNATURES)
    sigs = {f"cvx_plane_cascade_{d}": _kernels._SIGNATURES[f"cvx_plane_cascade_{d}"]
            for d in ("fwd", "inv")}
    variants = {name: (ab_common.build_variant(name, subs, ("plane_cascade.cu",), sigs),
                       bool(subs.get("probe")), subs.get("plan_ltile", wavelet.PLAN_LTILE))
                for name, subs in json.loads(args.variants).items()}
    _kernels.lib()
    ptx = ptxas_lines(_kernels.build_info.get("log", ""))
    for line in ptx:
        print(f"  ptxas: {line[:200]}")
    dev = torch.device("cuda")

    def call(name, *a):
        rc = getattr(plib, f"cvx_{name}")(*a, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"earlier {name} failed: cudaError {rc}")

    vol = cs.sinusoid(*cs.SHAPE, cs.PERIODS)
    vt = torch.from_numpy(vol).to(dev)
    res = {}
    for cell, block in CELLS:
        bx, by, bz = block
        shape = tuple(vol.shape)
        nnn = math.prod(blocks.grid_shape(shape, block))
        padded = wavelet._padded(shape, block)
        cells = math.prod(padded)
        plane_p = torch.empty(padded, dtype=torch.float32, device=dev)
        plane_t = torch.empty_like(plane_p)
        batch_t = torch.empty((nnn, bz, by, bx), dtype=torch.float32, device=dev)
        vol_t = torch.empty_like(vt)
        scratch = torch.empty(padded, dtype=torch.float32, device=dev)
        def make_plans(ltile=wavelet.PLAN_LTILE):
            keep, wavelet.PLAN_LTILE = wavelet.PLAN_LTILE, ltile
            try:
                return {k: wavelet.launch_plan(block, inv, lay) for k, inv, lay in (
                    ("plane", False, wavelet.PLANE), ("blocks", False, wavelet.BLOCKS),
                    ("inv", True, wavelet.PLANE))}
            finally:
                wavelet.PLAN_LTILE = keep

        plans = make_plans()

        def launcher(lib, name):
            if lib is None:
                return lambda *a: _kernels.launch(name, *a)

            def go(*a):
                rc = getattr(lib, f"cvx_{name}")(*a, torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"variant {name} failed: cudaError {rc}")
            return go

        def this_fwd(out, key, lib=None, plans=plans):
            plan = plans[key]
            launcher(lib, "plane_cascade_fwd")(
                vt.data_ptr(), *vt.stride(), *shape, *block, plan.ctypes.data, len(plan),
                out.data_ptr(), None)

        def earlier_fwd(src, out):
            call("plane_cascade_fwd", src.data_ptr(), *src.stride(), *src.shape, *block,
                 out.data_ptr())

        def earlier_blocks():
            b = blocks.to_blocks(vt, block)
            out = torch.empty_like(b)
            earlier_fwd(b.view(nnn * bz, by, bx), out)
            return out

        def this_inv(coeffs, lib=None, out=vol_t, plans=plans):
            plan = plans["inv"]
            launcher(lib, "plane_cascade_inv")(
                coeffs.data_ptr(), *shape, *block, plan.ctypes.data, len(plan),
                out.data_ptr(), scratch.data_ptr())

        def earlier_inv(coeffs):
            out = torch.empty_like(coeffs)
            c = coeffs.view(nnn * bz, by, bx)
            call("plane_cascade_inv", c.data_ptr(), *c.stride(), *c.shape, *block,
                 out.data_ptr())
            return blocks.from_blocks(out, shape, block)

        earlier_fwd(vt, plane_p)
        this_fwd(plane_t, "plane")
        this_fwd(batch_t, "blocks")
        eb = earlier_blocks()
        torch.cuda.synchronize()
        for name, a, b in (("forward plane", plane_p, plane_t),
                           ("forward blocks", eb, batch_t)):
            nd = cs.u32_differ(a, b)
            cs.check(nd == 0, f"{cell}: {name} uint32-equal in both builds ({nd} differ)")
        coeffs = batch_t.clone()
        ev = earlier_inv(coeffs)
        this_inv(coeffs)
        torch.cuda.synchronize()
        nd = cs.u32_differ(ev, vol_t)
        cs.check(nd == 0, f"{cell}: inverse into the volume uint32-equal in both builds "
                 f"({nd} differ)")
        del eb, ev
        fl = sum(cs.cascade_flops(n) for n in block if n > 1) * cells
        fl_inv = sum(cs.cascade_flops(n, True) for n in block if n > 1) * cells
        pairs = {
            "forward plane": (lambda: earlier_fwd(vt, plane_p),
                              lambda: this_fwd(plane_t, "plane"),
                              cs.bound(4 * vol.size + 4 * cells, fl)),
            "forward blocks": (earlier_blocks, lambda: this_fwd(batch_t, "blocks"),
                               cs.bound(4 * vol.size + 4 * cells, fl)),
            "inverse into the volume": (lambda: earlier_inv(coeffs), lambda: this_inv(coeffs),
                                        cs.bound(4 * cells + 4 * vol.size, fl_inv)),
        }
        for name, (earlier, this, bnd) in pairs.items():
            fns = {"earlier": earlier, "this": this}
            t = ab_common.turns(ab_common.ORDER, lambda k: fns[k](), args.iters)
            r = res[f"{name} {cell}"] = dict(earlier_ms=t["earlier"], this_ms=t["this"],
                                             passes_device_ms=pass_ms(this), **bnd)
            print(f"  {name} {cell}: earlier {t['earlier'][0]:.4f}, this {t['this'][0]:.4f}, "
                  f"this {t['this'][1]:.4f}, earlier {t['earlier'][1]:.4f} ms, bound "
                  f"{bnd['bound_ms']:.4f} ms; passes {r['passes_device_ms']} on {card}",
                  flush=True)
        # the variants against this build, in turns
        vout = {"forward plane": torch.empty_like(plane_t),
                "forward blocks": torch.empty_like(batch_t),
                "inverse into the volume": torch.empty_like(vol_t)}
        for vname, (vlib, probe, ltile) in variants.items():
            vp = make_plans(ltile)
            vfns = {"forward plane": lambda o, lb, ps: this_fwd(o, "plane", lb, ps),
                    "forward blocks": lambda o, lb, ps: this_fwd(o, "blocks", lb, ps),
                    "inverse into the volume": lambda o, lb, ps: this_inv(coeffs, lb, o, ps)}
            for name, fn in vfns.items():
                ref = {"forward plane": plane_t, "forward blocks": batch_t,
                       "inverse into the volume": vol_t}[name]
                fn(vout[name], vlib, vp)
                torch.cuda.synchronize()
                if not probe:
                    nd = cs.u32_differ(vout[name], ref)
                    cs.check(nd == 0, f"{cell}: {name} of variant {vname} uint32-equal to "
                             f"this build's ({nd} differ)")
                fns = {"this": lambda: fn(vout[name], None, plans),
                       vname: lambda: fn(vout[name], vlib, vp)}
                t = ab_common.turns(("this", vname, vname, "this"), lambda k: fns[k](),
                                    args.iters)
                res[f"{name} {cell} variant {vname}"] = dict(
                    this_ms=t["this"], variant_ms=t[vname], probe=probe,
                    passes_device_ms=pass_ms(fns[vname]))
                print(f"  {name} {cell} variant {vname}{' (probe)' if probe else ''}: this "
                      f"{t['this'][0]:.4f}, variant {t[vname][0]:.4f}, {t[vname][1]:.4f}, "
                      f"this {t['this'][1]:.4f} ms; passes "
                      f"{res[f'{name} {cell} variant {vname}']['passes_device_ms']}",
                      flush=True)
        del vout
        del plane_p, plane_t, batch_t, vol_t, scratch, coeffs
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "ptxas": ptx, "turns": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
