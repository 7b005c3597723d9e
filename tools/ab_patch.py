#!/usr/bin/env python3
"""Time an earlier checkout's `patch_extract` (K17) against this one's, in
turns, on one NVIDIA card.

    git archive <commit> | tar -x -C build/parent    # the earlier checkout
    python3 tools/ab_patch.py --parent build/parent [--variants JSON]

Builds the earlier checkout's `cvxcompress_tpu_torch/csrc/patch_extract.cu`
into build/ab_parent/libparent_patch.so, this checkout's into
build/ab_this/libpatch.so and tools/patch_extract_tma.cu (the copy by TMA
bulk copies, same interface) into build/ab_variants/tma/, and launches them
through their C interfaces with preallocated outputs, on the stripe
route's encode (`tokenize.encode`, this checkout's kernels) of: A 32^3 (the
reference CI volume, chip_smoke.py `SHAPE`, `SCALE`), A-64^3, A 32^3 ramp
(chip_smoke.py `ramp`), A 32^3 noise (N(0,1) at `NOISE_SCALE`, every chunk
live) and A at (8, 16, 8).  The earlier kernel takes each live chunk's row
from the wrapper's PyTorch ops (live mask, cumsum, subtraction), so its
turn runs those ops and its kernel, as its wrapper does; this one's turn is
its launcher (the scratch's memset and the kernel).

Every build's rows, descriptors and ids are held bit-equal to
`patch_extract_plain`, then the builds are timed in the order earlier,
this, the variants, this, earlier with CUDA events (chip_smoke.py
`cuda_ms`), and each alone by the profiler's device time of all its
records (for the earlier build also its kernel and its PyTorch ops apart).
Beside them a yardstick that is not the function: two library calls with
the addresses precomputed, `plane.view(-1)[addr]` and
`desc.view(-1, 128).index_select(0, ids)`.  `--variants` maps names to
text substitutions of this checkout's patch_extract.cu, {"name":
{"patch_extract.cu": [[old, new], ...]}} (["FILE", path] first takes the
file at `path`, relative to the repo root), each held and timed like the
TMA design (`"probe": true`: timed without being held, a probe of where
the time goes).  Prints the card's name and power limit, one line per input,
and on the last line one JSON object with the times in ms.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import ab_common  # noqa: E402
import chip_smoke as cs  # noqa: E402  (helpers only; its main() is not run)

_VP, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# the earlier checkout's C signature: a row per chunk from the wrapper (pos)
PARENT_SIGNATURES = {
    "cvx_patch_extract": [_VP, _VP, _VP, _VP, _I64, _I, _I, _I, _I64, _I64, _I64, _I64,
                          _VP, _VP, _VP, _VP],
}
TMA = {"patch_extract.cu": [["FILE", "tools/patch_extract_tma.cu"]]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="the earlier checkout's root")
    ap.add_argument("--variants", default="{}",
                    help="JSON: name -> {patch_extract.cu: [[old, new]]}")
    ap.add_argument("--iters", type=int, default=40)
    args = ap.parse_args()
    card = ab_common.card()
    print(card, flush=True)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from cvxcompress_tpu_torch.ops import _kernels, geometry, pack, quant, tokenize

    dev = torch.device("cuda")
    sigs = {"cvx_patch_extract": _kernels._SIGNATURES["cvx_patch_extract"]}
    variants = dict(tma=TMA, **json.loads(args.variants))
    jobs = {"earlier": lambda: ab_common.build_parent(
                args.parent, ("patch_extract.cu",), "libparent_patch", PARENT_SIGNATURES),
            "this": lambda: ab_common.build_lib(
                [os.path.join(_kernels.SRC_DIR, "patch_extract.cu")],
                os.path.join(ROOT, "build", "ab_this", "libpatch.so"), sigs)}
    for name, spec in variants.items():
        jobs[name] = (lambda n=name, s=spec: ab_common.build_variant(
            n.replace(" ", "_"), s, ("patch_extract.cu",), sigs))
    _kernels.lib()  # this checkout's package, for the inputs
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {n: pool.submit(j) for n, j in jobs.items()}
        libs = {n: f.result() for n, f in futs.items()}

    def call(lib, *a):
        rc = libs[lib].cvx_patch_extract(*a, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{lib} patch_extract failed: cudaError {rc}")

    def device_split(fn, iters, match):
        """Device time per call of all fn's records, and of those whose
        name holds `match`, the profiler's."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ev = prof.key_averages()
        total = sum(e.device_time_total for e in ev) / iters / 1e3
        part = sum(e.device_time_total for e in ev if match in e.key) / iters / 1e3
        return total, part

    res = {}

    def case(label, v, block, scale):
        t = torch.from_numpy(v).to(dev)
        c, dk, cbk, _, _, _ = tokenize.encode(t, block, quant.global_mulfac(v, scale))
        del t
        nchunks = cbk.numel()
        n = int((cbk > 0).sum())
        want = pack.patch_extract_plain(c, dk, cbk, block, n)
        margs = geometry.map_args(c.shape, block)
        outs = {k: (torch.empty((n, 128), dtype=torch.float32, device=dev),
                    torch.empty((n, 128), dtype=torch.int32, device=dev),
                    torch.empty(n, dtype=torch.int32, device=dev)) for k in libs}
        scratch = torch.empty(1 + -(-nchunks // pack.PATCH_TILE), dtype=torch.int32,
                              device=dev)

        def parent_pos():  # the earlier wrapper's PyTorch ops
            live = (cbk > 0).to(torch.int32)
            return torch.cumsum(live, 0, dtype=torch.int32) - live

        def parent_kernel(pos):
            r, d, i = outs["earlier"]
            call("earlier", c.data_ptr(), dk.data_ptr(), cbk.data_ptr(), pos.data_ptr(),
                 nchunks, *margs, r.data_ptr(), d.data_ptr(), i.data_ptr())

        def this(k):
            r, d, i = outs[k]
            call(k, c.data_ptr(), dk.data_ptr(), cbk.data_ptr(), nchunks, n, *margs,
                 scratch.data_ptr(), r.data_ptr(), d.data_ptr(), i.data_ptr())

        runs = {k: (lambda k=k: this(k)) for k in libs if k != "earlier"}
        runs["earlier"] = lambda: parent_kernel(parent_pos())
        for k, run in runs.items():
            for o in outs[k]:
                o.fill_(-1)
            run()
            if variants.get(k, {}).get("probe"):
                continue
            cs.check(all(torch.equal(a, b) for a, b in zip(outs[k], want)),
                     f"{label}: {k} patch_extract rows, descriptors and ids ({n} live of "
                     f"{nchunks} chunks) bit-equal to patch_extract_plain")
        # the yardstick: two library calls over precomputed addresses
        ids = want[2].to(torch.int64)
        cpb = dk.shape[1] // 128
        cell = (ids % cpb)[:, None] * 128 + torch.arange(128, device=dev)
        addr = geometry.stripe_addr(ids[:, None] // cpb, cell, c.shape, block)
        flat, d128 = c.view(-1), dk.view(-1, 128)
        runs["library"] = lambda: (flat[addr], d128.index_select(0, ids))
        del want
        order = ["earlier", "this", *variants, "this", "earlier", "library"]
        tt = ab_common.turns(order, lambda k: runs[k](), args.iters)
        dev_t = {k: device_split(runs[k], args.iters, "patch_extract_kernel")[0]
                 for k in runs}
        etot, ekern = device_split(runs["earlier"], args.iters, "patch_extract_kernel")
        pos = parent_pos()
        dev_t.update(earlier=etot, earlier_kernel=ekern, earlier_ops=etot - ekern,
                     earlier_kernel_alone=device_split(lambda: parent_kernel(pos),
                                                       args.iters,
                                                       "patch_extract_kernel")[1])
        bnd = cs.bound(4 * nchunks + n * (2048 + 4), 0)["bound_ms"]
        print(f"  {label}: {n} live of {nchunks} chunks; events " + ", ".join(
            f"{k} " + " / ".join(f"{x:.4f}" for x in v) for k, v in tt.items())
              + " ms; device " + ", ".join(f"{k} {x:.4f}" for k, x in dev_t.items())
              + f" ms; bound {bnd:.4f} ms on {card}", flush=True)
        res[label] = dict(tt, device_ms=dev_t, bound_ms=bnd, live=n, chunks=nchunks)
        del c, dk, cbk, outs, scratch, addr, cell, ids
        torch.cuda.empty_cache()

    vol = cs.sinusoid(*cs.SHAPE, cs.PERIODS)
    case("A 32^3", vol, (32, 32, 32), cs.SCALE)
    case("A-64^3", vol, (64, 64, 64), cs.SCALE)
    case("A (8, 16, 8)", vol, (8, 16, 8), cs.SCALE)
    case("A 32^3 ramp", cs.ramp(vol, 32), (32, 32, 32), cs.SCALE)
    del vol
    case("A 32^3 noise", np.random.default_rng(0).standard_normal(cs.SHAPE, dtype=np.float32),
         (32, 32, 32), cs.NOISE_SCALE)
    print(json.dumps({"card": card, "turns": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
