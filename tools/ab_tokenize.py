#!/usr/bin/env python3
"""Time the compacting tokenize (`tokenize_compact`) and the local-RMS 128^3
tokenize (`block_scale_tok`) of an earlier checkout against this one's, in
turns, on one NVIDIA card.

    git archive <commit> | tar -x -C build/parent    # the earlier checkout
    python3 tools/ab_tokenize.py --parent build/parent [--parent-probes] [--variants JSON]

Builds the earlier checkout's `cvxcompress_tpu_torch/csrc/tokenize_compact.cu`,
`block_encode_local.cu` and `tokenize_stripe.cu` into a library of their
own under build/ab_parent/, this checkout's into build/ab_this/, and
launches both libraries' kernels through their C interfaces (the same in
both) with preallocated outputs and a scratch large enough for either, on

- `block_scale_tok`: the coefficients and slice sums of `block_fwd_z` +
  `block_casc_local` (this checkout's kernels) of B's sinusoid (chip_smoke.py
  `SHAPE_B`, `SCALE`), B's local ramp (chip_smoke.py `ramp`: block RMS 10^4
  apart, a zero, a ~1e-38 and a NaN block), N(0,1) noise at B's shape (scale
  `NOISE_SCALE`) and the half-zero (512, 256, 256) volume (`SHAPE_HALF`,
  all-zero slices over whole blocks); and, as a floor, `tokenize_stripe`
  computing the same function on the (nnn * 128, 128, 128) view of the
  coefficients at the table;
- `tokenize_compact`: the block-major transform and the table of the
  CVX_FUSED_COMPACT=1 route (ops/tokenize.py `compact_encode`) of A at 32^3
  (global and local RMS), A's N(0,1) noise at 32^3, B at 128^3 and the
  half-zero volume at 128^3 and at 256^3 (a block over 1,024 tiles).

Each library's outputs are held bit-equal to the plain versions
(`scale_tok_plain`, `tokenize_compact_plain`, `tokenize_stripe_plain`), then
the two are timed in the order earlier, this, this, earlier with CUDA events
(chip_smoke.py `cuda_ms`; a call is the launcher's counter zeroing and the
kernel), and each alone by the profiler's device time of its kernel, with
the zeroing memsets' device time apart.  `--parent-probes` adds the probes
of `parent_probes`: the earlier checkout's sources with part of the work
left out (see there).  `--variants` maps names to text substitutions of this
checkout's sources, {"name": {"kernel": "tokenize_compact", "tokenize_compact.cu":
[[old, new], ...]}} (["FILE", path] first takes the file at `path`,
relative to the repo root); each is built into build/ab_variants/<name>/
with the source of its "kernel" only, held bit-equal and timed between this
checkout's turns, and with "probe": true timed without being held (a probe
of where the time goes).  Prints the card's name and power limit, one line
per kernel and input, and on the last line one JSON object with the times
in ms.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import ab_common  # noqa: E402
import chip_smoke as cs  # noqa: E402  (helpers only; its main() is not run)

SOURCES = {"tokenize_compact": "tokenize_compact.cu",
           "block_scale_tok": "block_encode_local.cu",
           "tokenize_stripe": "tokenize_stripe.cu"}
# the kernel's name in the profiler's records
KERNEL_NAMES = {k: f"{k}_kernel" for k in SOURCES}


def parent_probes(parent):
    """Probes of the earlier checkout's kernels (the design with a thread a
    64-cell run and one-word look-backs): its source, with parts of the
    work taken out (the outputs are then not held)."""
    src = os.path.join(os.path.relpath(parent, ROOT), "cvxcompress_tpu_torch", "csrc")
    compact = ["FILE", os.path.join(src, "tokenize_compact.cu")]
    local = ["FILE", os.path.join(src, "block_encode_local.cu")]
    no_run_walk = ["for (int p = 1; p <= zt; ++p) {", "for (int p = 1; p <= 0; ++p) {"]
    no_count_walk = ["for (int64_t p = tile - 1; p >= 0; --p) {",
                     "for (int64_t p = tile - 1; p >= tile; --p) {"]
    # the cost from the mask pass, the 64-cell tokenize compiled out
    no_tokenize = ["cost = tokenize64(", "cost = (int)(nonzero != 0); if (0) tokenize64("]
    no_sums = ["for (int z = 0; z < BB; ++z) ss += partials[blk * BB + z];",
               "ss = partials[blk * BB];"]
    no_lookback = ["for (int p = 1; p <= z; ++p) {", "for (int p = 1; p <= 0; ++p) {"]
    # the slice's copy in and its cells out as descriptors, nothing between
    copy_only = ["slice_tokenize(s, s_mulfac, tile, status, desc, chunk_bytes, sizes,\n"
                 "                 mulfacs, scan_buf, &s_carry);",
                 "for (int c = threadIdx.x; c < SLICE; c += BT)\n"
                 "    desc[(int64_t)tile * SLICE + c] = __float_as_int(s[(c >> 7) * PITCH + "
                 "(c & (BB - 1))]);\n"
                 "  if (threadIdx.x < SLICE / 128) chunk_bytes[(int64_t)tile * (SLICE / 128) "
                 "+ threadIdx.x] = 0;"]
    p = dict(probe=True)
    return {
        "parent no run walk": dict(p, kernel="tokenize_compact",
                                   **{"tokenize_compact.cu": [compact, no_run_walk]}),
        "parent no count walk": dict(p, kernel="tokenize_compact",
                                     **{"tokenize_compact.cu": [compact, no_count_walk]}),
        "parent copy, mask, scans, rows": dict(
            p, kernel="tokenize_compact",
            **{"tokenize_compact.cu": [compact, no_run_walk, no_count_walk, no_tokenize]}),
        "parent no sums": dict(p, kernel="block_scale_tok",
                               **{"block_encode_local.cu": [local, no_sums]}),
        "parent no look-back": dict(p, kernel="block_scale_tok",
                                    **{"block_encode_local.cu": [local],
                                       "block_common.cuh": [no_lookback]}),
        "parent copy only": dict(p, kernel="block_scale_tok",
                                 **{"block_encode_local.cu": [local, no_sums, copy_only]}),
    }


def device_total(fn, iters, match):
    """Device time per call of every record of fn's whose name holds
    `match` (the profiler's; several records a call add up)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if match in e.key) / iters / 1e3


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="the earlier checkout's root")
    ap.add_argument("--parent-probes", action="store_true",
                    help="also time the probes of the earlier checkout's kernels")
    ap.add_argument("--variants", default="{}",
                    help="JSON: name -> {kernel, file -> [[old, new]], probe}")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", choices=("tokenize_compact", "block_scale_tok"),
                    help="time one of the two kernels only")
    args = ap.parse_args()
    card = ab_common.card()
    print(card, flush=True)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from cvxcompress_tpu_torch.ops import (
        _kernels, blocks, fused_compress, geometry, quant, tokenize, wavelet,
    )

    dev = torch.device("cuda")
    sigs = {f"cvx_{k}": _kernels._SIGNATURES[f"cvx_{k}"] for k in SOURCES}
    variants = json.loads(args.variants)
    if args.parent_probes:
        variants.update(parent_probes(args.parent))
    jobs = {"earlier": lambda: ab_common.build_parent(args.parent, tuple(SOURCES.values()),
                                                      "libparent_tok", sigs),
            "this": lambda: ab_common.build_lib(
                [os.path.join(_kernels.SRC_DIR, f) for f in SOURCES.values()],
                os.path.join(ROOT, "build", "ab_this", "lib.so"), sigs)}
    for name, spec in variants.items():
        k = spec["kernel"]
        jobs[name] = (lambda n=name, s=spec, k=k: ab_common.build_variant(
            n.replace(" ", "_").replace(",", ""), s, (SOURCES[k],),
            {f"cvx_{k}": sigs[f"cvx_{k}"]}))
    _kernels.lib()  # this checkout's package, for the inputs; built beside the others
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {n: pool.submit(j) for n, j in jobs.items()}
        libs = {n: f.result() for n, f in futs.items()}

    def libs_of(kernel):
        return [n for n in libs if n in ("earlier", "this")
                or variants[n]["kernel"] == kernel]

    def call(lib, name, *a):
        rc = getattr(libs[lib], f"cvx_{name}")(*a, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{lib} {name} failed: cudaError {rc}")

    def timed(label, kernel, run, iters, bound_ms, keys=None):
        keys = keys or libs_of(kernel)
        order = ["earlier", "this", *[k for k in keys if k not in ("earlier", "this")],
                 "this", "earlier"]
        t = ab_common.turns(order, run, iters)
        dev_t = {lib: device_total(lambda: run(lib), iters, KERNEL_NAMES[kernel])
                 for lib in keys}
        mem_t = {lib: device_total(lambda: run(lib), iters, "Memset")
                 for lib in ("earlier", "this")}
        print(f"  {kernel} {label}: " + ", ".join(
            f"{k} " + " / ".join(f"{x:.4f}" for x in v) for k, v in t.items())
            + " ms; device " + ", ".join(f"{k} {x:.4f}" for k, x in dev_t.items())
            + "; memsets " + ", ".join(f"{k} {x:.4f}" for k, x in mem_t.items())
            + f" ms; bound {bound_ms:.4f} ms on {card}", flush=True)
        return dict(t, device_ms=dev_t, memset_ms=mem_t, bound_ms=bound_ms)

    def held(kernel, lib, label, ok):
        if variants.get(lib, {}).get("probe"):
            return
        cs.check(ok, f"{label}: {lib} {kernel} bit-equal to its plain version")

    res = {}
    vol_half = cs.sinusoid(*cs.SHAPE_HALF, cs.PERIODS)
    vol_half[cs.SHAPE_HALF[0] // 2:] = 0.0

    def noise(shape):
        return np.random.default_rng(0).standard_normal(shape, dtype=np.float32)

    # -- block_scale_tok (K10b) and its tokenize_stripe floor ------------------
    vol_b = cs.sinusoid(*cs.SHAPE_B, cs.PERIODS)
    local_inputs = (("B-local", lambda: vol_b, cs.SCALE),
                    ("B-local ramp", lambda: cs.ramp(vol_b, 128), cs.SCALE),
                    ("B-local noise", lambda: noise(cs.SHAPE_B), cs.NOISE_SCALE),
                    ("half-zero 128^3 local", lambda: vol_half, cs.SCALE))
    for label, make, scale in local_inputs if args.only != "tokenize_compact" else ():
        vt = torch.from_numpy(make()).to(dev)
        ck, pk = fused_compress.casc_local(fused_compress.fwd_z(vt))
        del vt
        nnn, cells = ck.shape
        plain = fused_compress.scale_tok_plain(ck, pk, scale)
        desc, cb, sizes, _ = (t.clone() for t in plain[:4])
        mf = torch.empty_like(plain[4])
        scratch = torch.empty(4 + 4 * nnn + 128 * nnn, dtype=torch.int32, device=dev)

        def run(lib):
            call(lib, "block_scale_tok", ck.data_ptr(), pk.data_ptr(), float(scale), nnn,
                 scratch.data_ptr(), desc.data_ptr(), cb.data_ptr(), sizes.data_ptr(),
                 mf.data_ptr())

        for lib in libs_of("block_scale_tok"):
            desc.fill_(-1)
            cb.fill_(-1)
            mf.fill_(-1.0)
            run(lib)
            got = (*tokenize.raw_fallback(desc, cb.clone(), sizes.clone()), mf)
            torch.cuda.synchronize()
            held("block_scale_tok", lib, label,
                 all(torch.equal(a, b) for a, b in zip(got, plain)))
        ncell = ck.numel()
        # chip_smoke.py local_b: coefficients and slice sums in; descriptors,
        # chunk counts, sizes and the table out
        bnd = cs.bound(8 * ncell + 8 * nnn * 128 + ncell // 32 + 8 * nnn, ncell)["bound_ms"]
        res[f"block_scale_tok {label}"] = timed(label, "block_scale_tok", run, args.iters,
                                                bnd)
        # the floor: tokenize_stripe on the (nnn * 128, 128, 128) view
        plane = ck.view(nnn * 128, 128, 128)
        mk = plain[4]
        sscr = torch.empty(1 + -(-ncell // tokenize.TILE), dtype=torch.int32, device=dev)
        margs = geometry.map_args(plane.shape, cs.BLOCK_B)

        def run_stripe(lib):
            call(lib, "tokenize_stripe", plane.data_ptr(), mk.data_ptr(), nnn, *margs,
                 sscr.data_ptr(), desc.data_ptr(), cb.data_ptr(), sizes.data_ptr())

        for lib in ("earlier", "this"):
            desc.fill_(-1)
            run_stripe(lib)
            got = tokenize.raw_fallback(desc, cb.clone(), sizes.clone())
            torch.cuda.synchronize()
            held("tokenize_stripe", lib, f"{label} (floor)",
                 all(torch.equal(a, b) for a, b in zip(got, plain)))
        res[f"tokenize_stripe floor {label}"] = timed(
            f"{label} (the floor)", "tokenize_stripe", run_stripe, args.iters,
            cs.bound(8 * ncell + ncell // 32 + 8 * nnn, ncell)["bound_ms"],
            keys=["earlier", "this"])
        del ck, pk, plain, desc, cb, sizes, mf, scratch, plane, mk, sscr
        torch.cuda.empty_cache()
    del vol_b

    # -- tokenize_compact (K14) -------------------------------------------------
    vol_a = cs.sinusoid(*cs.SHAPE, cs.PERIODS)
    compact_inputs = (("A", lambda: vol_a, cs.BLOCK_A, cs.SCALE, False),
                      ("A-local", lambda: vol_a, cs.BLOCK_A, cs.SCALE, True),
                      ("A noise", lambda: noise(cs.SHAPE), cs.BLOCK_A, cs.NOISE_SCALE, False),
                      ("B", lambda: cs.sinusoid(*cs.SHAPE_B, cs.PERIODS), cs.BLOCK_B,
                       cs.SCALE, False),
                      ("half-zero 128^3", lambda: vol_half, cs.BLOCK_B, cs.SCALE, False),
                      ("half-zero 256^3", lambda: vol_half, (256, 256, 256), cs.SCALE,
                       False))
    for label, make, block, scale, local in (compact_inputs if args.only != "block_scale_tok"
                                             else ()):
        v = make()
        kw = dict(scale=scale) if local else dict(mulfac=quant.global_mulfac(v, scale))
        vt = torch.from_numpy(v).to(dev)
        bx, by, _ = block
        coeffs = wavelet.forward_blocks(blocks.to_blocks(vt, block))  # compact_encode's
        coeffs = coeffs.reshape(coeffs.shape[0], -1)
        mk = quant.block_table(coeffs.view(-1, by, bx), block, **kw)
        del vt
        nnn, cells = coeffs.shape
        plain = tokenize.tokenize_compact_plain(coeffs, mk)
        n = plain[3].shape[0]
        nchunks = coeffs.numel() // 128
        cb = torch.empty(nchunks, dtype=torch.int32, device=dev)
        sizes = torch.empty(nnn, dtype=torch.int32, device=dev)
        rows = torch.empty((nchunks, 128), dtype=torch.float32, device=dev)
        drows = torch.empty((nchunks, 128), dtype=torch.int32, device=dev)
        ids = torch.empty(nchunks, dtype=torch.int32, device=dev)
        rbytes = torch.empty(nchunks, dtype=torch.int32, device=dev)
        nrows = torch.zeros(1, dtype=torch.int32, device=dev)
        ntiles = -(-coeffs.numel() // tokenize.TILE)
        scratch = torch.empty(2 + 2 * ntiles, dtype=torch.int64, device=dev)

        def run(lib):
            call(lib, "tokenize_compact", coeffs.data_ptr(), mk.data_ptr(), nnn,
                 cells.bit_length() - 1, scratch.data_ptr(), cb.data_ptr(),
                 sizes.data_ptr(), rows.data_ptr(), drows.data_ptr(), ids.data_ptr(),
                 rbytes.data_ptr(), nrows.data_ptr())

        for lib in libs_of("tokenize_compact"):
            for t in (cb, ids, rbytes, nrows, drows):
                t.fill_(-1)
            run(lib)
            got = tokenize._raw_decision(cb.clone(), sizes.clone(), cells)
            torch.cuda.synchronize()
            k = int(nrows[0])
            held("tokenize_compact", lib, label, k == n and all(
                torch.equal(a, b) for a, b in zip(got, plain[:3])) and all(
                torch.equal(a[:n], b) for a, b in zip((rows, drows, ids, rbytes),
                                                      plain[3:7])))
        ncell = coeffs.numel()
        # chip_smoke.py compact_kernels: coefficients and table in; chunk
        # counts, sizes, the live rows (1 KiB, id and count each) out
        bnd = cs.bound(4 * ncell + 8 * nnn + 4 * nchunks + n * (1024 + 8), 0)["bound_ms"]
        print(f"  {label}: {nnn} blocks of {cells} cells, {ntiles} tiles, {n} live rows "
              f"of {nchunks}", flush=True)
        res[f"tokenize_compact {label}"] = timed(label, "tokenize_compact", run,
                                                 args.iters, bnd)
        del coeffs, mk, plain, cb, sizes, rows, drows, ids, rbytes, nrows, scratch
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "turns": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
