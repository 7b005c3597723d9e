#!/usr/bin/env python3
"""Time the payload emit of an earlier checkout against this one's, in
turns, on one NVIDIA card: the 32^3 route's `emit_payload` (a CTA a block
over every descriptor) against this `block_emit` (persistent warps over
windows of 32 chunk counts, only the live chunks read), `block_emit` and
`block_emit_rows` of both at every other route's inputs, and `fused_encode`
/ `fused_encode_local` of both (this one also writes the chunk counts).

    git archive <commit> | tar -x -C build/parent    # the earlier checkout
    python3 tools/ab_emit.py --parent build/parent [--parent-probes] [--variants JSON]

Builds the earlier checkout's `cvxcompress_tpu_torch/csrc/fused_encode.cu`,
`emit_payload.cu` and `block_emit.cu` into build/ab_parent/libparent_emit.so,
this checkout's `fused_encode.cu` and `block_emit.cu` into
build/ab_this/libemit.so, and launches both through their C interfaces with
preallocated outputs, on the encode outputs of this checkout's kernels:

- the 32^3 emit at A (chip_smoke.py `SHAPE`, `SCALE`) and A-local: the
  earlier `emit_payload` on the block bases, the earlier `block_emit` and
  this one on the chunk bases;
- `block_emit` at B (128^3; also B's N(0,1) noise at `NOISE_SCALE`, every
  chunk live), A at 8^3, 64^3, 256^3 and (64, 32, 32), S at 16^3
  (`SHAPE_S`) and the half-zero volume (`SHAPE_HALF`) at 256^3;
- `block_emit_rows` on the rows of A's CVX_STRIPE=patch route and of A's
  and B's CVX_FUSED_COMPACT=1 route;
- `fused_encode` at A and `fused_encode_local` at A-local.

At every input also the device time of the codec's chunk-base arithmetic
(`pack.chunk_bases`: the PyTorch kernels of the int64 cast, cumsum and
subtraction; at A and A-local the earlier route's block bases too).
Every output of both builds is held bit-equal to the plain versions
(`emit_chunks_plain`, `emit_rows_plain`, `fused_encode_plain`), then the two
are timed in the order earlier, this, this, earlier with CUDA events
(chip_smoke.py `cuda_ms`), and each alone by the profiler's device time of
its kernel.  `--parent-probes` adds the earlier `block_emit` with its work
cut short at B: "parent launch only" returns at its first line (the CTA
waves), "parent counts only" after the warp's vote on its two counts (the
count reads).  `--variants` maps names to text substitutions of this
checkout's block_emit.cu, {"name": {"block_emit.cu": [[old, new], ...]}}
or of its fused_encode.cu and common.cuh (["FILE", path] first takes the
file at `path`, relative to the repo root), each built into
build/ab_variants/<name>/, held bit-equal and timed between this
checkout's turns at every input of `block_emit` and `fused_encode`
(`"only": "emit"` or `"encode"` at one kind; `"probe": true` timed without
being held, a probe of where the time goes).  Prints the
card's name and power limit, one line per kernel and input, and on the
last line one JSON object with the times in ms.
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

_VP, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# the earlier checkout's C signatures where they differ from this one's
PARENT_SIGNATURES = {
    "cvx_fused_encode": [_VP, _I, _I, _I, _F, _VP, _VP, _VP, _VP, _VP, _VP],
    "cvx_fused_encode_local": [_VP, _I, _I, _I, _F, _VP, _VP, _VP, _VP, _VP, _VP],
    "cvx_emit_payload": [_VP, _VP, _VP, _VP, _VP, _I64, _VP, _VP],
}
EMIT_NAMES = ("cvx_block_emit", "cvx_block_emit_rows")


def parent_probes(parent):
    """The earlier block_emit.cu with its work cut short (outputs not held)."""
    src = ["FILE", os.path.join(os.path.relpath(parent, ROOT), "cvxcompress_tpu_torch",
                                "csrc", "block_emit.cu")]
    first = "  constexpr int CW = 8 * LPC;  // cells per chunk\n"
    vote = "  if (!__any_sync(0xffffffffu, live)) return;  // uniform over the warp"
    return {
        "parent launch only": {"probe": True, "only": "emit", "b_only": True, "block_emit.cu": [
            src, [first, "  if (n >= 0) return;\n" + first]]},
        "parent counts only": {"probe": True, "only": "emit", "b_only": True,
                               "block_emit.cu": [
            src, [vote, "  if (__any_sync(0xffffffffu, live) || n >= 0) return;"]]},
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="the earlier checkout's root")
    ap.add_argument("--parent-probes", action="store_true",
                    help="also time the probes of the earlier block_emit at B")
    ap.add_argument("--variants", default="{}",
                    help="JSON: name -> {block_emit.cu: [[old, new]], probe}")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    card = ab_common.card()
    print(card, flush=True)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from cvxcompress_tpu_torch.ops import (
        _kernels, codec, fused_compress, geometry, pack, quant, rle_device, tokenize,
    )

    dev = torch.device("cuda")
    sigs = {k: _kernels._SIGNATURES[k] for k in ("cvx_fused_encode", "cvx_fused_encode_local",
                                                 *EMIT_NAMES)}
    psigs = dict(PARENT_SIGNATURES, **{k: sigs[k] for k in EMIT_NAMES})
    variants = json.loads(args.variants)
    if args.parent_probes:
        variants.update(parent_probes(args.parent))
    jobs = {"earlier": lambda: ab_common.build_parent(
                args.parent, ("fused_encode.cu", "emit_payload.cu", "block_emit.cu"),
                "libparent_emit", psigs),
            "this": lambda: ab_common.build_lib(
                [os.path.join(_kernels.SRC_DIR, f) for f in ("fused_encode.cu",
                                                             "block_emit.cu")],
                os.path.join(ROOT, "build", "ab_this", "libemit.so"), sigs)}
    for name, spec in variants.items():
        jobs[name] = (lambda n=name, s=spec: ab_common.build_variant(
            n.replace(" ", "_"), s, ("fused_encode.cu", "block_emit.cu"), sigs))
    _kernels.lib()  # this checkout's package, for the inputs
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {n: pool.submit(j) for n, j in jobs.items()}
        libs = {n: f.result() for n, f in futs.items()}

    def variants_at(where, at_b=False):
        """The variants timed at `where` ("emit" or "encode"); the earlier
        checkout's probes only at B (`at_b`)."""
        return [n for n, sp in variants.items() if sp.get("only", where) == where
                and (at_b or not sp.get("b_only"))]

    def call(lib, name, *a):
        rc = getattr(libs[lib], f"cvx_{name}")(*a, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{lib} {name} failed: cudaError {rc}")

    def device_total(fn, iters, match):
        """Device time per call of fn's records whose name holds `match`
        ("" for all of them), the profiler's."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        return sum(e.device_time_total for e in prof.key_averages()
                   if match in e.key) / iters / 1e3

    def timed(label, runs, names, bound_ms, iters=args.iters):
        """`runs` maps a key to a launch; turns earlier, this, the rest,
        this, earlier; then each alone by the device time of the kernels
        in `names` (key -> kernel name)."""
        order = ["earlier", "this", *[k for k in runs if k not in ("earlier", "this")],
                 "this", "earlier"]
        t = ab_common.turns(order, lambda k: runs[k](), iters)
        dev_t = {k: device_total(runs[k], iters, names.get(k, "block_emit_kernel"))
                 for k in runs}
        print(f"  {label}: " + ", ".join(f"{k} " + " / ".join(f"{x:.4f}" for x in v)
                                         for k, v in t.items())
              + " ms; device " + ", ".join(f"{k} {x:.4f}" for k, x in dev_t.items())
              + f" ms; bound {bound_ms:.4f} ms on {card}", flush=True)
        return dict(t, device_ms=dev_t, bound_ms=bound_ms)

    res = {}

    def eq(a, b):
        """Bit-equal, f32 as int32 (NaN payloads too), a uint8 flag as b's type."""
        if a.dtype == torch.float32:
            return torch.equal(a.view(torch.int32), b.view(torch.int32))
        return torch.equal(a.to(b.dtype), b)

    def emit_case(label, c, mk, dk, cbk, block=None, parent_payload=None, probes=False):
        """block_emit of every build on one input, held and timed; with
        `parent_payload` (sizes, raw) also the earlier emit_payload."""
        nnn, cells = dk.shape
        chunk = rle_device.chunk_cells(cells)
        base = pack.chunk_bases(cbk)
        total = int(cbk.sum())
        stripe = (1, *geometry.map_args(c.shape, block)) if block else (0,) * 8
        eargs = (c.data_ptr(), mk.data_ptr(), dk.data_ptr(), cbk.data_ptr(), base.data_ptr(),
                 cbk.numel(), chunk.bit_length() - 1, (cells // chunk).bit_length() - 1,
                 *stripe)
        want = pack.emit_chunks_plain(c, mk, dk, cbk, base, total, block)
        out = torch.empty(max(total, 1), dtype=torch.uint8, device=dev)
        keys = ["earlier", "this", *variants_at("emit", probes)]
        runs = {k: (lambda k=k: call(k, "block_emit", *eargs, out.data_ptr()))
                for k in keys}
        for k in keys:
            if variants.get(k, {}).get("probe"):
                continue
            out.fill_(0xA5)
            runs[k]()
            cs.check(torch.equal(out[:total], want), f"{label}: {k} block_emit "
                     f"bit-equal to emit_chunks_plain ({total} B)")
        names = {}
        if parent_payload is not None:
            sizes, raw = parent_payload
            nr = torch.where(raw, 0, sizes).to(torch.int64)
            pbase = torch.cumsum(nr, 0) - nr
            raw8 = raw.to(torch.uint8)
            runs["earlier emit_payload"] = lambda: call(
                "earlier", "emit_payload", c.data_ptr(), mk.data_ptr(), dk.data_ptr(),
                pbase.data_ptr(), raw8.data_ptr(), nnn, out.data_ptr())
            out.fill_(0xA5)
            runs["earlier emit_payload"]()
            cs.check(torch.equal(out[:total], want), f"{label}: earlier emit_payload "
                     "bit-equal to emit_chunks_plain")
            names["earlier emit_payload"] = "emit_payload_kernel"
            # the earlier route's base arithmetic: the block bases from the sizes
            res[f"bases {label}"] = dict(earlier_block_bases_device_ms=device_total(
                lambda: (lambda n: torch.cumsum(n, 0) - n)(
                    torch.where(raw, 0, sizes).to(torch.int64)), args.iters, ""))
        # the codec's base arithmetic before the emit (ops/codec.py): the
        # chunk bases from the counts, every PyTorch kernel of it
        res.setdefault(f"bases {label}", {})["chunk_bases_device_ms"] = device_total(
            lambda: pack.chunk_bases(cbk), args.iters, "")
        print(f"  {label}: base arithmetic, device: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in res[f"bases {label}"].items()) + f" on {card}",
            flush=True)
        nlive = int((cbk > 0).sum())
        print(f"  {label}: {nnn} blocks of {cells} cells, {nlive} live of {cbk.numel()} "
              f"chunks, {total} B", flush=True)
        res[f"block_emit {label}"] = dict(
            timed(label, runs, names,
                  cs.bound(cs.emit_chunks_bytes(dk, cbk, total), 0)["bound_ms"]),
            live_chunks=nlive, chunks=cbk.numel())
        del want, out

    def rows_case(label, rows, drows, ids, mk, cbk):
        base = pack.chunk_bases(cbk)
        total = int(cbk.sum())
        lcpb = (cbk.numel() // mk.numel()).bit_length() - 1
        want = pack.emit_rows_plain(rows, drows, ids, mk, cbk, base, total)
        out = torch.empty(max(total, 1), dtype=torch.uint8, device=dev)
        rargs = (rows.data_ptr(), drows.data_ptr(), ids.data_ptr(), ids.numel(),
                 mk.data_ptr(), cbk.data_ptr(), base.data_ptr(), lcpb)
        keys = ["earlier", "this", *[k for k in variants_at("emit")
                                     if not variants[k].get("probe")]]
        runs = {k: (lambda k=k: call(k, "block_emit_rows", *rargs, out.data_ptr()))
                for k in keys}
        for k in keys:
            out.fill_(0xA5)
            runs[k]()
            cs.check(torch.equal(out[:total], want), f"{label}: {k} block_emit_rows "
                     f"bit-equal to emit_rows_plain ({ids.numel()} rows)")
        groups = int(((drows.view(-1, 8) & 7).sum(1) > 0).sum())
        # chip_smoke.py rows_emit's bound
        bnd = cs.bound(ids.numel() * (512 + 16) + 32 * groups + 4 * mk.numel() + total,
                       0)["bound_ms"]
        res[f"block_emit_rows {label}"] = dict(timed(label + " (rows)", runs, {}, bnd),
                                               rows=ids.numel())

    # -- the 32^3 route: fused_encode and the emit, A and A-local -------------
    vol_a = cs.sinusoid(*cs.SHAPE, cs.PERIODS)
    vt = torch.from_numpy(vol_a).to(dev)
    nz, ny, nx = vol_a.shape
    mf = quant.global_mulfac(vol_a, cs.SCALE)
    for label, local in (("A", False), ("A-local", True)):
        kw = dict(scale=cs.SCALE) if local else dict(mulfac=mf)
        factor = cs.SCALE if local else mf
        name = "fused_encode_local" if local else "fused_encode"
        c, dk, cbk, sk, rk, mk = tokenize.fused_encode(vt, **kw)
        plain = tokenize.fused_encode_plain(vt, **kw)
        cs.check(all(eq(a, b) for a, b in zip((c, dk, cbk, sk, rk, mk), plain)),
                 f"{label}: this {name} bit-equal to fused_encode_plain, chunk counts "
                 "included")
        del plain
        nnn = mk.numel()
        po = (torch.empty_like(c), torch.empty_like(dk), torch.empty_like(sk),
              torch.empty(nnn, dtype=torch.uint8, device=dev), torch.empty_like(mk))
        outs = {k: (po if k == "earlier" else
                    (torch.empty_like(c), torch.empty_like(dk), torch.empty_like(cbk),
                     torch.empty_like(sk), torch.empty(nnn, dtype=torch.uint8, device=dev),
                     torch.empty_like(mk)))
                for k in ("earlier", "this", *variants_at("encode"))}
        runs = {k: (lambda k=k: call(k, name, vt.data_ptr(), nx, ny, nz, factor,
                                     *(t.data_ptr() for t in outs[k])))
                for k in outs}
        for k in runs:
            runs[k]()
        torch.cuda.synchronize()
        for k in runs:
            if variants.get(k, {}).get("probe"):
                continue
            ref = (c, dk, sk, rk, mk) if k == "earlier" else (c, dk, cbk, sk, rk, mk)
            cs.check(all(eq(a, b) for a, b in zip(outs[k], ref)),
                     f"{label}: {k} {name} outputs bit-equal to this wrapper's")
        ncell = c.numel()
        # chip_smoke.py: volume in; coefficients, descriptors, chunk counts,
        # sizes, raw flags and table out; three cascades and the scale a cell
        res[f"{name} {label}"] = timed(
            f"{name} {label}", runs, {k: "fused_encode_kernel" for k in runs},
            cs.bound(4 * vol_a.size + 8 * ncell + ncell // 32 + 9 * nnn,
                     (3 * cs.C32 + 1) * ncell, 2 * ncell if local else 0)["bound_ms"])
        del po, outs
        emit_case(label, c, mk, dk, cbk, parent_payload=(sk, rk))
        del c, dk, cbk, sk, rk, mk
        torch.cuda.empty_cache()

    # -- block_emit at the other routes --------------------------------------
    def emit_route(label, v, block, probes=False, scale=cs.SCALE):
        t = torch.from_numpy(v).to(dev)
        m = quant.global_mulfac(v, scale)
        path = codec.route(v.shape, block)
        if path == "block128":
            c, dk, cbk, _, _, mk = fused_compress.block_encode(t, m)
            sb = None
        elif path == "stripe_fused":
            c, dk, cbk, _, _, mk = tokenize.stripe_fused_encode(t, block, m)
            sb = None
        else:
            c, dk, cbk, _, _, mk = tokenize.encode(t, block, m)
            sb = block
        del t
        emit_case(f"{label} ({path})", c, mk, dk, cbk, sb, probes=probes)
        del c, dk, cbk, mk
        torch.cuda.empty_cache()

    vol_b = cs.sinusoid(*cs.SHAPE_B, cs.PERIODS)
    emit_route("B", vol_b, cs.BLOCK_B, probes=True)
    # every chunk live: N(0,1) noise at B's shape
    emit_route("B noise", np.random.default_rng(0).standard_normal(cs.SHAPE_B,
                                                                   dtype=np.float32),
               cs.BLOCK_B, scale=cs.NOISE_SCALE)
    for b in ((8, 8, 8), (64, 64, 64), (256, 256, 256), (64, 32, 32)):
        emit_route(f"A-{'x'.join(map(str, b))}", vol_a, b)
    emit_route("S-16x16x16", cs.sinusoid(*cs.SHAPE_S, cs.PERIODS), (16, 16, 16))
    vol_half = cs.sinusoid(*cs.SHAPE_HALF, cs.PERIODS)
    vol_half[cs.SHAPE_HALF[0] // 2:] = 0.0
    emit_route("half-zero 256x256x256", vol_half, (256, 256, 256))
    del vol_half

    # -- block_emit_rows: the patch and compact routes ----------------------
    c, dk, cbk, _, _, mk = tokenize.encode(vt, cs.BLOCK_A, mf)
    n = int((cbk > 0).sum())
    rows, drows, ids = pack.patch_extract(c, dk, cbk, cs.BLOCK_A, n)
    rows_case("A patch", rows, drows, ids, mk, cbk)
    del c, dk, cbk, mk, rows, drows, ids
    for label, v, block in (("A compact", vol_a, cs.BLOCK_A),
                            ("B compact", vol_b, cs.BLOCK_B)):
        t = torch.from_numpy(v).to(dev)
        (_, mk, cbk, _, _, rows, drows, ids, _, nrows) = tokenize.compact_encode(
            t, block, mulfac=quant.global_mulfac(v, cs.SCALE))
        del t
        n = int(nrows[0])
        rows_case(label, rows[:n], drows[:n], ids[:n], mk, cbk)
        del mk, cbk, rows, drows, ids
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "turns": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
