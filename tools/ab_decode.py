#!/usr/bin/env python3
"""Time the device decoder's parse (`decode_maps`) and emit (`decode_emit`)
of an earlier checkout against this one's, in turns, on one NVIDIA card.

    git archive <commit> | tar -x -C build/parent    # the earlier checkout
    python3 tools/ab_decode.py --parent build/parent [--variants JSON]

Builds the earlier checkout's `cvxcompress_tpu_torch/csrc/decode_maps.cu`
and `decode_emit.cu` into a library of their own under build/ab_parent/,
this checkout's into build/ab_this/, and launches both libraries' kernels
through their C interfaces (the same in both) with preallocated outputs, on

- config A's CI container and A's N(0,1) noise container (chip_smoke.py
  `SHAPE`, `SCALE`, `NOISE_SCALE`, 32^3 blocks);
- B's N(0,1) noise container (`SHAPE_B`, 128^3 blocks: 2^21 cells a block);
- A's sinusoid at 8^3 blocks (more and shorter chains);
- A's local-RMS ramp at 32^3 (chip_smoke.py `ramp`: one scalefac per
  block, 10^4 apart, a zero, a ~1e-38 and a NaN block);
- a corrupt container: 40 payload bytes of a (64, 64, 96) container
  flipped, as tests/test_torch_cuda.py `test_decode_kernels_on_corrupt_payloads`
  builds it.

Each library's outputs are held bit-equal to the plain versions
(`parse_maps_plain`; `emit_plain` as uint32, on this checkout's chase), then
the two are timed in the order earlier, this, this, earlier with CUDA events
(chip_smoke.py `cuda_ms`), and each alone by the profiler's device time of
its kernel.  `decode_emit` is timed as its wrapper runs it, the buffer
zeroed and then the kernel, and its device time is split into the kernel
and the zeroing.  `--variants` maps names to text substitutions of this
checkout's sources, {"name": {"decode_maps.cu": [[old, new], ...],
"decode_emit.cu": [...]}} (["FILE", path] first takes the file at `path`,
relative to the repo root, e.g. the earlier checkout's); each is built into
build/ab_variants/<name>/, held bit-equal and timed between this checkout's
turns.  With "probe": true a variant that leaves out part of the work is
timed and its outputs are not held (a probe of where the time goes).
Prints the card's name and power limit, one line per kernel and input, and
on the last line one JSON object with the times in ms.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import ab_common  # noqa: E402
import chip_smoke as cs  # noqa: E402  (helpers only; its main() is not run)

FILES = ("decode_maps.cu", "decode_emit.cu")
KERNELS = ("decode_maps", "decode_emit")


def corrupt_container():
    """tests/test_torch_cuda.py `test_decode_kernels_on_corrupt_payloads`,
    seed 0: a smooth field with noise and wide escapes, 40 payload bytes
    flipped."""
    import numpy as np

    from cvxcompress_tpu_torch import container as ctn
    from cvxcompress_tpu_torch.ops import rle_host

    shape = (64, 64, 96)
    rng = np.random.default_rng(0)
    z = np.sin(np.arange(shape[0]) * np.pi * 3 / shape[0]).astype(np.float32)
    v = np.broadcast_to(z[:, None, None], shape).copy()
    v += rng.standard_normal(shape).astype(np.float32) * 1e-2
    v[0, 0, :4] = [50.0, -50.0, 1e4, -1e4]
    data, _ = rle_host.host_compress(v, 1e-2)
    pbase = ctn.unpack(data)[3]
    r = np.random.default_rng(0)
    flips = r.integers(pbase, data.size - 8, 40)
    data[flips] ^= r.integers(1, 255, 40).astype(np.uint8)
    return data


def containers():
    """(label, function -> container bytes) of every input."""
    import numpy as np

    import cvxcompress_tpu_torch as cvt

    def noise(shape):
        return np.random.default_rng(0).standard_normal(shape, dtype=np.float32)

    def sinusoid():
        return cs.sinusoid(*cs.SHAPE, cs.PERIODS)

    return (
        ("A CI", lambda: cvt.compress(sinusoid(), cs.SCALE, block=cs.BLOCK_A)[0]),
        ("A noise", lambda: cvt.compress(noise(cs.SHAPE), cs.NOISE_SCALE,
                                         block=cs.BLOCK_A)[0]),
        ("B noise", lambda: cvt.compress(noise(cs.SHAPE_B), cs.NOISE_SCALE,
                                         block=cs.BLOCK_B)[0]),
        ("A-8^3", lambda: cvt.compress(sinusoid(), cs.SCALE, block=(8, 8, 8))[0]),
        ("A local ramp", lambda: cvt.compress(cs.ramp(sinusoid(), 32), cs.SCALE,
                                              block=cs.BLOCK_A, use_local_rms=True)[0]),
        ("corrupt", corrupt_container),
    )


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="the earlier checkout's root")
    ap.add_argument("--variants", default="{}", help="JSON: name -> file -> [[old, new]]")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", choices=KERNELS, help="time one of the two kernels only")
    args = ap.parse_args()
    card = ab_common.card()
    print(card, flush=True)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from cvxcompress_tpu_torch.ops import _kernels, entropy_decode

    dev = torch.device("cuda")
    sigs = {f"cvx_{k}": _kernels._SIGNATURES[f"cvx_{k}"] for k in KERNELS}
    variants = json.loads(args.variants)
    libs = {"earlier": ab_common.build_parent(args.parent, FILES, "libparent_decode", sigs),
            "this": ab_common.build_lib([os.path.join(_kernels.SRC_DIR, f) for f in FILES],
                                        os.path.join(ROOT, "build", "ab_this", "lib.so"),
                                        sigs)}
    for name, subs in variants.items():
        libs[name] = ab_common.build_variant(name, subs, FILES, sigs)
    order = ["earlier", "this", *[k for k in libs if k not in ("earlier", "this")],
             "this", "earlier"]
    kernels = [k for k in KERNELS if args.only in (None, k)]

    def call(lib, name, *a):
        rc = getattr(libs[lib], f"cvx_{name}")(*a, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{lib} {name} failed: cudaError {rc}")

    res = {}
    for label, make in containers():
        data = make()
        p = entropy_decode.plan(data)
        cs.check(p is not None, f"{label}: plan accepts the container")
        b = entropy_decode.upload(p, dev)
        stream, sblk, sf = b["stream"], b["sub_block"], b["scalefac"]
        nsub, cells, nnn = sblk.numel(), p["cells"], p["hdr"].grid[3]
        Mp, Pp = entropy_decode.parse_maps_plain(stream, nsub, cells)
        e32, c32 = entropy_decode.chase(Pp, b["sub_reset"], b["starts"], cells)
        bounds = {  # chip_smoke.py decode_stages
            "decode_maps": cs.bound(nsub * (32 + 128 + 100), 0)["bound_ms"],
            "decode_emit": cs.bound(nsub * (32 + 128 + 12) + 4 * nnn * (cells + 1),
                                    0)["bound_ms"]}
        print(f"{label}: {len(data)} B, {nsub} subsegments, {b['starts'].numel()} chains, "
              f"cells {cells}, {p['raw_ids'].size} raw blocks", flush=True)
        M = torch.empty_like(Mp)
        P = torch.empty_like(Pp)
        out = torch.empty((nnn, cells), dtype=torch.float32, device=dev)
        dp = (entropy_decode.emit_plain(stream, Mp, e32, c32, sblk, sf, nnn, cells)
              if "decode_emit" in kernels else None)
        runs = {
            "decode_maps": lambda lib: call(lib, "decode_maps", stream.data_ptr(), nsub,
                                            cells, M.data_ptr(), P.data_ptr()),
            # as the wrapper runs it: the zeroed buffer, then the kernel
            "decode_emit": lambda lib: (out.zero_(), call(
                lib, "decode_emit", stream.data_ptr(), Mp.data_ptr(), e32.data_ptr(),
                c32.data_ptr(), sblk.data_ptr(), nsub, sf.data_ptr(), cells, nnn,
                out.data_ptr())),
        }
        for k in kernels:
            for lib in libs:
                M.fill_(-1)
                P.fill_(-1)
                out.fill_(float("nan"))
                runs[k](lib)
                torch.cuda.synchronize()
                if variants.get(lib, {}).get("probe"):
                    continue
                same = (torch.equal(M, Mp) and torch.equal(P, Pp) if k == "decode_maps"
                        else torch.equal(out.view(torch.int32), dp.view(torch.int32)))
                cs.check(same, f"{label}: {lib} {k} bit-equal to its plain version")
            # host-bound short inputs take more calls against the noise
            iters = (10 * args.iters if nsub < 1 << 16
                     else max(3, args.iters // (1 + nsub // (1 << 20))))
            t = ab_common.turns(order, runs[k], iters)
            dev_t = {lib: cs.device_ms(lambda: runs[k](lib), iters, k) for lib in libs}
            line = (f"  {k} {label}: " + ", ".join(
                f"{lib} " + " / ".join(f"{x:.4f}" for x in v) for lib, v in t.items())
                + " ms; device " + ", ".join(f"{lib} {x:.4f}" for lib, x in dev_t.items()))
            r = dict(t, device_ms=dev_t, bound_ms=bounds[k])
            if k == "decode_emit":
                r["zero_ms"] = cs.device_ms(lambda: out.zero_(), iters,
                                            ("FillFunctor", "Memset"))
                line += f"; zeroing {r['zero_ms']:.4f}"
            print(line + f" ms; bound {bounds[k]:.4f} ms on {card}", flush=True)
            res[f"{k} {label}"] = r
        del data, p, b, stream, sblk, sf, Mp, Pp, e32, c32, M, P, out, dp, runs
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "turns": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
