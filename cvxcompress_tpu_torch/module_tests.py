"""Module tests: numbered stages after CvxCompress::Run_Module_Tests.

The port's counterpart of `tools/module_tests.py` (the reference's
CvxCompress.cpp:673-1246), run on the transforms and the codec the port
runs, on `device` ("cuda" unless the caller names another):

  [2] forward transform: `wavelet.cascade_3d` (the plain version of the
      32^3, 128^3 and fused stripe kernels' cascade) and `forward_blocks`
      (the stripe, patch and compact routes' transforms) against the
      oracle's scalar cascade
      (oracle/wavelet.py), over the block sweep, rel RMS < 1e-5 (:695-745)
  [3] inverse transform, the same harness (:747-785)
  [4] transform throughput: `forward_blocks` / `inverse_blocks` (on the
      card the kernels `plane_cascade_fwd` / `_inv`, timed by CUDA events)
      over 8^3 .. 128^3 blocks (32^3 and 128^3 with --quick), MC/s and
      lifting-model GF/s (:803-891); 2^26 cells a size on the card (2^24
      --quick), 2^21 on the CPU; floor 10 MC/s
  [5] block gather (`blocks.to_blocks`) bit-exact with edge clipping,
      fixtures cnx = bx+3, cny = by+5, cnz = bz+7 (:893-965)
  [6] block scatter (`blocks.from_blocks`) round trip (:967-1031)
  [7] block layout throughput: `blocks.to_blocks` of a 512^3 pattern
      volume (256^3 with --quick) at 32^3 blocks, the first and last
      blocks bit-exact against numpy's, GB/s read + written (:1033-1099);
      floor 0.5 GB/s
  [8] global RMS: `quant.global_rms_host` against an f64 loop, and
      `quant.sumsq` on the device, odd dims 37x41x43 (:1101-1131)
  [9] compress quality and throughput, synthetic radial volume (:1135-1187)
  [10] decompress throughput (the reference's stage never decompresses,
      :1219-1232; here it does)
  [11] the 2^24-cell zero run of an all-zero 256^3 block (exhaustive)
  [12] a 256^3-block round trip of correlated noise (exhaustive)

The floors of [4] and [7] are the JAX tool's CPU floors, on every device:
guards against a hang or an eager path, not targets.

    python -m cvxcompress_tpu_torch.module_tests [--exhaustive] [--quick]
        [--device cpu]

Exit code 0 iff every stage passes.  `run` is the same as a function;
`api.CvxCompress.Run_Module_Tests(exhaustive=True)` calls it.  Each stage
takes its sizes as arguments, so a CPU test runs them small.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

GREEN, RED, DIM, END = "\033[32m", "\033[31m", "\033[2m", "\033[0m"
SIZES = (8, 16, 32, 64, 128, 256)
# the JAX tool's CPU floors of [4] and [7], on every device: guards against a
# hang or an eager path, not targets
TRANSFORM_FLOOR_MCS = 10.0
LAYOUT_FLOOR_GBS = 0.5


class Stages:
    """The failures of one run and where it runs."""

    def __init__(self, device):
        from .ops import codec

        self.device = codec._target(device)
        self.failures = []

    def check(self, name, ok, detail=""):
        mark = f"{GREEN}[OK]{END}" if ok else f"{RED}[FAILED]{END}"
        print(f" {mark} {name} {DIM}{detail}{END}", flush=True)
        if not ok:
            self.failures.append(name)


def block_sweep(exhaustive, sizes=None, max_cells=1 << 21):
    """--exhaustive: EVERY (bx, by, bz) in {8..256 pow2}^3 (the reference's
    216, CvxCompress.cpp:695-785) plus the bz = 1 row.  Default: a sample
    over `sizes` ((8, 32, 128)) capped at `max_cells` cells, plus
    256-bearing blocks for the deepest (8-level) cascade on each axis."""
    if sizes is None:
        sizes = SIZES if exhaustive else (8, 32, 128)
    for bz in (1, *sizes):
        for by in sizes:
            for bx in sizes:
                if not exhaustive and bx * by * bz > max_cells:
                    continue
                yield bx, by, bz
    if not exhaustive and sizes == (8, 32, 128):
        yield from ((256, 32, 8), (8, 32, 256), (32, 256, 8), (256, 256, 8),
                    (256, 8, 256))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.sqrt(np.mean((got - want) ** 2)) / (np.sqrt(np.mean(want ** 2)) + 1e-30)


def stage_2_3_transforms(st, exhaustive, sizes=None, max_cells=1 << 21):
    from .ops import wavelet
    from .oracle import wavelet as ow

    r = np.random.default_rng(1)
    worst_f = worst_i = 0.0
    for bx, by, bz in block_sweep(exhaustive, sizes, max_cells):
        blk = r.standard_normal((1, bz, by, bx)).astype(np.float32)
        want = ow.forward_3d(blk[0])
        winv = ow.inverse_3d(want)
        t = torch.from_numpy(blk).to(st.device)
        c = torch.from_numpy(want[None]).to(st.device)
        for fwd, inv in ((wavelet.cascade_3d(t, False), wavelet.cascade_3d(c, True)),
                         (wavelet.forward_blocks(t), wavelet.inverse_blocks(c))):
            worst_f = max(worst_f, _rel(fwd[0].cpu(), want))
            worst_i = max(worst_i, _rel(inv[0].cpu(), winv))
    st.check("[2] forward transform vs oracle (sweep)", worst_f < 1e-5,
             f"worst rel-RMS {worst_f:.2e}")
    st.check("[3] inverse transform vs oracle (sweep)", worst_i < 1e-5,
             f"worst rel-RMS {worst_i:.2e}")


def stage_4_transform_throughput(st, quick, sizes=None, total=None):
    """[4] `forward_blocks` / `inverse_blocks` throughput over `sizes`
    (cubic blocks), `total` cells a size."""
    from .ops import wavelet
    from .utils import profiling

    cuda = st.device.type == "cuda"
    if total is None:
        total = ((1 << 24) if quick else (1 << 26)) if cuda else (1 << 21)
    gen = torch.Generator(device=st.device).manual_seed(2)
    worst = float("inf")
    print(f"{DIM}  [4] transform throughput ({total >> 20} MCells a size) "
          f"on {st.device}:{END}")
    for bs in sizes or ((32, 128) if quick else (8, 16, 32, 64, 128)):
        n = max(1, total // bs**3)
        x = torch.randn((n, bs, bs, bs), generator=gen, device=st.device)
        t = profiling.Timer(st.device)
        for _ in range(3 if cuda else 1):  # on the card the first round warms up
            with t.stage("f"):
                c = wavelet.forward_blocks(x)
            with t.stage("i"):
                wavelet.inverse_blocks(c)
        cells = n * bs**3
        f, i = t.report("f", cells, profiling.lifting_flops_per_cell((bs,) * 3)), \
            t.report("i", cells)
        worst = min(worst, f["mcells_s"], i["mcells_s"])
        print(f"      {bs:3}^3: fwd {f['mcells_s']:9.1f} MC/s "
              f"({f['gflop_s']:7.1f} GF/s lifting-equiv)  inv {i['mcells_s']:9.1f} MC/s")
    st.check("[4] transform throughput", worst >= TRANSFORM_FLOOR_MCS,
             f"worst {worst:.1f} MC/s (floor {TRANSFORM_FLOOR_MCS:g})")


def stage_5_6_block_layout(st, exhaustive, sizes=None):
    from .ops import blocks
    from .utils import volumes

    ok5 = ok6 = True
    for bx, by, bz in block_sweep(exhaustive, sizes):
        if bx * by * bz > (1 << 18):
            continue
        block = (bx, by, bz)
        # clip fixtures force partial blocks on every axis (ref :924-926)
        cnx, cny, cnz = bx + 3, by + 5, (bz + 7 if bz > 1 else 1)
        vol = volumes.pattern_volume(cnz, cny, cnx, seed=bx)
        b = blocks.to_blocks(torch.from_numpy(vol).to(st.device), block)
        # gather: interior cells bit-exact, padding zero
        nbz, nby, nbx = blocks.grid_shape(vol.shape, block)
        pad = np.zeros((nbz * bz, nby * by, nbx * bx), np.float32)
        pad[:cnz, :cny, :cnx] = vol
        want = pad.reshape(nbz, bz, nby, by, nbx, bx).transpose(0, 2, 4, 1, 3, 5)
        got = b.cpu().numpy().reshape(want.shape)
        ok5 &= np.array_equal(got.view(np.uint32), want.view(np.uint32))
        # scatter round trip: bit-exact
        back = blocks.from_blocks(b, vol.shape, block).cpu().numpy()
        ok6 &= np.array_equal(back.view(np.uint32), vol.view(np.uint32))
    st.check("[5] block gather exact (clipped fixtures)", ok5)
    st.check("[6] block scatter round trip exact", ok6)


def stage_7_layout_throughput(st, quick, n=None):
    """[7] `blocks.to_blocks` of an n^3 pattern volume at 32^3 blocks: the
    first and last blocks bit-exact against numpy's layout, GB/s."""
    from .ops import blocks
    from .utils import profiling, volumes

    n = n or (256 if quick else 512)
    vol_np = volumes.pattern_volume(n, n, n, seed=7)
    vol = torch.from_numpy(vol_np).to(st.device)
    t = profiling.Timer(st.device)
    for _ in range(3 if st.device.type == "cuda" else 1):
        with t.stage("l"):
            out = blocks.to_blocks(vol, (32, 32, 32))
    gbs = vol.numel() * 4 * 2 / t.best("l") / 1e9
    first, last = (out[i].cpu().numpy().view(np.uint32) for i in (0, -1))
    exact = (np.array_equal(first, vol_np[:32, :32, :32].view(np.uint32))
             and np.array_equal(last, vol_np[-32:, -32:, -32:].view(np.uint32)))
    st.check("[7] block layout throughput + exactness", exact and gbs > LAYOUT_FLOOR_GBS,
             f"{gbs:.2f} GB/s on {st.device} ({n}^3)")


def stage_8_rms(st):
    from .ops import quant

    r = np.random.default_rng(3)
    vol = (r.standard_normal((37, 41, 43)) * 3).astype(np.float32)
    acc = np.sum(np.square(vol, dtype=np.float64))
    want = float(np.sqrt(acc / vol.size))
    rel = abs(float(quant.global_rms_host(vol)) - want) / want
    dev = float(quant.sumsq(torch.from_numpy(vol).to(st.device)))
    rel_dev = abs(dev - acc) / acc
    st.check("[8] global RMS vs f64 loop (37x41x43)", rel < 1e-5 and rel_dev < 1e-12,
             f"rel {rel:.1e}, device f64 sum rel {rel_dev:.1e}")


# scale 1e-1 on the radial volume: errors 0.7-1.8e-2 and ratios 42-312
# (the JAX tool's round 4); the floors give ~2x margin
RATIO_FLOOR = {8: 25.0, 16: 55.0, 32: 95.0, 64: 150.0}


def stage_9_10_codec(st, quick, shape=None, sizes=None):
    from . import api
    from .utils import profiling, volumes

    vol = volumes.radial_volume(*(shape or ((51 if quick else 101), 101, 151)))
    print(f"{DIM}  [9/10] codec on radial volume {vol.shape} on {st.device}:{END}")
    ok = True
    for bs in sizes or ((32,) if quick else (8, 16, 32, 64)):
        t = profiling.Timer(st.device)
        with t.stage("c"):
            data, ratio = api.compress(vol, 1e-1, block=(bs, bs, bs), device=st.device)
        with t.stage("d"):
            out = api.decompress(data, device=st.device)
        err = float(np.linalg.norm(out.cpu().numpy() - vol) / np.linalg.norm(vol))
        ok &= err < 4e-2 and ratio > RATIO_FLOOR[bs]
        print(f"      {bs:3}^3: ratio {ratio:7.2f}:1"
              f"  compress {t.report('c', vol.size)['mcells_s']:7.1f} MC/s"
              f"  decompress {t.report('d', vol.size)['mcells_s']:7.1f} MC/s"
              f"  err {err:.2e}")
    st.check("[9] compress quality (err < 4e-2, per-size ratio floors)", ok)
    st.check("[10] decompress throughput (actually measured)", ok)


def stage_11_giant_run(st):
    """[11] all-zero 256^3 block: the 2^24-cell zero run splits into
    [RLESC3 0xFFFFFF][00] (5 payload bytes), the fix of the reference's
    24-bit run truncation (only reachable at this size)."""
    from . import api
    from .utils import io

    z = np.zeros((256, 256, 256), np.float32)
    data, _ = api.compress(z, 1e-2, block=(256, 256, 256), device=st.device)
    payload = io.probe(data)["payload_bytes"]
    out = api.decompress(data, device=st.device)
    st.check("[11] 2^24 zero-run split (256^3 block)",
             payload == 5 and not bool(out.any()), f"payload {payload} B")


def stage_12_roundtrip(st, n=256, block=(256, 256, 256)):
    """[12] a round trip of correlated noise (compressible, not degenerate)
    at 256^3 blocks on all axes (the reference's compress tests skip 256
    in z, CvxCompress.cpp:1143); err < 1e-3 and ratio > 1.5."""
    from . import api

    r = np.random.default_rng(12)
    vol = np.cumsum(r.standard_normal((n, n, n)).astype(np.float32), axis=2)
    data, ratio = api.compress(vol, 1e-3, block=block, device=st.device)
    out = api.decompress(data, device=st.device).cpu().numpy()
    o = vol.astype(np.float64)
    err = float(np.sqrt(((out - o) ** 2).mean()) / np.sqrt((o * o).mean()))
    st.check(f"[12] {block[0]}x{block[1]}x{block[2]}-block roundtrip quality",
             err < 1e-3 and ratio > 1.5, f"ratio {ratio:.1f}:1 err {err:.2e}")


def run(device="cuda", exhaustive=False, quick=False):
    """Every stage on `device` ([11] and [12] only when `exhaustive`).
    Returns the names of the stages that failed (empty: all passed)."""
    st = Stages(device)
    stage_2_3_transforms(st, exhaustive)
    stage_4_transform_throughput(st, quick)
    stage_5_6_block_layout(st, exhaustive)
    stage_7_layout_throughput(st, quick)
    stage_8_rms(st)
    stage_9_10_codec(st, quick)
    if exhaustive:
        stage_11_giant_run(st)
        stage_12_roundtrip(st)
    if st.failures:
        print(f"{RED}{len(st.failures)} stage(s) failed: {st.failures}{END}")
    else:
        print(f"{GREEN}All module tests passed.{END}")
    return st.failures


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--exhaustive", action="store_true",
                    help="the full 8..256 block sweep, the giant run, 256^3 blocks")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return 1 if run(args.device, args.exhaustive, args.quick) else 0


if __name__ == "__main__":
    sys.exit(main())
