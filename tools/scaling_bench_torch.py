#!/usr/bin/env python3
"""Scaling harness for the >= 85 % multi-device target, on the PyTorch port.

The port's counterpart of `tools/scaling_bench.py`.  What one run can
measure, it measures; the efficiency beyond the devices present is a
model, and the report labels it so ("kind": "model"):

  * per-shard work balance against mesh size, for a balanced and a skewed
    payload (`make_inputs`), on the port's own cuts: the compress's z slabs
    of whole block rows (`parallel.sharded.plan_shards`, block rows per
    shard) and the decompress's (`parallel.compress.decode_ranges`: payload
    bytes and block rows per shard, idle shards counted).  The balance is
    mean / max.  The JAX tool balances parse subsegments block-granularly
    (`_shard_decode_plan`), which the port does not run (deliberate
    difference 7 of ROADMAP.md);
  * communication bytes per volume: the f64 sums of squares (one a shard),
    the largest shard's payload and the offset table;
  * wall time of `parallel.compress.compress` / `decompress` on a mesh of
    n shards on the device present (`make_mesh([device] * n)`: on one card
    n shards share it, each on its own stream), and `matches_single_chip`:
    the container byte-equal to a single `codec.compress` and the volume
    bit-equal to a single `codec.decompress`;
  * the model: efficiency = balance * min(1, device time / link time), the
    device time this run's own single-call time on the same device divided
    by n, the link time the largest shard's payload at 25 GB/s a host.

Prints one JSON document; exit 0 iff every `matches_single_chip` holds and
every modelled efficiency is >= 0.85.

    python tools/scaling_bench_torch.py [--sizes 1,2,4,8] [--device cuda|cpu]
        [--backend torch] [--out report.json]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

BLOCK = (16, 16, 16)
SCALE = 1e-2
TARGET = 0.85
LINK_BPS = 25e9  # a modelled inter-host link, bytes/s a host


def make_inputs():
    """The JAX tool's inputs: a z sinusoid (payload spread evenly) and a
    volume whose payload sits in its low-z quarter."""
    from cvxcompress_tpu_torch.utils import volumes

    balanced = volumes.sinusoid_volume(96, 64, 64, periods=6)
    skewed = np.zeros((96, 64, 64), np.float32)
    rng = np.random.default_rng(7)
    skewed[:24] = rng.standard_normal((24, 64, 64)).astype(np.float32)
    skewed[24:] = 1e-7  # quantizes to zero: payload mass in the low-z slab
    return {"balanced": balanced, "skewed": skewed}


def balance(work):
    w = np.asarray(work, np.float64)
    return float(w.mean() / max(w.max(), 1e-30))


def shard_stats(data, shape, n):
    """The compress and decompress cuts of n shards: rows, bytes, balance."""
    from cvxcompress_tpu_torch.parallel import compress as pc
    from cvxcompress_tpu_torch.parallel import sharded

    hdr, _, _, sizes, _ = sharded.block_sizes(data)
    nbx, nby, nbz, _ = hdr.grid
    row_bytes = sizes.reshape(nbz, nbx * nby).sum(axis=1)
    plan = sharded.plan_shards(shape, BLOCK, n)
    crows = [-(-(z1 - z0) // BLOCK[2]) for z0, z1 in plan]
    ranges = pc.decode_ranges(data, n)
    drows = [r1 - r0 for r0, r1 in ranges] + [0] * (n - len(ranges))
    dbytes = [int(row_bytes[r0:r1].sum()) for r0, r1 in ranges] + [0] * (n - len(ranges))
    return {
        "compress_block_rows_per_shard": crows,
        "compress_balance": balance(crows),
        "decompress_block_rows_per_shard": drows,
        "decompress_payload_bytes_per_shard": dbytes,
        "decompress_balance": balance(dbytes),
    }


def best_time(fn, device, iters=3):
    """Best-of-`iters` host time of fn(), each ended by the device's
    synchronize; returns (seconds, last output)."""
    import torch

    out, best = None, float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return best, out


def run(sizes, device):
    import torch

    from cvxcompress_tpu_torch.ops import blocks, codec
    from cvxcompress_tpu_torch.parallel import compress as pc
    from cvxcompress_tpu_torch.parallel import mesh as meshlib

    dev = codec._target(device)
    report = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
        "devices_present": torch.cuda.device_count() if dev.type == "cuda" else 1,
        "block": list(BLOCK),
        "target_efficiency": TARGET,
        "model": {"kind": "model", "link_bytes_s": LINK_BPS,
                  "formula": "balance * min(1, single-call device s / n / "
                             "(largest shard payload / link_bytes_s))",
                  "device_rates_source": f"this run's single calls on {dev}"},
        "cases": {},
    }
    ok = True
    for tag, vol in make_inputs().items():
        codec.compress(vol, SCALE, block=BLOCK, device=dev)  # warm up (kernel build)
        tc, (data, ratio) = best_time(
            lambda: codec.compress(vol, SCALE, block=BLOCK, device=dev), dev)
        td, ref = best_time(lambda: codec.decompress(data, device=dev), dev)
        nnn = math.prod(blocks.grid_shape(vol.shape, BLOCK))
        case = {"cells": int(vol.size), "ratio": float(ratio), "blocks": nnn,
                "single_compress_mcells_s": vol.size / tc / 1e6,
                "single_decompress_mcells_s": vol.size / td / 1e6, "mesh": {}}
        for n in sizes:
            entry = shard_stats(data, vol.shape, n)
            comm = {"sumsq_bytes": 8 * n,
                    "payload_bytes_per_host": max(entry["decompress_payload_bytes_per_shard"]),
                    "offset_table_bytes": 8 * nnn}
            entry["comm"] = comm
            link_s = comm["payload_bytes_per_host"] / LINK_BPS
            for op, t, bal in (("compress", tc, entry["compress_balance"]),
                               ("decompress", td, entry["decompress_balance"])):
                eff = bal * min(1.0, (t / n) / max(link_s, 1e-30))
                entry[f"model_efficiency_{op}"] = eff
                ok &= eff >= TARGET
            mesh = meshlib.make_mesh([dev] * n)
            wc, (d2, _) = best_time(lambda: pc.compress(vol, SCALE, block=BLOCK,
                                                        mesh=mesh), dev, iters=1)
            wd, out = best_time(lambda: pc.decompress(data, mesh=mesh), dev, iters=1)
            entry["wall_compress_s"], entry["wall_decompress_s"] = wc, wd
            same = bool(np.array_equal(d2, data)) and torch.equal(
                out.view(torch.int32).cpu(), ref.view(torch.int32).cpu())
            entry["matches_single_chip"] = same
            ok &= same
            case["mesh"][str(n)] = entry
        report["cases"][tag] = case
    report["all_checks_and_projections_meet_target"] = bool(ok)
    return report, ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="1,2,4,8")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="torch", choices=["torch"],
                    help="the sharded codec is the torch backend's")
    ap.add_argument("--out", default=None, help="also write the report here")
    args = ap.parse_args(argv)
    report, ok = run([int(s) for s in args.sizes.split(",")], args.device)
    doc = json.dumps(report, indent=1)
    print(doc)
    if args.out:
        with open(args.out, "w") as f:
            f.write(doc + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
