"""The local RMS's mulfac tables: the port's 32^3 encode against the
reference's float64 sum, over many snapshots of a cell, in one process.

    python3 cvxbench/local_tables.py --workload <local 32^3 cell> \
        --seeds 1,2,3 --snapshots 300

For each (seed, snapshot) the generator makes the cell's volume on the card
and the port's `fused_encode` runs under the local RMS.  On its
coefficients two more tables are computed and compared bit for bit with
the kernel's:

- `flips`: the reference's (`reference/codec.py` `local_mulfacs`: one
  `torch.sum` in float64 a block), what the check compares the port with;
- `plain`: the port's plain version (`ops/quant.py` `local_rms`: the
  kernel's own order of summation, in float64).

Where the two float64 sums of a block differ, its RMS can round to another
float32 on one side: `expected` sums, over the blocks, the distance
between the two float64 RMS over the float32 spacing at that RMS, which is
the chance of a flip when the rounding boundary falls anywhere between.
Prints one JSON line a seed, then the totals.  Needs a CUDA card.
"""

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def compare(coeffs, mulfacs, scale):
    """Readings of one volume's table (module doc)."""
    import torch

    from cvxbench.reference import codec as ref_codec
    from cvxcompress_tpu_torch.ops import quant

    n, cells = coeffs.shape
    ref = ref_codec.local_mulfacs(coeffs, scale)
    acc_port = quant.cta_sumsq(quant.zline_order(coeffs), quant.SUMSQ_ORDER[cells][1])
    plain = quant.mulfac_from_rms(quant.rms_of_partials(acc_port.view(n, 1), cells), scale)
    acc_ref = torch.sum(torch.square(coeffs.to(torch.float64)), dim=1)
    rms_ref, rms_port = torch.sqrt(acc_ref / cells), torch.sqrt(acc_port / cells)
    low = rms_ref.to(torch.float32)
    spacing = (torch.nextafter(low, torch.full_like(low, math.inf)).double() - low.double())
    live = rms_ref > 0
    rel = ((acc_port - acc_ref).abs() / acc_ref.clamp_min(1e-300))[live]
    return dict(
        blocks=n,
        flips=int((mulfacs.view(torch.int32) != ref.view(torch.int32)).sum()),
        plain=int((mulfacs.view(torch.int32) != plain.view(torch.int32)).sum()),
        sums_differing=int((acc_port != acc_ref).sum()),
        sum_rel_max=float(rel.max()) if rel.numel() else 0.0,
        expected=float(((rms_port - rms_ref).abs() / spacing)[live].clamp(max=1).sum()),
    )


def add(total, r):
    """Readings summed over volumes or seeds (`sum_rel_max`: the largest)."""
    for k, v in r.items():
        total[k] = max(total.get(k, 0), v) if k == "sum_rel_max" else total.get(k, 0) + v
    return total


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--snapshots", type=int, default=100)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from cvxbench.harness import spec
    from cvxbench.harness.generator import Generator
    from cvxcompress_tpu_torch.ops import tokenize

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(spec.load_benchmark(ROOT), args.workload, ROOT)
    cfg = cell.config
    if not cfg.get("use_local_rms") or tuple(cfg["block"]) != tokenize.BLOCK:
        print(f"{args.workload} is not a local-RMS cell at 32^3 blocks", file=sys.stderr)
        return 2
    buf = torch.empty(tuple(cfg["shape"]), dtype=torch.float32, device="cuda")
    total = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        gen = Generator(cell.traffic, cfg["shape"], seed, "cuda")
        t0, seen = time.perf_counter(), {}
        for i in range(args.snapshots):
            gen.fill(buf, i)
            coeffs, *_, mulfacs = tokenize.fused_encode(buf, scale=cfg["scale"])
            add(seen, compare(coeffs, mulfacs, cfg["scale"]))
            del coeffs, mulfacs
        add(total, dict(seen, snapshots=args.snapshots))
        print(json.dumps(dict(seen, seed=seed, snapshots=args.snapshots,
                              seconds=time.perf_counter() - t0)), flush=True)
    n = total["blocks"]
    total.update(workload=args.workload, device=torch.cuda.get_device_name(0),
                 flip_rate=total["flips"] / n, expected_rate=total["expected"] / n,
                 # no flip in n blocks: the rate is below 3 / n with 95 % confidence
                 rate_bound_95=3.0 / n if total["flips"] == 0 else None)
    print(json.dumps(total), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
