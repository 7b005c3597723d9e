"""Readings of the comparison that decides `correct`, over many seeds in one
process: what a cell's limits are set from (check.py).

    python3 cvxbench/readings.py --workload <cell> --seeds 1,2,3 \
        --impl program|control [--seconds 1]

`program` runs the port as a run does, at the cell's own size and load,
for a short window of whole rounds; `control` puts the reference in its
place with the transforms in bfloat16.  Prints one JSON line a seed with
the readings, then their largest and smallest.  Needs a CUDA card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--impl", choices=("program", "control"), default="program")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from cvxbench.harness import bench, check, spec
    from cvxbench.harness.control import Control

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(spec.load_benchmark(ROOT), args.workload, ROOT)
    seen = []
    for seed in (int(s) for s in args.seeds.split(",")):
        impl = Control(cell.config, "cuda") if args.impl == "control" else None
        t0 = time.perf_counter()
        run = bench.run(cell, seed, args.seconds, False, "cuda", impl=impl)
        r = dict(run.readings or {}, seed=seed, impl=args.impl, rounds=run.rounds,
                 failed=run.failed, correct=run.correct,
                 seconds=time.perf_counter() - t0, reference_s=run.reference_s)
        seen.append(r)
        print(json.dumps(r), flush=True)
        del impl, run
        torch.cuda.empty_cache()
    for n in check.NAMES:
        vals = [r[n] for r in seen if n in r]
        if vals:
            print(f"{args.workload} {args.impl} {n}: largest {max(vals)}, smallest "
                  f"{min(vals)} over {len(vals)} seeds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
