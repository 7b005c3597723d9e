"""The port's benchmark: one run of one cell, one process.

    python3 cvxbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA card.  Loads,
warms up, measures for `--seconds` (or, with `--trace 1`, traces the mix's
whole rounds), checks the outputs against the reference, and prints one
JSON object as the last line of standard output; the numbers compared and
their limits are the last lines of standard error.  Exits 2 without a
result where there is no card (or fewer than the cell asks for), 3 where
the process loaded jax, jaxlib, flax or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "CUDA_CACHE_PATH": "cuda_cache"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "cvxbench" / sub)
    sys.path.insert(0, str(ROOT))
    from cvxbench.harness import bench, check, readers, roofline, spec

    cell = spec.cell(spec.load_benchmark(ROOT), args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"the cell needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    trace = bool(args.trace)
    try:
        run = bench.run(cell, args.seed, args.seconds, trace, "cuda", T_START)
    except bench.ForeignModules as e:
        print(f"refused: {e}", file=sys.stderr)
        return 3
    res = bench.result(cell, run, trace, "cuda")
    cfg = cell.config
    comp, dec = readers.calls(run, "compress"), readers.calls(run, "decompress")
    print(f"card: {bench.power_limit('cuda') or res['device']['kind']} (name, power.limit)")
    print(f"samples: {len(comp)} compress calls, {len(dec)} decompress calls, "
          f"{run.rounds} rounds; setup_s {run.setup_s}; "
          f"memory_peak_bytes {run.memory_peak_bytes}")
    for d, cs in (("compress", comp), ("decompress", dec)):
        if cs:
            ms = sorted(c["seconds"] * 1e3 for c in cs)
            print(f"{d}: median {ms[len(ms) // 2]:.4f} ms, min {ms[0]:.4f}, max "
                  f"{ms[-1]:.4f}; container {cs[0]['container_bytes']} B")
            t, by = roofline.least_time(d, tuple(cfg["shape"]), tuple(cfg["block"]),
                                        cs[0]["container_bytes"])
            print(f"least time of a {d}: {t * 1e3:.4f} ms, bound by {by} "
                  f"(H100 SXM peaks: {roofline.HBM_BPS:.3g} B/s, "
                  f"{roofline.F32_FLOPS:.3g} FLOP/s f32)")
    if trace and run.trace is not None:
        print(f"traced window: {len(run.trace.calls)} calls, {run.trace.issued} "
              f"device operations issued, {run.trace.lost} records lost, "
              f"{run.trace_tries} tries")
    if run.readings:
        print(f"checked: {run.readings['containers']} containers, "
              f"{run.readings['volumes']} volumes; reference {run.reference_s:.2f} s")
    for n in check.NAMES:
        print(f"check {n} {res['checks'][n]['value']} limit {res['checks'][n]['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
