"""One run of one cell: set-up, the RTM rounds of the window, the check.

The window drives the program's public entry points in RTM rounds, a closed
loop with one caller:

- forward phase: for each of the mix's P snapshot buffers, the generator
  writes snapshot i of the run into it (outside the timed interval, so no
  two calls see the same input), then one `compress` call is timed; it
  returns the host container;
- backward phase: `decompress` runs on the P containers in reverse order,
  each call's time ending after `torch.cuda.synchronize()`.

Rounds start while the window (`seconds`, from the first timed call) is
open; a round that started inside it is completed and counted.  Set-up is
everything from the process start to the first timed call: imports, the
kernel library, the buffers, and one warm round of the cell's own shapes.

Every timed call runs inside a span of the benchmark's own
(`cvxbench.compress`, `cvxbench.decompress`) and every snapshot's making
inside `cvxbench.generate`, so a traced run splits the window by
direction.  A traced run (`trace=True`) traces the mix's `trace_rounds`
whole rounds after the warm round instead of running the window.

The check samples two rounds: one drawn from the seed among the first
four, and the last.  Their containers and volumes are kept, and compared
with the reference once the window has closed and the peak memory has
been read (check.py).
"""

from __future__ import annotations

import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field

import torch
from torch.profiler import record_function

from . import check, spec
from . import trace as tr
from .generator import Generator, seed_of

FOREIGN = ("jax", "jaxlib", "flax", "cvxcompress_tpu")
CHECK_EARLY_ROUNDS = 4


class ForeignModules(RuntimeError):
    """The process holds a module the benchmark may not load."""


def foreign_modules():
    """Loaded modules whose top-level name is one the port must not load."""
    return sorted({m for m in list(sys.modules) if m.split(".", 1)[0] in FOREIGN})


class Program:
    """The system under test: the port's public `compress` and
    `decompress`, with the default engine."""

    def __init__(self, config, device):
        import cvxcompress_tpu_torch as cvx

        self.cvx = cvx
        self.scale = config["scale"]
        self.block = tuple(config["block"])
        self.local = bool(config.get("use_local_rms", False))
        self.device = device

    def compress(self, vol):
        return self.cvx.compress(vol, self.scale, block=self.block,
                                 use_local_rms=self.local)[0]

    def decompress(self, data):
        return self.cvx.decompress(data, device=self.device)


@dataclass
class Run:
    shape: tuple
    block: tuple
    calls: list = field(default_factory=list)
    setup_s: float | None = None
    trace: tr.Summary | None = None
    trace_tries: int = 0
    rounds: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    readings: dict | None = None
    reference_s: float = 0.0
    correct: bool = False


def run(cell, seed, seconds, trace=False, device="cuda", t_start=None, impl=None):
    """Run one cell; returns the Run.  `impl` replaces the program (the
    control and the fault tests)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cfg, traffic = cell.config, cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    shape, block = tuple(cfg["shape"]), tuple(cfg["block"])
    cells = shape[0] * shape[1] * shape[2]
    P = int(traffic["snapshots"])
    impl = impl or Program(cfg, dev)
    gen = Generator(traffic, shape, seed, dev)
    bufs = [torch.empty(shape, dtype=torch.float32, device=dev) for _ in range(P)]
    r_check = seed_of(seed, 0, "check") % CHECK_EARLY_ROUNDS
    out = Run(shape=shape, block=block)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def one_round(r, timed):
        """Round r (r < 0: the warm round); returns (indices, containers,
        volumes)."""
        idx = [r * P + j if r >= 0 else r * P - j for j in range(P)]
        conts, vols = [None] * P, [None] * P
        for j in range(P):
            with record_function("cvxbench.generate"):
                gen.fill(bufs[j], idx[j])
                sync()
            t0 = time.perf_counter()
            if timed and out.setup_s is None:
                out.setup_s = t0 - t_start
            with record_function("cvxbench.compress"):
                conts[j] = impl.compress(bufs[j])
            t1 = time.perf_counter()
            if timed:
                out.calls.append(dict(direction="compress", round=r, snapshot=idx[j],
                                      seconds=t1 - t0, cells=cells,
                                      container_bytes=int(conts[j].size)))
        for j in reversed(range(P)):
            t0 = time.perf_counter()
            with record_function("cvxbench.decompress"):
                vols[j] = impl.decompress(conts[j])
                sync()
            t1 = time.perf_counter()
            if timed:
                out.calls.append(dict(direction="decompress", round=r, snapshot=idx[j],
                                      seconds=t1 - t0, cells=cells,
                                      container_bytes=int(conts[j].size)))
        return idx, conts, vols

    kept, last = {}, None

    def play():
        """One timed round; keep it for the check if it is the drawn one."""
        nonlocal last
        # the last round's volumes go before the next round starts, unless
        # the check keeps that round
        last = None
        r = out.rounds
        res = one_round(r, True)
        if r == r_check:
            kept[r] = res
        last = (r, res)
        out.rounds += 1

    try:
        one_round(-1, False)
        sync()
        if trace:
            rounds = int(traffic["trace_rounds"])

            def window():
                for _ in range(rounds):
                    play()
                sync()

            out.trace, out.trace_tries = tr.profile(window)
            n_traced = 2 * P * rounds
            if len(out.trace.calls) == n_traced:
                for c, rec in zip(out.trace.calls, out.calls[-n_traced:]):
                    c.record = rec
        else:
            while out.rounds == 0 or time.perf_counter() - t_start - out.setup_s < seconds:
                play()
    except Exception:  # a failed call ends the window; the run is not correct
        out.failed += 1
        print(traceback.format_exc(), file=sys.stderr)
    if cuda:
        out.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))
    bad = foreign_modules()
    if bad:
        raise ForeignModules(f"the run loaded {bad}")
    del bufs
    if last is not None:
        kept[last[0]] = last[1]
    samples = [(i, c, v) for idx, conts, vols in (kept[k] for k in sorted(kept))
               for i, c, v in zip(idx, conts, vols)]
    kept.clear()
    last = None
    if cuda:
        torch.cuda.empty_cache()
    if out.failed == 0 and samples:
        t0 = time.perf_counter()
        out.readings = check.compare(cfg, traffic, seed, samples, dev)
        sync()
        out.reference_s = time.perf_counter() - t0
        out.correct = check.judge(out.readings, cell.limits)
    return out


def power_limit(device):
    """The card's name and power limit as nvidia-smi reads them, or None."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             "-i", str(torch.device(device).index or 0)],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip() or None


def result(cell, run_, trace, device):
    """The result line's object (the `checks` key last)."""
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = spec.load_metric(m["name"], cell.root).read(run_)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = torch.device(device)
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
                "memory_peak_bytes": run_.memory_peak_bytes}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    res = {"correct": bool(run_.correct and run_.failed == 0),
           "attempted": len(run_.calls) + run_.failed, "failed": run_.failed,
           "metrics": metrics, "device": info}
    if trace and run_.trace is not None:
        # the calls' own time: the generator's work between them is the
        # benchmark's, not the program's
        info["busy_s"] = run_.trace.calls_busy_us / 1e6
        info["window_s"] = run_.trace.calls_us / 1e6
        res["breakdown"] = run_.trace.breakdown()
    res["checks"] = {n: {"value": (run_.readings or {}).get(n), "limit": cell.limits[n]}
                     for n in check.NAMES}
    return res
