"""Profiling: the analytic FLOP model, stage timers, profiler traces.

The PyTorch counterpart of `cvxcompress_tpu/utils/profiling.py`.  The
reference reports MCells/s and analytic GF/s from a lifting FLOP model
(Compute_FLOPS_Single_Dimension, CvxCompress.cpp:663-671).  Here: the same
model (numpy copies), a stage timer that times with CUDA events on a card
and the host clock elsewhere, and `torch.profiler` traces.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def lifting_flops_per_cell_1d(dim):
    """Reference lifting FLOP model: sum over levels of 23*n/2 per axis,
    normalized per cell (CvxCompress.cpp:663-671)."""
    flops = 0.0
    n = dim
    while n >= 2:
        flops += 23.0 * n / 2.0
        n -= n // 2
    return flops / dim


def lifting_flops_per_cell(block):
    """Forward-transform lifting FLOPs per cell for a (bx, by, bz) block."""
    bx, by, bz = block
    out = 0.0
    for d in (bx, by, bz):
        if d > 1:
            out += lifting_flops_per_cell_1d(d)
    return out


def matmul_flops_per_cell(block):
    """FLOPs per cell of the dense-operator formulation (the stripe route's
    einsums)."""
    bx, by, bz = block
    return 2 * (bx * (bx > 1) + by * (by > 1) + bz * (bz > 1))


class Timer:
    """Stage timer accumulating MCells/s style stats.  On a CUDA `device`
    a stage is timed by two events on the current stream, the second
    waited on; elsewhere by the host clock."""

    def __init__(self, device="cpu"):
        self.cuda = torch.device(device).type == "cuda"
        self.times = {}

    @contextlib.contextmanager
    def stage(self, name):
        if self.cuda:
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            t0.record()
            yield
            t1.record()
            t1.synchronize()
            el = t0.elapsed_time(t1) / 1e3
        else:
            t = time.perf_counter()
            yield
            el = time.perf_counter() - t
        self.times.setdefault(name, []).append(el)

    def best(self, name):
        return min(self.times[name])

    def report(self, name, cells, flops_per_cell=0.0):
        el = self.best(name)
        out = {
            "stage": name,
            "seconds": el,
            "mcells_s": cells / el / 1e6,
        }
        if flops_per_cell:
            out["gflop_s"] = cells * flops_per_cell / el / 1e9
        return out


@contextlib.contextmanager
def device_trace(logdir):
    """A `torch.profiler` trace of a region (the host, and the card when
    there is one), written as `<logdir>/trace.json` (chrome://tracing,
    Perfetto).  The codec's stages show as "cvx.<stage>" spans."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(str(logdir), "trace.json"))


def fetch_timed(fn, *args, iters=3):
    """Best-of-N host time of fn(*args), each run ended by the card's
    synchronize (a CPU run needs none).  Returns (seconds, last output)."""

    def run():
        out = fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return out

    out = run()
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        out = run()
        best = min(best, time.perf_counter() - t0)
    return best, out
