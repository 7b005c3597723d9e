"""One torch.profiler trace of whole rounds, reduced to what the per-layer
metrics read.

The method is `chip_smoke.py`'s `profiled`: CUPTI may lose the device
records of a session's first activities, so each session first makes a few
small launches, and a traced window counts only when every launch, copy
and memset issued in it has its device record; else it is traced again.

- Device busy time is the union of the intervals of kernels, copies and
  memsets.
- Each device operation is tied to the runtime call that issued it by the
  trace's correlation id, and through that call's time and thread to the
  host spans around it: the program's `cvx.*` stage (the innermost one)
  and the benchmark's own `cvxbench.compress` or `cvxbench.decompress`
  call.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ISSUE = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")
CALLS = ("cvxbench.compress", "cvxbench.decompress")
WINDOW = "cvxbench.window"


@dataclass
class DeviceOp:
    name: str
    cat: str
    ts: float  # us
    dur: float  # us
    stage: str | None = None  # innermost cvx.* span around its launch
    call: int | None = None  # index into Summary.calls


@dataclass
class Call:
    direction: str  # "compress" or "decompress"
    ts: float
    dur: float
    ops: list = field(default_factory=list)
    host: dict = field(default_factory=dict)  # cvx.* span -> summed us
    busy: float = 0.0  # us of device activity inside the call
    record: dict | None = None  # the harness's record of this call


@dataclass
class Summary:
    window_us: float  # the traced window, generation of the snapshots included
    busy_us: float  # device activity in the window
    lost: int
    issued: int
    calls: list
    ops: list
    gaps: dict  # host span during device idle time inside the calls -> us

    @property
    def calls_us(self):
        """Summed wall time of the traced calls: the window the program ran in."""
        return sum(c.dur for c in self.calls)

    @property
    def calls_busy_us(self):
        """Device activity inside the traced calls."""
        return sum(c.busy for c in self.calls)

    def breakdown(self, top=10):
        """The device operations the calls launched that took most time, and
        the idle time inside the calls by the host span it fell in, in
        seconds."""
        by_op = {}
        for o in self.ops:
            if o.call is not None:
                by_op[o.name] = by_op.get(o.name, 0.0) + o.dur
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:120], v / 1e6] for k, v in ops],
                "idle_gaps": [[k, v / 1e6] for k, v in gaps]}


def union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def covered(merged, a, b):
    """Length of [a, b] that the merged intervals cover."""
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in merged if y > a and x < b)


class _Spans:
    """User-annotation spans of one thread, for innermost-enclosing lookups."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda e: e["ts"])
        self.starts = [e["ts"] for e in self.spans]

    def innermost(self, ts, prefix):
        best = None
        hi = bisect.bisect_right(self.starts, ts)
        for e in self.spans[:hi]:
            if e["name"].startswith(prefix) and e["ts"] <= ts <= e["ts"] + e["dur"]:
                if best is None or e["dur"] <= best["dur"]:
                    best = e
        return best


def reduce(events):
    """Summary of a chrome trace's events (a list of dicts)."""
    ann = [e for e in events if e.get("cat") == "user_annotation" and "dur" in e]
    win = next(e for e in ann if e["name"] == WINDOW)
    t0, t1 = win["ts"], win["ts"] + win["dur"]
    by_tid = {}
    for e in ann:
        by_tid.setdefault(e["tid"], []).append(e)
    spans = {tid: _Spans(v) for tid, v in by_tid.items()}
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver")
               and "correlation" in e.get("args", {})}
    issued = {c for c, e in runtime.items()
              if t0 <= e["ts"] <= t1 and e["name"].startswith(ISSUE)}
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and e.get("args", {}).get("correlation") in issued]
    lost = len(issued) - len({e["args"]["correlation"] for e in dev})
    call_spans = sorted((e for e in ann if e["name"] in CALLS and t0 <= e["ts"] <= t1),
                        key=lambda e: e["ts"])
    calls = [Call(e["name"].split(".", 1)[1], e["ts"], e["dur"]) for e in call_spans]
    call_at = {(e["tid"], e["ts"]): k for k, e in enumerate(call_spans)}
    ops = []
    for e in dev:
        launch = runtime[e["args"]["correlation"]]
        sp = spans.get(launch["tid"]) or spans.get(win["tid"])
        op = DeviceOp(e["name"], e["cat"], e["ts"], e["dur"])
        if sp is not None:
            st = sp.innermost(launch["ts"], "cvx.")
            op.stage = st["name"] if st else None
            cs = sp.innermost(launch["ts"], "cvxbench.compress") or sp.innermost(
                launch["ts"], "cvxbench.decompress")
            if cs is not None:
                op.call = call_at.get((cs["tid"], cs["ts"]))
        ops.append(op)
        if op.call is not None:
            calls[op.call].ops.append(op)
    merged = union((o.ts, o.ts + o.dur) for o in ops)
    for c, e in zip(calls, call_spans):
        c.busy = covered(merged, c.ts, c.ts + c.dur)
        for s in by_tid[e["tid"]]:
            if s["name"].startswith("cvx.") and c.ts <= s["ts"] <= c.ts + c.dur:
                c.host[s["name"]] = c.host.get(s["name"], 0.0) + s["dur"]
    gaps = {}
    for c in calls:
        _gaps(gaps, merged, c.ts, c.ts + c.dur, spans.get(win["tid"]))
    return Summary(window_us=t1 - t0, busy_us=covered(merged, t0, t1), lost=lost,
                   issued=len(issued), calls=calls, ops=ops, gaps=gaps)


def _gaps(out, merged, t0, t1, spans):
    """Add the idle device time in [t0, t1] to `out`, by the innermost host
    span at each gap's middle (the program's cvx.* stage, else the
    benchmark's own)."""
    at = t0
    edges = [(max(a, t0), min(b, t1)) for a, b in merged if b > t0 and a < t1]
    for a, b in edges + [(t1, t1)]:
        if a > at:
            mid = (at + a) / 2
            name = "no span"
            if spans is not None:
                s = spans.innermost(mid, "cvx.") or spans.innermost(mid, "cvxbench.")
                name = s["name"] if s else name
            out[name] = out.get(name, 0.0) + (a - at)
        at = max(at, b)


TRIES = 6


def profile(run_window):
    """Trace `run_window()` (whole rounds) under torch.profiler inside the
    `cvxbench.window` span, until a trace holds every device record or
    TRIES are spent.  Returns (Summary, tries used).  The trace is
    written to TMPDIR and deleted once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile, record_function

    s = None
    for attempt in range(1, TRIES + 1):
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            warm = torch.zeros(1, device="cuda")
            for _ in range(8):
                warm.add_(1.0)
            torch.cuda.synchronize()
            with record_function(WINDOW):
                run_window()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="cvxbench_trace_")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        s = reduce(events)
        if not s.lost:
            return s, attempt
        print(f"trace try {attempt}: the trace lacks the device records of {s.lost} of "
            f"the window's {s.issued} launches, copies and memsets; tracing again")
    return s, TRIES
