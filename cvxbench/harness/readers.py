"""What the metric readers under metrics/ share: reductions of a run's
host-clock call records and of its trace summary.

A reader returns None when the run has nothing for it to read; the harness
then leaves the metric out of the result line.
"""

from __future__ import annotations

import statistics

from . import roofline


def calls(run, direction):
    """The timed calls of one direction: records with `seconds` and `cells`."""
    return [c for c in run.calls if c["direction"] == direction]


def gcells_per_s(run, direction):
    """Cells of all the direction's calls over their summed wall time."""
    cs = calls(run, direction)
    t = sum(c["seconds"] for c in cs)
    return sum(c["cells"] for c in cs) / t / 1e9 if cs and t > 0 else None


def p95_ms(run, direction):
    """The 95th percentile of all the direction's call times (Python's
    `statistics.quantiles`, exclusive method)."""
    t = [c["seconds"] * 1e3 for c in calls(run, direction)]
    return statistics.quantiles(t, n=20)[-1] if len(t) >= 20 else None


def traced(run, direction):
    if run.trace is None:
        return []
    return [c for c in run.trace.calls if c.direction == direction]


def span_ms(run, direction, span):
    """Host time of the program's span `span`, summed over the traced calls
    of the direction, per call."""
    cs = traced(run, direction)
    if not cs or not any(span in c.host for c in cs):
        return None
    return sum(c.host.get(span, 0.0) for c in cs) / len(cs) / 1e3


def device_ms(run, direction, stages, cats=("kernel", "gpu_memset")):
    """Device time of the kernels and memsets launched under any of the
    program's `stages` spans, summed over the traced calls of the
    direction, per call."""
    cs = traced(run, direction)
    ops = [o for c in cs for o in c.ops if o.stage in stages and o.cat in cats]
    if not cs or not ops:
        return None
    return sum(o.dur for o in ops) / len(cs) / 1e3


def roofline_pct(run, direction):
    """The direction's least time (roofline.py) over the device time of all
    the kernels and memsets its traced calls launched, in percent."""
    cs = traced(run, direction)
    if not cs or any(c.record is None for c in cs):
        return None
    least = sum(roofline.least_time(direction, run.shape, run.block,
                                    c.record["container_bytes"])[0] for c in cs)
    dev = sum(o.dur for c in cs for o in c.ops if o.cat in ("kernel", "gpu_memset")) / 1e6
    return 100.0 * least / dev if dev > 0 else None


def idle_pct(run, direction):
    """1 - device busy time / wall time over the direction's traced calls,
    in percent."""
    cs = traced(run, direction)
    wall = sum(c.dur for c in cs)
    if not cs or wall <= 0:
        return None
    return 100.0 * (1.0 - sum(c.busy for c in cs) / wall)
