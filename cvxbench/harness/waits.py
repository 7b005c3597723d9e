"""The host time of the program's waits on the card, for the wait_ms
metrics: its spans whose names end in "_wait" (`cvxcompress_tpu_torch`
`utils/profiling.py`), each enclosing no launch but the copy it waits
for, and any span named beside them."""

from __future__ import annotations

from . import readers


def waits_ms(run, direction, also=()):
    """Host time of the program's wait spans ("cvx.*_wait") and of the
    spans `also`, summed over the traced calls of the direction, per
    call; None where the calls have none of them."""
    cs = readers.traced(run, direction)
    names = {s for c in cs for s in c.host if s.endswith("_wait") or s in also}
    if not cs or not names:
        return None
    return sum(c.host.get(s, 0.0) for c in cs for s in names) / len(cs) / 1e3
