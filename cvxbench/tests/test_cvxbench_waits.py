"""The readers of the program's spans below its stages (device_ms.rms,
wait_ms.compress and wait_ms.decompress, `harness/waits.py`) on a
hand-made chrome trace: the RMS's device time without its read-back, the
waits' host time, and None where the trace has no wait span or no call."""

import pytest

from cvxbench.harness import spec, trace
from test_cvxbench_trace import ann, dev, launch


def events(waits=True):
    """A compress call [10, 60]: the RMS's kernel and memset under
    cvx.mulfac, its read-back copy under cvx.mulfac_wait [22, 29], the
    sizes' wait [32, 36], the stream's [43, 48]; a decompress call [70,
    100]: cvx.validate, cvx.plan, the plan's upload in cvx.plan_h2d [80,
    86], a decode kernel.  Without `waits`, the parent's spans: no
    cvx.*_wait."""
    ev = [ann("cvxbench.window", 0, 200), ann("cvxbench.compress", 10, 50),
          ann("cvx.mulfac", 11, 19), ann("cvx.sizes_readback", 31, 9),
          ann("cvx.stream_d2h", 41, 9), ann("cvx.assemble", 50, 8),
          ann("cvxbench.decompress", 70, 30), ann("cvx.validate", 70, 1),
          ann("cvx.plan", 71, 9), ann("cvx.plan_h2d", 80, 6), ann("cvx.decode_emit", 86, 4),
          launch(1, 12), launch(2, 14, "cudaMemsetAsync"), launch(3, 23, "cudaMemcpyAsync"),
          launch(4, 81, "cudaMemcpyAsync"), launch(5, 87),
          dev(1, "reduce_k", 13, 7), dev(2, "Memset", 20, 2, "gpu_memset"),
          dev(3, "Memcpy DtoH", 24, 3, "gpu_memcpy"),
          dev(4, "Memcpy HtoD (Pageable)", 82, 4, "gpu_memcpy"), dev(5, "decode_emit_k", 88, 2)]
    if waits:
        ev += [ann("cvx.mulfac_wait", 22, 7), ann("cvx.sizes_wait", 32, 4),
               ann("cvx.stream_wait", 43, 5)]
    return ev


def run_of(ev):
    class R:
        shape, block = (704, 832, 640), (32, 32, 32)

    R.trace = trace.reduce(ev)
    return R


def read(name, run):
    return spec.load_metric(name).read(run)


def test_rms_device_time_is_its_kernels_and_memsets():
    r = run_of(events())
    assert read("device_ms.rms", r) == pytest.approx(0.009)  # the copy is not counted
    assert read("device_ms.encode", r) == pytest.approx(0.009)
    assert read("device_ms.rms", run_of(events(waits=False))) == pytest.approx(0.009)


def test_wait_spans_host_time():
    r = run_of(events())
    assert read("wait_ms.compress", r) == pytest.approx(0.007 + 0.004 + 0.005)
    assert read("wait_ms.decompress", r) == pytest.approx(0.006)
    parent = run_of(events(waits=False))
    assert read("wait_ms.compress", parent) is None
    assert read("wait_ms.decompress", parent) == pytest.approx(0.006)


def test_none_without_traced_calls():
    r = run_of(events())
    r.trace = None
    assert read("wait_ms.compress", r) is None and read("device_ms.rms", r) is None
