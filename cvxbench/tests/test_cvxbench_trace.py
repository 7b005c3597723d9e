"""The trace reduction on a hand-made chrome trace: the interval union, each
device operation tied to its stage and call through the correlation id, the
idle share, the idle gaps by host span, and the check that every launch
has its device record."""

import pytest

from cvxbench.harness import readers, trace


def ann(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1}


def launch(corr, ts, name="cudaLaunchKernel", tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 1,
            "tid": tid, "pid": 1, "args": {"correlation": corr}}


def dev(corr, name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 7,
            "pid": 0, "args": {"correlation": corr}}


def events(lose=False):
    """A 100 us window: a compress call [10, 50] with an encode kernel and a
    memset under cvx.fused_encode and a copy under cvx.stream_d2h, host
    span cvx.assemble [40, 50]; a decompress call [60, 95] with a decode
    kernel and an inverse kernel; a generator kernel between the calls."""
    ev = [ann("cvxbench.window", 0, 100), ann("cvxbench.compress", 10, 40),
          ann("cvx.fused_encode", 12, 8), ann("cvx.stream_d2h", 20, 15),
          ann("cvx.assemble", 40, 10), ann("cvxbench.generate", 52, 6),
          ann("cvxbench.decompress", 60, 35), ann("cvx.plan", 61, 9),
          ann("cvx.decode_emit", 70, 5), ann("cvx.fused_inverse", 75, 5),
          launch(1, 13), launch(2, 14, "cudaMemsetAsync"), launch(3, 21, "cudaMemcpyAsync"),
          launch(4, 53), launch(5, 71), launch(6, 76),
          launch(9, 30, "cudaStreamSynchronize"),
          dev(1, "fused_encode_k", 14, 10), dev(2, "Memset", 20, 2, "gpu_memset"),
          dev(3, "Memcpy DtoH", 22, 8, "gpu_memcpy"), dev(4, "gen_k", 54, 3),
          dev(5, "decode_emit_k", 72, 4), dev(6, "fused_inverse_k", 76, 12)]
    if lose:
        ev = [e for e in ev if e.get("args", {}).get("correlation") != 5 or
              e["cat"] != "kernel"]
    return ev


def test_union_and_cover():
    m = trace.union([(5, 7), (0, 2), (1, 3), (7, 9)])
    assert m == [[0, 3], [5, 9]]
    assert trace.covered(m, 2, 6) == pytest.approx(2.0)


def test_reduce_attributes_ops_to_stages_and_calls():
    s = trace.reduce(events())
    assert s.lost == 0 and s.issued == 6  # the synchronize issues nothing
    assert s.window_us == 100
    # busy: [14, 30] (kernel, memset, copy), [54, 57], [72, 76], [76, 88]
    assert s.busy_us == pytest.approx(16 + 3 + 4 + 12)
    comp, dec = s.calls
    assert (comp.direction, dec.direction) == ("compress", "decompress")
    assert [(o.name, o.stage) for o in comp.ops] == [
        ("fused_encode_k", "cvx.fused_encode"), ("Memset", "cvx.fused_encode"),
        ("Memcpy DtoH", "cvx.stream_d2h")]
    assert [o.stage for o in dec.ops] == ["cvx.decode_emit", "cvx.fused_inverse"]
    gen = [o for o in s.ops if o.name == "gen_k"][0]
    assert gen.call is None and gen.stage is None
    assert comp.busy == pytest.approx(16) and dec.busy == pytest.approx(16)
    assert comp.host == {"cvx.fused_encode": 8, "cvx.stream_d2h": 15, "cvx.assemble": 10}
    # idle time by the host span at each gap's middle
    # idle time inside the calls: [10, 14] mid 12 in cvx.fused_encode,
    # [30, 50] mid 40 in cvx.assemble, [60, 72] mid 66 in cvx.plan, [88, 95]
    assert s.gaps == {"cvx.fused_encode": 4, "cvx.assemble": 20, "cvx.plan": 12,
                      "cvxbench.decompress": 7}
    assert (s.calls_us, s.calls_busy_us) == (75, 32)
    b = s.breakdown()  # the generator's kernel is not the program's
    assert b["device_ops"][0] == ["fused_inverse_k", 12e-6]
    assert "gen_k" not in [k for k, _ in b["device_ops"]]
    assert sum(v for _, v in b["idle_gaps"]) == pytest.approx(43e-6)


def test_readers_on_the_summary():
    class R:
        shape, block = (704, 832, 640), (32, 32, 32)

    R.trace = trace.reduce(events())
    R.trace.calls[0].record = {"container_bytes": 1000}
    R.trace.calls[1].record = {"container_bytes": 1000}
    assert readers.device_ms(R, "compress", ("cvx.fused_encode",)) == pytest.approx(0.012)
    assert readers.device_ms(R, "decompress", ("cvx.fused_inverse",)) == pytest.approx(0.012)
    assert readers.device_ms(R, "compress", ("cvx.emit_chunks",)) is None
    assert readers.span_ms(R, "compress", "cvx.assemble") == pytest.approx(0.010)
    assert readers.span_ms(R, "decompress", "cvx.plan") == pytest.approx(0.009)
    assert readers.idle_pct(R, "compress") == pytest.approx(100 * (1 - 16 / 40))
    assert readers.idle_pct(R, "decompress") == pytest.approx(100 * (1 - 16 / 35))
    least = (4 * 704 * 832 * 640 + 1000) / 3.35e12
    # compress: kernel 10 + memset 2 us (the copy is not counted)
    assert readers.roofline_pct(R, "compress") == pytest.approx(100 * least / 12e-6)


def test_lost_records_are_counted():
    s = trace.reduce(events(lose=True))
    assert s.lost == 1
