"""The local-RMS cells on the CPU: the port's local `compress` and
`decompress` equal to the reference for both mixes, the kernel order's
table equal to the reference's on the generators' volumes
(`local_tables.compare`), the two readers of the local encode on a
hand-made trace, and the limits files' fields."""

import importlib.util
import json

import numpy as np
import pytest
import torch

from cvxbench.harness import spec, trace
from cvxbench.harness.generator import Generator
from cvxbench.reference import codec as rc

torch.set_num_threads(1)
BENCH = spec.load_benchmark()
LOCAL = [w["name"] for w in BENCH["workloads"]
         if spec.cell(BENCH, w["name"]).config.get("use_local_rms")]
BLOCK = (32, 32, 32)


def _volume(workload, shape, i, seed=2**31 + 1234):
    return Generator(spec.cell(BENCH, workload).traffic, shape, seed, "cpu").snapshot(i)


def test_the_local_cells():
    """The local encode's metrics are read in the local cells alone."""
    assert {"b32-sinusoid-local", "b32-radial-local"} <= set(LOCAL)
    new = {"device_ms.encode_local", "encode_local_roofline"}
    for w in BENCH["workloads"]:
        c = spec.cell(BENCH, w["name"])
        names = {m["name"] for m in c.per_layer}
        if w["name"] in LOCAL:
            assert c.config["block"] == list(BLOCK) and new <= names
        else:
            assert not new & names


@pytest.mark.parametrize("workload", LOCAL)
@pytest.mark.parametrize("shape", [(64, 96, 64), (40, 50, 70)])
def test_port_local_codec_is_the_reference(workload, shape):
    """Container byte-equal and decode bit-equal, snapshots 0 and 3, at an
    aligned and an unaligned volume."""
    import cvxcompress_tpu_torch as cvx

    codec = rc.Codec(shape, BLOCK, 1e-2, use_local_rms=True)
    for i in (0, 3):
        vol = _volume(workload, shape, i)
        want, want_vol = codec.compress(vol)
        got, _ = cvx.compress(vol, 1e-2, block=BLOCK, use_local_rms=True, device="cpu")
        assert np.array_equal(got, want)
        dec = cvx.decompress(got, device="cpu")
        assert torch.equal(dec.view(torch.int32), want_vol.view(torch.int32))


def _local_tables():
    path = spec.BENCH_DIR / "local_tables.py"
    s = importlib.util.spec_from_file_location("cvxbench_local_tables", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("workload", LOCAL)
def test_kernel_order_table_is_the_reference_table(workload):
    """On the plain encode's coefficients: no flip against the reference, the
    plain table is the encode's, and the two float64 sums differ by a few
    ulps at most, so a flip's expected count is tiny."""
    from cvxcompress_tpu_torch.ops import tokenize

    vol = _volume(workload, (64, 96, 128), 2)
    coeffs, *_, mulfacs = tokenize.fused_encode(vol, scale=1e-2)
    r = _local_tables().compare(coeffs, mulfacs, 1e-2)
    assert r["blocks"] == 24 and r["flips"] == 0 and r["plain"] == 0
    assert r["sum_rel_max"] < 1e-14 and r["expected"] < 1e-5


def events():
    """A 100 us window: a local compress [10, 50] with its encode kernel
    and a memset under cvx.fused_encode, a copy under cvx.stream_d2h and
    no launch under cvx.mulfac; a decompress [60, 95] with an inverse
    kernel."""
    def ann(name, ts, dur):
        return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
                "dur": dur, "tid": 1, "pid": 1}

    def launch(corr, ts, name="cudaLaunchKernel"):
        return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 1,
                "tid": 1, "pid": 1, "args": {"correlation": corr}}

    def dev(corr, name, ts, dur, cat="kernel"):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 7,
                "pid": 0, "args": {"correlation": corr}}

    return [ann("cvxbench.window", 0, 100), ann("cvxbench.compress", 10, 40),
            ann("cvx.mulfac", 11, 1), ann("cvx.fused_encode", 12, 8),
            ann("cvx.stream_d2h", 20, 15), ann("cvxbench.decompress", 60, 35),
            ann("cvx.fused_inverse", 75, 5),
            launch(1, 13), launch(2, 14, "cudaMemsetAsync"),
            launch(3, 21, "cudaMemcpyAsync"), launch(4, 76),
            dev(1, "fused_encode_kernel<true>", 14, 2000),
            dev(2, "Memset", 2020, 500, "gpu_memset"),
            dev(3, "Memcpy DtoH", 2600, 8, "gpu_memcpy"),
            dev(4, "fused_inverse_k", 2700, 12)]


def test_local_encode_readers_on_the_summary():
    class R:
        shape, block = (704, 832, 640), BLOCK

    R.trace = trace.reduce(events())
    enc = spec.load_metric("device_ms.encode_local")
    roof = spec.load_metric("encode_local_roofline")
    # the kernel and the memset under cvx.fused_encode, not the copy
    assert enc.read(R) == pytest.approx(2.5)
    least = roof.least_time(R.shape, R.block)
    # the volume read once bounds it (4 B a cell at 3.35 TB/s), above the
    # cascade's 3 x 22.28 f32 FLOP and the sum's 2 f64 FLOP a cell
    cells = 704 * 832 * 640
    assert least == pytest.approx(4 * cells / 3.35e12)
    assert least > cells * (3 * 22.28 / 67e12 + 2 / 34e12)
    assert roof.read(R) == pytest.approx(100 * least / 2.5e-3)
    R.trace = trace.reduce([e for e in events() if e.get("args", {}).get("correlation")
                            not in (1, 2)])
    assert enc.read(R) is None and roof.read(R) is None


@pytest.mark.parametrize("workload", LOCAL)
def test_limits_record_their_readings(workload):
    """Each limit with the program's largest and the control's smallest
    readings, the table's flip rate over at least 10 million blocks, and
    the limit at least 1,000 times below the control."""
    with open(spec.limits_path(workload)) as f:
        lim = json.load(f)
    r = lim["readings"]
    assert r["flips"]["blocks"] >= 10_000_000
    for n in ("container_bytes_differing", "volume_cells_differing"):
        assert r["program_largest"][n] <= lim[n]
        assert 1000 * lim[n] <= r["control_smallest"][n]
        assert r["control_smallest"][n] > 0
    if any(lim[n] for n in ("container_bytes_differing", "volume_cells_differing")):
        assert r["why_nonzero"]
    else:
        assert r["flips"]["flips"] == 0 and r["why_0"]
