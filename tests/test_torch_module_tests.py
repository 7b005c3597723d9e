"""The port's staged module tests (`cvxcompress_tpu_torch/module_tests.py`)
and integration test (`tools/integration_test_torch.py`) on the CPU: every
stage passes at small sizes, and a broken stage is reported, not passed."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
torch.set_num_threads(1)  # one thread a process: the suite runs in parallel workers

from cvxcompress_tpu_torch import module_tests as mt
from cvxcompress_tpu_torch.ops import wavelet
from cvxcompress_tpu_torch.utils import profiling

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import integration_test_torch as it  # noqa: E402


@pytest.fixture
def st():
    return mt.Stages("cpu")


STAGES = {
    "2-3 transforms": lambda st: mt.stage_2_3_transforms(st, False, (8, 16, 32)),
    # 256 on each axis (the 8-level cascade), blocks of at most 2^16 cells
    "2-3 deepest cascade": lambda st: mt.stage_2_3_transforms(st, False, (8, 256), 1 << 16),
    "5-6 block layout": lambda st: mt.stage_5_6_block_layout(st, True, (8, 16, 32)),
    "8 rms": mt.stage_8_rms,
    "9-10 codec": lambda st: mt.stage_9_10_codec(st, False, (51, 101, 151), (8, 32)),
    "11 giant run": mt.stage_11_giant_run,
    "12 roundtrip": lambda st: mt.stage_12_roundtrip(st, 64, (64, 64, 64)),
}


@pytest.mark.parametrize("name", list(STAGES))
def test_stage_passes_on_cpu(st, name):
    STAGES[name](st)
    assert st.failures == [] and st.device == torch.device("cpu")


THROUGHPUT = {
    "[4] transform throughput": (
        "TRANSFORM_FLOOR_MCS",
        lambda st: mt.stage_4_transform_throughput(st, False, (8, 32, 128), 1 << 18)),
    "[7] block layout throughput + exactness": (
        "LAYOUT_FLOOR_GBS", lambda st: mt.stage_7_layout_throughput(st, False, 128)),
}


@pytest.mark.parametrize("name", list(THROUGHPUT))
def test_throughput_stage_floor_decides(st, monkeypatch, name):
    """Stages [4] and [7] on the CPU: they run (the transforms and the
    layout at small budgets, [7]'s first and last blocks bit-exact), and
    their floor decides the check: a floor of 0 passes, an unreachable one
    fails.  A rate on a CPU shared by the suite's parallel workers is no
    measurement, so the floors themselves (10 MC/s, 0.5 GB/s) are held on
    the card (`chip_smoke.py` phase 3i) and by the command line."""
    const, stage = THROUGHPUT[name]
    monkeypatch.setattr(mt, const, 0.0)
    stage(st)
    assert st.failures == []
    monkeypatch.setattr(mt, const, float("inf"))
    stage(st)
    assert st.failures == [name]


def test_block_sweep():
    assert len(list(mt.block_sweep(True))) == 7 * 36
    assert list(mt.block_sweep(False, (8, 256), 1 << 16)) == [
        (8, 8, 1), (256, 8, 1), (8, 256, 1), (256, 256, 1), (8, 8, 8), (256, 8, 8),
        (8, 256, 8), (8, 8, 256)]
    default = list(mt.block_sweep(False))
    assert (256, 256, 8) in default and (128, 128, 128) in default
    assert all(bx * by * bz <= 1 << 21 for bx, by, bz in default)


def test_broken_transform_is_reported(st, monkeypatch):
    """A forward cascade 0.1 % off fails stage [2], and `run`
    returns the failed names (the exit code of the command line)."""
    real = wavelet.cascade_3d

    def broken(t, inverse):
        out = real(t, inverse)
        return out * 1.001 if not inverse else out

    monkeypatch.setattr(wavelet, "cascade_3d", broken)
    stage = mt.stage_2_3_transforms
    stage(st, False, (8,))
    assert st.failures == ["[2] forward transform vs oracle (sweep)"]
    monkeypatch.setattr(mt, "stage_2_3_transforms", lambda st, ex: stage(st, ex, (8, 16)))
    monkeypatch.setattr(mt, "stage_5_6_block_layout", lambda st, ex: None)
    monkeypatch.setattr(mt, "stage_9_10_codec", lambda st, quick: None)
    assert mt.run("cpu", quick=True)[0].startswith("[2]")
    assert mt.main(["--quick", "--device", "cpu"]) == 1


def test_default_device_needs_a_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            mt.Stages(None)


def test_integration_small_on_cpu():
    """The CI sinusoid's z profile, one 32^3 block column of k = 1, at the
    reference's bars (the JAX record at full size: err 1.551e-4, 76.2 dB)."""
    r = it.run_case(352, 32, 32, device="cpu")
    assert r["ok"] and r["err"] < 2e-4 and r["snr_db"] > 75, r
    assert 1000 < r["ratio"] < 1300
    bad = it.run_case(88, 104, 80, device="cpu")  # 10 periods in 88 cells: too fast
    assert not bad["ok"]


def test_profiling_helpers(tmp_path):
    from cvxcompress_tpu.utils import profiling as jprof

    for b in ((8, 8, 8), (32, 32, 32), (256, 8, 1), (16, 64, 128)):
        assert profiling.lifting_flops_per_cell(b) == jprof.lifting_flops_per_cell(b)
        assert profiling.matmul_flops_per_cell(b) == jprof.matmul_flops_per_cell(b)
    t = profiling.Timer()
    with t.stage("x"):
        np.zeros(10).sum()
    assert t.report("x", 1000, 2.0)["gflop_s"] > 0
    with profiling.device_trace(tmp_path / "trace"):
        with torch.profiler.record_function("cvx.probe"):
            torch.ones(3).sum()
    assert "cvx.probe" in (tmp_path / "trace" / "trace.json").read_text()
