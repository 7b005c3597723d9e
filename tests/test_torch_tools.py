"""The port's command-line tools (`tools/*_torch.py`) on the CPU at small
shapes: each `main` runs with `--device cpu`; `gen_empty_volume_torch`
writes the JAX tool's file byte for byte; `test_compression_torch`'s XZ
slices are the JAX tool's `dump_xz_slice` text; `compress_seam_basin_torch`'s
rows are within level 3 of the JAX tool's; `profile_trace_torch`'s trace
holds `cvx.*` spans; `scaling_bench_torch`'s report has its keys and its
exit code follows it; and a process that runs them all imports no jax."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
torch.set_num_threads(1)  # one thread a process: the suite runs in parallel workers

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TOOLS = os.path.join(REPO, "tools")
sys.path.insert(0, TOOLS)

import compress_seam_basin_torch as seam_t  # noqa: E402
import gen_empty_volume_torch as empty_t  # noqa: E402
import profile_trace_torch as trace_t  # noqa: E402
import scaling_bench_torch as scaling_t  # noqa: E402
import test_compression_torch as tc_t  # noqa: E402

from cvxcompress_tpu_torch.utils import volumes  # noqa: E402


def jax_tool(name):
    """A JAX tool's module, loaded from its file (its imports of the JAX
    package sit inside its `main`)."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_test_compression_runs_and_dumps(tmp_path, capsys):
    """The report, the container, the error volume and the three XZ-slice
    dumps; the slices are `tools/test_compression.py`'s text byte for
    byte on the same volumes."""
    pre = str(tmp_path / "s")
    rc = tc_t.main(["--nz", "12", "--ny", "20", "--nx", "28", "--block", "8,8,8",
                    "--device", "cpu", "--out", str(tmp_path / "c.cvx"),
                    "--dump-error", str(tmp_path / "e.bin"), "--dump-slices", pre])
    out = capsys.readouterr().out
    assert rc == 0 and "compress" in out and "SNR" in out
    from cvxcompress_tpu_torch.utils import io

    data = np.fromfile(tmp_path / "c.cvx", dtype=np.uint8)
    assert io.probe(data)["payload_bytes"] > 0
    vol = volumes.radial_volume(12, 20, 28)
    err = np.fromfile(tmp_path / "e.bin", dtype=np.float32).reshape(vol.shape)
    assert 0 < err.max() < 0.1
    jt = jax_tool("test_compression")
    for kind, v in (("input", vol), ("error", err)):
        jt.dump_xz_slice(str(tmp_path / f"j_{kind}.txt"), v)
        assert (tmp_path / f"s_{kind}.txt").read_bytes() == \
            (tmp_path / f"j_{kind}.txt").read_bytes()
    assert (tmp_path / "s_output.txt").stat().st_size > 0


def test_gen_empty_volume_same_file_as_jax_tool(tmp_path, subprocess_timeout):
    """The same bytes as `tools/gen_empty_volume.py`, and a round trip of
    the file through the port decodes to zeros."""
    assert empty_t.main([str(tmp_path / "t.bin"), "10", "12", "14", "--device", "cpu"]) == 0
    subprocess.run([sys.executable, os.path.join(TOOLS, "gen_empty_volume.py"),
                    str(tmp_path / "j.bin"), "10", "12", "14"], check=True,
                   capture_output=True, env={**os.environ, "JAX_PLATFORMS": "cpu"},
                   timeout=subprocess_timeout)
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    assert (tmp_path / "t.bin").stat().st_size == 4 * 10 * 12 * 14


def read_rows(path):
    lines = open(path).read().splitlines()
    return lines[0], [[float(x) for x in ln.split(",")] for ln in lines[1:]]


def test_seam_rows_within_level3_of_jax_tool(tmp_path, monkeypatch):
    """The JAX tool's CSV header; each row's size within max(64 B, 1 %) of
    the JAX tool's row (level 3) and its error within 2 % (0.2 dB)."""
    shape = ["--nz", "24", "--ny", "32", "--nx", "40"]
    mine = tmp_path / "t.csv"
    assert seam_t.main([*shape, "--scales", "1e-1,1e-2", "--device", "cpu",
                        "--results", str(mine)]) == 0
    monkeypatch.setattr(sys, "argv", ["compress_seam_basin.py", *shape, "--scales",
                                      "1e-1,1e-2", "--results", str(tmp_path / "j.csv")])
    assert jax_tool("compress_seam_basin").main() == 0
    head, rows = read_rows(mine)
    jhead, jrows = read_rows(tmp_path / "j.csv")
    assert head == jhead == seam_t.HEADER.strip()
    cells = 24 * 32 * 40
    for r, j in zip(rows, jrows, strict=True):
        assert r[0] == j[0]
        size, jsize = 4 * cells / r[1], 4 * cells / j[1]
        assert abs(size - jsize) <= max(64, 0.01 * jsize) + 1
        assert abs(r[2] / j[2] - 1) <= 0.02 and abs(r[3] - j[3]) <= 0.2


def test_profile_trace_holds_cvx_spans(tmp_path):
    """The trace is written after a warm-up and holds the codec's stage
    spans."""
    logdir = tmp_path / "tr"
    assert trace_t.main(["--nz", "24", "--ny", "24", "--nx", "24", "--iters", "1",
                         "--device", "cpu", "--logdir", str(logdir)]) == 0
    spans = trace_t.span_counts(str(logdir / "trace.json"))
    assert {"cvx.fused_encode", "cvx.emit_chunks", "cvx.fused_inverse"} <= set(spans)


def test_scaling_report_keys_and_exit_code(tmp_path):
    """The report's keys per mesh size; the projection labelled a model; the
    exit code 0 iff every mesh size matches the single call and every
    modelled efficiency reaches the target."""
    out = tmp_path / "r.json"
    rc = scaling_t.main(["--sizes", "1,2", "--device", "cpu", "--out", str(out)])
    rep = json.loads(out.read_text())
    assert rep["model"]["kind"] == "model" and rep["target_efficiency"] == 0.85
    assert set(rep["cases"]) == {"balanced", "skewed"}
    ok = True
    for case in rep["cases"].values():
        assert set(case["mesh"]) == {"1", "2"}
        for n, e in case["mesh"].items():
            assert {"compress_block_rows_per_shard", "compress_balance",
                    "decompress_block_rows_per_shard",
                    "decompress_payload_bytes_per_shard", "decompress_balance", "comm",
                    "model_efficiency_compress", "model_efficiency_decompress",
                    "wall_compress_s", "wall_decompress_s", "matches_single_chip"} <= set(e)
            assert set(e["comm"]) == {"sumsq_bytes", "payload_bytes_per_host",
                                      "offset_table_bytes"}
            assert len(e["decompress_payload_bytes_per_shard"]) == int(n)
            assert e["matches_single_chip"]
            ok &= min(e["model_efficiency_compress"],
                      e["model_efficiency_decompress"]) >= 0.85
    assert rep["all_checks_and_projections_meet_target"] == ok
    assert rc == (0 if ok else 1)
    # the skewed payload sits in the low-z quarter: two slabs' bytes differ
    skew = rep["cases"]["skewed"]["mesh"]["2"]["decompress_payload_bytes_per_shard"]
    assert skew[0] > skew[1]


def test_tools_import_no_jax(tmp_path, subprocess_timeout):
    """A process that runs every tool's main (tiny shapes, the CPU) has no
    jax in sys.modules."""
    d = str(tmp_path)
    code = f"""
import sys
sys.path.insert(0, {TOOLS!r})
import torch
torch.set_num_threads(1)
import compress_seam_basin_torch, gen_empty_volume_torch, profile_trace_torch
import scaling_bench_torch, test_compression_torch
assert test_compression_torch.main(["--nz", "8", "--ny", "8", "--nx", "8",
                                    "--block", "8,8,8", "--device", "cpu"]) == 0
assert gen_empty_volume_torch.main([{d!r} + "/z.bin", "8", "8", "8", "--device", "cpu"]) == 0
assert compress_seam_basin_torch.main(["--nz", "8", "--ny", "8", "--nx", "8", "--scales",
                                       "1e-2", "--device", "cpu", "--results",
                                       {d!r} + "/r.csv"]) == 0
assert profile_trace_torch.main(["--nz", "8", "--ny", "8", "--nx", "8", "--iters", "1",
                                 "--device", "cpu", "--logdir", {d!r} + "/tr"]) == 0
scaling_bench_torch.make_inputs()
print("jax" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=REPO, timeout=subprocess_timeout)
    assert out.stdout.split()[-1] == "False"
