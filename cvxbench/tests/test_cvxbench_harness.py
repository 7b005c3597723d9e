"""The harness on the CPU: BENCHMARK.json against the contract's shape, every
cell resolving to its files by name, a dummy cell added from new files
alone, the generator's seeds, and the function-level roofline count."""

import json
import math
import re
import shutil

import numpy as np
import pytest
import torch

from cvxbench.harness import bench, readers, roofline, spec
from cvxbench.harness.generator import Generator, seed_of

torch.set_num_threads(1)
BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
PATH_WORD = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_benchmark_keys_and_names():
    """Exactly the contract's keys; names, units and texts within their
    characters and lengths; every metric's `moves` an end-to-end metric."""
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cvxbench"]
    assert all(PATH_WORD.match(p) for p in BENCH["paths"])
    assert 1 <= BENCH["run_seconds"] <= 51
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("cvxbench/") and c["reduced"] == []
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        names += [w["name"], w["traffic"]]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for n in names:
        assert spec.NAME.match(n), n
    for text in ([c["source"] for c in BENCH["configs"]] + [x["why"] for x in
                 BENCH["configs"] + BENCH["workloads"]] + [m["layer"] for m in
                 BENCH["per_layer"]] + BENCH["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_resolves_by_name(workload):
    """Its configuration, traffic and limits files, and a reader for each
    of its metrics; every cell reports setup_s, another end-to-end metric
    and a per-layer one."""
    c = spec.cell(BENCH, workload)
    assert len(c.config["shape"]) == 3 and len(c.config["block"]) == 3
    assert c.traffic["snapshots"] >= 1 and c.traffic["terms"]
    assert set(c.limits) >= {"container_bytes_differing", "volume_cells_differing"}
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.load_metric(m["name"]).read)


def test_dummy_cell_from_new_files_only(tmp_path):
    """A cell, a traffic mix and a per-layer metric added as new files and
    new entries run without an edit to any file that is there."""
    shutil.copytree(spec.BENCH_DIR, tmp_path / "cvxbench")
    b = json.loads(json.dumps(BENCH))
    (tmp_path / "cvxbench/configs/tiny.json").write_text(json.dumps(
        {"shape": [40, 48, 72], "block": [8, 16, 8], "scale": 0.01,
         "use_local_rms": False}))
    (tmp_path / "cvxbench/traffic/mixed.json").write_text(json.dumps(
        {"snapshots": 2, "trace_rounds": 1, "noise_uniform": 0.001,
         "terms": [{"kind": "z_sinusoid", "periods": 3},
                   {"kind": "radial_sinusoid", "radius_divisor": 4.0,
                    "centre_shift": 0.25}]}))
    (tmp_path / "cvxbench/limits/tiny.mixed.json").write_text(json.dumps(
        {"container_bytes_differing": 0, "volume_cells_differing": 0}))
    (tmp_path / "cvxbench/metrics/calls.compress.py").write_text(
        "from cvxbench.harness import readers\n\n\n"
        "def read(run):\n    return float(len(readers.calls(run, 'compress')))\n")
    b["configs"].append({"name": "tiny", "source": "x", "file": "cvxbench/configs/tiny.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "tiny.mixed", "config": "tiny", "traffic": "mixed",
                           "chips": 1, "why": "x"})
    b["end_to_end"].append({"name": "calls.compress", "unit": "calls", "better": "higher",
                            "bound": 0.01, "source": "host_clock",
                            "workloads": ["tiny.mixed"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.cell(spec.load_benchmark(tmp_path), "tiny.mixed", tmp_path)
    cell.end_to_end = [m for m in cell.end_to_end if m["name"] != "setup_s"]
    run = bench.run(cell, 5, 0.0, device="cpu")
    assert run.correct and run.rounds == 1
    mod = spec.load_metric("calls.compress", tmp_path)
    assert mod.read(run) == 2.0
    res = bench.result(cell, run, False, "cpu")
    assert list(res)[-1] == "checks" and res["correct"]


def test_generator_is_a_function_of_seed_and_index():
    """The same (seed, i) gives the same snapshot, others differ; snapshot
    0 of the sinusoid is the reference CI volume; seeds past 2^32 work."""
    traffic = spec.cell(BENCH, "b32-radial").traffic
    big = 2**33 + 12345
    g, h = Generator(traffic, (16, 24, 40), big, "cpu"), Generator(traffic, (16, 24, 40), 7, "cpu")
    assert torch.equal(g.snapshot(3), g.snapshot(3))
    assert not torch.equal(g.snapshot(3), g.snapshot(4))
    assert not torch.equal(g.snapshot(3), h.snapshot(3))
    assert seed_of(big, 1, "noise") != seed_of(big + 1, 1, "noise")
    sin = spec.cell(BENCH, "b32-sinusoid").traffic
    v = Generator(sin, (64, 8, 8), big, "cpu").snapshot(0).numpy()
    z = np.sin((np.arange(64, dtype=np.float32) * np.float32(math.pi * 10 / 64)))
    assert np.allclose(v, z[:, None, None], atol=1e-6)
    assert not np.allclose(Generator(sin, (64, 8, 8), big, "cpu").snapshot(1).numpy(), v)


def test_roofline_counts_the_function():
    """At (704, 832, 640): 0.448 ms of bytes (the volume once, plus the
    container), 0.374 ms of FLOP at 32^3 and 0.380 ms at 64^3, bound by
    bytes; the count depends only on shapes and the container's size."""
    shape = (704, 832, 640)
    cells = 704 * 832 * 640
    assert roofline.cascade_flops(32) == pytest.approx(22.28, abs=0.01)
    assert 4 * cells / roofline.HBM_BPS * 1e3 == pytest.approx(0.4476, abs=1e-4)
    f32 = 3 * roofline.cascade_flops(32) * cells / roofline.F32_FLOPS * 1e3
    f64 = 3 * roofline.cascade_flops(64) * cells / roofline.F32_FLOPS * 1e3
    assert f32 == pytest.approx(0.374, abs=1e-3) and f64 == pytest.approx(0.380, abs=1e-3)
    for block in ((32, 32, 32), (64, 64, 64)):
        for d in ("compress", "decompress"):
            t, by = roofline.least_time(d, shape, block, 0)
            assert by == "bytes" and t * 1e3 == pytest.approx(0.4476, abs=1e-4)
            t2, _ = roofline.least_time(d, shape, block, 36_000_000)
            assert t2 - t == pytest.approx(36e6 / roofline.HBM_BPS)
    # flops of the whole blocks that cover a partial volume
    assert roofline.block_cells((40, 50, 70), (32, 32, 32)) == 64 * 64 * 96


def test_host_clock_readers():
    """Rates over all calls' summed time; the p95 of all call times."""

    class R:
        calls = ([dict(direction="compress", seconds=0.001 * (k + 1), cells=1000)
                  for k in range(100)]
                 + [dict(direction="decompress", seconds=0.002, cells=1000)] * 10)

    assert readers.gcells_per_s(R, "compress") == pytest.approx(
        100_000 / (0.001 * 5050) / 1e9)
    assert readers.p95_ms(R, "compress") == pytest.approx(95.95)
    assert readers.p95_ms(R, "decompress") is None  # fewer than 20 calls
