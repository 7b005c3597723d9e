"""What the benchmark loads: nothing whose top-level name is jax, jaxlib,
flax or cvxcompress_tpu (names compared whole: the port's own name begins
with the JAX package's), and the reference nothing of the port.  And the
command fails without a result where there is no card, or where the
checkout holds only the benchmark."""

import json
import os
import shutil
import subprocess
import sys

from cvxbench.harness.spec import ROOT

FOREIGN = ("jax", "jaxlib", "flax", "cvxcompress_tpu")


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport json, sys\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    """The harness, every metric reader and the port, as a run loads them."""
    top = _loaded(
        "from cvxbench.harness import bench, check, control, spec, trace\n"
        "b = spec.load_benchmark()\n"
        "for m in b['end_to_end'] + b['per_layer']: spec.load_metric(m['name'])\n"
        "import cvxcompress_tpu_torch\n"
        "assert not bench.foreign_modules()\n")
    assert "cvxcompress_tpu_torch" in top
    assert not top & set(FOREIGN)


def test_reference_loads_nothing_of_the_port():
    top = _loaded("from cvxbench.reference import codec, container, rle\n"
                  "from cvxbench.harness import check, generator\n")
    assert not top & set(FOREIGN + ("cvxcompress_tpu_torch",))


def test_foreign_names_are_compared_whole():
    from cvxbench.harness import bench

    sys.modules.setdefault("cvxcompress_tpu_torchlike", sys)
    try:
        assert "cvxcompress_tpu_torchlike" not in bench.foreign_modules()
    finally:
        del sys.modules["cvxcompress_tpu_torchlike"]


def test_no_result_without_a_card_or_the_program(tmp_path):
    """Run where torch sees no card: exit 2, no JSON line.  Run in a
    directory that holds only BENCHMARK.json and cvxbench/: not 0, no
    result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    args = [sys.executable, "cvxbench/run.py", "--workload", "b32-sinusoid", "--seed",
            "5", "--seconds", "1", "--trace", "0"]
    out = subprocess.run(args, cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode == 2 and "{" not in out.stdout
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "cvxbench", tmp_path / "cvxbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(args, cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode != 0 and "{" not in out.stdout
