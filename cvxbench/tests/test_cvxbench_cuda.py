"""The harness on the card (marked `cuda`; each test skips where there is
none): the reference computes the same bits on the card as on the CPU, a
small run of the port is correct on the card, and a traced run reads every
per-layer metric from a trace that holds all its device records.

    python -m pytest --noconftest -o addopts="" -q cvxbench/tests -m cuda
"""

import numpy as np
import pytest
import torch

from cvxbench.harness import bench, spec
from cvxbench.harness.generator import Generator
from cvxbench.reference import codec as rc

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def small(workload, shape):
    c = spec.cell(spec.load_benchmark(), workload)
    c.config = dict(c.config, shape=shape)
    return c


@pytest.mark.parametrize("workload", ["b32-radial", "b64-radial"])
def test_reference_on_the_card_is_the_cpu_reference(card, workload):
    c = small(workload, [128, 128, 192])
    vol = Generator(c.traffic, c.config["shape"], 99, "cpu").snapshot(2)
    args = (c.config["shape"], c.config["block"], c.config["scale"])
    want, want_vol = rc.Codec(*args).compress(vol)
    got, got_vol = rc.Codec(*args, device=card).compress(vol.to(card))
    assert np.array_equal(got, want)
    assert torch.equal(got_vol.cpu().view(torch.int32), want_vol.view(torch.int32))


@pytest.mark.parametrize("workload", ["b32-sinusoid", "b64-radial"])
def test_small_run_on_the_card(card, workload):
    c = small(workload, [128, 192, 256])
    run = bench.run(c, 2**31 + 5, 0.5, device=card)
    assert run.correct and run.rounds >= 1
    res = bench.result(c, run, False, card)
    assert set(res["metrics"]) >= {"setup_s", "compress_gcells_s", "decompress_gcells_s"}


def test_traced_run_reads_every_per_layer_metric(card):
    c = small("b32-radial", [128, 192, 256])
    run = bench.run(c, 2**31 + 6, 0.0, trace=True, device=card)
    assert run.correct and run.trace.lost == 0
    res = bench.result(c, run, True, card)
    assert set(res["metrics"]) == {m["name"] for m in c.per_layer}
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert 0 < res["metrics"]["compress_roofline"]["value"] <= 100
