"""The comparison that decides `correct` has been shown to fail.

On the CPU at a size a test run holds, the harness drives whole runs (its
look for a card skipped): the port as it is reads 0 and is correct; the
control (the reference with its transforms in bfloat16 in the port's place)
and each fault that a cell can have, planted underneath the timed path, come
out not correct."""

import numpy as np
import pytest
import torch

from cvxbench.harness import bench, check, spec
from cvxbench.harness.control import Control

torch.set_num_threads(1)
SMALL = {"b32": [64, 64, 96], "b64": [64, 128, 64]}
SEED = 2**31 + 1234


def small_cell(workload):
    c = spec.cell(spec.load_benchmark(), workload)
    c.config = dict(c.config, shape=SMALL[workload[:3]])
    return c


# bytes of a token by its first byte (rle.py's grammar); a plain byte is 1
TOKEN_BYTES = {0x7F: 2, 0x7D: 4, 0x83: 3, 0x81: 4, 0x80: 5, 0x82: 17, 0x7E: 25}


def plain_token(data):
    """The offset of the first plain-byte token of value 1..100 in the
    container's first coded block."""
    dims = data[:24].view(np.uint32).astype(int)
    nnn = int(np.prod(-(-dims[:3] // dims[3:])))
    p = 32 + 8 * nnn
    while not 1 <= data[p] <= 100:
        p += TOKEN_BYTES.get(int(data[p]), 1)
    return p


class Faulty(bench.Program):
    """The port with one fault planted where its outputs are produced."""

    def __init__(self, config, device, fault):
        super().__init__(config, device)
        self.fault = fault
        self.prev_data = self.prev_vol = None

    def compress(self, vol):
        if self.fault == "half_left_out":  # half of the snapshot not encoded
            vol = vol.clone()
            vol[vol.shape[0] // 2:] = 0
        data = super().compress(vol)
        if self.fault == "state_unchanged" and self.prev_data is not None:
            data, self.prev_data = self.prev_data, data
        elif self.fault == "state_unchanged":
            self.prev_data = data
        if self.fault == "token_altered":  # one plain-byte token's value, +1
            data = data.copy()
            data[plain_token(data)] += 1
        return data

    def decompress(self, data):
        vol = super().decompress(data)
        if self.fault == "stale_volume":
            vol, self.prev_vol = (self.prev_vol if self.prev_vol is not None else vol), vol
        if self.fault == "cell_altered":
            vol = vol.clone()
            vol.view(-1)[12345] += 1.0
        return vol


@pytest.mark.parametrize("workload", ["b32-sinusoid", "b64-radial"])
def test_the_port_reads_zero(workload):
    run = bench.run(small_cell(workload), SEED, 0.0, device="cpu")
    assert run.correct and run.readings["containers"] >= 4
    assert all(run.readings[n] == 0 for n in check.NAMES)


@pytest.mark.parametrize("workload", ["b32-radial", "b64-sinusoid"])
def test_control_is_not_correct(workload):
    """The reference in bfloat16 in the port's place fails both numbers."""
    cell = small_cell(workload)
    run = bench.run(cell, SEED, 0.0, device="cpu", impl=Control(cell.config, "cpu"))
    assert not run.correct
    assert run.readings["container_bytes_differing"] > 0
    assert run.readings["volume_cells_differing"] > 0


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out", "token_altered",
                                   "stale_volume", "cell_altered"])
def test_each_fault_is_not_correct(fault):
    cell = small_cell("b32-radial")
    run = bench.run(cell, SEED, 0.0, device="cpu", impl=Faulty(cell.config, "cpu", fault))
    assert not run.correct
    res = bench.result(cell, run, False, "cpu")
    assert res["correct"] is False and list(res)[-1] == "checks"
    assert any(res["checks"][n]["value"] > res["checks"][n]["limit"] for n in check.NAMES)


def test_a_failed_call_is_not_correct():
    class Raises(bench.Program):
        def decompress(self, data):
            raise RuntimeError("planted")

    cell = small_cell("b32-sinusoid")
    run = bench.run(cell, SEED, 0.0, device="cpu", impl=Raises(cell.config, "cpu"))
    res = bench.result(cell, run, False, "cpu")
    assert res["failed"] == 1 and res["correct"] is False


def test_container_and_volume_diff():
    a = np.arange(10, dtype=np.uint8)
    b = a.copy()
    b[3] = 0
    assert check.container_diff(a, b) == 1 and check.container_diff(a, b[:8]) == 3
    v = torch.tensor([1.0, float("nan"), 3.0])
    w = torch.tensor([1.0, float("nan"), -3.0])
    assert check.volume_diff(v, w) == 1 and check.volume_diff(v, v.clone()) == 0
