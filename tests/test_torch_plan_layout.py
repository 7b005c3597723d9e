"""The decode plan laid out from the container's payload and a small head
(ops/entropy_decode.py `device_plan`, `upload_plan`, `plan_layout`; on
the CPU its plain version) against the numpy plan
(`plan`) byte for byte, and the device engine on it against the engine on
`plan`'s blob.  The card's kernel is held to the plain version in
tests/test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
torch.set_num_threads(1)  # one thread a process: the suite runs in parallel workers

from cvxcompress_tpu_torch.ops import codec  # noqa: E402
from cvxcompress_tpu_torch.ops import entropy_decode as ed  # noqa: E402

import plan_layout_cases as lc  # noqa: E402


def head_coverage(s):
    """How many times the head's rows and the subsegment tables write each
    byte of the blob (the kernel's writes; every byte once)."""
    nrow = s["nrow"]
    rows = s["head"][: ed._ROW.itemsize * nrow].view(ed._ROW)
    cover = np.zeros(s["size"] + 1, np.int64)
    np.add.at(cover, rows["dst"], 1)
    np.add.at(cover, rows["dst"] + rows["fill"], -1)
    for name, width in (("sub_block", 4), ("sub_reset", 1)):
        o = s["layout"][name][0]
        cover[o] += 1
        cover[o + width * s["nsub"]] -= 1
    cum = s["head"][ed._ROW.itemsize * nrow: ed._ROW.itemsize * nrow + 8 * (nrow + 1)]
    chunks = -(-rows["fill"].astype(np.int64) // ed.CHUNK)
    np.testing.assert_array_equal(cum.view(np.int64), np.append(0, np.cumsum(chunks)))
    # 4-byte stores: destinations and fills are whole words; stream rows
    # cover whole subsegments
    assert not (rows["dst"] % 4).any() and not (rows["fill"] % 4).any()
    stream = rows["blk"] >= 0
    assert not (rows["dst"][stream] % ed.W).any() and not (rows["fill"][stream] % ed.W).any()
    return np.cumsum(cover)[:-1]


@pytest.mark.parametrize("case", list(lc.CASES))
def test_plain_layout_equals_plan(case):
    data = lc.CASES[case]()
    p = ed.plan(data)
    s = ed.device_plan(data)
    assert s["nrow"] < 2 * p["hdr"].grid[3] + 40  # O(blocks), not O(subsegments)
    np.testing.assert_array_equal(head_coverage(s), 1)
    up, blob = ed.upload_plan(s, "cpu")
    assert up.numel() == s["head"].size + ed._align(s["payload"].size)
    b = ed.plan_layout(up, blob.fill_(0xAB), s)  # every byte written
    np.testing.assert_array_equal(blob.numpy(), p["blob"])
    for name in b:
        assert b[name].dtype == ed._TORCH_DTYPES[p["layout"][name][1]], name
    if case == "raw":
        assert s["raw_ids"].size == 2
    if case == "one_block":
        assert p["hdr"].grid[3] == 1
    if case == "permuted":
        offs = s["offs"]
        assert not (np.diff(offs) > 0).all()
    # the device engine on the new path, bit for bit as on `plan`'s blob
    got = codec.decompress_device(data, torch.device("cpu"))
    want = codec._decode_planned(p, ed.upload(p, "cpu"))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # degenerate spans: None on both paths, and the host engine decides
    bad = lc.degenerate(data)
    assert ed.plan(bad) is None and ed.device_plan(bad) is None
    assert codec.decompress_device(bad, torch.device("cpu")) is None
