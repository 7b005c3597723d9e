"""The codec's spans (`utils/profiling.py` `span`) on the CPU.

Under `torch.profiler` (CPU activity) a compress and a decompress at 32^3
and 64^3 under the global RMS and at 32^3 under the local RMS, each with a
raw block, show the named spans nested as the stages are, run no aten op
outside a `cvx.*` span (a local compress none under `cvx.mulfac`, and no
`cvx.mulfac_host` or `cvx.mulfac_wait`), and put the same ops under
the stages each `device_ms.*` metric of the benchmark reads with and
without the spans added below and beside them.  The spans each `host_ms.*`
metric times whole hold no span inside, the host plan (`cvx.plan`) holds
no op either, and the plans' upload span holds the copies alone, its
layout on the device (`cvx.plan_layout`) following it.  With no profiler,
`profiling.span` never enters `record_function`.
"""

import collections
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
torch.set_num_threads(1)  # one thread a process: the suite runs in parallel workers

import cvxcompress_tpu_torch as cvt  # noqa: E402
from cvxbench.harness import spec  # noqa: E402
from cvxcompress_tpu_torch import container as ctn  # noqa: E402
from cvxcompress_tpu_torch.ops import codec  # noqa: E402
from cvxcompress_tpu_torch.utils import profiling  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

# (block, shape, use_local_rms): the benchmark's two routes, "fused32" and
# "stripe", and "fused32" under the local RMS
CASES = {"b32": ((32, 32, 32), (64, 64, 96), False),
         "b64": ((64, 64, 64), (64, 64, 192), False),
         "b32-local": ((32, 32, 32), (64, 64, 96), True)}
SCALE = 1e-7  # the noise block's tokens outgrow its raw bytes: one raw block
# the spans the global RMS opens under `cvx.mulfac`; a local compress opens none
GLOBAL_RMS = {"cvx.mulfac_host", "cvx.mulfac_wait"}

# each span the calls open below another, with the span it lies in
PARENT = {
    "cvx.mulfac_host": "cvx.mulfac",
    "cvx.sizes_wait": "cvx.sizes_readback",
    "cvx.stream_wait": "cvx.stream_d2h",
}
TOP = {"cvx.volume_h2d", "cvx.mulfac", "cvx.bundle", "cvx.sizes_readback",
       "cvx.chunk_bases", "cvx.emit_chunks", "cvx.raw_gather", "cvx.stream_d2h",
       "cvx.assemble", "cvx.validate", "cvx.plan", "cvx.plan_h2d", "cvx.plan_layout",
       "cvx.decode_maps", "cvx.decode_chase", "cvx.decode_emit", "cvx.overlay_raw"}
# the public halves' own spans, around all of their stages
OUTER = {"cvx.compress_stage", "cvx.compress_finish", "cvx.decompress"}
ROUTE_SPANS = {"b32": {"cvx.fused_encode", "cvx.fused_inverse"},
               "b64": {"cvx.encode", "cvx.inverse"},
               "b32-local": {"cvx.fused_encode", "cvx.fused_inverse"}}
# the spans that the stages' split added: children, waits, untraced stretches
ADDED = set(PARENT) | OUTER | {
    "cvx.bundle", "cvx.raw_gather", "cvx.validate", "cvx.mulfac_wait", "cvx.volume_d2h",
    "cvx.volume_wait", "cvx.plan_pack", "cvx.decompress_many_prepare",
    "cvx.decompress_many_dispatch", "cvx.plan_layout"}
DEVICE_MS = ("device_ms.encode", "device_ms.emit", "device_ms.decode", "device_ms.inverse",
             "device_ms.encode_local")
HOST_MS = ("host_ms.compress", "host_ms.decompress")


def volume(case):
    """A z-sinusoid with N(0, 1) noise in its first block."""
    block, shape, _ = CASES[case]
    z = np.arange(shape[0], dtype=np.float64)[:, None, None]
    v = (np.sin(z * np.pi * 3 / shape[0]) * np.ones(shape)).astype(np.float32)
    rng = np.random.default_rng(21)
    v[:block[2], :block[1], :block[0]] = rng.standard_normal(block[::-1])
    return v


def profiled(case):
    """(container, events) of one compress and one device-engine
    decompress under a CPU profile."""
    block, _, local = CASES[case]
    v = volume(case)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        data, _ = cvt.compress(v, SCALE, block=block, use_local_rms=local, device="cpu")
        cvt.decompress(data, device="cpu", engine="device")
    return data, list(prof.events())


def innermost(e, spans):
    """The innermost `cvx.*` span of `spans` around event `e` (its thread)."""
    best = None
    a, b = e.time_range.start, e.time_range.end
    for s in spans:
        if s is e or s.thread != e.thread:
            continue
        if s.time_range.start <= a and b <= s.time_range.end:
            if best is None or s.time_range.elapsed_us() < best.time_range.elapsed_us():
                best = s
    return best


def cvx_spans(events):
    return [e for e in events if e.name.startswith("cvx.")]


@pytest.mark.parametrize("case", list(CASES))
def test_spans_nest_and_cover_every_op(case):
    data, events = profiled(case)
    assert (ctn.unpack(data)[1] < 0).sum() == 1  # the raw block
    spans = cvx_spans(events)
    outer = [s for s in spans if s.name in OUTER]
    stages = [s for s in spans if s.name not in OUTER]
    assert sorted(s.name for s in outer) == sorted(OUTER)
    parents = {}
    for s in stages:
        p = innermost(s, stages)
        parents.setdefault(s.name, set()).add(p.name if p else None)
        assert innermost(s, outer) is not None, s.name
    local = CASES[case][2]
    want = {n: {PARENT.get(n)} for n in TOP | ROUTE_SPANS[case] | set(PARENT)
            if not (local and n in GLOBAL_RMS)}
    assert parents == want
    assert ctn.unpack(data)[0].use_local_rms == local
    # every op lies in a stage, not only in a public half's own span
    outside = sorted({e.name for e in events
                      if e.name.startswith("aten::") and innermost(e, stages) is None})
    assert outside == []
    if local:  # each block's mulfac comes from the encode kernel alone
        assert not [e.name for e in events if e.name.startswith("aten::")
                    and (innermost(e, spans) or e).name == "cvx.mulfac"]


def _ops_by_stage(events):
    spans = cvx_spans(events)
    out = collections.Counter()
    for e in events:
        if e.name.startswith("aten::"):
            s = innermost(e, spans)
            out[(s.name if s else None, e.name)] += 1
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_device_ms_stages_hold_the_same_ops(case, monkeypatch):
    """Each device_ms metric's stages hold the same aten ops whether or
    not the added spans are entered."""
    with_added = _ops_by_stage(profiled(case)[1])
    span = profiling.span
    monkeypatch.setattr(profiling, "span", lambda name: (
        contextlib.nullcontext() if name in ADDED else span(name)))
    without = _ops_by_stage(profiled(case)[1])
    for m in DEVICE_MS:
        stages = set(spec.load_metric(m).STAGES)
        a = {k: n for k, n in with_added.items() if k[0] in stages}
        b = {k: n for k, n in without.items() if k[0] in stages}
        assert a == b and a, m


def test_no_span_and_no_record_without_a_profiler(monkeypatch):
    """With no profiler no span is entered, on every public path."""
    entered = []
    rf = profiling.record_function
    monkeypatch.setattr(profiling, "record_function",
                        lambda name: entered.append(name) or rf(name))
    block = CASES["b32"][0]
    data, _ = cvt.compress(volume("b32"), SCALE, block=block, device="cpu")
    cvt.decompress(data, device="cpu", engine="device")
    cvt.decompress(data, device="cpu", engine="host")
    codec.decompress_many([data, data], device="cpu")
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        cvt.decompress(data, device="cpu", engine="device")
    assert "cvx.plan" in entered


@pytest.mark.parametrize("case", list(CASES))
def test_host_ms_spans_hold_no_span(case):
    """A span's own cost under a trace lands in the span around it: the
    spans that host_ms.* time whole open none inside, on one call or a
    batch."""
    block, _, local = CASES[case]
    v = volume(case)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        datas = [d for d, _ in codec.compress_many([v, v], SCALE, block=block,
                                                   use_local_rms=local, device="cpu")]
        cvt.decompress(datas[0], device="cpu", engine="device")
        codec.decompress_many(datas, device="cpu")
    spans = cvx_spans(prof.events())
    for m in HOST_MS:
        name = spec.load_metric(m).SPAN
        timed = [s for s in spans if s.name == name]
        inside = sorted({s.name for s in spans for t in timed
                         if s is not t and s.thread == t.thread
                         and t.time_range.start <= s.time_range.start <= t.time_range.end})
        assert timed and inside == [], (m, inside)


def test_plan_upload_span_holds_the_copy_alone():
    """decompress_many's `cvx.plan_h2d` holds the packed heads' and
    payloads' one copy and the two allocations (the upload, the blobs); the
    layouts and the fields' views are made after it."""
    block = CASES["b32"][0]
    data, _ = cvt.compress(volume("b32"), SCALE, block=block, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        codec.decompress_many([data, data], device="cpu")
    events = list(prof.events())
    spans = cvx_spans(events)
    ops = collections.Counter(
        e.name for e in events if e.name.startswith("aten::")
        and (innermost(e, spans) or e).name == "cvx.plan_h2d")
    assert ops == {"aten::empty": 2, "aten::copy_": 1}, ops


# the ops that make a view or wrap a numpy array: they launch nothing
VIEWS = {"aten::slice", "aten::as_strided", "aten::lift_fresh"}


@pytest.mark.parametrize("case", list(CASES))
def test_plan_holds_no_op_and_its_upload_the_two_copies(case):
    """A device-engine decompress: `cvx.plan` (the host's O(blocks) plan)
    runs no op and opens no span; `cvx.plan_h2d` holds the head's and the
    payload's copies, the two allocations (the upload, the blob) and the
    views they copy into, and nothing else; `cvx.plan_layout` follows it."""
    block, _, local = CASES[case]
    data, _ = cvt.compress(volume(case), SCALE, block=block, use_local_rms=local,
                           device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cvt.decompress(data, device="cpu", engine="device")
    events = list(prof.events())
    spans = cvx_spans(events)
    by_span = collections.defaultdict(collections.Counter)
    for e in events:
        if e.name.startswith("aten::") or e.name.startswith("cvx."):
            s = innermost(e, spans)
            by_span[s.name if s else None][e.name] += 1
    assert not by_span["cvx.plan"], by_span["cvx.plan"]
    upload = by_span["cvx.plan_h2d"]
    assert {k: n for k, n in upload.items() if k not in VIEWS} == {
        "aten::empty": 2, "aten::copy_": 2}, upload
    (plan_h2d,) = [s for s in spans if s.name == "cvx.plan_h2d"]
    (layout,) = [s for s in spans if s.name == "cvx.plan_layout"]
    assert plan_h2d.time_range.end <= layout.time_range.start


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_waits_on_the_card_hold_only_their_copy(case):
    """On the card each `*_wait` span holds no op but the copy it waits
    for, and the global RMS's sums come back inside `cvx.mulfac_wait`; a
    local compress opens no `cvx.mulfac_wait` and launches nothing under
    `cvx.mulfac`, so its waits (on the events of copies issued before
    them) hold no op at all."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    block, _, local = CASES[case]
    v = torch.from_numpy(volume(case)).cuda()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        data, _ = cvt.compress(v, SCALE, block=block, use_local_rms=local)
        cvt.decompress(data)
        torch.cuda.synchronize()
    events = list(prof.events())
    spans = cvx_spans(events)
    names = {s.name for s in spans}
    assert {"cvx.sizes_wait", "cvx.stream_wait"} <= names
    assert ("cvx.mulfac_wait" in names) != local
    if local:
        assert not [e.name for e in events if e.name.startswith("aten::")
                    and (innermost(e, spans) or e).name == "cvx.mulfac"]
    ops = {e.name for e in events if e.name.startswith("aten::")
           and (innermost(e, spans) or e).name.endswith("_wait")}
    # the copy and `.numpy()`'s metadata ops, which launch nothing
    assert ops <= {"aten::to", "aten::_to_copy", "aten::empty_strided", "aten::copy_",
                   "aten::detach", "aten::resolve_conj", "aten::resolve_neg"}, ops
    assert ("aten::copy_" in ops) != local, ops
