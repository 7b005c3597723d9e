"""The port's batched codecs (ops/codec.py `compress_many`,
`decompress_many`) and streams (pipeline.py) on the CPU: every container
byte-equal to the single `compress` of the same volume, every volume
bit-equal to the single `decompress` on the same engine, order and the
bound on what is in flight kept, mixed geometry falling back; and the
JAX package's batched containers decoded both ways (level 3)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
torch.set_num_threads(1)  # one thread a process: the suite runs in parallel workers

import cvxcompress_tpu_torch as cvt
from cvxcompress_tpu.ops import codec as jcodec
from cvxcompress_tpu_torch import container as ctn
from cvxcompress_tpu_torch import pipeline
from cvxcompress_tpu_torch.ops import codec, quant

from conftest import make_radial_volume

F32 = np.float32
TRANSFORM_TOL = 1e-5


def _vols(k=3, shape=(16, 16, 16), seed=42):
    rng = np.random.default_rng(seed)
    return [
        (np.sin(np.arange(np.prod(shape), dtype=F32) / (7.0 + j)).reshape(shape)
         + rng.standard_normal(shape).astype(F32) * 0.01).astype(F32)
        for j in range(k)
    ]


def _raw_vols(k=2):
    """Volumes with raw-fallback blocks beside token-coded ones."""
    out = []
    for j in range(k):
        v = make_radial_volume(nz=40, ny=16, nx=16, seed=j)
        v[:16] = (np.random.default_rng(j).standard_normal((16, 16, 16)) * 1e10
                  ).astype(F32)
        out.append(v)
    return out


def bits(t):
    return np.asarray(t).view(np.uint32)


def rel_rms(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.sqrt(((got - ref) ** 2).mean()) / (np.sqrt((ref ** 2).mean()) + 1e-30)


# (volumes, scale, block, local): 32^3 (nz = 40 not a multiple of bz), the
# fused stripe route at 16^3 under the local RMS, the stripe route at 8^3,
# and raw-fallback blocks at 16^3 with nz = 40 not a multiple of 16
CASES = {
    "32c_global": (lambda: _vols(3, (40, 24, 36)), 1e-2, (32, 32, 32), False),
    "16c_local": (lambda: _vols(3, (24, 16, 32)), 1e-2, (16, 16, 16), True),
    "8c_global": (lambda: _vols(3), 1e-2, (8, 8, 8), False),
    "raw_16c": (_raw_vols, 1e-8, (16, 16, 16), False),
}


@pytest.fixture(scope="module")
def singles():
    """Each case's volumes and their single compress -> decompress."""
    out = {}
    for name, (make, scale, block, local) in CASES.items():
        vols = make()
        datas = [cvt.compress(v, scale, block, local, device="cpu") for v in vols]
        outs = [cvt.decompress(d, device="cpu", engine="device") for d, _ in datas]
        out[name] = (vols, datas, outs)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_compress_many_equals_single(case, singles):
    """Numpy volumes and CPU tensors: byte-equal containers, equal ratios."""
    _, scale, block, local = CASES[case]
    vols, datas, _ = singles[case]
    for inputs in (vols, [torch.from_numpy(v) for v in vols]):
        got = codec.compress_many(inputs, scale, block, local, device="cpu" if
                                  inputs is vols else None)
        assert len(got) == len(datas)
        for (d1, r1), (d2, r2) in zip(datas, got):
            np.testing.assert_array_equal(d1, d2)
            assert r1 == r2
    if case == "raw_16c":
        _, blkoffs, _, _ = ctn.unpack(datas[0][0])
        assert (blkoffs < 0).any() and not (blkoffs < 0).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_decompress_many_equals_single(case, singles):
    """Host arrays (one copy for the batch) and tensors, bit-equal to the
    single device-engine decompress."""
    _, datas, outs = singles[case]
    ds = [d for d, _ in datas]
    host = codec.decompress_many(ds, "cpu", to_host=True)
    assert all(isinstance(h, np.ndarray) for h in host)
    dev = codec.decompress_many(ds, "cpu", to_host=False)
    assert all(isinstance(t, torch.Tensor) for t in dev)
    for o, h, t in zip(outs, host, dev):
        np.testing.assert_array_equal(bits(h), bits(o))
        np.testing.assert_array_equal(bits(t), bits(o))


def test_glob_mulfacs_override(singles):
    """glob_mulfacs overrides the header mulfac: the volume's own gives the
    plain container, another value lands in the header, and the JAX
    package's compress_many with the same override gives the same
    quantized values (its container decodes equal to the port's)."""
    vols, datas, _ = singles["8c_global"]
    own = [quant.global_mulfac(v, 1e-2) for v in vols]
    got = codec.compress_many(vols, 1e-2, (8, 8, 8), glob_mulfacs=own, device="cpu")
    for (d1, _), (d2, _) in zip(datas, got):
        np.testing.assert_array_equal(d1, d2)
    half = [F32(m * 0.5) for m in own]
    got = pipeline.compress_batched(vols[:2], 1e-2, (8, 8, 8), glob_mulfacs=half[:2],
                                    device="cpu")
    ref = [d for d, _ in jcodec.compress_many(vols[:2], 1e-2, (8, 8, 8),
                                              glob_mulfacs=half[:2])]
    for d, r, m in zip(got, ref, half):
        assert ctn.unpack(d)[0].glob_mulfac == m
        a = cvt.decompress(d, device="cpu").numpy()
        b = cvt.decompress(r, device="cpu").numpy()
        assert rel_rms(a, b) < TRANSFORM_TOL
    with pytest.raises(ValueError):
        codec.compress_many(vols, 1e-2, (8, 8, 8), glob_mulfacs=half[:2], device="cpu")


def test_jax_batched_interop(singles):
    """The port decodes JAX compress_many containers, and JAX's
    decompress_many the port's, within the transform tolerance."""
    vols, datas, outs = singles["8c_global"]
    jdatas = [d for d, _ in jcodec.compress_many(vols, 1e-2, (8, 8, 8))]
    for v, jd, o, po in zip(vols, jdatas, codec.decompress_many(jdatas, "cpu"), outs):
        assert rel_rms(o, cvt.decompress(jd, device="cpu").numpy()) == 0.0
        assert abs(rel_rms(o, v) - rel_rms(po, v)) < 0.01 * rel_rms(po, v)
    jouts = jcodec.decompress_many([d for d, _ in datas])
    for jo, o in zip(jouts, outs):
        assert rel_rms(jo, o) < TRANSFORM_TOL


def test_mixed_geometry_falls_back():
    v1 = _vols(1, (16, 16, 16))[0]
    v2 = _vols(1, (24, 16, 16))[0]
    d1, _ = cvt.compress(v1, 1e-2, (8, 8, 8), device="cpu")
    d2, _ = cvt.compress(v2, 1e-2, (8, 8, 8), device="cpu")
    assert codec.decompress_many([d1, d2], "cpu") is None
    for to_host in (True, False):
        outs = pipeline.decompress_batched([d1, d2], to_host=to_host, device="cpu")
        np.testing.assert_array_equal(bits(outs[0]), bits(cvt.decompress(d1, device="cpu")))
        np.testing.assert_array_equal(bits(outs[1]), bits(cvt.decompress(d2, device="cpu")))
        outs = list(pipeline.decompress_stream_batched([d1, d2, d1], batch=2,
                                                       to_host=to_host, device="cpu"))
        assert len(outs) == 3
        np.testing.assert_array_equal(bits(outs[2]), bits(outs[0]))
        np.testing.assert_array_equal(bits(outs[1]), bits(cvt.decompress(d2, device="cpu")))


def test_edge_cases():
    assert codec.compress_many([], 1e-2, device="cpu") == []
    assert codec.decompress_many([], "cpu") == []
    assert list(pipeline.compress_stream_batched([], 1e-2, device="cpu")) == []
    assert list(pipeline.decompress_stream_batched([], device="cpu")) == []
    v = _vols(1)[0]
    (d1, r1), = codec.compress_many([v], 1e-2, (8, 8, 8), device="cpu")
    d2, r2 = cvt.compress(v, 1e-2, (8, 8, 8), device="cpu")
    np.testing.assert_array_equal(d1, d2)
    out, = codec.decompress_many([d1], "cpu")
    np.testing.assert_array_equal(bits(out), bits(cvt.decompress(d1, device="cpu",
                                                                 engine="device")))
    with pytest.raises(ValueError):  # a garbage container is rejected, as single
        codec.decompress_many([d1, np.arange(64, dtype=np.uint8)], "cpu")
    if not torch.cuda.is_available():  # no card: the default raises, no fallback
        with pytest.raises(RuntimeError):
            codec.compress_many([v], 1e-2)
        with pytest.raises(RuntimeError):
            codec.decompress_many([d1])


@pytest.mark.parametrize("case", ["32c_global", "16c_local", "raw_16c"])
def test_streams_equal_single(case, singles):
    """compress_stream and compress_stream_batched (numpy and tensor
    inputs) give the single containers in order; decompress_stream and
    decompress_stream_batched the single volumes, bit for bit."""
    _, scale, block, local = CASES[case]
    vols, datas, outs = singles[case]
    k = len(vols)
    runs = [
        pipeline.compress_stream(iter(vols), scale, block, local, workers=2,
                                 device="cpu"),
        pipeline.compress_stream((torch.from_numpy(v) for v in vols), scale, block,
                                 local, workers=3),
        pipeline.compress_stream_batched(iter(vols), scale, block, local, batch=2,
                                         device="cpu"),
        pipeline.compress_stream_batched((torch.from_numpy(v) for v in vols), scale,
                                         block, local, batch=2, lookahead=0),
    ]
    for run in runs:
        got = list(run)
        assert len(got) == k
        for (d1, r1), (d2, r2) in zip(datas, got):
            np.testing.assert_array_equal(d1, d2)
            assert r1 == r2
    ds = [d for d, _ in datas]
    assert pipeline.compress_batched(vols, scale, block, local, device="cpu")[0].size \
        == ds[0].size
    for run in (pipeline.decompress_stream(iter(ds), workers=2, device="cpu",
                                           engine="device"),
                pipeline.decompress_stream_batched(iter(ds), batch=2, device="cpu"),
                pipeline.decompress_stream_batched(iter(ds), batch=2, to_host=False,
                                                   lookahead=2, device="cpu")):
        got = list(run)
        assert len(got) == k
        for o, g in zip(outs, got):
            np.testing.assert_array_equal(bits(g), bits(o))


def test_streams_bounded_in_flight():
    """The streams pull their input lazily: compress_stream holds at most
    workers+1 volumes, compress_stream_batched (lookahead + 1) batches."""
    pulled = []

    def gen(n):
        for s in range(n):
            pulled.append(s)
            yield make_radial_volume(16, 16, 32, seed=s)

    it = pipeline.compress_stream(gen(8), 1e-2, block=(16, 16, 16), workers=2,
                                  device="cpu")
    assert next(it)[0].size > 0
    assert len(pulled) <= 4  # window workers+1 = 3, and the next one
    assert len(list(it)) == 7 and len(pulled) == 8

    pulled.clear()
    it = pipeline.compress_stream_batched(gen(9), 1e-2, block=(16, 16, 16),
                                          batch=2, lookahead=1, device="cpu")
    assert next(it)[0].size > 0
    assert len(pulled) == 4  # batches 0 and 1 staged before batch 0 finished
    assert len(list(it)) == 8 and len(pulled) == 9

    pulled.clear()
    datas = [cvt.compress(v, 1e-2, (16, 16, 16), device="cpu")[0] for v in gen(6)]
    pulled.clear()

    def containers():
        for i, d in enumerate(datas):
            pulled.append(i)
            yield d

    it = pipeline.decompress_stream_batched(containers(), batch=2, lookahead=1,
                                            device="cpu")
    next(it)
    assert len(pulled) == 4
    assert len(list(it)) == 5


def test_kernel_signatures_match_the_launchers():
    """Every launcher's ctypes signature lists all its C parameters, the
    stream included: one left out passes as a C int, which truncates a
    non-default stream's handle (the streams here launch on such
    streams)."""
    import glob
    import os
    import re

    from cvxcompress_tpu_torch.ops import _kernels

    seen = set()
    for path in glob.glob(os.path.join(_kernels.SRC_DIR, "*.cu")):
        for m in re.finditer(r'extern "C" int (cvx_\w+)\(([^)]*)\)', open(path).read()):
            name, params = m.group(1), [p for p in m.group(2).split(",") if p.strip()]
            if name == "cvx_cuda_error_string":
                continue
            assert "stream" in params[-1], (name, params[-1])
            assert len(_kernels._SIGNATURES[name]) == len(params), name
            seen.add(name)
    assert seen == set(_kernels._SIGNATURES)
