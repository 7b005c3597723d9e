"""The port's API surface beside the codec: the backend switch (the oracle
copy and the native library), `to_bytes`, `Run_Module_Tests`, the IO
helpers and the synthetic volumes, each against the JAX package's
original; and the bench's quick shape through the codec at its bars."""

import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
torch.set_num_threads(1)  # one thread a process: the suite runs in parallel workers

import cvxcompress_tpu_torch as cvt
from cvxcompress_tpu import container as jctn
from cvxcompress_tpu.oracle import codec as jocodec
from cvxcompress_tpu.oracle import rle as jorle
from cvxcompress_tpu.oracle import wavelet as jowav
from cvxcompress_tpu.utils import io as jio
from cvxcompress_tpu.utils import volumes as jvolumes
from cvxcompress_tpu_torch import api, module_tests
from cvxcompress_tpu_torch import container as ctn
from cvxcompress_tpu_torch.oracle import rle as orle
from cvxcompress_tpu_torch.oracle import wavelet as owav
from cvxcompress_tpu_torch.ops import rle_host
from cvxcompress_tpu_torch.utils import io, volumes

from conftest import make_radial_volume, rel_error_and_snr


def _raw_mix():
    """Half the volume huge noise (raw-fallback blocks), half smooth."""
    vol = make_radial_volume(nz=32, ny=16, nx=16)
    vol[:16] = (np.random.default_rng(3).standard_normal((16, 16, 16)) * 1e10
                ).astype(np.float32)
    return vol


# (volume, scale, block, local): 32^3 global and local on an unaligned
# radial volume (edge blocks), and one with raw-fallback blocks
ORACLE_CASES = {
    "32c_global": (lambda: make_radial_volume(40, 34, 48), 1e-2, (32, 32, 32), False),
    "32c_local": (lambda: make_radial_volume(40, 34, 48), 1e-2, (32, 32, 32), True),
    "16c_raw": (_raw_mix, 1e-8, (16, 16, 16), False),
}


@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
def test_oracle_backend_byte_equal_to_jax_oracle(case):
    """backend="oracle" runs the port's numpy copy of the oracle: its
    container is byte-equal to the JAX package's oracle, and so is its
    decompress."""
    make, scale, block, local = ORACLE_CASES[case]
    vol = make()
    data, ratio = cvt.compress(vol, scale, block=block, use_local_rms=local,
                               backend="oracle")
    ref, ref_ratio = jocodec.compress(vol, scale, block=block, use_local_rms=local)
    np.testing.assert_array_equal(data, ref)
    assert ratio == ref_ratio
    if case == "16c_raw":
        _, blkoffs, _, _ = ctn.unpack(data)
        assert (blkoffs < 0).any() and not (blkoffs < 0).all()
    out = cvt.decompress(data, backend="oracle")
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out.view(np.uint32),
                                  jocodec.decompress(ref).view(np.uint32))


def test_oracle_pieces_equal_jax_oracle():
    """The copied rle and wavelet modules compute what the originals do."""
    rng = np.random.default_rng(5)
    vals = (rng.standard_normal(4096) * np.logspace(-3, 9, 4096)).astype(np.float32)
    vals[100:900] = 0.0
    vals[7] = np.nan
    for mulfac in (np.float32(0.7), np.float32(1e3)):
        p = orle.encode(mulfac, vals)
        assert p == jorle.encode(mulfac, vals)
        got, n = orle.decode(mulfac, np.frombuffer(p, np.uint8), vals.size)
        ref, m = jorle.decode(mulfac, np.frombuffer(p, np.uint8), vals.size)
        assert n == m
        np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    blk = rng.standard_normal((8, 16, 32)).astype(np.float32)
    fwd = owav.forward_3d(blk)
    np.testing.assert_array_equal(fwd.view(np.uint32), jowav.forward_3d(blk).view(np.uint32))
    np.testing.assert_array_equal(owav.inverse_3d(fwd).view(np.uint32),
                                  jowav.inverse_3d(fwd).view(np.uint32))


def test_container_pack_equals_jax():
    """`container.pack` (per-block payloads) writes the JAX package's bytes."""
    hdr = ctn.Header(40, 34, 24, 16, 16, 8, np.float32(0.25), True)
    nnn = hdr.grid[3]
    rng = np.random.default_rng(1)
    payloads = [rng.integers(0, 256, int(rng.integers(1, 40)), dtype=np.uint8).tobytes()
                for _ in range(nnn)]
    raw = rng.random(nnn) < 0.2
    mf = rng.random(nnn).astype(np.float32)
    jhdr = jctn.Header(40, 34, 24, 16, 16, 8, np.float32(0.25), True)
    np.testing.assert_array_equal(ctn.pack(hdr, payloads, raw, mf),
                                  jctn.pack(jhdr, payloads, raw, mf))
    with pytest.raises(ValueError):
        ctn.pack(hdr, payloads[:-1], raw, mf)


@pytest.mark.parametrize("local", [False, True])
def test_native_backend_is_host_compress(local):
    """backend="native" is the native library's codec, both ways."""
    vol = make_radial_volume(24, 40, 48)
    data, ratio = cvt.compress(vol, 1e-2, use_local_rms=local, backend="native")
    ref, ref_ratio = rle_host.host_compress(vol, 1e-2, use_local_rms=local)
    np.testing.assert_array_equal(data, ref)
    assert ratio == ref_ratio
    # a tensor goes to the host first
    np.testing.assert_array_equal(
        cvt.compress(torch.from_numpy(vol), 1e-2, use_local_rms=local,
                     backend="native")[0], ref)
    out = cvt.decompress(data, backend="native")
    np.testing.assert_array_equal(out, rle_host.host_decompress(data))
    # the native container decodes in the port's codec too
    err, _ = rel_error_and_snr(out, cvt.decompress(data, device="cpu").numpy())
    assert err < 1e-5


def test_unknown_backend_raises():
    vol = np.ones((8, 8, 8), np.float32)
    with pytest.raises(ValueError, match="backend"):
        cvt.compress(vol, 1e-2, backend="jax")
    with pytest.raises(ValueError, match="backend"):
        cvt.decompress(np.zeros(64, np.uint8), backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        cvt.CvxCompress(backend="numpy")


@pytest.mark.parametrize("backend", ["torch", "native", "oracle"])
def test_class_surface_per_backend(backend):
    """CvxCompress(backend=...): Compress, Decompress and
    Decompress_Inplace into a numpy array and into a tensor."""
    vol = make_radial_volume(16, 24, 40)
    c = cvt.CvxCompress(device="cpu", backend=backend)
    data, ratio = c.Compress(1e-2, vol, 16, 8, 16)
    assert ratio > 1
    out = c.Decompress(data)
    assert isinstance(out, torch.Tensor if backend == "torch" else np.ndarray)
    err, _ = rel_error_and_snr(vol, np.asarray(out))
    assert err < 5e-3
    arr = np.empty_like(vol)
    c.Decompress_Inplace(arr, data)
    np.testing.assert_array_equal(arr, np.asarray(out))
    t = torch.empty(vol.shape)
    c.Decompress_Inplace(t, data)
    np.testing.assert_array_equal(t.numpy(), np.asarray(out))
    with pytest.raises(ValueError):
        c.Decompress_Inplace(np.empty((16, 24, 41), np.float32), data)


def test_to_bytes_and_io_roundtrip(tmp_path):
    """to_bytes, save/load/probe round-trip; probe equals the JAX probe."""
    vol = make_radial_volume(20, 30, 40)
    data, ratio = cvt.compress(vol, 1e-2, block=(16, 16, 16), device="cpu")
    b = cvt.to_bytes(data)
    assert isinstance(b, bytes) and b == data.tobytes()
    path = tmp_path / "snap.cvx"
    io.save(str(path), data)
    back = io.load(str(path))
    np.testing.assert_array_equal(back, data)
    info = io.probe(str(path))
    assert info == io.probe(data) == jio.probe(data)
    assert info["shape_zyx"] == (20, 30, 40) and info["block_xyz"] == (16, 16, 16)
    assert info["container_bytes"] == data.size
    assert abs(info["ratio"] - ratio) < 1e-9
    local, _ = cvt.compress(vol, 1e-2, use_local_rms=True, device="cpu")
    assert io.probe(local) == jio.probe(local)
    assert io.probe(local)["use_local_rms"]


def test_load_rejects_garbage(tmp_path):
    bad = tmp_path / "bad.cvx"
    np.arange(64, dtype=np.uint8).tofile(bad)
    with pytest.raises(ValueError):
        io.load(str(bad))
    data, _ = cvt.compress(make_radial_volume(16, 16, 16), 1e-2,
                           block=(8, 8, 8), device="cpu")
    cut = tmp_path / "cut.cvx"
    data[: data.size // 2].tofile(cut)
    with pytest.raises(ValueError):
        io.load(str(cut))


def test_volumes_equal_jax(tmp_path):
    """The copied generators make the JAX package's arrays; raw file IO."""
    pairs = [
        (volumes.radial_volume(9, 11, 13), jvolumes.radial_volume(9, 11, 13)),
        (volumes.radial_volume(9, 11, 13, noise=False, seed=2),
         jvolumes.radial_volume(9, 11, 13, noise=False, seed=2)),
        (volumes.sinusoid_volume(12, 5, 7, periods=3),
         jvolumes.sinusoid_volume(12, 5, 7, periods=3)),
        (volumes.pattern_volume(4, 5, 6, seed=9), jvolumes.pattern_volume(4, 5, 6, seed=9)),
        (volumes.empty_volume(3, 4, 5), jvolumes.empty_volume(3, 4, 5)),
    ]
    for a, b in pairs:
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    v = volumes.pattern_volume(4, 5, 6)
    path = str(tmp_path / "v.raw")
    volumes.write_raw(path, v)
    np.testing.assert_array_equal(volumes.read_raw(path, 4, 5, 6).view(np.uint32),
                                  v.view(np.uint32))
    np.testing.assert_array_equal(jvolumes.read_raw(path, 4, 5, 6), v)
    with pytest.raises(ValueError):
        volumes.read_raw(path, 4, 5, 7)


def test_run_module_tests(monkeypatch):
    """Run_Module_Tests runs pytest on the port's test files and reports its
    result; the exhaustive switch then runs the staged module tests
    (module_tests.run, stubbed here) on the given device and reports theirs."""
    calls, staged = [], []

    def fake(args):
        calls.append(args)
        return 0 if len(calls) in (1, 3, 4) else 1  # the second run fails

    def fake_run(device, exhaustive=False, quick=False):
        staged.append((device, exhaustive, quick))
        return [] if len(staged) == 1 else ["[11] 2^24 zero-run split (256^3 block)"]

    monkeypatch.setattr(subprocess, "call", fake)
    monkeypatch.setattr(module_tests, "run", fake_run)
    assert api.CvxCompress.Run_Module_Tests() is True
    assert api.CvxCompress.Run_Module_Tests(verbose=True) is False
    assert staged == []
    assert cvt.CvxCompress.Run_Module_Tests(exhaustive=True, device="cpu") is True
    assert staged == [("cpu", True, False)]
    assert cvt.CvxCompress.Run_Module_Tests(exhaustive=True) is False
    assert staged[1] == ("cuda", True, False)
    files = [a for a in calls[0] if a.endswith(".py")]
    assert files and all("test_torch_" in f for f in files)
    assert "-q" in calls[0] and "-v" in calls[1]


def test_quick_shape_bars():
    """The bench's quick shape, (160, 192, 160) at 32^3 and scale 1e-2,
    through compress -> decompress (both engines): its quick bars, err <
    4e-4 and SNR > 70 dB (bench.py:584, :616)."""
    vol = volumes.sinusoid_volume(160, 192, 160)
    data, ratio = cvt.compress(vol, 1e-2, device="cpu")
    out = cvt.decompress(data, device="cpu", engine="device").numpy()
    err, snr = rel_error_and_snr(vol, out)
    assert err < 4e-4 and snr > 70.0, (err, snr)
    assert ratio > 100
    np.testing.assert_array_equal(
        out.view(np.uint32),
        cvt.decompress(data, device="cpu", engine="host").numpy().view(np.uint32))
