"""The port's DeviceSnapshotStack on the CPU (the plain versions): its
scaled integers are the port codec's quantized values exactly, its
containers are the codec's, `get` equals the device-engine decompress of
its container bit for bit, and against the JAX package's stack it is
within one quantization step (the JAX stack's mulfac is an f32 sum)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
torch.set_num_threads(1)  # one thread a process: the suite runs in parallel workers

import cvxcompress_tpu_torch as cvt
from cvxcompress_tpu.snapshots import DeviceSnapshotStack as JaxStack
from cvxcompress_tpu_torch import container as ctn
from cvxcompress_tpu_torch import snapshots
from cvxcompress_tpu_torch.ops import rle_host
from cvxcompress_tpu_torch.snapshots import DeviceSnapshotStack

from conftest import make_radial_volume, make_sinusoid_volume, rel_error_and_snr

F32 = np.float32


def bits(t):
    return np.asarray(t).view(np.uint32)


def codec_integers(data):
    """The quantized values a container's tokens carry: its payloads decoded
    at mulfac 1.0 (float(iv), and the VLESC4 floats verbatim)."""
    hdr, blkoffs, _, pbase = ctn.unpack(data)
    payload = np.frombuffer(memoryview(data), dtype=np.uint8)[pbase:]
    return rle_host.decode_payloads(payload, blkoffs, F32(1.0), hdr.bx * hdr.by * hdr.bz)


def stack_of(vols, block, scale=1e-2, **kw):
    st = DeviceSnapshotStack(vols[0].shape, scale, block, device="cpu", **kw)
    for v in vols:
        st.append(torch.from_numpy(v))
    return st


# one block of each representation and route: 32^3 (chunk rows + invmap,
# `fused_encode`), 16^3 (`stripe_fused_encode`), 8^3 and (128, 8, 8) (the
# stripe route's transform), all on unaligned volumes (edge blocks)
BLOCKS = {
    "32c": ((32, 32, 32), (40, 34, 48)),
    "16c": ((16, 16, 16), (24, 20, 40)),
    "8c": ((8, 8, 8), (12, 20, 18)),
    "128x8x8": ((128, 8, 8), (16, 8, 130)),
}


@pytest.fixture(scope="module")
def stacks():
    out = {}
    for name, (block, shape) in BLOCKS.items():
        vols = [make_radial_volume(*shape, seed=s) for s in range(2)]
        datas = [cvt.compress(torch.from_numpy(v), 1e-2, block)[0] for v in vols]
        out[name] = (vols, datas, stack_of(vols, block))
    return out


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_dense_fiv_is_the_codecs_quantization(name, stacks):
    """dense_fiv equals the codec's quantized values exactly; to_container
    is the codec's container byte for byte (no raw blocks here)."""
    vols, datas, st = stacks[name]
    for i, d in enumerate(datas):
        np.testing.assert_array_equal(bits(st.dense_fiv(i)), bits(codec_integers(d)))
        np.testing.assert_array_equal(st.to_container(i), d)


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_get_equals_device_decompress(name, stacks):
    """get(i) is the device engine's decompress of to_container(i), bit for
    bit, and within the codec's quality of the volume."""
    vols, _, st = stacks[name]
    for i, v in enumerate(vols):
        out = st.get(i)
        ref = cvt.decompress(st.to_container(i), device="cpu", engine="device")
        np.testing.assert_array_equal(bits(out), bits(ref))
        err, _ = rel_error_and_snr(v, out.numpy())
        assert err < 2e-2, err
    held = sum(4 * (rows.numel() + index.numel()) for rows, index, _, _ in st._snaps)
    assert st.nbytes() == held
    assert st.ratio() == len(vols) * np.prod(st.vol_shape) * 4 / held


def test_stack_at_128c():
    """The 128^3 route (`block_encode`): the same three equalities."""
    v = make_sinusoid_volume(128, 128, 128, periods=3)
    v[40:60, 50:90, 10:100] += 0.1
    d = cvt.compress(torch.from_numpy(v), 1e-2, (128, 128, 128))[0]
    st = stack_of([v], (128, 128, 128))
    np.testing.assert_array_equal(bits(st.dense_fiv(0)), bits(codec_integers(d)))
    np.testing.assert_array_equal(st.to_container(0), d)
    np.testing.assert_array_equal(
        bits(st.get(0)), bits(cvt.decompress(d, device="cpu", engine="device")))
    assert st.ratio() > 10


@pytest.mark.parametrize("block", [(16, 16, 16), (32, 32, 32)])
def test_within_one_step_of_jax_stack(block):
    """Against the JAX stack on the same volume: its f32 mulfac may differ
    from the port's f64 one by ~1 ulp, so the scaled integers may differ,
    but by one quantization step at most."""
    vol = make_radial_volume(32, 32, 32)
    j = JaxStack(vol.shape, 1e-2, block=block)
    j.append(vol)
    st = stack_of([vol], block)
    assert np.abs(st.dense_fiv(0) - j.dense_fiv(0)).max() <= 1.0


def test_from_container_roundtrip(stacks):
    """from_container of a codec container: get equals the device-engine
    decompress bit for bit; a stack -> container -> stack chain is exact."""
    vols, datas, _ = stacks["32c"]
    st = DeviceSnapshotStack(vols[0].shape, 1e-2, device="cpu")
    i = st.from_container(datas[0])
    np.testing.assert_array_equal(
        bits(st.get(i)), bits(cvt.decompress(datas[0], device="cpu", engine="device")))
    np.testing.assert_array_equal(st.to_container(i), datas[0])
    _, _, s1 = stacks["16c"]
    s2 = DeviceSnapshotStack(s1.vol_shape, 1e-2, s1.block, device="cpu")
    s2.from_container(s1.to_container(1))
    np.testing.assert_array_equal(bits(s2.get(0)), bits(s1.get(1)))
    with pytest.raises(ValueError):  # another block
        DeviceSnapshotStack(vols[0].shape, 1e-2, (16, 16, 16),
                            device="cpu").from_container(datas[0])
    local = cvt.compress(vols[0], 1e-2, use_local_rms=True, device="cpu")[0]
    with pytest.raises(ValueError):  # local RMS
        st.from_container(local)


def test_from_container_raw_blocks():
    """Raw-fallback blocks store dequantized values: from_container scales
    them back, so their reconstruction is the decompress's to one f32
    rounding."""
    vol = make_radial_volume(nz=32, ny=16, nx=16)
    vol[:16] = (np.random.default_rng(2).standard_normal((16, 16, 16)) * 1e10
                ).astype(F32)
    data, _ = cvt.compress(vol, 1e-8, block=(16, 16, 16), device="cpu")
    _, blkoffs, _, _ = ctn.unpack(data)
    assert (blkoffs < 0).any() and not (blkoffs < 0).all()
    ref = cvt.decompress(data, device="cpu", engine="device").numpy()
    st = DeviceSnapshotStack(vol.shape, 1e-8, (16, 16, 16), device="cpu")
    snap = st.get(st.from_container(data)).numpy()
    denom = np.abs(ref) + np.sqrt(np.mean(ref.astype(np.float64) ** 2))
    assert (np.abs(snap - ref) / denom).max() < 1e-5
    # appended, the raw blocks' container round-trips through get exactly
    st.append(vol)
    c = st.to_container(1)
    assert (ctn.unpack(c)[1] < 0).any()
    np.testing.assert_array_equal(
        bits(st.get(1)), bits(cvt.decompress(c, device="cpu", engine="device")))


def test_oracle_encoder_fallback(stacks, monkeypatch):
    """Without the native library the container comes from the oracle's
    encoder, byte-equal to the native one's."""
    vols, datas, st = stacks["8c"]

    def no_native(*a, **k):
        raise RuntimeError("no native library")

    monkeypatch.setattr(rle_host, "encode_payloads", no_native)
    np.testing.assert_array_equal(st.to_container(0), datas[0])


def test_lifo_pop_and_zero_snapshot():
    """pop returns the snapshots in reverse order, each equal to its get; an
    all-zero snapshot reconstructs zeros."""
    shape = (32, 32, 48)
    vols = [make_radial_volume(*shape, seed=s) for s in range(3)]
    vols.insert(1, np.zeros(shape, F32))
    st = stack_of(vols, (32, 32, 32))
    refs = [st.get(i).clone() for i in range(len(vols))]
    for i in reversed(range(len(vols))):
        np.testing.assert_array_equal(bits(st.pop()), bits(refs[i]))
        assert len(st) == i
    assert not refs[1].any()
    zero = stack_of([np.zeros(shape, F32)], (16, 16, 16))
    assert not zero.get(0).any() and zero._snaps[0][3] == 0


def test_pending_bounded():
    """Appends keep at most max_pending dense volumes for their checks."""
    shape = (16, 16, 32)
    st = DeviceSnapshotStack(shape, 1e-2, (16, 16, 16), max_pending=2, device="cpu")
    for s in range(6):
        st.append(make_radial_volume(*shape, seed=s))
        assert len(st._pending) <= 2
    st.flush()
    assert not st._pending
    assert all(snap[3] is not None for snap in st._snaps)


@pytest.mark.parametrize("block", [(32, 32, 32), (16, 16, 16)])
def test_capacity_overflow_retry(block):
    """A snapshot with more live chunks than the capacity its append
    assumed is compacted again at its check: its reconstruction equals a
    fresh stack's."""
    shape = (32, 32, 64)
    sparse = np.zeros(shape, F32)
    sparse[0, 0, 0] = 1.0
    dense = make_radial_volume(*shape)
    st = stack_of([sparse, dense], block, max_pending=1)
    st.flush()
    assert st._cap > 1
    assert st._snaps[1][0].shape[0] >= st._snaps[1][3] > 1
    ref = stack_of([dense], block)
    np.testing.assert_array_equal(bits(st.get(1)), bits(ref.get(0)))
    out0 = st.get(0).numpy()
    assert abs(out0[0, 0, 0] - 1.0) < 1e-2 and np.abs(out0.ravel()[1:]).max() < 1e-2


def test_checks():
    with pytest.raises(ValueError):
        DeviceSnapshotStack((16, 16, 16), 1e-2, (12, 16, 16), device="cpu")
    st = DeviceSnapshotStack((16, 16, 16), 1e-2, (8, 8, 8), device="cpu")
    with pytest.raises(ValueError):
        st.append(np.zeros((16, 16, 17), F32))
    if not torch.cuda.is_available():  # no card: the default raises
        with pytest.raises(RuntimeError):
            DeviceSnapshotStack((16, 16, 16), 1e-2)
    assert snapshots._bucket(0) == 1 and snapshots._bucket(5) == 8
    assert snapshots._bucket(8) == 8
