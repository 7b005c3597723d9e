"""The stripe, patch and compact routes on native's parity cascade (the plain
versions of csrc/plane_cascade.cu): `forward_3d_volume_plain` bit-equal to
the block batch's `cascade_3d` and to a numpy transcription of native's
parity cascade, with partial edge blocks; the CPU compress on the three
routes giving `cvx_compress_parity_th`'s container under the global RMS, and
the CPU decompress `cvx_decompress_inplace_parity_th`'s volume, at the
stripe route's geometries and on the inputs where the dense products spread
a non-finite cell (NaN, inf, 3e38); a sharded stripe-route compress
byte-equal to the single call.  No JAX call."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
torch.set_num_threads(1)  # one thread a process: the suite runs in parallel workers

import cvxcompress_tpu_torch as cvt
from cvxcompress_tpu_torch import container as ctn
from cvxcompress_tpu_torch.ops import blocks, codec, rle_host, wavelet
from cvxcompress_tpu_torch.parallel import mesh, sharded
from cvxcompress_tpu_torch.parallel import compress as pcompress

from test_torch_block32 import np_cascade_3d

F32 = np.float32
SCALE = 1e-2


def field(shape, seed=None):
    """sin(0.7 z) + cos(0.3 y) sin(0.11 x), plus N(0, 1e-2) noise from
    `seed` when one is given: coefficients whose last bits depend on the
    operation order, and every token class."""
    nz, ny, nx = shape
    z, y, x = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij")
    v = (np.sin(0.7 * z) + np.cos(0.3 * y) * np.sin(0.11 * x)).astype(F32)
    if seed is not None:
        v += np.random.default_rng(seed).standard_normal(shape).astype(F32) * F32(1e-2)
    return v


# block -> a volume with a partial edge block on every axis (bz = 1: none)
TRANSFORM_CASES = [
    ((8, 8, 8), (13, 21, 30)),
    ((64, 64, 64), (70, 40, 90)),
    ((128, 8, 8), (12, 20, 150)),
    ((8, 8, 1), (3, 21, 30)),
    ((8, 8, 256), (260, 12, 10)),
    ((256, 8, 16), (20, 12, 260)),
]


@pytest.mark.parametrize("block,shape", TRANSFORM_CASES,
                         ids=lambda v: "x".join(map(str, v)))
def test_forward_plain_is_block_cascade(block, shape):
    """The plane is `cascade_3d` of the zero-padded blocks, each at its
    place, and that is native's x, y, z parity cascade, bit for bit; the
    CPU entry points are the plain versions."""
    vol = torch.from_numpy(field(shape, sum(block)))
    plane = wavelet.forward_3d_volume_plain(vol, block)
    batch = blocks.to_blocks(vol, block)
    want = wavelet.cascade_3d(batch, inverse=False)
    got = blocks.to_blocks(plane, block)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    nat = np_cascade_3d(batch.numpy(), inverse=False)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), nat.view(np.uint32))
    assert torch.equal(wavelet.forward_3d_volume(vol, block), plane)
    assert torch.equal(wavelet.forward_blocks(batch), want)
    inv = wavelet.inverse_blocks(want)
    nat_inv = np_cascade_3d(want.numpy(), inverse=True)
    np.testing.assert_array_equal(inv.numpy().view(np.uint32), nat_inv.view(np.uint32))


def fault8(name):
    """The inputs where the dense products spread a non-finite cell over
    its line, or overflow: (volume, block)."""
    shape, block = ((8, 8, 128), (128, 8, 8)) if name == "nan_128x8x8" else \
        ((8, 8, 8), (8, 8, 8))
    v = field(shape)
    if name == "big_8c":
        v[4, 4, 4] = F32(3e38)
    else:
        v[0, 3, 4] = np.inf if name == "inf_8c" else np.nan
    return v, block


def assert_native_parity(vol, block, route, engines=("device",)):
    """The CPU compress on `route` gives native's parity container, and the
    CPU `engines` decode it to native's parity volume, bit for bit (NaN
    payloads too)."""
    assert codec.encode_route(vol.shape, block, False) == route
    data, _ = cvt.compress(vol, SCALE, block=block, device="cpu")
    want, _ = rle_host.host_compress_parity(vol, SCALE, block=block)
    np.testing.assert_array_equal(np.asarray(data), want)
    vref = rle_host.host_decompress_parity(want).view(np.uint32)
    for engine in engines:
        out = cvt.decompress(data, device="cpu", engine=engine).numpy()
        np.testing.assert_array_equal(out.view(np.uint32), vref)
    return data


@pytest.mark.parametrize("name", ["nan_8c", "inf_8c", "big_8c", "nan_128x8x8"])
def test_fault8_inputs_give_native_parity(name):
    """A NaN, an inf or a 3e38 cell reaches only its cascade's taps: the
    block is coded as native codes it (the dense products sent it raw, or
    overflowed), the container and the volume native's parity ones."""
    vol, block = fault8(name)
    data = assert_native_parity(vol, block, "stripe", ("device", "host"))
    if name != "big_8c":
        assert not (ctn.unpack(data)[1] < 0).any()  # no raw block


# name -> (block, volume shape, routes): stripe at every geometry; the
# patch route where `geometry.patch_ok`, compact where `compact_ok`
GEOMS = {
    "8c": ((8, 8, 8), (40, 50, 70), ("stripe",)),
    "8c_compact": ((8, 8, 8), (48, 64, 96), ("stripe", "compact")),
    "64c": ((64, 64, 64), (40, 40, 200), ("stripe", "patch", "compact")),
    "256c": ((256, 256, 256), (20, 30, 40), ("stripe",)),
    "128x8x8": ((128, 8, 8), (20, 40, 300), ("stripe",)),
    "8x8x1": ((8, 8, 1), (5, 50, 70), ("stripe",)),
    "128c_unaligned": ((128, 128, 128), (130, 40, 60), ("stripe",)),
    "32c_patch": ((32, 32, 32), (40, 50, 70), ("patch",)),
}
ROUTE_ENV = {"stripe": {}, "patch": {"CVX_STRIPE": "patch"},
             "compact": {"CVX_FUSED_COMPACT": "1"}}


@pytest.mark.parametrize("name,route", [(n, r) for n, g in GEOMS.items() for r in g[2]])
def test_routes_give_native_parity(monkeypatch, name, route):
    """Global RMS: the stripe, patch and compact routes' CPU compress gives
    `cvx_compress_parity_th`'s container, and the decompress
    `cvx_decompress_inplace_parity_th`'s volume."""
    for k in ("CVX_STRIPE", "CVX_FUSED_COMPACT", "CVX_FUSED_W"):
        monkeypatch.delenv(k, raising=False)
    for k, v in ROUTE_ENV[route].items():
        monkeypatch.setenv(k, v)
    block, shape, _ = GEOMS[name]
    assert_native_parity(field(shape, sum(shape)), block, route)


def test_local_rms_parity_where_tables_agree():
    """Local RMS at 8^3: where the block tables are bit-equal to native's
    (its f32 lane sums against the port's f64 sum), so is the payload of
    every such block; the test asserts the tables first."""
    vol = field((40, 50, 70), 3)
    data, _ = cvt.compress(vol, SCALE, block=(8, 8, 8), use_local_rms=True, device="cpu")
    want, _ = rle_host.host_compress_parity(vol, SCALE, block=(8, 8, 8),
                                            use_local_rms=True)
    hd, offs, mf, pb = ctn.unpack(data)
    hw, woffs, wmf, wpb = ctn.unpack(want)
    same = mf.view(np.uint32) == wmf.view(np.uint32)
    assert same.mean() > 0.25  # the comparison has content
    cells = 8 * 8 * 8
    dense = rle_host.decode_payloads(data[pb:], offs, hd.glob_mulfac, cells, mf)
    wdense = rle_host.decode_payloads(want[wpb:], woffs, hw.glob_mulfac, cells, wmf)
    np.testing.assert_array_equal(dense[same].view(np.uint32),
                                  wdense[same].view(np.uint32))


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_stripe_compress_is_single(n):
    """A sharded stripe-route compress (slabs of whole block rows, each on
    the whole volume's route) is byte-equal to the single call, and so to
    native's parity container."""
    vol = field((40, 50, 70), 9)
    block = (8, 8, 8)
    single, _ = cvt.compress(vol, SCALE, block=block, device="cpu")
    got, _ = sharded.compress_sharded(vol, SCALE, block=block, num_shards=n, device="cpu")
    np.testing.assert_array_equal(got, single)
    got, _ = pcompress.compress(vol, SCALE, block=block,
                                mesh=mesh.make_mesh(["cpu"] * n))
    np.testing.assert_array_equal(got, single)


@pytest.mark.parametrize("route", ["stripe", "patch", "compact"])
def test_routes_make_no_einsum(monkeypatch, route):
    """The three routes' transforms are native's cascade: a compress and a
    decompress run with `torch.einsum` made to raise."""
    def no_einsum(*args, **kwargs):
        raise AssertionError("torch.einsum called")

    for k in ("CVX_STRIPE", "CVX_FUSED_COMPACT", "CVX_FUSED_W"):
        monkeypatch.delenv(k, raising=False)
    for k, v in ROUTE_ENV[route].items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch, "einsum", no_einsum)
    block, shape, _ = GEOMS["64c"]
    vol = field(shape, 4)
    assert codec.encode_route(shape, block, False) == route
    data, _ = cvt.compress(vol, SCALE, block=block, device="cpu")
    out = cvt.decompress(data, device="cpu").numpy()
    assert out.shape == shape and np.isfinite(out).all()
