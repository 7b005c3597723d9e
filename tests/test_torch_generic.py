"""The port's stripe route at the blocks where the JAX package tokenizes a
block-major relayout with K12 (bx >= 128 but aligned 128^3, and bx = by =
8; ops/geometry.py) on the CPU: `tokenize_stripe` (plain version, the K12
and K12' port there) bit-exact against JAX K12 in interpret mode (level 1),
the transforms within 1e-5 of the oracle (level 2), containers across the
oracle, JAX and native codecs, sizes and local tables (level 3), the raw
fallback and a NaN block."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
torch.set_num_threads(1)  # one thread a process: the suite runs in parallel workers

import jax.numpy as jnp

import cvxcompress_tpu_torch as cvt
from cvxcompress_tpu.ops import codec as jcodec
from cvxcompress_tpu.ops import rle_device as jrd
from cvxcompress_tpu.ops import tokenize_pallas as tp
from cvxcompress_tpu.oracle import codec as ocodec
from cvxcompress_tpu.oracle import wavelet as owav
from cvxcompress_tpu_torch import container as ctn
from cvxcompress_tpu_torch.ops import blocks, codec, geometry, rle_host, tokenize, wavelet

from conftest import make_sinusoid_volume, rel_error_and_snr

TRANSFORM_TOL = 1e-5
F32 = np.float32

# each geometry of the route at a volume with partial edge blocks
GEOMS = {
    "8c": ((8, 8, 8), (20, 36, 52)),
    "128x8x8": ((128, 8, 8), (20, 36, 200)),
    "8x8x1": ((8, 8, 1), (6, 36, 52)),
    "128c_unaligned": ((128, 128, 128), (96, 128, 136)),
}


def rel_rms(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.sqrt(((got - ref) ** 2).mean()) / (np.sqrt((ref**2).mean()) + 1e-30)


def test_every_geometry_takes_its_route():
    for block, shape in GEOMS.values():
        assert codec.route(shape, block) == "stripe"
    assert codec.route((128, 128, 256), (128, 128, 128)) == "block128"
    assert codec.route((20, 36, 52), (32, 32, 32)) == "fused32"
    assert codec.route((20, 36, 52), (16, 16, 16)) == "stripe_fused"


# -- level 1: tokenize_stripe against JAX K12 ----------------------------------


def as_plane(c, shape, block):
    """Block-major (n, cells) coefficients as the volume-order plane of a
    `shape` in whole `block` blocks."""
    bx, by, bz = block
    return blocks.from_blocks(torch.from_numpy(c).view(-1, bz, by, bx), shape, block)


def coefficients(case):
    """(coeffs (n, cells), mulfacs (n,), volume shape, block) of a tokenize
    case."""
    rng = np.random.default_rng(12)
    if case == "blocks512":  # 32 blocks of 8^3 per JAX tile; per-block tables
        c = (rng.standard_normal((64, 512)) * 50).astype(F32)
        c[rng.random(c.shape) < 0.8] = 0.0
        c[5] = 0.0  # a zero block: one run of 512
        return c, rng.uniform(0.5, 3.0, 64).astype(F32), (32, 32, 32), (8, 8, 8)
    if case == "classes":  # every token class, NaN and out-of-range values
        c = np.zeros((4, 512), F32)
        c[0, 0:8] = [1, -1, 124, -124, 2, 3, 4, 5]
        c[0, 8:16] = [200, -200, 300, -300, 1000, -1000, 32767, -32768]
        c[0, 16:24] = [1e5, -1e5, 8388607, -8388608, 7e4, -7e4, 99999, -99999]
        c[0, 24:32] = [1e9, 1, 2, 0, 0, 300, 70000, 5]
        c[1, 100] = np.nan
        c[1, 101] = 3e12
        c[2] = 1e12  # over 4 B a cell: raw
        c[3, 511] = 7.0
        return c, np.ones(4, F32), (8, 8, 32), (8, 8, 8)
    # "tile_carry": one 64^3 block = 2 JAX tiles and 16 port tiles; runs
    # that cross tiles of both, whole tiles without a non-zero cell
    c = np.zeros((2, 1 << 18), F32)
    c[0, 5] = 7.0
    c[0, 3 * 16384 - 1] = 2.0
    c[0, 131072 + 10] = -3.0
    c[0, 9 * 16384 + 1: 9 * 16384 + 300] = 1.5
    c[1, -1] = 1.0
    return c, np.array([1.0, 2.0], F32), (64, 64, 128), (64, 64, 64)


@pytest.mark.parametrize("case", ["blocks512", "classes", "tile_carry"])
def test_tokenize_chunks_matches_jax_k12(case):
    """Level 1: the port's tokenize, fed the same coefficients (as the
    volume-order plane) and table, gives JAX K12's descriptors (on the
    chunk-major relayout), chunk bytes, sizes and raw flags bit for bit (JAX
    fed fv = c * mulfac, the one f32 rounding of both)."""
    c, mf, shape, block = coefficients(case)
    n, cells = c.shape
    desc, cb, sizes, raw = tokenize.tokenize_stripe(as_plane(c, shape, block),
                                                    torch.from_numpy(mf), block)
    fv = (c * mf[:, None]).astype(F32)
    nchunks = n * cells // 128
    fvp = np.zeros((tp.pad_rows2(nchunks), 128), F32)
    fvp[:nchunks] = fv.reshape(nchunks, 128)
    jd, jcb, js, jr, _ = tp.tokenize_desc_fast2(jnp.asarray(fvp), n, cells // 128,
                                                128, interpret=True)
    np.testing.assert_array_equal(desc.numpy().reshape(nchunks, 128), np.asarray(jd))
    np.testing.assert_array_equal(cb.numpy(), np.asarray(jcb))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(js))
    np.testing.assert_array_equal(raw.numpy(), np.asarray(jr))
    if case == "classes":
        assert raw.tolist() == [False, False, True, False]


def test_tokenize_chunks_64_cell_blocks():
    """(8, 8, 1) blocks hold 64 cells in one 64-cell chunk; JAX K12 takes
    128-cell chunks only, so the reference is its XLA tokenize
    (`rle_device.tokenize_desc`, the JAX route at this geometry)."""
    rng = np.random.default_rng(64)
    c = (rng.standard_normal((40, 64)) * 30).astype(F32)
    c[rng.random(c.shape) < 0.6] = 0.0
    c[3] = 0.0
    c[7] = 1e12
    mf = rng.uniform(0.5, 2.0, 40).astype(F32)
    block = (8, 8, 1)
    desc, cb, sizes, raw = tokenize.tokenize_stripe(as_plane(c, (40, 8, 8), block),
                                                    torch.from_numpy(mf), block)
    fv = (c * mf[:, None]).astype(F32)
    jd, jcb, js, jr, _ = jrd.tokenize_desc(jrd.as_rows(jnp.asarray(fv)), 40, 64)
    np.testing.assert_array_equal(desc.numpy(), np.asarray(jd).reshape(40, 64))
    np.testing.assert_array_equal(cb.numpy(), np.asarray(jcb))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(js))
    np.testing.assert_array_equal(raw.numpy(), np.asarray(jr))
    assert bool(raw[7]) and cb.numel() == 40


# -- level 2: the transforms against the oracle ---------------------------------


@pytest.mark.parametrize("block", [(8, 8, 8), (256, 8, 16), (8, 8, 256), (64, 8, 1)],
                         ids=lambda b: "x".join(map(str, b)))
def test_transforms_match_oracle(block):
    """Level 2: `forward_3d_volume` and the decode's block inverse within
    1e-5 of the oracle's per-block cascades (f64), partial edge blocks
    zero-padded; 256 along x and along z, and bz == 1."""
    bx, by, bz = block
    shape = (max(bz + bz // 2, 1) if bz > 1 else 3, 2 * by - 3, bx + bx // 2)
    vol = np.random.default_rng(sum(block)).standard_normal(shape).astype(F32)
    plane = wavelet.forward_3d_volume(torch.from_numpy(vol), block)
    assert tuple(plane.shape) == geometry.plane_shape(shape, block)
    got = blocks.to_blocks(plane, block).numpy()
    padded = blocks.to_blocks(torch.from_numpy(vol), block).numpy().astype(np.float64)
    ref = np.stack([owav.forward_3d(b) for b in padded])
    assert rel_rms(got, ref) < TRANSFORM_TOL
    inv = blocks.from_blocks(wavelet.inverse_blocks(torch.from_numpy(ref.astype(F32))),
                             shape, block).numpy()
    oinv = blocks.from_blocks(torch.from_numpy(
        np.stack([owav.inverse_3d(b) for b in ref])), shape, block).numpy()
    assert rel_rms(inv, oinv) < TRANSFORM_TOL
    assert rel_rms(inv, vol) < TRANSFORM_TOL


# -- level 3: containers ------------------------------------------------------------


def geom_volume(name):
    block, shape = GEOMS[name]
    vol = make_sinusoid_volume(*shape, periods=3)
    vol += np.random.default_rng(3).standard_normal(shape).astype(F32) * 1e-3
    return block, vol


@pytest.fixture(scope="module")
def containers():
    """The port's global and local containers of each geometry (CPU)."""
    out = {}
    for name in GEOMS:
        block, vol = geom_volume(name)
        out[name] = {local: cvt.compress(vol, 1e-2, block=block, use_local_rms=local,
                                         device="cpu")[0]
                     for local in (False, True)}
    return out


@pytest.mark.parametrize("name", list(GEOMS))
@pytest.mark.parametrize("decoder", ["oracle", "jax", "native"])
def test_port_container_decodes_elsewhere(containers, name, decoder):
    block, vol = geom_volume(name)
    data = containers[name][False]
    mine = cvt.decompress(data, device="cpu", engine="device").numpy()
    np.testing.assert_array_equal(
        mine, cvt.decompress(data, device="cpu", engine="host").numpy())
    if decoder == "oracle":
        other = ocodec.decompress(data)
    elif decoder == "jax":
        other = jcodec.decompress(data)
    else:
        other = rle_host.host_decompress(data)
    assert other.shape == mine.shape == vol.shape
    assert rel_rms(mine, other) < TRANSFORM_TOL
    assert rel_error_and_snr(vol, mine)[0] < 2e-3


@pytest.mark.parametrize("name", list(GEOMS))
@pytest.mark.parametrize("producer", ["jax", "native"])
def test_port_decodes_foreign_containers(name, producer):
    block, vol = geom_volume(name)
    if producer == "jax":
        data, _ = jcodec.compress(vol, 1e-2, block=block)
        ref = jcodec.decompress(data)
    else:
        data, _ = rle_host.host_compress(vol, 1e-2, block=block)
        ref = rle_host.host_decompress(data)
    for engine in ("host", "device"):
        mine = cvt.decompress(data, device="cpu", engine=engine).numpy()
        assert rel_rms(mine, ref) < TRANSFORM_TOL


@pytest.mark.parametrize("name", list(GEOMS))
def test_size_close_to_oracle(containers, name):
    block, vol = geom_volume(name)
    other, _ = ocodec.compress(vol, 1e-2, block=block)
    data = containers[name][False]
    assert abs(int(data.size) - int(other.size)) <= max(64, 0.01 * other.size)


@pytest.mark.parametrize("name", list(GEOMS))
def test_local_table_matches_jax_and_native(containers, name):
    """The local RMS at any cells: the table within rtol 1e-5 of the JAX
    package's (f32 sums) and of native's (f64), the container decoding on
    both engines and under native."""
    block, vol = geom_volume(name)
    data = containers[name][True]
    hdr, _, mf, _ = ctn.unpack(data)
    assert hdr.use_local_rms and hdr.glob_mulfac == 1.0
    jdata, _ = jcodec.compress(vol, 1e-2, block=block, use_local_rms=True)
    ndata, _ = rle_host.host_compress(vol, 1e-2, block=block, use_local_rms=True)
    np.testing.assert_allclose(mf, ctn.unpack(jdata)[2], rtol=1e-5)
    np.testing.assert_allclose(mf, ctn.unpack(ndata)[2], rtol=1e-5)
    assert abs(int(data.size) - int(ndata.size)) <= max(64, 0.01 * ndata.size)
    out = cvt.decompress(data, device="cpu", engine="device").numpy()
    assert rel_rms(out, rle_host.host_decompress(data)) < TRANSFORM_TOL
    assert rel_rms(out, cvt.decompress(ndata, device="cpu").numpy()) < 1e-3


@pytest.mark.parametrize("block", [(8, 8, 8), (128, 8, 8), (8, 8, 1)],
                         ids=lambda b: "x".join(map(str, b)))
def test_raw_fallback_and_nan_block(block):
    """x1000 noise beside a quiet region at 1e-8: the noisy blocks fall back
    to raw (their unscaled coefficients stored).  Under the local RMS a NaN
    reaches only its cascade's taps, and its block is coded as native's
    parity codec codes it (no block raw, the raw flags native's).  Both
    engines agree bit for bit and native decodes each container."""
    rng = np.random.default_rng(81)
    shape = (8, 16, 256)
    vol = (rng.standard_normal(shape) * 1000).astype(F32)
    vol[:, :, 128:] *= 1e-6
    nan_vol = vol.copy()
    nan_vol[-1, -1, -1] = np.nan
    nbz, nby, nbx = blocks.grid_shape(shape, block)
    for v, scale, local in ((vol, 1e-8, False), (nan_vol, 1e-2, True)):
        data, _ = cvt.compress(v, scale, block=block, use_local_rms=local,
                               device="cpu")
        raw = ctn.unpack(data)[1] < 0
        if local:
            want, _ = rle_host.host_compress_parity(v, scale, block=block,
                                                    use_local_rms=True)
            assert not raw.any()
            np.testing.assert_array_equal(raw, ctn.unpack(want)[1] < 0)
        else:
            assert raw.reshape(nbz, nby, nbx)[:, :, : 128 // block[0]].all()
            assert not raw.reshape(nbz, nby, nbx)[:, :, 128 // block[0]:].any()
        dev = cvt.decompress(data, device="cpu", engine="device").numpy()
        host = cvt.decompress(data, device="cpu", engine="host").numpy()
        np.testing.assert_array_equal(np.isnan(dev), np.isnan(host))
        fin = np.isfinite(host)
        np.testing.assert_array_equal(dev[fin], host[fin])
        nat = rle_host.host_decompress(data)
        assert rel_rms(nat[fin], dev[fin]) < TRANSFORM_TOL
        lead = (slice(None), slice(None), slice(0, 128))
        assert rel_error_and_snr(v[lead], dev[lead])[0] < 2e-2


def quantized(data):
    """The quantized coefficients (nnn, cells) of a container's blocks
    (native decode, times each block's mulfac, rounded) and its raw flags."""
    hdr, blkoffs, blkmf, pbase = ctn.unpack(data)
    dense = rle_host.decode_payloads(data[pbase:], blkoffs, hdr.glob_mulfac,
                                     hdr.bx * hdr.by * hdr.bz, blkmf)
    mf = blkmf if blkmf is not None else np.full(blkoffs.size, hdr.glob_mulfac, F32)
    return np.rint(dense.astype(np.float64) * mf[:, None]).astype(np.int64), blkoffs < 0


def test_8x8x1_local_steps_match_jax():
    """A z-only sinusoid at (8, 8, 1) blocks under the local RMS: each block
    is one constant 8x8 slice, so its DC is its only coefficient above
    rounding, and DC * mulfac = DC * 8 / (|DC| * scale) is +-800 in exact
    arithmetic.  Truncation gives 800 or 799 by the transform's last bit, so
    the port, the JAX package and native differ in which blocks get 799 and
    nowhere else: the same sizes, every quantized DC 0 or +-799 or +-800
    in all three, the port's scaled DC within 1e-5 of 800, and each err
    within the 1/800 the step can cost (chip_smoke.py holds the S-sized
    cases to this mechanism)."""
    shape, block = (96, 16, 16), (8, 8, 1)
    vol = make_sinusoid_volume(*shape, periods=3)
    data, _ = cvt.compress(vol, 1e-2, block=block, use_local_rms=True, device="cpu")
    jdata, _ = jcodec.compress(vol, 1e-2, block=block, use_local_rms=True)
    ndata, _ = rle_host.host_compress(vol, 1e-2, block=block, use_local_rms=True)
    assert data.size == jdata.size == ndata.size
    for d, decoded in ((data, cvt.decompress(data, device="cpu").numpy()),
                       (jdata, jcodec.decompress(jdata)),
                       (ndata, rle_host.host_decompress(ndata))):
        q, raw = quantized(d)
        assert not raw.any() and (q[:, 1:] == 0).all()
        assert set(np.abs(q[:, 0]).tolist()) <= {0, 799, 800}
        assert rel_error_and_snr(vol, decoded)[0] <= 1 / 800
    plane, *_, mf = tokenize.encode(torch.from_numpy(vol), block, scale=1e-2)
    dc = (blocks.to_blocks(plane, block).view(mf.numel(), -1)[:, 0] * mf).numpy()
    live = dc != 0
    assert np.abs(np.abs(dc[live]) - 800).max() <= 800 * 1e-5
