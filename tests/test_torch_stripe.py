"""The port's stripe and fused stripe routes at bx < 128 (but 32^3;
ops/geometry.py) on the CPU: the gates against the JAX package's,
`tokenize_stripe` (plain version, the K13 port) bit-exact against JAX K13 in
interpret mode through `stripe_rowmap`, and `stripe_fused_encode` (plain
version, the K1 and K9 port at the other `stripe_fused_ok` blocks) against
JAX K1 in interpret mode: coefficients within 1e-5, tables within rtol
1e-5, the tokenize of K1's fv bit-exact (level 1); the volume-order
transform within 1e-5 of the oracle and of JAX's, `stripe_fused_inverse`
within 1e-5 of JAX K5 (level 2); containers across the oracle, JAX and
native codecs, sizes and local tables (level 3), the raw fallback and a NaN
block."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
torch.set_num_threads(1)  # one thread a process: the suite runs in parallel workers

import jax.numpy as jnp

import cvxcompress_tpu_torch as cvt
from cvxcompress_tpu.ops import codec as jcodec
from cvxcompress_tpu.ops import fused_inverse as jfi
from cvxcompress_tpu.ops import tokenize_pallas as tp
from cvxcompress_tpu.ops import wavelet as jwav
from cvxcompress_tpu.oracle import codec as ocodec
from cvxcompress_tpu.oracle import wavelet as owav
from cvxcompress_tpu_torch import container as ctn
from cvxcompress_tpu_torch.ops import (
    blocks, codec, fused_inverse, geometry, quant, rle_host, tokenize, wavelet,
)

from conftest import make_sinusoid_volume, rel_error_and_snr

TRANSFORM_TOL = 1e-5
F32 = np.float32
SIZES = (1, 8, 16, 32, 64, 128, 256)

# geometries of the two routes at volumes with partial edge blocks (64^3 at
# an x extent of 300: the JAX fused gate's 3 MiB block row is exceeded)
GEOMS = {
    "16c": ((16, 16, 16), (20, 36, 52)),
    "64c": ((64, 64, 64), (70, 64, 300)),
    "16x16x1": ((16, 16, 1), (6, 36, 52)),
}
ROUTES = {"16c": "stripe_fused", "64c": "stripe", "16x16x1": "stripe_fused"}


def rel_rms(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.sqrt(((got - ref) ** 2).mean()) / (np.sqrt((ref**2).mean()) + 1e-30)


def test_gates_match_jax():
    """The port's copy of the fused stripe gate agrees with the JAX
    package's on every valid block at narrow and wide volumes, and each
    valid block takes exactly one route."""
    for shape in ((40, 50, 70), (40, 50, 300), (20, 30, 2000)):
        for bx, by, bz in itertools.product(SIZES[1:], SIZES[1:], SIZES):
            block = (bx, by, bz)
            assert ctn.is_valid_block_size(*block)
            fused = tp.stripe_fused_ok(shape, block)
            assert geometry.stripe_fused_ok(shape, block) == fused
            r = codec.route(shape, block)
            if block == (32, 32, 32):
                assert r == "fused32"
            else:
                assert r == ("stripe_fused" if fused else "stripe")
    for name, (block, shape) in GEOMS.items():
        assert codec.route(shape, block) == ROUTES[name]


def test_stripe_map_matches_rowmap():
    """`geometry.stripe_addr` puts every block-major cell where JAX's
    `stripe_rowmap` does, once the TPU's x-pad to 128 lanes is taken out."""
    shape, block = (20, 36, 52), (16, 16, 16)
    bx, by, bz = block
    nbz, nby, nbx = blocks.grid_shape(shape, block)
    nbx2 = jwav.padded_nbx(nbx, bx)
    nxp = nbx * bx
    nchunks = nbz * nby * nbx * bx * by * bz // 128
    rows = np.asarray(jcodec.stripe_rowmap(shape, block)(np.arange(nchunks)))
    flat = rows.reshape(-1, 1) * bx + np.arange(bx)  # offsets in the x-padded plane
    r, x = flat // (nbx2 * bx), flat % (nbx2 * bx)
    want = (r * nxp + x).reshape(-1)
    cell = np.arange(bx * by * bz)
    got = geometry.stripe_addr(torch.arange(nbz * nby * nbx)[:, None],
                               torch.from_numpy(cell)[None, :], shape, block)
    np.testing.assert_array_equal(got.reshape(-1).numpy(), want)


# -- level 1: tokenize_stripe against JAX K13 ----------------------------------


def plane_case(case):
    """(vol_shape, block, plane (nzp, nyp, nxp), mulfacs (nnn,))."""
    rng = np.random.default_rng(13)
    if case == "sparse16":  # partial edge blocks, per-block tables, a zero block
        shape, block = (20, 36, 40), (16, 16, 16)
    elif case == "flat16x16x1":
        shape, block = (3, 40, 40), (16, 16, 1)
    else:  # "classes64": every token class, NaN, out of range, a raw block
        shape, block = (64, 64, 100), (64, 64, 64)
    nzp, nyp, nxp = geometry.plane_shape(shape, block)
    nnn = int(np.prod(blocks.grid_shape(shape, block)))
    p = (rng.standard_normal((nzp, nyp, nxp)) * 50).astype(F32)
    p[rng.random(p.shape) < 0.85] = 0.0
    if case == "sparse16":
        p[:16, :16, :16] = 0.0  # block 0: one run of 4,096 zeros
        return shape, block, p, rng.uniform(0.5, 3.0, nnn).astype(F32)
    if case == "flat16x16x1":
        return shape, block, p, rng.uniform(0.5, 3.0, nnn).astype(F32)
    p[0, 0, 0:8] = [1, -1, 124, -124, 2, 3, 4, 5]
    p[0, 0, 8:16] = [200, -200, 300, -300, 1000, -1000, 32767, -32768]
    p[0, 1, 0:8] = [1e5, -1e5, 8388607, -8388608, 7e4, -7e4, 99999, -99999]
    p[5, 7, 9] = np.nan
    p[5, 7, 10] = 3e12
    p[:, :, 64:] = 1e12  # block 1 over 4 B a cell: raw
    return shape, block, p, np.ones(nnn, F32)


@pytest.mark.parametrize("case", ["sparse16", "flat16x16x1", "classes64"])
def test_tokenize_stripe_matches_jax_k13(case):
    """Level 1: the port's stripe tokenize, fed the plane and the table,
    gives JAX K13's descriptors (gathered to block-major through
    `stripe_rowmap`), chunk bytes, sizes and raw flags bit for bit (JAX fed
    the x-padded plane scaled by each block's mulfac, the one f32 rounding
    of both)."""
    shape, block, p, mf = plane_case(case)
    bx, by, bz = block
    nbz, nby, nbx = blocks.grid_shape(shape, block)
    nzp, nyp, nxp = p.shape
    desc, cb, sizes, raw = tokenize.tokenize_stripe(torch.from_numpy(p),
                                                    torch.from_numpy(mf), block)
    nbx2 = jwav.padded_nbx(nbx, bx)
    fvv = np.zeros((nzp, nyp, nbx2 * bx), F32)
    mf_vol = np.repeat(np.repeat(np.repeat(mf.reshape(nbz, nby, nbx), bz, 0), by, 1),
                       bx, 2)
    fvv[:, :, :nxp] = p * mf_vol
    jd, _, jcb, js, jr, _ = tp.tokenize_desc_stripe_fast(
        jnp.asarray(fvv.reshape(nzp * nyp, -1)), shape, block, interpret=True)
    nchunks = nbz * nby * nbx * bx * by * bz // 128
    rows = np.asarray(jcodec.stripe_rowmap(shape, block)(np.arange(nchunks)))
    jdesc = np.asarray(jd).reshape(-1, bx)[rows.reshape(-1)].reshape(desc.shape)
    np.testing.assert_array_equal(desc.numpy(), jdesc)
    np.testing.assert_array_equal(cb.numpy(), np.asarray(jcb))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(js))
    np.testing.assert_array_equal(raw.numpy(), np.asarray(jr))
    if case == "classes64":
        assert raw.tolist() == [False, True]


# the fused stripe route's level-1 and level-2 cases: block, volume, local RMS
FUSED_CASES = {
    "16c": ((16, 16, 16), (20, 36, 52), False),
    "16x16x1_local": ((16, 16, 1), (6, 36, 52), True),
    "8x16x8": ((8, 16, 8), (20, 36, 52), False),
}


def jax_block_major(plane, shape, block):
    """A JAX volume-order (nzp*nyp, W) plane (x-padded to 128 lanes) as
    block-major (nnn, cells), through `stripe_rowmap`."""
    bx, by, bz = block
    nnn = int(np.prod(blocks.grid_shape(shape, block)))
    rows = np.asarray(jcodec.stripe_rowmap(shape, block)(
        np.arange(nnn * bx * by * bz // 128)))
    return np.asarray(plane).reshape(-1, bx)[rows.reshape(-1)].reshape(nnn, -1)


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_stripe_fused_encode_matches_jax_k1(case):
    """Level 1: `stripe_fused_encode` against JAX K1 (`stripe_fused_encode`,
    interpret mode; K9 under the local RMS) on the same volume: the
    coefficients within 1e-5 of K1's fv over its mulfacs, the table within
    rtol 1e-5 (the port sums in f64, `quant.stripe_rms`), and the port's
    tokenize of K1's own fv giving its descriptors, chunk bytes, sizes and
    raw flags bit for bit."""
    block, shape, local = FUSED_CASES[case]
    assert codec.route(shape, block) == "stripe_fused"
    vol = make_sinusoid_volume(*shape, periods=3)
    vol += np.random.default_rng(11).standard_normal(shape).astype(F32) * 1e-2
    vol[0, 0, :4] = [50.0, -50.0, 1e4, -1e4]
    mulfac = quant.global_mulfac(vol, 1e-2)
    args = dict(scale=1e-2) if local else dict(mulfac=mulfac)
    c, _, _, _, _, mf = tokenize.stripe_fused_encode(torch.from_numpy(vol), block,
                                                     **args)
    jfv, jd, _, jcb, js, jr, _, jmf = tp.stripe_fused_encode(
        jnp.asarray(vol), jnp.float32(1e-2 if local else mulfac), shape, block,
        use_local=local, interpret=True)
    jm = np.asarray(jmf) if local else np.full(mf.shape, mulfac, F32)
    np.testing.assert_allclose(mf.numpy(), jm, rtol=1e-5)
    fv = jax_block_major(jfv, shape, block)
    assert rel_rms(c.numpy() * jm[:, None], fv) < TRANSFORM_TOL
    desc, cb, sizes, raw = tokenize.tokenize_blocks_plain(
        torch.from_numpy(fv), torch.ones(fv.shape[0]))
    np.testing.assert_array_equal(desc.numpy(), jax_block_major(jd, shape, block))
    np.testing.assert_array_equal(cb.numpy(), np.asarray(jcb))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(js))
    np.testing.assert_array_equal(raw.numpy(), np.asarray(jr))


# -- level 2: the volume-order transform, the fused stripe inverse --------------


@pytest.mark.parametrize("case", ["16c", "8x16x8"])
def test_stripe_fused_inverse_matches_jax_k5(case):
    """Level 2: `stripe_fused_inverse` (plain version) within 1e-5 of JAX K5
    (`stripe_fused_inverse`, interpret mode) on the same coefficients, the
    partial edge blocks clipped."""
    block, shape, _ = FUSED_CASES[case]
    bx, by, bz = block
    nbz, nby, nbx = blocks.grid_shape(shape, block)
    c = np.random.default_rng(5).standard_normal((nbz * nby * nbx, bx * by * bz))
    c = c.astype(F32)
    got = fused_inverse.stripe_fused_inverse(torch.from_numpy(c), shape, block)
    nzp, nyp, nxp = geometry.plane_shape(shape, block)
    plane = np.zeros((nzp, nyp, jwav.padded_nbx(nbx, bx) * bx), F32)
    plane[:, :, :nxp] = blocks.from_blocks(torch.from_numpy(c).view(-1, bz, by, bx),
                                           (nzp, nyp, nxp), block).numpy()
    jv = jfi.stripe_fused_inverse(jnp.asarray(plane.reshape(nzp * nyp, -1)), shape,
                                  block, interpret=True)
    assert got.shape == tuple(shape)
    assert rel_rms(got.numpy(), np.asarray(jv)) < TRANSFORM_TOL


@pytest.mark.parametrize("block", [(16, 16, 16), (64, 64, 64), (16, 16, 1), (32, 8, 64)],
                         ids=lambda b: "x".join(map(str, b)))
def test_volume_transform_matches_oracle(block):
    """Level 2: `forward_3d_volume` within 1e-5 of the oracle's per-block
    cascades (f64) and of JAX's `forward_3d_volume`, partial edge blocks
    zero-padded, the z axis skipped at bz == 1."""
    bx, by, bz = block
    shape = (bz + bz // 2 if bz > 1 else 3, 2 * by - 3, bx + bx // 2)
    vol = np.random.default_rng(sum(block)).standard_normal(shape).astype(F32)
    got = wavelet.forward_3d_volume(torch.from_numpy(vol), block)
    assert tuple(got.shape) == geometry.plane_shape(shape, block)
    gb = blocks.to_blocks(got, block).numpy()
    padded = blocks.to_blocks(torch.from_numpy(vol), block).numpy().astype(np.float64)
    ref = np.stack([owav.forward_3d(b) for b in padded])
    assert rel_rms(gb, ref) < TRANSFORM_TOL
    jv = np.asarray(jwav.forward_3d_volume(jnp.asarray(vol), shape, block))
    assert rel_rms(got.numpy().reshape(jv.shape), jv) < TRANSFORM_TOL


# -- level 3: containers ---------------------------------------------------------


def geom_volume(name):
    block, shape = GEOMS[name]
    vol = make_sinusoid_volume(*shape, periods=3)
    vol += np.random.default_rng(5).standard_normal(shape).astype(F32) * 1e-3
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
    """The local RMS summed over the volume-order plane: the table within
    rtol 1e-5 of the JAX package's and of native's, the container decoding
    on both engines and under native."""
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


@pytest.mark.parametrize("block", [(16, 16, 16), (64, 64, 8), (16, 16, 1)],
                         ids=lambda b: "x".join(map(str, b)))
def test_raw_fallback_and_nan_block(block):
    """x1000 noise beside a quiet region at 1e-8: the noisy blocks fall back
    to raw, their unscaled coefficients stored (the fused stripe route's
    block-major ones; the stripe route's, gathered from the volume-order
    plane, in tests/test_torch_generic.py).  Under the local RMS a NaN
    spreads to part of its block's coefficients (native's parity cascade),
    which code as VLESC4 tokens: the raw flags are native's parity codec's
    (no block raw) and the NaN block's mulfac is 1.0.  Both engines agree
    bit for bit and native decodes each container."""
    rng = np.random.default_rng(82)
    shape = (16, 64, 256)
    vol = (rng.standard_normal(shape) * 1000).astype(F32)
    vol[:, :, 128:] *= 1e-6
    nan_vol = vol.copy()
    nan_vol[-1, -1, -1] = np.nan
    nbz, nby, nbx = blocks.grid_shape(shape, block)
    assert codec.route(shape, block) == "stripe_fused"
    for v, scale, local in ((vol, 1e-8, False), (nan_vol, 1e-2, True)):
        data, _ = cvt.compress(v, scale, block=block, use_local_rms=local,
                               device="cpu")
        raw = ctn.unpack(data)[1] < 0
        if local:
            nat_raw = ctn.unpack(rle_host.host_compress_parity(
                v, scale, block=block, use_local_rms=True)[0])[1] < 0
            np.testing.assert_array_equal(raw, nat_raw)
            assert not raw.any() and ctn.unpack(data)[2][-1] == 1.0
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
