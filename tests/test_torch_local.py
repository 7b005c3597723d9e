"""The port's local-RMS path (plain versions, on the CPU) against the JAX
package's K9, K10 and K11 in interpret mode, the oracle and the native
library: the mulfac tables to rtol 1e-5 (the JAX package's own contract
between its paths, tests/test_fused_compress.py:189), tokenize and emit bit
for bit given JAX's fv (level 1), codec interop within one quantization
step, dense decodes uint32-equal to the native decoder.  The JAX kernels
run three times in all, shared through module-scoped fixtures."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
torch.set_num_threads(1)  # one thread a process: the suite runs in parallel workers

import jax.numpy as jnp

import cvxcompress_tpu_torch as cvt
from cvxcompress_tpu.ops import codec as jcodec
from cvxcompress_tpu.ops import fused_compress as jfc
from cvxcompress_tpu.ops import quant as jquant
from cvxcompress_tpu.ops import tokenize_pallas as tp
from cvxcompress_tpu.ops import wavelet as jwav
from cvxcompress_tpu.oracle import codec as ocodec
from cvxcompress_tpu_torch import container as ctn
from cvxcompress_tpu_torch.ops import (
    fused_compress, pack, quant, rle_device, rle_host, tokenize,
)
from cvxcompress_tpu_torch.ops import entropy_decode as ted

from conftest import rel_error_and_snr

SCALE = 1e-2
TABLE_RTOL = 1e-5
TRANSFORM_TOL = 1e-5
SHAPE32 = (64, 96, 96)  # 2 x 3 x 3 blocks of 32^3
CELLS32 = 32 ** 3
SHAPE128 = (128, 128, 256)  # 2 blocks of 128^3
CELLS128 = 128 ** 3


def rel_rms(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.sqrt(((got - ref) ** 2).mean()) / (np.sqrt((ref**2).mean()) + 1e-30)


def ramp_volume(shape, b, seed=4):
    """A z-sinusoid plus 1e-5 noise whose b^3 blocks are scaled by 10^-k,
    k = 4 * (block index mod 2): block RMS 10^4 apart, so a block quantized
    with another block's mulfac shows at once."""
    rng = np.random.default_rng(seed)
    nz, ny, nx = shape
    z = np.sin(np.arange(nz) * np.pi * 2 / nz).astype(np.float32)
    v = np.broadcast_to(z[:, None, None], shape).copy()
    v += rng.standard_normal(shape).astype(np.float32) * 1e-5
    f = (10.0 ** -ramp_exponents(shape, b)).astype(np.float32)
    return v * f


def ramp_exponents(shape, b):
    """Each cell's k of `ramp_volume`."""
    nb = tuple(n // b for n in shape)
    k = (4 * (np.arange(np.prod(nb)) % 2)).reshape(nb)
    return np.kron(k, np.ones((b, b, b), np.int64))


def quality_by_amplitude(vol, out, b, skip=None):
    """(err, SNR) over the loud and over the quiet blocks of a ramp volume
    apart (cells in `skip` left out): local RMS gives both the same relative
    quality."""
    k = ramp_exponents(vol.shape, b)
    keep = np.ones(vol.shape, bool) if skip is None else ~skip
    return [rel_error_and_snr(vol[keep & (k == e)], out[keep & (k == e)])
            for e in (0, 4)]


def odd_volume(nan=True):
    """The ramp volume at 32^3 with the guard cases in three blocks: an
    all-zero block (rms 0: mulfac 1.0), a block of ~1e-38 values (1/(rms *
    scale) overflows: 1.0) and, with `nan`, a block holding a NaN (rms NaN:
    mulfac 1.0; the port's cascade, native's parity cascade, spreads the NaN
    to part of the block's coefficients, each quantized to INT32_MIN and
    coded as the scaled NaN itself, and every decoder's inverse spreads it
    over the block).  The oracle's and the JAX package's dense transforms
    spread a NaN to every coefficient, so the interop tests take the volume
    without it."""
    v = ramp_volume(SHAPE32, 32)
    v[0:32, 0:32, 32:64] = 0.0
    v[0:32, 32:64, 0:32] = np.float32(1e-38) * (1.0 + v[0:32, 32:64, 0:32])
    v[32:64, 64:96, 64:96] += 0.5
    if nan:
        v[40, 70, 70] = np.nan
    return v


def raw_volume():
    """The ramp volume at 32^3 with N(0,1) noise in blocks 4 (loud) and 13
    (x 1e-4): at scale 1e-7 most of their quantized values leave the int24
    range, so they fall back to raw, and the sinusoid blocks do not."""
    v = ramp_volume(SHAPE32, 32)
    noise = np.random.default_rng(13).standard_normal((2, 32, 32, 32)).astype(np.float32)
    v[0:32, 32:64, 32:64] = noise[0]
    v[32:64, 32:64, 32:64] = noise[1] * np.float32(1e-4)
    return v


def odd_blocks():
    """The cells of `odd_volume`'s three guard blocks."""
    m = np.zeros(SHAPE32, bool)
    m[0:32, 0:32, 32:64] = m[0:32, 32:64, 0:32] = m[32:64, 64:96, 64:96] = True
    return m


def block_major(plane, shape, w):
    """A JAX volume-order (nzp*nyp, W) plane of 32^3 blocks -> (nnn, cells)."""
    nz, ny, nx = shape
    nbz, nby, nbx = nz // 32, ny // 32, nx // 32
    return (np.asarray(plane).reshape(nbz, 32, nby, 32, w // 32, 32)[:, :, :, :, :nbx]
            .transpose(0, 2, 4, 1, 3, 5).reshape(-1, CELLS32))


def native_stream(coeffs, mulfacs):
    streams, sizes, raw = rle_host.encode_payloads(coeffs, mulfacs)
    parts = [s for s, r in zip(streams, raw) if not r]
    return (np.concatenate(parts) if parts else np.zeros(0, np.uint8)), sizes, raw


# (a) quant.local_rms and mulfac_from_rms ------------------------------------


def test_local_rms_and_mulfac_match_jax_with_guards():
    """Per-block RMS and mulfac against the JAX package's on ordinary blocks
    (RMS 1e-4 to 1e4) and the guard blocks: all-zero, ~1e-38 (the quotient
    overflows) and NaN, all of which get mulfac 1.0."""
    rng = np.random.default_rng(9)
    c = rng.standard_normal((7, 32, 32, 32)).astype(np.float32)
    c[1] *= 1e-4
    c[2] *= 1e4
    c[3] = 0.0
    c[4] = np.float32(1e-38) * np.sign(c[4])
    c[5, 3, 4, 5] = np.nan
    c[6, :, :, :16] = 0.0
    rms = quant.local_rms(torch.from_numpy(c.reshape(7, -1)))
    mf = quant.mulfac_from_rms(rms, SCALE).numpy()
    jrms = np.asarray(jquant.local_rms(jnp.asarray(c)))
    jmf = np.asarray(jquant.mulfac_from_rms(jquant.local_rms(jnp.asarray(c)), SCALE))
    ordinary = [0, 1, 2, 6]
    np.testing.assert_allclose(rms.numpy()[ordinary], jrms[ordinary], rtol=TABLE_RTOL)
    np.testing.assert_allclose(mf, jmf, rtol=TABLE_RTOL)
    assert mf[3] == mf[4] == mf[5] == 1.0
    # f64 accumulation: the f32 RMS of the exact sum (one rounding)
    ref = np.sqrt((c.reshape(7, -1).astype(np.float64) ** 2).sum(1) / CELLS32)
    np.testing.assert_array_equal(rms.numpy()[ordinary], ref[ordinary].astype(np.float32))


def test_sum_order_at_128_slices_and_partials():
    """At 128^3 the RMS is 128 slice sums (one CTA each) added in slice
    order; `local_rms`, the slice partials of `casc_local_plain` and
    `rms_of_partials` give the same f32 value, that of the exact sum."""
    rng = np.random.default_rng(10)
    c = torch.from_numpy(rng.standard_normal((2, CELLS128)).astype(np.float32))
    c[1] *= 1e-3
    parts = quant.cta_sumsq(c.view(-1, 128 * 128), 256).view(2, 128)
    np.testing.assert_allclose(
        parts.numpy(), (c.double() ** 2).view(2, 128, -1).sum(-1).numpy(), rtol=1e-12)
    rms = quant.local_rms(c)
    assert torch.equal(rms, quant.rms_of_partials(parts, CELLS128))
    ref = np.sqrt((c.double() ** 2).sum(1).numpy() / CELLS128).astype(np.float32)
    np.testing.assert_array_equal(rms.numpy(), ref)


@pytest.mark.parametrize("encode", [tokenize.fused_encode, fused_compress.block_encode],
                         ids=["32", "128"])
def test_encode_takes_exactly_one_of_mulfac_and_scale(encode):
    """An encode's mode follows from its arguments: the global mulfac, or
    the scale for the local RMS; both or neither raise before any work."""
    vol = torch.zeros((128, 128, 128))
    with pytest.raises(ValueError, match="exactly one"):
        encode(vol)
    with pytest.raises(ValueError, match="exactly one"):
        encode(vol, 1.0, scale=SCALE)


# (b) 32^3: K9 -----------------------------------------------------------


@pytest.fixture(scope="module")
def jax_k9():
    """JAX K9 (stripe_fused_encode(use_local=True), interpret mode) on the
    ramp volume, re-laid out block-major."""
    vol = ramp_volume(SHAPE32, 32)
    block = (32, 32, 32)
    assert tp.stripe_fused_ok(SHAPE32, block)
    fv, desc, _, _, sizes, raw, _, mf = tp.stripe_fused_encode(
        jnp.asarray(vol), jnp.float32(SCALE), SHAPE32, block, use_local=True,
        interpret=True)
    w = jwav.padded_nbx(SHAPE32[2] // 32, 32) * 32
    return vol, dict(fv=block_major(fv, SHAPE32, w), desc=block_major(desc, SHAPE32, w),
                     sizes=np.asarray(sizes), raw=np.asarray(raw), mf=np.asarray(mf))


def test_k9_table_matches_jax(jax_k9):
    """fused_encode(scale=...), the local RMS: each block's mulfac within rtol
    1e-5 of JAX K9's, over blocks whose mulfacs span 10^4; the tokenize
    used that table (bit-equal to the plain tokenize at it)."""
    vol, j = jax_k9
    coeffs, desc, _, sizes, raw, mulfacs = tokenize.fused_encode(
        torch.from_numpy(vol), scale=SCALE)
    np.testing.assert_allclose(mulfacs.numpy(), j["mf"], rtol=TABLE_RTOL)
    assert mulfacs.max() / mulfacs.min() > 5e3
    assert torch.equal(mulfacs, quant.mulfac_from_rms(quant.local_rms(coeffs), SCALE))
    d2, s2, r2 = rle_device.tokenize(tokenize.scaled(coeffs, mulfacs))
    assert torch.equal(desc, d2) and torch.equal(sizes, s2) and torch.equal(raw, r2)


def test_k9_tokenize_and_emit_stage_exact(jax_k9):
    """Level 1: the port's tokenize fed JAX K9's fv gives its descriptors,
    sizes and raw flags bit for bit, and emit_chunks_plain at its chunk
    counts writes the native encoder's stream of that fv; on the port's own
    coefficients, chunk counts and per-block table the stream equals
    native's at the same table."""
    vol, j = jax_k9
    fv = torch.from_numpy(j["fv"])
    desc, sizes, raw = rle_device.tokenize(fv)
    np.testing.assert_array_equal(desc.numpy(), j["desc"])
    np.testing.assert_array_equal(sizes.numpy(), j["sizes"])
    np.testing.assert_array_equal(raw.numpy(), j["raw"])
    ones = torch.ones(fv.shape[0])
    _, cb, _, _ = tokenize.tokenize_blocks_plain(fv, ones)
    base = torch.cumsum(cb.long(), 0) - cb.long()
    stream = pack.emit_chunks_plain(fv, ones, desc, cb, base, int(cb.sum()))
    native, nsizes, _ = native_stream(j["fv"], 1.0)
    np.testing.assert_array_equal(nsizes, j["sizes"])
    np.testing.assert_array_equal(stream.numpy(), native)

    coeffs, desc, cb, sizes, raw, mulfacs = tokenize.fused_encode(
        torch.from_numpy(vol), scale=SCALE)
    base = torch.cumsum(cb.long(), 0) - cb.long()
    stream = pack.emit_chunks(coeffs, mulfacs, desc, cb, base, int(cb.sum()))
    native, nsizes, _ = native_stream(coeffs.numpy(), mulfacs.numpy())
    np.testing.assert_array_equal(nsizes, sizes.numpy())
    np.testing.assert_array_equal(stream.numpy(), native)


# (c) 128^3: K10 (a, b) and K11 --------------------------------------------


def volume128():
    """Sparse x40 noise (every token class, zero runs across chunks and
    slices) with block 1 scaled by 1e-4."""
    rng = np.random.default_rng(2024)
    v = (rng.standard_normal(SHAPE128) * 40).astype(np.float32)
    v[rng.random(SHAPE128) >= 0.2] = 0.0
    v[:, :, 128:] *= 1e-4
    return v


@pytest.fixture(scope="module")
def jax_k10_k11():
    """JAX tokenize_desc_block(use_local=True) in interpret mode: the
    two-kernel K10 (onek=False) and the one-kernel K11 (onek=True)."""
    vol = volume128()
    out = {}
    for onek in (False, True):
        fv, desc, cb, sizes, raw, _, mf = jfc.tokenize_desc_block(
            jnp.asarray(vol), jnp.float32(SCALE), SHAPE128, (128, 128, 128),
            use_local=True, onek=onek, interpret=True)
        out[onek] = dict(fv=np.array(fv).reshape(2, CELLS128),
                         desc=np.array(desc).reshape(2, CELLS128),
                         cb=np.asarray(cb), sizes=np.asarray(sizes),
                         raw=np.asarray(raw), mf=np.asarray(mf))
    port = fused_compress.block_encode(torch.from_numpy(vol), scale=SCALE)
    return vol, out, port


@pytest.mark.parametrize("onek", [False, True], ids=["k10", "k11"])
def test_k10_k11_table_and_stage_exact(jax_k10_k11, onek):
    """The port's 128^3 local encode (block_fwd_z, block_casc_local,
    block_scale_tok) against JAX K10 and K11: tables within rtol 1e-5; the
    port's tokenize and emit_chunks_plain fed JAX's fv give its
    descriptors, chunk bytes, sizes and raw flags bit for bit, and the
    native encoder's stream."""
    _, out, port = jax_k10_k11
    j = out[onek]
    mulfacs = port[5]
    np.testing.assert_allclose(mulfacs.numpy(), j["mf"], rtol=TABLE_RTOL)
    assert mulfacs[1] / mulfacs[0] > 5e3
    fv = torch.from_numpy(j["fv"])
    desc, cb, sizes, raw = tokenize.tokenize_blocks_plain(fv, 1.0)
    np.testing.assert_array_equal(desc.numpy(), j["desc"])
    np.testing.assert_array_equal(cb.numpy(), j["cb"])
    np.testing.assert_array_equal(sizes.numpy(), j["sizes"])
    np.testing.assert_array_equal(raw.numpy(), j["raw"])
    cb64 = cb.long()
    stream = pack.emit_chunks_plain(fv, torch.ones(2), desc, cb, torch.cumsum(cb64, 0) - cb64,
                                    int(cb64.sum()))
    native, _, _ = native_stream(j["fv"], 1.0)
    np.testing.assert_array_equal(stream.numpy(), native)


def test_k10_passes_agree_with_one_reduction(jax_k10_k11):
    """casc_local's slice partials and scale_tok's table give exactly the
    one-shot `local_rms` table of the coefficients, the tokenize is the
    plain tokenize at that table, and the chunk stream at the per-block
    table equals the native encoder's."""
    _, _, port = jax_k10_k11
    coeffs, desc, cb, sizes, raw, mulfacs = port
    assert torch.equal(mulfacs, quant.mulfac_from_rms(quant.local_rms(coeffs), SCALE))
    d2, cb2, s2, r2 = tokenize.tokenize_blocks_plain(coeffs, mulfacs)
    assert torch.equal(desc, d2) and torch.equal(cb, cb2)
    assert torch.equal(sizes, s2) and torch.equal(raw, r2)
    cb64 = cb.long()
    stream = pack.emit_chunks(coeffs, mulfacs, desc, cb, torch.cumsum(cb64, 0) - cb64,
                              int(cb64.sum()))
    native, nsizes, _ = native_stream(coeffs.numpy(), mulfacs.numpy())
    np.testing.assert_array_equal(nsizes, sizes.numpy())
    np.testing.assert_array_equal(stream.numpy(), native)


# (d) the codec ------------------------------------------------------------


@pytest.fixture(scope="module")
def local32():
    """The port's local-RMS container of `odd_volume` without the NaN."""
    vol = odd_volume(nan=False)
    data, _ = cvt.compress(vol, SCALE, use_local_rms=True, device="cpu")
    return vol, data


def _decode(decoder, data):
    if decoder == "oracle":
        return ocodec.decompress(data)
    if decoder == "jax":
        return jcodec.decompress(data)
    return rle_host.host_decompress(data)


def _compress(producer, vol, scale=SCALE):
    if producer == "oracle":
        return ocodec.compress(vol, scale, use_local_rms=True)[0]
    if producer == "jax":
        return jcodec.compress(vol, scale, use_local_rms=True)[0]
    return rle_host.host_compress(vol, scale, use_local_rms=True)[0]


def per_block_max(diff):
    nz, ny, nx = diff.shape
    return diff.reshape(nz // 32, 32, ny // 32, 32, nx // 32, 32).max(axis=(1, 3, 5)).reshape(-1)


def device_dense(data):
    """The device engine's dense coefficients (plain versions) with the raw
    overlay, and native decode_payloads' at the container's table."""
    hdr, blkoffs, blkmf, pbase = ctn.unpack(data)
    p = ted.plan(data)
    b = ted.upload(p, "cpu")
    nsub, cells = b["sub_block"].numel(), p["cells"]
    if hdr.use_local_rms:
        np.testing.assert_array_equal(p["scalefac"], np.float32(1.0) / blkmf)
    M, P = ted.parse_maps(b["stream"], nsub, cells)
    e32, c32 = ted.chase(P, b["sub_reset"], b["starts"], cells)
    dense = ted.emit(b["stream"], M, e32, c32, b["sub_block"], b["scalefac"],
                     hdr.grid[3], cells)
    dense = ted.overlay_raw(dense, b["raw_rows"], b["raw_ids"]).numpy()
    nat = rle_host.decode_payloads(data[pbase:], blkoffs, hdr.glob_mulfac, cells, blkmf)
    return dense, nat


def test_local_container_layout_and_quality():
    """Header mulfac 1.0 and the local flag; the table holds the guards'
    1.0 for the zero, ~1e-38 and NaN blocks, and the raw flags are native's
    codec's: the NaN block's tokens carry its NaN coefficients and fit in
    far less than its raw bytes, as in native's container; the NaN fills
    the NaN block and no other after every decoder; the other blocks decode
    at the CI bars within the loud and within the quiet blocks apart, on
    both engines and under native, and through the class surface."""
    vol = odd_volume()
    data, ratio = cvt.compress(vol, SCALE, use_local_rms=True, device="cpu")
    hdr, blkoffs, blkmf, _ = ctn.unpack(data)
    assert hdr.use_local_rms and hdr.glob_mulfac == 1.0
    assert blkmf[1] == blkmf[3] == blkmf[17] == 1.0
    theirs, _ = rle_host.host_compress(vol, SCALE, use_local_rms=True)
    assert (blkoffs < 0).tolist() == (ctn.unpack(theirs)[1] < 0).tolist() == [False] * 18
    assert ratio == pytest.approx(vol.size * 4 / data.size)
    nan = np.kron(np.arange(18).reshape(2, 3, 3) == 17, np.ones((32, 32, 32), bool))
    outs = [cvt.decompress(data, device="cpu", engine=e).numpy() for e in ("host", "device")]
    outs.append(rle_host.host_decompress(data))
    for out in outs:
        assert np.array_equal(np.isnan(out), nan)
        for err, snr in quality_by_amplitude(vol, out, 32, skip=odd_blocks()):
            assert err < 2e-4 and snr > 75.0, (err, snr)
    np.testing.assert_array_equal(outs[0], outs[1])
    mine, _ = cvt.CvxCompress(device="cpu").Compress(SCALE, vol, 32, 32, 32,
                                                     use_local_RMS=True)
    np.testing.assert_array_equal(mine, data)


@pytest.mark.parametrize("decoder", ["oracle", "jax", "native"])
def test_port_local_container_decodes_elsewhere(local32, decoder):
    """The port's local container decodes under the oracle, the JAX package
    and the native library; in every block within one quantization step
    (1/mulfac of the block) of that decoder's decode of its own producer's
    local container."""
    vol, data = local32
    mine = _decode(decoder, data)
    theirs = _decode(decoder, _compress(decoder, vol))
    diff = np.abs(mine.astype(np.float64) - theirs)
    step = 1.0 / ctn.unpack(data)[2].astype(np.float64)
    assert (per_block_max(diff) <= step).all(), per_block_max(diff) / step


@pytest.mark.parametrize("producer", ["oracle", "jax", "native"])
def test_port_decodes_foreign_local_containers(local32, producer):
    """Local containers of the oracle, the JAX package and the native
    library: the device engine's dense coefficients are uint32-equal to the
    native decode_payloads at the container's table, and both engines give
    the producer's own decode within 1e-5."""
    vol, _ = local32
    data = _compress(producer, vol)
    assert ctn.unpack(data)[0].use_local_rms
    dense, nat = device_dense(data)
    np.testing.assert_array_equal(dense.view(np.uint32), nat.view(np.uint32))
    ref = _decode(producer, data)
    for engine in ("host", "device"):
        out = cvt.decompress(data, device="cpu", engine=engine).numpy()
        assert rel_rms(out, ref) < TRANSFORM_TOL, engine


def test_local_size_and_table_close_to_native(local32):
    vol, data = local32
    nat, _ = rle_host.host_compress(vol, SCALE, use_local_rms=True)
    assert abs(int(data.size) - int(nat.size)) <= max(64, 0.01 * nat.size)
    np.testing.assert_allclose(ctn.unpack(data)[2], ctn.unpack(nat)[2], rtol=TABLE_RTOL)


@pytest.fixture(scope="module")
def raw32():
    """`raw_volume` at scale 1e-7: the port's and native's local containers."""
    vol = raw_volume()
    data, _ = cvt.compress(vol, 1e-7, use_local_rms=True, device="cpu")
    nat, _ = rle_host.host_compress(vol, 1e-7, use_local_rms=True)
    return vol, data, nat


@pytest.mark.parametrize("decoder", ["oracle", "jax", "native"])
def test_local_raw_blocks_interop(raw32, decoder):
    """Raw-fallback blocks under the local RMS: the same blocks fall back as
    in native's container, whose size the port's matches within
    max(64 B, 1 %); the port's container decodes under the oracle, the JAX
    package and native within 1e-5 of the port's own decode (both engines
    bit-equal), and native's decodes in the port with dense coefficients
    uint32-equal to native's."""
    vol, data, nat = raw32
    raw = ctn.unpack(data)[1] < 0
    assert raw.tolist() == [b in (4, 13) for b in range(18)]
    np.testing.assert_array_equal(raw, ctn.unpack(nat)[1] < 0)
    assert abs(int(data.size) - int(nat.size)) <= max(64, 0.01 * nat.size)
    mine = cvt.decompress(data, device="cpu", engine="device").numpy()
    np.testing.assert_array_equal(mine, cvt.decompress(data, device="cpu",
                                                       engine="host").numpy())
    assert rel_rms(_decode(decoder, data), mine) < TRANSFORM_TOL
    assert rel_rms(mine, vol) < 1e-5
    dense, want = device_dense(nat)
    np.testing.assert_array_equal(dense.view(np.uint32), want.view(np.uint32))


def test_local_128_codec_against_native():
    """compress(block=128^3, use_local_rms=True) on the ramp volume (block
    RMS 10^4 apart): table within rtol 1e-5 of native's, size within
    max(64 B, 1 %), the CI bars within the loud and within the quiet block
    on both engines, and the container decodes under native within 1e-5;
    native's local container decodes in the port with dense coefficients
    uint32-equal to native's."""
    vol = ramp_volume(SHAPE128, 128)
    data, _ = cvt.compress(vol, SCALE, block=(128, 128, 128), use_local_rms=True,
                           device="cpu")
    nat, _ = rle_host.host_compress(vol, SCALE, block=(128, 128, 128), use_local_rms=True)
    hdr, _, blkmf, _ = ctn.unpack(data)
    assert hdr.use_local_rms and hdr.glob_mulfac == 1.0 and blkmf[0] / blkmf[1] < 1e-3
    np.testing.assert_allclose(blkmf, ctn.unpack(nat)[2], rtol=TABLE_RTOL)
    assert abs(int(data.size) - int(nat.size)) <= max(64, 0.01 * nat.size)
    for engine in ("host", "device"):
        out = cvt.decompress(data, device="cpu", engine=engine).numpy()
        for err, snr in quality_by_amplitude(vol, out, 128):
            assert err < 2e-4 and snr > 75.0, (engine, err, snr)
    assert rel_rms(rle_host.host_decompress(data), out) < TRANSFORM_TOL
    dense, want = device_dense(nat)
    np.testing.assert_array_equal(dense.view(np.uint32), want.view(np.uint32))


def test_local_tables_stay_near_the_library_lanes():
    """Recorded difference 11: the port sums each block's squares in f64 in
    its kernel's order (native's non-parity engine), the library in 8 f32
    lanes (CvxCompress.cpp:119-142, native's parity engine).  On the
    benchmark's radial mix at 128^3 (snapshot 0: sin(r / 10) + U(0, 1) / 100)
    the tables differ by up to ~4.7e-6 relative; held: within rtol 1e-5 of
    `host_compress_parity`'s, and each decoded cell within one quantization
    step (the library's 1 / mulfac of its block) of the parity decode."""
    import json

    from cvxbench.harness.generator import Generator
    from cvxbench.harness.spec import traffic_path
    from cvxcompress_tpu_torch.ops import blocks

    with open(traffic_path("rtm-radial")) as f:
        vol = Generator(json.load(f), (128, 128, 128), 2**31 + 77, "cpu").snapshot(0)
    data, _ = cvt.compress(vol, SCALE, use_local_rms=True, device="cpu")
    lib, _ = rle_host.host_compress_parity(vol.numpy(), SCALE, use_local_rms=True)
    want = ctn.unpack(lib)[2]
    np.testing.assert_allclose(ctn.unpack(data)[2], want, rtol=TABLE_RTOL)
    diff = np.abs(cvt.decompress(data, device="cpu").numpy().astype(np.float64)
                  - rle_host.host_decompress_parity(lib))
    per_block = blocks.to_blocks(torch.from_numpy(diff), (32, 32, 32)).reshape(64, -1)
    assert (per_block.amax(1).numpy() < 1.0 / want.astype(np.float64)).all()
