"""The port's 128^3 whole-block path (plain versions, on the CPU) against the
JAX package's K6, K7 and K8 in interpret mode, the oracle and the native
library: tokenize and pack bit-exact (level 1), transforms within 1e-5
(level 2), codec interop (level 3), the decoder at cells = 2^21.  The JAX
kernels run four times in all, shared through module-scoped fixtures."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
torch.set_num_threads(1)  # one thread a process: the suite runs in parallel workers

import jax.numpy as jnp

import cvxcompress_tpu_torch as cvt
from cvxcompress_tpu.ops import codec as jcodec
from cvxcompress_tpu.ops import fused_compress as jfc
from cvxcompress_tpu.ops import fused_inverse as jfi
from cvxcompress_tpu.ops import pack_pallas as pp
from cvxcompress_tpu.oracle import codec as ocodec
from cvxcompress_tpu.oracle import wavelet as owav
from cvxcompress_tpu_torch import container as ctn
from cvxcompress_tpu_torch.ops import (
    blocks, codec, fused_compress, fused_inverse, pack, quant, rle_host,
    tokenize,
)
from cvxcompress_tpu_torch.ops import entropy_decode as ted

from conftest import make_sinusoid_volume, rel_error_and_snr

SHAPE = (128, 128, 256)  # 2 blocks along x, 4.2 M cells
BLOCK = (128, 128, 128)
CELLS = 128 ** 3
MULFAC = 37.5
TRANSFORM_TOL = 1e-5


def rel_rms(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.sqrt(((got - ref) ** 2).mean()) / (np.sqrt((ref**2).mean()) + 1e-30)


def carry_volume():
    """Block 0: the sparse x40 volume of tests/test_fused_compress.py:149;
    block 1: zero but for a small cube, so its coefficients' zero runs
    cross chunks, whole z-slices and end at the block's end."""
    rng = np.random.default_rng(2024)
    vol = (rng.standard_normal(SHAPE) * 40).astype(np.float32)
    vol[rng.random(SHAPE) >= 0.2] = 0.0
    vol[:, :, 128:] = 0.0
    vol[70:78, 40:46, 150:155] = 25.0
    return vol


@pytest.fixture(scope="module")
def jax_k6():
    """JAX K6 (tokenize_desc_block, interpret mode) at mulfac 37.5 and 1."""
    vol = carry_volume()
    out = {}
    for mf in (MULFAC, 1.0):
        fv, desc, cb, sizes, raw, _, _ = jfc.tokenize_desc_block(
            jnp.asarray(vol), jnp.float32(mf), SHAPE, BLOCK, interpret=True)
        out[mf] = dict(fv=np.array(fv).reshape(2, CELLS),
                       desc=np.array(desc).reshape(2, CELLS),
                       cb=np.asarray(cb), sizes=np.asarray(sizes),
                       raw=np.asarray(raw))
    return vol, out


@pytest.fixture(scope="module")
def sinusoid():
    """The 128^3 sinusoid (periods 3) and the port's container of it."""
    vol = make_sinusoid_volume(*SHAPE, periods=3)
    data, ratio = cvt.compress(vol, 1e-2, block=BLOCK, device="cpu")
    return vol, data, ratio


def test_tokenize_stage_exact_against_jax_k6(jax_k6):
    """Level 1: the port's tokenize fed JAX K6's fv gives its desc,
    chunk_bytes, sizes and raw bit for bit, zero runs across chunks, z-slices
    and the block boundary included."""
    _, out = jax_k6
    j = out[MULFAC]
    desc, cb, sizes, raw = tokenize.tokenize_blocks_plain(torch.from_numpy(j["fv"]), 1.0)
    np.testing.assert_array_equal(desc.numpy(), j["desc"])
    np.testing.assert_array_equal(cb.numpy(), j["cb"])
    np.testing.assert_array_equal(sizes.numpy(), j["sizes"])
    np.testing.assert_array_equal(raw.numpy(), j["raw"])
    # the carry case happened: a run enters a z-slice from the one before,
    # and whole z-slices of block 1 hold no token at all
    first = j["desc"][1].reshape(128, -1)[1:, 0]
    assert ((first & 7) == 0).any() and ((first >> 4) > 1).any()
    assert (j["cb"].reshape(2, 128, 128)[1].sum(1) == 0).any()


def test_transform_matches_jax_k6_and_oracle(jax_k6):
    """Level 2: the port's forward at 128^3 is within 1e-5 of JAX K6's fv
    at mulfac 1 and of the oracle cascade per block."""
    vol, out = jax_k6
    coeffs = fused_compress.block_encode(torch.from_numpy(vol), 1.0)[0].numpy()
    assert rel_rms(coeffs, out[1.0]["fv"]) < TRANSFORM_TOL
    for b in range(2):
        ref = owav.forward_3d(vol[:, :, 128 * b: 128 * (b + 1)].astype(np.float64))
        assert rel_rms(coeffs[b], ref.reshape(-1)) < TRANSFORM_TOL


def test_emit_chunks_matches_pack_staging_and_native(jax_k6):
    """Level 1: emit_chunks_plain writes each active chunk's bytes as JAX K7
    (pack_staging, interpret mode) front-packs them, and the whole stream
    equals the native encoder's on the same coefficients."""
    _, out = jax_k6
    j = out[MULFAC]
    cb = j["cb"]
    base = np.cumsum(cb.astype(np.int64)) - cb
    total = int(cb.sum())
    stream = pack.emit_chunks_plain(
        torch.from_numpy(j["fv"]), torch.ones(2), torch.from_numpy(j["desc"]),
        torch.from_numpy(cb), torch.from_numpy(base), total).numpy()

    active = np.flatnonzero(cb)
    # every active chunk of block 1 and the first 1,000 of block 0
    pick = np.concatenate([active[active < 16384][:1000], active[active >= 16384]])
    a = -(-pick.size // pp.GR) * pp.GR
    rows = np.zeros((a, 128), np.float32)
    drows = np.zeros((a, 128), np.int32)
    rows[: pick.size] = j["fv"].reshape(-1, 128)[pick]
    drows[: pick.size] = j["desc"].reshape(-1, 128)[pick]
    packed = np.asarray(pp.pack_staging(jnp.asarray(rows), jnp.asarray(drows),
                                        interpret=True)).astype(np.uint8)
    for i, c in enumerate(pick):
        np.testing.assert_array_equal(stream[base[c]: base[c] + cb[c]],
                                      packed[i, : cb[c]], err_msg=f"chunk {c}")

    streams, _, nraw = rle_host.encode_payloads(j["fv"], 1.0)
    native = np.concatenate([s for s, r in zip(streams, nraw) if not r])
    np.testing.assert_array_equal(stream, native)


def test_emit_chunks_of_port_coefficients_equals_native(sinusoid):
    """The stream of the port's own (unscaled) coefficients at the real
    mulfac equals the native encoder's, block by block."""
    vol, _, _ = sinusoid
    mulfac = quant.global_mulfac(vol, 1e-2)
    coeffs, desc, cb, sizes, raw, mulfacs = fused_compress.block_encode(
        torch.from_numpy(vol), mulfac)
    assert (mulfacs == mulfac).all()
    base = torch.cumsum(cb.long(), 0) - cb.long()
    stream = pack.emit_chunks(coeffs, mulfacs, desc, cb, base, int(cb.sum()))
    streams, nsizes, nraw = rle_host.encode_payloads(coeffs.numpy(), mulfac)
    np.testing.assert_array_equal(nsizes, sizes.numpy())
    np.testing.assert_array_equal(nraw, raw.numpy())
    np.testing.assert_array_equal(stream.numpy(), np.concatenate(streams))


def test_inverse_matches_jax_k8():
    """Level 2: block_fused_inverse (plain) within 1e-5 of JAX K8 in
    interpret mode on the same coefficients (as JAX's volume-order plane)."""
    rng = np.random.default_rng(8)
    c = rng.standard_normal((2, CELLS)).astype(np.float32)
    c.reshape(-1, 128)[rng.random(c.size // 128) < 0.7] = 0.0
    mine = fused_inverse.block_fused_inverse(
        torch.from_numpy(c).view(-1, 128), SHAPE).numpy()
    plane = blocks.from_blocks(torch.from_numpy(c).view(2, 128, 128, 128), SHAPE,
                               BLOCK).numpy().reshape(-1, SHAPE[2])
    ref = np.asarray(jfi.block_fused_inverse(jnp.asarray(plane), SHAPE, BLOCK,
                                             interpret=True))
    assert mine.shape == ref.shape == SHAPE
    assert rel_rms(mine, ref) < TRANSFORM_TOL


def test_roundtrip_sinusoid_quality_bars(sinusoid):
    """Level 3: the CI bars at 128^3 (tests/test_fused_compress.py:60-78),
    on both engines."""
    vol, data, ratio = sinusoid
    assert ctn.unpack(data)[0].bx == 128
    for engine in ("host", "device"):
        out = cvt.decompress(data, device="cpu", engine=engine).numpy()
        err, snr = rel_error_and_snr(vol, out)
        assert err < 2e-4 and snr > 75.0, (engine, err, snr)
    assert ratio > 1000.0


def test_class_surface_at_128(sinusoid):
    """CvxCompress.Compress(scale, vol, 128, 128, 128) takes the 128^3 path:
    the same container as `compress`, and Decompress_Inplace fills it."""
    vol, data, _ = sinusoid
    c = cvt.CvxCompress(device="cpu")
    mine, ratio = c.Compress(1e-2, vol, 128, 128, 128)
    np.testing.assert_array_equal(mine, data)
    assert ratio == pytest.approx(vol.size * 4 / data.size)
    out = np.zeros(SHAPE, np.float32)
    c.Decompress_Inplace(out, mine)
    assert rel_error_and_snr(vol, out)[0] < 2e-4


@pytest.mark.parametrize("decoder", ["oracle", "jax", "native"])
def test_port_container_decodes_elsewhere(sinusoid, decoder):
    vol, data, _ = sinusoid
    mine = cvt.decompress(data, device="cpu").numpy()
    if decoder == "oracle":
        other = ocodec.decompress(data)
    elif decoder == "jax":
        other = jcodec.decompress(data)
    else:
        other = rle_host.host_decompress(data)
    assert other.shape == mine.shape == vol.shape
    assert rel_rms(mine, other) < TRANSFORM_TOL


@pytest.mark.parametrize("producer", ["jax", "native"])
def test_port_decodes_foreign_containers(sinusoid, producer):
    vol, _, _ = sinusoid
    if producer == "jax":
        data, _ = jcodec.compress(vol, 1e-2, block=BLOCK)
        ref = jcodec.decompress(data)
    else:
        data, _ = rle_host.host_compress(vol, 1e-2, block=BLOCK)
        ref = rle_host.host_decompress(data)
    for engine in ("host", "device"):
        mine = cvt.decompress(data, device="cpu", engine=engine).numpy()
        assert rel_rms(mine, ref) < TRANSFORM_TOL


@pytest.mark.parametrize("ref", ["oracle", "native"])
def test_size_close_to_reference(sinusoid, ref):
    vol, data, _ = sinusoid
    if ref == "oracle":
        other, _ = ocodec.compress(vol, 1e-2, block=BLOCK)
    else:
        other, _ = rle_host.host_compress(vol, 1e-2, block=BLOCK)
    assert abs(int(data.size) - int(other.size)) <= max(64, 0.01 * other.size)


@pytest.mark.parametrize("case", ["noise_1e-3", "mixed_1e-8"])
def test_raw_fallback(case):
    """x1000 noise at 1e-3 (tests/test_fused_compress.py:81-94: every token
    class, no raw block at 128^3) and, at 1e-8, the same noise in block 0
    beside a quiet block 1: block 0 falls back to raw.  Both decode within
    5e-3, the device and host engines bit-equal."""
    rng = np.random.default_rng(81)
    vol = (rng.standard_normal(SHAPE) * 1000).astype(np.float32)
    scale = 1e-3
    if case == "mixed_1e-8":
        vol[:, :, 128:] *= 1e-6
        scale = 1e-8
    data, _ = cvt.compress(vol, scale, block=BLOCK, device="cpu")
    raw = ctn.unpack(data)[1] < 0
    assert raw.tolist() == ([True, False] if case == "mixed_1e-8" else [False, False])
    dev = cvt.decompress(data, device="cpu", engine="device").numpy()
    host = cvt.decompress(data, device="cpu", engine="host").numpy()
    np.testing.assert_array_equal(dev, host)
    err, _ = rel_error_and_snr(vol, dev)
    assert err < 5e-3, err
    assert rel_rms(rle_host.host_decompress(data), dev) < TRANSFORM_TOL


def test_decoder_at_two_million_cells():
    """Plan, parse, chase and emit (plain versions) at cells = 2^21 give the
    native decoder's dense coefficients as uint32, with chains of tens of
    thousands of subsegments (N(0,1) at scale 1: ~5.6:1)."""
    vol = np.random.default_rng(21).standard_normal(BLOCK).astype(np.float32)
    data, _ = rle_host.host_compress(vol, 1.0, block=BLOCK)
    p = ted.plan(data)
    b = ted.upload(p, "cpu")
    nsub = b["sub_block"].numel()
    assert p["cells"] == CELLS
    assert np.diff(np.append(p["starts"], nsub)).max() > 10_000  # one chain
    M, P = ted.parse_maps(b["stream"], nsub, CELLS)
    assert int(P.max()) < 2 ** 31 - 1
    e32, c32 = ted.chase(P, b["sub_reset"], b["starts"], CELLS)
    assert int(c32.max()) < CELLS
    dense = ted.emit(b["stream"], M, e32, c32, b["sub_block"], b["scalefac"],
                     1, CELLS)
    hdr, blkoffs, _, pbase = ctn.unpack(data)
    nat = rle_host.decode_payloads(data[pbase:], blkoffs, hdr.glob_mulfac, CELLS)
    np.testing.assert_array_equal(dense.numpy().view(np.uint32), nat.view(np.uint32))


def test_gates():
    """The 128^3 kernels take 128^3 blocks over dims that are multiples of
    128 only; 128^3 over other dims and 64^3 take the stripe route instead
    and round-trip, in compress and in decompress of native's containers."""
    assert fused_compress.fused_path_ok((128, 128, 256), BLOCK)
    assert not fused_compress.fused_path_ok((128, 128, 200), BLOCK)
    assert not fused_compress.fused_path_ok((128, 128, 256), (128, 128, 64))
    vol = make_sinusoid_volume(128, 128, 200, periods=3)
    assert codec.route(vol.shape, BLOCK) == "stripe"
    assert codec.route(vol.shape, (64, 64, 64)) == "stripe"
    for block in (BLOCK, (64, 64, 64)):
        data, _ = cvt.compress(vol, 1e-2, block=block, device="cpu")
        out = cvt.decompress(data, device="cpu").numpy()
        assert rel_rms(out, rle_host.host_decompress(data)) < TRANSFORM_TOL
        ndata, _ = rle_host.host_compress(vol, 1e-2, block=block)
        out = cvt.decompress(ndata, device="cpu").numpy()
        assert rel_rms(out, rle_host.host_decompress(ndata)) < TRANSFORM_TOL
    with pytest.raises(ValueError, match="multiples of 128"):
        fused_compress.block_encode(torch.from_numpy(vol), 1.0)
