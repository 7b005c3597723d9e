"""The port's device entropy decoder (plain versions, on the CPU) against
the JAX package's: the plan, the parse maps, the chase (and K18 in
interpret mode), the dense decode (and K4 in interpret mode), the engines
and corrupt or degenerate containers.  Small shapes, few JAX compiles."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
torch.set_num_threads(1)  # one thread a process: the suite runs in parallel workers

import jax
import jax.numpy as jnp

import cvxcompress_tpu_torch as cvt
from cvxcompress_tpu import container as jctn
from cvxcompress_tpu.ops import codec as jcodec
from cvxcompress_tpu.ops import entropy_decode as ed
from cvxcompress_tpu.oracle import codec as ocodec
from cvxcompress_tpu.oracle import rle as orle
from cvxcompress_tpu_torch import container as ctn
from cvxcompress_tpu_torch.ops import codec, rle_host
from cvxcompress_tpu_torch.ops import entropy_decode as ted

from conftest import make_radial_volume, make_sinusoid_volume, rel_error_and_snr

TRANSFORM_TOL = 1e-5
# the JAX package's parse, compiled once per shape (run op by op it takes
# tens of seconds a call)
parse_stages = jax.jit(ed._parse_stages, static_argnums=(2, 3))


def rel_rms(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.sqrt(((got - ref) ** 2).mean()) / (np.sqrt((ref**2).mean()) + 1e-30)


def reorder_payload(data, seed):
    """The same container with its block payloads in a shuffled order (as
    the reference's OpenMP threads complete them, CvxCompress.cpp:370-374)."""
    hdr, blkoffs, _, pbase = ctn.unpack(data)
    offs = blkoffs & ~ctn.RAW_FLAG
    order = np.argsort(offs, kind="stable")
    ends = np.empty_like(offs)
    ends[order[:-1]] = offs[order[1:]]
    ends[order[-1]] = data.size - pbase - ctn.SLACK_BYTES
    perm = np.random.default_rng(seed).permutation(offs.size)
    payload = data[pbase:]
    parts, new = [], np.empty_like(offs)
    pos = 0
    for b in perm:
        parts.append(payload[offs[b]:ends[b]])
        new[b] = pos
        pos += ends[b] - offs[b]
    new = np.where(blkoffs < 0, new | ctn.RAW_FLAG, new)
    out = np.concatenate([data[:pbase], *parts, np.zeros(ctn.SLACK_BYTES, np.uint8)])
    out[32: 32 + 8 * offs.size] = new.view(np.uint8)
    return out


def _container(kind):
    rng = np.random.default_rng(3)
    if kind == "sinusoid":
        return cvt.compress(make_sinusoid_volume(64, 64, 64, periods=3), 1e-2,
                            device="cpu")[0]
    if kind == "radial":  # unaligned on every axis: edge blocks
        return cvt.compress(make_radial_volume(40, 50, 70), 1e-2, device="cpu")[0]
    if kind == "raw_noise":
        return cvt.compress(rng.standard_normal((40, 50, 70)).astype(np.float32),
                            1e-9, device="cpu")[0]
    if kind == "oracle":
        return ocodec.compress(make_radial_volume(40, 50, 70), 1e-2)[0]
    if kind == "native_shuffled":
        data, _ = rle_host.host_compress(make_radial_volume(40, 50, 70), 1e-2)
        return reorder_payload(data, seed=1)
    if kind == "multiseg":  # noise at scale 0.1 (~4:1): blocks of many segments
        return rle_host.host_compress(
            rng.standard_normal((32, 32, 64)).astype(np.float32), 0.1,
            block=(16, 16, 16))[0]
    raise ValueError(kind)


CONTAINERS = ["sinusoid", "radial", "raw_noise", "oracle", "native_shuffled"]


@pytest.fixture(scope="module")
def container():
    """_container(kind), each kind built once for the module's tests (which
    only read it)."""
    cache = {}

    def get(kind):
        if kind not in cache:
            cache[kind] = _container(kind)
        return cache[kind]

    return get


def decode_dense(data):
    """The port's device engine stages on the CPU: dense (nnn, cells)."""
    p = ted.plan(data)
    assert p is not None
    b = ted.upload(p, "cpu")
    nsub, cells = b["sub_block"].numel(), p["cells"]
    M, P = ted.parse_maps(b["stream"], nsub, cells)
    e32, c32 = ted.chase(P, b["sub_reset"], b["starts"], cells)
    dense = ted.emit(b["stream"], M, e32, c32, b["sub_block"], b["scalefac"],
                     p["hdr"].grid[3], cells)
    return ted.overlay_raw(dense, b["raw_rows"], b["raw_ids"]).numpy()


def jax_dense(data):
    """ed.decode_to_blocks + the raw overlay, block-major."""
    p = ed.plan(data)
    hdr = p["hdr"]
    out = np.array(ed.decode_to_blocks(
        jnp.asarray(p["segs"]), jnp.asarray(p["sub_block"]),
        jnp.asarray(p["sub_reset"]), jnp.asarray(p["scalefac"]),
        hdr.grid[3], (hdr.bx, hdr.by, hdr.bz), p["segs"].shape[0],
    ))
    if p["raw_ids"].size:
        out[p["raw_ids"]] = p["raw_rows"]
    return out


def host_dense(data):
    hdr, blkoffs, blkmf, pbase = jctn.unpack(data)
    return jcodec._decode_payloads_host(data, hdr, blkoffs, blkmf, pbase)


def assert_dense_bit_exact(data):
    got = decode_dense(data)
    for want in (jax_dense(data), host_dense(data)):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# (a) the plan ------------------------------------------------------------


@pytest.mark.parametrize("kind", CONTAINERS)
def test_plan_matches_jax(container, kind):
    data = container(kind)
    mine, ref = ted.plan(data), ed.plan(data)
    for k in ("segs", "sub_block", "sub_reset", "raw_ids"):
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)
    # one scalefac per block here, one per subsegment (or one in all) there
    live = mine["sub_block"] < mine["hdr"].grid[3]
    np.testing.assert_array_equal(
        mine["scalefac"][mine["sub_block"][live]],
        np.broadcast_to(ref["scalefac"], live.shape)[live])
    assert mine["segs"].dtype == ref["segs"].dtype == np.uint8
    assert (mine["raw_rows"] is None) == (ref["raw_rows"] is None)
    if ref["raw_rows"] is not None:
        np.testing.assert_array_equal(mine["raw_rows"].view(np.uint32),
                                      ref["raw_rows"].view(np.uint32))
    np.testing.assert_array_equal(mine["starts"], np.flatnonzero(ref["sub_reset"]))
    o, _, _ = mine["layout"]["stream"]
    tail = mine["blob"][o + mine["segs"].size: o + mine["segs"].size + ted.PAD]
    assert tail.size == ted.PAD and not tail.any()
    if kind == "raw_noise":
        assert mine["raw_ids"].size > 0
    if kind == "native_shuffled":
        _, blkoffs, _, _ = ctn.unpack(data)
        assert not (np.diff(blkoffs & ~ctn.RAW_FLAG) > 0).all()


# (b) parse maps + chase against _parse_stages ------------------------------


@pytest.mark.parametrize("kind", ["radial", "multiseg"])
def test_parse_and_chase_match_parse_stages(container, kind):
    data = container(kind)
    p = ted.plan(data)
    b = ted.upload(p, "cpu")
    nsub, cells = b["sub_block"].numel(), p["cells"]
    M, P = ted.parse_maps_plain(b["stream"], nsub, cells)
    e32, c32 = ted.chase_plain(P, b["sub_reset"], cells)
    jM, je32, jc32, _, _, _ = parse_stages(
        jnp.asarray(p["segs"]), jnp.asarray(p["sub_reset"]), cells)
    np.testing.assert_array_equal(M.numpy(), np.asarray(jM))
    np.testing.assert_array_equal(e32.numpy(), np.asarray(je32))
    np.testing.assert_array_equal(c32.numpy(), np.asarray(jc32))
    se, sc = ted.chase_sequential(P.numpy(), p["sub_reset"], cells)
    np.testing.assert_array_equal(se, e32.numpy())
    np.testing.assert_array_equal(sc, c32.numpy())
    if kind == "multiseg":
        assert (np.bincount(p["sub_block"]) > ted.SPS).any()


# (c) the chase against K18 in interpret mode ------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_chase_matches_chase_pallas_interpret(seed):
    import jax.experimental.pallas as pl

    rng = np.random.default_rng(seed)
    nsub, cap = 192, 4096
    T = rng.integers(0, ted.E, (nsub, ted.E)).astype(np.int32)
    NV = rng.integers(0, 600, (nsub, ted.E)).astype(np.int32)
    reset = rng.random(nsub) < 0.15
    reset[0] = True
    P = torch.from_numpy(NV * 32 + T)
    e32, c32 = ted.chase(P, torch.from_numpy(reset),
                         torch.from_numpy(np.flatnonzero(reset).astype(np.int32)), cap)
    se, sc = ted.chase_sequential(P.numpy(), reset, cap)
    np.testing.assert_array_equal(e32.numpy(), se)
    np.testing.assert_array_equal(c32.numpy(), sc)

    orig = pl.pallas_call

    def patched(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    pl.pallas_call = patched
    try:
        ke, kc = ed._chase_pallas(jnp.asarray(T), jnp.asarray(NV),
                                  jnp.asarray(reset), cap)
    finally:
        pl.pallas_call = orig
    np.testing.assert_array_equal(np.asarray(ke), se)
    np.testing.assert_array_equal(np.asarray(kc), sc)


# (d) the dense decode, bit-exact ------------------------------------------


@pytest.mark.parametrize("scale", [1e-4, 1e-2, 1e-1, 1.0])
def test_dense_decode_token_classes(scale):
    vol = np.random.default_rng(5).standard_normal((32, 32, 64)).astype(np.float32)
    data, _ = rle_host.host_compress(vol, scale, block=(16, 16, 16))
    assert_dense_bit_exact(data)


def test_dense_decode_f32_escapes_and_raw():
    """x1e8 values: VLESC4 escapes, and raw-fallback blocks at 1e-9."""
    big = (np.random.default_rng(6).standard_normal((16, 16, 32)) * 1e8).astype(np.float32)
    data, _ = rle_host.host_compress(big, 1e-6, block=(8, 8, 8))
    p = ted.plan(data)
    raw = p["segs"].reshape(-1)
    assert (raw == 0x80).any()
    assert_dense_bit_exact(data)
    data, _ = rle_host.host_compress(big, 1e-9, block=(8, 8, 8))
    assert (ctn.unpack(data)[1] < 0).any()
    assert_dense_bit_exact(data)


def test_dense_decode_multisegment_blocks(container):
    assert_dense_bit_exact(container("multiseg"))


def test_dense_decode_zero_and_long_runs():
    z = np.zeros((64, 64, 64), np.float32)
    z[0, 0, 0] = 5.0
    z[63, 63, 63] = -3.0
    assert_dense_bit_exact(rle_host.host_compress(z, 1e-2)[0])
    assert_dense_bit_exact(
        rle_host.host_compress(np.zeros((32, 32, 32), np.float32), 1e-2,
                               block=(16, 16, 16))[0])


def _straddle_streams(cells):
    """Hand-built streams where every token class straddles the 32-byte
    subsegment boundaries at every feasible offset
    (tests/test_entropy_decode.py:170-234)."""
    rng = np.random.default_rng(7)

    def vl2(v):
        return bytes([0x83]) + int(v & 0xFFFF).to_bytes(2, "little")

    def vl3(v):
        return bytes([0x81]) + int(v & 0xFFFFFF).to_bytes(3, "little")

    def vl4(f):
        return bytes([0x80]) + np.float32(f).tobytes()

    def vl2x8(vals):
        return bytes([0x82]) + np.asarray(vals, "<i2").tobytes()

    def vl3x8(vals):
        return bytes([0x7E]) + b"".join(
            int(v & 0xFFFFFF).to_bytes(3, "little") for v in vals)

    def rle1(run):
        return bytes([0x7F, run])

    def rle3(run):
        return bytes([0x7D]) + int(run).to_bytes(3, "little")

    cases = []
    toks = [vl3x8(rng.integers(-(1 << 22), 1 << 22, 8)) for _ in range(32)]
    toks.append(rle3(cells - 8 * len(toks)))
    cases.append(b"".join(toks))
    toks = [vl2x8(rng.integers(-30000, 30000, 8)) for _ in range(30)]
    toks.append(rle3(cells - 8 * len(toks)))
    cases.append(b"".join(toks))
    toks, emitted, k = [], 0, 0
    while emitted < cells - 40:
        toks.append([vl2(200 + k), vl3(70000 + k), vl4(3e9 + k * 1e6),
                     rle1(3), bytes([k % 120 + 1])][k % 5])
        emitted += [1, 1, 1, 3, 1][k % 5]
        k += 1
    toks.append(rle3(cells - emitted))
    cases.append(b"".join(toks))
    toks, emitted = [], 0
    for run in (31, 32, 33, 255, 1, 2):
        toks += [bytes([5]), rle1(run)]
        emitted += 1 + run
    toks += [vl3(300), rle3(cells - emitted - 1)]
    cases.append(b"".join(toks))
    return cases


@pytest.mark.parametrize("case", range(4))
def test_dense_decode_boundary_straddles(case):
    cells = 512
    payload = _straddle_streams(cells)[case]
    want, used = orle.decode(2.5, payload + b"\x00" * 8, cells)
    assert used == len(payload)
    hdr = jctn.Header(8, 8, 8, 8, 8, 8, np.float32(2.5), False)
    data = jctn.pack(hdr, [np.frombuffer(payload, np.uint8)], [False])
    assert_dense_bit_exact(data)
    np.testing.assert_array_equal(decode_dense(data)[0].view(np.uint32),
                                  want.view(np.uint32))


# (e) K4 in interpret mode -------------------------------------------------


def test_emit_matches_emit_kernel_interpret():
    """ed._emit_values_pallas (interpret mode), scattered into the padded
    volume plane, equals the port's dense decode in volume order
    (tests/test_entropy_decode.py:289-351)."""
    from cvxcompress_tpu.ops import wavelet

    rng = np.random.default_rng(11)
    shape, block = (64, 96, 96), (32, 32, 32)
    vol = (rng.standard_normal(shape) * 300).astype(np.float32)
    vol[rng.random(shape) >= 0.4] = 0.0
    data, _ = jcodec.compress(vol, 1e-2, block=block)
    p = ed.plan(data)
    cells = 32 ** 3
    M, e32, c32, vals_s, sv, Bx = parse_stages(
        jnp.asarray(p["segs"]), jnp.asarray(p["sub_reset"]), cells, False)
    kval, kidx, total = ed._emit_values_pallas(
        M, e32, c32, vals_s, sv, Bx, jnp.asarray(p["scalefac"]),
        jnp.asarray(p["sub_block"]), shape, block, interpret=True)
    kval, kidx = np.asarray(kval).reshape(-1), np.asarray(kidx).reshape(-1)
    live = kidx < total
    nbz, nby, nbx = 2, 3, 3
    nxp = wavelet.padded_nbx(nbx, 32) * 32
    plane = np.zeros(total, np.float32)
    plane[kidx[live]] = kval[live]
    plane = plane.reshape(nbz * 32 * nby * 32, nxp)

    dense = decode_dense(data)
    mine = dense.reshape(nbz, nby, nbx, 32, 32, 32).transpose(0, 3, 1, 4, 2, 5)
    mine = mine.reshape(nbz * 32 * nby * 32, nbx * 32)
    np.testing.assert_array_equal(plane[:, nbx * 32:], 0.0)
    np.testing.assert_array_equal(plane[:, : nbx * 32].view(np.uint32),
                                  mine.view(np.uint32))


# (f) the engines ----------------------------------------------------------


def test_device_engine_matches_host_engine_and_jax():
    vol = make_sinusoid_volume(96, 64, 64, periods=3)
    data, ratio = cvt.compress(vol, 1e-2, device="cpu")
    dev = cvt.decompress(data, device="cpu", engine="device").numpy()
    host = cvt.decompress(data, device="cpu", engine="host").numpy()
    assert rel_rms(dev, host) < TRANSFORM_TOL
    assert rel_rms(dev, jcodec.decompress(data, engine="device")) < TRANSFORM_TOL
    err, snr = rel_error_and_snr(vol, dev)
    assert err < 2e-4 and snr > 75.0 and ratio > 500.0


@pytest.mark.parametrize("kind", ["oracle", "native_shuffled", "raw_noise"])
def test_device_engine_decodes_foreign_containers(container, kind):
    data = container(kind)
    dev = cvt.decompress(data, device="cpu", engine="device").numpy()
    np.testing.assert_array_equal(
        dev, cvt.decompress(data, device="cpu", engine="host").numpy())


# (g) corrupt payloads -----------------------------------------------------


@pytest.fixture(scope="module")
def clean_radial():
    """A native container of a (64, 64, 96) radial volume and its dense
    decode, shared by the corrupt-payload cases."""
    data = rle_host.host_compress(make_radial_volume(64, 64, 96), 1e-2)[0]
    return data, decode_dense(data)


@pytest.mark.parametrize("seed", range(3))
def test_corrupt_payload_never_crashes_and_stays_in_its_blocks(clean_radial, seed):
    """Bit-flipped payload bytes decode to something without raising, and
    a flipped block's chain writes nowhere but in its own block: every block
    whose payload holds no flip decodes exactly as before."""
    data, clean = clean_radial
    _, blkoffs, _, pbase = ctn.unpack(data)
    r = np.random.default_rng(seed)
    bad = data.copy()
    flips = r.integers(pbase, data.size - 8, 6)
    bad[flips] ^= r.integers(1, 255, 6).astype(np.uint8)
    got = decode_dense(bad)  # must not raise
    assert got.shape == clean.shape
    offs = np.append(blkoffs & ~ctn.RAW_FLAG, data.size - pbase) + pbase
    hit = np.zeros(blkoffs.size, bool)
    hit[np.searchsorted(offs, flips, side="right") - 1] = True
    assert (~hit).any()
    np.testing.assert_array_equal(got[~hit].view(np.uint32),
                                  clean[~hit].view(np.uint32))
    vol = cvt.decompress(bad, device="cpu", engine="device")
    assert tuple(vol.shape) == (64, 64, 96)


# (h) a degenerate container -----------------------------------------------


def test_degenerate_container_raises_on_device_decodes_on_auto(container):
    data = container("radial").copy()
    offs = data[32: 32 + 8 * 12].view(np.int64)
    offs[1] = offs[0]  # two blocks share one payload
    cvt.utils.io.validate(data)
    assert ted.plan(data) is None and ed.plan(data) is None
    assert codec.decompress_device(data, "cpu") is None
    with pytest.raises(ValueError, match="device engine"):
        cvt.decompress(data, device="cpu", engine="device")
    out = cvt.decompress(data, device="cpu", engine="auto").numpy()
    assert rel_rms(out, jcodec.decompress(data, engine="host")) < TRANSFORM_TOL
    with pytest.raises(ValueError, match="engine"):
        cvt.decompress(data, device="cpu", engine="gpu")


# the class surface --------------------------------------------------------


def test_class_surface_block_limits_and_inplace():
    c = cvt.CvxCompress(device="cpu")
    assert (c.Min_BX(), c.Max_BX(), c.Min_BY(), c.Max_BY(), c.Min_BZ(),
            c.Max_BZ()) == (8, 256, 8, 256, 8, 256)
    assert cvt.CvxCompress.Is_Valid_Block_Size(32, 32, 32)
    assert cvt.CvxCompress.Is_Valid_Block_Size(16, 16, 1)
    assert not cvt.CvxCompress.Is_Valid_Block_Size(24, 32, 32)
    vol = make_radial_volume(40, 50, 70)
    data, _ = c.Compress(1e-2, vol, 32, 32, 32)
    ref = c.Decompress(data).numpy()
    arr = np.zeros((40, 50, 70), np.float32)
    assert c.Decompress_Inplace(arr, data) is arr
    np.testing.assert_array_equal(arr, ref)
    t = torch.zeros((40, 50, 70))
    cvt.CvxCompress(device="cpu", engine="device").Decompress_Inplace(t, data)
    assert rel_rms(t.numpy(), ref) < TRANSFORM_TOL
    with pytest.raises(ValueError, match="shape"):
        c.Decompress_Inplace(np.zeros((40, 50, 71), np.float32), data)
