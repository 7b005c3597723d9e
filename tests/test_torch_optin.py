"""The port's opt-in encode routes, selected by the JAX package's switches
(`CVX_FUSED_W=1`, `CVX_STRIPE=patch`, `CVX_FUSED_COMPACT=1`; ops/geometry.py),
on the CPU: each kernel's plain version against the JAX kernel it ports in
interpret mode (K16a + K16b, K17, K14, and K15 held to `tokenize_stripe`),
every switch through compress -> decompress across the oracle, native and
JAX decoders, and the TF32 and current-device faults.  One interpret-mode
JAX call per case at most, small shapes."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
torch.set_num_threads(1)  # one thread a process: the suite runs in parallel workers

import jax.experimental.pallas as pl
import jax.numpy as jnp

import cvxcompress_tpu_torch as cvt
from cvxcompress_tpu.ops import codec as jcodec
from cvxcompress_tpu.ops import fused_compress as jfc
from cvxcompress_tpu.ops import rle_device as jrd
from cvxcompress_tpu.ops import tokenize_pallas as tp
from cvxcompress_tpu.ops import wavelet as jwav
from cvxcompress_tpu.oracle import codec as ocodec
from cvxcompress_tpu_torch.ops import (
    blocks, codec, fused_compress, geometry, pack, rle_host, tokenize,
)

from conftest import make_sinusoid_volume, rel_error_and_snr

TRANSFORM_TOL = 1e-5
SWITCHES = ("CVX_FUSED_COMPACT", "CVX_STRIPE", "CVX_FUSED_W", "CVX_VOLUME_COMPRESS",
            "CVX_STRIPE_FUSED")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rel_rms(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.sqrt(((got - ref) ** 2).mean()) / (np.sqrt((ref**2).mean()) + 1e-30)


@pytest.fixture
def clean_env(monkeypatch):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def interpret_kernels(monkeypatch):
    """Every pallas_call in interpret mode, as the JAX package's CPU tests
    run its kernels (tests/test_jax_codec.py `_interpret_kernels`)."""
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", patched)
    orig_dot3 = tp.mxu_dot3
    monkeypatch.setattr(tp, "mxu_dot3", lambda a, b, split: orig_dot3(a, b, False))


# -- the gates and the switches -------------------------------------------


def test_gates_match_jax():
    """`patch_ok` is the JAX `stripe_path_ok`, `compact_ok` the JAX gate of
    K14 (`codec.py:624-627`), TR the JAX tile."""
    assert geometry.TR == tp.TR
    sizes = (8, 16, 32, 64, 128, 256)
    for bx in sizes:
        for by in sizes:
            for bz in (1, *sizes):
                assert geometry.patch_ok((bx, by, bz)) == tp.stripe_path_ok(
                    (64, 64, 64), (bx, by, bz)), (bx, by, bz)
    for shape, block in (((352, 416, 320), (32, 32, 32)), ((64, 64, 64), (32, 32, 32)),
                         ((64, 64, 32), (32, 32, 32)), ((64, 64, 64), (8, 8, 1)),
                         ((384, 384, 384), (128, 128, 128)), ((8, 8, 8), (8, 8, 8))):
        cells = block[0] * block[1] * block[2]
        nchunks = np.prod(blocks.grid_shape(shape, block)) * cells // 128
        want = min(128, cells) == tp.LANES and nchunks >= 2 * tp.TR
        assert geometry.compact_ok(shape, block) == want, (shape, block)


@pytest.mark.parametrize("env,block,local,want", [
    ({}, (128, 128, 128), False, "block128"),
    ({"CVX_FUSED_W": "block"}, (128, 128, 128), True, "block128"),
    ({"CVX_FUSED_W": "1"}, (128, 128, 128), False, "block128_w"),
    ({"CVX_FUSED_W": "1"}, (128, 128, 128), True, "stripe"),
    ({"CVX_FUSED_W": "0"}, (128, 128, 128), False, "stripe"),
    ({"CVX_FUSED_W": "0", "CVX_VOLUME_COMPRESS": "1"}, (128, 128, 128), False, "stripe"),
    ({"CVX_FUSED_W": "1"}, (32, 32, 32), False, "fused32"),
    ({"CVX_STRIPE": "patch"}, (32, 32, 32), False, "patch"),
    ({"CVX_STRIPE": "patch"}, (16, 16, 16), True, "patch"),
    ({"CVX_STRIPE": "patch"}, (8, 8, 8), False, "stripe"),
    ({"CVX_STRIPE": "patch"}, (128, 128, 128), False, "block128"),
    ({"CVX_STRIPE": "seg"}, (16, 16, 16), False, "stripe_fused"),
    ({"CVX_FUSED_COMPACT": "1"}, (32, 32, 32), True, "compact"),
    ({"CVX_FUSED_COMPACT": "1", "CVX_STRIPE": "patch"}, (32, 32, 32), False, "compact"),
    ({"CVX_FUSED_COMPACT": "1", "CVX_FUSED_W": "1"}, (128, 128, 128), False, "compact"),
    ({"CVX_FUSED_COMPACT": "1"}, (8, 8, 1), False, "stripe"),
])
def test_switches_select_routes(clean_env, env, block, local, want):
    """The switches' values and precedence (`codec.py:621-627`, then
    `:341-421`) at a (256, 256, 256) volume; decode never reads them."""
    shape = (256, 256, 256)
    geometry_route = codec.route(shape, block)
    for k, v in env.items():
        clean_env.setenv(k, v)
    assert codec.encode_route(shape, block, local) == want
    assert codec.route(shape, block) == geometry_route  # what decode reads
    if "CVX_FUSED_COMPACT" in env and block == (32, 32, 32):  # 1,024 chunks
        assert codec.encode_route((64, 64, 32), block, local) != "compact"


# -- K16a + K16b: the x,z | y encode ----------------------------------------

SHAPE_B = (128, 128, 256)  # 2 blocks along x
BLOCK_B = (128, 128, 128)
MULFAC = 37.5


@pytest.fixture(scope="module")
def jax_k16():
    """JAX K16a + K16b (interpret mode) on a sparse x40 volume: the x,z
    plane, then the scaled chunk-major fv and descriptors."""
    rng = np.random.default_rng(16)
    vol = (rng.standard_normal(SHAPE_B) * 40).astype(np.float32)
    vol[rng.random(SHAPE_B) >= 0.2] = 0.0
    vol[:, :, 128:] = 0.0  # block 1: a small cube, zero runs across slices
    vol[70:78, 40:46, 150:155] = 25.0
    plane = jfc.forward_xz(jnp.asarray(vol), SHAPE_B, interpret=True)
    fv, desc = jfc.tokenize_fused_y(plane, jnp.float32(MULFAC), SHAPE_B, interpret=True)
    return vol, np.array(plane), np.array(fv).reshape(2, -1), np.array(desc).reshape(2, -1)


def test_k16_plain_matches_jax(jax_k16):
    """`fwd_xz_plain` within 1e-5 of K16a's plane; `encode_y_plain`'s
    scaled coefficients within 1e-5 of K16b's fv; the port's tokenize of
    K16b's fv gives its descriptors bit for bit."""
    vol, plane, fv, desc = jax_k16
    mine = fused_compress.fwd_xz_plain(torch.from_numpy(vol))
    assert rel_rms(mine.numpy(), plane) < TRANSFORM_TOL
    coeffs, *_ = fused_compress.encode_y_plain(torch.from_numpy(plane), MULFAC)
    assert rel_rms(tokenize.scaled(coeffs, MULFAC).numpy(), fv) < TRANSFORM_TOL
    d, cb, sizes, raw = tokenize.tokenize_blocks_plain(torch.from_numpy(fv), 1.0)
    np.testing.assert_array_equal(d.numpy(), desc)
    assert not raw.any() and (cb.view(2, -1)[1] == 0).any()


def test_block_encode_w_agrees_with_block_encode(jax_k16):
    """x,z | y and z | x,y (plain versions) give the same outputs' shapes
    and coefficients within 1e-5 (bit-identity is held on the CPU by
    tests/test_torch_cascade.py and on the card by tests/test_torch_cuda.py)."""
    vol = torch.from_numpy(jax_k16[0])
    a = fused_compress.block_encode_w(vol, MULFAC)
    b = fused_compress.block_encode(vol, MULFAC)
    assert rel_rms(a[0].numpy(), b[0].numpy()) < TRANSFORM_TOL
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype


# -- K17: the patch gather ---------------------------------------------------


@pytest.mark.parametrize("block,shape", [
    ((16, 16, 16), (32, 48, 80)), ((32, 32, 32), (64, 64, 96)),
    ((64, 64, 64), (64, 128, 192)),
], ids=["16c", "32c", "64c"])
def test_k17_plain_matches_jax(monkeypatch, block, shape):
    """`patch_extract_plain`'s rows and descriptors equal the JAX
    package's patch gather + K17 (`rle_device._gather_from_planes`, kernel
    in interpret mode) at the same live chunks of the same volume-order
    planes (the JAX planes x-padded to 128 lanes)."""
    interpret_kernels(monkeypatch)
    rng = np.random.default_rng(sum(block))
    bx, by, bz = block
    cells = bx * by * bz
    nnn = int(np.prod(blocks.grid_shape(shape, block)))
    plane = rng.standard_normal(shape).astype(np.float32)
    desc = rng.integers(0, 1 << 28, size=(nnn, cells), dtype=np.int32)
    cb = rng.integers(0, 3, size=nnn * cells // 128).astype(np.int32)
    n = int((cb > 0).sum())
    rows, drows, ids = pack.patch_extract_plain(
        torch.from_numpy(plane), torch.from_numpy(desc), torch.from_numpy(cb), block, n)

    nzp, nyp, nxp = shape
    w = jwav.padded_nbx(nxp // bx, bx) * bx
    fvv = np.zeros((nzp * nyp, w), np.float32)
    fvv[:, :nxp] = plane.reshape(-1, nxp)
    dvol = blocks.from_blocks(torch.from_numpy(desc).view(nnn, bz, by, bx), shape,
                              block).numpy()
    dv = np.zeros((nzp * nyp, w), np.int32)
    dv[:, :nxp] = dvol.reshape(-1, nxp)
    acap = -(-n // 128) * 128
    aidx = np.zeros(acap, np.int32)
    aidx[:n] = np.flatnonzero(cb)
    of, od = jrd._gather_from_planes(jnp.asarray(fvv), jnp.asarray(dv), jnp.asarray(aidx),
                                     acap, (shape, block), use_kernel=True)
    np.testing.assert_array_equal(ids.numpy(), aidx[:n])
    np.testing.assert_array_equal(rows.numpy(), np.asarray(of)[:n])
    np.testing.assert_array_equal(drows.numpy(), np.asarray(od)[:n])


def test_rows_emit_equals_in_place_emit():
    """The rows emit of the patch rows writes the in-place emit's stream,
    raw blocks (their chunks count 0) skipped, on the stripe route's own
    plane at 32^3."""
    vol = (np.random.default_rng(3).standard_normal((64, 64, 96)) * 30).astype(np.float32)
    vol[:32, :32, :32] *= 1e9  # one raw block
    t = torch.from_numpy(vol)
    c, dk, cbk, sk, rk, mk = tokenize.encode(t, (32, 32, 32), 1.0)
    assert rk.tolist().count(True) == 1
    n = int((cbk > 0).sum())
    rows, drows, ids = pack.patch_extract(c, dk, cbk, (32, 32, 32), n)
    base = torch.cumsum(cbk.long(), 0) - cbk.long()
    total = int(cbk.sum())
    got = pack.emit_rows(rows, drows, ids, mk, cbk, base, total)
    assert torch.equal(got, pack.emit_chunks(c, mk, dk, cbk, base, total, (32, 32, 32)))


# -- K14: the compacting tokenize ---------------------------------------------


def test_k14_plain_matches_jax():
    """`tokenize_compact_plain` against K14 (`tokenize_compact_fast`,
    interpret mode) on 3 one-tile blocks, the pattern of
    tests/test_jax_codec.py:322-362: chunk counts and sizes bit-equal; the
    live rows' ids, coefficients, descriptors and byte counts equal in
    order (the JAX pad rows, bytes 0, left out)."""
    rng = np.random.default_rng(14)
    n, cells = 3, tp.TR * 128
    ncpb = cells // 128
    c = (rng.standard_normal((n, cells)) * 60).astype(np.float32)
    c[rng.random((n, cells)) < 0.9] = 0.0
    c[1, : cells // 2] = 0.0  # zero runs across a half-tile
    padded = np.zeros((tp.pad_rows(n * ncpb), 128), np.float32)
    padded[: n * ncpb] = c.reshape(-1, 128)
    f_cb, f_sizes, f_raw, f_counts, fvc, dscc, meta = tp.tokenize_compact_fast(
        jnp.asarray(padded), n, ncpb, 128, interpret=True)
    cb, sizes, raw, rows, drows, ids, rbytes, nrows = tokenize.tokenize_compact(
        torch.from_numpy(c), torch.ones(n))
    np.testing.assert_array_equal(cb.numpy(), np.asarray(f_cb))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(f_sizes))
    np.testing.assert_array_equal(raw.numpy(), np.asarray(f_raw))
    emitted = int(np.asarray(f_counts)[0])
    meta_h = np.asarray(meta)[:emitted]
    live = meta_h[:, 1] > 0
    assert int(nrows[0]) == int(live.sum()) == rows.shape[0]
    np.testing.assert_array_equal(ids.numpy(), meta_h[live, 0])
    np.testing.assert_array_equal(rbytes.numpy(), meta_h[live, 1])
    np.testing.assert_array_equal(rows.numpy(), np.asarray(fvc)[:emitted][live])
    np.testing.assert_array_equal(drows.numpy(), np.asarray(dscc)[:emitted][live])


# -- K15: the volume-order tokenize, held to tokenize_stripe -----------------


def test_k15_held_by_tokenize_stripe():
    """K15 (`tokenize_desc_volume_fast`, interpret mode) at volume (8, 128,
    256) with (128, 128, 8) blocks (`volume_path_ok`: 2 blocks, one tile
    each, the run carry reset between them) against
    `tokenize_stripe_plain` on the same plane: its chunk-major descriptors
    are the port's block-major ones, chunk by chunk; counts, sizes, raw
    flags bit-equal."""
    shape, block = (8, 128, 256), (128, 128, 8)
    assert tp.volume_path_ok(shape, block)
    rng = np.random.default_rng(15)
    plane = (rng.standard_normal(shape) * 3).astype(np.float32)
    plane[rng.random(shape) < 0.7] = 0.0
    plane[:, 64:, :128] = 0.0
    mulfac = np.float32(17.25)
    fv = (plane * mulfac).astype(np.float32)
    d_v, cb_v, sz_v, raw_v, _ = tp.tokenize_desc_volume_fast(
        jnp.asarray(fv.reshape(-1, shape[2])), shape, block, interpret=True)
    desc, cb, sizes, raw = tokenize.tokenize_stripe_plain(
        torch.from_numpy(plane), torch.full((2,), float(mulfac)), block)
    np.testing.assert_array_equal(desc.numpy().reshape(-1, 128), np.asarray(d_v))
    np.testing.assert_array_equal(cb.numpy(), np.asarray(cb_v))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(sz_v))
    np.testing.assert_array_equal(raw.numpy(), np.asarray(raw_v))


# -- every switch through compress -> decompress ------------------------------

DRIVES = {
    "fused_w1": ({"CVX_FUSED_W": "1"}, (128, 128, 256), (128, 128, 128), False),
    "fused_w0": ({"CVX_FUSED_W": "0"}, (128, 128, 256), (128, 128, 128), False),
    "patch32": ({"CVX_STRIPE": "patch"}, (64, 96, 96), (32, 32, 32), False),
    "patch16_local": ({"CVX_STRIPE": "patch"}, (48, 64, 80), (16, 16, 16), True),
    "compact32": ({"CVX_FUSED_COMPACT": "1"}, (64, 64, 64), (32, 32, 32), False),
    "compact32_local": ({"CVX_FUSED_COMPACT": "1"}, (64, 64, 64), (32, 32, 32), True),
    "compact128": ({"CVX_FUSED_COMPACT": "1"}, (128, 128, 256), (128, 128, 128), False),
}


@pytest.mark.parametrize("name", list(DRIVES))
def test_switch_roundtrip_and_interop(clean_env, name):
    """Each switch through compress -> decompress on the CPU: the CI bars;
    the container equal to the default route's where the coefficients are
    (every route here computes them with the same products but the
    local-RMS table of "compact", whose f64 sums run in another order); its
    decode under the oracle, native and the JAX decoders within 1e-5 of the
    port's."""
    env, shape, block, local = DRIVES[name]
    vol = make_sinusoid_volume(*shape, periods=3)
    ref, _ = cvt.compress(vol, 1e-2, block=block, use_local_rms=local, device="cpu")
    for k, v in env.items():
        clean_env.setenv(k, v)
    data, ratio = cvt.compress(vol, 1e-2, block=block, use_local_rms=local, device="cpu")
    out = cvt.decompress(data, device="cpu").numpy()
    err, snr = rel_error_and_snr(vol, out)
    assert err < 4e-4 and snr > 68.0, (err, snr)
    if name in ("fused_w1", "fused_w0", "patch32", "compact32", "compact128"):
        np.testing.assert_array_equal(data, ref)
    else:
        assert abs(int(data.size) - int(ref.size)) <= max(64, 0.01 * ref.size)
    for other in (ocodec.decompress(data), rle_host.host_decompress(data),
                  jcodec.decompress(data)):
        assert rel_rms(other, out) < TRANSFORM_TOL


@pytest.mark.parametrize("name", ["fused_w1", "patch32", "compact32"])
def test_jax_switch_containers_decode_in_port(clean_env, name):
    """The JAX package's container under the same switch (its TPU route,
    kernels in interpret mode) decodes in the port on both engines within
    1e-5 of the JAX decode.  Under `CVX_FUSED_COMPACT=1` the JAX package's
    compress cannot run: `_stage_w_pallas` pads the chunk rows to a multiple
    of TR (`pad_rows2`, `codec.py:95`), and K14 asserts TR-multiple + 8 rows
    (`tokenize_pallas.py:1323`); its default container stands in."""
    env, shape, block, local = DRIVES[name]
    interpret_kernels(clean_env)
    clean_env.setattr(jcodec, "use_pallas", lambda: True)
    for k, v in env.items():
        clean_env.setenv(k, v)
    if name == "patch32":
        assert jcodec._use_stripe_path(shape, block, False, 128) == "patch"
    vol = make_sinusoid_volume(*shape, periods=3)
    if name == "compact32":
        with pytest.raises(AssertionError):
            jcodec.compress(vol, 1e-2, block=block)
        for k in env:
            clean_env.delenv(k)
    data, _ = jcodec.compress(vol, 1e-2, block=block)
    clean_env.setattr(jcodec, "use_pallas", lambda: False)
    ref = jcodec.decompress(data, engine="host")
    for engine in ("host", "device"):
        mine = cvt.decompress(data, device="cpu", engine=engine).numpy()
        assert rel_rms(mine, ref) < TRANSFORM_TOL


def test_raw_blocks_on_rows_routes(clean_env):
    """A raw-fallback block on the patch and compact routes: its chunks
    are skipped by the rows emit and its coefficients stored; the
    containers equal the in-place emit's on the same transform, the
    stripe route's einsums, and have the default route's raw blocks (the
    default 32^3 route runs native's parity cascade, whose coefficients
    differ from the einsums' in their last bits)."""
    rng = np.random.default_rng(5)
    vol = (rng.standard_normal((64, 64, 64)) * 1000).astype(np.float32)
    vol[:, :, 32:] *= 1e-6  # x1000 noise at 1e-8 beside quiet blocks
    default, _ = cvt.compress(vol, 1e-8, block=(32, 32, 32), device="cpu")
    raw = cvt.container.unpack(default)[1] < 0
    assert raw.sum() == 4
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(codec, "route", lambda shape, block: "stripe")
        ref, _ = cvt.compress(vol, 1e-8, block=(32, 32, 32), device="cpu")
    np.testing.assert_array_equal(cvt.container.unpack(ref)[1] < 0, raw)
    for env in ({"CVX_STRIPE": "patch"}, {"CVX_FUSED_COMPACT": "1"}):
        for k, v in env.items():
            clean_env.setenv(k, v)
        got, _ = cvt.compress(vol, 1e-8, block=(32, 32, 32), device="cpu")
        np.testing.assert_array_equal(got, ref)
        for k in env:
            clean_env.delenv(k)


# -- the faults: TF32, the current device -------------------------------------


def test_import_leaves_matmul_precision():
    """Importing the port leaves the caller's TF32 flag and f32 matmul
    precision as they were (the stripe route's einsums set their own, only
    inside `wavelet.full_f32`)."""
    code = ("import sys, torch; torch.set_float32_matmul_precision('high'); "
            f"sys.path.insert(0, {REPO!r}); import cvxcompress_tpu_torch; "
            "from cvxcompress_tpu_torch.ops import codec, wavelet; "
            "print(torch.backends.cuda.matmul.allow_tf32, "
            "torch.get_float32_matmul_precision())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.stdout.split() == ["True", "high"]


def test_compress_keeps_caller_tf32(clean_env):
    """A compress on the stripe route with the caller's TF32 flag set
    leaves it set, and gives the container made without it."""
    from cvxcompress_tpu_torch.ops import wavelet

    vol = make_sinusoid_volume(32, 32, 48, periods=3)
    ref, _ = cvt.compress(vol, 1e-2, block=(8, 8, 8), device="cpu")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got, _ = cvt.compress(vol, 1e-2, block=(8, 8, 8), device="cpu")
        assert torch.backends.cuda.matmul.allow_tf32
        with wavelet.full_f32():
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    np.testing.assert_array_equal(got, ref)


def test_device_guard():
    """The guard compress and decompress run under: `torch.cuda.device` of
    a CUDA target (here built, not entered: there is no card), a null
    context for the CPU."""
    g = codec.device_guard("cuda:1")
    assert isinstance(g, torch.cuda.device) and g.idx == 1
    g = codec.device_guard(torch.device("cpu"))
    assert not isinstance(g, torch.cuda.device)
    with g:
        pass
