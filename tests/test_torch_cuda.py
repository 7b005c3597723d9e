"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; every test skips where there is no CUDA card (decided in the
`dev` fixture, never at import).  The file imports no jax, so on a machine
without jax it runs alone:

    python -m pytest --noconftest -o addopts="" -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import cvxcompress_tpu_torch as cvt
from cvxcompress_tpu_torch import container as ctn
from cvxcompress_tpu_torch.ops import (
    _kernels, blocks, codec, entropy_decode, fused_compress, fused_inverse, pack,
    quant, rle_device, rle_host, tokenize,
)

import chunk_emit_cases as ec
import doubling_cases as dc
import lookback_cases as lc
import patch_walk_cases as pc
import tile_tokenize_cases as tc

pytestmark = pytest.mark.cuda

TRANSFORM_TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(2024)


def rel_rms(a, b):
    a, b = a.double(), b.double()
    return float(((a - b) ** 2).mean().sqrt() / ((b**2).mean().sqrt() + 1e-30))


def volume(rng, shape):
    """A smooth field plus noise and a few specials: every token class."""
    nz, ny, nx = shape
    z = np.sin(np.arange(nz) * np.pi * 3 / nz).astype(np.float32)
    v = np.broadcast_to(z[:, None, None], shape).copy()
    v += rng.standard_normal(shape).astype(np.float32) * 1e-2
    v[0, 0, :4] = [50.0, -50.0, 1e4, -1e4]
    return v


@pytest.mark.parametrize("shape", [(40, 50, 70), (64, 96, 96)])
@pytest.mark.parametrize("scale", [1e-2, 1e-12])
def test_fused_encode_matches_plain(dev, rng, shape, scale):
    vol = volume(rng, shape)
    vt = torch.from_numpy(vol).to(dev)
    mulfac = quant.global_mulfac(vol, scale)
    ck, dk, cbk, sk, rk, mk = tokenize.fused_encode(vt, mulfac)
    cp, _, cbp, _, _, _ = tokenize.fused_encode_plain(vt, mulfac)
    torch.cuda.synchronize()
    assert rel_rms(ck, cp) < TRANSFORM_TOL
    assert torch.equal(ck.view(torch.int32), cp.view(torch.int32))  # the same cascade
    assert torch.equal(cbk, cbp)
    d2, s2, r2 = rle_device.tokenize(tokenize.scaled(ck, mulfac))
    assert torch.equal(dk, d2) and torch.equal(sk, s2) and torch.equal(rk, r2)
    assert bool(rk.any()) == (scale < 1e-6)
    assert bool((mk == mulfac).all())


def test_fused_encode_nonfinite_volume(dev, rng):
    """NaN and inf in the volume make part of their blocks' coefficients
    non-finite (the native parity cascade's spread: VLESC4 tokens carry
    them, and the blocks stay under their raw size, as in native's codec);
    kernel and plain version agree on every token and the stream still
    equals the native encoder's."""
    vol = volume(rng, (40, 50, 70))
    vol[3, 3, 3] = np.nan
    vol[35, 45, 65] = np.inf
    mulfac = quant.global_mulfac(np.where(np.isfinite(vol), vol, 0), 1e-2)
    ck, dk, cbk, sk, rk, mk = tokenize.fused_encode(torch.from_numpy(vol).to(dev),
                                                    mulfac)
    d2, cb2, s2, r2 = tokenize.tokenize_blocks_plain(ck, mk)
    assert torch.equal(dk, d2) and torch.equal(sk, s2) and torch.equal(rk, r2)
    assert torch.equal(cbk, cb2)
    bad = (~torch.isfinite(ck)).sum(1)
    assert bool(bad[0] > 0) and bool(bad[-1] > 0) and not bool(rk.any())
    base = torch.cumsum(cbk.long(), 0) - cbk.long()
    got = pack.emit_chunks(ck, mk, dk, cbk, base, int(cbk.sum()))
    streams, _, nraw = rle_host.encode_payloads(ck.cpu().numpy(), mulfac)
    np.testing.assert_array_equal(nraw, rk.cpu().numpy())
    native = np.concatenate([s for s, r in zip(streams, nraw) if not r])
    np.testing.assert_array_equal(got.cpu().numpy(), native)


@pytest.mark.parametrize("scale", [1e-2, 1e-4, 1e-12])
def test_emit_32_matches_plain_and_native(dev, rng, scale):
    """The 32^3 route's emit: `block_emit` over the encode's chunk counts,
    bit-equal to its plain version and to the native encoder, block by
    block (at 1e-12 every block raw)."""
    vol = volume(rng, (40, 50, 70))
    mulfac = quant.global_mulfac(vol, scale)
    ck, dk, cbk, sk, rk, mk = tokenize.fused_encode(torch.from_numpy(vol).to(dev),
                                                    mulfac)
    base = torch.cumsum(cbk.long(), 0) - cbk.long()
    total = int(cbk.sum())
    assert total == int(torch.where(rk, 0, sk).sum())
    _kernels.reset_counts()
    got = pack.emit_chunks(ck, mk, dk, cbk, base, total)
    assert _kernels.launches["block_emit"] == 1
    ref = pack.emit_chunks_plain(ck, mk, dk, cbk, base, total)
    assert torch.equal(got, ref)
    streams, _, nraw = rle_host.encode_payloads(ck.cpu().numpy(), mulfac)
    parts = [s for s, r in zip(streams, nraw) if not r]
    native = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    np.testing.assert_array_equal(got.cpu().numpy(), native)


@pytest.mark.parametrize("local", [False, True], ids=["global", "local"])
@pytest.mark.parametrize("kind", ["sinusoid", "noise", "ramp"])
def test_fused_encode_chunk_bytes_at_a(dev, kind, local):
    """fused_encode(_local) at A's shape (352, 416, 320): the per-chunk byte
    counts bit-equal to the plain version's (on A's sinusoid, N(0,1) noise
    and `ramp`), and their sums the sizes."""
    shape = (352, 416, 320)
    if kind == "noise":
        vol = np.random.default_rng(9).standard_normal(shape, dtype=np.float32)
    elif kind == "ramp":
        vol = ramp(shape, 32)
    else:
        z = np.sin(np.arange(shape[0]) * np.pi * 10 / shape[0]).astype(np.float32)
        vol = np.broadcast_to(z[:, None, None], shape).copy()
    vt = torch.from_numpy(vol).to(dev)
    scale = 1e-1 if kind == "noise" else 1e-2
    args = dict(scale=scale) if local else dict(mulfac=quant.global_mulfac(vol, scale))
    ck, dk, cbk, sk, rk, mk = tokenize.fused_encode(vt, **args)
    cp, dp, cbp, sp, rp, mp = tokenize.fused_encode_plain(vt, **args)
    torch.cuda.synchronize()
    assert torch.equal(ck.view(torch.int32), cp.view(torch.int32))
    assert torch.equal(dk, dp) and torch.equal(cbk, cbp) and torch.equal(mk, mp)
    assert torch.equal(sk, sp) and torch.equal(rk, rp)
    assert torch.equal(cbk.view(-1, 256).sum(1, dtype=torch.int32)[~rk], sk[~rk])
    assert not bool(cbk.view(-1, 256)[rk].any())


@pytest.mark.parametrize("name", list(ec.CASES))
def test_block_emit_cases(dev, name):
    """block_emit on the cases of tests/chunk_emit_cases.py (no live chunk;
    only window lane 31's; odd counts of live chunks and raw blocks in a
    window; a last window cut short; 64-cell chunks; the stripe map at 8^3
    and (128, 8, 8); 32^3 with a raw block), bit-equal to its plain
    version; in rows mode too (ids shuffled, raw blocks' rows among them)."""
    c = ec.make(name, dev)
    args = (c["coeffs"], c["mulfacs"], c["desc"], c["chunk_bytes"], c["chunk_base"],
            c["total"], c["block"])
    _kernels.reset_counts()
    got = pack.emit_chunks(*args)
    assert _kernels.launches["block_emit"] == 1
    want = pack.emit_chunks_plain(*args)
    assert torch.equal(got, want)
    if name in ec.ROWS:
        rows, drows, ids = ec.rows_of(c)
        got = pack.emit_rows(rows, drows, ids, c["mulfacs"], c["chunk_bytes"],
                             c["chunk_base"], c["total"])
        assert _kernels.launches["block_emit_rows"] == 1
        assert torch.equal(got, want)


@pytest.mark.parametrize("route", ["tma", "view_at_offset_1", "nx_75"])
def test_fused_encode_copy_routes_bit_equal(dev, rng, route):
    """The encode's two copy routes (a TMA tile where the volume is 16-byte
    aligned with nx % 4 == 0, else 4-byte cp.async) give the plain
    version's coefficients and tokens bit for bit, edges included."""
    shape = (40, 50, 75) if route == "nx_75" else (40, 50, 72)
    vol = volume(rng, shape)
    if route == "view_at_offset_1":
        flat = torch.zeros(vol.size + 1, device=dev)
        vt = flat[1:].view(shape)
        vt.copy_(torch.from_numpy(vol))
    else:
        vt = torch.from_numpy(vol).to(dev)
    mulfac = quant.global_mulfac(vol, 1e-2)
    got = tokenize.fused_encode(vt, mulfac)
    want = tokenize.fused_encode_plain(torch.from_numpy(vol).to(dev), mulfac)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)


def test_fused_inverse_rejects_misaligned_rows(dev):
    """fused_inverse copies its chunk rows 16 bytes at a time: a view that
    does not start on a 16-byte boundary raises instead of launching."""
    flat = torch.zeros(12 * 256 * 128 + 1, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        fused_inverse.fused_inverse(flat[1:].view(-1, 128), None, (40, 50, 70))


def test_fused_inverse_matches_plain(dev, rng):
    shape = (60, 90, 90)
    nnn = 2 * 3 * 3
    c = rng.standard_normal((nnn, 32 ** 3)).astype(np.float32)
    c.reshape(-1, 128)[rng.random(c.size // 128) < 0.7] = 0.0
    rows, invmap = codec.sparse_chunks(c)
    rows, invmap = torch.from_numpy(rows).to(dev), torch.from_numpy(invmap).to(dev)
    got = fused_inverse.fused_inverse(rows, invmap, shape)
    ref = fused_inverse.fused_inverse_plain(rows, invmap, shape)
    torch.cuda.synchronize()
    assert rel_rms(got, ref) < TRANSFORM_TOL
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))  # the same cascade


def test_main_path_counts_and_agrees_with_cpu(dev, rng):
    """The public API on "cuda" launches each kernel once and agrees with
    the plain CPU path."""
    vol = volume(rng, (40, 50, 70))
    _kernels.reset_counts()
    data, _ = cvt.compress(vol, 1e-2, device="cuda")
    out = cvt.decompress(data, device="cuda")
    torch.cuda.synchronize()
    once = ("fused_encode", "block_emit", "fused_inverse", "decode_maps",
            "decode_chase", "decode_emit")
    assert _kernels.launches == {k: int(k in once) for k in _kernels.launches}
    ref, _ = cvt.compress(vol, 1e-2, device="cpu")
    assert abs(int(data.size) - int(ref.size)) <= max(64, 0.01 * ref.size)
    assert rel_rms(out.cpu(), cvt.decompress(data, device="cpu")) < TRANSFORM_TOL


def decode_kernels_vs_plain(data, dev):
    """Each decode kernel against its plain version on the same inputs
    (bit-equal); returns the dense coefficients with the raw overlay."""
    p = entropy_decode.plan(data)
    b = entropy_decode.upload(p, dev)
    nsub, cells, nnn = b["sub_block"].numel(), p["cells"], p["hdr"].grid[3]
    sf = b["scalefac"]
    M, P = entropy_decode.parse_maps(b["stream"], nsub, cells)
    Mp, Pp = entropy_decode.parse_maps_plain(b["stream"], nsub, cells)
    assert torch.equal(M, Mp) and torch.equal(P, Pp)
    e32, c32 = entropy_decode.chase(P, b["sub_reset"], b["starts"], cells)
    ep, cp = entropy_decode.chase_plain(P, b["sub_reset"], cells)
    assert torch.equal(e32, ep) and torch.equal(c32, cp)
    args = (b["stream"], M, e32, c32, b["sub_block"], sf, nnn, cells)
    dense = entropy_decode.emit(*args)
    assert torch.equal(dense.view(torch.int32),
                       entropy_decode.emit_plain(*args).view(torch.int32))
    return entropy_decode.overlay_raw(dense, b["raw_rows"], b["raw_ids"])


@pytest.mark.parametrize("scale,block", [
    (1e-4, (16, 16, 16)), (1e-2, (16, 16, 16)), (1.0, (16, 16, 16)),
    (1e-1, (32, 32, 32)),  # blocks of many 512-byte segments
    (1e-9, (8, 8, 8)),  # raw fallback
])
def test_decode_kernels_match_plain_and_native(dev, rng, scale, block):
    vol = rng.standard_normal((32, 64, 64)).astype(np.float32)
    if scale >= 1e-6:  # (outliers lift the RMS: no raw fallback with them)
        vol[0, 0, :3] = [1e3, -1e3, 1e4]  # wide escapes
    data, _ = rle_host.host_compress(vol, scale, block=block)
    dense = decode_kernels_vs_plain(data, dev)
    hdr, blkoffs, _, pbase = ctn.unpack(data)
    nat = rle_host.decode_payloads(data[pbase:], blkoffs, hdr.glob_mulfac,
                                   dense.shape[1])
    np.testing.assert_array_equal(dense.cpu().numpy().view(np.uint32),
                                  nat.view(np.uint32))
    assert bool((blkoffs < 0).any()) == (scale < 1e-6)


@pytest.mark.parametrize("seed", range(3))
def test_decode_kernels_on_corrupt_payloads(dev, seed):
    vol = volume(np.random.default_rng(seed), (64, 64, 96))
    data, _ = rle_host.host_compress(vol, 1e-2)
    _, _, _, pbase = ctn.unpack(data)
    r = np.random.default_rng(seed)
    flips = r.integers(pbase, data.size - 8, 40)
    data[flips] ^= r.integers(1, 255, 40).astype(np.uint8)
    decode_kernels_vs_plain(data, dev)
    out = cvt.decompress(data, device="cuda", engine="device")
    torch.cuda.synchronize()
    assert tuple(out.shape) == (64, 64, 96)


@pytest.mark.parametrize("cells", [64, 1 << 22, 1 << 24])
def test_decode_kernels_on_doubling_cases(dev, cells):
    """decode_maps against its plain version and the numpy model of its
    pointer doubling, decode_emit against its plain version, on the streams
    of tests/doubling_cases.py (every token class at every lane offset, a
    VLESC3_8x from lane 7 to the end, tokens over the subsegment's end,
    chains of 32 one-byte tokens, saturated runs, random streams), each
    case a block of its own with a scalefac of its own."""
    stream, reset, spans = dc.stream_of(dc.cases())
    nsub, nnn = reset.size, len(spans)
    st = torch.from_numpy(stream).to(dev)
    M, P = entropy_decode.parse_maps(st, nsub, cells)
    Mp, Pp = entropy_decode.parse_maps_plain(st, nsub, cells)
    assert torch.equal(M, Mp) and torch.equal(P, Pp)
    Mm, Pm = dc.doubling_maps(stream, nsub, cells)
    np.testing.assert_array_equal(M.cpu().numpy(), Mm)
    np.testing.assert_array_equal(P.cpu().numpy(), Pm)
    sub_block = np.full(nsub, nnn, np.int32)
    for i, (a, b) in enumerate(spans.values()):
        sub_block[a:b] = i
    rt = torch.from_numpy(reset).to(dev)
    starts = torch.from_numpy(np.flatnonzero(reset).astype(np.int32)).to(dev)
    e32, c32 = entropy_decode.chase(P, rt, starts, cells)
    sf = torch.tensor([0.5 * (i + 1) for i in range(nnn)], dtype=torch.float32, device=dev)
    args = (st, M, e32, c32, torch.from_numpy(sub_block).to(dev), sf, nnn, cells)
    dense = entropy_decode.emit(*args)
    assert torch.equal(dense.view(torch.int32),
                       entropy_decode.emit_plain(*args).view(torch.int32))
    assert bool((dense != 0).any())


def test_decode_wrappers_reject_misaligned_stream(dev):
    """The decode kernels read the stream as aligned words: a stream view
    off the 16-byte boundary `upload` gives raises, as does a block over
    P's packing."""
    st = torch.zeros(64 * 32 + 48, dtype=torch.uint8, device=dev)[1:]
    with pytest.raises(ValueError):
        entropy_decode.parse_maps(st, 64, 4096)
    with pytest.raises(ValueError):
        entropy_decode.parse_maps(torch.zeros(64 * 32 + 48, dtype=torch.uint8, device=dev),
                                  64, entropy_decode.MAX_CELLS)
    z = torch.zeros(64, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        entropy_decode.emit(st, torch.zeros((64, 32), dtype=torch.int32, device=dev), z, z,
                            z, torch.ones(1, device=dev), 1, 4096)


@pytest.mark.parametrize("walk", [True, False], ids=["walk", "pieces"])
@pytest.mark.parametrize("name", ["short", "short_saturating", "long"])
def test_chase_kernel_across_piece_seams(dev, name, walk, monkeypatch):
    """decode_chase, on each of its routes, against its plain version and
    the one-step semantics on chains of 1, L - 1, L, L + 1 and 2 L + 1
    subsegments (L its piece), resets on and beside piece boundaries and a
    chain over hundreds of pieces (tests/lookback_cases.py)."""
    P, reset, cells = lc.chase_cases(entropy_decode.chase_shape)[name]
    Pt, rt = torch.from_numpy(P).to(dev), torch.from_numpy(reset).to(dev)
    starts = torch.from_numpy(np.flatnonzero(reset).astype(np.int32)).to(dev)
    monkeypatch.setattr(entropy_decode, "chase_walks", lambda *_: walk)
    e32, c32 = entropy_decode.chase(Pt, rt, starts, cells)
    ep, cp = entropy_decode.chase_plain(Pt, rt, cells)
    assert torch.equal(e32, ep) and torch.equal(c32, cp)
    se, sc = entropy_decode.chase_sequential(P, reset, cells)
    np.testing.assert_array_equal(e32.cpu().numpy(), se)
    np.testing.assert_array_equal(c32.cpu().numpy(), sc)


@pytest.mark.parametrize("kind", ["stretches", "last_tile", "tile_edge"])
def test_tokenize_stripe_kernel_across_tile_seams(dev, kind):
    """tokenize_stripe against its plain version on three (256, 256, 8)
    blocks of 32 tiles (all-zero stretches over many tiles, one non-zero
    cell in a block's last tile, runs ending on tile edges), the plane also
    at a misaligned view (the wrapper copies it for the TMA boxes)."""
    c, mf = lc.stripe_case(kind)
    plane = blocks.from_blocks(torch.from_numpy(c).to(dev).view(-1, 8, 256, 256),
                               lc.STRIPE_SHAPE, lc.STRIPE_BLOCK)
    mk = torch.from_numpy(mf).to(dev)
    plain = tokenize.tokenize_stripe_plain(plane, mk, lc.STRIPE_BLOCK)
    view = torch.zeros(plane.numel() + 1, device=dev)[1:].view(plane.shape)
    view.copy_(plane)
    for p in (plane, view):
        got = tokenize.tokenize_stripe(p, mk, lc.STRIPE_BLOCK)
        assert all(torch.equal(a, b) for a, b in zip(got, plain))


def test_device_decompress_from_two_threads(dev):
    """Two threads decompress at once on the default stream, a container
    each: a smooth 32^3 one (the chase walks its chains) and a noise 128^3
    one (the chase scans pieces, its look-back over a scratch of its own
    each call).  Every result equals the one decompressed alone."""
    import threading

    rng = np.random.default_rng(5)
    smooth = volume(rng, (64, 96, 96))
    noise = rng.standard_normal((128, 128, 256)).astype(np.float32)
    datas = [cvt.compress(smooth, 1e-2, device="cuda")[0],
             cvt.compress(noise, 1e-1, block=(128, 128, 128), device="cuda")[0]]
    refs = [cvt.decompress(d, device="cuda", engine="device") for d in datas]
    torch.cuda.synchronize()
    bad = []

    def run(i):
        try:
            for _ in range(20):
                out = cvt.decompress(datas[i], device="cuda", engine="device")
                nd = int((out.view(torch.int32) != refs[i].view(torch.int32)).sum())
                if nd:
                    bad.append((i, nd))  # the container, its cells that differ
        except Exception as e:  # a failed launch fails the test, not just the thread
            bad.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert not bad


def test_device_engine_matches_host_engine(dev, rng):
    vol = volume(rng, (64, 96, 96))
    data, _ = cvt.compress(vol, 1e-2, device="cuda")
    out = cvt.decompress(data, device="cuda", engine="device")
    ref = cvt.decompress(data, device="cuda", engine="host")
    assert rel_rms(out, ref) < TRANSFORM_TOL
    coeffs = decode_kernels_vs_plain(data, dev)
    rows = coeffs.view(-1, fused_inverse.CHUNK)
    got = fused_inverse.fused_inverse(rows, None, vol.shape)
    assert rel_rms(got, fused_inverse.fused_inverse_plain(rows, None, vol.shape)) \
        < TRANSFORM_TOL


def test_kernel_wrappers_reject_bad_inputs(dev):
    with pytest.raises(ValueError):
        tokenize.fused_encode(torch.zeros((32, 32, 32), dtype=torch.float64,
                                          device=dev), 1.0)
    with pytest.raises(ValueError):
        fused_inverse.fused_inverse(
            torch.zeros((1, 128), device=dev),
            torch.zeros(5, dtype=torch.int32, device=dev), (32, 32, 32),
        )


# -- the 128^3 whole-block kernels ------------------------------------------

BLOCK128 = (128, 128, 128)


def volume128(kind, shape):
    """Inputs of the 128^3 kernels: "sparse" (x40 noise at 20 % density, every
    token class), "cube" (zero but for a small cube: zero runs over whole
    z-slices, the look-back's long walk), "sine" (the smooth CI field)."""
    r = np.random.default_rng(128)
    if kind == "sparse":
        v = (r.standard_normal(shape) * 40).astype(np.float32)
        v[r.random(shape) >= 0.2] = 0.0
        return v, 37.5
    if kind == "cube":
        v = np.zeros(shape, np.float32)
        v[70:78, 40:46, 20:25] = 25.0
        return v, 37.5
    v = volume(r, shape)
    return v, quant.global_mulfac(v, 1e-2)


def encode128_vs_plain(vt, mulfac):
    """block_encode against its plain version; returns the kernel's outputs."""
    ck, dk, cbk, sk, rk, mk = fused_compress.block_encode(vt, mulfac)
    cp = fused_compress.block_encode_plain(vt, mulfac)[0]
    torch.cuda.synchronize()
    assert rel_rms(ck, cp) < TRANSFORM_TOL
    d2, cb2, s2, r2 = tokenize.tokenize_blocks_plain(ck, mulfac)
    assert torch.equal(dk, d2) and torch.equal(cbk, cb2)
    assert torch.equal(sk, s2) and torch.equal(rk, r2)
    assert bool((mk == mulfac).all())
    return ck, dk, cbk, sk, rk, mk


@pytest.mark.parametrize("kind,shape", [
    ("sparse", (128, 128, 256)), ("cube", (128, 128, 256)),
    ("sine", (128, 128, 256)), ("sine", (384, 384, 384)),
])
def test_block128_kernels_match_plain(dev, kind, shape):
    vol, mulfac = volume128(kind, shape)
    vt = torch.from_numpy(vol).to(dev)
    ck, dk, cbk, sk, rk, mk = encode128_vs_plain(vt, mulfac)
    base = torch.cumsum(cbk.long(), 0) - cbk.long()
    total = int(cbk.sum())
    got = pack.emit_chunks(ck, mk, dk, cbk, base, total)
    assert torch.equal(got, pack.emit_chunks_plain(ck, mk, dk, cbk, base, total))
    streams, nsizes, nraw = rle_host.encode_payloads(ck.cpu().numpy(), mulfac)
    np.testing.assert_array_equal(nsizes, sk.cpu().numpy())
    parts = [st for st, r in zip(streams, nraw) if not r]
    native = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    np.testing.assert_array_equal(got.cpu().numpy(), native)
    rows = ck.view(-1, 128)
    vk = fused_inverse.block_fused_inverse(rows, shape)
    vp = fused_inverse.block_fused_inverse_plain(rows, shape)
    torch.cuda.synchronize()
    assert rel_rms(vk, vp) < TRANSFORM_TOL
    assert rel_rms(vk.cpu(), torch.from_numpy(vol)) < TRANSFORM_TOL


def test_block128_raw_fallback_on_the_card(dev):
    """x1000 noise beside a quiet block at 1e-8: block 0 falls back to raw;
    kernel and plain version agree, and the stream skips the raw block."""
    vol = (np.random.default_rng(81).standard_normal((128, 128, 256))
           * 1000).astype(np.float32)
    vol[:, :, 128:] *= 1e-6
    mulfac = quant.global_mulfac(vol, 1e-8)
    ck, dk, cbk, sk, rk, _ = encode128_vs_plain(torch.from_numpy(vol).to(dev), mulfac)
    assert rk.tolist() == [True, False]
    assert int(cbk[:16384].sum()) == 0 and int(sk[0]) == 4 * 128 ** 3
    data, _ = cvt.compress(vol, 1e-8, block=BLOCK128)
    out = cvt.decompress(data)
    ref = cvt.decompress(data, engine="host")
    assert torch.equal(out, ref)


def test_block128_roundtrip_on_the_card(dev):
    """The public API at 128^3 on the default device: each 128^3 kernel and
    each decode kernel launches once; the container and the volume agree
    with the plain CPU path and the native decoder."""
    vol = volume(np.random.default_rng(5), (128, 256, 128))
    _kernels.reset_counts()
    data, _ = cvt.compress(vol, 1e-2, block=BLOCK128)
    out = cvt.decompress(data)
    torch.cuda.synchronize()
    once = ("block_fwd_z", "block_encode_xy", "block_emit", "block_inv_xy",
            "block_inv_z", "decode_maps", "decode_chase", "decode_emit")
    assert _kernels.launches == {k: int(k in once) for k in _kernels.launches}
    assert out.device.type == "cuda"
    ref, _ = cvt.compress(vol, 1e-2, block=BLOCK128, device="cpu")
    assert abs(int(data.size) - int(ref.size)) <= max(64, 0.01 * ref.size)
    assert rel_rms(out.cpu(), cvt.decompress(data, device="cpu")) < TRANSFORM_TOL
    assert rel_rms(out, cvt.decompress(data, engine="host")) < TRANSFORM_TOL
    nat = torch.from_numpy(rle_host.host_decompress(data))
    assert rel_rms(out.cpu(), nat) < TRANSFORM_TOL


def test_block128_decode_kernels_at_two_million_cells(dev):
    """The decode kernels at cells = 2^21 on a noise container (one chain of
    tens of thousands of subsegments per block) match their plain versions
    and the native decoder."""
    vol = np.random.default_rng(21).standard_normal((128, 128, 256)).astype(np.float32)
    data, _ = rle_host.host_compress(vol, 1.0, block=BLOCK128)
    dense = decode_kernels_vs_plain(data, dev)
    hdr, blkoffs, _, pbase = ctn.unpack(data)
    nat = rle_host.decode_payloads(data[pbase:], blkoffs, hdr.glob_mulfac, 128 ** 3)
    np.testing.assert_array_equal(dense.cpu().numpy().view(np.uint32),
                                  nat.view(np.uint32))


def test_block128_wrappers_reject_bad_inputs(dev):
    with pytest.raises(ValueError):
        fused_compress.block_encode(torch.zeros((128, 128, 200), device=dev), 1.0)
    with pytest.raises(ValueError):
        fused_inverse.block_fused_inverse(torch.zeros((10, 128), device=dev),
                                          BLOCK128)


# -- the local RMS ------------------------------------------------------------


def ramp(shape, b):
    """`volume` with its b^3 blocks scaled by 1 and 1e-4 in turn (block RMS
    10^4 apart) and, at 32^3, the guard blocks: all-zero, ~1e-38 and NaN
    (each gets mulfac 1.0)."""
    v = volume(np.random.default_rng(4), shape)
    nb = tuple(n // b for n in shape)
    f = np.where(np.arange(np.prod(nb)) % 2 == 1, 1e-4, 1.0).astype(np.float32)
    v *= np.kron(f.reshape(nb), np.ones((b, b, b), np.float32))
    if b == 32:
        v[:32, :32, 32:64] = 0.0
        v[:32, 32:64, :32] = np.float32(1e-38)
        v[32:64, 64:96, 64:96] = 0.5
        v[40, 70, 70] = np.nan
    return v


def test_fused_encode_local_matches_plain(dev):
    """fused_encode_local: coefficients bit-equal to the plain version;
    the table, descriptors, sizes and raw flags bit-equal to the plain
    local RMS and tokenize of the kernel's coefficients (the NaN block's
    NaN coefficients code as VLESC4 tokens in less than its raw size, as in
    native's codec); the chunk counts bit-equal to the plain version's;
    block_emit at the table bit-equal to its plain version and to the
    native encoder."""
    vol = ramp((64, 96, 96), 32)
    vt = torch.from_numpy(vol).to(dev)
    _kernels.reset_counts()
    ck, dk, cbk, sk, rk, mk = tokenize.fused_encode(vt, scale=1e-2)
    assert _kernels.launches["fused_encode_local"] == 1
    assert _kernels.launches["fused_encode"] == 0
    cp, _, cbp, *_ = tokenize.fused_encode_plain(vt, scale=1e-2)
    assert torch.equal(cbk, cbp)
    torch.cuda.synchronize()
    fin = torch.isfinite(cp).all(1)
    assert rel_rms(ck[fin], cp[fin]) < TRANSFORM_TOL
    assert torch.equal(ck.view(torch.int32), cp.view(torch.int32))
    assert torch.equal(mk, quant.mulfac_from_rms(quant.local_rms(ck), 1e-2))
    assert float(mk.max() / mk[fin & (mk != 1.0)].min()) > 5e3
    assert mk[1] == mk[3] == mk[17] == 1.0 and not bool(fin[17])
    assert rk.tolist() == [False] * 18
    d2, s2, r2 = rle_device.tokenize(tokenize.scaled(ck, mk))
    assert torch.equal(dk, d2) and torch.equal(sk, s2) and torch.equal(rk, r2)
    base = torch.cumsum(cbk.long(), 0) - cbk.long()
    total = int(cbk.sum())
    got = pack.emit_chunks(ck, mk, dk, cbk, base, total)
    assert torch.equal(got, pack.emit_chunks_plain(ck, mk, dk, cbk, base, total))
    streams, nsizes, nraw = rle_host.encode_payloads(ck.cpu().numpy(), mk.cpu().numpy())
    np.testing.assert_array_equal(nraw, rk.cpu().numpy())
    np.testing.assert_array_equal(nsizes, sk.cpu().numpy())
    native = np.concatenate([st for st, r in zip(streams, nraw) if not r])
    np.testing.assert_array_equal(got.cpu().numpy(), native)


@pytest.mark.parametrize("kind", ["sparse", "cube", "ramp"])
def test_block128_local_kernels_match_plain(dev, kind):
    """block_casc_local: coefficients within 1e-5 of the plain version and
    slice partials bit-equal to the plain sums of its coefficients;
    block_scale_tok: table, descriptors, chunk bytes, sizes and raw flags
    bit-equal to the plain version on the same inputs; emit_chunks at the
    table bit-equal to its plain version and to the native encoder."""
    shape = (128, 128, 256)
    vol = ramp(shape, 128) if kind == "ramp" else volume128(kind, shape)[0]
    vt = torch.from_numpy(vol).to(dev)
    tk = fused_compress.fwd_z(vt)
    cp, _ = fused_compress.casc_local_plain(tk)
    ck, pk = fused_compress.casc_local(tk)
    torch.cuda.synchronize()
    assert rel_rms(ck, cp) < TRANSFORM_TOL
    del cp
    assert torch.equal(pk, quant.cta_sumsq(ck.view(-1, 128 * 128), 256).view(-1, 128))
    dk, cbk, sk, rk, mk = fused_compress.scale_tok(ck, pk, 1e-2)
    dp, cbp, sp, rp, mp = fused_compress.scale_tok_plain(ck, pk, 1e-2)
    assert torch.equal(mk, mp) and torch.equal(dk, dp) and torch.equal(cbk, cbp)
    assert torch.equal(sk, sp) and torch.equal(rk, rp)
    if kind == "ramp":
        assert float(mk[1] / mk[0]) > 5e3
    base = torch.cumsum(cbk.long(), 0) - cbk.long()
    total = int(cbk.sum())
    got = pack.emit_chunks(ck, mk, dk, cbk, base, total)
    assert torch.equal(got, pack.emit_chunks_plain(ck, mk, dk, cbk, base, total))
    streams, nsizes, nraw = rle_host.encode_payloads(ck.cpu().numpy(), mk.cpu().numpy())
    np.testing.assert_array_equal(nsizes, sk.cpu().numpy())
    parts = [st for st, r in zip(streams, nraw) if not r]
    native = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    np.testing.assert_array_equal(got.cpu().numpy(), native)


@pytest.mark.parametrize("block", [(32, 32, 32), (128, 128, 128)], ids=["32", "128"])
def test_local_roundtrip_on_the_card(dev, block):
    """compress(use_local_rms=True) -> decompress on the default device:
    the local encode kernels launch (the global ones do not), the table
    equals the plain CPU path's within rtol 1e-5, the device engine equals
    the host engine within 1e-5, and native decodes the container."""
    b = block[0]
    shape = (64, 96, 96) if b == 32 else (128, 128, 256)
    vol = ramp(shape, b)
    if b == 32:
        vol[40, 70, 70] = 0.5  # finite: the CPU path's transform differs on NaN
    _kernels.reset_counts()
    data, _ = cvt.compress(vol, 1e-2, block=block, use_local_rms=True)
    out = cvt.decompress(data)
    torch.cuda.synchronize()
    local = ("fused_encode_local",) if b == 32 else ("block_fwd_z", "block_casc_local",
                                                      "block_scale_tok")
    for k in local + ("block_emit", "decode_maps", "decode_chase", "decode_emit"):
        assert _kernels.launches[k] == 1, k
    assert _kernels.launches["fused_encode"] == _kernels.launches["block_encode_xy"] == 0
    hdr, _, blkmf, _ = ctn.unpack(data)
    ref, _ = cvt.compress(vol, 1e-2, block=block, use_local_rms=True, device="cpu")
    np.testing.assert_allclose(blkmf, ctn.unpack(ref)[2], rtol=1e-5)
    assert abs(int(data.size) - int(ref.size)) <= max(64, 0.01 * ref.size)
    assert rel_rms(out, cvt.decompress(data, engine="host")) < TRANSFORM_TOL
    nat = torch.from_numpy(rle_host.host_decompress(data))
    assert rel_rms(out.cpu(), nat) < TRANSFORM_TOL


def test_decode_kernels_on_local_containers(dev):
    """The decode kernels with a per-block scalefac table (a native local
    container whose block RMS span 10^4) match their plain versions, and
    the dense coefficients are uint32-equal to native decode_payloads at
    the container's table."""
    vol = ramp((64, 96, 96), 32)
    vol[40, 70, 70] = 0.5
    data, _ = rle_host.host_compress(vol, 1e-2, use_local_rms=True)
    dense = decode_kernels_vs_plain(data, dev)
    hdr, blkoffs, blkmf, pbase = ctn.unpack(data)
    assert hdr.use_local_rms and blkmf.max() / blkmf[blkmf != 1.0].min() > 5e3
    nat = rle_host.decode_payloads(data[pbase:], blkoffs, hdr.glob_mulfac,
                                   dense.shape[1], blkmf)
    np.testing.assert_array_equal(dense.cpu().numpy().view(np.uint32),
                                  nat.view(np.uint32))


# -- every other geometry: stripe_fused_encode / _inverse, tokenize_stripe,
# -- block_emit ------------------------------------------------------------------


def generic_volume(kind, shape, block):
    """Inputs of the other geometries: "sine" (`volume`: every token class),
    "half" (the upper half along z zero: whole zero blocks), "nan" (one NaN:
    its block's coefficients go NaN, raw fallback)."""
    v = volume(np.random.default_rng(sum(block)), shape)
    if kind == "half":
        v[shape[0] // 2:] = 0.0
    if kind == "nan":
        v[shape[0] - 1, shape[1] - 1, shape[2] - 1] = np.nan
    return v


def route_kernels(shape, block, local=False):
    """The encode and inverse kernels of the block's route."""
    if codec.route(shape, block) == "stripe_fused":
        return ("stripe_fused_encode_local" if local else "stripe_fused_encode",
                "stripe_fused_inverse")
    return ("tokenize_stripe",)


def generic_vs_plain(vt, block, mulfac=None, scale=None):
    """The route's encode on the card: on the "stripe_fused" route the
    kernel's coefficients (as int32: NaN payloads too) and table bit-equal
    to the plain version's, and the fused inverse bit-equal to its plain
    version on those coefficients; on either route the tokenize
    and `emit_chunks` bit-equal to their plain versions on the kernel's own
    coefficients and table, and the stream equal to the native encoder's.
    Returns the encode's outputs."""
    shape, local = tuple(vt.shape), scale is not None
    fused = codec.route(shape, block) == "stripe_fused"
    _kernels.reset_counts()
    if fused:
        c, dk, cbk, sk, rk, mk = tokenize.stripe_fused_encode(vt, block, mulfac,
                                                              scale=scale)
    else:
        c, dk, cbk, sk, rk, mk = tokenize.encode(vt, block, mulfac, scale=scale)
    torch.cuda.synchronize()
    assert _kernels.launches[route_kernels(shape, block, local)[0]] == 1
    if fused:
        cp, *_, mp = tokenize.stripe_fused_encode_plain(vt, block, mulfac, scale=scale)
        assert torch.equal(c.view(torch.int32), cp.view(torch.int32))
        assert torch.equal(mk, mp)
        plain = tokenize.tokenize_blocks_plain(c, mk)
        cbm, sb = c, None
        vk = fused_inverse.stripe_fused_inverse(c, shape, block)
        vp = fused_inverse.stripe_fused_inverse_plain(c, shape, block)
        assert torch.equal(vk.view(torch.int32), vp.view(torch.int32))
    else:
        plain = tokenize.tokenize_stripe_plain(c, mk, block)
        cbm, sb = blocks.to_blocks(c, block).view(mk.shape[0], -1), block
    for got, ref in zip((dk, cbk, sk, rk), plain):
        assert torch.equal(got, ref)
    base = torch.cumsum(cbk.long(), 0) - cbk.long()
    total = int(cbk.sum())
    got = pack.emit_chunks(c, mk, dk, cbk, base, total, sb)
    assert torch.equal(got, pack.emit_chunks_plain(c, mk, dk, cbk, base, total, sb))
    streams, nsizes, nraw = rle_host.encode_payloads(cbm.cpu().numpy(), mk.cpu().numpy())
    np.testing.assert_array_equal(nsizes, sk.cpu().numpy())
    np.testing.assert_array_equal(nraw, rk.cpu().numpy())
    parts = [st for st, r in zip(streams, nraw) if not r]
    native = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    np.testing.assert_array_equal(got.cpu().numpy(), native)
    return c, dk, cbk, sk, rk, mk


@pytest.mark.parametrize("block,shape", [
    ((8, 8, 8), (40, 50, 70)), ((8, 8, 1), (5, 50, 70)),
    ((128, 8, 8), (40, 50, 300)), ((256, 8, 16), (20, 30, 260)),
    ((128, 128, 128), (130, 128, 140)),
    ((16, 16, 16), (40, 50, 70)), ((64, 64, 64), (70, 90, 100)),
    ((16, 16, 1), (3, 50, 70)), ((8, 16, 8), (20, 40, 60)),
    ((32, 32, 16), (40, 70, 70)), ((64, 32, 32), (70, 40, 140)),
    ((16, 256, 16), (20, 300, 40)), ((64, 64, 64), (70, 90, 300)),
    ((8, 16, 256), (260, 40, 20)), ((64, 8, 128), (130, 20, 130)),
    ((64, 64, 64), (64, 64, 128)),
], ids=lambda v: "x".join(map(str, v)))
@pytest.mark.parametrize("local", [False, True], ids=["global", "local"])
def test_generic_kernels_match_plain(dev, block, shape, local):
    vol = generic_volume("sine", shape, block)
    vt = torch.from_numpy(vol).to(dev)
    args = dict(scale=1e-2) if local else dict(mulfac=quant.global_mulfac(vol, 1e-2))
    generic_vs_plain(vt, block, **args)


@pytest.mark.parametrize("block", [(16, 16, 16), (64, 32, 32)], ids=["16", "64x32x32"])
@pytest.mark.parametrize("route", ["view_at_offset_1", "nx_odd"])
def test_stripe_fused_copy_routes_bit_equal(dev, block, route):
    """The fused stripe encode's 4-byte copy route (a misaligned view, or nx
    % 4 != 0 where TMA's 16-byte rules fail) gives the plain version's
    outputs bit for bit, in the tile and the cluster kernels."""
    shape = (40, 70, 75) if route == "nx_odd" else (40, 70, 96)
    vol = generic_volume("sine", shape, block)
    if route == "view_at_offset_1":
        flat = torch.zeros(vol.size + 1, device=dev)
        vt = flat[1:].view(shape)
        vt.copy_(torch.from_numpy(vol))
    else:
        vt = torch.from_numpy(vol).to(dev)
    for args in (dict(mulfac=quant.global_mulfac(vol, 1e-2)), dict(scale=1e-2)):
        generic_vs_plain(vt, block, **args)


@pytest.mark.parametrize("block", [(16, 16, 16), (64, 32, 32)], ids=["16", "64x32x32"])
def test_stripe_fused_gives_native_parity_container(dev, block):
    """On the card the fused stripe route's global container is
    `cvx_compress_parity_th`'s byte for byte, and its decompress equals
    `cvx_decompress_inplace_parity_th`'s volume."""
    vol = generic_volume("sine", (64, 100, 128), block)
    data, _ = cvt.compress(vol, 1e-2, block=block)
    ref, _ = rle_host.host_compress_parity(vol, 1e-2, block=block)
    np.testing.assert_array_equal(np.asarray(data), ref)
    out = cvt.decompress(data).cpu().numpy()
    want = rle_host.host_decompress_parity(ref)
    assert np.array_equal(out.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("kind", ["half", "nan", "fused_nan"])
def test_generic_kernels_zero_and_nan_blocks(dev, kind):
    """Whole zero blocks (one run of 2^24 zeros in a 256^3 block: an RLESC3
    of 2^24 - 1 and a trailing [0], cost 5) and a NaN block, on the stripe
    route (raw: the einsums spread the NaN to the whole block) and on the
    fused stripe route at a block held by a cluster (native's parity
    cascade spreads it to part of the block, coded as VLESC4 tokens)."""
    block = (64, 32, 32) if kind == "fused_nan" else (256, 256, 256)
    shape = (64, 64, 128) if kind == "fused_nan" else (512, 256, 256)
    vol = generic_volume("half" if kind == "half" else "nan", shape, block)
    vt = torch.from_numpy(vol).to(dev)
    mulfac = quant.global_mulfac(np.nan_to_num(vol), 1e-2)
    c, dk, cbk, sk, rk, mk = generic_vs_plain(vt, block, mulfac)
    if kind == "half":
        assert rk.tolist() == [False, False] and int(sk[1]) == 5
        assert int(dk[1, -1]) == 5 | 8 | (((1 << 24) - 1) << 4)
    elif kind == "nan":
        assert rk.tolist() == [False] * (rk.numel() - 1) + [True]
    else:
        nan = torch.isnan(c[-1])
        assert bool(nan.any()) and not bool(nan.all())


@pytest.mark.parametrize("block,shape", [
    ((8, 8, 8), (40, 50, 70)), ((8, 8, 1), (5, 50, 70)), ((64, 64, 64), (70, 90, 100)),
    ((128, 128, 128), (130, 128, 140)), ((16, 16, 1), (3, 50, 70)),
    ((16, 16, 16), (40, 50, 70)), ((64, 32, 32), (70, 40, 140)),
], ids=lambda v: "x".join(map(str, v)))
def test_generic_roundtrip_on_the_card(dev, block, shape):
    """The public API at the other geometries on the default device: the
    route's kernels and block_emit launch once, the decode kernels once;
    the volume agrees with the host engine and the native decoder, the size
    with the plain CPU path; a raw block and a local container too."""
    vol = generic_volume("sine", shape, block)
    for scale, local in ((1e-2, False), (1e-2, True), (1e-12, False)):
        names = route_kernels(shape, block, local)
        _kernels.reset_counts()
        data, _ = cvt.compress(vol, scale, block=block, use_local_rms=local)
        out = cvt.decompress(data)
        torch.cuda.synchronize()
        for k in (*names, "block_emit", "decode_maps", "decode_chase", "decode_emit"):
            assert _kernels.launches[k] == 1, k
        assert sum(_kernels.launches.values()) == 4 + len(names)
        ref, _ = cvt.compress(vol, scale, block=block, use_local_rms=local,
                              device="cpu")
        assert abs(int(data.size) - int(ref.size)) <= max(64, 0.01 * ref.size)
        assert rel_rms(out, cvt.decompress(data, engine="host")) < TRANSFORM_TOL
        nat = torch.from_numpy(rle_host.host_decompress(data))
        assert rel_rms(out.cpu(), nat) < TRANSFORM_TOL
        dense = decode_kernels_vs_plain(data, dev)
        hdr, blkoffs, blkmf, pbase = ctn.unpack(data)
        nd = rle_host.decode_payloads(data[pbase:], blkoffs, hdr.glob_mulfac,
                                      dense.shape[1], blkmf)
        np.testing.assert_array_equal(dense.cpu().numpy().view(np.uint32),
                                      nd.view(np.uint32))


def test_generic_wrappers_reject_bad_inputs(dev):
    with pytest.raises(ValueError):
        tokenize.tokenize_stripe(torch.zeros((16, 16, 32), device=dev),
                                 torch.ones(3, device=dev), (16, 16, 16))
    with pytest.raises(ValueError):
        fused_inverse.stripe_fused_inverse(torch.zeros(4096 * 3, device=dev),
                                           (16, 16, 32), (16, 16, 16))
    with pytest.raises(ValueError):
        tokenize.tokenize_stripe(torch.zeros((16, 16, 24), device=dev),
                                 torch.ones(2, device=dev), (16, 16, 16))
    with pytest.raises(ValueError):
        cvt.compress(np.zeros((8, 8, 8), np.float32), 1e-2, block=(8, 8, 2))


# -- the opt-in encode routes (the JAX package's CVX_* switches) ------------


def optin_volume(shape, sparse=True, seed=7):
    """N(0,1) x 40 with 80 % of the cells zero (zero runs across chunks,
    slices and tiles), or the plain noise."""
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal(shape) * 40).astype(np.float32)
    if sparse:
        v[rng.random(shape) >= 0.2] = 0.0
    return v


@pytest.mark.parametrize("kind", ["sparse", "noise"])
def test_block_encode_w_matches_plain_and_block_encode(dev, kind):
    """K16a + K16b: `block_fwd_xz` within 1e-5 of its plain version,
    `block_encode_y`'s coefficients within 1e-5 and its tokenize bit-equal
    to the plain tokenize of them; both launches' coefficients, descriptors,
    counts and sizes bit-equal to `block_encode`'s (z | x,y) on the same
    volume."""
    shape = (128, 128, 256)
    vol = optin_volume(shape, sparse=kind == "sparse")
    vt = torch.from_numpy(vol).to(dev)
    mulfac = 37.5
    _kernels.reset_counts()
    plane = fused_compress.fwd_xz(vt)
    out = fused_compress.encode_y(plane, mulfac)
    torch.cuda.synchronize()
    assert _kernels.launches["block_fwd_xz"] == 1
    assert _kernels.launches["block_encode_y"] == 1
    assert rel_rms(plane, fused_compress.fwd_xz_plain(vt)) < TRANSFORM_TOL
    coeffs = out[0]
    plain = fused_compress.encode_y_plain(plane, mulfac)[0]
    assert rel_rms(coeffs, plain) < TRANSFORM_TOL
    for got, ref in zip(out[1:5], tokenize.tokenize_blocks_plain(coeffs, mulfac)):
        assert torch.equal(got, ref)
    ref = fused_compress.block_encode(vt, mulfac)
    for got, want in zip(out, ref):
        assert torch.equal(got, want)


@pytest.mark.parametrize("block,shape", [
    ((16, 16, 16), (40, 50, 70)), ((32, 32, 32), (64, 96, 96)),
    ((64, 64, 64), (70, 90, 100)), ((8, 16, 8), (20, 40, 60)),
    ((8, 16, 8), (16, 416, 320)),  # A's width: 65 tiles
], ids=lambda v: "x".join(map(str, v)))
@pytest.mark.parametrize("scale", [1e-2, 1e-12])
def test_patch_extract_and_emit_rows_match_plain(dev, block, shape, scale):
    """K17 and the rows emit: `patch_extract`'s rows, descriptors and ids
    bit-equal to its plain version on the stripe route's plane (one
    launch; none where every block is raw), and the stream of `emit_rows` bit-equal to its plain version's
    and to the in-place `emit_chunks` stream (at 1e-12 with raw blocks)."""
    vol = generic_volume("sine", shape, block)
    vt = torch.from_numpy(vol).to(dev)
    c, dk, cbk, sk, rk, mk = tokenize.encode(vt, block, quant.global_mulfac(vol, scale))
    n = int((cbk > 0).sum())
    _kernels.reset_counts()
    rows, drows, ids = pack.patch_extract(c, dk, cbk, block, n)
    torch.cuda.synchronize()
    assert _kernels.launches["patch_extract"] == (1 if n else 0)  # none when all raw
    plain = pack.patch_extract_plain(c, dk, cbk, block, n)
    for got, ref in zip((rows, drows, ids), plain):
        assert torch.equal(got, ref)
    base = torch.cumsum(cbk.long(), 0) - cbk.long()
    total = int(cbk.sum())
    got = pack.emit_rows(rows, drows, ids, mk, cbk, base, total)
    assert _kernels.launches["block_emit_rows"] == 1
    assert torch.equal(got, pack.emit_rows_plain(rows, drows, ids, mk, cbk, base, total))
    assert torch.equal(got, pack.emit_chunks(c, mk, dk, cbk, base, total, block))
    if scale == 1e-12:
        assert bool(rk.any())


@pytest.mark.parametrize("name", list(pc.CASES))
def test_patch_extract_walk_cases(dev, name):
    """K17 on the cases of tests/patch_walk_cases.py (no live chunk: no
    launch; every chunk live; one live chunk in the last window; raw blocks
    between live ones; the patch route's blocks), bit-equal to its plain
    version in one launch; twice in a row (the launcher zeroes its scratch
    each call)."""
    c = pc.make(name, dev)
    args = (c["plane"], c["desc"], c["chunk_bytes"], c["block"], c["nlive"])
    want = pack.patch_extract_plain(*args)
    for _ in range(2):
        _kernels.reset_counts()
        got = pack.patch_extract(*args)
        torch.cuda.synchronize()
        assert _kernels.launches["patch_extract"] == (1 if c["nlive"] else 0)
        for g, w in zip(got, want):
            assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("block,shape,live", [
    ((8, 16, 8), (80, 400, 1016), 0.1), ((8, 16, 8), (80, 400, 1016), 1.0),
    ((16, 16, 16), (80, 400, 1008), 1.0),
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_patch_extract_many_tiles(dev, block, shape, live):
    """K17 over more tiles than the card holds CTAs (993 and 985 tiles, the
    last cut short), synthetic counts (any chunk live with probability
    `live`: both of the launcher's shapes, the x-neighbour order at 8
    chunks a block) and a view of the plane at a 4-byte offset (the wrapper
    copies it to 16-byte alignment): bit-equal to its plain version, which
    takes any counts."""
    cells = block[0] * block[1] * block[2]
    nnn = shape[0] * shape[1] * shape[2] // cells
    g = torch.Generator(device=dev).manual_seed(3)
    plane = torch.randn(nnn * cells + 1, device=dev, generator=g)[1:].view(shape)
    desc = torch.randint(-2**31, 2**31 - 1, (nnn, cells), device=dev, generator=g,
                         dtype=torch.int32)
    nchunks = nnn * cells // 128
    cb = ((torch.rand(nchunks, device=dev, generator=g) < live)
          * torch.randint(1, 600, (nchunks,), device=dev, generator=g)).to(torch.int32)
    n = int((cb > 0).sum())
    assert -(-nchunks // pack.PATCH_TILE) in (993, 985)
    _kernels.reset_counts()
    got = pack.patch_extract(plane, desc, cb, block, n)
    torch.cuda.synchronize()
    assert _kernels.launches["patch_extract"] == 1
    for a, b in zip(got, pack.patch_extract_plain(plane, desc, cb, block, n)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("block,shape", [
    ((32, 32, 32), (64, 64, 64)), ((128, 128, 128), (128, 128, 256)),
    ((8, 16, 8), (40, 48, 64)), ((256, 256, 256), (256, 256, 256)),
], ids=lambda v: "x".join(map(str, v)))
@pytest.mark.parametrize("mode", ["global", "local", "raw"])
def test_tokenize_compact_matches_plain(dev, block, shape, mode):
    """K14: `tokenize_compact`'s chunk counts, sizes, raw flags, live rows
    (coefficients, descriptors, ids, byte counts, in chunk order) and their
    number bit-equal to its plain version's, zero runs across tiles (a
    128^3 block spans 128 tiles, a 256^3 one 1,024) and live rows across
    tiles; the rows emit's stream bit-equal to the in-place emit's."""
    vol = optin_volume(shape)
    vol[: shape[0] // 2, :, : shape[2] // 2] = 0.0  # whole zero tiles
    vt = torch.from_numpy(vol).to(dev)
    args = (dict(scale=1e-2) if mode == "local" else
            dict(mulfac=quant.global_mulfac(vol, 1e-12 if mode == "raw" else 1e-2)))
    _kernels.reset_counts()
    coeffs, mk, *out = tokenize.compact_encode(vt, block, **args)
    torch.cuda.synchronize()
    assert _kernels.launches["tokenize_compact"] == 1
    ref = tokenize.tokenize_compact_plain(coeffs, mk)
    n = int(out[7])
    assert n == int(ref[7]) == ref[3].shape[0]
    for got, want in zip(out[:3], ref[:3]):
        assert torch.equal(got, want)
    for got, want in zip(out[3:7], ref[3:7]):
        assert torch.equal(got[:n], want)
    cbk = out[0]
    base = torch.cumsum(cbk.long(), 0) - cbk.long()
    total = int(cbk.sum())
    got = pack.emit_rows(out[3][:n], out[4][:n], out[5][:n], mk, cbk, base, total)
    desc = tokenize.tokenize_blocks_plain(coeffs, mk)[0]
    assert torch.equal(got, pack.emit_chunks(coeffs, mk, desc, cbk, base, total))
    assert bool(out[2].any()) == (mode == "raw")


@pytest.mark.parametrize("kind", tc.COMPACT_KINDS)
def test_tokenize_compact_across_tile_seams(dev, kind):
    """K14 against its plain version on the cases of
    tests/tile_tokenize_cases.py (zero stretches over many tiles, tiles with
    no live chunk between live ones, a 256^3 block over 1,024 tiles, a half
    full last tile, raw blocks, a NaN cell), the coefficients also at a
    misaligned view (the wrapper copies it for the bulk copies)."""
    c, mf = tc.compact_case(kind)
    ct = torch.from_numpy(c).to(dev)
    mk = torch.from_numpy(mf).to(dev)
    ref = tokenize.tokenize_compact_plain(ct, mk)
    view = torch.zeros(ct.numel() + 1, device=dev)[1:].view(ct.shape)
    view.copy_(ct)
    for x in (ct, view):
        _kernels.reset_counts()
        out = tokenize.tokenize_compact(x, mk)
        torch.cuda.synchronize()
        assert _kernels.launches["tokenize_compact"] == 1
        n = int(out[7])
        assert n == ref[3].shape[0]
        for got, want in zip(out[:3], ref[:3]):
            assert torch.equal(got, want)
        assert torch.equal(out[3][:n].view(torch.int32), ref[3].view(torch.int32))
        for got, want in zip(out[4:7], ref[4:7]):
            assert torch.equal(got[:n], want)


@pytest.mark.parametrize("kind", tc.LOCAL_KINDS)
def test_block_scale_tok_across_slice_seams(dev, kind):
    """K10b against its plain version on the cases of
    tests/tile_tokenize_cases.py: a zero stretch of 96 slices, an all-zero
    block (mulfac 1.0), a NaN cell, a raw block."""
    c, scale = tc.local_case(kind)
    ck = torch.from_numpy(c).to(dev)
    pk = quant.cta_sumsq(ck.view(-1, 128 * 128), 256).view(-1, 128)
    _kernels.reset_counts()
    got = fused_compress.scale_tok(ck, pk, scale)
    torch.cuda.synchronize()
    assert _kernels.launches["block_scale_tok"] == 1
    ref = fused_compress.scale_tok_plain(ck, pk, scale)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert bool(ref[3].any()) == (kind == "raw_nan")


@pytest.mark.parametrize("env,block,shape,local,kernels", [
    ({"CVX_FUSED_W": "1"}, (128, 128, 128), (128, 128, 256), False,
     ("block_fwd_xz", "block_encode_y", "block_emit")),
    ({"CVX_FUSED_W": "0"}, (128, 128, 128), (128, 128, 256), False,
     ("tokenize_stripe", "block_emit")),
    ({"CVX_STRIPE": "patch"}, (32, 32, 32), (64, 96, 96), False,
     ("tokenize_stripe", "patch_extract", "block_emit_rows")),
    ({"CVX_STRIPE": "patch"}, (16, 16, 16), (40, 50, 70), True,
     ("tokenize_stripe", "patch_extract", "block_emit_rows")),
    ({"CVX_FUSED_COMPACT": "1"}, (32, 32, 32), (64, 64, 64), False,
     ("tokenize_compact", "block_emit_rows")),
    ({"CVX_FUSED_COMPACT": "1"}, (32, 32, 32), (64, 64, 64), True,
     ("tokenize_compact", "block_emit_rows")),
    ({"CVX_FUSED_COMPACT": "1"}, (128, 128, 128), (128, 128, 256), False,
     ("tokenize_compact", "block_emit_rows")),
], ids=["fused_w1", "fused_w0", "patch32", "patch16_local", "compact32",
        "compact32_local", "compact128"])
def test_optin_routes_on_the_card(dev, monkeypatch, env, block, shape, local, kernels):
    """Each switch through the public API on the card: its encode kernels
    launch once each with the decode kernels, no other; the container's size
    within 1 % of the plain CPU path's under the same switch, its volume
    within 1e-5 of the host engine's and native's decode."""
    vol = generic_volume("sine", shape, block)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _kernels.reset_counts()
    data, _ = cvt.compress(vol, 1e-2, block=block, use_local_rms=local)
    out = cvt.decompress(data)
    torch.cuda.synchronize()
    inverse = {"fused32": ("fused_inverse",), "block128": ("block_inv_xy", "block_inv_z"),
               "stripe_fused": ("stripe_fused_inverse",), "stripe": ()}
    want = dict.fromkeys((*kernels, "decode_maps", "decode_chase", "decode_emit",
                          *inverse[codec.route(shape, block)]), 1)
    assert {k: v for k, v in _kernels.launches.items() if v} == want
    ref, _ = cvt.compress(vol, 1e-2, block=block, use_local_rms=local, device="cpu")
    assert abs(int(data.size) - int(ref.size)) <= max(64, 0.01 * ref.size)
    assert rel_rms(out, cvt.decompress(data, engine="host")) < TRANSFORM_TOL
    nat = torch.from_numpy(rle_host.host_decompress(data))
    assert rel_rms(out.cpu(), nat) < TRANSFORM_TOL


def test_fused_w1_and_patch64_containers_equal_default(dev, monkeypatch):
    """Where the coefficients are the default route's, so is the container:
    `CVX_FUSED_W=1` at aligned 128^3, `CVX_STRIPE=patch` at 64^3 (the
    stripe route's encode either way)."""
    for env, block, shape in (({"CVX_FUSED_W": "1"}, (128,) * 3, (128, 128, 256)),
                              ({"CVX_STRIPE": "patch"}, (64,) * 3, (70, 90, 100))):
        vol = generic_volume("sine", shape, block)
        ref, _ = cvt.compress(vol, 1e-2, block=block)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        got, _ = cvt.compress(vol, 1e-2, block=block)
        for k in env:
            monkeypatch.delenv(k)
        np.testing.assert_array_equal(got, ref)


def test_transform_exact_under_caller_tf32(dev):
    """Under the caller's `set_float32_matmul_precision("high")` the stripe
    route's einsums still run in full f32: the 8^3 transform within 1e-5 of
    the f64 operator product, the container equal to the one made under
    "highest", and the caller's setting left as it was."""
    from cvxcompress_tpu_torch.ops import wavelet

    block = (8, 8, 8)
    vol = np.random.default_rng(64).standard_normal((64, 64, 64)).astype(np.float32)
    ref, _ = cvt.compress(vol, 1e-2, block=block)
    w = torch.from_numpy(np.array(wavelet.forward_matrix(8)))
    want = torch.einsum("nzyx,Zz,Yy,Xx->nZYX",
                        blocks.to_blocks(torch.from_numpy(vol).double(), block), w, w, w)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        plane = wavelet.forward_3d_volume(torch.from_numpy(vol).to(dev), block)
        got, _ = cvt.compress(vol, 1e-2, block=block)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert rel_rms(blocks.to_blocks(plane.cpu(), block), want) < TRANSFORM_TOL
    np.testing.assert_array_equal(got, ref)


def test_volume_on_another_card(dev):
    """A volume on the last card compresses and decompresses there while
    card 0 is current: the kernels launch on the tensor's card (the codec
    enters its `torch.cuda.device`), and the containers and volumes equal
    card 0's, on the fused 32^3 route and on the stripe route."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    assert torch.cuda.current_device() == 0
    vol = generic_volume("sine", (64, 96, 96), (32, 32, 32))
    for block in ((32, 32, 32), (8, 8, 8)):
        ref, _ = cvt.compress(vol, 1e-2, block=block, device="cuda:0")
        data, _ = cvt.compress(torch.from_numpy(vol).to(last), 1e-2, block=block)
        np.testing.assert_array_equal(data, ref)
        out = cvt.decompress(data, device=last)
        assert out.device == last and torch.cuda.current_device() == 0
        want = cvt.decompress(ref, device="cuda:0")
        assert torch.equal(out.cpu(), want.cpu())


# -- the batched codecs, the streams and the snapshot stack on the card -------

SHAPE_A = (352, 416, 320)


def card_sinusoids(dev, shape, k, local=False):
    """k sinusoids of different phase, born on the card."""
    nz = shape[0]
    z = torch.arange(nz, dtype=torch.float32, device=dev) * (np.pi * 10 / nz)
    out = []
    for j in range(k):
        v = torch.sin(z + 0.7 * j)[:, None, None].expand(shape).contiguous()
        if local:
            v[: nz // 2] *= 1e-3  # block RMS far apart
        out.append(v)
    return out


@pytest.mark.parametrize("local", [False, True])
def test_compress_decompress_many_equal_single_at_a(dev, local):
    """compress_many / decompress_many at A's shape: each container
    byte-equal to a single compress, each volume bit-equal to a single
    device-engine decompress."""
    vols = card_sinusoids(dev, SHAPE_A, 3, local)
    singles = [cvt.compress(v, 1e-2, use_local_rms=local)[0] for v in vols]
    got = codec.compress_many(vols, 1e-2, use_local_rms=local)
    for d, (g, _) in zip(singles, got):
        assert np.array_equal(d, g)
    outs = codec.decompress_many(singles, "cuda", to_host=False)
    host = codec.decompress_many(singles, "cuda", to_host=True)
    for d, o, h in zip(singles, outs, host):
        ref = cvt.decompress(d, engine="device")
        assert torch.equal(o.view(torch.int32), ref.view(torch.int32))
        assert np.array_equal(h.view(np.uint32), ref.cpu().numpy().view(np.uint32))


def test_compress_stream_from_four_threads(dev):
    """compress_stream with 4 worker threads, each on its own CUDA stream,
    20 rounds over volumes born on the card: every container byte-equal to
    the single compress, in order, every round."""
    from cvxcompress_tpu_torch import pipeline

    vols = card_sinusoids(dev, (128, 160, 192), 8)
    refs = [cvt.compress(v, 1e-2)[0] for v in vols]
    for r in range(20):
        got = list(pipeline.compress_stream(iter(vols), 1e-2, workers=4))
        assert len(got) == len(refs)
        for i, ((d, _), ref) in enumerate(zip(got, refs)):
            assert np.array_equal(d, ref), (r, i)
    outs = list(pipeline.decompress_stream(refs, workers=4))
    for d, o in zip(refs, outs):
        ref = cvt.decompress(d)
        assert torch.equal(o.view(torch.int32), ref.view(torch.int32))


def test_stream_batched_on_the_card(dev):
    """The batched streams on their CUDA streams, inputs made on the
    caller's stream: containers and volumes equal the single calls."""
    from cvxcompress_tpu_torch import pipeline

    vols = card_sinusoids(dev, (128, 160, 192), 7)
    refs = [cvt.compress(v, 1e-2)[0] for v in vols]
    got = list(pipeline.compress_stream_batched(iter(vols), 1e-2, batch=3))
    assert all(np.array_equal(d, r) for (d, _), r in zip(got, refs))
    for to_host in (False, True):
        outs = list(pipeline.decompress_stream_batched(iter(refs), batch=3,
                                                       to_host=to_host))
        assert len(outs) == len(refs)
        for d, o in zip(refs, outs):
            ref = cvt.decompress(d, engine="device")
            o = torch.as_tensor(o).to(dev)
            assert torch.equal(o.view(torch.int32), ref.view(torch.int32))


def test_snapshot_pending_after_volumes_freed(dev):
    """A stack whose pending checks resolve after the volumes they came
    from were freed and their memory written over: every snapshot still
    equals the device-engine decompress of its container, and its
    container the single compress of a copy of the volume."""
    from cvxcompress_tpu_torch import DeviceSnapshotStack

    shape = (128, 160, 192)
    st = DeviceSnapshotStack(shape, 1e-2, max_pending=4)
    refs = []
    for j in range(4):
        v = card_sinusoids(dev, shape, j + 1)[j]
        refs.append(cvt.compress(v.clone(), 1e-2)[0])
        st.append(v)
        del v
    torch.cuda.empty_cache()
    junk = [torch.full(shape, float("nan"), device=dev) for _ in range(4)]
    assert len(st._pending) == 4
    st.flush()
    del junk
    for i, ref in enumerate(refs):
        assert np.array_equal(st.to_container(i), ref)
        out = st.get(i)
        dec = cvt.decompress(ref, engine="device")
        assert torch.equal(out.view(torch.int32), dec.view(torch.int32))


@pytest.mark.parametrize("block", [(32, 32, 32), (16, 16, 16), (8, 8, 8)])
def test_snapshot_stack_on_the_card(dev, block):
    """The stack on the card: dense_fiv the codec's quantized values,
    get equal to the device engine's decompress of to_container, a forced
    capacity overflow, pop in reverse."""
    from cvxcompress_tpu_torch import DeviceSnapshotStack

    shape = (96, 128, 160)
    vols = card_sinusoids(dev, shape, 3)
    spike = torch.zeros(shape, device=dev)
    spike[0, 0, 0] = 1.0
    st = DeviceSnapshotStack(shape, 1e-2, block, max_pending=1)
    st.append(spike)  # a capacity of one chunk: the next append overflows
    for v in vols:
        st.append(v)
    gets = []
    for i in range(len(st)):
        c = st.to_container(i)
        hdr, blkoffs, _, pbase = ctn.unpack(c)
        payload = np.frombuffer(memoryview(c), dtype=np.uint8)[pbase:]
        iv = rle_host.decode_payloads(payload, blkoffs, np.float32(1.0), st.cells)
        assert np.array_equal(st.dense_fiv(i).view(np.uint32), iv.view(np.uint32))
        if i:
            assert np.array_equal(c, cvt.compress(vols[i - 1], 1e-2, block)[0])
        g = st.get(i)
        dec = cvt.decompress(c, engine="device")
        assert torch.equal(g.view(torch.int32), dec.view(torch.int32))
        gets.append(g)
    for i in reversed(range(len(gets))):
        assert torch.equal(st.pop().view(torch.int32), gets[i].view(torch.int32))


@pytest.mark.parametrize("shape,block", [((130, 96, 96), (32, 32, 32)),
                                         ((384, 128, 128), (128, 128, 128)),
                                         ((200, 128, 128), (128, 128, 128))])
def test_parallel_mesh_of_four_shards_on_one_card(dev, shape, block):
    """Four shards on cuda:0, each on a stream of its own: the container of
    a numpy volume and of a card tensor byte-equal to the single compress's
    on the kernel routes (level 3 on the stripe route of the unaligned
    128^3 volume), four launches of the route's encode, the decompress
    bit-equal to the single device-engine one (within 1e-5 on the stripe
    route), one decode launch a slab."""
    from cvxcompress_tpu_torch.parallel import compress as pc
    from cvxcompress_tpu_torch.parallel import mesh as ml
    from cvxcompress_tpu_torch.parallel import sharded

    mesh = ml.make_mesh(["cuda:0"] * 4)
    vol = volume(np.random.default_rng(5), shape)
    exact = codec.route(shape, block) != "stripe"
    for v in (vol, torch.from_numpy(vol).to(dev)):
        want = codec.compress(v, 1e-2, block)[0]
        _kernels.reset_counts()
        got, _ = pc.compress(v, 1e-2, block, mesh=mesh)
        torch.cuda.synchronize()
        plan = sharded.plan_shards(shape, block, 4)
        assert _kernels.launches["block_emit"] == sum(z1 > z0 for z0, z1 in plan)
        # a card tensor's f64 sums add per shard: the f32 mulfac may flip
        same_mulfac = ctn.unpack(got)[0].glob_mulfac == ctn.unpack(want)[0].glob_mulfac
        if exact and same_mulfac:
            assert np.array_equal(got, want)
        else:
            assert abs(got.size - want.size) <= max(64, 0.01 * want.size)
    ref = codec.decompress(want, engine="device")
    _kernels.reset_counts()
    out = pc.decompress(want, mesh=mesh)
    torch.cuda.synchronize()
    assert _kernels.launches["decode_emit"] == len(pc.decode_ranges(want, 4))
    if exact:
        assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    else:
        assert rel_rms(out, ref) < TRANSFORM_TOL


@pytest.mark.parametrize("mode", ["allgather", "files"])
def test_multihost_two_processes_on_the_card(dev, tmp_path, mode):
    """Two processes on cuda:0 over gloo: the container byte-equal to the
    single compress on the card."""
    from test_torch_multihost_mp import BLOCK, SHAPE, run_pair
    from cvxcompress_tpu_torch.utils import volumes

    got = run_pair(tmp_path, mode, device="cuda:0")
    want = codec.compress(volumes.radial_volume(*SHAPE), 1e-2, BLOCK)[0]
    assert np.array_equal(got, want)
