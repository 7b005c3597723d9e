"""The stripe, patch and compact routes on native's parity cascade (the plain
versions of csrc/plane_cascade.cu): `forward_3d_volume_plain` bit-equal to
the block batch's `cascade_3d` and to a numpy transcription of native's
parity cascade, with partial edge blocks; the CPU compress on the three
routes giving `cvx_compress_parity_th`'s container under the global RMS, and
the CPU decompress `cvx_decompress_inplace_parity_th`'s volume, at the
stripe route's geometries and on the inputs where the dense products spread
a non-finite cell (NaN, inf, 3e38); a sharded stripe-route compress
byte-equal to the single call; the kernels' pass plan over every legal
block; the block-major forward and the inverse into the volume (plain
versions) bit-equal to the compositions they replace, and the stripe
decode and the compact encode going through them.  No JAX call."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
torch.set_num_threads(1)  # one thread a process: the suite runs in parallel workers

import cvxcompress_tpu_torch as cvt
from cvxcompress_tpu_torch import container as ctn
from cvxcompress_tpu_torch.ops import blocks, codec, quant, rle_host, tokenize, wavelet
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


# every legal block: each edge 8 .. 256, bz also 1
EDGES = (8, 16, 32, 64, 128, 256)
ALL_BLOCKS = [(bx, by, bz) for bx in EDGES for by in EDGES for bz in (1, *EDGES)]


def plan_bytes(shape, block, inverse, layout):
    """Bytes the plan's passes move over (nz, ny, nx): each pass reads its
    source once and writes its destination once (the volume's cells where
    it reads or writes the volume, the padded cells elsewhere)."""
    vol = 4 * int(np.prod(shape))
    padded = 4 * int(np.prod(wavelet._padded(shape, block)))
    side = {wavelet.VOL: vol, wavelet.CLIP: vol, wavelet.PLANE: padded,
            wavelet.BLOCKS: padded}
    return sum(side[r[5] & 3] + side[r[6] & 3]
               for r in wavelet.launch_plan(block, inverse, layout))


def test_pass_plan_covers_every_block():
    """Every legal block (6 x 6 x 7 = 252) has a class and passes whose
    tiles hold 2^PLAN_LTILE cells of whole lines, running x, then y, then z
    once each; the kernel's shared memory fits 227 KiB; the plan's bytes
    are the bound's (each input read once, each output written once) for
    class a, one padded read and write more a pass after the first."""
    assert len(ALL_BLOCKS) == 252
    t = wavelet.PLAN_LTILE
    # csrc/plane_cascade.cu PC_SMEM: two tile buffers, their tables (32
    # bytes a block of at least 64 cells), 1 KiB of alignment slack
    assert 2 * (4 << t) + 2 * 32 * (1 << t) // 64 + 1024 <= 227 * 1024
    shape = (300, 270, 260)  # partial blocks on every axis at most blocks
    seen = set()
    for block in ALL_BLOCKS:
        lbx, lby, lbz = (int(b).bit_length() - 1 for b in block)
        cls, passes = wavelet.pass_plan(block)
        seen.add(cls)
        assert cls == ("a" if lbx + lby + lbz <= t else "b" if lbx + lby <= t else "c")
        order = []
        for axes, (ltz, lty, ltx), lnb in passes:
            assert lnb + ltz + lty + ltx == t, block
            assert 3 <= ltx <= lbx and 0 <= lty <= lby and 0 <= ltz <= lbz, block
            assert not lnb or (ltz, lty, ltx) == (lbz, lby, lbx), block
            assert lnb <= t - 6  # the launcher's table holds 2^(t - 6) blocks
            for bit, (l, lb) in ((1, (ltx, lbx)), (2, (lty, lby)), (4, (ltz, lbz))):
                if axes & bit:
                    assert l == lb, block  # whole lines
                    order.append(bit)
        assert order == ([1, 2, 4] if lbz else [1, 2]), block
        pad = 4 * int(np.prod(wavelet._padded(shape, block)))
        vol = 4 * int(np.prod(shape))
        for inverse, layout in ((False, wavelet.PLANE), (False, wavelet.BLOCKS),
                                (True, wavelet.PLANE)):
            plan = wavelet.launch_plan(block, inverse, layout)
            assert plan.dtype == np.int32 and plan.shape == (len(passes), 7)
            assert plan_bytes(shape, block, inverse, layout) == (
                vol + pad + 2 * pad * (len(passes) - 1)), block
            first, last = plan[0, 5], plan[-1, 6]
            assert first == (wavelet.IN * 4 + (wavelet.BLOCKS if inverse else wavelet.VOL))
            assert last == wavelet.OUT * 4 + (wavelet.CLIP if inverse else layout)
            mid = plan[:-1, 6] >> 2
            assert (mid == (wavelet.SCRATCH if inverse else wavelet.OUT)).all()
    assert seen == {"a", "b", "c"}


def views(vol):
    """The volume contiguous, transposed in memory (x slowest) and as a
    slice of a wider one: the strides the kernels read through."""
    t = torch.from_numpy(vol)
    wide = torch.zeros(vol.shape[0], vol.shape[1], vol.shape[2] + 3)
    wide[:, :, 1:-2] = t
    return (t, torch.from_numpy(np.ascontiguousarray(vol.transpose(2, 1, 0))).permute(2, 1, 0),
            wide[:, :, 1:-2])


@pytest.mark.parametrize("block,shape", TRANSFORM_CASES + [
    ((16, 32, 64), (70, 40, 20)), ((256, 128, 8), (10, 130, 260)),
    ((8, 256, 16), (20, 260, 10)), ((32, 32, 32), (33, 31, 65))],
    ids=lambda v: "x".join(map(str, v)))
def test_fused_relayout_entry_points_plain(block, shape):
    """On the CPU `forward_blocks_of_volume` is `cascade_3d` of
    `to_blocks` and `inverse_to_volume` is `from_blocks` of the inverse
    `cascade_3d`, bit for bit, partial edge blocks included and on strided
    views; the batch is the plane's blocks, and the inverse gives back the
    batch's volume (native's transcription, `np_cascade_3d`)."""
    vol = field(shape, sum(block) + 1)
    # every view holds the same cells: one reference serves them all
    ref = wavelet.cascade_3d(blocks.to_blocks(torch.from_numpy(vol), block), inverse=False)
    for v in views(vol):
        got = wavelet.forward_blocks_of_volume(v, block)
        assert got.shape == ref.shape
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(blocks.to_blocks(wavelet.forward_3d_volume(views(vol)[0], block),
                                        block).view(torch.int32), ref.view(torch.int32))
    want = blocks.from_blocks(wavelet.cascade_3d(ref, inverse=True), shape, block)
    for c in (ref, ref.reshape(ref.shape[0], -1)):
        inv = wavelet.inverse_to_volume(c, shape, block)
        assert inv.shape == shape
        assert torch.equal(inv.view(torch.int32), want.view(torch.int32))
    nat = np_cascade_3d(ref.numpy(), inverse=True)
    np.testing.assert_array_equal(
        inv.numpy().view(np.uint32),
        blocks.from_blocks(torch.from_numpy(nat), shape, block).numpy().view(np.uint32))


@pytest.mark.parametrize("route", ["stripe", "compact"])
def test_routes_relayout_in_the_transform(monkeypatch, route):
    """The stripe route's decode runs `wavelet.inverse_to_volume` once and
    the compact encode `wavelet.forward_blocks_of_volume` once, and neither
    runs `blocks.from_blocks` or `blocks.to_blocks` outside them (on the
    card those entry points are one kernel each, no PyTorch relayout)."""
    for k in ("CVX_STRIPE", "CVX_FUSED_COMPACT", "CVX_FUSED_W"):
        monkeypatch.delenv(k, raising=False)
    block, shape = (8, 8, 8), (48, 64, 96)
    vol = field(shape, 7)
    calls, depth = [], [0]

    def spy(name, fn):
        def run(*a, **kw):
            calls.append(name)
            depth[0] += 1
            try:
                return fn(*a, **kw)
            finally:
                depth[0] -= 1
        return run

    def guard(name, fn):
        def run(*a, **kw):
            assert depth[0], f"blocks.{name} outside the transform's entry points"
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(wavelet, "inverse_to_volume",
                        spy("inverse_to_volume", wavelet.inverse_to_volume))
    monkeypatch.setattr(wavelet, "forward_blocks_of_volume",
                        spy("forward_blocks_of_volume", wavelet.forward_blocks_of_volume))
    guards = [("to_blocks", blocks.to_blocks), ("from_blocks", blocks.from_blocks)]
    if route == "stripe":
        data, _ = cvt.compress(vol, SCALE, block=block, device="cpu")
        for name, fn in guards:
            monkeypatch.setattr(blocks, name, guard(name, fn))
        out = cvt.decompress(data, device="cpu", engine="device")
        assert calls == ["inverse_to_volume"]
        vref = rle_host.host_decompress_parity(
            rle_host.host_compress_parity(vol, SCALE, block=block)[0])
        np.testing.assert_array_equal(out.numpy().view(np.uint32), vref.view(np.uint32))
    else:
        batch = blocks.to_blocks(torch.from_numpy(vol), block).numpy()
        for name, fn in guards:
            monkeypatch.setattr(blocks, name, guard(name, fn))
        coeffs = tokenize.compact_encode(torch.from_numpy(vol), block,
                                         quant.global_mulfac(vol, SCALE))[0]
        assert calls == ["forward_blocks_of_volume"]
        nat = np_cascade_3d(batch, inverse=False)
        np.testing.assert_array_equal(coeffs.numpy().view(np.uint32),
                                      nat.reshape(coeffs.shape).view(np.uint32))


def psw(w):
    """csrc/plane_cascade.cu `psw`: where word w of a tile lives."""
    return w ^ ((((w >> 5) ^ (w >> 8) ^ (w >> 11)) & 7) << 2)


def lanes_per_bank(words, vec4=False):
    """The most lanes of one shared-memory access that meet on a bank
    (distinct words): scalar words per warp, float4s per quarter warp."""
    worst = 1
    for q in range(4 if vec4 else 1):
        part = words[8 * q:8 * q + 8] if vec4 else words
        banks = {}
        for w in {psw(x) for x in part}:
            banks.setdefault((w >> 2) & 7 if vec4 else w & 31, set()).add(w)
        worst = max(worst, max(len(v) for v in banks.values()))
    return worst


@pytest.mark.parametrize("block", [(8, 8, 8), (16, 16, 16), (64, 64, 64), (256, 256, 256),
                                   (128, 8, 8), (8, 8, 1), (8, 256, 8), (32, 32, 16)],
                         ids=lambda v: "x".join(map(str, v)))
def test_swizzle_banks(block):
    """The kernels' shared-memory accesses, modelled: a warp's lanes take
    consecutive lines (lines of 64 to 256 cells: N / 32 lanes a line, 32
    cells a lane), rows of up to 32 cells and a lane's own cells of a row
    read as float4s.  Every copy of the lines' cells meets at most 2 lanes
    to a bank; the highpass accesses of rows of 64 to 256 cells at most 4,
    of y- and z-lines at most 2."""
    t = wavelet.PLAN_LTILE
    for axes, (ltz, lty, ltx), _ in wavelet.pass_plan(block)[1]:
        lf = ltx + lty
        for bit, ln, L, off in (
                (1, ltx, 0, lambda l: l << ltx),
                (2, lty, ltx, lambda l: ((l >> ltx) << lf) + (l & ((1 << ltx) - 1))),
                (4, ltz, lf, lambda l: ((l >> lf) << (lf + ltz)) + (l & ((1 << lf) - 1)))):
            if not axes & bit:
                continue
            n = 1 << ln
            for warp in range(16):
                lanes = range(32 * warp, 32 * warp + 32)
                if n <= 32:
                    if bit == 1:
                        worst = max(lanes_per_bank([(k << ltx) + 4 * c for k in lanes], True)
                                    for c in range(n // 4))
                    else:
                        worst = max(lanes_per_bank([off(k) + (i << L) for k in lanes
                                                    if k < (1 << t) // n]) for i in range(n))
                    assert worst <= 2, (block, bit)
                    continue
                S = n // 32
                line = [off((k >> 5) * (32 // S) + (k & 31) // S) for k in lanes]
                seg = [k & (S - 1) for k in lanes]
                if bit == 1:
                    own = max(lanes_per_bank([a + 32 * s + 4 * c for a, s in zip(line, seg)],
                                             True) for c in range(8))
                else:
                    own = max(lanes_per_bank([a + ((32 * s + i) << L)
                                              for a, s in zip(line, seg)]) for i in range(32))
                assert own <= 2, (block, bit)
                m = 32
                while m >= 4:  # the highpass cells of level n = m S
                    h, q = m * S // 2, m // 2
                    hi = max(lanes_per_bank([a + ((h + q * s + j) << L)
                                             for a, s in zip(line, seg)]) for j in range(q))
                    assert hi <= (4 if bit == 1 else 2), (block, bit, m)
                    m //= 2
