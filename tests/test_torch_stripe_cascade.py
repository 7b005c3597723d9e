"""The fused stripe route on the native parity cascade: the plain versions
of csrc/stripe_fused.cu (`stripe_fused_encode_plain`,
`stripe_fused_inverse_plain`) against a numpy transcription of the native
library's parity cascade in its x, y, z order, bit for bit, at 16^3,
(16, 16, 1), (8, 16, 8), (32, 32, 16) and (64, 32, 32) (a block over one
CTA: a cluster's); the CPU compress giving native
`cvx_compress_parity_th`'s container and the CPU decompress native
`cvx_decompress_inplace_parity_th`'s volume; and the local RMS's f64 sum in
the order the kernels' warps and cluster ranks hold the coefficients.  No
JAX call."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
torch.set_num_threads(1)  # one thread a process: the suite runs in parallel workers

import cvxcompress_tpu_torch as cvt
from cvxcompress_tpu_torch import container as ctn
from cvxcompress_tpu_torch.ops import blocks, codec, fused_inverse, quant, rle_host, tokenize

from test_torch_block32 import np_cascade_3d
from test_torch_cascade import bits_differ

F32 = np.float32
SCALE = 1e-2
# block -> a volume with partial edge blocks (a whole one for the cluster's)
CASES = {
    (16, 16, 16): (20, 36, 52),
    (16, 16, 1): (3, 40, 52),
    (8, 16, 8): (12, 36, 20),
    (32, 32, 16): (20, 40, 70),
    (64, 32, 32): (64, 64, 128),
}
IDS = ["x".join(map(str, b)) for b in CASES]


def volume(block):
    """A z sinusoid and noise, large and subnormal cells (every token class,
    coefficients whose last bits depend on the operation order), one block
    all zero and one scaled to ~1e-38."""
    shape = CASES[block]
    rng = np.random.default_rng(sum(block))
    nz = shape[0]
    z = np.sin(np.arange(nz) * np.pi * 3 / nz).astype(F32)
    v = np.broadcast_to(z[:, None, None], shape).copy()
    v += rng.standard_normal(shape).astype(F32) * F32(1e-2)
    v[-1, -2, :4] = [50.0, -50.0, 1e4, -1e4]
    v[-2:, 5:9, -12:] = F32(3e-39)
    bx, by, bz = block
    v[:bz, :by, :bx] = 0.0
    v[:bz, :by, bx:2 * bx] *= F32(1e-38)
    return v


@pytest.mark.parametrize("block", list(CASES), ids=IDS)
def test_plain_encode_is_native_parity_cascade(block):
    """The plain encode's coefficients are native's x, y, z parity cascade of
    the zero-padded blocks, bit for bit; the route is the fused stripe one."""
    vol = volume(block)
    assert codec.route(vol.shape, block) == "stripe_fused"
    coeffs = tokenize.stripe_fused_encode_plain(torch.from_numpy(vol), block, 37.5)[0]
    blk = blocks.to_blocks(torch.from_numpy(vol), block).numpy()
    want = np_cascade_3d(blk, False).reshape(coeffs.shape)
    assert bits_differ(coeffs.numpy(), want) == 0


@pytest.mark.parametrize("block", list(CASES), ids=IDS)
def test_plain_inverse_is_native_parity_cascade(block):
    """The plain inverse is native's x, y, z inverse parity cascade of each
    block, clipped to the volume, bit for bit."""
    shape = CASES[block]
    bx, by, bz = block
    nnn = int(np.prod(blocks.grid_shape(shape, block)))
    rng = np.random.default_rng(sum(block) + 1)
    c = rng.standard_normal((nnn, bz, by, bx)).astype(F32)
    c[:, :, :, bx // 2:] *= F32(1e-3)
    c[0, ..., :4] *= F32(1e-39)
    got = fused_inverse.stripe_fused_inverse_plain(torch.from_numpy(c.reshape(nnn, -1)),
                                                   shape, block)
    want = blocks.from_blocks(torch.from_numpy(np_cascade_3d(c, True)), shape, block)
    assert bits_differ(got.numpy(), want.numpy()) == 0


@pytest.fixture(scope="module")
def containers():
    """Per block: the input, the port's CPU containers (global, local) and
    native's parity ones."""
    out = {}
    for block in CASES:
        vol = volume(block)
        for local in (False, True):
            mine, _ = cvt.compress(vol, SCALE, block=block, use_local_rms=local,
                                   device="cpu")
            theirs, _ = rle_host.host_compress_parity(vol, SCALE, block=block,
                                                      use_local_rms=local)
            out[block, local] = vol, np.asarray(mine), theirs
    return out


@pytest.mark.parametrize("block", list(CASES), ids=IDS)
def test_cpu_compress_gives_native_parity_container(containers, block):
    """Global RMS: the CPU compress gives `cvx_compress_parity_th`'s
    container byte for byte.  Local RMS (as at 32^3, tests/test_torch_block32.py):
    native's parity codec sums each block's squares in eight f32 lanes, the
    port in f64, so the port's table is the f32 RMS of the f64 sum of the
    coefficients, native's within rtol 1e-4 of it; the payload is native's
    encoder's at the port's table, and blocks whose mulfac is bit-equal
    have native's payload bytes."""
    vol, mine, theirs = containers[block, False]
    np.testing.assert_array_equal(mine, theirs)
    vol, mine, theirs = containers[block, True]
    _, offs, mf, base = ctn.unpack(mine)
    _, offs_n, mf_n, base_n = ctn.unpack(theirs)
    coeffs = tokenize.stripe_fused_encode_plain(torch.from_numpy(vol), block, 1.0)[0].numpy()
    rms = np.sqrt((coeffs.astype(np.float64) ** 2).sum(1) / coeffs.shape[1]).astype(F32)
    np.testing.assert_allclose(mf, quant.mulfac_from_rms(torch.from_numpy(rms),
                                                         SCALE).numpy(), rtol=1e-6)
    np.testing.assert_allclose(mf, mf_n, rtol=1e-4)
    streams, sizes, raw = rle_host.encode_payloads(coeffs, mf)
    payload = np.concatenate(
        [coeffs[i].view(np.uint8) if r else s for i, (s, r) in enumerate(zip(streams, raw))])
    np.testing.assert_array_equal(mine[base:base + payload.size], payload)
    flag = np.int64(1) << 63
    same = 0
    for i in np.flatnonzero(mf == mf_n):
        n = int(sizes[i])
        o, o_n = int(offs[i] & ~flag), int(offs_n[i] & ~flag)
        np.testing.assert_array_equal(mine[base + o:base + o + n],
                                      theirs[base_n + o_n:base_n + o_n + n])
        same += 1
    assert same >= 1


@pytest.mark.parametrize("block", list(CASES), ids=IDS)
def test_cpu_decompress_is_native_parity_decompress(containers, block):
    """Both engines' CPU decompress equal `cvx_decompress_inplace_parity_th`
    bit for bit, on the port's containers and on native's."""
    for local in (False, True):
        vol, mine, theirs = containers[block, local]
        for data in (mine, theirs):
            want = rle_host.host_decompress_parity(data)
            for engine in ("device", "host"):
                got = cvt.decompress(data, engine=engine, device="cpu").numpy()
                assert got.shape == vol.shape
                assert bits_differ(got, want) == 0, (local, engine)


@pytest.mark.parametrize("cells", [512, 4096, 16384, 65536, 262144])
def test_local_sum_order_is_the_kernels(cells):
    """`stripe_rms` sums in the kernels' order: a block of at most 16,384
    cells in one CTA, spans of min(cells, 1,024) cells (a warp's share); a
    larger one across min(8, cells / 16,384) cluster CTAs of 8 warps, a span
    a warp.  In a span lane l adds the f64 square of cell 32 j + l of each
    segment j in turn, the lanes meet in a halving tree; a CTA's spans add
    in turn, then the ranks."""
    ranks = 1 if cells <= 16384 else min(8, cells // 16384)
    span = min(cells, 1024) if ranks == 1 else cells // (8 * ranks)
    assert quant.stripe_layout(cells) == (ranks, span)
    rng = np.random.default_rng(cells)
    c = (rng.standard_normal((2, cells)) * 1e3).astype(F32)
    c[1] *= F32(1e-30)
    sq = c.astype(np.float64) ** 2

    def halve(a):
        while a.shape[-1] > 1:
            h = a.shape[-1] // 2
            a = a[..., :h] + a[..., h:]
        return a[..., 0]

    want = np.empty(2, F32)
    for n in range(2):
        sums = []
        for s0 in range(0, cells, span):
            lanes = np.zeros(32)
            for j in range(s0, s0 + span, 32):
                lanes = lanes + sq[n, j:j + 32]
            sums.append(halve(lanes))
        per = len(sums) // ranks
        total = 0.0
        for r in range(ranks):
            part = 0.0
            for k in range(per):
                part = part + sums[r * per + k]
            total = total + part
        want[n] = np.float32(np.sqrt(total / cells))
    got = quant.stripe_rms(torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy(), want)
