"""The 32^3 path on the native parity cascade: `fused_encode_plain` and
`fused_inverse_plain` (the plain versions of csrc/fused_encode.cu and
csrc/fused_inverse.cu) against a numpy transcription of the native
library's parity cascade in its x, y, z order, bit for bit; the CPU
compress at 32^3 giving native `cvx_compress_parity_th`'s container and the
CPU decompress native `cvx_decompress_inplace_parity_th`'s volume, at an
unaligned shape and on a ramp with an all-zero, a ~1e-38 and a NaN block,
under the global and the local RMS; and the local RMS's f64 sum in the
order the kernel's threads hold the coefficients.  No JAX call."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
torch.set_num_threads(1)  # one thread a process: the suite runs in parallel workers

import cvxcompress_tpu_torch as cvt
from cvxcompress_tpu_torch import container as ctn
from cvxcompress_tpu_torch.ops import blocks, fused_inverse, quant, rle_host, tokenize

from test_torch_cascade import bits_differ, np_fwd_axis_parity, np_inv_axis_parity

F32 = np.float32
BLOCK = (32, 32, 32)
SHAPE = (40, 50, 70)  # 2 x 2 x 3 blocks, every axis cut at its edge
SCALE = 1e-2


def sinusoid_noise(shape=SHAPE, seed=5):
    """A z sinusoid, noise, large and subnormal cells: every token class,
    and coefficients whose last bits depend on the operation order."""
    rng = np.random.default_rng(seed)
    nz = shape[0]
    z = np.sin(np.arange(nz) * np.pi * 3 / nz).astype(F32)
    v = np.broadcast_to(z[:, None, None], shape).copy()
    v += rng.standard_normal(shape).astype(F32) * F32(1e-2)
    v[5, 9, :4] = [50.0, -50.0, 1e4, -1e4]
    v[33:38, 20:30, 40:50] = F32(3e-39)
    return v


def ramp(shape=SHAPE, seed=6):
    """Blocks scaled by 10^-(index mod 5) (block RMS 10^4 apart), and three
    guard blocks: all-zero, ~1e-38 (1/(rms * scale) overflows) and one NaN
    cell (its block's coefficients all NaN: a raw block)."""
    v = sinusoid_noise(shape, seed)
    nb = tuple(-(-n // 32) for n in shape)
    k = np.arange(np.prod(nb)) % 5
    f = np.kron((10.0 ** -k).astype(F32).reshape(nb), np.ones(BLOCK, F32))
    v = v * f[: shape[0], : shape[1], : shape[2]]
    v[:32, :32, 32:64] = 0.0
    v[:32, :32, 64:] = F32(1e-38)
    v[16, 40, 16] = np.nan
    return v


INPUTS = {"sinusoid_noise": sinusoid_noise, "ramp": ramp}


def np_cascade_3d(blk, inverse):
    """native's `wav_fwd_block_ex` / `wav_inv_block_ex` (parity): x, then
    y, then z, on a (n, 32, 32, 32) batch."""
    f = np_inv_axis_parity if inverse else np_fwd_axis_parity
    t = f(blk)
    t = np.swapaxes(f(np.swapaxes(t, 2, 3)), 2, 3)
    return np.swapaxes(f(np.swapaxes(t, 1, 3)), 1, 3)


@pytest.mark.parametrize("name", list(INPUTS))
def test_plain_encode_is_native_parity_cascade(name):
    """fused_encode_plain's coefficients are native's x, y, z parity
    cascade of the zero-padded blocks, bit for bit (NaN where it is)."""
    vol = INPUTS[name]()
    coeffs = tokenize.fused_encode_plain(torch.from_numpy(vol), 37.5)[0].numpy()
    blk = blocks.to_blocks(torch.from_numpy(vol), BLOCK).numpy()
    assert bits_differ(coeffs, np_cascade_3d(blk, False).reshape(coeffs.shape)) == 0


@pytest.mark.parametrize("mode", ["dense", "chunk_sparse"])
def test_plain_inverse_is_native_parity_cascade(mode):
    """fused_inverse_plain (both input modes) is native's x, y, z inverse
    parity cascade of each block, clipped to the volume, bit for bit."""
    rng = np.random.default_rng(8)
    nnn = 12
    c = rng.standard_normal((nnn, 32, 32, 32)).astype(F32)
    c[:, 16:] *= F32(1e-3)
    c[3] = 0.0  # all-zero chunks for the sparse mode
    c[5, :, :, :8] *= F32(1e-39)
    dense = torch.from_numpy(c.reshape(-1, 128))
    if mode == "dense":
        got = fused_inverse.fused_inverse_plain(dense, None, SHAPE)
    else:
        from cvxcompress_tpu_torch.ops import codec

        rows, invmap = codec.sparse_chunks(c.reshape(nnn, -1))
        assert rows.shape[0] < nnn * 256
        got = fused_inverse.fused_inverse_plain(torch.from_numpy(rows),
                                                torch.from_numpy(invmap), SHAPE)
    want = blocks.from_blocks(torch.from_numpy(np_cascade_3d(c, True)), SHAPE, BLOCK)
    assert bits_differ(got.numpy(), want.numpy()) == 0


@pytest.fixture(scope="module")
def containers():
    """Per (input, RMS mode): the input, the port's CPU container and native's
    parity one."""
    out = {}
    for name, make in INPUTS.items():
        vol = make()
        for local in (False, True):
            mine, _ = cvt.compress(vol, SCALE, block=BLOCK, use_local_rms=local,
                                   device="cpu")
            theirs, _ = rle_host.host_compress_parity(vol, SCALE, block=BLOCK,
                                                      use_local_rms=local)
            out[name, local] = vol, np.asarray(mine), theirs
    return out


CASES = [(n, lo) for n in INPUTS for lo in (False, True)]
IDS = [f"{n}-{'local' if lo else 'global'}" for n, lo in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cpu_compress_gives_native_parity_container(containers, case):
    """Global RMS: the CPU compress at 32^3 gives `cvx_compress_parity_th`'s
    container byte for byte.  Local RMS: native's parity codec sums each
    block's squares in eight f32 lanes (the reference's plain-AVX order),
    the port in f64 (ops/quant.py), so the port's table is the f32 RMS of
    the f64 sum and native's is within its f32 sum's error (rtol 1e-4) of
    it; the container is the one native's encoder writes from the same
    coefficients at the port's table, and blocks whose mulfac is bit-equal
    have native's payload bytes."""
    vol, mine, theirs = containers[case]
    name, local = case
    if not local:
        np.testing.assert_array_equal(mine, theirs)
        return
    hdr, offs, mf, base = ctn.unpack(mine)
    _, offs_n, mf_n, base_n = ctn.unpack(theirs)
    coeffs = tokenize.fused_encode_plain(torch.from_numpy(vol), 1.0)[0].numpy()
    rms = np.sqrt((coeffs.astype(np.float64) ** 2).sum(1) / coeffs.shape[1]).astype(F32)
    want = quant.mulfac_from_rms(torch.from_numpy(rms), SCALE).numpy()
    np.testing.assert_array_equal(mf, want)
    np.testing.assert_allclose(mf, mf_n, rtol=1e-4)
    streams, sizes, raw = rle_host.encode_payloads(coeffs, mf)
    payload = np.concatenate(
        [coeffs[i].view(np.uint8) if r else s for i, (s, r) in enumerate(zip(streams, raw))])
    np.testing.assert_array_equal(mine[base:base + payload.size], payload)
    flag = np.int64(1) << 63

    def block_bytes(data, offs, base, i, size):
        o = int(offs[i] & ~flag)
        return data[base + o:base + o + size]

    same = 0
    for i in np.flatnonzero(mf == mf_n):
        n = int(sizes[i])
        np.testing.assert_array_equal(block_bytes(mine, offs, base, i, n),
                                      block_bytes(theirs, offs_n, base_n, i, n))
        same += 1
    assert same >= 1


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cpu_decompress_is_native_parity_decompress(containers, case):
    """The CPU decompress at 32^3 (fused_inverse_plain after the host or the
    device engine's plain decode) equals `cvx_decompress_inplace_parity_th`
    bit for bit, on the port's container and on native's."""
    vol, mine, theirs = containers[case]
    for data in (mine, theirs):
        want = rle_host.host_decompress_parity(data)
        for engine in ("device", "host"):
            got = cvt.decompress(data, engine=engine, device="cpu").numpy()
            assert got.shape == vol.shape
            assert bits_differ(got, want) == 0, engine


def test_local_sum_order_is_the_kernels():
    """`local_rms` at 32^3 sums in the encode kernel's order: thread
    t = 32 w + x adds the f64 squares of its z-lines (2w, x), then
    (2w + 1, x), from z = 0 up; the 512 sums meet in the halving tree of
    each warp's lanes, then of the 16 warps' sums."""
    rng = np.random.default_rng(12)
    c = rng.standard_normal((3, 32, 32, 32)).astype(F32) * F32(1e3)
    c[1] *= F32(1e-30)
    sq = c.astype(np.float64) ** 2
    want = np.empty(3, F32)
    for n in range(3):
        acc = np.zeros(512)
        for t in range(512):
            w, x = divmod(t, 32)
            for y in (2 * w, 2 * w + 1):
                for z in range(32):
                    acc[t] = acc[t] + sq[n, z, y, x]

        def halve(a):
            while a.shape[-1] > 1:
                h = a.shape[-1] // 2
                a = a[..., :h] + a[..., h:]
            return a[..., 0]

        total = halve(halve(acc.reshape(16, 32)))
        want[n] = np.float32(np.sqrt(total / 32768.0))
    got = quant.local_rms(torch.from_numpy(c.reshape(3, -1)))
    np.testing.assert_array_equal(got.numpy(), want)
    perm = quant.zline_order(torch.from_numpy(c.reshape(3, -1))).view(3, 512, 64)
    assert perm[0, 33, 32] == c[0, 0, 3, 1]  # thread 33: w 1, x 1; line y 3, z 0
