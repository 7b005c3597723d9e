"""The multi-level 7/9 cascade of the 128^3 kernels' plain versions
(`wavelet.cascade_axis`) against the native library's parity cascade
(`native/cvx_host.cpp` `wav_fwd_axis_parity`, `wav_inv_axis_parity`), and the
128^3 path built on it: bit-equal to a numpy transcription of the native
cascade, the CPU decompress of a 128^3 container bit-equal to native's
`cvx_decompress_inplace_parity_th`, the x, y, z forward giving
`cvx_compress_parity_th`'s payload byte for byte, and the two 128^3 encode
splits (z | x,y and x,z | y) bit-equal.  No JAX call."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
torch.set_num_threads(1)  # one thread a process: the suite runs in parallel workers

import cvxcompress_tpu_torch as cvt
from cvxcompress_tpu_torch.ops import fused_compress, fused_inverse, rle_host, wavelet

F32 = np.float32
BLOCK = (128, 128, 128)
SHAPE = (128, 128, 256)  # two 128^3 blocks along x
AL, AH, SL, SH = (np.asarray(c, F32) for c in (wavelet.AL, wavelet.AH, wavelet.SL,
                                              wavelet.SH))


def _mirr(v, n):
    v = abs(v)
    v = 2 * n - 2 - v if v >= n else v
    v = abs(v)
    return 2 * n - 2 - v if v >= n else v


def _mirr_sl(v, nl):
    for _ in range(3):
        v = abs(v)
        v = 2 * nl - 1 - v if v >= nl else v
    return v


def _mirr_sh(v, nl, nh):
    v -= nl
    for _ in range(3):
        v = -v - 1 if v < 0 else v
        v = 2 * nh - 2 - v if v >= nh else v
    return nl + v


def np_fwd_axis_parity(p):
    """`wav_fwd_axis_parity` along the last axis, each op in np.float32."""
    p = p.astype(F32, copy=True)
    n = p.shape[-1]
    while n >= 2:
        tmp = p[..., :n].copy()
        nh = n // 2
        nl = n - nh
        for ix in range(nl):
            i0 = 2 * ix
            acc = AL[4] * (tmp[..., _mirr(i0 - 4, n)] + tmp[..., _mirr(i0 + 4, n)])
            for k in (3, 2, 1):
                acc = acc + AL[k] * (tmp[..., _mirr(i0 - k, n)] + tmp[..., _mirr(i0 + k, n)])
            p[..., ix] = acc + AL[0] * tmp[..., i0]
        for ix in range(nh):
            i0 = 2 * ix + 1
            acc = AH[3] * (tmp[..., _mirr(i0 - 3, n)] + tmp[..., _mirr(i0 + 3, n)])
            for k in (2, 1):
                acc = acc + AH[k] * (tmp[..., _mirr(i0 - k, n)] + tmp[..., _mirr(i0 + k, n)])
            p[..., nl + ix] = acc + AH[0] * tmp[..., i0]
        n -= n // 2
    return p


def np_inv_axis_parity(p):
    """`wav_inv_axis_parity` along the last axis, each op in np.float32."""
    p = p.astype(F32, copy=True)
    levels = wavelet.level_schedule(p.shape[-1])
    for n in reversed(levels):
        tmp = p[..., :n].copy()
        nh = n // 2
        nl = n - nh

        def lo(v):
            return tmp[..., _mirr_sl(v, nl)]

        def hi(v):
            return tmp[..., _mirr_sh(v, nl, nh)]

        for k in range(nl):
            acc = SH[3] * (hi(nl + k - 2) + hi(nl + k + 1))
            acc = acc + SL[2] * (lo(k - 1) + lo(k + 1))
            acc = acc + SH[1] * (hi(nl + k - 1) + hi(nl + k))
            p[..., 2 * k] = acc + SL[0] * tmp[..., k]
        for k in range(nh):
            acc = SH[4] * (hi(nl + k - 2) + hi(nl + k + 2))
            acc = acc + SL[3] * (lo(k - 1) + lo(k + 2))
            acc = acc + SH[2] * (hi(nl + k - 1) + hi(nl + k + 1))
            acc = acc + SL[1] * (lo(k) + lo(k + 1))
            p[..., 2 * k + 1] = acc + SH[0] * tmp[..., nl + k]
    return p


def volume(shape=SHAPE, seed=7):
    """A z sinusoid, noise, large and tiny specials: every token class, and
    coefficients whose last bits depend on the operation order."""
    rng = np.random.default_rng(seed)
    nz = shape[0]
    z = np.sin(np.arange(nz) * np.pi * 3 / nz).astype(F32)
    v = np.broadcast_to(z[:, None, None], shape).copy()
    v += rng.standard_normal(shape).astype(F32) * F32(1e-2)
    v[5, 9, :4] = [50.0, -50.0, 1e4, -1e4]
    v[64:70, 20:30, 140:150] = F32(3e-39)  # subnormal cells
    return v


def bits_differ(a, b):
    return int((np.asarray(a, F32).view(np.uint32)
                != np.asarray(b, F32).view(np.uint32)).sum())


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("n", [128, 32, 2])
def test_cascade_axis_bit_equal_to_native_parity(n, inverse):
    """(a) `cascade_axis` equals the numpy transcription of native's parity
    cascade bit for bit, subnormal and large inputs included."""
    rng = np.random.default_rng(n + inverse)
    lines = rng.standard_normal((48, n)).astype(F32)
    lines[:8] *= F32(1e-39)
    lines[8:16] *= F32(1e6)
    got = wavelet.cascade_axis(torch.from_numpy(lines), inverse).numpy()
    want = (np_inv_axis_parity if inverse else np_fwd_axis_parity)(lines)
    assert bits_differ(got, want) == 0
    # and within f32 rounding of the dense f64 operator
    m = wavelet.inverse_matrix(n) if inverse else wavelet.forward_matrix(n)
    ref = lines[16:].astype(np.float64) @ m.T
    assert np.abs(got[16:] - ref).max() < 1e-5 * np.abs(ref).max()


@pytest.fixture(scope="module")
def containers():
    """The port's CPU container of `volume()` and native's parity one."""
    vol = volume()
    mine, _ = cvt.compress(vol, 1e-2, block=BLOCK, device="cpu")
    theirs, _ = rle_host.host_compress_parity(vol, 1e-2, block=BLOCK)
    return vol, {"port": mine, "native": theirs}


@pytest.mark.parametrize("producer", ["port", "native"])
def test_decompress_128_bit_equal_to_native_parity(containers, producer):
    """(b) The port's 128^3 decompress on the CPU (the plain versions of
    `block_inv_xy` and `block_inv_z`) equals native
    `cvx_decompress_inplace_parity_th` bit for bit, on the port's container
    and on native's."""
    vol, data = containers
    mine = cvt.decompress(data[producer], device="cpu").numpy()
    want = rle_host.host_decompress_parity(data[producer])
    assert mine.shape == want.shape == vol.shape
    assert bits_differ(mine, want) == 0


def test_forward_xyz_gives_native_parity_payload(containers):
    """(c) The x, y, z composition of `cascade_axis`, tokenized by native's
    encoder, gives `cvx_compress_parity_th`'s payload byte for byte.  The
    128^3 kernels keep the JAX package's order z, x, y, whose coefficients
    differ from these in their last bits."""
    vol, data = containers
    theirs = data["native"]
    blocks = torch.from_numpy(vol).view(128, 128, 2, 128).permute(2, 0, 1, 3)
    xyz = blocks
    for d in (3, 2, 1):
        xyz = wavelet.cascade(xyz, d, inverse=False)
    mulfac = np.frombuffer(theirs[24:28].tobytes(), F32)[0]
    streams, sizes, raw = rle_host.encode_payloads(xyz.reshape(2, -1).numpy(), mulfac)
    assert not raw.any()
    payload = np.concatenate(streams)
    offsets = np.frombuffer(theirs[32:48].tobytes(), np.int64)
    np.testing.assert_array_equal(offsets, [0, sizes[0]])
    np.testing.assert_array_equal(payload, theirs[48:48 + payload.size])
    zxy = fused_compress.block_encode_plain(torch.from_numpy(vol), 1.0)[0]
    assert bits_differ(zxy.numpy(), xyz.reshape(2, -1).numpy()) > 0


def test_plain_k16_bit_equal_to_plain_k6():
    """(d) The x,z | y encode's plain versions (K16a + K16b) give
    `block_encode`'s plain outputs bit for bit: both run the same per-line
    cascades in the order z, x, y."""
    vt = torch.from_numpy(volume(seed=11))
    mulfac = 37.5
    a = fused_compress.block_encode_w(vt, mulfac)
    b = fused_compress.block_encode(vt, mulfac)
    assert bits_differ(a[0].numpy(), b[0].numpy()) == 0
    for x, y in zip(a[1:], b[1:]):
        assert torch.equal(x, y)


def test_inverse_plain_passes_compose():
    """The two inverse passes' plain versions compose to the x, y, z
    cascade of each block, and the forward passes to z, x, y."""
    rng = np.random.default_rng(3)
    dense = torch.from_numpy(rng.standard_normal((2 * 128 ** 3,)).astype(F32))
    vol = fused_inverse.block_fused_inverse_plain(dense.view(-1, 128), SHAPE)
    t = dense.view(2, 128, 128, 128)
    for d in (3, 2, 1):
        t = wavelet.cascade(t, d, inverse=True)
    want = t.permute(1, 2, 0, 3).reshape(SHAPE)
    assert bits_differ(vol.numpy(), want.numpy()) == 0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_128_kernels_bit_equal_to_plain_on_the_card(dev):
    """The seven 128^3 transform launches bit-equal to their plain versions
    (subnormal cells included), and the card's decompress of the port's
    container bit-equal to native's parity decompress."""
    from cvxcompress_tpu_torch.ops import _kernels

    vol = volume(seed=13)
    vt = torch.from_numpy(vol).to(dev)
    _kernels.reset_counts()
    tk = fused_compress.fwd_z(vt)
    assert torch.equal(tk, fused_compress.fwd_z_plain(vt))
    ck = fused_compress.encode_xy(tk, 37.5, out=torch.empty_like(tk))[0]
    assert torch.equal(ck, fused_compress.encode_xy_plain(tk, 37.5)[0])
    cl, _ = fused_compress.casc_local(tk.clone())
    assert torch.equal(cl, fused_compress.casc_local_plain(tk)[0])
    plane = fused_compress.fwd_xz(vt)
    assert torch.equal(plane, fused_compress.fwd_xz_plain(vt))
    cy = fused_compress.encode_y(plane, 37.5)[0]
    assert torch.equal(cy, fused_compress.encode_y_plain(plane, 37.5)[0])
    assert torch.equal(cy, ck)
    rows = ck.view(-1, 128)
    xk = fused_inverse.block_inv_xy(rows, SHAPE)
    assert torch.equal(xk, fused_inverse.block_inv_xy_plain(rows, SHAPE))
    zk = fused_inverse.block_inv_z(xk.clone())
    assert torch.equal(zk, fused_inverse.block_inv_z_plain(xk))
    for k in ("block_fwd_z", "block_encode_xy", "block_casc_local", "block_fwd_xz",
              "block_encode_y", "block_inv_xy", "block_inv_z"):
        assert _kernels.launches[k] == 1, k
    data, _ = cvt.compress(vol, 1e-2, block=BLOCK)
    out = cvt.decompress(data).cpu().numpy()
    assert bits_differ(out, rle_host.host_decompress_parity(data)) == 0


@pytest.mark.cuda
def test_128_wrappers_reject_misaligned_views(dev):
    """The 128^3 launches move rows as float4s: a view that does not start
    on a 16-byte boundary raises instead of launching."""
    flat = torch.zeros(2 * 128 ** 3 + 1, device=dev)
    vol = flat[1:].view(SHAPE)
    with pytest.raises(ValueError, match="16-byte"):
        fused_compress.fwd_z(vol)
    with pytest.raises(ValueError, match="16-byte"):
        fused_compress.fwd_xz(vol)
    with pytest.raises(ValueError, match="16-byte"):
        fused_inverse.block_inv_xy(flat[1:], SHAPE)
    with pytest.raises(ValueError, match="16-byte"):
        fused_inverse.block_inv_z(vol)
