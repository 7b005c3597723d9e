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
from cvxcompress_tpu_torch.ops import (
    _kernels, codec, fused_inverse, pack, quant, rle_device, rle_host, tokenize,
)

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
    ck, dk, sk, rk = tokenize.fused_encode(vt, mulfac)
    cp, _, _, _ = tokenize.fused_encode_plain(vt, mulfac)
    torch.cuda.synchronize()
    assert rel_rms(ck, cp) < TRANSFORM_TOL
    d2, s2, r2 = rle_device.tokenize(tokenize.scaled(ck, mulfac))
    assert torch.equal(dk, d2) and torch.equal(sk, s2) and torch.equal(rk, r2)
    assert bool(rk.any()) == (scale < 1e-6)


def test_fused_encode_nonfinite_volume(dev, rng):
    """NaN and inf in the volume make their blocks' coefficients non-finite
    (VLESC4, raw fallback); kernel and plain version agree on every token
    and the stream still equals the native encoder's."""
    vol = volume(rng, (40, 50, 70))
    vol[3, 3, 3] = np.nan
    vol[35, 45, 65] = np.inf
    mulfac = quant.global_mulfac(np.where(np.isfinite(vol), vol, 0), 1e-2)
    ck, dk, sk, rk = tokenize.fused_encode(torch.from_numpy(vol).to(dev), mulfac)
    d2, s2, r2 = rle_device.tokenize(tokenize.scaled(ck, mulfac))
    assert torch.equal(dk, d2) and torch.equal(sk, s2) and torch.equal(rk, r2)
    assert bool(rk[0]) and bool(rk[-1])
    nr = torch.where(rk, 0, sk).to(torch.int64)
    base = torch.cumsum(nr, 0) - nr
    got = pack.emit_payload(ck, mulfac, dk, base, rk, int(nr.sum()))
    streams, _, nraw = rle_host.encode_payloads(ck.cpu().numpy(), mulfac)
    np.testing.assert_array_equal(nraw, rk.cpu().numpy())
    native = np.concatenate([s for s, r in zip(streams, nraw) if not r])
    np.testing.assert_array_equal(got.cpu().numpy(), native)


@pytest.mark.parametrize("scale", [1e-2, 1e-4, 1e-12])
def test_emit_payload_matches_plain_and_native(dev, rng, scale):
    vol = volume(rng, (40, 50, 70))
    mulfac = quant.global_mulfac(vol, scale)
    ck, dk, sk, rk = tokenize.fused_encode(torch.from_numpy(vol).to(dev), mulfac)
    nr = torch.where(rk, 0, sk).to(torch.int64)
    base = torch.cumsum(nr, 0) - nr
    total = int(nr.sum())
    got = pack.emit_payload(ck, mulfac, dk, base, rk, total)
    ref = pack.emit_payload_plain(ck, mulfac, dk, base, rk, total)
    assert torch.equal(got, ref)
    streams, _, nraw = rle_host.encode_payloads(ck.cpu().numpy(), mulfac)
    parts = [s for s, r in zip(streams, nraw) if not r]
    native = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    np.testing.assert_array_equal(got.cpu().numpy(), native)


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


def test_main_path_counts_and_agrees_with_cpu(dev, rng):
    """The public API on "cuda" launches each kernel once and agrees with
    the plain CPU path."""
    vol = volume(rng, (40, 50, 70))
    _kernels.reset_counts()
    data, _ = cvt.compress(vol, 1e-2, device="cuda")
    out = cvt.decompress(data, device="cuda")
    torch.cuda.synchronize()
    assert _kernels.launches == {
        "fused_encode": 1, "emit_payload": 1, "fused_inverse": 1,
    }
    ref, _ = cvt.compress(vol, 1e-2, device="cpu")
    assert abs(int(data.size) - int(ref.size)) <= max(64, 0.01 * ref.size)
    assert rel_rms(out.cpu(), cvt.decompress(data, device="cpu")) < TRANSFORM_TOL


def test_kernel_wrappers_reject_bad_inputs(dev):
    with pytest.raises(ValueError):
        tokenize.fused_encode(torch.zeros((32, 32, 32), dtype=torch.float64,
                                          device=dev), 1.0)
    with pytest.raises(ValueError):
        fused_inverse.fused_inverse(
            torch.zeros((1, 128), device=dev),
            torch.zeros(5, dtype=torch.int32, device=dev), (32, 32, 32),
        )
