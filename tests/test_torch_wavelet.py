"""The port's wavelet operators and block layout against the JAX package."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
torch.set_num_threads(1)  # one thread a process: the suite runs in parallel workers

from cvxcompress_tpu.ops import blocks as jblocks
from cvxcompress_tpu.ops import wavelet as jwav
from cvxcompress_tpu.oracle import wavelet as owav
from cvxcompress_tpu_torch.ops import blocks, wavelet

TRANSFORM_TOL = 1e-5  # relative RMS, the reference's fast-vs-slow bar


def rel_rms(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.sqrt(((got - ref) ** 2).mean()) / (np.sqrt((ref**2).mean()) + 1e-30)


@pytest.mark.parametrize("n", [8, 16, 32, 64, 128, 256])
def test_operators_bit_equal_to_jax(n):
    """The port composes the same float64 operators, bit for bit."""
    f, i = wavelet.forward_matrix(n), wavelet.inverse_matrix(n)
    assert f.dtype == i.dtype == np.float64
    np.testing.assert_array_equal(f, jwav.forward_matrix(n))
    np.testing.assert_array_equal(i, jwav.inverse_matrix(n))


@pytest.mark.parametrize(
    "block_zyx",
    [(32, 32, 32), (8, 16, 32), (1, 16, 16), (16, 8, 64), (128, 128, 128)],
)
def test_plain_transforms_match_oracle(block_zyx, rng):
    """forward_blocks / inverse_blocks stay within 1e-5 of the scalar
    oracle cascade (oracle.wavelet.forward_3d / inverse_3d)."""
    x = rng.standard_normal((3, *block_zyx)).astype(np.float32)
    fwd = wavelet.forward_blocks(torch.from_numpy(x)).numpy()
    ref = np.stack([owav.forward_3d(b) for b in x])
    assert rel_rms(fwd, ref) < TRANSFORM_TOL
    inv = wavelet.inverse_blocks(torch.from_numpy(ref)).numpy()
    ref_inv = np.stack([owav.inverse_3d(b) for b in ref])
    assert rel_rms(inv, ref_inv) < TRANSFORM_TOL
    assert rel_rms(inv, x) < TRANSFORM_TOL  # perfect reconstruction


@pytest.mark.parametrize("shape", [(64, 96, 96), (40, 50, 70)])
def test_block_layout_matches_jax(shape, rng):
    """to_blocks / from_blocks equal the JAX package's numpy twins: raster
    block order, zero-padded edges, clipped scatter."""
    block = (32, 32, 32)
    vol = rng.standard_normal(shape).astype(np.float32)
    got = blocks.to_blocks(torch.from_numpy(vol), block).numpy()
    ref = jblocks.to_blocks_np(vol, block)
    np.testing.assert_array_equal(got, ref)
    back = blocks.from_blocks(torch.from_numpy(ref), shape, block).numpy()
    np.testing.assert_array_equal(back, jblocks.from_blocks_np(ref, shape, block))
    np.testing.assert_array_equal(back, vol)
