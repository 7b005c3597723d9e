"""The port's inverse (plain version of the decompress kernel) against the
JAX package's fused inverse kernel and the oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from cvxcompress_tpu.ops import fused_inverse as jfi
from cvxcompress_tpu.ops import wavelet as jwav
from cvxcompress_tpu.oracle import codec as ocodec
from cvxcompress_tpu.oracle import wavelet as owav
from cvxcompress_tpu_torch.ops import codec, fused_inverse

CELLS = 32 * 32 * 32
TRANSFORM_TOL = 1e-5


def rel_rms(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.sqrt(((got - ref) ** 2).mean()) / (np.sqrt((ref**2).mean()) + 1e-30)


def sparse_coeffs(rng, shape):
    """Block-major coefficients with whole zero chunks, as decoded data has."""
    nbz, nby, nbx = (-(-n // 32) for n in shape)
    c = rng.standard_normal((nbz * nby * nbx, CELLS)).astype(np.float32)
    c.reshape(-1, 128)[rng.random(c.size // 128) < 0.7] = 0.0
    return c


@pytest.mark.parametrize("shape", [(60, 90, 90)])
def test_plain_inverse_matches_jax_stripe_kernel(shape, rng):
    """fused_inverse_plain on the sparse upload equals the JAX stripe
    inverse kernel (interpret mode) on the same coefficients laid out as
    its volume-order plane, within the 1e-5 transform contract; edges are
    clipped on every axis."""
    nz, ny, nx = shape
    nbz, nby, nbx = (-(-n // 32) for n in shape)
    coeffs = sparse_coeffs(rng, shape)
    rows, invmap = codec.sparse_chunks(coeffs)
    got = fused_inverse.fused_inverse(
        torch.from_numpy(rows), torch.from_numpy(invmap), shape
    ).numpy()

    w = jwav.padded_nbx(nbx, 32) * 32
    plane = np.zeros((nbz, 32, nby, 32, w // 32, 32), np.float32)
    plane[:, :, :, :, :nbx] = coeffs.reshape(nbz, nby, nbx, 32, 32, 32).transpose(
        0, 3, 1, 4, 2, 5
    )
    ref = np.asarray(
        jfi.stripe_fused_inverse(
            jnp.asarray(plane.reshape(nbz * 32 * nby * 32, w)), shape, (32, 32, 32),
            interpret=True,
        )
    )
    assert got.shape == ref.shape == shape
    assert rel_rms(got, ref) < TRANSFORM_TOL


def test_plain_inverse_matches_oracle_blocks(rng):
    """Per block: the oracle's inverse_3d then its clipped insert_block."""
    shape = (40, 50, 70)
    coeffs = sparse_coeffs(rng, shape)
    rows, invmap = codec.sparse_chunks(coeffs)
    got = fused_inverse.fused_inverse(
        torch.from_numpy(rows), torch.from_numpy(invmap), shape
    ).numpy()
    ref = np.zeros(shape, np.float32)
    nbz, nby, nbx = (-(-n // 32) for n in shape)
    for ib, c in enumerate(coeffs):
        iz, r = divmod(ib, nbx * nby)
        iy, ix = divmod(r, nbx)
        blk = owav.inverse_3d(c.reshape(32, 32, 32))
        ocodec.insert_block(ref, blk, ix * 32, iy * 32, iz * 32)
    assert rel_rms(got, ref) < TRANSFORM_TOL


def test_sparse_chunks_roundtrip(rng):
    """rows + invmap rebuild the dense coefficients; all-zero chunks point
    past the rows and never travel."""
    coeffs = sparse_coeffs(rng, (64, 64, 32))
    rows, invmap = codec.sparse_chunks(coeffs)
    flat = coeffs.reshape(-1, 128)
    live = flat.any(axis=1)
    assert rows.shape == (int(live.sum()), 128)
    np.testing.assert_array_equal(invmap[~live], rows.shape[0])
    dense = np.concatenate([rows, np.zeros((1, 128), np.float32)])[invmap]
    np.testing.assert_array_equal(dense, flat)
