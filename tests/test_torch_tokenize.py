"""The port's tokenize (plain version of the compress kernel) against the
oracle encoder and the JAX package's tokenizers."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
torch.set_num_threads(1)  # one thread a process: the suite runs in parallel workers

from cvxcompress_tpu import container as jctn
from cvxcompress_tpu.ops import quant as jquant
from cvxcompress_tpu.ops import rle_device as jrle
from cvxcompress_tpu.ops import tokenize_pallas as tp
from cvxcompress_tpu.ops import wavelet as jwav
from cvxcompress_tpu.oracle import rle as orle
from cvxcompress_tpu_torch.ops import quant, rle_device, tokenize

CELLS = 32 * 32 * 32


def edge_case_blocks(rng):
    """(n, 32768) pre-scaled blocks covering every token class and guard."""
    blocks = []

    def block(fill=0.0):
        return np.full(CELLS, fill, np.float32)

    b = block()  # special values scattered through zero runs
    specials = [np.nan, 1e30, -1e30, np.inf, -np.inf, 2147483648.0,
                -2147483904.0, 32767.0, -32768.0, 32768.0, -32769.0,
                8388607.0, -8388608.0, 8388608.0, -8388609.0, 124.9,
                -124.9, 125.0, -125.0, 0.999, -0.999, 1.0, -1.0]
    b[7 : 7 + len(specials)] = specials
    b[100] = 3.0  # after a run of 70 (cells 30..99)
    b[102] = 5.0  # run of exactly 1 (cell 101)
    b[358] = 7.0  # run of 255 (cells 103..357)
    b[615] = 9.0  # run of 256 (cells 359..614)
    blocks.append(b)
    blocks.append(block())  # all-zero block: one trailing RLESC3 token
    b = block(1.0)  # all-byte groups, broken by single zeros
    b[::9] = 0.0
    blocks.append(b)
    g = rng.integers(-32768, 32768, CELLS).astype(np.float32)
    g[g == 0] = 1.0
    blocks.append(g)  # VLESC2_8x groups (the allshort guard)
    g = rng.integers(-8388608, 8388608, CELLS).astype(np.float32)
    g[g == 0] = 1.0
    blocks.append(g)  # VLESC3_8x groups
    g = np.where(rng.random(CELLS) < 0.5, 3.0, 200.0).astype(np.float32)
    blocks.append(g)  # mixed byte/short groups near the 17-byte guard
    blocks.append(np.full(CELLS, 1e30, np.float32))  # raw fallback (VLESC4)
    g = (rng.standard_normal(CELLS) * rng.choice([0.3, 30.0, 3e4, 3e7], CELLS))
    g[rng.random(CELLS) < 0.6] = 0.0
    blocks.append(g.astype(np.float32))  # everything mixed
    return np.stack(blocks)


def test_quantize_cvttps_semantics():
    """Truncation toward zero; NaN and out-of-int32 values -> INT32_MIN,
    exactly the oracle's quantizer."""
    fv = np.array([0.5, -0.5, 1.9, -1.9, np.nan, np.inf, -np.inf, 3e9,
                   -3e9, 2147483520.0, -2147483648.0, 2147483648.0], np.float32)
    got = quant.quantize(torch.from_numpy(fv)).numpy()
    _, ref = orle.quantize(1.0, fv)
    np.testing.assert_array_equal(got, ref)


def test_tokenize_sizes_match_oracle_encode(rng):
    """Per-block sizes and raw flags equal len(oracle.rle.encode(...)) on the
    edge-case blocks (NaN, +-1e30, int16/int24 edges, runs of 1/255/256,
    an all-zero block, every group mode, a raw block)."""
    fv = edge_case_blocks(rng)
    _, sizes, raw = rle_device.tokenize(torch.from_numpy(fv))
    ref = np.array([len(orle.encode(1.0, b)) for b in fv])
    ref_raw = ref > 4 * CELLS
    np.testing.assert_array_equal(raw.numpy(), ref_raw)
    np.testing.assert_array_equal(sizes.numpy(), np.where(ref_raw, 4 * CELLS, ref))
    assert ref_raw.any() and not ref_raw.all()


def test_tokenize_desc_matches_jax_tokenize_desc(rng):
    """Stage-exact: per-cell descriptors, sizes and raw flags are bit-equal
    to the JAX package's XLA tokenizer fed the same pre-scaled blocks."""
    fv = edge_case_blocks(rng)
    desc, sizes, raw = rle_device.tokenize(torch.from_numpy(fv))
    jd, _, jsz, jraw, _ = jrle.tokenize_desc(
        jrle.as_rows(jnp.asarray(fv)), fv.shape[0], 128
    )
    np.testing.assert_array_equal(desc.numpy(), np.asarray(jd).reshape(fv.shape))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(jsz))
    np.testing.assert_array_equal(raw.numpy(), np.asarray(jraw))


@pytest.mark.parametrize("shape,periods", [((64, 96, 96), 3)])
def test_tokenize_of_jax_stripe_kernel_fv(shape, periods, rng):
    """The JAX compress kernel (stripe_fused_encode, interpret mode) and the
    port's tokenize agree bit for bit on the JAX kernel's own fv (re-laid
    out block-major), and the port's plain transform agrees with that fv
    within the 1e-5 transform contract."""
    nz, ny, nx = shape
    z = np.sin(np.arange(nz) * np.pi * periods / nz).astype(np.float32)
    vol = np.broadcast_to(z[:, None, None], shape).copy()
    vol += rng.standard_normal(shape).astype(np.float32) * 1e-3
    block = (32, 32, 32)
    assert tp.stripe_fused_ok(shape, block)
    mulfac = jctn.compute_glob_mulfac(jquant.global_rms_host(vol), 1e-3)
    fv, _, _, _, sizes, raw, _, _ = tp.stripe_fused_encode(
        jnp.asarray(vol), jnp.float32(mulfac), shape, block, interpret=True
    )
    nbz, nby, nbx = nz // 32, ny // 32, nx // 32
    w = jwav.padded_nbx(nbx, 32) * 32
    fvb = (
        np.asarray(fv).reshape(nbz, 32, nby, 32, w // 32, 32)[:, :, :, :, :nbx]
        .transpose(0, 2, 4, 1, 3, 5).reshape(-1, CELLS)
    )
    _, psizes, praw = rle_device.tokenize(torch.from_numpy(fvb))
    np.testing.assert_array_equal(psizes.numpy(), np.asarray(sizes))
    np.testing.assert_array_equal(praw.numpy(), np.asarray(raw))

    coeffs = tokenize.fused_encode(torch.from_numpy(vol), mulfac)[0]
    mine = tokenize.scaled(coeffs, mulfac).numpy().astype(np.float64)
    rel = np.sqrt(((mine - fvb) ** 2).mean()) / np.sqrt((fvb.astype(np.float64) ** 2).mean())
    assert rel < 1e-5, rel
