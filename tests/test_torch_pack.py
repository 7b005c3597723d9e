"""The port's payload emitter (plain version of the emit kernel) and host
assembly against the oracle encoder, the native encoder and the JAX
package."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
torch.set_num_threads(1)  # one thread a process: the suite runs in parallel workers

from cvxcompress_tpu.ops import rle_device as jrle
from cvxcompress_tpu.oracle import rle as orle
from cvxcompress_tpu_torch.ops import pack, rle_device, rle_host, tokenize

CELLS = 32 * 32 * 32


def coefficient_blocks(rng, n=6):
    """Unscaled blocks: sparse smooth-field-like, dense, special values, and
    one that falls back to raw."""
    c = rng.standard_normal((n, CELLS)).astype(np.float32)
    c *= rng.choice([1e-3, 0.05, 1.0, 50.0], (n, CELLS)).astype(np.float32)
    c[0, 2000:] = 0.0  # mostly zero runs
    c[1] = 0.0  # all-zero block
    c[2, ::3] = 0.0
    c[3, 10:20] = [np.nan, np.inf, -np.inf, 1e30, -1e30, 4e6, -4e6, 9e4, -9e4, 0.0]
    c[4] = 1e35  # every cell VLESC4 -> raw fallback
    return c


def _emit(coeffs, mulfac):
    """The emit of 32^3 blocks as the compress runs it: the tokenize's
    per-chunk byte counts (0 in a raw block), their exclusive cumsum the
    chunk bases, then `pack.emit_chunks`."""
    c = torch.from_numpy(coeffs)
    mf = torch.full((coeffs.shape[0],), mulfac)
    desc, chunk_bytes, sizes, raw = tokenize.tokenize_blocks_plain(c, mf)
    stream = pack.emit_chunks(c, mf, desc, chunk_bytes, pack.chunk_bases(chunk_bytes),
                              int(chunk_bytes.sum()))
    return stream.numpy(), sizes.numpy(), raw.numpy()


def test_plain_stream_equals_oracle_encode(rng):
    """The plain emitter's stream is the concatenation of
    oracle.rle.encode over the non-raw blocks, in block order."""
    mulfac = np.float32(40.0)
    coeffs = coefficient_blocks(rng)
    stream, sizes, raw = _emit(coeffs, mulfac)
    ref = [orle.encode(mulfac, b) for b in coeffs]
    np.testing.assert_array_equal(raw, [len(r) > 4 * CELLS for r in ref])
    assert raw[4] and not raw[:4].any()
    expect = b"".join(r for r, is_raw in zip(ref, raw) if not is_raw)
    assert stream.tobytes() == expect


def test_plain_stream_equals_native_encoder(rng):
    """Stage-exact against the native C++ encoder on the same unscaled
    coefficients (what chip_smoke.py checks for the kernel on the card)."""
    mulfac = np.float32(7.5)
    coeffs = coefficient_blocks(rng)
    stream, sizes, raw = _emit(coeffs, mulfac)
    streams, nsizes, nraw = rle_host.encode_payloads(coeffs, mulfac)
    np.testing.assert_array_equal(nraw, raw)
    np.testing.assert_array_equal(nsizes, sizes)
    native = np.concatenate([s for s, r in zip(streams, nraw) if not r])
    np.testing.assert_array_equal(stream, native)


def test_assemble_blockorder_matches_jax(rng):
    """The numpy copy of assemble_payload_blockorder splices raw blocks
    exactly as the JAX package's original does."""
    cells = CELLS
    sizes = np.array([10, 4 * cells, 7, 0, 4 * cells, 3], np.int64)
    raw = np.array([False, True, False, False, True, False])
    nr_total = int(sizes[~raw].sum())
    stream = rng.integers(0, 256, nr_total + 5).astype(np.uint8)
    raw_bytes = rng.integers(0, 256, (2, 4 * cells)).astype(np.uint8)
    got, gt = rle_device.assemble_payload_blockorder(stream, sizes, raw, raw_bytes, cells)
    ref, rt = jrle.assemble_payload_blockorder(stream, sizes, raw, raw_bytes, cells)
    assert gt == rt == int(sizes.sum())
    np.testing.assert_array_equal(got, ref)
    no_raw, _ = rle_device.assemble_payload_blockorder(
        stream, np.array([3, 4], np.int64), np.zeros(2, bool), None, cells
    )
    np.testing.assert_array_equal(no_raw, stream[:7])
