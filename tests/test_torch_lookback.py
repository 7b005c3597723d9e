"""The seams of the decoupled look-backs on the CPU: the decode chase
(csrc/decode_chase.cu walks pieces of subsegments and joins them) and the
stripe tokenize (csrc/tokenize_stripe.cu carries a block's zero run across
16,384-cell tiles).  On chains and runs that straddle the kernels' pieces
and tiles (tests/lookback_cases.py), the plain versions the wrappers run
for a CPU tensor are held bit-exact against the chase's one-step-at-a-time
semantics and K18 in interpret mode, and against JAX K12 in interpret
mode; tests/test_torch_cuda.py holds the kernels to them on the card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
torch.set_num_threads(1)  # one thread a process: the suite runs in parallel workers

import jax.numpy as jnp

from cvxcompress_tpu.ops import entropy_decode as ed
from cvxcompress_tpu.ops import tokenize_pallas as tp
from cvxcompress_tpu_torch.ops import blocks, tokenize
from cvxcompress_tpu_torch.ops import entropy_decode as ted

import lookback_cases as lc


@pytest.fixture(scope="module")
def chase_inputs():
    return lc.chase_cases(ted.chase_shape)


@pytest.mark.parametrize("name", ["short", "short_saturating", "long"])
def test_chase_seams_match_sequential(chase_inputs, name):
    """chase on a CPU tensor (chase_plain, the Sklansky scan) equals the
    one-step semantics on chains of 1, L - 1, L, L + 1 and 2 L + 1
    subsegments (L the kernel's piece at this length: 32, or 128 for the
    long stream), resets on and next to piece (so also unit) boundaries,
    a chain over hundreds of pieces; every entry offset is reached and the
    counts saturate where cells is small."""
    P, reset, cells = chase_inputs[name]
    se, sc = ted.chase_sequential(P, reset, cells)
    Pt, rt = torch.from_numpy(P), torch.from_numpy(reset)
    starts = torch.from_numpy(np.flatnonzero(reset).astype(np.int32))
    e32, c32 = ted.chase(Pt, rt, starts, cells)  # chase_plain on a CPU tensor
    np.testing.assert_array_equal(e32.numpy(), se)
    np.testing.assert_array_equal(c32.numpy(), sc)
    assert set(np.unique(se).tolist()) == set(range(lc.E))
    piece, warps = ted.chase_shape(P.shape[0])
    assert (piece, warps) == ((128, 8) if name == "long" else (32, 4))
    lengths = np.diff(np.append(np.flatnonzero(reset), P.shape[0]))
    assert {1, piece - 1, piece, piece + 1}.issubset(set(lengths.tolist()))
    assert lengths.max() > 100 * piece or name != "long"
    if name != "short":
        assert (sc == cells).any()


def test_chase_walks_short_chains_only():
    """The kernel's route: a warp a chain where the chains average at most
    16 subsegments over blocks of at most 32^3 cells (A's CI container:
    5,344 subsegments, ~4 a block), the pieces for long chains (A's and
    B's noise containers) or larger blocks, whatever their chains."""
    assert ted.chase_walks(5344, 1440, 32 ** 3)
    assert not ted.chase_walks(1464320, 1440, 32 ** 3)
    assert not ted.chase_walks(1768704, 32, 128 ** 3)
    assert not ted.chase_walks(64, 64, 64 ** 3)
    assert ted.chase_walks(16 * 10, 10, 8 ** 3)
    assert not ted.chase_walks(16 * 10 + 1, 10, 8 ** 3)


def test_chase_seams_match_chase_pallas_interpret(chase_inputs):
    """The first 480 subsegments of the short case (its chains of 1, 31,
    32, 33 and 65, then resets at and beside piece boundaries) through K18
    in interpret mode."""
    import jax.experimental.pallas as pl

    P, reset, cells = chase_inputs["short"]
    P, reset = P[:480], reset[:480]
    se, sc = ted.chase_sequential(P, reset, cells)
    orig = pl.pallas_call

    def patched(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    pl.pallas_call = patched
    try:
        ke, kc = ed._chase_pallas(jnp.asarray(P & 31), jnp.asarray(P >> 5),
                                  jnp.asarray(reset), cells)
    finally:
        pl.pallas_call = orig
    np.testing.assert_array_equal(np.asarray(ke), se)
    np.testing.assert_array_equal(np.asarray(kc), sc)


@pytest.fixture(scope="module")
def stripe_jax():
    """JAX K12 (`tokenize_desc_fast2`, interpret mode) on each case's
    fv = c * mulfac, one call per case: (desc, chunk bytes, sizes, raw)."""
    out = {}
    for kind in ("stretches", "last_tile", "tile_edge"):
        c, mf = lc.stripe_case(kind)
        n, cells = c.shape
        nchunks = n * cells // 128
        fvp = np.zeros((tp.pad_rows2(nchunks), 128), np.float32)
        fvp[:nchunks] = (c * mf[:, None]).astype(np.float32).reshape(nchunks, 128)
        jd, jcb, js, jr, _ = tp.tokenize_desc_fast2(jnp.asarray(fvp), n, cells // 128,
                                                    128, interpret=True)
        out[kind] = tuple(np.asarray(a) for a in (jd, jcb, js, jr))
    return out


@pytest.mark.parametrize("kind", ["stretches", "last_tile", "tile_edge"])
def test_tokenize_stripe_seams_match_jax_k12(stripe_jax, kind):
    """tokenize_stripe on the volume-order plane of three (256, 256, 8)
    blocks (32 tiles a block): all-zero stretches over many tiles, one
    non-zero cell in a block's last tile, runs ending exactly on tile
    edges; descriptors, chunk bytes, sizes and raw flags equal JAX K12's
    on fv = c * mulfac (the one f32 rounding of both)."""
    c, mf = lc.stripe_case(kind)
    plane = blocks.from_blocks(torch.from_numpy(c).view(-1, 8, 256, 256),
                               lc.STRIPE_SHAPE, lc.STRIPE_BLOCK)
    desc, cb, sizes, raw = tokenize.tokenize_stripe(plane, torch.from_numpy(mf),
                                                    lc.STRIPE_BLOCK)
    jd, jcb, js, jr = stripe_jax[kind]
    np.testing.assert_array_equal(desc.numpy().reshape(-1, 128), jd)
    np.testing.assert_array_equal(cb.numpy(), jcb)
    np.testing.assert_array_equal(sizes.numpy(), js)
    np.testing.assert_array_equal(raw.numpy(), jr)
    runs = (desc.numpy() >> 4)[desc.numpy() & 8 != 0]
    assert runs.max() > 20 * lc.TILE or kind == "tile_edge"
