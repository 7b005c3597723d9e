"""The parse's pointer doubling on the CPU: a numpy model of
csrc/decode_maps.cu's algorithm (tests/doubling_cases.py: lanes as an
axis, 5 rounds of J/V/S doubling, then the bit transpose) against the
port's plain version `parse_maps_plain` and the JAX package's
`_parse_stages`, on streams built to reach every corner of the token
grammar: every token class at every lane offset, a VLESC3_8x from lane 7
to exactly the end, tokens that cross the subsegment's end, chains of 32
one-byte tokens, runs saturated at `cells`, random streams.
tests/test_torch_cuda.py holds the kernel to the plain version on the same
streams on the card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
torch.set_num_threads(1)  # one thread a process: the suite runs in parallel workers

import jax
import jax.numpy as jnp

from cvxcompress_tpu.ops import entropy_decode as ed
from cvxcompress_tpu_torch.ops import entropy_decode as ted

import doubling_cases as dc

# 8x8x1 blocks (64 cells: an RLESC1 run alone saturates), 2^22 (the
# largest block whose sums the kernel adds unsaturated) and 256^3 (2^24,
# the largest block, each sum saturated)
CELLS = (64, 1 << 22, 1 << 24)
CASES = tuple(dc.cases())


@pytest.fixture(scope="module")
def parsed():
    """Per cells: the stream of every case, and its (M, P) from the model,
    the plain version and (M, e32, c32) from one JAX `_parse_stages` call."""
    stream, reset, spans = dc.stream_of(dc.cases())
    nsub = reset.size
    out = {}
    for cells in CELLS:
        M, P = dc.doubling_maps(stream, nsub, cells)
        Mp, Pp = ted.parse_maps_plain(torch.from_numpy(stream), nsub, cells)
        jM, je32, jc32, *_ = jax.jit(ed._parse_stages, static_argnums=(2, 3))(
            jnp.asarray(stream[: nsub * dc.W].reshape(-1, ted.SEG)), jnp.asarray(reset),
            cells)
        out[cells] = dict(M=M, P=P, Mp=Mp.numpy(), Pp=Pp.numpy(), jM=np.asarray(jM),
                          je32=np.asarray(je32), jc32=np.asarray(jc32))
    return stream, reset, spans, out


@pytest.mark.parametrize("cells", CELLS)
@pytest.mark.parametrize("case", CASES)
def test_doubling_matches_plain_and_parse_stages(parsed, case, cells):
    """M and P of the model equal the plain version's; M equals the JAX
    parse's, and the JAX chase's entries and cursors are the one-step chase
    over the model's P (each case a chain of its own)."""
    stream, reset, spans, out = parsed
    a, b = spans[case]
    r = out[cells]
    np.testing.assert_array_equal(r["M"][a:b], r["Mp"][a:b])
    np.testing.assert_array_equal(r["P"][a:b], r["Pp"][a:b])
    np.testing.assert_array_equal(r["M"][a:b], r["jM"][a:b])
    se, sc = ted.chase_sequential(r["P"], reset, cells)
    np.testing.assert_array_equal(se[a:b], r["je32"][a:b])
    np.testing.assert_array_equal(sc[a:b], r["jc32"][a:b])


def test_every_class_at_every_offset_is_reached(parsed):
    """In "classes", entered at 0, the chain of one-byte filler reaches the
    token at offset o; its exit and its cells are the class's (the P row of
    entry 0)."""
    stream, _, spans, out = parsed
    a, _ = spans["classes"]
    M, P = out[64]["M"], out[64]["P"]
    for c, (name, head, n) in enumerate(dc.CLASSES):
        for o in range(dc.W):
            k = a + 2 * (c * dc.W + o)
            assert M[k, o] & 1, (name, o)
            assert (P[k, 0] & 31) == max(0, o + n - dc.W), (name, o)
            if n == 1:
                assert P[k, 0] >> 5 == dc.W
    k = spans["vlesc3_8x_lane7"][0]
    assert P[k, 0] == (7 + 8) * 32 + 0  # ends exactly at 32: exit offset 0


def test_chains_of_32_tokens_need_five_rounds(parsed):
    """32 one-byte tokens: entry 0's chain has 32 steps; 4 rounds of
    doubling follow 16 of them, 5 all."""
    stream, reset, spans, _ = parsed
    a, b = spans["one_byte"]
    M4, P4 = dc.doubling_maps(stream, reset.size, 1 << 24, rounds=4)
    M5, P5 = dc.doubling_maps(stream, reset.size, 1 << 24)
    # byte p is reached from every entry e <= p
    assert (M5[a:b] == (1 << (np.minimum(np.arange(dc.W), dc.E - 1) + 1)) - 1).all()
    assert (P5[a:b, 0] == dc.W * 32).all()
    assert (P4[a:b, 0] != P5[a:b, 0]).all() and (M4[a:b] != M5[a:b]).any()


@pytest.mark.parametrize("cells", CELLS)
def test_one_byte_closed_form(parsed, cells):
    """Where every token of a subsegment is one byte (the kernel's shortcut
    for dense data) the closed form equals the doubling's result."""
    stream, reset, _, out = parsed
    n = reset.size
    heads = stream[: n * dc.W].reshape(n, dc.W)
    ones = ~np.isin(heads, [b for _, b, ln in dc.CLASSES if ln > 1]).any(axis=1)
    assert ones.sum() > 100
    M1, P1 = dc.one_byte_maps(int(ones.sum()), cells)
    np.testing.assert_array_equal(out[cells]["M"][ones], M1)
    np.testing.assert_array_equal(out[cells]["P"][ones], P1)


def test_saturated_runs(parsed):
    """RLESC3 runs of 2^24 - 1 saturate at cells at both sizes, RLESC1 runs
    of 255 at 64 cells (16 of them cover 4,080 cells)."""
    _, _, spans, out = parsed
    a, _ = spans["saturated"]
    for cells in CELLS:
        P = out[cells]["P"]
        assert (P[a: a + 2, 0] >> 5 == cells).all()
        assert P[a + 2, 0] >> 5 == min(cells, 16 * 255)


def test_transpose_butterfly():
    """The kernel's 5-stage butterfly is the 32x32 bit transpose."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, 2**32, (64, dc.W), dtype=np.uint64)
    bits = (x[:, :, None] >> np.arange(dc.W, dtype=np.uint64)) & np.uint64(1)
    want = (bits.transpose(0, 2, 1) << np.arange(dc.W, dtype=np.uint64)).sum(axis=2)
    np.testing.assert_array_equal(dc.transpose_bits(x), want)
