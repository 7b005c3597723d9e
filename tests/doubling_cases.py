"""Streams for the parse's pointer doubling (csrc/decode_maps.cu) and a
numpy model of it, shared by the CPU tests (tests/test_torch_parse_doubling.py)
and the card's (tests/test_torch_cuda.py).  numpy only: no jax, no torch.

The model keeps the kernel's lanes as an axis: lane p of subsegment k holds
J (where the tokens followed from byte p end), V (the token starts reached,
one bit each) and S (the cells they cover, saturated at `cells`, packed
with J in one 32-bit word as the kernel shuffles them); 5 rounds of
"if J < 32: V |= V[J], S += S[J], J = J[J]", then P[e] = S * 32 + J - 32
and M the transpose of the 25 entry rows by the kernel's 5-stage
butterfly."""

import numpy as np

W = 32  # subsegment bytes (ops/entropy_decode.py `W`)
E = 25  # entry offsets
SPS = 16  # subsegments per segment: the JAX parse takes whole segments
PAD = 32  # zero bytes after the stream (ops/entropy_decode.py `PAD`)
# token classes by first byte: (name, byte, length)
CLASSES = (("plain", 5, 1), ("zero", 0, 1), ("RLESC1", 127, 2), ("RLESC3", 125, 4),
           ("VLESC2", 0x83, 3), ("VLESC3", 0x81, 4), ("VLESC2_8x", 0x82, 17),
           ("VLESC3_8x", 0x7E, 25), ("VLESC4", 0x80, 5))
_LEN = {b: n for _, b, n in CLASSES}
_MASKS = {16: 0x0000FFFF, 8: 0x00FF00FF, 4: 0x0F0F0F0F, 2: 0x33333333, 1: 0x55555555}


def _filler(n):
    return np.ones(n, np.uint8)  # plain one-byte tokens


def _classes(rng):
    """Every token class at every lane offset 0-31: one-byte filler before
    it, random payload bytes after it, a second subsegment for what runs
    past the first."""
    out = []
    for _, head, n in CLASSES:
        for o in range(W):
            s = _filler(2 * W)
            s[o] = head
            s[o + 1: o + n] = rng.integers(0, 256, n - 1)
            out.append(s)
    return np.concatenate(out)


def _tokens(rng, nbytes):
    """A stream of random tokens over subsegment ends: heads drawn from the
    classes, payload bytes random."""
    out, n = [], 0
    heads = np.array([b for _, b, _ in CLASSES], np.uint8)
    while n < nbytes:
        h = heads[rng.integers(0, heads.size)] if rng.random() < 0.5 else rng.integers(0, 256)
        ln = _LEN.get(int(h), 1)
        out.append(np.concatenate([[h], rng.integers(0, 256, ln - 1)]).astype(np.uint8))
        n += ln
    return np.concatenate(out)[:nbytes]


def cases():
    """{name: bytes} of whole subsegments, each case entered at offset 0:
    "classes", every class at every offset (576 subsegments);
    "vlesc3_8x_lane7", a VLESC3_8x from byte 7 to exactly the end;
    "cross_end", tokens that run past the subsegment's end (a VLESC2_8x
    from 20, a VLESC4 from 29, an RLESC3 from 30, a VLESC3_8x from 31);
    "one_byte", 32 one-byte tokens and 32 zeros: chains of 32 steps, all 5
    rounds; "saturated", RLESC3 runs of 2^24 - 1 and RLESC1 runs of 255,
    saturated at small `cells`; "random_tokens" and "random_bytes"."""
    rng = np.random.default_rng(11)
    out = {"classes": _classes(rng)}
    s = _filler(2 * W)
    s[7] = 0x7E
    s[8:32] = rng.integers(0, 256, 24)
    out["vlesc3_8x_lane7"] = s
    cross = []
    for head, o in ((0x82, 20), (0x80, 29), (125, 30), (0x7E, 31)):
        s = _filler(2 * W)
        s[o] = head
        s[o + 1: o + _LEN[head]] = 0xFF
        cross.append(s)
    out["cross_end"] = np.concatenate(cross)
    out["one_byte"] = np.concatenate([_filler(W), np.zeros(W, np.uint8)])
    sat = np.tile(np.array([125, 255, 255, 255], np.uint8), 2 * W // 4)
    out["saturated"] = np.concatenate([sat, np.tile(np.array([127, 255], np.uint8), W // 2)])
    out["random_tokens"] = _tokens(rng, 128 * W)
    out["random_bytes"] = rng.integers(0, 256, 128 * W).astype(np.uint8)
    return out


def stream_of(named):
    """The cases one after another as one stream: (stream (nsub*W + PAD,) u8,
    sub_reset (nsub,) bool (each case starts a chain; padding subsegments
    reset), {name: (first, end) subsegment}); nsub a multiple of SPS."""
    parts, spans, k = [], {}, 0
    for name, s in named.items():
        assert s.size % W == 0
        spans[name] = (k, k + s.size // W)
        parts.append(s)
        k += s.size // W
    nsub = -(-k // SPS) * SPS
    stream = np.zeros(nsub * W + PAD, np.uint8)
    stream[: k * W] = np.concatenate(parts)
    reset = np.zeros(nsub, bool)
    reset[[a for a, _ in spans.values()]] = True
    reset[k:] = True
    return stream, reset, spans


def transpose_bits(x):
    """The kernel's 5-stage shuffle butterfly on rows x (n, 32) of 32-bit
    words: at stage j lane p keeps its half of the bits (`keep`) and takes
    the rest from lane p ^ j, rotated left by j (or right, on the upper
    lane); bit e of row p out is bit p of row e in."""
    x = np.asarray(x, np.uint64)
    lane = np.arange(W)
    full = np.uint64(0xFFFFFFFF)
    for j in (16, 8, 4, 2, 1):
        m = np.uint64(_MASKS[j])
        up = (lane & j) != 0
        keep = np.where(up, ~m & full, m)
        rot = np.where(up, W - j, j).astype(np.uint64)
        y = x[:, lane ^ j]
        ry = ((y << rot) | (y >> (np.uint64(W) - rot))) & full
        x = (x & keep) | (ry & ~keep & full)
    return x


UNSAT_CELLS = 1 << 22  # csrc/decode_maps.cu MAPS_UNSAT_CELLS


def doubling_maps(stream, nsub, cells, rounds=5):
    """The kernel's algorithm: (M (nsub, 32) i32, P (nsub, 25) i32).  Up to
    UNSAT_CELLS cells the packed sums add without saturation (the kernel's
    bound: they stay below 2^26), above it each addition saturates."""
    b = np.asarray(stream[: nsub * W + 3], np.int64)
    n = nsub * W
    head = b[:n]
    ln = np.ones(n, np.int64)
    for h, tl in _LEN.items():
        ln[head == h] = tl
    vals = np.ones(n, np.int64)
    vals[head == 127] = b[1: n + 1][head == 127]
    run3 = b[1: n + 1] | (b[2: n + 2] << 8) | (b[3: n + 3] << 16)
    vals[head == 125] = np.minimum(run3, cells)[head == 125]
    vals[(head == 0x82) | (head == 0x7E)] = 8
    lane = np.arange(W)
    js = (np.minimum(vals.reshape(nsub, W), cells) << 6) | (lane + ln.reshape(nsub, W))
    V = np.broadcast_to(np.uint64(1) << lane.astype(np.uint64), (nsub, W))
    for _ in range(rounds):
        live = (js & W) == 0  # J < 32
        q = js & 31  # the source lane: J mod 32
        vq = np.take_along_axis(V, q, 1)
        jq = np.take_along_axis(js, q, 1)
        if cells <= UNSAT_CELLS:
            new = (js & ~63) + jq
        else:
            new = (np.minimum((js >> 6) + (jq >> 6), cells) << 6) | (jq & 63)
        assert not live.any() or new[live].max() < 2**32  # the packed word holds
        V = np.where(live, V | vq, V)
        js = np.where(live, new, js)
    P = np.minimum(js[:, :E] >> 6, cells) * 32 + (js[:, :E] & 63) - W
    M = transpose_bits(np.where(lane < E, V, np.uint64(0)))
    return M.astype(np.int64).astype(np.int32), P.astype(np.int32)


def one_byte_maps(nsub, cells):
    """The kernel's closed form where every token of a subsegment is one
    byte: every chain runs on to the end, one cell a byte."""
    lane = np.arange(W)
    M = (1 << (np.minimum(lane, E - 1) + 1)) - 1
    P = np.minimum(W - lane[:E], cells) * 32
    return (np.broadcast_to(M, (nsub, W)).astype(np.int32),
            np.broadcast_to(P, (nsub, E)).astype(np.int32))
