"""The tile schedules of csrc/tokenize_compact.cu (`tokenize_compact`, K14)
and csrc/block_encode_local.cu (`block_scale_tok`, K10b) on the CPU: a numpy
model of each kernel's tile work (stripe_tok.cuh: the segment summaries,
the max-scan, the descriptors a chunk at a time with the closed form of an
all-zero chunk and the short cut of a segment of bytes; K14's live chunks
from the summaries and its rows; K10b's mulfac made once a block) and of
its decoupled look-backs (stripe_tok.cuh `run_publish` / `run_walk`,
lookback.cuh `prefix_publish` / `prefix_walk`: 32 status words a step),
held bit-equal to the plain
versions `tokenize_compact_plain` and `scale_tok_plain` on the inputs of
tests/tile_tokenize_cases.py.  Every
tile publishes its status words in ticket order, then finishes its walks
in a shuffled order, so a walk meets earlier tiles both finished
(inclusive) and not (aggregate), as the ticket allows.  The plain versions
are held against JAX K14 and K10/K11 in interpret mode in
tests/test_torch_optin.py and tests/test_torch_local.py;
tests/test_torch_cuda.py runs the same cases through the kernels."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
torch.set_num_threads(1)  # one thread a process: the suite runs in parallel workers

from cvxcompress_tpu_torch.ops import fused_compress, quant, tokenize

import tile_tokenize_cases as tc

TILE = tc.TILE
NSEG, NCH = TILE // 32, TILE // 128
LB_AGG, LB_INCL = 1 << 30, 2 << 30
LB_VALUE = LB_AGG - 1
MAX_RUN24 = (1 << 24) - 1
ORDERS = ("ticket", "shuffled")


# -- tokens.cuh --------------------------------------------------------------

def cvtt(fv):
    """cvttss2si of f32 values: truncation, INT32_MIN out of range or NaN."""
    inr = (fv >= -2147483648.0) & (fv < 2147483648.0)
    return np.where(inr, np.trunc(np.where(inr, fv, 0)), -(1 << 31)).astype(np.int64)


def run_cost(n):
    return np.where(n == 1, 1, np.where(n < 256, 2, np.where(n <= MAX_RUN24, 4, 5)))


def zero_desc(end, n):
    return np.where(end, run_cost(n), 0) | end.astype(np.int64) << 3 | np.minimum(
        n, MAX_RUN24) << 4


def classes(q):
    return (q > -125) & (q < 125), (q >= -32768) & (q <= 32767), (q >= -8388608) & (
        q <= 8388607)


def group_modes(q):
    """The group-of-8 mode of every cell's group (group_mode_counts)."""
    g = q.reshape(*q.shape[:-1], -1, 8)
    b, s, i3 = classes(g)
    nz, nb, ns, n3 = (g == 0).sum(-1), b.sum(-1), s.sum(-1), i3.sum(-1)
    mode = np.where(nz != 0, 0, np.where(nb == 8, 1, np.where(
        (ns == 8) & (nb + (8 - nb) * 3 > 17), 2, np.where(
            (n3 == 8) & (nb + (ns - nb) * 3 + (8 - ns) * 4 > 25), 3, 0))))
    return np.repeat(mode, 8, axis=-1)


def value_cost(mode, lane8, q):
    b, s, i3 = classes(q)
    plain = np.where(b, 1, np.where(s, 3, np.where(i3, 4, 5)))
    return np.where(mode == 1, 1, np.where(mode == 2, np.where(lane8 == 0, 3, 2), np.where(
        mode == 3, np.where(lane8 == 0, 4, 3), plain)))


# -- stripe_tok.cuh ------------------------------------------------------------

def summaries(q):
    """tok_summaries: per 32-cell segment 1 + its last non-zero cell (0:
    none), bit 16 its first cell non-zero."""
    nz = q.reshape(NSEG, 32) != 0
    last = 31 - np.argmax(nz[:, ::-1], axis=1)
    return np.where(nz.any(1), np.arange(NSEG) * 32 + last + 1, 0) | nz[:, 0].astype(
        np.int64) << 16


def scan(rows):
    """tok_scan: the exclusive max-scan of the segments' low 16 bits, bit 16
    kept; and its total (top)."""
    incl = np.maximum.accumulate(rows & 0xffff)
    return np.concatenate([[0], incl[:-1]]) | (rows & 0x10000), int(incl[-1])


def descs(q, rows, top, n, boff, cells, carry0, next_first):
    """tok_descs<4> over a tile's first n cells: (descriptors (n,), chunk
    costs (n / 128,))."""
    nch = n // 128
    c0 = 128 * np.arange(nch)[:, None]
    bl0 = (boff + c0) & (cells - 1)
    bs = c0 - bl0
    block_end = bl0 + 128 == cells
    e = np.stack([rows[4 * np.arange(nch) + j] for j in range(4)]
                 + [np.where(np.arange(nch) + 1 < NCH, rows[np.minimum(
                     4 * np.arange(nch) + 4, NSEG - 1)], top | int(next_first) << 16)], 1)
    i = np.arange(128)[None, :]
    kk, lane = i >> 5, i & 31
    blc = bl0 + i
    qq = q[:n].reshape(nch, 128)
    nz = qq != 0
    # the general path: the segment's carry, the lower lanes' last non-zero
    seg_last = np.take_along_axis(e, kk.repeat(nch, 0), 1) & 0xffff
    seg_last = seg_last - 1
    carry = np.where((seg_last >= 0) & (seg_last >= bs), seg_last - bs, carry0)
    lanes = np.where(nz, lane, -1).reshape(nch, 4, 32)
    low = np.concatenate([np.full((nch, 4, 1), -1), np.maximum.accumulate(
        lanes, 2)[:, :, :-1]], 2).reshape(nch, 128)
    last = np.where(low >= 0, blc - lane + low, carry)
    nxt = np.concatenate([nz[:, 1:], np.zeros((nch, 1), bool)], 1)
    seg_end = ((kk == 3) & block_end) | ((np.take_along_axis(
        e, np.minimum(kk + 1, 4).repeat(nch, 0), 1) >> 16) != 0)
    end = np.where(lane < 31, nxt, seg_end)
    # a segment of bytes only: every value costs 1, whatever its group's mode
    bytes_only = classes(qq)[0].reshape(nch, 4, 32).all(2).repeat(32, 1)
    d = np.where(nz, np.where(bytes_only, 1, value_cost(group_modes(qq), i & 7, qq)),
                 zero_desc(end, blc - last))
    # the closed form of a chunk with no non-zero cell
    short = ((e[:, 4] & 0xffff) == (e[:, 0] & 0xffff))[:, None]
    s_last = (e[:, :1] & 0xffff) - 1
    s_carry = np.where((s_last >= 0) & (s_last >= bs), s_last - bs, carry0)
    s_end = block_end | ((e[:, 4:5] >> 16) != 0)
    d = np.where(short, zero_desc((i == 127) & s_end, blc - s_carry), d)
    return d.reshape(-1), (d & 7).sum(1)


# -- lookback.cuh ------------------------------------------------------------

def run_walk(status, t, zt, top, first_nz):
    """run_walk of tile t (after it published its word)."""
    carry = -1
    if zt and not first_nz:
        base = t - 1
        while True:
            r = base - np.arange(32)
            f = np.array([status[x] if x >= t - zt else LB_INCL for x in r])
            assert (f != 0).all()  # every word it reads is published
            incl = np.flatnonzero(f & LB_INCL)
            if incl.size:
                carry = int(f[incl[0]] & LB_VALUE) - 1
                break
            base -= 32
        if not top:
            status[t] = LB_INCL | (carry + 1)
    return carry


def prefix_walk(status, t, count):
    """prefix_walk of tile t (after it published its count)."""
    excl, base = 0, t - 1
    while base >= 0:
        r = base - np.arange(32)
        f = np.array([status[x] if x >= 0 else LB_INCL for x in r])
        assert (f != 0).all()
        incl = np.flatnonzero(f & LB_INCL)
        stop = incl[0] + 1 if incl.size else 32
        excl += int((f[:stop] & LB_VALUE).sum())
        if incl.size:
            break
        base -= 32
    if t:
        status[t] = LB_INCL | (excl + count)
    return excl


# -- the kernels' schedules ---------------------------------------------------

def schedule(ntiles, order):
    """The order in which the tiles finish their walks."""
    return (np.arange(ntiles) if order == "ticket"
            else np.random.default_rng(ntiles).permutation(ntiles))


def tile_geometry(t, lc, total):
    """(first block, block-local index of the first cell, cells) of tile t."""
    if lc > 14:
        return t >> (lc - 14), (t & ((1 << (lc - 14)) - 1)) << 14, TILE
    return t << (14 - lc), 0, int(min(TILE, total - (t << 14)))


def publish(flat, mf_cell, t, lc, total, run_status):
    """A tile's work up to its first status word: (q, summaries, scanned
    rows, top, s_next, geometry); publishes the zero-run word."""
    blk0, boff, n = tile_geometry(t, lc, total)
    cells, ltpb = 1 << lc, lc > 14
    x = flat[t * TILE: t * TILE + n]
    q = np.zeros(TILE, np.int64)
    q[:n] = cvtt(x * mf_cell(blk0, n))
    nxt = bool(ltpb and boff + TILE < cells
               and cvtt(flat[(t + 1) * TILE: (t + 1) * TILE + 1] * mf_cell(blk0, 1))[0] != 0)
    raw_rows = summaries(q)
    rows, top = scan(raw_rows)
    if ltpb:
        zt = boff >> 14
        run_status[t] = LB_INCL | (boff + top) if top else (LB_AGG if zt else LB_INCL)
    return dict(q=q, raw_rows=raw_rows, rows=rows, top=top, next=nxt, blk0=blk0, boff=boff,
                n=n)


def model_compact(coeffs, mulfacs, order):
    """tokenize_compact's outputs (chunk_bytes and sizes before the
    raw-fallback decision, rows, drows, ids, row_bytes, nrows)."""
    nnn, cells = coeffs.shape
    lc, total = cells.bit_length() - 1, coeffs.size
    ntiles = -(-total // TILE)
    flat = coeffs.reshape(-1)

    def mf_cell(blk0, n):
        return mulfacs[blk0 + (np.arange(n) >> lc)]

    run_status = np.zeros(ntiles, np.int64)
    row_status = np.zeros(ntiles, np.int64)
    tiles = []
    for t in range(ntiles):
        w = publish(flat, mf_cell, t, lc, total, run_status)
        k = np.arange(NCH)
        segs = np.append(w["raw_rows"], 0).astype(np.int64)
        nz = (segs[4 * k] | segs[4 * k + 1] | segs[4 * k + 2] | segs[4 * k + 3]) & 0xffff
        block_end = ((w["boff"] + 128 * k + 128) & (cells - 1)) == 0
        nxt = np.where(k + 1 < NCH, segs[np.minimum(4 * k + 4, NSEG)] >> 16 != 0,
                       lc > 14 and w["next"])
        w["live"] = (128 * k < w["n"]) & ((nz != 0) | block_end | nxt)
        row_status[t] = (LB_AGG if t else LB_INCL) | int(w["live"].sum())
        tiles.append(w)
    for t in schedule(ntiles, order):
        w = tiles[t]
        w["carry"] = (run_walk(run_status, t, w["boff"] >> 14, w["top"],
                                (w["rows"][0] >> 16) != 0) if lc > 14 else -1)
        w["first"] = prefix_walk(row_status, t, int(w["live"].sum()))
    nchunks = total // 128
    cb = np.zeros(nchunks, np.int64)
    sizes = np.zeros(nnn, np.int64)
    nrows = tiles[-1]["first"] + int(tiles[-1]["live"].sum())
    rows = np.zeros((nrows, 128), np.float32)
    drows = np.zeros((nrows, 128), np.int64)
    ids = np.zeros(nrows, np.int64)
    rbytes = np.zeros(nrows, np.int64)
    for t, w in enumerate(tiles):
        d, cost = descs(w["q"], w["rows"], w["top"], w["n"], w["boff"], cells, w["carry"],
                        lc > 14 and w["next"])
        nch = w["n"] // 128
        chunk0 = t * NCH
        cb[chunk0: chunk0 + nch] = cost
        np.add.at(sizes, w["blk0"] + (128 * np.arange(nch) >> lc), cost)
        live = np.flatnonzero(w["live"][:nch])
        r = w["first"] + np.arange(live.size)
        rows[r] = flat[t * TILE: t * TILE + w["n"]].reshape(nch, 128)[live]
        drows[r] = d.reshape(nch, 128)[live]
        ids[r] = chunk0 + live
        rbytes[r] = cost[live]
    return cb, sizes, rows, drows, ids, rbytes, nrows


def local_mulfac(ss, scale):
    """tokens.cuh local_mulfac of an f64 sum of squares of a 128^3 block."""
    rms = np.float32(np.sqrt(ss / float(tc.SLICE_CELLS)))
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        mf = np.float32(1.0) / (rms * np.float32(scale)) if rms != 0 else np.float32(1.0)
    return mf if np.isfinite(mf) else np.float32(1.0)


def model_scale_tok(coeffs, partials, scale, order):
    """block_scale_tok's outputs (desc, chunk_bytes and sizes before the
    raw-fallback decision, the table)."""
    nnn, cells = coeffs.shape
    lc, total, ntiles = 21, coeffs.size, nnn * 128
    flat = coeffs.reshape(-1)
    mulfacs = np.zeros(nnn, np.float32)
    mf_status = np.zeros(nnn, np.int64)
    run_status = np.zeros(ntiles, np.int64)
    tiles = []
    for t in range(ntiles):
        if t % 128 == 0:  # the block's first slice makes its mulfac
            ss = 0.0
            for z in range(128):
                ss += float(partials[t // 128, z])
            mulfacs[t // 128] = local_mulfac(ss, scale)
            mf_status[t // 128] = 1 << 32 | int(mulfacs[t // 128:t // 128 + 1].view(
                np.uint32)[0])
        word = int(mf_status[t // 128])
        assert word  # published before any slice of the block reads it
        mf = np.array([word & 0xffffffff], np.uint32).view(np.float32)[0]
        tiles.append(publish(flat, lambda blk0, n: np.full(n, mf, np.float32), t, lc, total,
                             run_status))
    for t in schedule(ntiles, order):
        w = tiles[t]
        w["carry"] = run_walk(run_status, t, w["boff"] >> 14, w["top"],
                               (w["rows"][0] >> 16) != 0)
    desc = np.zeros(total, np.int64)
    cb = np.zeros(total // 128, np.int64)
    sizes = np.zeros(nnn, np.int64)
    for t, w in enumerate(tiles):
        d, cost = descs(w["q"], w["rows"], w["top"], TILE, w["boff"], cells, w["carry"],
                        w["next"])
        desc[t * TILE: (t + 1) * TILE] = d
        cb[t * NCH: (t + 1) * NCH] = cost
        sizes[w["blk0"]] += int(cost.sum())
    return desc.reshape(nnn, cells), cb, sizes, mulfacs


def as_t(a):
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))


@pytest.fixture(scope="module", params=tc.COMPACT_KINDS)
def compact(request):
    c, mf = tc.compact_case(request.param)
    return c, mf, tokenize.tokenize_compact_plain(torch.from_numpy(c), torch.from_numpy(mf))


@pytest.mark.parametrize("order", ORDERS)
def test_compact_model_matches_plain(compact, order):
    """K14's tile work and both look-backs give the plain version's chunk
    counts, sizes, raw flags and live rows, their ids, counts and number."""
    c, mf, plain = compact
    cb, sizes, rows, drows, ids, rbytes, nrows = model_compact(c, mf, order)
    got = tokenize._raw_decision(as_t(cb), as_t(sizes), c.shape[1])
    for a, b in zip(got, plain[:3]):
        assert torch.equal(a, b)
    assert nrows == int(plain[7][0]) == plain[3].shape[0]
    assert np.array_equal(rows.view(np.int32), plain[3].numpy().view(np.int32))
    for a, b in zip((drows, ids, rbytes), plain[4:7]):
        assert torch.equal(as_t(a), b)


@pytest.fixture(scope="module", params=tc.LOCAL_KINDS)
def local(request):
    c, scale = tc.local_case(request.param)
    ck = torch.from_numpy(c)
    pk = quant.cta_sumsq(ck.view(-1, 128 * 128), 256).view(-1, 128)
    return c, pk.numpy(), scale, fused_compress.scale_tok_plain(ck, pk, scale)


@pytest.mark.parametrize("order", ORDERS)
def test_scale_tok_model_matches_plain(local, order):
    """K10b's mulfac made once a block, its tile work and its zero-run
    look-back give the plain version's table, descriptors, chunk counts,
    sizes and raw flags."""
    c, pk, scale, plain = local
    desc, cb, sizes, mulfacs = model_scale_tok(c, pk, scale, order)
    got = (as_t(desc), *tokenize._raw_decision(as_t(cb), as_t(sizes), c.shape[1]))
    for a, b in zip(got, plain[:4]):
        assert torch.equal(a, b)
    assert np.array_equal(mulfacs.view(np.int32), plain[4].numpy().view(np.int32))


def test_cases_reach_the_seams():
    """The cases hold what they are for: a raw block, a NaN, zero tiles
    between live ones, a block over 1,024 tiles."""
    c, mf = tc.compact_case("raw")
    plain = tokenize.tokenize_compact_plain(torch.from_numpy(c), torch.from_numpy(mf))
    assert 0 < int(plain[2].sum()) < c.shape[0]
    c, mf = tc.compact_case("stretch")
    live = model_compact(c, mf, "ticket")[4] // NCH
    assert np.isin(np.arange(3, 90), live).sum() == 0 and (live > 90).any()
    assert tc.compact_case("256")[0].shape[1] // TILE == 1024
    c, scale = tc.local_case("raw_nan")
    assert np.isnan(c).any()
