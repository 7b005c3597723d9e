"""`patch_extract` (csrc/patch_extract.cu) on the CPU: a numpy model of the
launch, held to `patch_extract_plain` on tests/patch_walk_cases.py, whose
cases the card's tests run through the kernel.

The model runs the kernel's protocol: CTAs of PX_WARPS warps take tiles of
PX_TILE chunks from a ticket; a warp takes its window of 32 counts and a
ballot of the live lanes; the tile's count, the sum of the ballots'
popcounts, is published as an aggregate (the first tile's inclusive); a
tile behind, the walk (lookback.cuh prefix_walk: 32 status words a step,
back to the nearest inclusive one, its first window read at the
iteration's start) gives the rows before the tile and publishes the
inclusive sum, and each warp copies its window's live chunks (a lane's
rank in the window the popcount of the ballot below it, the windows' first
rows the warps' popcounts summed; where a block holds fewer than 32
chunks, the same chunk of x-neighbour blocks one after another; a lane 4
cells through the stripe map).
The CTAs run interleaved in a shuffled order, one action at a time, so the
tiles publish, walk and copy in many orders; a walk that finds a word not
yet published waits."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
torch.set_num_threads(1)  # one thread a process: the suite runs in parallel workers

from cvxcompress_tpu_torch.ops import geometry, pack

import patch_walk_cases as pc

PX_WARPS = 8  # csrc/patch_extract.cu
PX_TILE = 32 * PX_WARPS
LB_AGG, LB_INCL = 1 << 30, 2 << 30  # csrc/lookback.cuh
LB_VALUE = LB_AGG - 1


def map_origin(m, blk):
    """stripe_map.cuh map_origin<true>, transcribed."""
    lbx, lby, lbz, nbx, nby, nxp, nyp = m
    bxi, t = blk % nbx, blk // nbx
    byi, bzi = t % nby, t // nby
    return ((bzi << lbz) * nyp + (byi << lby)) * nxp + (bxi << lbx)


def map_cell(m, l):
    """stripe_map.cuh map_cell<true>, transcribed."""
    lbx, lby, lbz, nbx, nby, nxp, nyp = m
    x, y, z = l & ((1 << lbx) - 1), (l >> lbx) & ((1 << lby) - 1), l >> (lbx + lby)
    return (z * nyp + y) * nxp + x


def model_patch(plane, desc, cb, m, nlive, grid, seed, steps=None, rounds=False):
    """rows, drows, ids as the kernel's `grid` CTAs write them (numpy);
    every row is written once.  plane and desc flat numpy arrays, cb the
    chunk counts, m the map (geometry.map_args); `steps`, a list, gets the
    number of 32-word windows each walk read.  The
    CTAs take one action at a time, a random CTA each, or with `rounds` each
    CTA one action a pass in a shuffled order (the card's CTAs in step: a
    round's tiles all publish their counts before any walks)."""
    n = cb.size
    ntiles = -(-n // PX_TILE)
    lcpb = m[0] + m[1] + m[2] - 7
    status = np.zeros(ntiles, np.int64)
    ticket = [0]
    rows = np.full((nlive, 128), np.nan, np.float32)
    drows = np.full((nlive, 128), -1, np.int32)
    ids = np.full(nlive, -1, np.int64)
    written = np.zeros(nlive, np.int64)

    def take():
        ticket[0] += 1
        return ticket[0] - 1

    def window(t, w):
        """The live lanes of warp w's window of tile t (its ballot)."""
        c = (t * PX_WARPS + w) * 32 + np.arange(32)
        cnt = np.where((t < ntiles) & (c < n), cb[np.minimum(c, n - 1)], 0)
        return sum(1 << int(i) for i in np.flatnonzero(cnt != 0))

    def peek(t):
        r = t - 1 - np.arange(32)
        return np.where(r >= 0, status[np.maximum(r, 0)], LB_INCL)

    def walk(t, count, pre):
        """prefix_walk: 32 words a step, nearest first, the first window
        from the peek where it was published; yields while a word it needs
        is not published."""
        excl, base, read = 0, t - 1, 0
        while base >= 0:
            read += 1
            r = base - np.arange(32)
            while True:
                f = np.where(r >= 0, status[np.maximum(r, 0)], LB_INCL)
                if base == t - 1:
                    f = np.where(pre != 0, pre, f)
                if (f != 0).all():
                    break
                yield None
            yield None  # the loads' latency: other CTAs act meanwhile
            incl = np.flatnonzero(f & LB_INCL)
            upto = 32 if incl.size == 0 else incl[0] + 1
            excl += int((f[:upto] & LB_VALUE).sum())
            if incl.size:
                break
            base -= 32
        if steps is not None:
            steps.append(read)
        if t:
            status[t] = LB_INCL | (excl + count)
        yield excl

    def copy(t, masks, bases, first):
        """Warp w copies its window's live chunks in the kernel's order: where a block has fewer than 32 chunks (XN),
        position p = j nb + b is chunk j of the window's block b."""
        lb = 5 - lcpb if lcpb < 5 else 0
        order = [((p & ((1 << lb) - 1)) << lcpb) | (p >> lb) for p in range(32)]
        for w in range(PX_WARPS):
            w0 = (t * PX_WARPS + w) * 32
            mask = masks[w]
            for lane in [i for i in order if (mask >> i) & 1]:
                r = first + bases[w] + bin(mask & ((1 << lane) - 1)).count("1")
                ch = w0 + lane
                origin = map_origin(m, ch >> lcpb)
                l = ((ch & ((1 << lcpb) - 1)) << 7) + 4 * np.arange(32)
                src = origin + map_cell(m, l)  # a lane's 4 cells: 4 consecutive floats
                rows[r] = plane[(src[:, None] + np.arange(4)).reshape(-1)]
                drows[r] = desc[ch * 128:(ch + 1) * 128]
                ids[r] = ch
                written[r] += 1

    def cta():
        t = take()
        yield
        prev, pmasks, pbases, pcount = -1, None, None, 0
        while True:
            cur = t < ntiles
            if not cur and prev < 0:
                return
            nt = take() if cur else ntiles
            pre = peek(prev) if prev > 0 else None
            yield
            masks = [window(t, w) for w in range(PX_WARPS)]
            pops = [bin(x).count("1") for x in masks]
            bases = list(np.cumsum([0] + pops[:-1]))
            count = sum(pops)
            if cur:
                status[t] = (LB_AGG if t else LB_INCL) | count
            yield
            if prev >= 0:
                first = None
                for first in walk(prev, pcount, pre):
                    if first is None:
                        yield
                copy(prev, pmasks, pbases, first)
                yield
            prev, pmasks, pbases, pcount = (t if cur else -1), masks, bases, count
            t = min(nt, ntiles)

    rng = np.random.default_rng(seed)
    ctas = [cta() for _ in range(grid)]
    for _ in range(200000):
        if not ctas:
            break
        for k in rng.permutation(len(ctas)) if rounds else [rng.integers(len(ctas))]:
            try:
                next(ctas[k])
            except StopIteration:
                ctas[k] = None
        ctas = [c for c in ctas if c is not None]
    assert not ctas, "the walks did not end"
    assert (written == 1).all()
    return rows, drows, ids.astype(np.int32)


@pytest.fixture(scope="module")
def cases():
    return {name: pc.make(name) for name in pc.CASES}


def test_cases_reach_the_walks_edges(cases):
    """The cases hold what they are named for: no live chunk; every chunk
    live; one live chunk, lane 31, in the last window; raw blocks (their
    chunks count 0) between live ones; tiles whose count is not a multiple
    of the model's CTAs; each plane at a block the patch route takes."""
    for name, c in cases.items():
        assert geometry.patch_ok(c["block"]), name
        assert c["nlive"] == int((c["chunk_bytes"] > 0).sum()), name
    assert cases["no_live"]["nlive"] == 0
    for name in ("all_live", "all_live_16"):
        assert bool((cases[name]["chunk_bytes"] > 0).all())
    cb = cases["last_window_one"]["chunk_bytes"].numpy()
    assert cb.size % 32 == 0 and (np.flatnonzero(cb[-32:]) == [31]).all()
    assert (cb[:-32] > 0).sum() > 1
    cb = cases["raw_between"]["chunk_bytes"].numpy().reshape(-1, 32)  # 32 chunks a 16^3 block
    dead = np.flatnonzero((cb == 0).all(1))
    assert dead.size and dead.min() > 0 and dead.max() < cb.shape[0] - 1
    tiles = {name: -(-c["chunk_bytes"].numel() // PX_TILE) for name, c in cases.items()}
    assert any(t > 5 and t % 5 for t in tiles.values())
    assert any(t % 3 for t in tiles.values())


@pytest.mark.parametrize("grid,seed,rounds", [(1, 0, False), (3, 1, False), (5, 2, True)])
@pytest.mark.parametrize("name", list(pc.CASES))
def test_model_walk_equals_plain(cases, name, grid, seed, rounds):
    """The model of the launch, its CTAs in a shuffled order, gives
    `patch_extract_plain`'s rows, descriptors and ids; so does the wrapper
    on the CPU."""
    c = cases[name]
    args = (c["plane"], c["desc"], c["chunk_bytes"], c["block"], c["nlive"])
    want = pack.patch_extract_plain(*args)
    got = model_patch(c["plane"].numpy().reshape(-1), c["desc"].numpy().reshape(-1),
                      c["chunk_bytes"].numpy(), geometry.map_args(c["plane"].shape,
                                                                  c["block"]),
                      c["nlive"], grid, seed, rounds=rounds)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.view(np.int32), w.numpy().view(np.int32))
    for g, w in zip(pack.patch_extract(*args), want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("grid", [40, 90])
def test_model_walk_across_windows(grid):
    """Synthetic counts (any chunk live with probability 0.1), 100 tiles
    under `grid` CTAs in step: walks that step back past 32 tiles, and the
    rows of `patch_extract_plain` (which takes any counts)."""
    rng = np.random.default_rng(5)
    block, shape = (8, 16, 8), (32, 320, 320)
    plane = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    nchunks = plane.numel() // 128
    desc = torch.from_numpy(rng.integers(-2**31, 2**31, (nchunks // 8, 1024), np.int64)
                            .astype(np.int32))
    cb = torch.from_numpy((rng.random(nchunks) < 0.1) * rng.integers(1, 600, nchunks)
                          ).to(torch.int32)
    nlive = int((cb > 0).sum())
    steps = []
    got = model_patch(plane.numpy().reshape(-1), desc.numpy().reshape(-1), cb.numpy(),
                      geometry.map_args(shape, block), nlive, grid, 3, steps, rounds=True)
    assert -(-nchunks // PX_TILE) == 100 and max(steps) > 1
    for g, w in zip(got, pack.patch_extract_plain(plane, desc, cb, block, nlive)):
        np.testing.assert_array_equal(g.view(np.int32), w.numpy().view(np.int32))
