"""The chunk-sparse emit of csrc/block_emit.cu on the CPU: a numpy model of
the kernel's walk (windows of 32 down to 2 chunks or rows, by grid stride
in rotated bands, the count load and ballot, the base and mulfac of the
live lanes, the live chunks 32 / LPC a step, a lane's group of 8 cells, the
stripe map's addresses, the LPC-lane exclusive scan of the group costs,
rows mode's gathers), held byte for byte to `emit_chunks_plain` and
`emit_rows_plain` on tests/chunk_emit_cases.py, whose cases the card's
tests run through the kernel; and the 32^3 encode's chunk counts
(`fused_encode_plain`, the kernel's per-plane warp sums, JAX K1's
descriptors in interpret mode)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
torch.set_num_threads(1)  # one thread a process: the suite runs in parallel workers

import jax.numpy as jnp

from cvxcompress_tpu.ops import tokenize_pallas as tp
from cvxcompress_tpu.ops import wavelet as jwav
from cvxcompress_tpu_torch.ops import geometry, pack, quant, rle_device, tokenize

import chunk_emit_cases as ec

EMIT_WARPS = 8  # csrc/block_emit.cu
ROT = 40503  # a pass's rotation of its band of windows


# -- the kernel's walk -------------------------------------------------------

def map_addr(blk, l, stripe):
    """stripe_map.cuh map_origin(blk) + map_cell(l), transcribed; `stripe`
    is log2 of the cells per block for block-major coefficients (the
    identity map) or the map's (lbx, lby, lbz, nbx, nby, nxp, nyp)."""
    if isinstance(stripe, int):
        return (blk << stripe) + l
    lbx, lby, lbz, nbx, nby, nxp, nyp = stripe
    bxi, t = blk % nbx, blk // nbx
    byi, bzi = t % nby, t // nby
    origin = ((bzi << lbz) * nyp + (byi << lby)) * nxp + (bxi << lbx)
    x, y, z = l & ((1 << lbx) - 1), (l >> lbx) & ((1 << lby) - 1), l >> (lbx + lby)
    return origin + (z * nyp + y) * nxp + x


def model_emit(coeffs, desc, chunk_bytes, chunk_base, mulfacs, total, lchunk, lcpb,
               stripe, ids=None, lw=5, grid=3, seed=0):
    """The stream block_emit_kernel writes, built the way its warps walk:
    `grid` CTAs of EMIT_WARPS warps, warp w taking tickets w, w + warps,
    ..., ticket u of pass p = u // warps the window p * warps + (u - p *
    warps + p * ROT) mod (the band's length) of 1 << lw chunks (rows);
    the live lanes of a window CPS = 32 / LPC a step, lane group g the
    g-th; the warps run in a shuffled order (the stream must not depend on
    it).  coeffs and desc flat numpy arrays (rows mode: the gathered rows),
    the rest numpy; `stripe` as `map_addr` takes it (unused in rows mode)."""
    cw = 1 << lchunk
    lpc = cw // 8
    cps = 32 // lpc
    n = chunk_bytes.size if ids is None else ids.size
    nwin = -(-n // (1 << lw))
    warps = grid * EMIT_WARPS
    out = np.zeros(total, np.uint8)
    groups = []  # (cells (8,), desc (8,), mulfac, stream offset) of each token group
    seen = []
    for w in np.random.default_rng(seed).permutation(warps):
        for u in range(w, nwin, warps):
            band = u // warps * warps
            win = band + (u - band + u // warps * ROT) % min(warps, nwin - band)
            seen.append(win)
            r = (win << lw) + np.arange(32)
            valid = (np.arange(32) < (1 << lw)) & (r < n)
            chunk = np.where(valid, r if ids is None else ids[np.minimum(r, n - 1)], -1)
            cnt = np.where(valid, chunk_bytes[np.maximum(chunk, 0)], 0)
            base = np.where(cnt != 0, chunk_base[np.maximum(chunk, 0)], 0)
            mf = np.where(cnt != 0, mulfacs[np.maximum(chunk, 0) >> lcpb], 0)
            live = int(sum(1 << int(i) for i in np.flatnonzero(cnt != 0)))
            while live:
                step = []  # step[g]: the lane of the chunk lane group g takes
                for _ in range(cps):
                    step.append((live & -live).bit_length() - 1 if live else -1)
                    live &= live - 1
                for p in step:
                    if p < 0:
                        continue
                    c = (win << lw) + p  # the chunk, or in rows mode the row
                    sub = np.arange(lpc)
                    d = desc[c * cw + sub[:, None] * 8 + np.arange(8)]
                    mine = (d & 7).sum(1)
                    off = np.cumsum(mine) - mine  # the lpc-lane exclusive scan
                    if ids is None:
                        blk = c >> lcpb
                        l = (c - (blk << lcpb)) * cw + sub * 8
                        src = map_addr(blk, l, stripe)
                    else:
                        src = c * cw + sub * 8
                    for s in np.flatnonzero(mine):
                        groups.append((coeffs[src[s] + np.arange(8)], d[s], mf[p],
                                       base[p] + off[s]))
    assert sorted(seen) == list(range(nwin))  # the order is a permutation
    if groups:
        cv = torch.from_numpy(np.stack([g[0] for g in groups]))
        dg = torch.from_numpy(np.stack([g[1] for g in groups]))
        mfs = torch.from_numpy(np.array([g[2] for g in groups], np.float32))
        planes, cost = pack.token_bytes(cv, mfs, dg)
        cost = cost.numpy()
        at = np.array([g[3] for g in groups])[:, None] + np.cumsum(cost, 1) - cost
        for k, plane in enumerate(planes):
            m = cost > k
            out[at[m] + k] = plane.numpy()[m]
    return out


def case_args(c):
    """The model's (coeffs, desc, lchunk, lcpb, stripe) of a case."""
    nnn, cells = c["desc"].shape
    chunk = rle_device.chunk_cells(cells)
    lchunk = chunk.bit_length() - 1
    lcpb = (cells // chunk).bit_length() - 1
    if c["block"] is None:
        stripe = lchunk + lcpb
    else:
        stripe = geometry.map_args(c["coeffs"].shape, c["block"])
    return (c["coeffs"].numpy().reshape(-1), c["desc"].numpy().reshape(-1), lchunk,
            lcpb, stripe)


@pytest.fixture(scope="module")
def cases():
    return {name: ec.make(name) for name in ec.CASES}


def test_cases_reach_the_walks_edges(cases):
    """The cases hold what they are named for: no live chunk at all; only
    lane 31's; windows with an odd count of live chunks and raw blocks
    between live ones; a last window cut short; 64-cell chunks."""
    def windows(c):
        cb = c["chunk_bytes"].numpy()
        live = np.zeros(-(-cb.size // 32) * 32, bool)
        live[: cb.size] = cb > 0
        return live.reshape(-1, 32)

    assert cases["all_dead"]["total"] == 0 and not windows(cases["all_dead"]).any()
    lw = windows(cases["lane31_only"])
    assert lw[:, 31].sum() == 2 and not lw[:, :31].any()
    ow = windows(cases["odd_and_raw"])
    cb = cases["odd_and_raw"]["chunk_bytes"].numpy().reshape(-1, 4)
    raw_blocks = np.flatnonzero((cb == 0).all(1))
    assert (ow.sum(1) % 2 == 1).any() and raw_blocks.size > 0
    assert raw_blocks.min() > 0 and raw_blocks.max() < cb.shape[0] - 1
    assert cases["tail_window"]["chunk_bytes"].numel() % 32 == 20
    assert cases["stripe_8x8x1"]["desc"].shape[1] == 64
    for name, c in cases.items():
        assert c["chunk_bytes"].sum() == c["total"], name


@pytest.mark.parametrize("name", list(ec.CASES))
def test_model_walk_equals_plain(cases, name):
    """The model of the kernel's walk writes `emit_chunks_plain`'s stream,
    and so does the wrapper on the CPU."""
    c = cases[name]
    args = (c["coeffs"], c["mulfacs"], c["desc"], c["chunk_bytes"], c["chunk_base"],
            c["total"], c["block"])
    want = pack.emit_chunks_plain(*args).numpy()
    coeffs, desc, lchunk, lcpb, stripe = case_args(c)
    for lw, grid in ((5, 1), (5, 3), (4, 2), (2, 5), (1, 7)):
        got = model_emit(coeffs, desc, c["chunk_bytes"].numpy(), c["chunk_base"].numpy(),
                         c["mulfacs"].numpy(), c["total"], lchunk, lcpb, stripe,
                         lw=lw, grid=grid, seed=grid)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pack.emit_chunks(*args).numpy(), want)


@pytest.mark.parametrize("name", list(ec.ROWS))
def test_model_rows_walk_equals_plain(cases, name):
    """Rows mode, ids out of order, a raw block's rows among them: the
    model's gathers (ids[r], then its count, base and block's mulfac) write
    `emit_rows_plain`'s stream, which is the in-place stream."""
    c = cases[name]
    rows, drows, ids = ec.rows_of(c)
    want = pack.emit_rows_plain(rows, drows, ids, c["mulfacs"], c["chunk_bytes"],
                                c["chunk_base"], c["total"]).numpy()
    np.testing.assert_array_equal(want, pack.emit_chunks_plain(
        c["coeffs"], c["mulfacs"], c["desc"], c["chunk_bytes"], c["chunk_base"],
        c["total"], c["block"]).numpy())
    nnn, cells = c["desc"].shape
    for lw in (5, 3, 2):
        got = model_emit(rows.numpy().reshape(-1), drows.numpy().reshape(-1),
                         c["chunk_bytes"].numpy(), c["chunk_base"].numpy(),
                         c["mulfacs"].numpy(), c["total"], 7,
                         (cells // 128).bit_length() - 1, None,
                         ids=ids.numpy().astype(np.int64), lw=lw, grid=2)
        np.testing.assert_array_equal(got, want)


# -- the 32^3 encode's chunk counts ------------------------------------------

def half_chunk_counts(desc):
    """fused_encode.cu's chunk counts (common.cuh tokenize_half,
    chunk_cost): warp w's rows (z, 2w) and (z, 2w + 1) summed into slot
    32 w + z; chunk j the slots of warps 2 (j % 8) and 2 (j % 8) + 1 at
    z = j // 8."""
    rows = (desc & 7).reshape(-1, 32, 32, 32).sum(-1)  # (nnn, z, y)
    slots = rows.reshape(-1, 32, 16, 2).sum(-1).transpose(0, 2, 1).reshape(-1, 512)
    j = np.arange(256)
    return slots[:, 2 * (j % 8) * 32 + j // 8] + slots[:, (2 * (j % 8) + 1) * 32 + j // 8]


@pytest.mark.parametrize("local", [False, True], ids=["global", "local"])
def test_fused_encode_plain_chunk_counts(local):
    """`fused_encode_plain`'s chunk counts: (desc & 7) summed per 128 cells
    with a raw block's zeroed, `tokenize_blocks_plain`'s on its
    coefficients and table, and the kernel's half-chunk slots' sums."""
    rng = np.random.default_rng(3)
    vol = rng.standard_normal((40, 64, 70)).astype(np.float32)
    vol[:, :, 32:64] *= np.float32(1e6)  # raw blocks at the global RMS
    vol[:32, :32, :32] = 0.0
    vt = torch.from_numpy(vol)
    args = dict(scale=1e-2) if local else dict(mulfac=quant.global_mulfac(vol, 1e-7))
    coeffs, desc, cb, sizes, raw, mulfacs = tokenize.fused_encode(vt, **args)
    assert cb.shape == (coeffs.shape[0] * 256,) and cb.dtype == torch.int32
    per = (desc & 7).view(-1, 128).sum(1).view(-1, 256)
    per[raw] = 0
    assert torch.equal(cb, per.view(-1).to(torch.int32))
    assert bool(raw.any()) != local and not bool(raw.all())
    assert torch.equal(cb.view(-1, 256).sum(1)[~raw], sizes[~raw])
    _, cb2, s2, r2 = tokenize.tokenize_blocks_plain(coeffs, mulfacs)
    assert torch.equal(cb, cb2) and torch.equal(sizes, s2) and torch.equal(raw, r2)
    slots = half_chunk_counts(desc.numpy())
    slots[raw.numpy()] = 0
    np.testing.assert_array_equal(cb.numpy().reshape(-1, 256), slots)


def test_jax_k1_descriptor_sums_are_the_chunk_counts():
    """JAX K1 (stripe_fused_encode, interpret mode) at 32^3: the per-128-cell
    sums of its descriptors, block-major, a raw block's zeroed, are its own
    chunk_bytes and `tokenize_blocks_plain`'s on its fv, which the 32^3
    kernel's counts are held to on the card."""
    shape, block = (32, 64, 64), (32, 32, 32)
    rng = np.random.default_rng(4)
    z = np.sin(np.arange(shape[0]) * np.pi * 3 / shape[0]).astype(np.float32)
    vol = np.broadcast_to(z[:, None, None], shape).copy()
    vol += rng.standard_normal(shape).astype(np.float32) * np.float32(1e-3)
    vol[:, 32:, 32:] = rng.standard_normal((32, 32, 32)) * np.float32(1e6)  # raw
    mulfac = quant.global_mulfac(vol, 1e-7)
    fv, desc, _, jcb, _, jraw, _, _ = tp.stripe_fused_encode(
        jnp.asarray(vol), jnp.float32(mulfac), shape, block, interpret=True)
    w = jwav.padded_nbx(shape[2] // 32, 32) * 32
    nbz, nby, nbx = shape[0] // 32, shape[1] // 32, shape[2] // 32

    def block_major(plane):
        return (np.asarray(plane).reshape(nbz, 32, nby, 32, w // 32, 32)[:, :, :, :, :nbx]
                .transpose(0, 2, 4, 1, 3, 5).reshape(-1, 32 ** 3))

    jd = block_major(desc)
    raw = np.asarray(jraw)
    assert raw.any() and not raw.all()
    sums = (jd & 7).reshape(-1, 256, 128).sum(-1)
    sums[raw] = 0
    np.testing.assert_array_equal(np.asarray(jcb).reshape(-1, 256), sums)
    pd, pcb, _, praw = tokenize.tokenize_blocks_plain(
        torch.from_numpy(block_major(fv)), torch.ones(jd.shape[0]))
    np.testing.assert_array_equal(pd.numpy(), jd)
    np.testing.assert_array_equal(praw.numpy(), raw)
    np.testing.assert_array_equal(pcb.numpy().reshape(-1, 256), sums)
    np.testing.assert_array_equal(half_chunk_counts(jd)[~raw], sums[~raw])
