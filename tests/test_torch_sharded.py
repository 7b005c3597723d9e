"""The port's sharded dataflow (`cvxcompress_tpu_torch/parallel/sharded.py`,
`multihost.py` in one process): the numpy pieces equal to the JAX
module's, the merge byte-equal to the JAX merge, `compress_sharded` and
`split_segments` + merge byte-equal to the port's single compress, the
segment files and their header check."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
torch.set_num_threads(1)  # one thread a process: the suite runs in parallel workers

import cvxcompress_tpu as cvx
from cvxcompress_tpu.parallel import sharded as jsharded
from cvxcompress_tpu_torch import container as ctn
from cvxcompress_tpu_torch.ops import codec
from cvxcompress_tpu_torch.parallel import multihost, sharded

from conftest import make_radial_volume, rel_error_and_snr


def single(vol, block, local=False):
    return codec.compress(vol, 1e-2, block, local, device="cpu")[0]


@pytest.mark.parametrize("shape,block,n", [
    ((100, 8, 8), (8, 8, 8), 4), ((21, 16, 16), (8, 8, 8), 2),
    ((40, 32, 48), (16, 16, 8), 5), ((7, 9, 11), (8, 8, 1), 3),
    ((5, 16, 16), (16, 16, 16), 4),
])
def test_plan_and_sums_equal_jax(shape, block, n):
    """plan_shards, partial_sumsq and mulfac_from_sumsq are the JAX ones."""
    assert sharded.plan_shards(shape, block, n) == jsharded.plan_shards(shape, block, n)
    vol = make_radial_volume(*shape)
    ss = [sharded.partial_sumsq(vol[z0:z1]) for z0, z1 in sharded.plan_shards(shape, block, n)]
    jss = [jsharded.partial_sumsq(vol[z0:z1]) for z0, z1 in jsharded.plan_shards(shape, block, n)]
    assert ss == jss
    for scale in (1e-2, 1e-1):
        a = sharded.mulfac_from_sumsq(sum(ss), vol.size, scale)
        b = jsharded.mulfac_from_sumsq(sum(jss), vol.size, scale)
        assert a.dtype == b.dtype == np.float32 and a.view(np.uint32) == b.view(np.uint32)
    assert sharded.mulfac_from_sumsq(0.0, vol.size, 1e-2) == np.float32(1.0)


@pytest.mark.parametrize("local", [False, True])
def test_merge_of_jax_segments_equals_jax_merge(local):
    """The port's merge of the JAX package's own segments is byte-equal to
    the JAX merge (and to the JAX single compress)."""
    vol = make_radial_volume(nz=40, ny=16, nx=24)
    block = (8, 8, 8)
    plan = jsharded.plan_shards(vol.shape, block, 3)
    mf = np.float32(1.0) if local else jsharded.mulfac_from_sumsq(
        sum(jsharded.partial_sumsq(vol[a:b]) for a, b in plan), vol.size, 1e-2)
    segs = [jsharded.compress_shard(vol[a:b], 1e-2, block, mf, local) for a, b in plan]
    want = jsharded.merge_segments(segs, vol.shape, block, mf, local)
    got = sharded.merge_segments(segs, vol.shape, block, mf, local)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, cvx.compress(vol, 1e-2, block=block,
                                                    use_local_rms=local)[0])


@pytest.mark.parametrize("num_shards", [1, 2, 3, 5])
def test_sharded_byte_equal_to_single(num_shards):
    vol = make_radial_volume(nz=40, ny=32, nx=48)
    data, ratio = sharded.compress_sharded(vol, 1e-2, block=(16, 16, 8),
                                           num_shards=num_shards, device="cpu")
    np.testing.assert_array_equal(data, single(vol, (16, 16, 8)))
    assert ratio > 1


@pytest.mark.parametrize("shape,block,local,n", [
    ((32, 16, 16), (8, 8, 8), True, 2),      # the local RMS
    ((21, 16, 16), (8, 8, 8), False, 2),     # the last shard's clipped blocks
    ((70, 40, 40), (32, 32, 32), True, 3),   # 32^3, local, clipped
])
def test_sharded_cases_byte_equal_to_single(shape, block, local, n):
    """The cases of tests/test_sharded.py, and the 32^3 route (the route
    forcing of a slab: tests/test_torch_parallel.py)."""
    vol = make_radial_volume(*shape)
    data, _ = sharded.compress_sharded(vol, 1e-2, block=block, num_shards=n,
                                       use_local_rms=local, device="cpu")
    np.testing.assert_array_equal(data, single(vol, block, local))


@pytest.mark.parametrize("shape,block,local,ranges", [
    ((40, 32, 48), (16, 16, 8), False, [(0, 1), (1, 4), (4, 5)]),
    ((70, 40, 40), (32, 32, 32), True, [(0, 2), (2, 3)]),
    ((21, 16, 16), (8, 8, 8), False, [(0, 3)]),
])
def test_split_then_merge_is_identity(shape, block, local, ranges):
    """split_segments cuts slab containers (each byte-equal to the compress
    of its slab on the volume's route at the volume's mulfac), and merging
    them gives back the container."""
    vol = make_radial_volume(*shape)
    data = single(vol, block, local)
    hdr = ctn.unpack(data)[0]
    slabs = sharded.split_segments(data, ranges)
    for (r0, r1), s in zip(ranges, slabs):
        z0, z1 = r0 * block[2], min(r1 * block[2], shape[0])
        want = sharded.compress_shard(vol[z0:z1], 1e-2, block, hdr.glob_mulfac, local,
                                      device="cpu", vol_shape=shape)
        np.testing.assert_array_equal(s, want)
    np.testing.assert_array_equal(
        sharded.merge_segments(slabs, shape, block, hdr.glob_mulfac, local), data)
    with pytest.raises(ValueError):
        sharded.split_segments(data, [(1, 1)])


def test_split_of_unordered_payloads():
    """A container whose payloads are out of block order (the reference
    writes them in thread-completion order) splits into the same slabs."""
    vol = make_radial_volume(nz=24, ny=16, nx=16)
    data = single(vol, (8, 8, 8))
    hdr, offs, _, base = ctn.unpack(data)
    nnn = hdr.grid[3]
    plain = offs & ~ctn.RAW_FLAG
    sizes = np.diff(np.r_[plain, data.size - ctn.SLACK_BYTES - base])
    order = np.arange(nnn)[::-1]  # payloads written last block first
    pay = [data[base + plain[i]:base + plain[i] + sizes[i]] for i in order]
    new = np.empty(nnn, np.int64)
    new[order] = np.cumsum(sizes[order]) - sizes[order]
    shuffled = data.copy()
    shuffled[ctn.HEADER_BYTES:ctn.HEADER_BYTES + 8 * nnn] = new.view(np.uint8)
    shuffled[base:base + int(sizes.sum())] = np.concatenate(pay)
    ranges = [(0, 1), (1, 3)]
    for a, b in zip(sharded.split_segments(shuffled, ranges),
                    sharded.split_segments(data, ranges)):
        np.testing.assert_array_equal(a, b)


def test_multihost_single_process_and_files(tmp_path):
    """Without a process group: the merged container and the segment file,
    each byte-equal to the single compress; a header mismatch raises."""
    vol = make_radial_volume(nz=24, ny=16, nx=16)
    want = single(vol, (8, 8, 8))
    data = multihost.compress(vol, 1e-2, block=(8, 8, 8), device="cpu")
    np.testing.assert_array_equal(data, want)
    path = multihost.compress(vol, 1e-2, block=(8, 8, 8), gather="files",
                              file_prefix=str(tmp_path / "seg"), device="cpu")
    merged = multihost.merge_segment_files([path], vol.shape, (8, 8, 8))
    np.testing.assert_array_equal(merged, want)
    out = codec.decompress(merged, device="cpu").numpy()
    assert rel_error_and_snr(vol, out)[0] < 1e-2

    other = multihost.compress(vol, 1e-1, block=(8, 8, 8), gather="files",
                               file_prefix=str(tmp_path / "other"), device="cpu")
    with pytest.raises(ValueError, match="header mismatch"):
        multihost.merge_segment_files([path, other], vol.shape, (8, 8, 8))
    with pytest.raises(ValueError):
        multihost.compress(vol, 1e-2, gather="files", device="cpu")
