"""The port's multi-device layer on a mesh of 8 CPU devices
(`cvxcompress_tpu_torch/parallel/compress.py`, `mesh.py`): containers
byte-identical across mesh sizes and to the single compress on every
route, the sharded decompress against the single one, and the JAX
package's `parallel` on its 8 virtual CPU devices (tests/conftest.py)."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
torch.set_num_threads(1)  # one thread a process: the suite runs in parallel workers

from cvxcompress_tpu.parallel import compress as jpcompress
from cvxcompress_tpu.parallel import mesh as jmesh
from cvxcompress_tpu_torch.ops import codec
from cvxcompress_tpu_torch.parallel import compress as pcompress
from cvxcompress_tpu_torch.parallel import mesh as meshlib
from cvxcompress_tpu_torch.parallel import sharded

from conftest import make_radial_volume, make_sinusoid_volume, rel_error_and_snr

CPU8 = ["cpu"] * 8


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sqrt(np.mean((a - b) ** 2)) / (np.sqrt(np.mean(b ** 2)) + 1e-30)


# (shape, block, local, route): one case a route, and the 128^3 volume
# whose first slab is aligned (its own shape would pick "block128")
CASES = [
    ((20, 24, 40), (8, 8, 8), False, "stripe"),
    ((36, 32, 32), (16, 16, 16), False, "stripe_fused"),
    ((70, 40, 40), (32, 32, 32), False, "fused32"),
    ((70, 40, 40), (32, 32, 32), True, "fused32"),
    ((128, 128, 256), (128, 128, 128), False, "block128"),
    ((200, 128, 128), (128, 128, 128), False, "stripe"),
]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[3]}-{c[1][0]}-{c[2]}")
def case(request):
    shape, block, local, path = request.param
    vol = make_radial_volume(*shape)
    assert codec.route(shape, block) == path
    data, ratio = codec.compress(vol, 1e-2, block, local, device="cpu")
    return vol, block, local, data, ratio


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_container_identical_across_mesh_sizes(case, n):
    vol, block, local, want, ratio = case
    got, r = pcompress.compress(vol, 1e-2, block, local, mesh=CPU8[:n])
    np.testing.assert_array_equal(got, want)
    assert r == ratio


def test_decompress_matches_single(case):
    """Bit-equal to the single decompress on the kernel routes (their plain
    versions here), within rel 1e-6 on the stripe route; both engines."""
    vol, block, _, data, _ = case
    path = codec.route(vol.shape, block)
    # the block128 case has one block row (the cut delegates): one engine
    for engine in ("auto",) if path == "block128" else ("auto", "device"):
        want = codec.decompress(data, device="cpu", engine=engine)
        got = pcompress.decompress(data, mesh=CPU8, engine=engine)
        assert got.shape == want.shape and got.device.type == "cpu"
        if path == "stripe":
            assert rel(got, want) < 1e-6
        else:
            assert torch.equal(got, want)
    assert rel_error_and_snr(vol, got.numpy())[0] < 1e-2


def test_tensor_volume_and_ranges():
    """A CPU tensor shards as views (host RMS, as the single compress); the
    decode cut tiles the block rows, balanced on bytes, skipping empties."""
    vol = make_sinusoid_volume(96, 32, 32, periods=3)
    want = codec.compress(vol, 1e-2, device="cpu")[0]
    got, _ = pcompress.compress(torch.from_numpy(vol), 1e-2, mesh=CPU8[:3])
    np.testing.assert_array_equal(got, want)
    assert pcompress.decode_ranges(want, 8) == [(0, 1), (1, 2), (2, 3)]
    assert pcompress.decode_ranges(want, 1) == [(0, 3)]
    data = codec.compress(make_radial_volume(80, 8, 8), 1e-2, (8, 8, 8), device="cpu")[0]
    ranges = pcompress.decode_ranges(data, 4)
    assert ranges[0][0] == 0 and ranges[-1][1] == 10 and len(ranges) == 4
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = sharded.block_sizes(data)[3].reshape(10, -1).sum(1)
    shares = [int(sizes[a:b].sum()) for a, b in ranges]
    assert max(shares) - min(shares) <= 2 * sizes.max(), shares


def test_make_mesh():
    assert meshlib.make_mesh(["cpu", "cpu"]) == (torch.device("cpu"),) * 2
    assert meshlib.pad_to_shards(6, 8) == jmesh.pad_to_shards(6, 8) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            meshlib.make_mesh()
        with pytest.raises(RuntimeError):
            meshlib.make_mesh(["cuda:0"] * 2)
        with pytest.raises(RuntimeError):
            pcompress.compress(make_radial_volume(8, 8, 8), 1e-2, (8, 8, 8))
    with pytest.raises(ValueError):
        meshlib.make_mesh([])


@pytest.fixture(scope="module")
def jax_pair():
    """The JAX package's sharded compress and decompress on its 8-device
    mesh, beside the port's on CPU8, one volume: four JAX calls."""
    assert len(jax.devices()) == 8
    vol = make_radial_volume(nz=32, ny=24, nx=40)
    jm = jmesh.make_mesh()
    jd, _ = jpcompress.compress(vol, 1e-2, block=(8, 8, 8), mesh=jm)
    pd, _ = pcompress.compress(vol, 1e-2, (8, 8, 8), mesh=CPU8)
    return dict(vol=vol, jd=jd, pd=pd,
                j_of_j=np.asarray(jpcompress.decompress(jd, mesh=jm)),
                j_of_p=np.asarray(jpcompress.decompress(pd, mesh=jm)))


def test_against_jax_parallel(jax_pair):
    """Size within max(64 B, 1 %) of the JAX package's sharded container,
    each package decodes the other's, the port's sharded decompress within
    1e-5 of the JAX one's."""
    p = jax_pair
    assert abs(p["pd"].size - p["jd"].size) <= max(64, 0.01 * p["jd"].size)
    p_of_j = pcompress.decompress(p["jd"], mesh=CPU8).numpy()
    p_of_p = pcompress.decompress(p["pd"], mesh=CPU8).numpy()
    assert rel(p_of_j, p["j_of_j"]) < 1e-5
    assert rel(p_of_p, p["j_of_p"]) < 1e-5
    for out in (p_of_j, p_of_p, p["j_of_p"]):
        assert rel_error_and_snr(p["vol"], out)[0] < 1e-2


def test_distributed_sumsq_against_jax():
    vol = make_radial_volume(nz=16, ny=16, nx=64)
    jm = jmesh.make_mesh()
    v = jax.device_put(vol.ravel(), jax.sharding.NamedSharding(
        jm, jax.sharding.PartitionSpec("blocks")))
    want = float(jpcompress.distributed_sumsq(v, jm))
    slabs = [torch.from_numpy(vol[z0:z1])
             for z0, z1 in sharded.plan_shards(vol.shape, (8, 8, 8), 8) if z1 > z0]
    got = pcompress.distributed_sumsq(slabs)
    assert abs(got - want) / want < 1e-6
    assert got == pytest.approx(float(np.sum(np.square(vol, dtype=np.float64))),
                                rel=1e-12)
    assert pcompress.distributed_sumsq([vol[:8], vol[8:]]) == pytest.approx(got, rel=1e-12)
