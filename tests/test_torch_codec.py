"""The port's codec end to end (plain versions on the CPU) against the
oracle, the JAX package and the native library: level 3 of ROADMAP.md."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
torch.set_num_threads(1)  # one thread a process: the suite runs in parallel workers

import cvxcompress_tpu_torch as cvt
from cvxcompress_tpu import container as jctn
from cvxcompress_tpu.ops import codec as jcodec
from cvxcompress_tpu.ops import rle_host as jrle_host
from cvxcompress_tpu.oracle import codec as ocodec
from cvxcompress_tpu.utils import io as jio
from cvxcompress_tpu_torch import container as ctn
from cvxcompress_tpu_torch.ops import rle_host
from cvxcompress_tpu_torch.utils import io

from conftest import make_radial_volume, make_sinusoid_volume, rel_error_and_snr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRANSFORM_TOL = 1e-5


def rel_rms(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.sqrt(((got - ref) ** 2).mean()) / (np.sqrt((ref**2).mean()) + 1e-30)


@pytest.fixture(scope="module")
def radial():
    """Unaligned on every axis, with noise: edge blocks and every token."""
    vol = make_radial_volume(nz=40, ny=50, nx=70)
    data, _ = cvt.compress(vol, 1e-2, device="cpu")
    return vol, data


def test_import_leaves_jax_out():
    """The port imports neither jax nor the JAX package, even after full
    roundtrips through every module, at 32^3 and at 128^3, with the global
    and the local RMS."""
    code = (
        "import sys, numpy as np\n"
        "import cvxcompress_tpu_torch as cvt\n"
        "from cvxcompress_tpu_torch.ops import (_kernels, codec, entropy_decode,"
        " fused_compress, fused_inverse, pack, quant, rle_device, rle_host,"
        " tokenize, wavelet, blocks)\n"
        "from cvxcompress_tpu_torch.utils import io\n"
        "v = np.ones((32, 32, 40), np.float32)\n"
        "cvt.decompress(cvt.compress(v, 1e-2, device='cpu')[0], device='cpu')\n"
        "cvt.decompress(cvt.compress(v, 1e-2, device='cpu')[0], device='cpu',"
        " engine='device')\n"
        "w = np.zeros((128, 128, 128), np.float32)\n"
        "w[60:70, 60:70, 60:70] = 1.0\n"
        "d = cvt.compress(w, 1e-2, block=(128, 128, 128), device='cpu')[0]\n"
        "assert cvt.decompress(d, device='cpu').shape == (128, 128, 128)\n"
        "d = cvt.compress(w, 1e-2, block=(128, 128, 128), use_local_rms=True,"
        " device='cpu')[0]\n"
        "assert cvt.decompress(d, device='cpu', engine='device').shape == (128, 128, 128)\n"
        "cvt.decompress(cvt.compress(v, 1e-2, use_local_rms=True, device='cpu')[0],"
        " device='cpu')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('cvxcompress_tpu.') or m == 'cvxcompress_tpu']\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"  # as the test processes (parallel workers)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_roundtrip_sinusoid_quality_bars():
    """The reference CI bars on a small sinusoid."""
    vol = make_sinusoid_volume(96, 64, 64, periods=3)
    data, ratio = cvt.compress(vol, 1e-2, block=(32, 32, 32), device="cpu")
    out = cvt.decompress(data, device="cpu")
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    err, snr = rel_error_and_snr(vol, out.numpy())
    assert err < 2e-4, err
    assert snr > 75.0, snr
    assert ratio > 500.0
    assert ratio == pytest.approx(vol.size * 4 / data.size)


@pytest.mark.parametrize("decoder", ["oracle", "jax", "native"])
def test_port_container_decodes_elsewhere(radial, decoder):
    """Port containers decode under the oracle, the JAX package and the
    native C ABI, within the transform tolerance of the port's own decode."""
    vol, data = radial
    mine = cvt.decompress(data, device="cpu").numpy()
    if decoder == "oracle":
        other = ocodec.decompress(data)
    elif decoder == "jax":
        other = jcodec.decompress(data)
    else:
        other = rle_host.host_decompress(data)
    assert other.shape == mine.shape == vol.shape
    assert rel_rms(mine, other) < TRANSFORM_TOL
    err, _ = rel_error_and_snr(vol, mine)
    assert err < 1e-2


@pytest.mark.parametrize(
    "shape,kind", [((40, 50, 70), "radial"), ((64, 96, 96), "sinusoid")]
)
def test_size_close_to_oracle(shape, kind):
    vol = (make_radial_volume(*shape) if kind == "radial"
           else make_sinusoid_volume(*shape, periods=3))
    mine, _ = cvt.compress(vol, 1e-2, device="cpu")
    ref, _ = ocodec.compress(vol, 1e-2)
    assert abs(int(mine.size) - int(ref.size)) <= max(64, 0.01 * ref.size)


@pytest.mark.parametrize("producer", ["oracle", "jax", "native"])
def test_port_decodes_foreign_containers(radial, producer):
    """Oracle, JAX and native containers decode in the port within 1e-5 of
    the JAX package's decode of the same container."""
    vol, _ = radial
    if producer == "oracle":
        data, _ = ocodec.compress(vol, 1e-2)
    elif producer == "jax":
        data, _ = jcodec.compress(vol, 1e-2)
    else:
        data, _ = rle_host.host_compress(vol, 1e-2)
    mine = cvt.decompress(data, device="cpu").numpy()
    assert rel_rms(mine, jcodec.decompress(data)) < TRANSFORM_TOL


def test_raw_fallback_roundtrip(rng):
    """Noise at scale 1e-8 makes blocks fall back to raw coefficients; the
    container still roundtrips, here and under the oracle."""
    vol = rng.standard_normal((40, 50, 70)).astype(np.float32)
    data, ratio = cvt.compress(vol, 1e-8, device="cpu")
    _, blkoffs, _, _ = ctn.unpack(data)
    assert (blkoffs < 0).any() and ratio < 1.0
    out = cvt.decompress(data, device="cpu").numpy()
    assert rel_rms(out, vol) < 1e-5
    assert rel_rms(ocodec.decompress(data), vol) < 1e-5


def test_container_copy_matches_jax(radial, rng):
    """The numpy copies (container, utils.io) behave as their originals."""
    _, data = radial
    mine, theirs = ctn.unpack(data), jctn.unpack(data)
    assert mine[0].__dict__ == theirs[0].__dict__
    np.testing.assert_array_equal(mine[1], theirs[1])
    assert mine[2] is theirs[2] is None and mine[3] == theirs[3]
    assert io.validate(data).__dict__ == jio.validate(data).__dict__
    for rms, scale in [(0.5, 1e-2), (0.0, 1e-2), (1e-30, 1e-30), (np.inf, 1.0)]:
        assert ctn.compute_glob_mulfac(rms, scale) == jctn.compute_glob_mulfac(rms, scale)
    assert ctn.block_grid(70, 50, 40, 32, 32, 32) == jctn.block_grid(70, 50, 40, 32, 32, 32)
    hdr = ctn.Header(70, 50, 40, 32, 32, 32, np.float32(3.5), False)
    jhdr = jctn.Header(70, 50, 40, 32, 32, 32, np.float32(3.5), False)
    sizes = rng.integers(1, 50, hdr.grid[3])
    raw = rng.random(hdr.grid[3]) < 0.3
    stream = rng.integers(0, 256, int(sizes.sum())).astype(np.uint8)
    np.testing.assert_array_equal(
        ctn.pack_stream(hdr, sizes, raw, stream),
        jctn.pack_stream(jhdr, sizes, raw, stream),
    )


def test_validate_rejects_damage(radial):
    _, data = radial
    with pytest.raises(ValueError):
        cvt.decompress(data[: data.size // 2], device="cpu")
    with pytest.raises(ValueError):
        cvt.decompress(data[:20], device="cpu")


def test_outside_the_slice_raises(radial):
    """Only a block Is_Valid_Block_Size refuses raises (ValueError naming
    it), in compress and in CvxCompress; a geometry the port once refused
    (16^3) now round-trips, and the oracle's 16^3 container decodes."""
    vol, _ = radial
    for block in ((16, 16, 2), (4, 8, 8), (512, 8, 8), (24, 16, 16), (16, 16)):
        with pytest.raises(ValueError, match="Is_Valid_Block_Size"):
            cvt.compress(vol, 1e-2, block=block, device="cpu")
    with pytest.raises(ValueError, match="Is_Valid_Block_Size"):
        cvt.CvxCompress(device="cpu").Compress(1e-2, vol, 16, 16, 3)
    data, _ = cvt.compress(vol, 1e-2, block=(16, 16, 16), device="cpu")
    out = cvt.decompress(data, device="cpu").numpy()
    assert rel_rms(out, ocodec.decompress(data)) < TRANSFORM_TOL
    data16, _ = ocodec.compress(vol, 1e-2, block=(16, 16, 16))
    assert rel_rms(cvt.decompress(data16, device="cpu").numpy(),
                   ocodec.decompress(data16)) < TRANSFORM_TOL


def test_cuda_without_card_raises(radial):
    """device="cuda" raises where there is no card: nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    vol, data = radial
    with pytest.raises(RuntimeError):
        cvt.compress(vol, 1e-2, device="cuda")
    with pytest.raises(RuntimeError):
        cvt.decompress(data, device="cuda")
    from cvxcompress_tpu_torch.ops import _kernels

    with pytest.raises(RuntimeError):
        _kernels.lib()
    with pytest.raises(ValueError):
        _kernels.check_cuda(torch.zeros(4), dtypes=(torch.float32,))


def test_default_device_is_the_card(radial):
    """With no `device`, compress, decompress and CvxCompress run on "cuda";
    without a card that raises: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    vol, data = radial
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cvt.compress(vol, 1e-2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cvt.decompress(data)
    with pytest.raises(RuntimeError):
        cvt.CvxCompress().Compress(1e-2, vol, 32, 32, 32)
    with pytest.raises(RuntimeError):
        cvt.CvxCompress().Decompress(data)
    assert cvt.CvxCompress().device == "cuda"


def test_class_surface_and_native_c_abi(radial):
    """CvxCompress().Compress / .Decompress, and a container from the native
    reference C ABI (cvx_compress) decoding in the port."""
    vol, _ = radial
    codec = cvt.CvxCompress(device="cpu")
    data, ratio = codec.Compress(1e-2, vol, 32, 32, 32)
    out = codec.Decompress(data).numpy()
    assert rel_error_and_snr(vol, out)[0] < 1e-2
    native, _ = rle_host.host_compress(vol, 1e-2)
    ref, _ = jrle_host.host_compress(vol, 1e-2)
    np.testing.assert_array_equal(native, ref)
    mine = cvt.decompress(native, device="cpu").numpy()
    assert rel_rms(mine, rle_host.host_decompress(native)) < TRANSFORM_TOL
