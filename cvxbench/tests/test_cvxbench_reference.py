"""The benchmark's reference is the format: its vectorized grammar equals the
frozen oracle's token by token, and its containers and decodes equal the
port's CPU codec and the native library's parity codec, for both traffic
mixes at 32^3 and 64^3 on small volumes."""

import numpy as np
import pytest
import torch

from cvxbench.harness.generator import Generator
from cvxbench.harness.spec import load_benchmark, traffic_path
from cvxbench.reference import codec as rc
from cvxbench.reference import rle

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", range(12))
def test_vectorized_grammar_is_the_oracle(seed):
    """Every token class (bytes, shorts, int24s, floats, the group fast
    paths, runs of every length, NaN) byte-equal to `rle.encode`, and the
    dequantized cells equal to `rle.decode`."""
    rng = np.random.default_rng(seed)
    n, cells = 3, 512
    c = (rng.standard_normal((n, cells)) * 10.0 ** rng.integers(-3, 8)).astype(np.float32)
    c[rng.random((n, cells)) < rng.random()] = 0
    c[0, 5], c[1, 7], c[2, 100:400] = np.nan, 3e12, 0
    mf = np.float32(rng.uniform(0.5, 3))
    fv, iv = rc.quantize(float(mf), torch.from_numpy(c))
    sizes, stream = rc.encode(fv, iv)
    want = [rle.encode(mf, c[b]) for b in range(n)]
    assert sizes.tolist() == [len(w) for w in want]
    assert stream.numpy().tobytes() == b"".join(want)
    got = rc.dequantize(fv, iv, float(mf)).numpy()
    for b in range(n):
        vals, _ = rle.decode(mf, want[b] + bytes(8), cells)
        assert np.array_equal(vals, got[b], equal_nan=True)


def _volume(mix, shape, i, seed=2**31 + 77):
    with open(traffic_path(mix)) as f:
        import json

        traffic = json.load(f)
    return Generator(traffic, shape, seed, "cpu").snapshot(i)


CASES = [("rtm-sinusoid", (64, 96, 64), (32, 32, 32)),
         ("rtm-radial", (64, 96, 64), (32, 32, 32)),
         ("rtm-radial", (40, 50, 70), (32, 32, 32)),
         ("rtm-sinusoid", (64, 128, 64), (64, 64, 64)),
         ("rtm-radial", (64, 128, 64), (64, 64, 64)),
         ("rtm-radial", (70, 64, 72), (64, 64, 64))]


@pytest.mark.parametrize("mix,shape,block", CASES)
def test_reference_is_the_ports_cpu_codec(mix, shape, block):
    """Container byte-equal to `cvxcompress_tpu_torch.compress(...,
    device="cpu")`, and the reference's decode bit-equal to the port's
    CPU decompress of it, on snapshots 0 and 3 of the mix."""
    import cvxcompress_tpu_torch as cvx

    codec = rc.Codec(shape, block, 1e-2)
    for i in (0, 3):
        vol = _volume(mix, shape, i)
        want, want_vol = codec.compress(vol)
        got, _ = cvx.compress(vol, 1e-2, block=block, device="cpu")
        assert np.array_equal(got, want)
        dec = cvx.decompress(got, device="cpu")
        assert torch.equal(dec.view(torch.int32), want_vol.view(torch.int32))


@pytest.mark.parametrize("mix,shape,block", CASES[1::2])
def test_reference_is_native_parity(mix, shape, block):
    """A second witness: the native host library's parity codec gives the
    same container and decodes it to the same volume."""
    from cvxcompress_tpu_torch.ops import rle_host

    vol = _volume(mix, shape, 5)
    want, want_vol = rc.Codec(shape, block, 1e-2).compress(vol)
    got, _ = rle_host.host_compress_parity(vol.numpy(), 1e-2, block=block)
    assert np.array_equal(got, want)
    dec = rle_host.host_decompress_parity(got)
    assert np.array_equal(dec.view(np.int32), want_vol.numpy().view(np.int32))


def test_reference_raw_blocks_and_local_rms():
    """A block of noise at a tiny scale goes raw (its tokens would be
    floats, 5 B a cell); under the local RMS the
    table and the container equal the port's CPU codec."""
    import cvxcompress_tpu_torch as cvx

    shape, block = (32, 32, 64), (32, 32, 32)
    vol = _volume("rtm-radial", shape, 1)
    vol[:, :, 32:] = torch.from_numpy(
        np.random.default_rng(0).standard_normal((32, 32, 32)).astype(np.float32))
    want, want_vol = rc.Codec(shape, block, 1e-8).compress(vol)
    got, _ = cvx.compress(vol, 1e-8, block=block, device="cpu")
    assert np.array_equal(got, want)
    assert (np.frombuffer(want[32:48].tobytes(), np.int64) < 0).any()  # a raw block
    dec = cvx.decompress(got, device="cpu")
    assert torch.equal(dec.view(torch.int32), want_vol.view(torch.int32))
    want, _ = rc.Codec(shape, block, 1e-2, use_local_rms=True).compress(vol)
    got, _ = cvx.compress(vol, 1e-2, block=block, use_local_rms=True, device="cpu")
    assert np.array_equal(got, want)


def test_the_benchmark_runs_only_known_configs():
    """Every configuration of BENCHMARK.json is one the reference codec
    takes (a valid block over its volume)."""
    import json

    from cvxbench.harness.spec import ROOT

    for c in load_benchmark()["configs"]:
        with open(ROOT / c["file"]) as f:
            cfg = json.load(f)
        rc.Codec(cfg["shape"], cfg["block"], cfg["scale"], cfg["use_local_rms"])
