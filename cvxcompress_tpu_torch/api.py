"""Public API, shaped by the reference's class CvxCompress (CvxCompress.hxx:19-135).

The PyTorch counterpart of `cvxcompress_tpu/api.py`: every block the
reference accepts (Is_Valid_Block_Size: bx and by powers of two in
[8, 256], bz one too or 1; any other raises ValueError), any volume shape,
with the global RMS or the local RMS (`use_local_rms=True`: each block
quantized with 1/(rms*scale) of its own coefficients, the table in the
container).

Three backends, one container format (the entropy stage is bit-exact
between them):
  - "torch":  the port's codec (ops/codec.py), the default.  Everything
              runs on the CUDA card unless the caller asks for the CPU: a
              torch volume brings its own device, a numpy volume and every
              decompress go to `device`, "cuda" by default ("cpu" runs the
              plain PyTorch versions of the kernels; "cuda" without a card
              raises, nothing falls back).  `engine` picks the decompress
              engine (ops/codec.py `decompress`): "auto", "device" or
              "host".  Decompress returns a tensor on `device`.
  - "native": the multithreaded C++ host codec (native/libcvxhost.so,
              ops/rle_host.py `host_compress`, `host_decompress`).
  - "oracle": the numpy reference-semantics codec (oracle/), the format
              authority.
The host backends take numpy volumes (a tensor is copied to the host) and
return numpy volumes; `device` and `engine` are the torch backend's.
"""

from __future__ import annotations

import glob
import os
import subprocess
import sys

import numpy as np
import torch

from . import container as ctn
from .ops import codec

DEFAULT_BACKEND = "torch"
BACKENDS = ("torch", "native", "oracle")


def _check_backend(backend):
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")


def _host(vol):
    return vol.detach().cpu().numpy() if isinstance(vol, torch.Tensor) else vol


def compress(vol, scale, block=(32, 32, 32), use_local_rms=False, device=None,
             backend=DEFAULT_BACKEND):
    """Compress a (nz, ny, nx) float32 volume -> (container uint8 ndarray, ratio).

    `block` (bx, by, bz) is any block Is_Valid_Block_Size accepts, else
    ValueError.  `use_local_rms` picks the reference's local-RMS mode: one
    mulfac per block, from the RMS of the block's own wavelet coefficients.
    `device` (torch backend) None: the tensor's own device, or "cuda" for
    a numpy volume.
    """
    _check_backend(backend)
    if backend == "native":
        from .ops import rle_host

        return rle_host.host_compress(_host(vol), scale, block=block,
                                      use_local_rms=use_local_rms)
    if backend == "oracle":
        from .oracle import codec as ocodec

        return ocodec.compress(_host(vol), scale, block=block,
                               use_local_rms=use_local_rms)
    return codec.compress(vol, scale, block=block, use_local_rms=use_local_rms,
                          device=device)


def decompress(data, device="cuda", engine="auto", backend=DEFAULT_BACKEND):
    """Decompress a container -> (nz, ny, nx) float32 volume: a tensor on
    `device` (torch backend), a numpy array (native, oracle).  Accepts the
    containers of every backend, of the JAX package and of the reference
    library."""
    _check_backend(backend)
    if backend == "native":
        from .ops import rle_host

        return rle_host.host_decompress(data)
    if backend == "oracle":
        from .oracle import codec as ocodec

        return ocodec.decompress(data)
    return codec.decompress(data, device=device, engine=engine)


def to_bytes(data) -> bytes:
    """Container ndarray -> bytes (for file IO)."""
    return np.asarray(data, dtype=np.uint8).tobytes()


class CvxCompress:
    """Class surface mirroring the reference API (CvxCompress.hxx:19-135).

    The thread-count parameters of the reference overloads have no device
    equivalent and are accepted and ignored.  `backend` as in `compress`;
    under "torch", `device` ("cuda" by default) is where numpy volumes go
    and where Decompress returns its tensor, `engine` the decompress
    engine.  `Compress(scale, vol, bx, by, bz)` takes any block
    Is_Valid_Block_Size accepts (each geometry on its route, ops/codec.py
    `route`).
    """

    @staticmethod
    def Min_BX():
        return ctn.MIN_B

    @staticmethod
    def Max_BX():
        return ctn.MAX_B

    Min_BY = Min_BX
    Max_BY = Max_BX
    Min_BZ = Min_BX
    Max_BZ = Max_BX

    @staticmethod
    def Is_Valid_Block_Size(bx, by, bz):
        return ctn.is_valid_block_size(bx, by, bz)

    def __init__(self, device="cuda", engine="auto", backend=DEFAULT_BACKEND):
        _check_backend(backend)
        self.device = device
        self.engine = engine
        self.backend = backend

    def Compress(self, scale, vol, bx, by, bz, use_local_RMS=False, num_threads=None):
        """Returns (container, ratio).  `use_local_RMS`: one mulfac per block
        from its own coefficients' RMS (CvxCompress.cpp:343-348), else one
        from the volume's."""
        del num_threads
        return compress(vol, scale, block=(bx, by, bz), use_local_rms=use_local_RMS,
                        device=self.device, backend=self.backend)

    def Decompress(self, compressed, num_threads=None):
        """Out-of-place decompress; returns the volume (a tensor under the
        torch backend, else a numpy array)."""
        del num_threads
        return decompress(compressed, device=self.device, engine=self.engine,
                          backend=self.backend)

    def Decompress_Inplace(self, vol, compressed, num_threads=None):
        """Decompress into the caller's (nz, ny, nx) tensor or array.

        Mirrors cvx_decompress_inplace (CvxCompress.hxx:160-167); the shape
        must match the container's header, else ValueError.
        """
        del num_threads
        out = self.Decompress(compressed)
        if tuple(vol.shape) != tuple(out.shape):
            raise ValueError(f"volume shape {tuple(vol.shape)} != container "
                             f"{tuple(out.shape)}")
        if isinstance(vol, torch.Tensor):
            vol.copy_(torch.as_tensor(out))
        else:
            np.copyto(vol, _host(out))
        return vol

    @staticmethod
    def Run_Module_Tests(verbose=False, exhaustive=False, device="cuda"):
        """Run the port's test suite (reference: CvxCompress.hxx:133):
        pytest on the repository's tests/test_torch_*.py; True when every
        test passed.  `exhaustive` then also runs the staged module tests
        with the full 8..256 block sweep, the 2^24 zero run and the 256^3
        round trip (module_tests.py, the reference's exhaustive switch,
        CvxCompress.cpp:695) on `device`, and is True only when they pass
        too.  A checkout without the tests raises FileNotFoundError:
        nothing passes silently.
        """
        tests = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
            __file__))), "tests")
        files = sorted(glob.glob(os.path.join(tests, "test_torch_*.py")))
        if not files:
            raise FileNotFoundError(f"no tests/test_torch_*.py under {tests}")
        args = [sys.executable, "-m", "pytest", *files, "-x",
                "-v" if verbose else "-q"]
        ok = subprocess.call(args) == 0
        if ok and exhaustive:
            from . import module_tests

            ok = not module_tests.run(device, exhaustive=True)
        return ok
