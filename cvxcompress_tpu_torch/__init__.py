"""cvxcompress_tpu_torch: the codec in PyTorch with hand-written CUDA kernels.

A port of `cvxcompress_tpu` (JAX/Pallas on a TPU) to PyTorch and CUDA on an
NVIDIA H100 (sm_90a).  It imports torch and numpy, never jax and never the
JAX package.  Ported so far: 32^3 blocks with the global RMS, compress on
the device and decompress by host entropy decode plus the inverse on the
device (ROADMAP.md lists what is still to port).

    compress(vol, scale, block=(32, 32, 32), device="cuda")
        -> (container uint8 ndarray, ratio)
    decompress(container, device="cuda") -> (nz, ny, nx) float32 tensor
    CvxCompress  -- class mirroring the reference API surface
"""

__version__ = "0.1.0"

from . import container  # noqa: F401
from .api import CvxCompress, compress, decompress  # noqa: F401
