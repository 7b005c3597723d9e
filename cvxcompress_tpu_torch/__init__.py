"""cvxcompress_tpu_torch: the codec in PyTorch with hand-written CUDA kernels.

A port of `cvxcompress_tpu` (JAX/Pallas on a TPU) to PyTorch and CUDA on an
NVIDIA H100 (sm_90a).  It imports torch and numpy, never jax and never the
JAX package.  Every block the reference accepts (8..256 per axis, bz 1
for 2D), the global and the local RMS and raw-fallback blocks; compress on
the device, decompress on the device (entropy parse, emit, inverse) or by
host entropy decode plus the inverse on the device; batched and streamed
codecs (`pipeline`), the device-resident snapshot stack (`snapshots`),
the multi-device layer (`parallel`: z-slab shards over a mesh of devices,
several on one card too, and a multi-process compress on torch.distributed)
and the staged module tests (`module_tests`).  ROADMAP.md lists what is
still to port (the bench).  Everything runs on the CUDA card unless the
caller passes device="cpu".

    compress(vol, scale, block=(32, 32, 32), use_local_rms=False,
             backend="torch" | "native" | "oracle")
        -> (container uint8 ndarray, ratio)
    decompress(container, engine="auto")
        -> (nz, ny, nx) float32 tensor
    CvxCompress  -- class mirroring the reference API surface
    pipeline.compress_stream / decompress_stream / compress_batched /
        decompress_batched / compress_stream_batched /
        decompress_stream_batched
    DeviceSnapshotStack(vol_shape, scale, block).append / get / pop / ...
    parallel.compress.compress(vol, scale, block, mesh=None) -> (container,
        ratio); parallel.compress.decompress(container, mesh=None);
        parallel.multihost.compress(local_slab, scale, block, vol_shape=...)
"""

__version__ = "0.1.0"

from . import container, oracle, parallel, pipeline  # noqa: F401
from .api import CvxCompress, compress, decompress, to_bytes  # noqa: F401
from .snapshots import DeviceSnapshotStack  # noqa: F401
from .utils import io, volumes  # noqa: F401
