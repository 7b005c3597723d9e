"""Public API, shaped by the reference's class CvxCompress (CvxCompress.hxx:19-135).

The PyTorch counterpart of `cvxcompress_tpu/api.py`: every block the
reference accepts (Is_Valid_Block_Size: bx and by powers of two in
[8, 256], bz one too or 1; any other raises ValueError), any volume shape,
with the global RMS or the local RMS (`use_local_rms=True`: each block
quantized with 1/(rms*scale) of its own coefficients, the table in the
container).  Everything runs on the CUDA card unless the caller asks for
the CPU: a torch volume brings its own device, a numpy volume and every
decompress go to `device`, "cuda" by default ("cpu" runs the plain PyTorch
versions of the kernels; "cuda" without a card raises, nothing falls back).
`engine` picks the decompress engine (ops/codec.py `decompress`): "auto",
"device" or "host".
"""

from __future__ import annotations

import numpy as np
import torch

from . import container as ctn
from .ops import codec


def compress(vol, scale, block=(32, 32, 32), use_local_rms=False, device=None):
    """Compress a (nz, ny, nx) float32 volume -> (container uint8 ndarray, ratio).

    `block` (bx, by, bz) is any block Is_Valid_Block_Size accepts, else
    ValueError.  `device` None: the tensor's own device, or "cuda" for a
    numpy volume.
    `use_local_rms` picks the reference's local-RMS mode: one mulfac per
    block, from the RMS of the block's own wavelet coefficients.
    """
    return codec.compress(vol, scale, block=block, use_local_rms=use_local_rms,
                          device=device)


def decompress(data, device="cuda", engine="auto"):
    """Decompress a container -> (nz, ny, nx) float32 tensor on `device`."""
    return codec.decompress(data, device=device, engine=engine)


class CvxCompress:
    """Class surface mirroring the reference API (CvxCompress.hxx:19-135).

    The thread-count parameters of the reference overloads have no device
    equivalent and are accepted and ignored.  `device` ("cuda" by default)
    is where numpy volumes go and where Decompress returns its tensor.
    `Compress(scale, vol, bx, by, bz)` takes any block Is_Valid_Block_Size
    accepts (each geometry on its route, ops/codec.py `route`).
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

    def __init__(self, device="cuda", engine="auto"):
        self.device = device
        self.engine = engine

    def Compress(self, scale, vol, bx, by, bz, use_local_RMS=False, num_threads=None):
        """Returns (container, ratio).  `use_local_RMS`: one mulfac per block
        from its own coefficients' RMS (CvxCompress.cpp:343-348), else one
        from the volume's."""
        del num_threads
        return compress(vol, scale, block=(bx, by, bz),
                        use_local_rms=use_local_RMS, device=self.device)

    def Decompress(self, compressed, num_threads=None):
        """Out-of-place decompress; returns the volume as a tensor."""
        del num_threads
        return decompress(compressed, device=self.device, engine=self.engine)

    def Decompress_Inplace(self, vol, compressed, num_threads=None):
        """Decompress into the caller's (nz, ny, nx) tensor or array.

        Mirrors cvx_decompress_inplace (CvxCompress.hxx:160-167); the shape
        must match the container's header, else ValueError.
        """
        del num_threads
        out = decompress(compressed, device=self.device, engine=self.engine)
        if tuple(vol.shape) != tuple(out.shape):
            raise ValueError(f"volume shape {tuple(vol.shape)} != container "
                             f"{tuple(out.shape)}")
        if isinstance(vol, torch.Tensor):
            vol.copy_(out)
        else:
            np.copyto(vol, out.cpu().numpy())
        return vol
