"""Public API, shaped by the reference's class CvxCompress (CvxCompress.hxx:19-135).

The PyTorch counterpart of `cvxcompress_tpu/api.py` for the ported slice:
32^3 blocks with the global RMS.  `device` is explicit: a torch volume
brings its own, a numpy volume goes where the caller says ("cpu" runs the
plain PyTorch versions of the kernels, "cuda" the CUDA kernels; "cuda"
without a card raises).
"""

from __future__ import annotations

from .ops import codec


def compress(vol, scale, block=(32, 32, 32), use_local_rms=False, device=None):
    """Compress a (nz, ny, nx) float32 volume -> (container uint8 ndarray, ratio)."""
    return codec.compress(vol, scale, block=block, use_local_rms=use_local_rms,
                          device=device)


def decompress(data, device="cpu"):
    """Decompress a container -> (nz, ny, nx) float32 tensor on `device`."""
    return codec.decompress(data, device=device)


class CvxCompress:
    """Class surface mirroring the reference API (CvxCompress.hxx:19-135).

    The thread-count parameters of the reference overloads have no device
    equivalent and are accepted and ignored.
    """

    def __init__(self, device="cpu"):
        self.device = device

    def Compress(self, scale, vol, bx, by, bz, use_local_RMS=False, num_threads=None):
        """Returns (container, ratio)."""
        del num_threads
        return compress(vol, scale, block=(bx, by, bz),
                        use_local_rms=use_local_RMS, device=self.device)

    def Decompress(self, compressed, num_threads=None):
        """Out-of-place decompress; returns the volume as a tensor."""
        del num_threads
        return decompress(compressed, device=self.device)
