"""Global RMS and the quantization contract (`cvxcompress_tpu/ops/quant.py`).

Global RMS (CvxCompress.cpp:73-117): float64 accumulation of the sum of
squares, sqrt, cast to float32, then `container.compute_glob_mulfac`.

Quantization (Run_Length_Encode_Slow.cpp:203-207): i = trunc(mulfac * c)
toward zero with x86 cvttps semantics — NaN and values outside the int32
range map to INT32_MIN.  A plain float -> int cast saturates or is
undefined out of range, so the in-range mask is explicit here and in the
CUDA kernels (`cvxcompress_tpu/ops/tokenize_pallas.py:125-129`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import container as ctn

INT32_MIN = -2147483648


def global_rms_host(vol):
    """Reference-exact global RMS of a host volume (float64 accumulation)."""
    v = np.asarray(vol, dtype=np.float32)
    acc = np.sum(np.square(v, dtype=np.float64))
    return np.float32(np.sqrt(acc / v.size))


def global_mulfac(vol, scale):
    """mulfac = 1/(rms*scale) of a (nz, ny, nx) f32 tensor or array.

    Host data takes the reference's exact numpy reduction.  A CUDA tensor
    is reduced on the card, still in float64, so only the summation order
    differs from the host's (a last-bit difference in the f64 sum, which
    the f32 cast almost always absorbs) and the volume never leaves the
    card.
    """
    if isinstance(vol, torch.Tensor) and vol.device.type != "cpu":
        acc = torch.sum(torch.square(vol.to(torch.float64))).item()
        rms = np.float32(math.sqrt(acc / vol.numel()))
    else:
        host = vol.numpy() if isinstance(vol, torch.Tensor) else vol
        rms = global_rms_host(host)
    return ctn.compute_glob_mulfac(rms, scale)


def quantize(fv):
    """cvttps(fv): int32 truncation toward zero, INT32_MIN when out of range."""
    in_range = (fv >= -2147483648.0) & (fv < 2147483648.0)
    tr = torch.trunc(torch.where(in_range, fv, torch.zeros_like(fv)))
    return torch.where(
        in_range, tr.to(torch.int32), torch.full_like(fv, INT32_MIN, dtype=torch.int32)
    )
