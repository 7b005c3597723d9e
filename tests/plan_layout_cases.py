"""Containers for the decode plan's layout on the device
(ops/entropy_decode.py `device_plan`, `plan_layout`), shared by
the CPU tests (tests/test_torch_plan_layout.py) and the card's
(tests/test_torch_cuda.py): each compressed on the CPU by the port, small.
No jax."""

import numpy as np

import cvxcompress_tpu_torch as cvt
from cvxcompress_tpu_torch import container as ctn


def radial(nz, ny, nx, seed=7):
    """A radial sinusoid with U(0, 1) / 100 noise (Read_Raw_Volume.cpp:28-42,
    tests/conftest.py `make_radial_volume`)."""
    zz, yy, xx = np.meshgrid(np.arange(nz) - (nz - 1) // 2, np.arange(ny) - (ny - 1) // 2,
                             np.arange(nx) - (nx - 1) // 2, indexing="ij")
    vol = np.sin(np.sqrt(zz * zz + yy * yy + xx * xx) / 10.0)
    vol = vol + np.random.default_rng(seed).random(vol.shape) / 100.0
    return vol.astype(np.float32)


def reorder_payload(data, seed):
    """The same container with its block payloads in a shuffled order (as
    the reference's OpenMP threads complete them, CvxCompress.cpp:370-374)."""
    hdr, blkoffs, _, pbase = ctn.unpack(data)
    offs = blkoffs & ~ctn.RAW_FLAG
    order = np.argsort(offs, kind="stable")
    ends = np.empty_like(offs)
    ends[order[:-1]] = offs[order[1:]]
    ends[order[-1]] = data.size - pbase - ctn.SLACK_BYTES
    perm = np.random.default_rng(seed).permutation(offs.size)
    payload = data[pbase:]
    parts, new = [], np.empty_like(offs)
    pos = 0
    for b in perm:
        parts.append(payload[offs[b]:ends[b]])
        new[b] = pos
        pos += ends[b] - offs[b]
    new = np.where(blkoffs < 0, new | ctn.RAW_FLAG, new)
    out = np.concatenate([data[:pbase], *parts, np.zeros(ctn.SLACK_BYTES, np.uint8)])
    out[32: 32 + 8 * offs.size] = new.view(np.uint8)
    return out


def with_raw_blocks():
    """16^3 blocks over a z-sinusoid whose first two blocks hold N(0, 1)
    noise: at scale 1e-7 their tokens outgrow their raw bytes."""
    z = np.sin(np.arange(32) * np.pi * 3 / 32).astype(np.float32)
    v = np.broadcast_to(z[:, None, None], (32, 48, 64)).copy()
    v[:16, :16, :32] = np.random.default_rng(21).standard_normal((16, 16, 32))
    return cvt.compress(v, 1e-7, block=(16, 16, 16), device="cpu")[0]


# name -> container; each a case of the layout's tests
CASES = {
    "b32": lambda: cvt.compress(radial(40, 50, 70), 1e-2, device="cpu")[0],
    "b64": lambda: cvt.compress(radial(64, 64, 128), 1e-2, block=(64, 64, 64),
                                device="cpu")[0],
    "b32_local": lambda: cvt.compress(radial(40, 50, 70), 1e-2, use_local_rms=True,
                                      device="cpu")[0],
    "raw": with_raw_blocks,
    "permuted": lambda: reorder_payload(
        cvt.compress(radial(40, 50, 70), 1e-2, device="cpu")[0], seed=1),
    "one_block": lambda: cvt.compress(radial(32, 32, 32), 1e-2, device="cpu")[0],
}


def degenerate(data):
    """`data` with its first block's payload moved to the payload's end:
    an empty span, so the spans are degenerate."""
    _, _, _, pbase = ctn.unpack(data)
    data = data.copy()
    data[32: 40].view(np.int64)[0] = data.size - pbase
    return data
