"""Synthetic test volumes and raw-volume file IO.

Covers the reference's input fixtures: the radial-sinusoid synthesizer of
Read_Raw_Volume (Read_Raw_Volume.cpp:28-42 — since 2024-10-27 the reference
ignores its filename argument and always synthesizes), the sinusoidal
x-slice volumes of the CI integration test
(Test_With_Generated_Input.cpp:45-51), the bit-pattern volumes of the block
copy module tests (CvxCompress.cpp:616-619), and raw float32 file IO
(gen_empty_volume.cpp:10-46, Test_Compression.cpp file loop).

A numpy copy of `cvxcompress_tpu/utils/volumes.py`, held equal to it by
tests/test_torch_api.py.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32


def radial_volume(nz=51, ny=101, nx=151, noise=True, seed=7):
    """sin(r/10) + noise/100 around the volume center (Read_Raw_Volume.cpp)."""
    z0, y0, x0 = (nz - 1) // 2, (ny - 1) // 2, (nx - 1) // 2
    zz = (np.arange(nz) - z0)[:, None, None]
    yy = (np.arange(ny) - y0)[None, :, None]
    xx = (np.arange(nx) - x0)[None, None, :]
    r = np.sqrt(zz * zz + yy * yy + xx * xx)
    vol = np.sin(r / 10.0)
    if noise:
        vol = vol + np.random.default_rng(seed).random(vol.shape) / 100.0
    return vol.astype(F32)


def sinusoid_volume(nz, ny, nx, periods=10):
    """Constant-x-slice sinusoid: vol[z] = sin(z*pi*periods/nz).

    The CI integration input (Test_With_Generated_Input.cpp:45-51; its
    (slow, mid, fast) dims map to our (nz, ny, nx)).
    """
    z = np.sin(np.arange(nz) * np.pi * periods / nz).astype(F32)
    return np.broadcast_to(z[:, None, None], (nz, ny, nx)).copy()


def pattern_volume(nz, ny, nx, seed=0):
    """Index bit-pattern volume for exact layout tests.

    value bits = cell index + seed, bit-exact comparable after gather or
    scatter (Fill_Volume_With_Pattern, CvxCompress.cpp:616-619).
    """
    idx = np.arange(nz * ny * nx, dtype=np.uint32) + np.uint32(seed)
    return idx.view(F32).reshape(nz, ny, nx).copy()


def write_raw(path, vol):
    """Write a volume as raw little-endian float32 (x fastest)."""
    np.ascontiguousarray(vol, dtype=F32).tofile(path)


def read_raw(path, nz, ny, nx):
    """Read a raw float32 volume written by write_raw / gen_empty_volume."""
    vol = np.fromfile(path, dtype=F32, count=nz * ny * nx)
    if vol.size != nz * ny * nx:
        raise ValueError(
            f"{path}: expected {nz * ny * nx} floats, found {vol.size}"
        )
    return vol.reshape(nz, ny, nx)


def empty_volume(nz, ny, nx):
    """All-zero volume (gen_empty_volume.cpp:10-46)."""
    return np.zeros((nz, ny, nx), dtype=F32)
