"""ctypes binding of the native host library (native/libcvxhost.so).

The C++ library in `native/` belongs to neither framework: the JAX package
binds it in `cvxcompress_tpu/ops/rle_host.py`, the port binds it here.  It
gives the port its host entropy decoder (`decode_payloads`), the per-chunk
non-zero flags for the sparse upload (`chunk_flags`), the host encoder
(`encode_payloads`, a stage-exact check of the emit kernel) and the
reference-compatible C ABI (`host_compress`, `host_decompress`).

The library is built with `make -C native` at first use; a compiler with
no OpenMP runtime gets the Makefile's flags without -fopenmp (the library
then runs serial).  If it cannot be built or loaded this raises: there is
no fallback decoder.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import tempfile
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_ROOT, "native")
SO_PATH = os.path.join(NATIVE_DIR, "libcvxhost.so")

F32 = np.float32
_VP = ctypes.c_void_p

_lib = None
_lock = threading.Lock()


# The Makefile's flags without -fopenmp: for a compiler that has no OpenMP
# runtime (the source guards every OpenMP call with _OPENMP).
SERIAL_CXXFLAGS = "CXXFLAGS=-O3 -std=c++17 -fPIC -ffp-contract=off -Wall -Wextra"
build_info = {}  # "openmp": whether the library was built with OpenMP


def _build():
    # cross-process lock, the same file the JAX package's binding takes:
    # test workers of both packages may race to build the one .so
    with open(os.path.join(tempfile.gettempdir(), "cvxhost_build.lock"), "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        try:
            if os.path.exists(SO_PATH):
                return
            logs = []
            for extra in ([], [SERIAL_CXXFLAGS]):
                res = subprocess.run(
                    ["make", "-C", NATIVE_DIR, "-s", *extra],
                    capture_output=True, text=True,
                )
                logs.append(res.stdout + res.stderr)
                if res.returncode == 0 and os.path.exists(SO_PATH):
                    build_info["openmp"] = not extra
                    return
        finally:
            fcntl.flock(lf, fcntl.LOCK_UN)
    raise RuntimeError(f"building {SO_PATH} failed:\n" + "\n".join(logs))


def lib():
    """The loaded native library (built on first call); raises on failure."""
    global _lib
    with _lock:
        if _lib is None:
            _build()  # under the build lock: never load a half-written .so
            h = ctypes.CDLL(SO_PATH)
            h.cvx_decode_payloads.restype = ctypes.c_int
            h.cvx_decode_payloads.argtypes = [
                _VP, ctypes.c_int64, _VP, _VP, ctypes.c_float,
                ctypes.c_int64, ctypes.c_int64, _VP,
            ]
            h.cvx_encode_payloads.restype = None
            h.cvx_encode_payloads.argtypes = [
                _VP, _VP, ctypes.c_int64, ctypes.c_int64, _VP, _VP, _VP,
            ]
            h.cvx_chunk_flags.restype = None
            h.cvx_chunk_flags.argtypes = [_VP, ctypes.c_int64, ctypes.c_int64, _VP]
            h.cvx_compress.restype = ctypes.c_float
            h.cvx_compress.argtypes = [
                ctypes.c_float, _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP,
                ctypes.POINTER(ctypes.c_long),
            ]
            h.cvx_decompress_outofplace.restype = ctypes.POINTER(ctypes.c_float)
            h.cvx_decompress_outofplace.argtypes = [
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), _VP, ctypes.c_long,
            ]
            _lib = h
        return _lib


def _p(a):
    return a.ctypes.data


def decode_payloads(payload, blkoffs, glob_mulfac, cells):
    """Decode every block payload (global RMS) -> (nnn, cells) f32.

    Raw-flagged blocks copy their coefficients.  Raises ValueError when any
    block's stream is truncated or overruns the payload area.
    """
    payload = np.ascontiguousarray(payload, dtype=np.uint8)
    blkoffs = np.ascontiguousarray(blkoffs, dtype=np.int64)
    nnn = blkoffs.size
    out = np.empty((nnn, int(cells)), dtype=F32)
    rc = lib().cvx_decode_payloads(
        _p(payload), payload.size, _p(blkoffs), None, float(glob_mulfac),
        nnn, int(cells), _p(out),
    )
    if rc != 0:
        raise ValueError("corrupt container: block stream truncated")
    return out


def encode_payloads(coeffs, mulfac):
    """Encode (nnn, cells) unscaled coefficients at one mulfac.

    Returns (streams, sizes, raw): streams[i] holds block i's payload bytes
    (its coefficient bytes when raw).
    """
    coeffs = np.ascontiguousarray(coeffs, dtype=F32)
    nnn, cells = coeffs.shape
    mulfacs = np.full(nnn, mulfac, dtype=F32)
    stride = 5 * cells + 8
    buf = np.empty((nnn, stride), dtype=np.uint8)
    sizes = np.empty(nnn, dtype=np.int64)
    raw = np.empty(nnn, dtype=np.uint8)
    lib().cvx_encode_payloads(
        _p(coeffs), _p(mulfacs), nnn, cells, _p(buf), _p(sizes), _p(raw)
    )
    return [buf[i, : sizes[i]] for i in range(nnn)], sizes, raw.astype(bool)


def chunk_flags(coeffs, chunk):
    """Per-chunk non-zero flags of a dense f32 coefficient buffer."""
    c = np.ascontiguousarray(coeffs, dtype=F32)
    nchunks = c.size // int(chunk)
    flags = np.empty(nchunks, dtype=np.uint8)
    lib().cvx_chunk_flags(_p(c), nchunks, int(chunk), _p(flags))
    return flags.astype(bool)


def host_compress(vol, scale, block=(32, 32, 32)):
    """Compress through the reference C ABI `cvx_compress` (global RMS)."""
    vol = np.ascontiguousarray(vol, dtype=F32)
    nz, ny, nx = vol.shape
    bx, by, bz = block
    nnn = (-(-nx // bx)) * (-(-ny // by)) * (-(-nz // bz))
    # worst case: every block raw (4*cells) + tables + header + slack
    out = np.zeros(32 + 12 * nnn + nnn * 4 * bx * by * bz + 64, dtype=np.uint8)
    length = ctypes.c_long(0)
    ratio = lib().cvx_compress(
        float(scale), _p(vol), nx, ny, nz, bx, by, bz, _p(out), ctypes.byref(length)
    )
    return out[: length.value].copy(), float(ratio)


def host_decompress(data):
    """Decompress through the reference C ABI `cvx_decompress_outofplace`."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    nx, ny, nz = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    ptr = lib().cvx_decompress_outofplace(
        ctypes.byref(nx), ctypes.byref(ny), ctypes.byref(nz), _p(data), data.size
    )
    if not ptr:
        raise MemoryError("cvx_decompress_outofplace returned NULL")
    try:
        shape = (nz.value, ny.value, nx.value)
        return np.ctypeslib.as_array(ptr, shape=shape).copy()
    finally:
        _libc_free(ptr)


def _libc_free(ptr):
    libc = ctypes.CDLL(None)
    libc.free.argtypes = [_VP]
    libc.free.restype = None
    libc.free(ctypes.cast(ptr, _VP))
