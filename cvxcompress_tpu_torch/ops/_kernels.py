"""Build, load and launch the hand-written CUDA kernels of csrc/.

The sources are compiled at first use with nvcc for sm_90a (Hopper), one
nvcc per source, all started together, and linked into one shared library
with a plain C interface, loaded with ctypes: every pointer and the stream
pass as `c_void_p`.  The library lands in
`build/kernels/` beside the package (listed in .gitignore), named by a hash
of the sources so an edited kernel is never served from a stale build.

Each kernel has a plain-integer launch counter, `launches[name]`, raised
(under a lock: launches come from several threads) only where the kernel
is launched, so a run can show which kernels its main path went through.  A failed build, a missing nvcc or card, and any launch
that returns a `cudaError_t` other than 0 raise; nothing falls back.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_VP = ctypes.c_void_p
# each launcher's C parameters, the stream last (`launch` appends it): a
# parameter left out here would pass as a C int, truncating the pointer
_SIGNATURES = {
    "cvx_fused_encode": [
        _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        _VP, _VP, _VP, _VP, _VP, _VP, _VP,
    ],
    "cvx_fused_encode_local": [
        _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        _VP, _VP, _VP, _VP, _VP, _VP, _VP,
    ],
    "cvx_fused_inverse": [
        _VP, ctypes.c_int64, _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP, _VP,
    ],
    "cvx_plan_layout": [
        _VP, ctypes.c_int64, ctypes.c_int64, _VP, ctypes.c_int64, ctypes.c_int64, _VP,
    ],
    "cvx_decode_maps": [_VP, ctypes.c_int64, ctypes.c_int, _VP, _VP, _VP],
    "cvx_decode_chase": [
        _VP, _VP, _VP, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _VP, _VP, _VP, _VP,
    ],
    "cvx_decode_emit": [
        _VP, _VP, _VP, _VP, _VP, ctypes.c_int64, _VP, ctypes.c_int,
        ctypes.c_int64, _VP, _VP,
    ],
    "cvx_block_fwd_z": [_VP, ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP, _VP],
    "cvx_block_encode_xy": [
        _VP, ctypes.c_float, ctypes.c_int64, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
    ],
    "cvx_block_casc_local": [_VP, ctypes.c_int64, _VP, _VP],
    "cvx_block_scale_tok": [
        _VP, _VP, ctypes.c_float, ctypes.c_int64, _VP, _VP, _VP, _VP, _VP, _VP,
    ],
    "cvx_block_emit": [
        _VP, _VP, _VP, _VP, _VP, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _VP, _VP,
    ],
    "cvx_stripe_fused_encode": [
        _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, _VP, _VP, _VP, _VP, _VP, _VP,
    ],
    "cvx_stripe_fused_encode_local": [
        _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, _VP, _VP, _VP, _VP, _VP, _VP,
    ],
    "cvx_stripe_fused_inverse": [
        _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _VP, _VP,
    ],
    "cvx_tokenize_stripe": [
        _VP, _VP, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _VP, _VP,
        _VP, _VP, _VP,
    ],
    "cvx_block_fwd_xz": [_VP, ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP, _VP],
    "cvx_block_encode_y": [
        _VP, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int64, _VP, _VP,
        _VP, _VP, _VP, _VP, _VP,
    ],
    "cvx_patch_extract": [
        _VP, _VP, _VP, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _VP,
        _VP, _VP, _VP, _VP,
    ],
    "cvx_block_emit_rows": [
        _VP, _VP, _VP, ctypes.c_int64, _VP, _VP, _VP, ctypes.c_int, _VP, _VP,
    ],
    "cvx_tokenize_compact": [
        _VP, _VP, ctypes.c_int64, ctypes.c_int, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
        _VP, _VP,
    ],
    "cvx_block_inv_xy": [_VP, ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP, _VP],
    "cvx_block_inv_z": [ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP, _VP],
    "cvx_plane_cascade_fwd": [
        _VP, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP, ctypes.c_int, _VP,
        _VP, _VP,
    ],
    "cvx_plane_cascade_inv": [
        _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _VP, ctypes.c_int, _VP, _VP, _VP,
    ],
}

# one counter per launched kernel (the 128^3 encode and inverse are two
# launches each, so a run shows every pass; the local-RMS encodes have
# counters of their own)
launches = {name[len("cvx_"):]: 0 for name in _SIGNATURES}
build_info = {}  # library path, build seconds, nvcc's -Xptxas -v report

_lib = None
_lock = threading.Lock()


def reset_counts():
    with _lock:
        for k in launches:
            launches[k] = 0


def _sources():
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu"))) + sorted(
        glob.glob(os.path.join(SRC_DIR, "*.cuh"))
    )


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc); cannot build the kernels")
    path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found at {path}")
    return path


def build():
    """Compile csrc/*.cu into the hashed library; returns its path."""
    srcs = _sources()
    h = hashlib.sha256()
    for p in srcs:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + b"\0" + f.read())
    h.update(" ".join(ARCH_FLAGS).encode())
    so = os.path.join(BUILD_DIR, f"libcvxtorch_{h.hexdigest()[:16]}.so")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        try:
            if os.path.exists(so):
                build_info.update(path=so, seconds=0.0, log="(cached)")
                return so
            tmp = f"{so}.{os.getpid()}.tmp"
            objdir = f"{tmp}.d"
            os.makedirs(objdir, exist_ok=True)
            nvcc = _nvcc()
            common = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
            t0 = time.perf_counter()
            cus = [p for p in srcs if p.endswith(".cu")]
            objs = [os.path.join(objdir, os.path.basename(p) + ".o") for p in cus]
            procs = [
                subprocess.Popen(
                    [*common, "-Xptxas", "-v", "-c", "-o", o, p],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                )
                for p, o in zip(cus, objs)
            ]
            logs = [pr.communicate()[0] for pr in procs]
            log = "".join(f"== {os.path.basename(p)}\n{lg}" for p, lg in zip(cus, logs))
            if any(pr.returncode != 0 for pr in procs):
                raise RuntimeError(f"nvcc failed:\n{log}")
            res = subprocess.run([*common, "-shared", "-o", tmp, *objs],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc link failed ({res.returncode}):\n{res.stdout}{res.stderr}"
                )
            os.replace(tmp, so)
            for o in objs:
                os.remove(o)
            os.rmdir(objdir)
            build_info.update(
                path=so, seconds=time.perf_counter() - t0, log=log,
            )
        finally:
            fcntl.flock(lf, fcntl.LOCK_UN)
    return so


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            if not torch.cuda.is_available():
                raise RuntimeError("CUDA kernels requested but no CUDA device")
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.cvx_cuda_error_string.argtypes = [ctypes.c_int]
            handle.cvx_cuda_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def launch(name, *args):
    """Launch kernel `name` on the current stream; raise on a CUDA error."""
    lb = lib()
    args = args + (torch.cuda.current_stream().cuda_stream,)
    rc = getattr(lb, f"cvx_{name}")(*args)
    if rc != 0:
        msg = lb.cvx_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: cudaError {rc} ({msg})")
    with _lock:  # the stream pipelines launch from several threads
        launches[name] += 1


def check_cuda(*tensors, dtypes):
    """Raise unless every tensor is a contiguous CUDA tensor of its dtype."""
    for t, dt in zip(tensors, dtypes):
        if t.device.type != "cuda" or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"kernel input must be a contiguous CUDA {dt} tensor, got "
                f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )


def check_aligned(*tensors):
    """Raise unless every tensor's data starts on a 16-byte boundary (the
    128^3 kernels move 512-byte rows as float4s, `fused_inverse` its chunk
    rows by 16-byte asynchronous copies, the decode kernels read the stream
    as aligned words)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("kernel input must start on a 16-byte boundary (a view "
                             f"at storage offset {t.storage_offset()})")
