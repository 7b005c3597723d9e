"""What the A/B timing scripts share (tools/ab_block128.py, ab_block32.py,
ab_stripe.py, ab_chase_stripe.py, ab_decode.py, variants_stripe.py): the
card's name and power limit, a library built from chosen csrc/ sources (an
earlier checkout's, or a text-substituted copy of this one's) and timing in
turns by CUDA events (the profiler's device time of a kernel is
chip_smoke.py `device_ms`).  Imported by those
scripts, which put the repo root on sys.path first; torch is imported
inside the functions that need it."""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the turns of an A/B comparison: the earlier build first and last
ORDER = ("earlier", "this", "this", "earlier")


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def build_lib(paths, so, signatures):
    """nvcc of the .cu files `paths` into the shared library `so` (printing
    ptxas's register lines), its C functions typed by `signatures` (name ->
    argtypes, each returning int)."""
    from cvxcompress_tpu_torch.ops import _kernels

    os.makedirs(os.path.dirname(so), exist_ok=True)
    r = subprocess.run([_kernels._nvcc(), *_kernels.ARCH_FLAGS, "-std=c++17", "-O3",
                        "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v", "-o", so, *paths],
                       capture_output=True, text=True)
    name = os.path.basename(so)
    for line in (r.stdout + r.stderr).splitlines():
        if "registers" in line or "error" in line:
            print(f"  {name}: {line.strip()[:160]}")
    if r.returncode:
        raise RuntimeError(f"{name}: nvcc failed")
    lib = ctypes.CDLL(so)
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def build_parent(parent, files, name, signatures):
    """The earlier checkout's (root `parent`) csrc/`files` built into
    build/ab_parent/<name>.so."""
    src = os.path.join(parent, "cvxcompress_tpu_torch", "csrc")
    return build_lib([os.path.join(src, f) for f in files],
                     os.path.join(ROOT, "build", "ab_parent", f"{name}.so"), signatures)


def build_variant(name, subs, files, signatures, subdir="ab_variants"):
    """A copy of this checkout's csrc/ under build/<subdir>/<name>/ with
    text substitutions, its `files` built into lib.so there.  `subs` maps a
    file name to [old, new] pairs, each replacing every `old` with `new`
    (["FILE", path] first replaces the whole file with the one at `path`,
    relative to the repo root); other keys are ignored."""
    from cvxcompress_tpu_torch.ops import _kernels

    d = os.path.join(ROOT, "build", subdir, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_kernels.SRC_DIR, d)
    for fname, pairs in subs.items():
        p = os.path.join(d, fname)
        if not os.path.isfile(p):
            continue
        with open(p) as f:
            s = f.read()
        for a, b in pairs:
            if a == "FILE":
                with open(os.path.join(ROOT, b)) as f:
                    s = f.read()
                continue
            if a not in s:
                raise ValueError(f"{name}: {a!r} is not in {fname}")
            s = s.replace(a, b)
        with open(p, "w") as f:
            f.write(s)
    return build_lib([os.path.join(d, f) for f in files], os.path.join(d, "lib.so"),
                     signatures)


def turns(order, run, iters):
    """CUDA-event times (chip_smoke.py `cuda_ms`, `iters` calls) of run(key)
    for each key of `order` in turn, a key possibly twice (ORDER):
    {key: [ms, ...]}."""
    import chip_smoke as cs

    t = {}
    for k in order:
        t.setdefault(k, []).append(cs.cuda_ms(lambda: run(k), iters))
    return t

