"""Build, load and count the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process per
source, all started together), linked into one shared library with a plain
C interface, and loaded with ``ctypes``. The build happens at first use,
from the sources in the checkout, into ``_build/`` beside this file (listed
in ``.gitignore``); the library's file name carries a hash of the sources
and flags, so an edited source is never served by a stale build. A file
lock in ``_build/`` makes the processes of one machine (the ranks of a
data-parallel run) build once: the others wait and load that build.

Each C entry launches on the stream it is given, allocates nothing, and
returns ``cudaGetLastError()``; :func:`check` raises on a nonzero code.
``launches`` counts, per kernel name, the launches the wrappers made since
:func:`reset_launches`; ``act_launches`` counts the GN+GELU forward
launches among them by (kernel name, activation code: 0 none, 1 erf GELU,
2 tanh GELU); ``route_launches`` the GN+GELU backward's calls by
(``"gn1_gelu_bwd"``, route: ``"ticket"`` or ``"three"``).
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from collections import Counter
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I, I64, F32, F64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                       ctypes.c_float, ctypes.c_double)
# C entry -> argument types (pointers and the stream as c_void_p)
SIGNATURES = {
    # b, n, bf16, out[6]
    "gn1_gelu_plan": [I, I64, I, P],
    # x, gamma, beta, y, stats, partials, b, c, hw, eps, act (0 none, 1
    # GELU erf, 2 GELU tanh), bf16, then the plan (grid, samples per round,
    # CTAs per sample, slice, rounds, vec), stream
    "gn1_gelu_fwd": [P] * 6 + [I, I, I64, F32, I, I] + [I] * 6 + [P],
    # x, gamma, beta, y, stats, partials, b, c, hw, eps, act, bf16, chunk,
    # chunks, vec, stream
    "gn1_gelu_fwd_stream": [P] * 6 + [I, I, I64, F32, I, I, I, I, I] + [P],
    # bf16, vec, out[2] (resident CTAs of the backward kernel, L2 bytes)
    "gn1_bwd_resident": [I, I, P],
    # x, dy, gamma, beta, stats, ws, coef, ctr, dx, dgamma, dbeta, b, c, hw,
    # act, bf16, vec, then the plan (planes per item, items per sample,
    # warp per plane, L2 hints, grid), stream
    "gn1_gelu_bwd": [P] * 11 + [I, I, I64] + [I] * 8 + [P],
    # x, dy, gamma, beta, stats, ws, coef, dx, dgamma, dbeta, b, c, hw, act,
    # bf16, load4, stream
    "gn1_gelu_bwd_three": [P] * 10 + [I, I, I64, I, I, I] + [P],
    # x, w_packed, film, film_mode, c2, s2, c1, s1, ic2, is2, ic1, is1,
    # xr, xi, yr, yi, ur, ui, out, b, ci, co, n1, n2, m1, m2, stream
    "spectral_dft2d_fwd": [P, P, P, I] + [P] * 8 + [P] * 7
                          + [I] * 7 + [P],
    # x, w_packed, film, film_mode, c2, s2, c1, s1, ic2, is2, ic1, is1,
    # ty, te, ta, tb, pr, pi, xr, xi, yr, yi, ur, ui, out, b, ci, co, n1, n2,
    # m1, m2, bf16, stream
    "spectral_dft2d_fwd_large": [P, P, P, I] + [P] * 12 + [P] * 9
                                + [I] * 8 + [P],
    # dy, w_packed, film, film_mode, ur, ui, scale, dfilm, c2, s2, c1, s1,
    # ic2, is2, ic1, is1, gr, gi, hr, hi, dx, b, ci, co, n1, n2, m1, m2,
    # stream
    "spectral_dft2d_bwd": [P, P, P, I] + [P] * 4 + [P] * 8 + [P] * 5
                          + [I] * 7 + [P],
    # dy, w_packed, film, film_mode, ur, ui, scale, dfilm, c2, s2, c1, s1,
    # ic2, is2, ic1, is1, ty, te, ta, tb, pr, pi, gr, gi, hr, hi, dx, b, ci,
    # co, n1, n2, m1, m2, bf16, stream
    "spectral_dft2d_bwd_large": [P, P, P, I] + [P] * 4 + [P] * 12 + [P] * 7
                                + [I] * 8 + [P],
    # xr, xi, gr, gi, scale, dw1, dw2, b, ci, co, m1, m2, stream
    "spectral_dw2d": [P] * 7 + [I] * 5 + [P],
    # the split samples of spatial parallelism (csrc/gn1_gelu.cu):
    # x, sums, partials, b, c, hw, bf16, chunk, chunks, vec, stream
    "gn1_split_sums": [P] * 3 + [I, I, I64, I, I, I, I] + [P],
    # x, gamma, beta, y, sums, stats, b, c, hw, count, eps, act, bf16,
    # chunk, chunks, vec, stream
    "gn1_split_apply": [P] * 6 + [I, I, I64, F64, F32] + [I] * 5 + [P],
    # x, dy, gamma, beta, stats, ws, coef, dgamma, dbeta, b, c, hw, count,
    # act, bf16, vec, stream
    "gn1_split_bwd_sums": [P] * 9 + [I, I, I64, F64, I, I, I] + [P],
    # x, dy, gamma, beta, stats, coef, dx, b, c, hw, act, bf16, vec, stream
    "gn1_split_bwd_apply": [P] * 7 + [I, I, I64, I, I, I] + [P],
    # the row-split stages of spatial parallelism (csrc/spectral_dft2d.cu):
    # x, c2, s2, c1, s1, ty, te, pr, pi, xr, xi, b, c, n1, n2, m1, m2, bf16,
    # resident, stream
    "spectral_split_dft": [P] * 11 + [I] * 8 + [P],
    # xr, xi, w_packed, film, film_mode, ur, ui, scale, dfilm, yr, yi, b,
    # c_in, c_out, m1, m2, adjoint, stream
    "spectral_split_mix": [P, P, P, P, I] + [P] * 6 + [I] * 6 + [P],
    # yr, yi, ic2, is2, ic1, is1, ta, tb, out, b, c, n1, n2, m1, m2, scale,
    # bf16, resident, stream
    "spectral_split_inv": [P] * 9 + [I] * 6 + [F32, I, I] + [P],
}

launches = Counter()
act_launches = Counter()
route_launches = Counter()
_lib = None


def reset_launches():
    launches.clear()
    act_launches.clear()
    route_launches.clear()


def nvcc_path():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def _digest(sources):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build():
    """Compile ``csrc/`` into one shared library; return its path. The
    per-source ``ptxas`` reports go to ``_build/<source>.log``."""
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    so = BUILD_DIR / f"libnps_kernels_{_digest(sources + headers)}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():   # another process may have built it meanwhile
            _compile(sources, so)
    return so


def _compile(sources, so):
    """nvcc every source into an object (all at once), then link ``so``."""
    nvcc = nvcc_path()
    jobs = []
    for src in sources:
        obj = BUILD_DIR / f"{src.stem}.o"
        log = open(BUILD_DIR / f"{src.stem}.log", "w")
        jobs.append((src, log, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, log, proc in jobs:
        proc.wait()
        log.close()
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        logs = "\n".join((BUILD_DIR / f"{Path(n).stem}.log").read_text()
                         for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    tmp = so.with_suffix(f".tmp{os.getpid()}")
    subprocess.run([nvcc, "-shared", *NVCC_FLAGS[:2],
                    *(str(BUILD_DIR / f"{s.stem}.o") for s in sources),
                    "-o", str(tmp)], check=True, capture_output=True)
    os.replace(tmp, so)


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc, name):
    """Raise if a C entry reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_ptr(device):
    return torch.cuda.current_stream(device).cuda_stream
