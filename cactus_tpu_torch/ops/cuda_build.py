"""Build the hand-written CUDA kernels under csrc/ at first use.

Each ``csrc/<name>.cu`` compiles with nvcc for sm_90a into its own
shared library with a plain C interface,
``_build/lib<name>_<hash>.so`` (the hash covers the source, the
csrc/*.cuh headers and the flags, so an edited source or header
rebuilds), and is loaded with ctypes.  Nothing
here runs at import: the CPU tests import every module, and a CPU-only
host has no nvcc.  `build()` starts one nvcc per source, all at once, so
a cold build costs the slowest file, not the sum.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

SOURCES = ("banded", "pairhmm", "pairhmm5", "poa", "poa_cluster")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the 5-state pair-HMM keeps each float32 multiply and add separately
# rounded, as its plain PyTorch version does, instead of contracting them
# into FMAs (the 3-state kernels, which rescale once per 8 rows, follow
# their plain version only to rounding anyway)
EXTRA_FLAGS = {"pairhmm5": ("-fmad=false",)}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_BOUND: set[str] = set()

# launches of each kernel, counted by its wrapper where it launches it;
# the *_wide names are the routes of rows past a kernel's widest narrow
# launch (ops/pairhmm_cuda.py, ops/pairhmm5_cuda.py, ops/poa_cuda.py)
KERNELS = ("banded_dp", "banded_traceback", "pairhmm_fwd", "pairhmm_bwd",
           "pairhmm5_fwd", "pairhmm5_bwd", "poa_linear", "poa_affine",
           "poa_chain", "pairhmm_fwd_wide", "pairhmm_bwd_wide",
           "pairhmm5_fwd_wide", "pairhmm5_bwd_wide", "poa_linear_wide",
           "poa_wide")
LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "of cactus_tpu_torch build only where the CUDA "
                           "toolkit is installed")
    return found


def _target(name: str) -> tuple[str, str, list[str]]:
    """The source, the library it builds into and nvcc's flags.  The
    library's name hashes the source, every csrc/*.cuh header (which a
    source may include) and the flags, so editing any of them rebuilds."""
    src = os.path.join(CSRC, f"{name}.cu")
    flags = [*NVCC_FLAGS, *EXTRA_FLAGS.get(name, ())]
    digest = hashlib.sha256()
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as fh:
            digest.update(os.path.basename(path).encode() + b"\0"
                          + fh.read())
    digest.update(" ".join(flags).encode())
    so = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")
    return src, so, flags


def build(names=SOURCES) -> dict[str, str]:
    """Compile (in parallel) and load every named source not yet loaded.

    Returns {name: nvcc/ptxas output} for the sources compiled by this
    call; raises with nvcc's message when a compile fails."""
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        jobs = {}
        for name in todo:
            src, so, flags = _target(name)
            if os.path.exists(so):
                jobs[name] = (so, None, None)
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.tmp{os.getpid()}"
            cmd = [nvcc(), *flags, "-o", tmp, src]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs[name] = (so, tmp, proc)
        logs = {}
        for name, (so, tmp, proc) in jobs.items():
            if proc is not None:
                out, _ = proc.communicate(timeout=900)
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n"
                                       f"{out}")
                os.replace(tmp, so)
                logs[name] = out
            _LIBS[name] = ctypes.CDLL(so)
        return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
    if lib is None:
        build([name])
        with _LOCK:
            lib = _LIBS[name]
    return lib


def bind(name: str, signatures: dict) -> ctypes.CDLL:
    """The library of csrc/<name>.cu with each C function's argtypes set:
    signatures maps function name -> argtypes (every function returns the
    int cudaError_t of its launch)."""
    lib = library(name)
    with _LOCK:
        if name not in _BOUND:
            lib.cuda_error_string.restype = ctypes.c_char_p
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            for fn, argtypes in signatures.items():
                getattr(lib, fn).restype = ctypes.c_int
                getattr(lib, fn).argtypes = argtypes
            _BOUND.add(name)
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def check_tensor(x, name: str, dtype, shape, device) -> None:
    """Raise unless x lies on `device` with this dtype and shape and is
    contiguous (what a kernel's raw pointer assumes)."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def stream(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on `device`, as a C pointer."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def count_launch(name: str) -> None:
    """Add one to LAUNCHES[name] under the lock: the progressive driver
    runs ancestor steps on several threads."""
    with _LOCK:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    with _LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def launches() -> dict[str, int]:
    """A snapshot of every kernel's launch count."""
    with _LOCK:
        return dict(LAUNCHES)
