"""Build the port's native libraries at first use and load them with ctypes.

Every ``csrc/*.cu`` file is compiled together by one nvcc call into one shared library
with a plain C interface (no PyTorch headers, so the build takes seconds). Host-only C++
(the audio decoders, ``audio/io.py``) goes through ``compile_library`` with g++ the same
way. Libraries land in ``audio_flamingo_tpu_torch/_build/`` (ignored by git) under a name
keyed by a hash of the sources and flags, so an unchanged tree does not rebuild. A build
writes a temporary name and renames it into place, so concurrent builders never load a
half-written file. A failed build raises with the compiler's stderr.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None   # wall time of this process's nvcc run, if any
build_log: str = ""                  # nvcc's stderr (ptxas register/smem report)


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin, PATH)")


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path(stem: str, srcs: list[str], flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in srcs:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def compile_library(compiler: str, flags, srcs: list[str], stem: str):
    """Compile ``srcs`` into ``_build/<stem>-<hash>.so`` unless it exists.

    Returns (path, seconds of this call's compile or None, compiler stderr)."""
    out = library_path(stem, srcs, flags)
    if os.path.exists(out):
        return out, None, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = [compiler, *flags, "-o", tmp, *srcs]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(compiler)} failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return out, seconds, proc.stderr


def build() -> str:
    """Compile csrc/*.cu into the hashed kernel library unless it exists; return its path."""
    global build_seconds, build_log
    out, seconds, log = compile_library(find_nvcc(), NVCC_FLAGS, sources(), "libaf_kernels")
    if seconds is not None:
        build_seconds, build_log = seconds, log
    return out


def load_library() -> ctypes.CDLL:
    """Build if needed, load once, and declare every entry point's C signature."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
        fn = lib.af_flash_attention_fwd
        fn.restype = i32
        fn.argtypes = ([ptr] * 5 + [i32] * 7 + [i64] * 12
                       + [ctypes.c_float, i32, i32, ptr])
        fn = lib.af_log_mel_power
        fn.restype = i32
        fn.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
        fn = lib.af_log_mel_clamp
        fn.restype = i32
        fn.argtypes = [ptr, i32, i64, ptr]
        fn = lib.af_w4a16_matmul
        fn.restype = i32
        fn.argtypes = [ptr] * 5 + [i32] * 6 + [ptr]
        for name in ("af_w4_suffix_a", "af_w4_suffix_b"):
            fn = getattr(lib, name)
            fn.restype = i32
            fn.argtypes = [ptr] * 11 + [i32] * 9 + [ctypes.c_float, ptr]
        _lib = lib
    return _lib
