"""Build the port's native libraries at first use and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own nvcc process, all started together, and
the objects are linked into one shared library with a plain C interface (no PyTorch
headers); the headers they share (``csrc/*.cuh``) come in through them. The build takes
about as long as its slowest source. Host-only C++ (the audio decoders,
``audio/io.py``) goes through ``compile_library`` with g++ the same way. Libraries land in
``audio_flamingo_tpu_torch/_build/`` (ignored by git) under a name keyed by a hash of the
sources, the headers beside them and the flags, so an unchanged tree does not rebuild and
a changed header does. The compiler's stderr (nvcc's ptxas report of registers, stack and
spills) is kept beside each library as ``<name>.log``, so a cached library still has its
report. A build writes temporary names and renames them into place, so concurrent builders
never load a half-written file. A failed build raises with the compiler's stderr.
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
build_log: str = ""                  # nvcc's stderr of the library (ptxas register/smem report)


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin, PATH)")


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path(stem: str, srcs: list[str], flags) -> str:
    """The library's path, keyed by the flags, ``srcs`` and every header beside them."""
    h = hashlib.sha256(" ".join(flags).encode())
    headers = sorted({hdr for src in srcs
                      for hdr in glob.glob(os.path.join(os.path.dirname(src), "*.cuh"))})
    for path in [*srcs, *headers]:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def compile_library(compiler: str, flags, srcs: list[str], stem: str):
    """Compile ``srcs`` into ``_build/<stem>-<hash>.so`` unless it and its log exist.

    Returns (path, seconds of this call's compile or None, the compiler's stderr of the
    build that made the library)."""
    out = library_path(stem, srcs, flags)
    log_path = f"{out}.log"
    if os.path.exists(out) and os.path.exists(log_path):
        with open(log_path) as f:
            return out, None, f.read()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    t0 = time.perf_counter()
    # each source compiled by its own process, all at once, then one link
    objs = [f"{tmp}.{i}.o" for i in range(len(srcs))]
    compile_flags = [f for f in flags if f != "-shared"]
    try:
        stderr = _run([[compiler, *compile_flags, "-c", "-o", obj, src]
                       for obj, src in zip(objs, srcs)])
        stderr += _run([[compiler, *flags, "-o", tmp, *objs]])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    seconds = time.perf_counter() - t0
    with open(f"{tmp}.log", "w") as f:
        f.write(stderr)
    os.replace(f"{tmp}.log", log_path)
    os.replace(tmp, out)
    return out, seconds, stderr


def _run(cmds: list) -> str:
    """Run the commands at once; their stderr in order, or raise with a failed one's."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    errs = [proc.communicate()[1] for proc in procs]
    for cmd, proc, err in zip(cmds, procs, errs):
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(cmd[0])} failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{err}")
    return "".join(errs)


def build() -> str:
    """Compile csrc/*.cu into the hashed kernel library unless it exists; return its path."""
    global build_seconds, build_log
    out, seconds, build_log = compile_library(find_nvcc(), NVCC_FLAGS, sources(),
                                              "libaf_kernels")
    if seconds is not None:
        build_seconds = seconds
    return out


def load_library(path: str | None = None) -> ctypes.CDLL:
    """Load the kernel library once (built if needed) and declare every entry point's C
    signature. ``path`` loads another build of the same sources in its place (one made
    with other flags by ``compile_library``)."""
    global _lib
    if _lib is None or path is not None:
        lib = ctypes.CDLL(path or build())
        i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
        fn = lib.af_flash_attention_fwd
        fn.restype = i32
        fn.argtypes = ([ptr] * 5 + [i32] * 7 + [i64] * 12
                       + [ctypes.c_float, i32, i32, ptr])
        fn = lib.af_flash_attention_bwd
        fn.restype = i32
        fn.argtypes = ([ptr] * 9 + [i32] * 7 + [i64] * 21
                       + [ctypes.c_float, i32, i32, ptr])
        fn = lib.af_flash_scores
        fn.restype = i32
        fn.argtypes = [ptr] * 4 + [i32] * 6 + [i64] * 6 + [ptr]
        fn = lib.af_log_mel_power
        fn.restype = i32
        fn.argtypes = [ptr] * 5 + [i32] * 6 + [ptr]
        fn = lib.af_log_mel_clamp
        fn.restype = i32
        fn.argtypes = [ptr, ptr] + [i32] * 3 + [ptr]
        fn = lib.af_w4a16_matmul
        fn.restype = i32
        fn.argtypes = [ptr] * 5 + [i32] * 6 + [ptr]
        fn = lib.af_w8a16_matmul_group
        fn.restype = i32
        fn.argtypes = [ptr, ptr, i32] + [ptr] * 3 + [i32] * 7 + [ptr]
        fn = lib.af_w8a16_matmul_nk
        fn.restype = i32
        fn.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
        fn = lib.af_paged_attention
        fn.restype = i32
        fn.argtypes = [ptr] * 12 + [i32] * 11 + [i64, ctypes.c_float, ptr]
        fn = lib.af_paged_attention_occupancy
        fn.restype = i32
        fn.argtypes = [i32] * 5 + [ptr]
        fn = lib.af_flash_attention_a8
        fn.restype = i32
        fn.argtypes = [ptr] * 5 + [i32] * 12 + [i64] * 6 + [ptr]
        fn = lib.af_fa8_prelude
        fn.restype = i32
        fn.argtypes = [ptr] * 12 + [i32] * 10 + [i64] * 9 + [ctypes.c_float, ptr]
        fn = lib.af_enc_ln_qkv
        fn.restype = i32
        fn.argtypes = [ptr] * 7 + [i32] * 5 + [ctypes.c_float, ptr]
        fn = lib.af_enc_out_ln
        fn.restype = i32
        fn.argtypes = [ptr] * 10 + [i32] * 3 + [ctypes.c_float, ptr]
        fn = lib.af_enc_mlp
        fn.restype = i32
        fn.argtypes = [ptr] * 11 + [i32] * 5 + [ptr]
        for name in ("af_w4_suffix_a", "af_w4_suffix_b"):
            fn = getattr(lib, name)
            fn.restype = i32
            fn.argtypes = [ptr] * 11 + [i32] * 10 + [ctypes.c_float, ptr]
        fn = lib.af_w4_suffix_blocks
        fn.restype = i32
        fn.argtypes = [i32] * 4 + [ptr]
        _lib = lib
    return _lib
