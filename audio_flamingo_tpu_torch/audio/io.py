"""Audio file input of the port: WAV and FLAC decode, resample, ``load_audio``.

As ``audio_flamingo_tpu/audio/io.py``. The native library (``audio/cpp/audioio.cpp`` and
``audio/cpp/flac.cpp``, the port's own copies) is built by one g++ call into the port's
``_build/`` at first use, keyed by a hash of the sources, and bound with ctypes. The numpy
versions here (and ``audio/flac.py``) are its plain references, used by the tests.

Unlike the JAX loader, nothing falls back: a failed build raises with g++'s stderr, and a
native error code raises naming the code (the sources list what each means).
"""

from __future__ import annotations

import ctypes
import io as _io
import os
import wave
from math import gcd

import numpy as np

from audio_flamingo_tpu_torch.ops.kernels import _build

CPP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cpp")
SOURCES = ("audioio.cpp", "flac.cpp")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lib: ctypes.CDLL | None = None


def get_lib() -> ctypes.CDLL:
    """ctypes handle to the native library, built on first use; raises if it cannot be."""
    global _lib
    if _lib is None:
        path, _, _ = _build.compile_library(
            "g++", GXX_FLAGS, [os.path.join(CPP_DIR, s) for s in SOURCES], "libaf_audioio")
        lib = ctypes.CDLL(path)
        out_args = [ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                    ctypes.POINTER(ctypes.c_uint64)]
        lib.af_decode_wav.restype = ctypes.c_int
        lib.af_decode_wav.argtypes = ([ctypes.c_char_p, ctypes.c_uint64] + out_args
                                      + [ctypes.POINTER(ctypes.c_int)])
        lib.af_decode_flac.restype = ctypes.c_int
        lib.af_decode_flac.argtypes = lib.af_decode_wav.argtypes
        lib.af_resample.restype = ctypes.c_int
        lib.af_resample.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_uint64,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_double] + out_args
        lib.af_free.restype = None
        lib.af_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


# ------------------------------------------------------------------- numpy reference

def decode_wav_np(data: bytes) -> tuple[np.ndarray, int]:
    """Reference WAV decode via the stdlib: mono float32 + sample rate."""
    with wave.open(_io.BytesIO(data)) as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        x = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        x = np.where(x & 0x800000, x | ~0xFFFFFF, x).astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    return x.reshape(-1, ch).mean(axis=1).astype(np.float32), sr


def resample_np(x: np.ndarray, sr_in: int, sr_out: int, zeros: int = 16,
                beta: float = 8.555) -> np.ndarray:
    """Kaiser-windowed-sinc polyphase resampler, numpy reference of the native one."""
    if sr_in == sr_out:
        return x.astype(np.float32)
    g = gcd(sr_in, sr_out)
    L, M = sr_out // g, sr_in // g
    fc = 0.5 if L >= M else 0.5 * L / M
    half_width = zeros / (2 * fc)
    n_out = (len(x) * L) // M
    t_out = np.arange(n_out, dtype=np.float64) * (M / L)
    lo = np.ceil(t_out - half_width).astype(np.int64)
    hi = np.floor(t_out + half_width).astype(np.int64)
    width = int((hi - lo).max()) + 1
    k = lo[:, None] + np.arange(width)[None, :]
    t = k - t_out[:, None]
    valid = (np.abs(t) <= half_width) & (k >= 0) & (k < len(x))
    arg = np.clip(t / half_width, -1, 1)
    win = np.i0(beta * np.sqrt(np.maximum(1 - arg ** 2, 0))) / np.i0(beta)
    s = np.where(t == 0, 2 * fc, np.sin(2 * np.pi * fc * t) / (np.pi * np.where(t == 0, 1, t)))
    taps = np.where(valid, s * win, 0.0)
    xk = np.where(valid, x[np.clip(k, 0, len(x) - 1)], 0.0)
    return (taps * xk).sum(axis=1).astype(np.float32)


# ----------------------------------------------------------------------- native path

def _take(lib: ctypes.CDLL, out, n: ctypes.c_uint64) -> np.ndarray:
    """Copy a malloc'd float buffer from the library into numpy and free it."""
    arr = np.ctypeslib.as_array(out, shape=(n.value,)).copy() if n.value else \
        np.zeros(0, np.float32)
    lib.af_free(out)
    return arr


def _decode(fn_name: str, data: bytes) -> tuple[np.ndarray, int]:
    lib = get_lib()
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_uint64()
    sr = ctypes.c_int()
    rc = getattr(lib, fn_name)(data, len(data), ctypes.byref(out), ctypes.byref(n),
                               ctypes.byref(sr))
    if rc != 0:
        raise ValueError(f"{fn_name} failed with code {rc} (audio/cpp sources list the codes)")
    return _take(lib, out, n), sr.value


def decode_wav(data: bytes) -> tuple[np.ndarray, int]:
    """RIFF/WAVE bytes -> (mono float32, sample rate), natively."""
    return _decode("af_decode_wav", data)


def decode_flac(data: bytes) -> tuple[np.ndarray, int]:
    """Native-FLAC bytes -> (mono float32, sample rate), natively."""
    return _decode("af_decode_flac", data)


def resample(x: np.ndarray, sr_in: int, sr_out: int, zeros: int = 16,
             beta: float = 8.555) -> np.ndarray:
    """Resample mono float32 from sr_in to sr_out, natively (see resample_np)."""
    lib = get_lib()
    x = np.ascontiguousarray(x, np.float32)
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_uint64()
    rc = lib.af_resample(x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x),
                         sr_in, sr_out, zeros, beta, ctypes.byref(out), ctypes.byref(n))
    if rc != 0:
        raise ValueError(f"af_resample failed with code {rc} (audio/cpp sources list the codes)")
    return _take(lib, out, n)


def decode_audio(data: bytes) -> tuple[np.ndarray, int]:
    """Container dispatch by magic: native FLAC, else RIFF/WAVE -> (mono f32, sr)."""
    if data[:4] == b"fLaC":
        return decode_flac(data)
    return decode_wav(data)


def load_audio(path: str, target_sr: int = 16_000) -> np.ndarray:
    """Decode an audio file (WAV or FLAC) to mono float32 at target_sr."""
    with open(path, "rb") as f:
        data = f.read()
    wav, sr = decode_audio(data)
    return resample(wav, sr, target_sr)
