"""Port's audio file input against the JAX package's: numpy references equal on the same
bytes, the native library equal to the numpy references, ``load_audio`` on WAV and FLAC,
the library built in the port's own tree, and no silent fallback on a corrupt file."""

import functools
import io
import os
import wave

import numpy as np
import pytest

from audio_flamingo_tpu.audio import io as jio
from audio_flamingo_tpu.audio.flac_ref import decode_flac_np as j_decode_flac_np
from audio_flamingo_tpu.audio.flac_ref import encode_flac
from audio_flamingo_tpu_torch.audio import io as tio
from audio_flamingo_tpu_torch.audio.flac import decode_flac_np
from audio_flamingo_tpu_torch.ops.kernels import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _make_wav(x: np.ndarray, sr: int, width: int = 2) -> bytes:
    """x: [n] or [n, channels] in [-1, 1] -> PCM WAV bytes of the given sample width."""
    x = np.asarray(x, np.float64)
    x = x[:, None] if x.ndim == 1 else x
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(x.shape[1])
        w.setsampwidth(width)
        w.setframerate(sr)
        if width == 1:
            data = (np.clip(x, -1, 1) * 127 + 128).astype(np.uint8).tobytes()
        elif width == 2:
            data = (np.clip(x, -1, 1) * 32767).astype("<i2").tobytes()
        elif width == 3:
            v = (np.clip(x, -1, 1) * 8388607).astype(np.int32).reshape(-1)
            data = np.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF], 1).astype(
                np.uint8).tobytes()
        else:
            data = (np.clip(x, -1, 1) * 2147483647).astype("<i4").tobytes()
        w.writeframes(data)
    return buf.getvalue()


FLAC_STREAMS = ["mono16", "independent", "left_side", "right_side", "mid_side", "bps8",
                "bps24", "partitions", "constant"]


@functools.lru_cache(maxsize=None)
def _flac(name: str) -> bytes:
    """The FLAC streams tests/test_audio_io.py covers: mono 16-bit, the four stereo modes,
    8- and 24-bit depths, Rice partitions, a constant subframe."""
    rng = np.random.default_rng(FLAC_STREAMS.index(name))
    if name == "mono16":
        t = np.arange(10_000) / 16_000
        wav = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.normal(size=t.shape)
        return encode_flac(np.clip(wav * 32767, -32768, 32767).astype(np.int64), 16_000,
                           bps=16, block_size=4096)
    if name.endswith("side") or name == "independent":
        left = np.clip(rng.normal(size=5000) * 8000, -32768, 32767).astype(np.int64)
        right = np.clip(left * 0.8 + rng.normal(size=5000) * 800, -32768, 32767).astype(np.int64)
        return encode_flac(np.stack([left, right], 1), 44_100, bps=16, block_size=1024,
                           stereo_mode=name)
    if name.startswith("bps"):
        bps = int(name[3:])
        lim = (1 << (bps - 1)) - 1
        s = np.clip(rng.normal(size=3000) * lim * 0.3, -lim, lim).astype(np.int64)
        return encode_flac(s, 48_000, bps=bps, block_size=512)
    if name == "partitions":
        parts = np.concatenate([rng.normal(size=2048) * 100, rng.normal(size=2048) * 20000])
        return encode_flac(np.clip(parts, -32768, 32767).astype(np.int64), 16_000, bps=16,
                           block_size=4096, partition_order=2)
    return encode_flac(np.full(2000, -123, np.int64), 8000, bps=16, block_size=512)


@pytest.mark.parametrize("width,channels", [(1, 1), (2, 1), (2, 2), (3, 2), (4, 1)])
def test_wav_decode_matches_jax_and_native(width, channels):
    rng = np.random.default_rng(width * 10 + channels)
    x = rng.normal(size=(4000, channels)) * 0.3
    data = _make_wav(x, 16_000, width)
    ref, sr = tio.decode_wav_np(data)
    jref, jsr = jio.decode_wav_np(data)
    np.testing.assert_array_equal(ref, jref)
    got, nsr = tio.decode_wav(data)
    assert sr == jsr == nsr == 16_000 and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("sr_in,sr_out", [(48_000, 16_000), (44_100, 16_000), (22_050, 16_000),
                                          (8_000, 48_000), (16_000, 16_000)])
def test_resample_matches_jax_reference_and_native(sr_in, sr_out):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=sr_in // 2) * 0.2).astype(np.float32)
    ref = tio.resample_np(x, sr_in, sr_out)
    np.testing.assert_array_equal(ref, jio.resample_np(x, sr_in, sr_out))
    got = tio.resample(x, sr_in, sr_out)
    assert got.shape == ref.shape == (len(x) * sr_out // sr_in,)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", FLAC_STREAMS)
def test_flac_decode_matches_jax_and_native(name):
    data = _flac(name)
    ref, sr = decode_flac_np(data)
    jref, jsr = j_decode_flac_np(data)
    np.testing.assert_array_equal(ref, jref)
    got, nsr = tio.decode_flac(data)
    assert sr == jsr == nsr
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind", ["wav_stereo_48k", "flac_48k"])
def test_load_audio(tmp_path, kind):
    sr_in = 48_000
    t = np.arange(sr_in) / sr_in
    x = 0.5 * np.sin(2 * np.pi * 440 * t)
    if kind == "flac_48k":
        data = encode_flac((x * 32767).astype(np.int64), sr_in, bps=16)
        decoded, _ = decode_flac_np(data)
    else:
        data = _make_wav(np.stack([x, 0.5 * x], 1), sr_in)
        decoded, _ = tio.decode_wav_np(data)
    path = tmp_path / f"tone.{kind[:4]}"
    path.write_bytes(data)
    out = tio.load_audio(str(path), target_sr=16_000)
    assert out.shape == (16_000,) and out.dtype == np.float32
    np.testing.assert_allclose(out, tio.resample_np(decoded, sr_in, 16_000), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out, jio.load_audio(str(path), target_sr=16_000), atol=1e-5,
                               rtol=0)
    spec = np.abs(np.fft.rfft(out * np.hanning(len(out))))
    assert abs(np.fft.rfftfreq(len(out), 1 / 16_000)[spec.argmax()] - 440.0) < 2.0


def test_library_is_built_in_the_port_tree():
    lib = tio.get_lib()
    port_build = os.path.join(REPO, "audio_flamingo_tpu_torch", "_build")
    assert os.path.dirname(lib._name) == port_build == _build.BUILD_DIR
    assert os.path.basename(lib._name).startswith("libaf_audioio-")
    assert not lib._name.startswith(os.path.join(REPO, "audio_flamingo_tpu") + os.sep)


@pytest.mark.parametrize("kind", ["wav_header", "wav_bits", "flac_info", "flac_frame"])
def test_corrupt_file_raises(tmp_path, kind):
    """A file the native decoder refuses raises; nothing decodes it in numpy instead."""
    if kind == "wav_header":
        data = b"RIFF\x00\x00\x00\x00WAVEjunk" + bytes(40)
    elif kind == "wav_bits":                       # 12-bit integer PCM
        data = bytearray(_make_wav(np.zeros(100), 16_000, 2))
        data[34:36] = (12).to_bytes(2, "little")
        data = bytes(data)
    elif kind == "flac_info":                      # STREAMINFO with sample rate 0
        data = bytearray(_flac("mono16"))
        data[18:21] = bytes(3)
        data = bytes(data)
    else:                                          # reserved subframe type in frame 1
        data = bytearray(_flac("mono16"))
        assert data[42:50].hex() == "fff87008000fff2a"   # its 8-byte frame header
        data[50] = 0x04                                  # subframe type 2 is reserved
        data = bytes(data)
    path = tmp_path / "bad.bin"
    path.write_bytes(data)
    with pytest.raises(ValueError, match="failed with code -"):
        tio.load_audio(str(path))
