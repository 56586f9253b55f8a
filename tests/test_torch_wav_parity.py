"""Raw WAV bytes to logits and greedy tokens, the port against the JAX package at a tiny
config set up as tests/test_e2e_wav_parity.py sets it (1 s "windows" of 100 mel frames,
50 encoder positions, 25 audio tokens per window): load_audio -> processor (injected
frontend, no window buckets) -> af3.logits and generate, at f32."""

import dataclasses
import io
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.api import AudioFlamingo as JAudioFlamingo
from audio_flamingo_tpu.audio import io as jio
from audio_flamingo_tpu.audio.mel import WhisperMelFrontend as JWhisperMelFrontend
from audio_flamingo_tpu.config import AF3Config as JAF3Config
from audio_flamingo_tpu.config import MelConfig as JMelConfig
from audio_flamingo_tpu.config import Qwen2Config as JQwen2Config
from audio_flamingo_tpu.config import WhisperEncoderConfig as JWhisperEncoderConfig
from audio_flamingo_tpu.models import af3 as jaf3
from audio_flamingo_tpu.ops import sampling as js
from audio_flamingo_tpu.runtime import generate as jgen
from audio_flamingo_tpu.runtime.processor import AF3Processor as JAF3Processor
from audio_flamingo_tpu.train.data import bucket_tokens as j_bucket_tokens
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.api import AudioFlamingo
from audio_flamingo_tpu_torch.audio import io as tio
from audio_flamingo_tpu_torch.audio.mel import WhisperMelFrontend
from audio_flamingo_tpu_torch.io.convert import params_from_jax
from audio_flamingo_tpu_torch.models import af3
from audio_flamingo_tpu_torch.runtime.processor import AF3Processor
from audio_flamingo_tpu_torch.runtime.tokenizer import BBPETokenizer

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

CHUNK_S = 1
JCFG = JAF3Config(
    encoder=JWhisperEncoderConfig(num_mel_bins=16, d_model=32, num_layers=2, num_heads=4,
                                  ffn_dim=64, max_source_positions=50, pool_stride=2),
    lm=JQwen2Config(vocab_size=512, hidden_size=48, intermediate_size=96, num_layers=2,
                    num_heads=4, num_kv_heads=2, rope_theta=1e6, tie_word_embeddings=False),
    mel=JMelConfig(num_mel_bins=16, chunk_length_s=CHUNK_S),
)
PROMPT = "What do you hear?"


def _wav_bytes() -> bytes:
    """2.6 s of 16-bit stereo at 48 kHz: a tone per channel plus noise."""
    rng = np.random.default_rng(0)
    t = np.arange(int(2.6 * 48_000)) / 48_000
    x = np.stack([0.3 * np.sin(2 * np.pi * 440 * t), 0.2 * np.sin(2 * np.pi * 660 * t)], 1)
    x = x + 0.05 * rng.standard_normal(x.shape)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(48_000)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def _port_cfg(j):
    pick = lambda cls, obj: cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})
    return C.AF3Config(encoder=pick(C.WhisperEncoderConfig, j.encoder),
                       lm=pick(C.Qwen2Config, j.lm), audio_token_id=j.audio_token_id)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    path = tmp_path_factory.mktemp("wav") / "clip.wav"
    path.write_bytes(_wav_bytes())
    jm = JAudioFlamingo.from_random(JCFG, compute_dtype=jnp.float32)
    jm.processor = JAF3Processor(
        tokenizer=jm.processor.tokenizer, cfg=jm.cfg,
        frontend=JWhisperMelFrontend(JMelConfig(num_mel_bins=16, chunk_length_s=CHUNK_S)),
        use_buckets=False)
    cfg = _port_cfg(jm.cfg)
    tok = BBPETokenizer(jm.processor.tokenizer.vocab, jm.processor.tokenizer.merges)
    tm = AudioFlamingo.from_state_dict(cfg, params_from_jax(jax.tree.map(np.asarray, jm.params),
                                                            cfg),
                                       tok, compute_dtype=torch.float32, device="cpu")
    tm = dataclasses.replace(tm, processor=AF3Processor(
        tokenizer=tok, cfg=cfg, use_buckets=False, frontend=WhisperMelFrontend(
            C.MelConfig(num_mel_bins=16, chunk_length_s=CHUNK_S), use_pallas=True,
            device="cpu")))
    return str(path), jm, tm


def test_wav_to_logits_within_1e3(setup):
    path, jm, tm = setup
    jwav, twav = jio.load_audio(path), tio.load_audio(path)
    np.testing.assert_allclose(twav, jwav, atol=1e-5, rtol=0)
    msgs = [{"role": "user", "content": f"<sound>{PROMPT}"}]
    jb, tb = jm.processor(messages=msgs, audios=[jwav]), tm.processor(messages=msgs, audios=[twav])
    np.testing.assert_array_equal(tb["ids"], jb["ids"])
    assert tb["mels"].shape == (1, 3, 100, 16)           # 2.6 s -> 3 one-second windows
    want = np.asarray(jaf3.logits(jm.params, jm.cfg, jnp.asarray(jb["ids"]),
                                  jnp.asarray(jb["mels"])))
    got = af3.logits(tm.model, tm.cfg, torch.from_numpy(tb["ids"]).long(), tb["mels"]).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-3, np.abs(got - want).max()


def test_wav_to_greedy_tokens_exact(setup):
    path, jm, tm = setup
    jwav = jio.load_audio(path)
    tm.generate(sound=tio.load_audio(path), prompt=PROMPT, max_new_tokens=8)
    got = tm.last_output.tokens[0, : int(tm.last_output.lengths[0])].tolist()
    batch = jm.processor(messages=[{"role": "user", "content": f"<sound>{PROMPT}"}],
                         audios=[jwav])
    ids = jnp.asarray(batch["ids"])
    t = ids.shape[1]
    ids = jnp.concatenate([ids, jnp.full((1, j_bucket_tokens(t) - t), jm.eos_token_id,
                                         jnp.int32)], 1)
    tokens, lengths = jgen.generate(jm.params, jm.cfg, ids, jnp.asarray(batch["mels"]),
                                    max_new_tokens=8, eos_token_id=jm.eos_token_id,
                                    sampling=js.SamplingParams(), rng=jax.random.PRNGKey(0),
                                    compute_dtype=jnp.float32,
                                    prompt_len=jnp.asarray(t, jnp.int32))
    assert got == np.asarray(tokens)[0][: int(lengths[0])].tolist()
