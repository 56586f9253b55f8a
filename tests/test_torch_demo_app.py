"""The port's demo server (serve/demo.py): JAX's five demo tests (tests/test_demo_app.py:
the page, a mic-PCM chat, a WAV-file chat and reset, a text-only chat, a bad upload
answering 400) on the port's tiny random model, an answer equal to JAX's DemoServer on
the same weights (crossed through io/convert), the lock holding one generate at a time,
and a failing generate answering 500 instead of being swallowed."""

import base64
import dataclasses
import json
import struct
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.api import AudioFlamingo as JAudioFlamingo
from audio_flamingo_tpu.serve.demo import DemoServer as JDemoServer
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.api import AudioFlamingo
from audio_flamingo_tpu_torch.io.convert import params_from_jax
from audio_flamingo_tpu_torch.runtime.tokenizer import BBPETokenizer
from audio_flamingo_tpu_torch.serve import DemoServer

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)


def _wav_bytes(wav: np.ndarray, sr: int = 16_000) -> bytes:
    pcm = (np.clip(wav, -1, 1) * 32767).astype("<i2").tobytes()
    hdr = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(pcm), b"WAVE",
                      b"fmt ", 16, 1, 1, sr, sr * 2, 2, 16, b"data", len(pcm))
    return hdr + pcm


@pytest.fixture(scope="module")
def server():
    model = AudioFlamingo.from_random(device="cpu")
    srv = DemoServer(model, port=0, max_new_tokens=8)
    srv.start_background()
    yield srv
    srv.shutdown()


def _post(srv, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}",
                                 data=json.dumps(payload).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_index_page(server):
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/", timeout=30) as r:
        body = r.read().decode()
    assert "Audio Flamingo" in body and "/api/chat" in body


def test_chat_with_mic_pcm(server):
    t = np.arange(16_000) / 16_000
    pcm = (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    resp = _post(server, "/api/chat",
                 {"prompt": "What do you hear?",
                  "pcm_b64": base64.b64encode(pcm.tobytes()).decode()})
    assert isinstance(resp["text"], str)
    assert len(server.model.history) == 2          # user + assistant turns


def test_chat_with_wav_file_and_reset(server):
    t = np.arange(8000) / 16_000
    wav = (0.2 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    resp = _post(server, "/api/chat",
                 {"prompt": "Describe.",
                  "file_b64": base64.b64encode(_wav_bytes(wav)).decode()})
    assert isinstance(resp["text"], str)
    assert _post(server, "/api/reset", {})["ok"]
    assert server.model.history == []


def test_text_only_chat(server):
    resp = _post(server, "/api/chat", {"prompt": "Hello there."})
    assert isinstance(resp["text"], str)


def test_bad_audio_reports_error(server):
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(server, "/api/chat",
              {"prompt": "x", "file_b64": base64.b64encode(b"nope").decode()})
    assert exc.value.code == 400
    assert "error" in json.loads(exc.value.read())


def _lively_pair():
    """JAX's tiny random AF3 with its LM's linears x 3 (so greedy ids vary) and the port's
    model on the same weights."""
    jm = JAudioFlamingo.from_random(compute_dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jm.params)
    layers = params["lm"]["layers"]
    for name in ("q", "k", "v", "o"):
        layers[name]["w"] = layers[name]["w"] * 3.0
    layers["mlp"] = {k: v * 3.0 for k, v in layers["mlp"].items()}
    jm = dataclasses.replace(jm, params=jax.tree.map(jnp.asarray, params))
    pick = lambda cls, obj: cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})
    cfg = C.AF3Config(encoder=pick(C.WhisperEncoderConfig, jm.cfg.encoder),
                      lm=pick(C.Qwen2Config, jm.cfg.lm), audio_token_id=jm.cfg.audio_token_id)
    tok = jm.processor.tokenizer
    tm = AudioFlamingo.from_state_dict(cfg, params_from_jax(params, cfg),
                                       BBPETokenizer(tok.vocab, tok.merges),
                                       compute_dtype=torch.float32, device="cpu")
    return jm, tm


def test_answers_equal_jax_demo_server():
    jm, tm = _lively_pair()
    jsrv, tsrv = JDemoServer(jm, port=0, max_new_tokens=8), DemoServer(tm, port=0,
                                                                        max_new_tokens=8)
    jsrv.start_background()
    tsrv.start_background()
    try:
        t = np.arange(12_000) / 16_000
        pcm = (0.3 * np.sin(2 * np.pi * 330 * t)).astype(np.float32)
        turns = [{"prompt": "What do you hear?",
                  "pcm_b64": base64.b64encode(pcm.tobytes()).decode()},
                 {"prompt": "Describe.", "file_b64": base64.b64encode(_wav_bytes(pcm)).decode()},
                 {"prompt": "And then?", "think": True}]
        got = [_post(tsrv, "/api/chat", turn)["text"] for turn in turns]
        want = [_post(jsrv, "/api/chat", turn)["text"] for turn in turns]
        assert got == want and any(got)
        assert len(tm.history) == len(jm.history) == 6
    finally:
        jsrv.shutdown()
        tsrv.shutdown()


class _SlowModel:
    """A stand-in that records how many generate calls overlap."""

    def __init__(self, fail: bool = False):
        self.active = self.most = 0
        self.fail = fail
        self.history = []

    def generate(self, sound, prompt, **kw):
        self.active += 1
        self.most = max(self.most, self.active)
        time.sleep(0.05)
        self.active -= 1
        if self.fail:
            raise RuntimeError("the card fell over")
        return f"{prompt}:{0 if sound is None else len(sound)}"

    def reset_chat(self):
        self.history.clear()


def test_lock_serializes_generate_and_failures_answer_500():
    model = _SlowModel()
    srv = DemoServer(model, port=0)
    srv.start_background()
    try:
        out = [None] * 6
        pcm = base64.b64encode(np.zeros(160, np.float32).tobytes()).decode()

        def post(i):
            out[i] = _post(srv, "/api/chat", {"prompt": f"p{i}", "pcm_b64": pcm})["text"]

        threads = [threading.Thread(target=post, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert out == [f"p{i}:160" for i in range(6)] and model.most == 1
        model.fail = True
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(srv, "/api/chat", {"prompt": "x"})
        assert exc.value.code == 500
        assert "the card fell over" in json.loads(exc.value.read())["error"]
    finally:
        srv.shutdown()
