"""The port's command line (cli.py, ``python -m audio_flamingo_tpu_torch``) against the
JAX package's: ``infer`` and a two-turn ``chat`` print what JAX's CLI prints on the same
tiny checkpoint (written by JAX's exporter, f32, ``--device cpu``); ``train --config`` on a
tiny YAML prints ``done: step N`` equal to a direct ``loop.run`` with the same seed;
``demo`` hands its flags to the demo server; ``bench`` raises the NOT_PORTED message;
without ``--device`` and without a card a command raises."""

import dataclasses
import io
import json
import os
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch

import jax

from audio_flamingo_tpu import cli as jcli
from audio_flamingo_tpu.config import AF3Config as JAF3Config
from audio_flamingo_tpu.io.hf_export import save_pretrained
from audio_flamingo_tpu.models import af3 as jaf3
from audio_flamingo_tpu.runtime.tokenizer import BBPETokenizer as JTokenizer
from audio_flamingo_tpu.runtime.tokenizer import train_bpe as j_train_bpe
from audio_flamingo_tpu_torch import cli
from audio_flamingo_tpu_torch.models import af3
from audio_flamingo_tpu_torch.runtime.processor import AUDIO_TOKEN, AF3Processor
from audio_flamingo_tpu_torch.runtime.tokenizer import BBPETokenizer, train_bpe
from audio_flamingo_tpu_torch.serve import demo
from audio_flamingo_tpu_torch.train import loop
from audio_flamingo_tpu_torch.train.config import load_train_config
from audio_flamingo_tpu_torch.train.data import BatchBuilder

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_wav(path, seconds: float, hz: float, seed: int) -> None:
    rng = np.random.default_rng(seed)
    t = np.arange(int(16_000 * seconds)) / 16_000
    x = 0.3 * np.sin(2 * np.pi * hz * t) + 0.05 * rng.standard_normal(t.size)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16_000)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A tiny AF3 checkpoint written by JAX's exporter (the LM's linears x 3, so that
    greedy ids vary) and two WAV clips."""
    d = tmp_path_factory.mktemp("cli")
    tok = JTokenizer(*j_train_bpe(["describe the sound of music and speech"], 400),
                     use_native=False)
    cfg = JAF3Config.tiny()
    cfg = dataclasses.replace(cfg, audio_token_id=tok.special_tokens["<sound>"],
                              lm=dataclasses.replace(cfg.lm, tie_word_embeddings=False))
    params = jax.tree.map(np.asarray, jaf3.init(jax.random.PRNGKey(11), cfg))
    params["adaptor"] = {"fc1": params["adaptor"]["fc1"]}   # the importer's projector
    layers = params["lm"]["layers"]
    for name in ("q", "k", "v", "o"):
        layers[name]["w"] = layers[name]["w"] * 3.0
    layers["mlp"] = {k: v * 3.0 for k, v in layers["mlp"].items()}
    save_pretrained(str(d / "model"), params, cfg, tokenizer=tok)
    _write_wav(d / "a.wav", 2.0, 330.0, 0)
    _write_wav(d / "b.wav", 1.0, 550.0, 1)
    return d


def _run(main, argv, capsys, stdin: str | None = None, monkeypatch=None) -> str:
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("audio", [True, False])
def test_infer_prints_what_jax_prints(ckpt, capsys, audio):
    argv = ["infer", "--model", str(ckpt / "model"), "--fp32", "--max-new-tokens", "8",
            "--prompt", "What is this?"] + (["--audio", str(ckpt / "a.wav")] if audio else [])
    want = _run(jcli.main, argv, capsys)
    got = _run(cli.main, argv + ["--device", "cpu"], capsys)
    assert got == want and got.strip()


def test_chat_prints_what_jax_prints(ckpt, capsys, monkeypatch):
    stdin = (f":audio {ckpt / 'b.wav'}\nWhat do you hear?\n\nAnd then?\n:reset\n"
             f"Hello.\n")
    argv = ["chat", "--model", str(ckpt / "model"), "--fp32", "--max-new-tokens", "8"]
    want = _run(jcli.main, argv, capsys, stdin, monkeypatch)
    got = _run(cli.main, argv + ["--device", "cpu"], capsys, stdin, monkeypatch)
    assert got == want
    assert got.count("assistant> ") == 3


def test_train_prints_a_direct_run(tmp_path, capsys):
    _write_wav(tmp_path / "c.wav", 1.0, 440.0, 2)
    with open(tmp_path / "m.jsonl", "w") as f:
        for i in range(3):
            f.write(json.dumps({"audio": "c.wav", "prompt": "What?",
                                "answer": f"A tone {i}."}) + "\n")
    path = tmp_path / "train.yaml"
    path.write_text(f"""\
stage: 2_encoder_tuning
batch_size: 2
num_steps: 2
log_every: 1
model:
  preset: tiny
mixture:
  - jsonl: {tmp_path / "m.jsonl"}
    audio_root: {tmp_path}
""")
    out = _run(cli.main, ["train", "--config", str(path), "--seed", "3", "--device", "cpu"],
               capsys)
    model_cfg, run_cfg, make_sampler = load_train_config(str(path))
    tok = BBPETokenizer(*train_bpe(["describe the audio"], min(400, model_cfg.lm.vocab_size)))
    model_cfg = dataclasses.replace(model_cfg, audio_token_id=tok.special_tokens[AUDIO_TOKEN])
    model = af3.build(model_cfg, "cpu", torch.float32)
    af3.init_(model, model_cfg, torch.Generator().manual_seed(3))
    builder = BatchBuilder(processor=AF3Processor(tokenizer=tok, cfg=model_cfg, device="cpu"))
    state, metrics = loop.run(model_cfg, model, make_sampler(3), builder, run_cfg,
                              device="cpu")
    last = out.strip().splitlines()[-1]
    assert last == f"done: step {int(state.step)}, last loss {metrics.latest('loss')}"
    assert last.startswith("done: step 2, last loss ")


def test_demo_hands_its_flags_to_the_server(monkeypatch):
    seen = {}

    def fake_serve(self):
        seen.update(port=self.port, device=str(self.model.device),
                    dtype=next(self.model.model.parameters()).dtype)
        self.httpd.server_close()

    monkeypatch.setattr(demo.DemoServer, "serve_forever", fake_serve)
    cli.main(["demo", "--port", "0", "--device", "cpu"])
    assert seen["device"] == "cpu" and seen["port"] > 0 and seen["dtype"] == torch.float32


def test_bench_raises_not_ported():
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md, Queue 1: 13, the port's "
                                                  r"benchmark harness"):
        cli.main(["bench"])


@pytest.mark.parametrize("cmd", [["infer", "--fp32"], ["chat"], ["demo", "--port", "0"],
                                 ["train", "--config", "unread.yaml"]])
def test_without_device_and_card_raises(cmd, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(cmd)


def test_python_dash_m_entry():
    run = subprocess.run([sys.executable, "-m", "audio_flamingo_tpu_torch", "--help"],
                         capture_output=True, text=True, cwd=ROOT, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert run.returncode == 0, run.stderr
    assert all(c in run.stdout for c in ("infer", "chat", "train", "demo", "bench"))
