"""The port's YAML run config (train/config.py) against the JAX package: its YAML reader
against PyYAML's ``safe_load`` on the docstring's example and variants (every scalar kind,
comments, quoting, nesting, sequences at their key's indentation), the refusals of what
lies outside the subset (with the line), ``load_train_config`` field by field against
JAX's on the same file, and the brace expansion of tar shard patterns."""

import dataclasses
import io
import json
import math
import tarfile
import wave

import numpy as np
import pytest
import torch
import yaml

from audio_flamingo_tpu.train import config as jconfig
from audio_flamingo_tpu_torch.config import AF3Config
from audio_flamingo_tpu_torch.train import config

torch.set_num_threads(2)

EXAMPLE = config.__doc__.split("```yaml\n")[1].split("```")[0]

VARIANTS = [
    EXAMPLE,
    # scalars of every kind, in YAML 1.1 as PyYAML resolves them
    """\
ints: [0, 7, -12, +3, 010, 0x1F, 0b101, 1_000, -0x10]
floats: [1.5, -2., .5, 1.0e+3, 2.5E-2, .inf, -.inf, 1_0.5]
not_numbers: [1e3, 1.0e3, 12abc, 0x, v1.2]
bools: [true, True, TRUE, false, yes, No, on, OFF]
nulls: [~, null, Null, NULL]
empty:
strings: ["a # not a comment", 'it''s', "tab\\tand \\"quote\\" \\u00e9", plain text here]
path: s3://bucket/key-{000..009}.tar   # a comment
colon_inside: a:b
hash_inside: a#b
""",
    # nesting, sequences at their key's indentation, items that open mappings, comments
    """\
# leading comment
stage: 3.5_context_think
model:
  preset: af3_7b
  nested:
    deeper:
      - 1
      - - ignored
mixture:
- jsonl: /data/a.jsonl   # same indentation as the key
  weight: 2
  name: "first source"
-
  tar_shards:
    - /data/s-{0..2}.tar
    - '/data/t.tar'
  weight: 0.5
"list of lists":
  -
    - x
    - y
  - [z, 'w']
ckpt_dir:
log_every: 5
""",
]


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(_same, a, b))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("i", range(len(VARIANTS)))
def test_reader_matches_safe_load(i):
    text = VARIANTS[i]
    if i == 2:
        # PyYAML reads '- - ignored' as a nested sequence; the reader refuses it
        with pytest.raises(ValueError, match="line 8: a sequence nested on one line"):
            config.read_yaml(text)
        text = text.replace("      - - ignored\n", "")
    assert _same(config.read_yaml(text), yaml.safe_load(text))


@pytest.mark.parametrize("text,line", [
    ("a: {b: 1}\n", 1), ("a: &x 1\nb: *x\n", 1), ("a: !!str 1\n", 1), ("a: |\n  text\n", 1),
    ("---\na: 1\n", 1), ("a: 1\nb:\n\t- 2\n", 3), ("when: 2024-01-02\n", 1),
    ("a: 1\n  b: 2\n", 2), ("a: [1, {b: 2}]\n", 1), ("a: \"open\n", 1),
    ("a: 1\njust a scalar\n", 2), ("time: 1:30\n", 1),
])
def test_reader_refuses_outside_the_subset(text, line):
    with pytest.raises(ValueError, match=f"YAML line {line}: .* outside the subset"):
        config.read_yaml(text)


def test_empty_and_comment_only_documents():
    for text in ("", "\n\n", "# only a comment\n"):
        assert config.read_yaml(text) is None and yaml.safe_load(text) is None


def _wav_bytes(n: int = 1600) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16_000)
        w.writeframes((np.sin(np.arange(n) / 5.0) * 8000).astype(np.int16).tobytes())
    return buf.getvalue()


def test_load_train_config_matches_jax(tmp_path):
    """The same file through both packages: the model preset, every run field, and the
    sampler factory's sources (names, weights, probabilities, shards found by brace
    expansion) and first draws."""
    (tmp_path / "audio").mkdir()
    (tmp_path / "audio" / "a.wav").write_bytes(_wav_bytes())
    with open(tmp_path / "m.jsonl", "w") as f:
        f.write(json.dumps({"audio": "a.wav", "prompt": "What?", "answer": "A tone."}) + "\n")
    for i in range(3):
        with tarfile.open(tmp_path / f"shard-{i:03d}.tar", "w") as tf:
            for name, data in ((f"k{i}.wav", _wav_bytes()),
                               (f"k{i}.json", json.dumps({"prompt": "P", "answer": str(i)})
                                .encode())):
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    text = f"""\
stage: 2_encoder_tuning   # AF3 stage 2
batch_size: 4
num_steps: 12
log_every: 3
ckpt_every: 6
ckpt_dir: {tmp_path / "ckpt"}
model:
  preset: tiny
mixture:
  - jsonl: {tmp_path / "m.jsonl"}
    audio_root: {tmp_path / "audio"}
    weight: 3.0
    name: skills
  - tar_shards: ["{tmp_path}/shard-{{000..002}}.tar"]
    weight: 1
"""
    path = tmp_path / "train.yaml"
    path.write_text(text)
    jm, jr, jmake = jconfig.load_train_config(str(path))
    m, r, make = config.load_train_config(str(path))
    mine = dataclasses.asdict(m)

    def held(want: dict, got: dict, path=""):
        for k, v in want.items():        # every field the two configs share
            if k not in got:
                continue
            if isinstance(v, dict):
                held(v, got[k], f"{path}{k}.")
            else:
                assert got[k] == (list(v) if isinstance(v, tuple) and isinstance(got[k], list)
                                  else v), path + k
    held(dataclasses.asdict(jm), mine)
    assert m == AF3Config.tiny()
    for f in ("stage", "batch_size", "num_steps", "log_every", "ckpt_every", "ckpt_dir"):
        assert getattr(r, f) == getattr(jr, f), f
    js, s = jmake(seed=5), make(seed=5)
    assert [x.name for x in s.sources] == [x.name for x in js.sources] == ["skills", "tar"]
    assert [x.weight for x in s.sources] == [x.weight for x in js.sources]
    np.testing.assert_array_equal(s.probs, js.probs)
    for _ in range(4):
        (jn, (jaud, jp, ja)), (n, (aud, p, a)) = js.sample(), s.sample()
        assert (n, p, a) == (jn, jp, ja)
        assert len(aud) == len(jaud) and all(np.allclose(x, y, atol=1e-6)
                                             for x, y in zip(aud, jaud))


def test_expand_braces_matches_jax(tmp_path):
    for name in ("x1.tar", "x2.tar"):
        (tmp_path / name).write_bytes(b"")
    for pat in ("/d/shard-{000..012}.tar", "/d/s{7..9}.tar", f"{tmp_path}/x*.tar",
                "/nowhere/none-*.tar", "/d/plain.tar"):
        assert config._expand_braces(pat) == jconfig._expand_braces(pat), pat
