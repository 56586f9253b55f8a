"""Port's tokenizer, safetensors I/O and token buckets against the JAX package's."""

import json

import numpy as np
import pytest

from audio_flamingo_tpu.io import safetensors as jst
from audio_flamingo_tpu.runtime import tokenizer as jtok
from audio_flamingo_tpu.train.data import bucket_tokens as j_bucket_tokens
from audio_flamingo_tpu_torch.config import bucket_tokens
from audio_flamingo_tpu_torch.io import safetensors as tst
from audio_flamingo_tpu_torch.runtime import tokenizer as ttok

CORPUS = ["describe the sound of music and speech", "It's a dog barking; don't panic!",
          "Ünïcödé naïve café 漢字 テスト ٣٤ 12345 ²", "tabs\tand\nnew\r\nlines   end  "]
TEXTS = CORPUS + ["<|im_start|>user\n<sound><sound>What?<|im_end|>\n", "I'LL 'S 'Re",
                  "emoji 😀🎵 ♪  nbsp 　ideographic sep", "x\x1cy \x1f z",
                  "ﬁ compatibility 並 forms", ""]


@pytest.fixture(scope="module")
def vocab_merges():
    vm = ttok.train_bpe(CORPUS, 420)
    assert vm == jtok.train_bpe(CORPUS, 420)
    return vm


def test_pretokenizer_matches_regex_module():
    import regex

    pat = regex.compile(jtok.PRETOKENIZE_REGEX)
    rng = np.random.default_rng(0)
    pool = [chr(c) for c in [*range(0x20, 0x250), *range(0x370, 0x530), *range(0x3000, 0x3100),
                             *range(0x4e00, 0x4e40), 0x0a, 0x0d, 0x09, 0x0b, 0x85, 0x2028]]
    texts = TEXTS + ["".join(rng.choice(pool, size=int(rng.integers(1, 40)))) for _ in range(200)]
    for t in texts:
        assert ttok.pretokenize_pattern().findall(t) == pat.findall(t), repr(t)


def test_encode_decode_match_jax(vocab_merges):
    a = ttok.BBPETokenizer(*vocab_merges)
    b = jtok.BBPETokenizer(*vocab_merges, use_native=False)
    assert a.special_tokens == b.special_tokens
    for t in TEXTS:
        ids = a.encode(t)
        assert ids == b.encode(t)
        assert a.decode(ids) == b.decode(ids)
        assert a.decode(ids, skip_special=True) == b.decode(ids, skip_special=True)


@pytest.mark.parametrize("layout", ["vocab_merges", "tokenizer_json"])
def test_from_pretrained_dir_matches_jax(tmp_path, vocab_merges, layout):
    vocab, merges = vocab_merges
    if layout == "vocab_merges":
        (tmp_path / "vocab.json").write_text(json.dumps(vocab))
        (tmp_path / "merges.txt").write_text(
            "#version: 0.2\n" + "".join(f"{x} {y}\n" for x, y in merges))
    else:
        plain = {k: v for k, v in vocab.items() if k not in jtok.DEFAULT_SPECIAL_TOKENS}
        added = [{"id": len(plain) + i, "content": "<extra_%d>" % i} for i in range(2)]
        (tmp_path / "tokenizer.json").write_text(json.dumps(
            {"model": {"vocab": plain, "merges": [f"{x} {y}" for x, y in merges]},
             "added_tokens": added}))
    a = ttok.BBPETokenizer.from_pretrained_dir(str(tmp_path))
    b = jtok.BBPETokenizer.from_pretrained_dir(str(tmp_path), use_native=False)
    assert a.vocab == b.vocab and a.special_tokens == b.special_tokens
    for t in TEXTS + ["<extra_1>hi<extra_0>"]:
        assert a.encode(t) == b.encode(t)


def test_safetensors_roundtrip_and_cross_read(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {"f32": rng.normal(size=(3, 5)).astype(np.float32),
               "i8": rng.integers(-5, 5, size=(7,)).astype(np.int8),
               "bf16": (rng.normal(size=(4, 2)).astype(np.float32).view(np.uint32) >> 16)
               .astype(np.uint16)}
    ours, theirs = str(tmp_path / "a.safetensors"), str(tmp_path / "b.safetensors")
    tst.save_safetensors(ours, tensors, metadata={"format": "pt"})
    jst.save_safetensors(theirs, tensors, metadata={"format": "pt"})
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    raw = tst.load_safetensors(ours, upcast_bf16=False)
    up = tst.load_safetensors(ours)
    want = jst.load_safetensors(ours)
    for k in tensors:
        np.testing.assert_array_equal(raw[k], tensors[k])
        np.testing.assert_array_equal(up[k], want[k])
    np.testing.assert_array_equal(up["bf16"], tst.bf16_to_f32(tensors["bf16"]))


def test_bucket_tokens_match():
    for n in (1, 127, 128, 129, 1000, 1024, 1025, 20000):
        assert bucket_tokens(n) == j_bucket_tokens(n)
