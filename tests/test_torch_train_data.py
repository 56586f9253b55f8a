"""Port's training data against the JAX package: MixtureSampler draws, bucket_tokens,
icl_interleave and BatchBuilder batches for the same seed, the prefetcher, and the JSONL
and tar-shard sources (the port's native WAV reader and resampler)."""

import dataclasses
import io
import itertools
import json
import tarfile
import wave

import numpy as np
import pytest
import torch

from audio_flamingo_tpu.config import AF3Config as JAF3Config
from audio_flamingo_tpu.runtime.processor import AF3Processor as JProcessor
from audio_flamingo_tpu.runtime.tokenizer import BBPETokenizer as JTokenizer
from audio_flamingo_tpu.runtime.tokenizer import train_bpe as j_train_bpe
from audio_flamingo_tpu.train import data as jdata
from audio_flamingo_tpu.train import sources as jsources
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.runtime.processor import AUDIO_TOKEN, AF3Processor
from audio_flamingo_tpu_torch.runtime.tokenizer import BBPETokenizer
from audio_flamingo_tpu_torch.train import data as tdata
from audio_flamingo_tpu_torch.train import sources as tsources

torch.set_num_threads(2)
MEL_ATOL = 2e-4   # the port's log-mel against JAX's (tests/test_torch_mel.py)


def _port_cfg(j):
    pick = lambda cls, obj: cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})
    return C.AF3Config(encoder=pick(C.WhisperEncoderConfig, j.encoder),
                       lm=pick(C.Qwen2Config, j.lm), audio_token_id=j.audio_token_id)


@pytest.fixture(scope="module")
def processors():
    """The JAX processor of tests/test_train.py and the port's on the same tokenizer."""
    vocab, merges = j_train_bpe(["a dog barks", "music plays loudly", "someone speaks"], 380)
    jtok = JTokenizer(vocab, merges)
    cfg = JAF3Config.tiny()
    cfg = dataclasses.replace(cfg, audio_token_id=jtok.special_tokens[AUDIO_TOKEN])
    tproc = AF3Processor(tokenizer=BBPETokenizer(vocab, merges), cfg=_port_cfg(cfg),
                         device="cpu")
    return JProcessor(tokenizer=jtok, cfg=cfg), tproc


def _example(rng):
    """A 1-3 s clip and an answer whose length the rng picks."""
    wav = (rng.normal(size=int(rng.integers(16000, 48000))) * 0.1).astype(np.float32)
    words = ["a", "dog", "barks", "music", "plays", "loudly"]
    answer = " ".join(words[int(i)] for i in rng.integers(0, len(words), rng.integers(2, 9)))
    return [wav], f"What is {AUDIO_TOKEN}?", answer


def _sources(mod):
    return [mod.Source("speech", 3.0, _example),
            mod.Source("text", 1.0, lambda rng: ([], "Say something.",
                                                 "someone speaks " * int(rng.integers(1, 4))))]


def test_mixture_sampler_draws_match_jax():
    js = jdata.MixtureSampler(_sources(jdata), seed=3)
    ts = tdata.MixtureSampler(_sources(tdata), seed=3)
    for _ in range(40):
        (jn, (ja, jp, jans)), (tn, (ta, tp, tans)) = js.sample(), ts.sample()
        assert (jn, jp, jans) == (tn, tp, tans)
        assert len(ja) == len(ta) and all(np.array_equal(a, b) for a, b in zip(ja, ta))
    with pytest.raises(ValueError):
        tdata.MixtureSampler([])


def test_bucket_tokens_and_icl_interleave_match_jax():
    for n in [1, 127, 128, 129, 1000, 1024, 1025, 16384, 20000]:
        assert tdata.bucket_tokens(n) == jdata.bucket_tokens(n)
    assert tdata.TOKEN_BUCKETS == jdata.TOKEN_BUCKETS
    shots = [("What is it?", "a dog"), ("And this?", "music"), ("Last", "")]
    jt, jm = jdata.icl_interleave(shots)
    tt, tm = tdata.icl_interleave(shots)
    assert jt == tt and np.array_equal(jm, tm)


def test_batch_builder_matches_jax(processors):
    """Same seed, same draws: ids and labels equal, mels within the log-mel tolerance;
    the port's batch lies on the processor's device, as torch tensors."""
    jproc, tproc = processors
    jit = jdata.batches(jdata.MixtureSampler(_sources(jdata), seed=0),
                        jdata.BatchBuilder(processor=jproc, pad_id=0), batch_size=3)
    tit = tdata.batches(tdata.MixtureSampler(_sources(tdata), seed=0),
                        tdata.BatchBuilder(processor=tproc, pad_id=0), batch_size=3)
    n_audio = 0
    for jb, tb in itertools.islice(zip(jit, tit), 3):
        for key in ("ids", "labels", "mels"):
            assert isinstance(tb[key], torch.Tensor) and tb[key].device == tproc.device
        np.testing.assert_array_equal(tb["ids"].numpy(), jb["ids"])
        np.testing.assert_array_equal(tb["labels"].numpy(), jb["labels"])
        assert tb["mels"].shape == jb["mels"].shape
        np.testing.assert_allclose(tb["mels"].numpy(), jb["mels"], atol=MEL_ATOL, rtol=0)
        n_audio += int((jb["ids"] == jproc.cfg.audio_token_id).sum())
    assert n_audio > 0


def test_prefetch_matches_sequential_and_raises(processors):
    _, tproc = processors
    builder = tdata.BatchBuilder(processor=tproc)
    seq = [b["ids"] for b in itertools.islice(
        tdata.batches(tdata.MixtureSampler(_sources(tdata), seed=1), builder, 2), 3)]
    pre = [b["ids"] for b in itertools.islice(tdata.prefetch(
        tdata.batches(tdata.MixtureSampler(_sources(tdata), seed=1), builder, 2)), 3)]
    assert all(torch.equal(a, b) for a, b in zip(seq, pre))

    def broken():
        yield {"ids": 1}
        raise RuntimeError("source failed")

    it = tdata.prefetch(broken())
    assert next(it) == {"ids": 1}
    with pytest.raises(RuntimeError, match="source failed"):
        next(it)


def _wav_bytes(seconds=1, sr=48_000):
    buf = io.BytesIO()
    t = np.arange(sr * seconds) / sr
    x = (np.sin(2 * np.pi * 440 * t) * 0.3 * 32767).astype(np.int16)
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(x.tobytes())
    return buf.getvalue()


def _same_examples(jsrc, tsrc, n=8):
    rng_j, rng_t = np.random.default_rng(0), np.random.default_rng(0)
    kinds = set()
    for _ in range(n):
        (ja, jp, jans), (ta, tp, tans) = jsrc.examples(rng_j), tsrc.examples(rng_t)
        assert (jp, jans) == (tp, tans)
        assert len(ja) == len(ta)
        for a, b in zip(ja, ta):
            assert b.dtype == np.float32 and len(b) == 16_000
            np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)
        kinds.add(bool(ta))
    return kinds


def test_jsonl_source_matches_jax(tmp_path):
    (tmp_path / "a.wav").write_bytes(_wav_bytes())
    manifest = tmp_path / "data.jsonl"
    rows = [{"audio": "a.wav", "prompt": "What is this?", "answer": "a tone"},
            {"prompt": "Text only?", "answer": "yes"},
            {"audios": ["a.wav", "a.wav"], "prompt": "Compare.", "answer": "same"}]
    manifest.write_text("\n".join(json.dumps(r) for r in rows))
    jsrc = jsources.JsonlSource(str(manifest), audio_root=str(tmp_path)).source()
    tsrc = tsources.JsonlSource(str(manifest), audio_root=str(tmp_path)).source()
    assert tsrc.name == jsrc.name == "data.jsonl"
    assert _same_examples(jsrc, tsrc) == {True, False}
    (tmp_path / "empty.jsonl").write_text("\n")
    with pytest.raises(ValueError, match="empty manifest"):
        tsources.JsonlSource(str(tmp_path / "empty.jsonl"))


def test_tar_shard_source_matches_jax(tmp_path):
    shard = tmp_path / "shard-000.tar"
    with tarfile.open(shard, "w") as tf:
        for key in ("000001", "000002", "000003"):
            members = [(f"{key}.wav", _wav_bytes()),
                       (f"{key}.json", json.dumps({"prompt": "Describe",
                                                   "answer": f"clip {key}"}).encode())]
            if key == "000003":
                members = members[1:]            # no audio: not an example
            for name, blob in members:
                info = tarfile.TarInfo(name)
                info.size = len(blob)
                tf.addfile(info, io.BytesIO(blob))
    jsrc = jsources.TarShardSource([str(shard)])
    tsrc = tsources.TarShardSource([str(shard)])
    assert tsrc.index == jsrc.index and len(tsrc.index) == 2
    assert _same_examples(jsrc.source(), tsrc.source()) == {True}
    empty = tmp_path / "empty.tar"
    with tarfile.open(empty, "w"):
        pass
    with pytest.raises(ValueError, match="no \\(wav, json\\) pairs"):
        tsources.TarShardSource([str(empty)])
