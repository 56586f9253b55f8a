"""The port's worker-parallel input pipeline (train/grain_pipeline.py, torch DataLoader
workers) against JAX's ``grain_batches`` for one seed: the same examples in the same
order, so equal ids and labels and mels within the log-mel tolerance, with the port at 0
and at 2 spawned workers (which import the examples from tests/torch_grain_examples.py,
a module without JAX)."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from audio_flamingo_tpu.config import AF3Config as JAF3Config
from audio_flamingo_tpu.runtime.processor import AF3Processor as JProcessor
from audio_flamingo_tpu.runtime.tokenizer import BBPETokenizer as JTokenizer
from audio_flamingo_tpu.runtime.tokenizer import train_bpe as j_train_bpe
from audio_flamingo_tpu.train import data as jdata
from audio_flamingo_tpu.train.grain_pipeline import grain_batches as j_grain_batches
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.runtime.processor import AUDIO_TOKEN, AF3Processor
from audio_flamingo_tpu_torch.runtime.tokenizer import BBPETokenizer
from audio_flamingo_tpu_torch.train import data as tdata
from audio_flamingo_tpu_torch.train.grain_pipeline import grain_batches
from torch_grain_examples import speech, text

torch.set_num_threads(2)
MEL_ATOL = 2e-4   # the port's log-mel against JAX's (tests/test_torch_mel.py)


def _port_cfg(j):
    pick = lambda cls, obj: cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})
    return C.AF3Config(encoder=pick(C.WhisperEncoderConfig, j.encoder),
                       lm=pick(C.Qwen2Config, j.lm), audio_token_id=j.audio_token_id)


@pytest.fixture(scope="module")
def processors():
    vocab, merges = j_train_bpe(["a dog barks", "music plays loudly", "someone speaks"], 380)
    cfg = JAF3Config.tiny()
    cfg = dataclasses.replace(cfg, audio_token_id=JTokenizer(vocab, merges)
                              .special_tokens[AUDIO_TOKEN])
    return (JProcessor(tokenizer=JTokenizer(vocab, merges), cfg=cfg),
            AF3Processor(tokenizer=BBPETokenizer(vocab, merges), cfg=_port_cfg(cfg),
                         device="cpu"))


@pytest.mark.parametrize("workers", [0, 2])
def test_batches_match_jax_grain(processors, workers):
    jproc, tproc = processors
    jsampler = jdata.MixtureSampler([jdata.Source("speech", 3.0, speech),
                                     jdata.Source("text", 1.0, text)], seed=0)
    tsampler = tdata.MixtureSampler([tdata.Source("speech", 3.0, speech),
                                     tdata.Source("text", 1.0, text)], seed=0)
    want = list(itertools.islice(j_grain_batches(
        jsampler, jdata.BatchBuilder(processor=jproc, pad_id=0), 3, seed=7), 3))
    got = list(itertools.islice(grain_batches(
        tsampler, tdata.BatchBuilder(processor=tproc, pad_id=0), 3, seed=7,
        worker_count=workers, prefetch=4), 3))
    n_audio = 0
    for jb, tb in zip(want, got):
        np.testing.assert_array_equal(tb["ids"].numpy(), jb["ids"])
        np.testing.assert_array_equal(tb["labels"].numpy(), jb["labels"])
        assert tb["mels"].shape == jb["mels"].shape
        np.testing.assert_allclose(tb["mels"].numpy(), jb["mels"], atol=MEL_ATOL, rtol=0)
        n_audio += int((jb["ids"] == jproc.cfg.audio_token_id).sum())
    assert len(got) == 3 and n_audio > 0
