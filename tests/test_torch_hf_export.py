"""The port's HF export (io/hf_export.py) against the JAX package's at f32: the exported
arrays (1- and 2-layer adaptors, tied and untied heads) and the written directories
(config.json, model.safetensors, bf16, shards with their index, the tokenizer files)
equal JAX's for the same weights; io/convert.state_dict_from_hf (and api.load) read the
export back to the same model; the plain-Qwen2 export equals JAX's and api.load_draft
reads it; a quantized LM or one with adapters is refused."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax

from audio_flamingo_tpu.config import AF3Config as JAF3Config
from audio_flamingo_tpu.config import Qwen2Config as JQwen2Config
from audio_flamingo_tpu.config import WhisperEncoderConfig as JEncoderConfig
from audio_flamingo_tpu.io import hf_export as jexport
from audio_flamingo_tpu.models import af3 as jaf3
from audio_flamingo_tpu.models import qwen2 as jqwen2
from audio_flamingo_tpu.runtime.tokenizer import BBPETokenizer as JTokenizer
from audio_flamingo_tpu.runtime.tokenizer import train_bpe
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.api import load, load_draft
from audio_flamingo_tpu_torch.io import hf_export
from audio_flamingo_tpu_torch.io.convert import (lm_params_from_jax, params_from_jax,
                                                 state_dict_from_hf)
from audio_flamingo_tpu_torch.io.safetensors import load_safetensors
from audio_flamingo_tpu_torch.models import af3, lora, qwen2
from audio_flamingo_tpu_torch.runtime.tokenizer import BBPETokenizer

torch.set_num_threads(2)

JCFG = JAF3Config(
    encoder=JEncoderConfig(num_mel_bins=16, d_model=32, num_layers=2, num_heads=4, ffn_dim=64,
                           max_source_positions=12, pool_stride=2),
    lm=JQwen2Config(vocab_size=128, hidden_size=48, intermediate_size=96, num_layers=2,
                    num_heads=4, num_kv_heads=2, rope_theta=1e6, tie_word_embeddings=False),
    audio_token_id=120)


def _pick(cls, obj):
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})


def _port_cfg(j):
    return C.AF3Config(encoder=_pick(C.WhisperEncoderConfig, j.encoder),
                       lm=_pick(C.Qwen2Config, j.lm), audio_token_id=j.audio_token_id)


def _case(adaptor_layers: int, tied: bool):
    jcfg = dataclasses.replace(JCFG, lm=dataclasses.replace(JCFG.lm, tie_word_embeddings=tied))
    params = jaf3.init(jax.random.PRNGKey(3), jcfg)
    if adaptor_layers == 1:
        params["adaptor"] = {"fc1": params["adaptor"]["fc1"]}
    cfg = _port_cfg(jcfg)
    model = af3.build(cfg, "cpu", torch.float32, adaptor_layers=adaptor_layers)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), cfg))
    return jcfg, params, cfg, model


CASES = [(1, False), (2, True)]


@pytest.mark.parametrize("layers,tied", CASES)
def test_state_dict_equals_jax_and_reads_back(layers, tied):
    jcfg, params, cfg, model = _case(layers, tied)
    want = jexport.export_af3_state_dict(params, jcfg)
    got = hf_export.export_af3_state_dict(model, cfg)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32 and np.array_equal(got[k], v), k
    back = af3.build(cfg, "cpu", torch.float32, adaptor_layers=layers)
    back.load_state_dict(state_dict_from_hf(got, cfg))
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


def _files(path: str) -> dict:
    return {f: (json.load(open(os.path.join(path, f))) if f.endswith(".json") else
                load_safetensors(os.path.join(path, f), upcast_bf16=False)
                if f.endswith(".safetensors") else open(os.path.join(path, f)).read())
            for f in sorted(os.listdir(path))}


@pytest.mark.parametrize("kw", [{}, dict(dtype="bf16"), dict(max_shard_bytes=40_000)])
def test_directories_equal_jax(tmp_path, kw):
    jcfg, params, cfg, model = _case(2, False)
    vocab, merges = train_bpe(["the sound of rain"], 120)
    jexport.save_pretrained(str(tmp_path / "j"), params, jcfg, tokenizer=JTokenizer(vocab, merges),
                            **kw)
    hf_export.save_pretrained(str(tmp_path / "p"), model, cfg,
                              tokenizer=BBPETokenizer(vocab, merges), **kw)
    want, got = _files(str(tmp_path / "j")), _files(str(tmp_path / "p"))
    assert list(got) == list(want)
    if kw.get("max_shard_bytes"):
        assert len(got) > 5                             # several shards and the index
    for f, w in want.items():
        if f.endswith(".safetensors"):
            assert list(got[f]) == list(w), f
            for k, v in w.items():
                assert got[f][k].dtype == v.dtype and np.array_equal(got[f][k], v), (f, k)
        else:
            assert got[f] == w, f
    m = load(str(tmp_path / "p"), compute_dtype=torch.float32, device="cpu")
    if not kw:
        for k, v in model.state_dict().items():
            assert torch.equal(m.model.state_dict()[k], v), k


def test_qwen2_export_equals_jax_and_loads_as_draft(tmp_path):
    jlm = dataclasses.replace(JCFG.lm, num_layers=1)
    params = jqwen2.init(jax.random.PRNGKey(5), jlm)
    cfg = _pick(C.Qwen2Config, jlm)
    with torch.device("meta"):
        lm = qwen2.Qwen2(cfg, dtype=torch.float32)
    lm = lm.to_empty(device="cpu")
    lm.load_state_dict(lm_params_from_jax(jax.tree.map(np.asarray, params), cfg))
    want = jexport.export_qwen2_state_dict(params, jlm)
    got = hf_export.export_qwen2_state_dict(lm, cfg)
    assert list(got) == list(want) and all(np.array_equal(got[k], v) for k, v in want.items())
    jexport.save_qwen2_pretrained(str(tmp_path / "j"), params, jlm)
    hf_export.save_qwen2_pretrained(str(tmp_path / "p"), lm, cfg)
    jf, pf = _files(str(tmp_path / "j")), _files(str(tmp_path / "p"))
    assert pf["config.json"] == jf["config.json"]
    assert all(np.array_equal(pf["model.safetensors"][k], v)
               for k, v in jf["model.safetensors"].items())
    draft, dcfg = load_draft(str(tmp_path / "p"), torch.float32, device="cpu")
    assert dcfg.num_layers == 1
    for k, v in lm.state_dict().items():
        assert torch.equal(draft.state_dict()[k], v), k


def test_refusals():
    from audio_flamingo_tpu_torch.ops.quant import quantize_lm_params

    _, _, cfg, model = _case(2, False)
    lora.add_lora(torch.Generator().manual_seed(0), model, rank=2)
    with pytest.raises(ValueError, match="merge_lora"):
        hf_export.export_af3_state_dict(model, cfg)
    qlm = qwen2.quantized_lm(quantize_lm_params(_case(2, False)[3].lm.state_dict()),
                             torch.float32, "cpu")
    with pytest.raises(ValueError, match="quantized"):
        hf_export.export_qwen2_state_dict(qlm, cfg.lm)
