"""Port's load() of checkpoints written by the JAX package's io/hf_export.save_pretrained,
against JAX api.load on the same directory (greedy, token-exact, f32), and the two weight
converters against each other."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu import api as japi
from audio_flamingo_tpu.config import AF3Config as JAF3Config
from audio_flamingo_tpu.io.hf_export import export_af3_state_dict, save_pretrained
from audio_flamingo_tpu.models import af3 as jaf3
from audio_flamingo_tpu.ops.sampling import SamplingParams as JSamplingParams
from audio_flamingo_tpu.runtime import generate as jgen
from audio_flamingo_tpu.runtime.tokenizer import BBPETokenizer as JTokenizer
from audio_flamingo_tpu.runtime.tokenizer import train_bpe as j_train_bpe
from audio_flamingo_tpu.train.data import bucket_tokens as j_bucket_tokens
from audio_flamingo_tpu_torch import api
from audio_flamingo_tpu_torch.io.convert import params_from_jax, state_dict_from_hf
from audio_flamingo_tpu_torch.models import af3
from audio_flamingo_tpu_torch.models.qwen2 import flatten

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

TONE = (0.2 * np.sin(2 * np.pi * 300 * np.arange(16000 * 2) / 16000)).astype(np.float32)
PROMPT = "Describe the sound."


def _tiny(tied: bool = True):
    tok = JTokenizer(*j_train_bpe(["describe the sound of music and speech"], 400),
                     use_native=False)
    cfg = JAF3Config.tiny()
    cfg = dataclasses.replace(cfg, audio_token_id=tok.special_tokens["<sound>"],
                              lm=dataclasses.replace(cfg.lm, tie_word_embeddings=tied))
    params = jax.tree.map(np.asarray, jaf3.init(jax.random.PRNGKey(7), cfg))
    return cfg, params, tok


def _jax_ids(jm, sound):
    """The token ids JAX api.generate decodes (same processor, bucket padding, loop)."""
    text = f"<sound>{PROMPT}" if sound is not None else PROMPT
    batch = jm.processor(messages=[{"role": "user", "content": text}],
                         audios=[sound] if sound is not None else None)
    ids = jnp.asarray(batch["ids"])
    mels = jnp.asarray(batch["mels"]) if batch["mels"] is not None else None
    t = ids.shape[1]
    ids = jnp.concatenate(
        [ids, jnp.full((1, j_bucket_tokens(t) - t), jm.eos_token_id, jnp.int32)], 1)
    tokens, lengths = jgen.generate(jm.params, jm.cfg, ids, mels, max_new_tokens=8,
                                    eos_token_id=jm.eos_token_id, sampling=JSamplingParams(),
                                    rng=jax.random.PRNGKey(0), compute_dtype=jnp.float32,
                                    prompt_len=jnp.asarray(t, jnp.int32))
    return np.asarray(tokens)[0][: int(lengths[0])].tolist()


@pytest.mark.parametrize("layout", ["f32", "bf16_sharded"])
def test_load_matches_jax_load(tmp_path, layout):
    cfg, params, tok = _tiny(tied=False)
    # the qwen2_audio single-linear projector: JAX's importer reads only that layer
    params["adaptor"] = {"fc1": params["adaptor"]["fc1"]}
    kw = {} if layout == "f32" else {"dtype": "bf16", "max_shard_bytes": 200_000}
    save_pretrained(str(tmp_path), params, cfg, tokenizer=tok, **kw)
    jm = japi.load(str(tmp_path), compute_dtype=jnp.float32)
    tm = api.load(str(tmp_path), compute_dtype=torch.float32, device="cpu")
    assert tm.cfg.lm.use_flash and tm.cfg.encoder.use_flash
    assert tm.model.adaptor.fc2 is None
    for sound in (None, TONE):
        ttext = tm.generate(sound=sound, prompt=PROMPT, max_new_tokens=8)
        out = tm.last_output
        assert out.tokens[0, : int(out.lengths[0])].tolist() == _jax_ids(jm, sound)
        assert ttext == jm.generate(sound=sound, prompt=PROMPT, max_new_tokens=8)


def test_load_keeps_two_layer_adaptor(tmp_path):
    """save_pretrained writes a 2-layer adaptor's fc2 as mm_projector.2; the port reads it,
    so its logits equal af3.logits on the original params."""
    cfg, params, tok = _tiny(tied=True)
    save_pretrained(str(tmp_path), params, cfg, tokenizer=tok)
    tm = api.load(str(tmp_path), compute_dtype=torch.float32, device="cpu", use_flash=False)
    assert tm.model.adaptor.fc2 is not None
    batch = tm.processor(messages=[{"role": "user", "content": "<sound>hi"}], audios=[TONE])
    want = np.asarray(jaf3.logits(params, cfg, jnp.asarray(batch["ids"]),
                                  jnp.asarray(batch["mels"].numpy())))
    got = af3.logits(tm.model, tm.cfg, torch.from_numpy(batch["ids"]).long(), batch["mels"])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("tied", [True, False])
def test_converters_agree(tied):
    cfg, params, _ = _tiny(tied)
    a = params_from_jax(params, cfg)
    b = state_dict_from_hf(export_af3_state_dict(params, cfg), cfg)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_load_rejects_unported_options_and_missing_parts(tmp_path):
    """The w8a8 flags: load(quantize_lm=True, a8_prefill=True, a8_encoder=True) holds the
    trees JAX's load holds (int8 LM and encoder, bit for bit) and answers with its greedy
    ids; a8_prefill without the int8 LM raises, as JAX's assert does. A state dict that
    lacks the tower or the projector is refused."""
    cfg, params, tok = _tiny(tied=False)
    params["adaptor"] = {"fc1": params["adaptor"]["fc1"]}   # the importer's projector
    save_pretrained(str(tmp_path), params, cfg, tokenizer=tok)
    flags = dict(quantize_lm=True, a8_prefill=True, a8_encoder=True)
    jm = japi.load(str(tmp_path), compute_dtype=jnp.float32, **flags)
    tm = api.load(str(tmp_path), compute_dtype=torch.float32, device="cpu", **flags)
    assert tm.cfg.lm.a8_prefill and jm.cfg.lm.a8_prefill
    for part in ("encoder", "lm"):
        want = {k: np.asarray(v) for k, v in flatten(jm.params[part]["layers"]).items()}
        got = {k: v.numpy() for k, v in getattr(tm.model, part).layers.state_dict().items()}
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{part}.{k}")
    for sound in (None, TONE):
        tm.generate(sound=sound, prompt=PROMPT, max_new_tokens=8)
        out = tm.last_output
        assert out.tokens[0, : int(out.lengths[0])].tolist() == _jax_ids(jm, sound)
    for quantize_lm in (False, "int4"):
        with pytest.raises(ValueError, match="a8_prefill requires"):
            api.load(str(tmp_path), quantize_lm=quantize_lm, a8_prefill=True, device="cpu")
        with pytest.raises(AssertionError, match="a8_prefill requires"):
            japi.load(str(tmp_path), quantize_lm=quantize_lm, a8_prefill=True)
    sd = export_af3_state_dict(params, cfg)
    with pytest.raises(KeyError):
        state_dict_from_hf({k: v for k, v in sd.items() if "audio_tower" not in k}, cfg)
    with pytest.raises(KeyError):
        state_dict_from_hf({k: v for k, v in sd.items() if "projector" not in k}, cfg)


def test_config_from_hf_matches_jax_load(tmp_path):
    import json

    cfg, params, tok = _tiny()
    save_pretrained(str(tmp_path), params, cfg, tokenizer=tok)
    with open(tmp_path / "config.json") as f:
        raw = json.load(f)
    raw["text_config"].update(rope_theta=1e4, use_sliding_window=True, sliding_window=64,
                              max_window_layers=1)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(raw, f)
    want = japi.load(str(tmp_path), compute_dtype=jnp.float32, use_flash=False).cfg
    got = api.config_from_hf(raw)
    for part in ("encoder", "lm"):
        for f in dataclasses.fields(getattr(got, part)):
            assert getattr(getattr(got, part), f.name) == getattr(getattr(want, part), f.name)
    assert got.audio_token_id == want.audio_token_id
    assert got.lm.sliding_window == 64 and got.lm.rope_theta == 1e4
