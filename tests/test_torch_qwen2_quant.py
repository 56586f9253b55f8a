"""Port's quantized LM against the JAX package at f32: the same quantized tree (carried
across by ``params_from_jax``) through prefill and two decode steps (the fused w4 tree
through the suffix path where JAX takes it), logits within 1e-4; and ``load(quantize_lm=
"int4" | True)`` of a checkpoint written by the JAX exporter against JAX ``load``, greedy
ids token-exact; under bf16 the scales stay f32."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu import api as japi
from audio_flamingo_tpu.config import AF3Config as JAF3Config
from audio_flamingo_tpu.config import Qwen2Config as JQwen2Config
from audio_flamingo_tpu.io.hf_export import save_pretrained
from audio_flamingo_tpu.models import af3 as jaf3
from audio_flamingo_tpu.models import qwen2 as jqwen2
from audio_flamingo_tpu.ops import quant as jquant
from audio_flamingo_tpu.ops import quant4 as jquant4
from audio_flamingo_tpu.ops.sampling import SamplingParams as JSamplingParams
from audio_flamingo_tpu.runtime import generate as jgen
from audio_flamingo_tpu.runtime.tokenizer import BBPETokenizer as JTokenizer
from audio_flamingo_tpu.runtime.tokenizer import train_bpe as j_train_bpe
from audio_flamingo_tpu.train.data import bucket_tokens as j_bucket_tokens
from audio_flamingo_tpu_torch import api
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.io.convert import lm_params_from_jax
from audio_flamingo_tpu_torch.models import qwen2

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

LOGITS_TOL = 1e-4
JLM = JQwen2Config(vocab_size=128, hidden_size=256, intermediate_size=512, num_layers=3,
                   num_heads=4, num_kv_heads=2, head_dim=64, tie_word_embeddings=False)
LM = C.Qwen2Config(**{f.name: getattr(JLM, f.name) for f in dataclasses.fields(C.Qwen2Config)})
# the JAX functions under jit: one compile instead of one per eager op
_jw4 = jax.jit(jquant4.quantize_lm_params_w4, static_argnames=("group_size", "fuse", "head_w4"))
QUANTIZERS = {
    "w4_fused": lambda p: _jw4(p, group_size=64),
    "w4_unfused": lambda p: _jw4(p, group_size=64, fuse=False),
    "w4_head": lambda p: _jw4(p, group_size=64, head_w4=True),
    "int8": jax.jit(jquant.quantize_lm_params),
}


@pytest.mark.parametrize("variant", list(QUANTIZERS))
def test_quantized_lm_prefill_and_decode_match_jax(monkeypatch, variant):
    jp = QUANTIZERS[variant](jax.jit(jqwen2.init, static_argnums=1)(jax.random.PRNGKey(2), JLM))
    lm = qwen2.quantized_lm(qwen2.unflatten(lm_params_from_jax(jp, LM)), torch.float32, "cpu")
    suffix_calls = []
    real = qwen2.w4_suffix_a
    monkeypatch.setattr(qwen2, "w4_suffix_a", lambda *a, **k: suffix_calls.append(1)
                        or real(*a, **k))
    b, t0, cap = 2, 6, 16
    ids = np.random.default_rng(0).integers(0, 128, (b, t0)).astype(np.int32)
    jcache = jqwen2.init_cache(JLM, b, cap, dtype=jnp.float32)
    tcache = qwen2.init_cache(LM, b, cap, torch.float32, "cpu")
    jx = jqwen2.embed(jp, jnp.asarray(ids), dtype=jnp.float32)
    with torch.inference_mode():
        tx = qwen2.embed(lm, torch.from_numpy(ids).long())
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-7, rtol=0)
    for step in range(3):   # the prefill, then two decode steps at the greedy token
        s = jx.shape[1]
        pos = np.broadcast_to(np.arange(tcache.index, tcache.index + s), (b, s)).astype(np.int32)
        jh, jcache = jqwen2.forward(jp, JLM, jx, jnp.asarray(pos), cache=jcache)
        want = np.asarray(jqwen2.unembed(jp, JLM, jh[:, -1]))
        with torch.inference_mode():
            th, tcache = qwen2.forward(lm, LM, tx, torch.from_numpy(pos).long(), cache=tcache)
            got = qwen2.unembed(lm, th[:, -1]).numpy()
        np.testing.assert_allclose(got, want, atol=LOGITS_TOL, rtol=0, err_msg=f"step {step}")
        nxt = want.argmax(-1)
        assert (got.argmax(-1) == nxt).all()
        jx = jqwen2.embed(jp, jnp.asarray(nxt)[:, None], dtype=jnp.float32)
        with torch.inference_mode():
            tx = qwen2.embed(lm, torch.from_numpy(nxt).long()[:, None])
    assert tcache.index == int(jcache.index) == t0 + 2
    # the fused tree decodes through the suffix kernels: 3 layers x 2 decode steps
    assert len(suffix_calls) == (6 if variant in ("w4_fused", "w4_head") else 0)


def _checkpoint(tmp_path):
    tok = JTokenizer(*j_train_bpe(["describe the sound of music and speech"], 120),
                     use_native=False)
    cfg = JAF3Config.tiny()
    cfg = dataclasses.replace(cfg, audio_token_id=tok.special_tokens["<sound>"],
                              lm=dataclasses.replace(JLM, vocab_size=512))
    params = jax.tree.map(np.asarray, jax.jit(jaf3.init, static_argnums=1)(
        jax.random.PRNGKey(5), cfg))
    params["adaptor"] = {"fc1": params["adaptor"]["fc1"]}   # the importer's projector
    save_pretrained(str(tmp_path), params, cfg, tokenizer=tok)
    return str(tmp_path)


TONE = (0.2 * np.sin(2 * np.pi * 300 * np.arange(16000 * 2) / 16000)).astype(np.float32)
PROMPT = "Describe the sound."


def _jax_ids(jm, sound, n=6):
    """The greedy ids JAX api.generate decodes (same processor, bucket padding, loop)."""
    text = f"<sound>{PROMPT}" if sound is not None else PROMPT
    batch = jm.processor(messages=[{"role": "user", "content": text}],
                         audios=[sound] if sound is not None else None)
    ids = jnp.asarray(batch["ids"])
    mels = jnp.asarray(batch["mels"]) if batch["mels"] is not None else None
    t = ids.shape[1]
    ids = jnp.concatenate(
        [ids, jnp.full((1, j_bucket_tokens(t) - t), jm.eos_token_id, jnp.int32)], 1)
    tokens, lengths = jgen.generate(jm.params, jm.cfg, ids, mels, max_new_tokens=n,
                                    eos_token_id=jm.eos_token_id, sampling=JSamplingParams(),
                                    rng=jax.random.PRNGKey(0), compute_dtype=jnp.float32,
                                    prompt_len=jnp.asarray(t, jnp.int32))
    return np.asarray(tokens)[0][: int(lengths[0])].tolist()


@pytest.mark.parametrize("mode", ["int4", True])
def test_load_quantized_matches_jax_load(tmp_path, mode):
    path = _checkpoint(tmp_path)
    jm = japi.load(path, compute_dtype=jnp.float32, quantize_lm=mode)
    tm = api.load(path, compute_dtype=torch.float32, quantize_lm=mode, device="cpu")
    want = {k: np.asarray(v) for k, v in qwen2.flatten(jm.params["lm"]).items()}
    got = {k: v.numpy() for k, v in tm.model.lm.state_dict().items()}
    assert got.keys() == want.keys()
    for k in want:   # the same codes, scales, norms and biases
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for sound in (None, TONE):
        tm.generate(sound=sound, prompt=PROMPT, max_new_tokens=6)
        out = tm.last_output
        ids = out.tokens[0, : int(out.lengths[0])].tolist()
        assert ids == _jax_ids(jm, sound)


def test_load_bf16_keeps_scales_f32(tmp_path):
    path = _checkpoint(tmp_path)
    tm = api.load(path, compute_dtype=torch.bfloat16, quantize_lm="int4", device="cpu")
    lm = tm.model.lm
    assert isinstance(lm, qwen2.QuantQwen2) and tm.device == torch.device("cpu")
    assert lm.layers["qkv"]["gscale"].dtype == torch.float32
    assert lm.layers["qkv"]["w_p"].dtype == torch.int8
    assert lm.layers["qkv"]["b"].dtype == torch.bfloat16
    assert lm.layers["ln1_w"].dtype == torch.bfloat16
    assert lm.embed["scale"].dtype == lm.lm_head["scale"].dtype == torch.float32
    assert lm.embed["w_q"].dtype == torch.int8
    assert tm.model.encoder.conv1.weight.dtype == torch.bfloat16
    out = tm.generate(prompt="hi", max_new_tokens=2)
    assert isinstance(out, str) and tm.last_output.first_logits.dtype == torch.float32


def test_quantized_tree_without_int8_embedding_is_refused():
    """A JAX tree quantized with ``quantize_embed=False`` keeps a float embedding, which the
    port's quantized LM does not take: the converter says so instead of failing later."""
    jp = jquant.quantize_lm_params(jqwen2.init(jax.random.PRNGKey(2), JLM), quantize_embed=False)
    with pytest.raises(ValueError, match="int8 embedding"):
        lm_params_from_jax(jp, LM)
