"""The port's w8a8 pieces against the JAX package at f32: per-token activation
quantization and the int8 x int8 products (eager JAX: codes and scales bit-identical,
outputs within 1e-6 relative), a tiny int8 LM under ``a8_prefill`` (and ``a8_attention``)
against JAX ``qwen2.logits_from_ids`` under the same flags, decode (one token) unchanged
by ``a8_prefill``, and ``train_step``'s grad norm on an all-float model, frozen parts
included, against JAX's (ROADMAP Queue 3 item 7).

The encoder quantizers are held to JAX's trees in tests/test_torch_enc_fused.py, beside
the conversion of both layouts.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.config import AF3Config as JAF3Config
from audio_flamingo_tpu.config import Qwen2Config as JQwen2Config
from audio_flamingo_tpu.models import af3 as jaf3
from audio_flamingo_tpu.models import qwen2 as jqwen2
from audio_flamingo_tpu.ops import quant as jquant
from audio_flamingo_tpu.train import train_step as jts
from audio_flamingo_tpu.train.stages import AF3_STAGES as J_STAGES
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.io.convert import lm_params_from_jax, params_from_jax
from audio_flamingo_tpu_torch.models import af3, qwen2
from audio_flamingo_tpu_torch.ops import quant
from audio_flamingo_tpu_torch.train import train_step as tts
from audio_flamingo_tpu_torch.train.stages import AF3_STAGES

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

JLM = JQwen2Config(vocab_size=128, hidden_size=256, intermediate_size=512, num_layers=3,
                   num_heads=4, num_kv_heads=2, head_dim=64, tie_word_embeddings=False)


def _pick(cls, obj):
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})


@pytest.mark.parametrize("shape", [(5, 64), (2, 7, 48), (33, 256)])
def test_activation_quantization_and_products_match_eager_jax(shape):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=shape) * rng.uniform(0.1, 3.0, size=shape[:-1] + (1,))
         ).astype(np.float32)
    x[..., 0, :] = 0.0          # an all-zero row: the scale's 1e-6 floor
    w = rng.normal(size=(shape[-1], 24)).astype(np.float32)
    jp = jquant.quantize_linear(jnp.asarray(w))
    p = quant.quantize_linear(torch.from_numpy(w))
    jq, js = jquant.quantize_act(jnp.asarray(x))
    q, s = quant.quantize_act(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    want = np.asarray(jquant.q_matmul_a8q(jq, js, jp, out_dtype=jnp.float32))
    got = quant.q_matmul_a8q(q, s, p, out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    got = quant.q_matmul_a8(torch.from_numpy(x), p).numpy()
    want = np.asarray(jquant.q_matmul_a8(jnp.asarray(x), jp))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    y = quant.q_matmul_a8q(q, s, p, out_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16 and y.shape == shape[:-1] + (24,)


def test_int8_product_is_exact_at_the_lm_width():
    """127^2 * 18,944 < 2^31: the int32 product of full-range codes is exact (unit
    scales; the value, 1,193,546 * 2^8, is exact in f32 as well)."""
    k = 18_944
    a = torch.full((2, k), 127, dtype=torch.int8)
    a[1] = -127
    p = {"w_q": torch.full((k, 8), 127, dtype=torch.int8), "scale": torch.ones(8)}
    y = quant.q_matmul_a8q(a, torch.ones(2, 1), p, out_dtype=torch.float32)
    assert (y[0] == 127 * 127 * k).all() and (y[1] == -127 * 127 * k).all()


@pytest.fixture(scope="module")
def int8_lm():
    jp = jax.jit(jquant.quantize_lm_params)(
        jax.jit(jqwen2.init, static_argnums=1)(jax.random.PRNGKey(2), JLM))
    lm = qwen2.quantized_lm(qwen2.unflatten(lm_params_from_jax(jp, _pick(C.Qwen2Config, JLM))),
                            torch.float32, "cpu")
    return jp, lm


@pytest.mark.parametrize("flags,tol", [
    (dict(a8_prefill=True), 1e-5),
    (dict(a8_prefill=True, use_flash=True), 1e-5),
    # K8's prelude inside JAX's jit may move a scale by an ulp and flip a code
    (dict(a8_prefill=True, use_flash=True, a8_attention=True), 1e-2),
])
def test_a8_prefill_logits_match_jax(int8_lm, flags, tol):
    jp, lm = int8_lm
    jc = dataclasses.replace(JLM, **flags)
    cfg = _pick(C.Qwen2Config, jc)
    ids = np.random.default_rng(0).integers(0, 128, (2, 40)).astype(np.int32)
    want = np.asarray(jqwen2.logits_from_ids(jp, jc, jnp.asarray(ids)))
    with torch.inference_mode():
        x = qwen2.embed(lm, torch.from_numpy(ids).long())
        h, _ = qwen2.forward(lm, cfg, x, torch.arange(40)[None].expand(2, 40))
        got = qwen2.unembed(lm, h).numpy()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
    assert (got.argmax(-1) == want.argmax(-1)).all()
    off = np.asarray(jqwen2.logits_from_ids(jp, JLM, jnp.asarray(ids)))
    assert np.abs(got - off).max() > 0       # the flags changed the computation


def test_a8_leaves_decode_bit_identical(int8_lm):
    """A one-token step under a8_prefill is the w8a16 step, bit for bit; a multi-token
    step is not."""
    _, lm = int8_lm
    on = _pick(C.Qwen2Config, dataclasses.replace(JLM, a8_prefill=True))
    off = _pick(C.Qwen2Config, JLM)
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 128, (2, 9))).long()
    outs = {}
    with torch.inference_mode():
        for name, cfg in (("on", on), ("off", off)):
            cache = qwen2.init_cache(cfg, 2, 16, torch.float32, "cpu")
            x = qwen2.embed(lm, ids[:, :8])
            h0, cache = qwen2.forward(lm, cfg, x, torch.arange(8)[None].expand(2, 8), cache)
            h1, _ = qwen2.forward(lm, off, qwen2.embed(lm, ids[:, 8:]),
                                  torch.full((2, 1), 8), cache)
            h2, _ = qwen2.forward(lm, cfg, qwen2.embed(lm, ids[:, 8:]),
                                  torch.full((2, 1), 8), qwen2.KVCache(cache.k.clone(),
                                                                       cache.v.clone(), 8))
            outs[name] = (h0, h1, h2)
    assert not torch.equal(outs["on"][0], outs["off"][0])
    assert torch.equal(outs["on"][1], outs["on"][2])     # decode under a8 = decode without


def test_grad_norm_includes_frozen_float_parts():
    """Stage 2 on a tiny all-float AF3: the LM is frozen, yet the port's grad_norm is
    JAX's (within 1e-5 relative), which takes the norm over every parameter's gradient;
    the clip still uses the hot part's norm, and the frozen LM does not move."""
    jcfg = JAF3Config.tiny()
    jcfg = dataclasses.replace(jcfg, lm=dataclasses.replace(jcfg.lm, vocab_size=256))
    params = jaf3.init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    ids = rng.integers(5, 250, (2, 32)).astype(np.int32)
    ids[:, 1:9] = jcfg.audio_token_id
    labels = ids.copy()
    labels[:, :20] = -100
    mels = (rng.normal(size=(2, 1, 3000, jcfg.encoder.num_mel_bins)) * 0.1).astype(np.float32)
    batch = {"ids": ids, "labels": labels, "mels": mels}
    jstate, jopt = jts.init_state(jax.tree.map(jnp.copy, params), J_STAGES["2_encoder_tuning"],
                                  warmup_steps=1, total_steps=5)
    jstep = jts.make_jit_train_step(jcfg, jopt, compute_dtype=jnp.float32)
    cfg = C.AF3Config(encoder=_pick(C.WhisperEncoderConfig, jcfg.encoder),
                      lm=_pick(C.Qwen2Config, jcfg.lm), audio_token_id=jcfg.audio_token_id)
    model = af3.build(cfg, "cpu", torch.float32)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), cfg))
    lm_before = {k: v.clone() for k, v in model.lm.state_dict().items()}
    state, opt = tts.init_state(model, AF3_STAGES["2_encoder_tuning"], warmup_steps=1,
                                total_steps=5)
    assert all(not n.startswith("lm.") for n in opt.hot)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for step in range(2):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = tts.train_step(state, tb, cfg=cfg, opt=opt)
        assert abs(m["grad_norm"].item() - float(jm["grad_norm"])) <= (
            1e-5 * float(jm["grad_norm"])), step
        _, grads = tts.loss_and_grads(model, tb, cfg=cfg, opt=opt)
        hot_norm = tts.global_norm(grads[n] for n in opt.hot).item()
        assert hot_norm < tts.global_norm(grads.values()).item()
    assert all(not p.requires_grad for n, p in model.named_parameters() if n.startswith("lm."))
    for k, v in model.lm.state_dict().items():
        assert torch.equal(v, lm_before[k]), k


def test_stage_that_trains_an_int8_encoder_raises():
    """A stage whose mask trains the encoder refuses an int8 encoder (its layers are
    codes; JAX cannot differentiate them either); a stage that freezes it builds."""
    from audio_flamingo_tpu_torch.api import AudioFlamingo
    from audio_flamingo_tpu_torch.models import whisper_encoder

    m = AudioFlamingo.from_random(device="cpu")
    enc = whisper_encoder.quantize(m.model.encoder, m.cfg.encoder)
    model = af3.AF3Model(enc, m.model.adaptor, m.model.lm)
    with pytest.raises(ValueError, match="int8 codes"):
        tts.init_state(model, AF3_STAGES["2_encoder_tuning"])
    _, opt = tts.init_state(model, AF3_STAGES["1_pretrain"])
    assert opt.hot and all(n.startswith("adaptor.") for n in opt.hot)
