"""Port's Qwen2 decoder against the JAX decoder at f32: full forward, prefill + decode
through the KV cache, the flash gate, sliding-window gating, tied and untied heads."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.config import AF3Config as JAF3Config
from audio_flamingo_tpu.models import af3 as jaf3
from audio_flamingo_tpu.models import qwen2 as jq
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.io.convert import params_from_jax
from audio_flamingo_tpu_torch.models import af3, qwen2
from audio_flamingo_tpu_torch.ops.kernels import flash_attention as tfa

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

VARIANTS = {
    "tied": {},
    "untied": {"tie_word_embeddings": False},
    "sliding": {"sliding_window": 5, "max_window_layers": 1},
}


def _port_cfg(j):
    pick = lambda cls, obj: cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})
    return C.AF3Config(encoder=pick(C.WhisperEncoderConfig, j.encoder),
                       lm=pick(C.Qwen2Config, j.lm), audio_token_id=j.audio_token_id)


def _setup(variant: str, use_flash: bool = False):
    jcfg = JAF3Config.tiny()
    jcfg = dataclasses.replace(jcfg, lm=dataclasses.replace(jcfg.lm, use_flash=use_flash,
                                                            **VARIANTS[variant]))
    params = jax.tree.map(np.asarray, jaf3.init(jax.random.PRNGKey(1), jcfg))
    cfg = _port_cfg(jcfg)
    model = af3.build(cfg, "cpu", torch.float32)
    model.load_state_dict(params_from_jax(params, cfg))
    return jcfg, params, cfg, model


def _embeds(b, t, d, seed=0):
    return np.random.default_rng(seed).normal(size=(b, t, d)).astype(np.float32)


# flash on the tied model; sliding layers must turn the flash gate off
@pytest.mark.parametrize("variant,use_flash", [("tied", False), ("tied", True),
                                               ("untied", False), ("sliding", True)])
def test_forward_and_unembed_match_jax(variant, use_flash):
    jcfg, params, cfg, model = _setup(variant, use_flash)
    b, t = 2, 12
    x = _embeds(b, t, jcfg.lm.hidden_size)
    pos = np.broadcast_to(np.arange(t), (b, t)).astype(np.int32)
    jh, _ = jq.forward(params["lm"], jcfg.lm, jnp.asarray(x), jnp.asarray(pos))
    want = np.asarray(jq.unembed(params["lm"], jcfg.lm, jh))
    tfa.LAUNCHES.reset()
    with torch.inference_mode():
        th, _ = qwen2.forward(model.lm, cfg.lm, torch.from_numpy(x), torch.from_numpy(pos).long())
        got = qwen2.unembed(model.lm, th).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert tfa.LAUNCHES.count == 0   # CPU tensors never reach the kernel


@pytest.mark.parametrize("variant", ["tied", "sliding"])
def test_prefill_then_decode_matches_jax_cache(variant):
    jcfg, params, cfg, model = _setup(variant, use_flash=True)
    t0, steps, cap = 9, 4, 16
    x = _embeds(1, t0 + steps, jcfg.lm.hidden_size, seed=2)
    jcache = jq.init_cache(jcfg.lm, 1, cap, dtype=jnp.float32)
    tcache = qwen2.init_cache(cfg.lm, 1, cap, torch.float32, "cpu")
    spans = [(0, t0)] + [(t0 + i, t0 + i + 1) for i in range(steps)]
    for lo, hi in spans:
        pos = np.arange(lo, hi, dtype=np.int32)[None]
        jh, jcache = jq.forward(params["lm"], jcfg.lm, jnp.asarray(x[:, lo:hi]),
                                jnp.asarray(pos), cache=jcache, is_prefill=lo == 0)
        with torch.inference_mode():
            th, tcache = qwen2.forward(model.lm, cfg.lm, torch.from_numpy(x[:, lo:hi]),
                                       torch.from_numpy(pos).long(), cache=tcache,
                                       is_prefill=lo == 0)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4, rtol=0)
    assert tcache.index == int(jcache.index) == t0 + steps
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), atol=1e-4, rtol=0)


def test_extra_mask_matches_jax():
    jcfg, params, cfg, model = _setup("tied", use_flash=True)
    b, t = 2, 10
    x = _embeds(b, t, jcfg.lm.hidden_size, seed=3)
    pos = np.broadcast_to(np.arange(t), (b, t)).astype(np.int32)
    valid = np.arange(t)[None] < np.array([[10], [7]])
    extra = valid[:, None, None, :]
    jh, _ = jq.forward(params["lm"], jcfg.lm, jnp.asarray(x), jnp.asarray(pos),
                       extra_mask=jnp.asarray(extra))
    with torch.inference_mode():
        th, _ = qwen2.forward(model.lm, cfg.lm, torch.from_numpy(x), torch.from_numpy(pos).long(),
                              extra_mask=torch.from_numpy(extra))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4, rtol=0)


def test_cache_overflow_raises():
    _, _, cfg, model = _setup("tied")
    cache = qwen2.init_cache(cfg.lm, 1, 4, torch.float32, "cpu")
    with pytest.raises(ValueError):
        qwen2.forward(model.lm, cfg.lm, torch.zeros(1, 5, cfg.lm.hidden_size),
                      torch.arange(5)[None], cache=cache, is_prefill=True)
