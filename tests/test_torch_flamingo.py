"""Port's AF1/AF2 stack against the JAX package at f32: xattn's media masks and block,
the audio-transform layers, flamingo logits / logits_with_media_mask / prefill /
decode_step on a Qwen2 LM (float, the JAX-quantized int8 tree, the fused w4 tree through
the plain versions of K4 and K5) and on OPT, and greedy generate token-exact with and
without prompt_len padding, with Flamingo media masking and with generate's options."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.config import AF2Config as JAF2Config
from audio_flamingo_tpu.config import ClapAudioConfig as JClapAudioConfig
from audio_flamingo_tpu.config import GatedXAttnConfig as JGatedXAttnConfig
from audio_flamingo_tpu.config import OPTConfig as JOPTConfig
from audio_flamingo_tpu.config import Qwen2Config as JQwen2Config
from audio_flamingo_tpu.models import flamingo as jflamingo
from audio_flamingo_tpu.models import opt as jopt
from audio_flamingo_tpu.ops import quant as jquant
from audio_flamingo_tpu.ops import quant4 as jquant4
from audio_flamingo_tpu.ops import xattn as jxattn
from audio_flamingo_tpu.ops.sampling import SamplingParams as JSamplingParams
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.io.convert import (_flat_tree, _from_jax, _fusion_names, _opt_names,
                                                  af2_params_from_jax, af2_params_to_jax)
from audio_flamingo_tpu_torch.models import flamingo, opt, qwen2
from audio_flamingo_tpu_torch.ops import xattn
from audio_flamingo_tpu_torch.ops.sampling import SamplingParams

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

TOL = 1e-4   # f32 logits, hidden states and caches


def port_cfg(j: JAF2Config) -> C.AF2Config:
    pick = lambda cls, obj: cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})
    lm_cls = C.OPTConfig if isinstance(j.lm, JOPTConfig) else C.Qwen2Config
    return C.AF2Config(clap=pick(C.ClapAudioConfig, j.clap), lm=pick(lm_cls, j.lm),
                       xattn=pick(C.GatedXAttnConfig, j.xattn),
                       num_audio_transform_layers=j.num_audio_transform_layers,
                       audio_embed_dim=j.audio_embed_dim, mel=pick(C.ClapMelConfig, j.mel))


XA = JGatedXAttnConfig(cross_every_n_layers=1, num_heads=4, ffn_mult=2)
CFGS = {
    # tests/test_flamingo.py's config
    "float": JAF2Config(clap=JClapAudioConfig(), xattn=XA, num_audio_transform_layers=2,
                        audio_embed_dim=16,
                        lm=JQwen2Config(vocab_size=96, hidden_size=32, intermediate_size=64,
                                        num_layers=2, num_heads=4, num_kv_heads=2,
                                        tie_word_embeddings=True)),
    # widths the w4 quantizer packs (K a multiple of 2 x 64); an untied head
    "quant": JAF2Config(clap=JClapAudioConfig(), xattn=XA, num_audio_transform_layers=2,
                        audio_embed_dim=16,
                        lm=JQwen2Config(vocab_size=128, hidden_size=128, intermediate_size=256,
                                        num_layers=2, num_heads=4, num_kv_heads=2,
                                        tie_word_embeddings=False)),
    # AF1: OPT, xattn before every second layer
    "opt": JAF2Config(clap=JClapAudioConfig(),
                      xattn=JGatedXAttnConfig(cross_every_n_layers=2, num_heads=4, ffn_mult=2),
                      num_audio_transform_layers=1, audio_embed_dim=16,
                      lm=JOPTConfig(vocab_size=96, hidden_size=32, ffn_dim=64, num_layers=4,
                                    num_heads=4, max_position_embeddings=512)),
}
_jw4 = jax.jit(jquant4.quantize_lm_params_w4, static_argnames=("group_size",))
LAYOUTS = {"float": ("float", None), "int8": ("quant", jax.jit(jquant.quantize_lm_params)),
           "w4": ("quant", lambda p: _jw4(p, group_size=64)), "opt": ("opt", None)}


def _lively(params: dict, seed: int) -> dict:
    """Nonzero gates (a fresh block is an identity), the LM's layer linears x 3 and its
    token (OPT: token x 3, position x 30) embeddings scaled up, so that the audio reaches
    the logits and greedy ids vary (a tiny random LM otherwise repeats one token)."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, params)
    n_x = params["xattn"]["alpha_xattn"].shape[0]
    params["xattn"]["alpha_xattn"] = rng.uniform(0.5, 1.5, n_x).astype(np.float32)
    params["xattn"]["alpha_dense"] = rng.uniform(-1.0, 1.0, n_x).astype(np.float32)
    layers = params["lm"]["layers"]
    for name, p in layers.items():
        if isinstance(p, dict) and "w" in p:
            p["w"] = p["w"] * 3.0
    if "mlp" in layers:
        for name in ("gate", "up", "down"):
            layers["mlp"][name] = layers["mlp"][name] * 3.0
    lm = params["lm"]
    if "pos_embed" in lm:
        lm["embed"], lm["pos_embed"] = lm["embed"] * 3.0, lm["pos_embed"] * 30.0
    else:
        lm["embed"] = lm["embed"] * 30.0
        if "lm_head" in lm:
            lm["lm_head"] = lm["lm_head"] * 30.0
    return params


_MODELS: dict = {}


def models(layout: str):
    """(JAX cfg, JAX params, port cfg, port model) of a layout, made once."""
    if layout not in _MODELS:
        key, quantize = LAYOUTS[layout]
        jcfg = CFGS[key]
        params = _lively(jflamingo.init(jax.random.PRNGKey(0), jcfg), seed=1)
        if quantize is not None:
            params["lm"] = jax.tree.map(np.asarray, quantize(params["lm"]))
        cfg = port_cfg(jcfg)
        state = af2_params_from_jax(params, cfg)
        lm = None
        if quantize is not None:
            lm = qwen2.quantized_lm(qwen2.unflatten({k[3:]: v for k, v in state.items()
                                                     if k.startswith("lm.")}),
                                    torch.float32, "cpu")
            state = {k: v for k, v in state.items() if not k.startswith("lm.")}
        model = flamingo.build(cfg, "cpu", torch.float32, lm=lm)
        model.load_state_dict(state, strict=lm is None)
        _MODELS[layout] = (jcfg, params, cfg, model)
    return _MODELS[layout]


def _ids(b: int, t: int, vocab: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)


def _wins(b: int, n_media: int, wpm: int, d: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((b, n_media, wpm, d)).astype(np.float32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x))


# --------------------------------------------------------------------------------- xattn

@pytest.mark.parametrize("mode", ["last", "all_previous"])
def test_media_mask_matches_jax(mode):
    idx = np.array([[0, 1, 1, 2, 2, 3], [0, 0, 1, 3, 3, 3]], np.int32)
    want = np.asarray(jxattn.media_mask(jnp.asarray(idx), 3, 4, mode=mode))
    got = xattn.media_mask(_t(idx).long(), 3, 4, mode=mode)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", [None, "last", "all_previous"])
def test_xattn_apply_matches_jax(mode):
    """A block with moved norms and gates: every row without media zeroed in both."""
    jp = jax.tree.map(np.asarray, jxattn.init(jax.random.PRNGKey(3), 32, 16, 4, 2))
    rng = np.random.default_rng(4)
    jp = jax.tree.map(lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32), jp)
    block = xattn.XAttnBlock(32, 16, 4, 2).requires_grad_(False)
    names = [n for n in _fusion_names(dataclasses.replace(port_cfg(CFGS["float"]),
                                                          lm=C.Qwen2Config(num_layers=1)))
             if n[0].startswith("xattn.")]
    state = _from_jax(_flat_tree({"xattn": jax.tree.map(lambda a: a[None], jp)}), names)
    block.load_state_dict({k[len("xattn.0."):]: v for k, v in state.items()})
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    media = rng.standard_normal((2, 8, 16)).astype(np.float32)
    mask = None
    if mode is not None:
        mask = xattn.media_mask(torch.tensor([[0, 1, 1, 2, 2, 2], [0, 0, 1, 1, 2, 2]]), 2, 4,
                                mode=mode)
    want = jxattn.apply(jp, jnp.asarray(x), jnp.asarray(media), 4,
                        mask=None if mask is None else jnp.asarray(mask.numpy()))
    got = xattn.apply(block, _t(x), _t(media), mask=mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_zero_gates_are_identity():
    """With zero gates the stack is the plain Qwen2 (the JAX test's claim, on the port)."""
    cfg = port_cfg(CFGS["float"])
    model = flamingo.init(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    ids = _t(_ids(2, 7, 96, seed=0)).long()
    with_audio = flamingo.logits(model, cfg, ids, _t(_wins(2, 1, 4, 16, seed=1)))
    pos = torch.arange(7)[None].expand(2, 7)
    h, _ = qwen2.forward(model.lm, cfg.lm, qwen2.embed(model.lm, ids), pos)
    np.testing.assert_allclose(with_audio.numpy(), qwen2.unembed(model.lm, h).numpy(),
                               atol=1e-5, rtol=0)


def test_transform_audio_matches_jax():
    jcfg, params, cfg, model = models("float")
    wins = _wins(2, 3, 4, 16, seed=2)
    want = jflamingo.transform_audio(params, jcfg, jnp.asarray(wins))
    got = flamingo.transform_audio(model, cfg, _t(wins))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


# ------------------------------------------------------------------------ forward, prefill

@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_logits_match_jax(layout):
    jcfg, params, cfg, model = models(layout)
    ids, wins = _ids(2, 9, cfg.lm.vocab_size, seed=3), _wins(2, 2, 3, 16, seed=4)
    want = np.asarray(jflamingo.logits(params, jcfg, jnp.asarray(ids), jnp.asarray(wins)))
    got = flamingo.logits(model, cfg, _t(ids).long(), _t(wins)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("layout", ["float", "opt"])
@pytest.mark.parametrize("mode", ["last", "all_previous"])
def test_logits_with_media_mask_match_jax(layout, mode):
    """AF1's few-shot case: 4 media x 4 windows interleaved with text."""
    jcfg, params, cfg, model = models(layout)
    ids = _ids(1, 12, cfg.lm.vocab_size, seed=5)
    idx = np.array([[0, 0, 1, 1, 1, 2, 2, 3, 3, 4, 4, 4]], np.int32)
    wins = _wins(1, 4, 4, 16, seed=6)
    want = np.asarray(jflamingo.logits_with_media_mask(params, jcfg, jnp.asarray(ids),
                                                       jnp.asarray(wins), jnp.asarray(idx),
                                                       4, mode=mode))
    got = flamingo.logits_with_media_mask(model, cfg, _t(ids).long(), _t(wins),
                                          _t(idx).long(), 4, mode=mode).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("padded", [False, True])
def test_prefill_matches_jax(layout, padded):
    """Last-row logits, the media and the filled cache; a right-padded prompt takes the
    logits of row prompt_len - 1 and sets the index to prompt_len."""
    jcfg, params, cfg, model = models(layout)
    ids, wins = _ids(1, 12, cfg.lm.vocab_size, seed=7), _wins(1, 1, 3, 16, seed=8)
    plen = 9 if padded else None
    jcache, jmedia, jlogits = jflamingo.prefill(
        params, jcfg, jnp.asarray(ids), jnp.asarray(wins), 32,
        prompt_len=None if plen is None else jnp.asarray(plen, jnp.int32))
    cache, media, logits = flamingo.prefill(model, cfg, _t(ids).long(), _t(wins), 32,
                                            prompt_len=plen)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=TOL, rtol=0)
    np.testing.assert_allclose(media.numpy(), np.asarray(jmedia), atol=TOL, rtol=0)
    assert cache.host_index == int(cache.index) == int(jcache.index) == (plen or 12)
    for got, want in ((cache.k, jcache.k), (cache.v, jcache.v)):
        np.testing.assert_allclose(got[:, :, :12].numpy(), np.asarray(want)[:, :, :12],
                                   atol=TOL, rtol=0)


@pytest.mark.parametrize("layout", ["float", "w4"])
def test_decode_step_matches_jax(layout):
    jcfg, params, cfg, model = models(layout)
    ids, wins = _ids(1, 10, cfg.lm.vocab_size, seed=9), _wins(1, 1, 3, 16, seed=10)
    jcache, jmedia, _ = jflamingo.prefill(params, jcfg, jnp.asarray(ids), jnp.asarray(wins), 32)
    cache, media, _ = flamingo.prefill(model, cfg, _t(ids).long(), _t(wins), 32)
    for step, tok in enumerate((5, 17)):
        jcache, want = jflamingo.decode_step(params, jcfg, jcache, jmedia,
                                             jnp.asarray([tok], jnp.int32),
                                             jnp.asarray(10 + step, jnp.int32))
        cache, got = flamingo.decode_step(model, cfg, cache, media, torch.tensor([tok]),
                                          torch.tensor(10 + step))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    assert int(cache.index) == int(jcache.index) == 12


# -------------------------------------------------------------------------------- generate

def _jax_generate(jcfg, params, ids, wins, plen=None, **kw):
    out = jflamingo.generate(params, jcfg, jnp.asarray(ids), jnp.asarray(wins),
                             prompt_len=None if plen is None else jnp.asarray(plen, jnp.int32),
                             **kw)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("padded", [False, True])
def test_generate_greedy_matches_jax(layout, padded):
    jcfg, params, cfg, model = models(layout)
    ids, wins = _ids(1, 16, cfg.lm.vocab_size, seed=11), _wins(1, 2, 3, 16, seed=12)
    plen = 11 if padded else None
    tokens, lengths = _jax_generate(jcfg, params, ids, wins, plen, max_new_tokens=12,
                                    eos_token_id=3)
    out = flamingo.generate(model, cfg, _t(ids).long(), _t(wins), max_new_tokens=12,
                            eos_token_id=3, prompt_len=plen)
    np.testing.assert_array_equal(out.tokens.numpy(), tokens)
    np.testing.assert_array_equal(out.lengths.numpy(), lengths)
    assert len(set(tokens[0, : lengths[0]].tolist())) > 1, "a constant answer tests little"


@pytest.mark.parametrize("layout", ["float", "opt"])
def test_generate_with_media_mask_matches_jax(layout):
    """Few-shot ICL: the prompt masked per media item, the generated tokens attend to the
    last clip only."""
    jcfg, params, cfg, model = models(layout)
    ids, wins = _ids(1, 12, cfg.lm.vocab_size, seed=13), _wins(1, 3, 2, 16, seed=14)
    idx = np.array([[0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3]], np.int32)
    tokens, lengths = _jax_generate(jcfg, params, ids, wins, max_new_tokens=8, eos_token_id=-1,
                                    text_media_idx=jnp.asarray(idx))
    out = flamingo.generate(model, cfg, _t(ids).long(), _t(wins), max_new_tokens=8,
                            eos_token_id=-1, text_media_idx=_t(idx).long())
    np.testing.assert_array_equal(out.tokens.numpy(), tokens)


def test_generate_options_match_jax():
    """Repetition penalty, the EOS floor, a stop sequence and log-probabilities."""
    jcfg, params, cfg, model = models("float")
    ids, wins = _ids(1, 10, 96, seed=15), _wins(1, 1, 4, 16, seed=16)
    jsp = JSamplingParams(repetition_penalty=1.3, min_new_tokens=2)
    ref, _ = _jax_generate(jcfg, params, ids, wins, max_new_tokens=10, eos_token_id=7,
                           sampling=jsp)
    stop = (tuple(int(t) for t in ref[0, 3:5]),)
    tokens, lengths, lp = _jax_generate(jcfg, params, ids, wins, max_new_tokens=10,
                                        eos_token_id=7, sampling=jsp, stop_sequences=stop,
                                        return_logprobs=True)
    out = flamingo.generate(model, cfg, _t(ids).long(), _t(wins), max_new_tokens=10,
                            eos_token_id=7, stop_sequences=stop, return_logprobs=True,
                            sampling=SamplingParams(repetition_penalty=1.3, min_new_tokens=2))
    np.testing.assert_array_equal(out.tokens.numpy(), tokens)
    np.testing.assert_array_equal(out.lengths.numpy(), lengths)
    np.testing.assert_allclose(out.logprobs.numpy(), lp, atol=TOL, rtol=0)


def test_second_media_equals_its_own_run():
    """The decode state keeps the media it attends to: a generate right after another
    with other media gives what it gives alone (the captured step's trap, eagerly)."""
    _, _, cfg, model = models("float")
    ids = _t(_ids(1, 10, 96, seed=17)).long()
    wins_a, wins_b = _t(_wins(1, 1, 4, 16, seed=18)), _t(_wins(1, 1, 4, 16, seed=19))
    alone = flamingo.generate(model, cfg, ids, wins_b, max_new_tokens=8).tokens
    flamingo.generate(model, cfg, ids, wins_a, max_new_tokens=8)
    after = flamingo.generate(model, cfg, ids, wins_b, max_new_tokens=8).tokens
    torch.testing.assert_close(after, alone, rtol=0, atol=0)
    assert not torch.equal(flamingo.generate(model, cfg, ids, wins_a, max_new_tokens=8).tokens,
                           alone)


def test_fused_w4_stack_never_takes_the_suffix_kernels(monkeypatch):
    """K6 computes the next layer's qkv before that layer's xattn block: the stack must
    not reach it, at prefill or at one token."""
    def refuse(*args, **kwargs):
        raise AssertionError("the flamingo stack reached a w4 suffix")

    monkeypatch.setattr(qwen2, "w4_suffix_a", refuse)
    monkeypatch.setattr(qwen2, "w4_suffix_b", refuse)
    _, _, cfg, model = models("w4")
    assert qwen2.split_stacked_w4(model.lm.layers) is not None
    out = flamingo.generate(model, cfg, _t(_ids(1, 8, 128, seed=20)).long(),
                            _t(_wins(1, 1, 2, 16, seed=21)), max_new_tokens=4)
    assert out.decode_steps == 3


# ------------------------------------------------------------------------------------ OPT

@pytest.mark.parametrize("variant", [{}, {"do_layer_norm_before": False},
                                     {"word_embed_proj_dim": 16}])
def test_opt_logits_match_jax(variant):
    jcfg = JOPTConfig(vocab_size=80, hidden_size=32, ffn_dim=64, num_layers=2, num_heads=4,
                      max_position_embeddings=64, **variant)
    cfg = C.OPTConfig(**dataclasses.asdict(jcfg))
    params = jax.tree.map(np.asarray, jopt.init(jax.random.PRNGKey(4), jcfg))
    lm = opt.build(cfg, "cpu", torch.float32)
    lm.load_state_dict(_from_jax(_flat_tree(params), _opt_names(cfg)))
    ids = _ids(2, 11, 80, seed=22)
    want = np.asarray(jopt.logits_from_ids(params, jcfg, jnp.asarray(ids)))
    got = opt.logits_from_ids(lm, cfg, _t(ids).long()).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_opt_cache_forward_matches_full_forward():
    """Prefill then one cached token equals the cache-free forward over all rows."""
    _, _, cfg, model = models("opt")
    lm, lcfg = model.lm, cfg.lm
    ids = _t(_ids(1, 9, 96, seed=23)).long()
    full = opt.logits_from_ids(lm, lcfg, ids)
    cache = opt.init_cache(lcfg, 1, 16, torch.float32, "cpu")
    pos = torch.arange(9)[None]
    with torch.inference_mode():
        h, cache = opt.forward(lm, lcfg, opt.embed(lm, ids[:, :8]), pos[:, :8], cache)
        h2, cache = opt.forward(lm, lcfg, opt.embed(lm, ids[:, 8:]), pos[:, 8:], cache)
    np.testing.assert_allclose(opt.unembed(lm, h2)[0, 0].numpy(), full[0, 8].numpy(),
                               atol=TOL, rtol=0)
    assert cache.host_index == 9


@pytest.mark.parametrize("layout", ["float", "int8", "opt"])
def test_af2_params_round_trip(layout):
    """af2_params_to_jax inverts af2_params_from_jax: the names and arrays JAX's save_af2
    writes."""
    _, params, cfg, model = models(layout)
    back = af2_params_to_jax(model.state_dict(), cfg)
    flat = _flat_tree(params)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
