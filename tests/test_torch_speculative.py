"""The port's dense speculative decoding (runtime/speculative.py) and the API's draft
(AudioFlamingo(draft=...), load_draft) against the JAX package at f32 on the same
numpy-seeded weights (AF3Config.tiny() target, a 1-layer draft with a smaller vocabulary,
so clamp and pad run): greedy generate_speculative token-exact with JAX's and with plain
generate at k = 1, 2, 4, the target as its own draft, audio in the prompt, flash on; the
sampled rule's law (speculative_accept, the greedy limit, the first token's marginal,
the second token's conditional marginal, one seed one answer); rounds after done change
no tensor; load_draft on a tiny HF Qwen2 checkpoint (tied and untied, float and int8)
against JAX's; AudioFlamingo.generate with a draft against JAX's API."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu import api as japi
from audio_flamingo_tpu.config import AF3Config as JAF3Config
from audio_flamingo_tpu.config import Qwen2Config as JQwen2Config
from audio_flamingo_tpu.io.safetensors import save_safetensors
from audio_flamingo_tpu.models import af3 as jaf3
from audio_flamingo_tpu.models import qwen2 as jqwen2
from audio_flamingo_tpu.ops import sampling as js
from audio_flamingo_tpu.runtime import speculative as jspec
from audio_flamingo_tpu_torch import api
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.api import AudioFlamingo
from audio_flamingo_tpu_torch.io.convert import lm_params_from_jax, params_from_jax
from audio_flamingo_tpu_torch.models import af3, qwen2
from audio_flamingo_tpu_torch.ops.sampling import SamplingParams
from audio_flamingo_tpu_torch.runtime import generate as gen
from audio_flamingo_tpu_torch.runtime import speculative as sp
from audio_flamingo_tpu_torch.runtime.tokenizer import BBPETokenizer

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

JCFG = JAF3Config.tiny()
JDRAFT = JQwen2Config(vocab_size=448, hidden_size=32, intermediate_size=64, num_layers=1,
                      num_heads=4, num_kv_heads=2, tie_word_embeddings=True)
MAX_NEW = 14
LOGITS_TOL = 1e-4


def _pick(cls, obj):
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})


def _port_cfg(j):
    return C.AF3Config(encoder=_pick(C.WhisperEncoderConfig, j.encoder),
                       lm=_pick(C.Qwen2Config, j.lm), audio_token_id=j.audio_token_id)


def _float_lm(cfg: C.Qwen2Config, state: dict) -> qwen2.Qwen2:
    lm = qwen2.Qwen2(cfg, dtype=torch.float32)
    lm.load_state_dict(state)
    return lm.eval().requires_grad_(False)


def lively(lm: dict) -> dict:
    """The LM's layer linears times 3: the tiny random LM then emits varied tokens instead
    of repeating one (a tied embedding's attractor)."""
    layers = lm["layers"]
    for name in ("q", "k", "v", "o"):
        layers[name]["w"] = layers[name]["w"] * 3.0
    layers["mlp"] = {k: v * 3.0 for k, v in layers["mlp"].items()}
    return lm


@pytest.fixture(scope="module")
def models():
    params = jax.tree.map(np.asarray, jaf3.init(jax.random.PRNGKey(0), JCFG))
    params["lm"] = lively(params["lm"])
    jdraft = jax.tree.map(np.asarray, jqwen2.init(jax.random.PRNGKey(7), JDRAFT))
    cfg = _port_cfg(JCFG)
    model = af3.build(cfg, "cpu", torch.float32)
    model.load_state_dict(params_from_jax(params, cfg))
    dcfg = _pick(C.Qwen2Config, JDRAFT)
    draft = _float_lm(dcfg, lm_params_from_jax(jdraft, dcfg))
    return dict(params=params, jdraft=jdraft, cfg=cfg, model=model, dcfg=dcfg, draft=draft)


def _ids(seed, n):
    return np.random.default_rng(seed).integers(0, 500, (1, n)).astype(np.int32)


def _audio_case():
    rng = np.random.default_rng(3)
    n_audio = JCFG.encoder.max_source_positions // JCFG.encoder.pool_stride
    ids = np.concatenate([rng.integers(0, 400, (1, 3)), np.full((1, n_audio), JCFG.audio_token_id),
                          rng.integers(0, 400, (1, 4))], axis=1).astype(np.int32)
    mels = rng.normal(size=(1, 1, 2 * JCFG.encoder.max_source_positions,
                            JCFG.encoder.num_mel_bins)).astype(np.float32)
    return ids, mels


def _plain(m, ids, mels=None, cfg=None, eos=-1, max_new=MAX_NEW):
    out = gen.generate(m["model"], cfg or m["cfg"], torch.from_numpy(ids).long(),
                       None if mels is None else torch.from_numpy(mels),
                       max_new_tokens=max_new, eos_token_id=eos)
    return out.tokens[0, : int(out.lengths[0])].tolist()


def _port(m, ids, mels=None, draft=None, dcfg=None, cfg=None, max_new=MAX_NEW, **kw):
    out = sp.generate_speculative(m["model"], cfg or m["cfg"], draft or m["draft"],
                                  dcfg or m["dcfg"], torch.from_numpy(ids).long(),
                                  None if mels is None else torch.from_numpy(mels),
                                  max_new_tokens=max_new, **kw)
    return out.tokens[0, : int(out.lengths[0])].tolist(), out


def _jax(m, ids, mels=None, draft=None, dcfg=None, cfg=JCFG, max_new=MAX_NEW, k=4, eos=-1):
    out, n = jspec.generate_speculative(
        m["params"], m["jdraft"] if draft is None else draft, cfg, dcfg or JDRAFT,
        jnp.asarray(ids), None if mels is None else jnp.asarray(mels), k=k,
        max_new_tokens=max_new, eos_token_id=eos, compute_dtype=jnp.float32)
    return np.asarray(out)[0][: int(n[0])].tolist()


@pytest.fixture(scope="module")
def eos(models):
    """A token the plain greedy run emits mid-sequence, so the EOS cut is exercised."""
    return _plain(models, _ids(0, 9))[6]


@pytest.fixture(scope="module")
def jax_refs(models, eos):
    """JAX's generate_speculative on every case the tests hold the port to."""
    m = models
    audio_ids, mels = _audio_case()
    return {
        **{("small", k): _jax(m, _ids(0, 9), k=k, eos=eos) for k in (1, 2, 4)},
        "perfect": _jax(m, _ids(1, 7), draft=m["params"]["lm"], dcfg=JCFG.lm, k=4),
        "audio": _jax(m, audio_ids, mels, k=3),
        "flash": _jax(m, _ids(4, 40), k=3),
    }


@pytest.mark.parametrize("k", [1, 2, 4])
def test_greedy_matches_jax_and_plain_generate(models, jax_refs, eos, k):
    got, out = _port(models, _ids(0, 9), k=k, eos_token_id=eos)
    assert got == jax_refs[("small", k)]
    assert got == _plain(models, _ids(0, 9), eos=eos)
    assert got[-1] == eos and len(got) < MAX_NEW        # cut at the EOS, included
    assert out.rounds >= 1 and 0.0 <= out.acceptance <= 1.0


def test_target_as_its_own_draft_accepts_everything(models, jax_refs):
    m = models
    got, out = _port(m, _ids(1, 7), draft=m["model"].lm, dcfg=m["cfg"].lm, k=4)
    assert got == jax_refs["perfect"] == _plain(m, _ids(1, 7))
    assert out.acceptance == 1.0 and out.rounds == -(-(MAX_NEW - 1) // 5)


def test_audio_in_the_prompt(models, jax_refs):
    ids, mels = _audio_case()
    got, _ = _port(models, ids, mels, k=3)
    assert got == jax_refs["audio"] == _plain(models, ids, mels)


def test_flash_prefill(models, jax_refs):
    """Both prefills through the flash kernel's plain version; the verify (k + 1 tokens
    against a warm cache) must not take it. JAX's reference runs without flash."""
    m = models
    cfg = dataclasses.replace(m["cfg"], lm=dataclasses.replace(m["cfg"].lm, use_flash=True))
    dcfg = dataclasses.replace(m["dcfg"], use_flash=True)
    got, _ = _port(m, _ids(4, 40), cfg=cfg, dcfg=dcfg, k=3)
    assert got == jax_refs["flash"] == _plain(m, _ids(4, 40), cfg=cfg)


def test_clamp_and_pad():
    tok = torch.tensor([3, 447, 448, 511])
    assert sp.clamp_draft_tokens(tok, C.Qwen2Config(vocab_size=448)).tolist() == [3, 447, 447, 447]
    p = torch.rand(2, 448)
    padded = sp.pad_draft_probs(p, 512)
    assert padded.shape == (2, 512) and torch.equal(padded[:, :448], p)
    assert not padded[:, 448:].any()
    np.testing.assert_array_equal(padded.numpy(), np.asarray(jspec.pad_draft_probs(
        jnp.asarray(p.numpy()), 512)))
    with pytest.raises(ValueError, match="exceeds"):
        sp.pad_draft_probs(torch.rand(1, 600), 512)


# ------------------------------------------------------------------ the sampled rule's law

def test_speculative_accept_preserves_the_target_law():
    rng = np.random.default_rng(0)
    v = 8
    p_t = torch.from_numpy(rng.dirichlet(np.ones(v)).astype(np.float32))
    p_d = torch.from_numpy(rng.dirichlet(np.ones(v)).astype(np.float32))
    accept = torch.minimum(p_t, p_d)
    residual = (p_t - p_d).clamp(min=0)
    marginal = accept + (1 - accept.sum()) * residual / residual.sum()
    np.testing.assert_allclose(marginal.numpy(), p_t.numpy(), atol=1e-6)
    n = 40_000
    g = torch.Generator().manual_seed(1)
    proposals = sp.categorical(torch.log(p_d).expand(n, v), g)
    toks, _ = sp.speculative_accept(p_t, p_d, proposals, g)
    counts = np.bincount(toks.numpy(), minlength=v) / n
    np.testing.assert_allclose(counts, p_t.numpy(), atol=0.02)


def test_warped_probs_match_jax():
    logits = np.random.default_rng(2).normal(size=(3, 64)).astype(np.float32) * 3
    for sampling in (SamplingParams(greedy=False, temperature=0.7, top_p=0.9),
                     SamplingParams(greedy=False, temperature=1.3, top_k=20)):
        want = np.asarray(jspec._warped_probs(jnp.asarray(logits),
                                              js.SamplingParams(**sampling._asdict())))
        got = sp._warped_probs(torch.from_numpy(logits), sampling).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_sampled_greedy_limit(models, jax_refs):
    got, _ = _port(models, _ids(0, 9), k=3, eos_token_id=-1,
                   sampling=SamplingParams(greedy=False, temperature=1e-4),
                   generator=torch.Generator().manual_seed(0))
    want, _ = _port(models, _ids(0, 9), k=3)
    assert got == want == _plain(models, _ids(0, 9))


def test_sampled_first_token_marginal(models):
    m = models
    sampling = SamplingParams(greedy=False, temperature=1.3, top_k=20)
    ids = _ids(3, 5)
    _, logits = gen.prefill(m["model"], m["cfg"], torch.from_numpy(ids).long(), None, 128)
    expected = sp._warped_probs(logits.float(), sampling)[0].numpy()
    g = torch.Generator().manual_seed(4)
    firsts = [_port(m, ids, k=2, max_new=1, sampling=sampling, generator=g)[0][0]
              for _ in range(400)]
    emp = np.bincount(firsts, minlength=512) / len(firsts)
    assert 0.5 * np.abs(emp - expected).sum() < 0.14


def test_sampled_second_token_conditional_marginal(models):
    """The second token goes through one round (draft draw, accept or residual draw): its
    law given the first token is the warped target's at that prefix."""
    m = models
    sampling = SamplingParams(greedy=False, temperature=0.8, top_k=4)
    spec = sp.SpecSpec(2, 2, -1, sampling)
    ids = torch.from_numpy(_ids(6, 5)).long()
    g = torch.Generator().manual_seed(8)
    st = sp.new_state(m["cfg"].lm, m["dcfg"], spec, 128, torch.float32, torch.float32, "cpu", g)
    firsts = torch.tensor([int(torch.argmax(sp.start(m["model"], m["cfg"], m["draft"],
                                                     m["dcfg"], spec, st, ids, None, g)))])
    # condition on the argmax first token: every trial starts from the same state
    sp.begin(st, spec, firsts, ids.shape[1])
    snap = {n: t.clone() for n, t in vars(st).items() if isinstance(t, torch.Tensor)}
    caches = [(c.k.clone(), c.v.clone()) for c in (st.t_cache, st.d_cache)]
    seconds = []
    for _ in range(600):
        for n, t in snap.items():
            getattr(st, n).copy_(t)
        for c, (k0, v0) in zip((st.t_cache, st.d_cache), caches):
            c.k.copy_(k0)
            c.v.copy_(v0)
            c.index.fill_(ids.shape[1])
        sp.spec_body(m["model"].lm, m["cfg"].lm, m["draft"], m["dcfg"], spec, st)
        seconds.append(int(st.out[0, 1]))
    full = torch.cat([ids, firsts[None]], dim=1)
    logits = af3.logits(m["model"], m["cfg"], full)[:, -1]
    expected = sp._warped_probs(logits, sampling)[0].numpy()
    emp = np.bincount(seconds, minlength=512) / len(seconds)
    assert 0.5 * np.abs(emp - expected).sum() < 0.1


def test_sampled_one_seed_one_answer(models):
    kw = dict(k=3, sampling=SamplingParams(greedy=False, temperature=0.9, top_p=0.95))
    a, _ = _port(models, _ids(5, 6), generator=torch.Generator().manual_seed(9), **kw)
    b, _ = _port(models, _ids(5, 6), generator=torch.Generator().manual_seed(9), **kw)
    assert a == b


def test_rounds_after_done_change_no_tensor(models):
    m = models
    for sampling in (SamplingParams(), SamplingParams(greedy=False, temperature=0.9)):
        spec = sp.SpecSpec(3, 9, -1, sampling)
        g = torch.Generator().manual_seed(2)
        st = sp.new_state(m["cfg"].lm, m["dcfg"], spec, 128, torch.float32, torch.float32,
                          "cpu", g)
        sp.start(m["model"], m["cfg"], m["draft"], m["dcfg"], spec, st,
                 torch.from_numpy(_ids(2, 8)).long(), None, g)
        body = lambda: sp.spec_body(m["model"].lm, m["cfg"].lm, m["draft"], m["dcfg"], spec, st)
        while not bool(st.done):
            body()
        snap = [t.clone() for t in (st.cur, st.position, st.out, st.n_out, st.done, st.rounds,
                                    *(x for c in (st.t_cache, st.d_cache)
                                      for x in (c.k, c.v, c.index)))]
        for _ in range(3):
            body()
        after = [st.cur, st.position, st.out, st.n_out, st.done, st.rounds,
                 *(x for c in (st.t_cache, st.d_cache) for x in (c.k, c.v, c.index))]
        assert all(torch.equal(a, b) for a, b in zip(snap, after))


def test_refusals(models):
    m = models
    ids = torch.from_numpy(_ids(0, 5)).long()
    with pytest.raises(ValueError, match="batch 1"):
        sp.generate_speculative(m["model"], m["cfg"], m["draft"], m["dcfg"], ids.repeat(2, 1))
    with pytest.raises(ValueError, match="repetition"):
        sp.generate_speculative(m["model"], m["cfg"], m["draft"], m["dcfg"], ids,
                                sampling=SamplingParams(repetition_penalty=1.2))
    with pytest.raises(ValueError, match="cannot take"):
        sp.generate_speculative(m["model"], m["cfg"], m["draft"], m["dcfg"], ids, capacity=16,
                                max_new_tokens=12)


# ------------------------------------------------------------------ load_draft and the API

def _hf_checkpoint(path, tied: bool):
    """A tiny HF Qwen2 CausalLM directory written from numpy: config.json and
    model.safetensors."""
    rng = np.random.default_rng(11 if tied else 12)
    v, d, f, n_layers, nh, nkv = 448, 32, 64, 2, 4, 2
    hd = d // nh
    w = lambda *s: (rng.normal(size=s) * 0.3).astype(np.float32)
    sd = {"model.embed_tokens.weight": w(v, d), "model.norm.weight": 1 + w(d)}
    for i in range(n_layers):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": 1 + w(d),
                   p + "post_attention_layernorm.weight": 1 + w(d),
                   p + "self_attn.q_proj.weight": w(nh * hd, d), p + "self_attn.q_proj.bias": w(nh * hd),
                   p + "self_attn.k_proj.weight": w(nkv * hd, d), p + "self_attn.k_proj.bias": w(nkv * hd),
                   p + "self_attn.v_proj.weight": w(nkv * hd, d), p + "self_attn.v_proj.bias": w(nkv * hd),
                   p + "self_attn.o_proj.weight": w(d, nh * hd),
                   p + "mlp.gate_proj.weight": w(f, d), p + "mlp.up_proj.weight": w(f, d),
                   p + "mlp.down_proj.weight": w(d, f)})
    if not tied:
        sd["lm_head.weight"] = w(v, d)
    path.mkdir()
    save_safetensors(str(path / "model.safetensors"), sd)
    cfg = dict(vocab_size=v, hidden_size=d, intermediate_size=f, num_hidden_layers=n_layers,
               num_attention_heads=nh, num_key_value_heads=nkv, rope_theta=10000.0)
    if tied:
        cfg["tie_word_embeddings"] = True
    (path / "config.json").write_text(json.dumps(cfg))
    return str(path)


@pytest.mark.parametrize("tied", [True, False])
def test_load_draft_matches_jax(tmp_path, tied):
    path = _hf_checkpoint(tmp_path / "draft", tied)
    ids = _ids(9, 11) % 448
    for quantize in (False, True):
        jparams, jcfg = japi.load_draft(path, jnp.float32, quantize=quantize)
        want = np.asarray(jqwen2.logits_from_ids(jparams, jcfg, jnp.asarray(ids)))
        lm, cfg = api.load_draft(path, torch.float32, quantize=quantize, device="cpu")
        assert cfg == _pick(C.Qwen2Config, jcfg)
        assert isinstance(lm, qwen2.QuantQwen2) == quantize
        assert (lm.lm_head is None if not quantize else "lm_head" not in lm) == tied
        x = qwen2.embed(lm, torch.from_numpy(ids).long())
        pos = torch.arange(ids.shape[1])[None]
        got = qwen2.unembed(lm, qwen2.forward(lm, cfg, x, pos)[0]).numpy()
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=LOGITS_TOL * scale, rtol=0)


@pytest.fixture(scope="module")
def apis(models):
    jm = japi.AudioFlamingo.from_random(compute_dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jm.params)
    cfg = _port_cfg(jm.cfg)
    tok = BBPETokenizer(jm.processor.tokenizer.vocab, jm.processor.tokenizer.merges)
    tm = AudioFlamingo.from_state_dict(cfg, params_from_jax(params, cfg), tok,
                                       compute_dtype=torch.float32, device="cpu")
    jm = dataclasses.replace(jm, draft_params=models["jdraft"], draft_cfg=JDRAFT, spec_k=3)
    tm = dataclasses.replace(tm, draft=models["draft"], draft_cfg=models["dcfg"], spec_k=3)
    return jm, tm


def test_api_generate_with_a_draft_matches_jax(apis):
    jm, tm = apis
    for sampling in (SamplingParams(), SamplingParams(greedy=False, temperature=1e-4)):
        want = jm.generate(prompt="describe the sound", max_new_tokens=10,
                           sampling=js.SamplingParams(**sampling._asdict()))
        got = tm.generate(prompt="describe the sound", max_new_tokens=10, sampling=sampling)
        assert got == want and tm.last_output is None and tm.last_spec.rounds >= 1
    plain = dataclasses.replace(tm, draft=None).generate(prompt="describe the sound",
                                                         max_new_tokens=10)
    assert got == plain
    tm.reset_chat()
    tm.generate(prompt="first", chat=True, max_new_tokens=3)
    tm.generate(prompt="second", chat=True, max_new_tokens=3)
    assert [h["role"] for h in tm.history] == ["user", "assistant"] * 2
    tm.reset_chat()
