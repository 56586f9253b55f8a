"""Speculation on the port's serving engines against the JAX package at f32 on the same
numpy-seeded weights (AF3Config.tiny() target, a 1-layer draft with a smaller vocabulary):
BatchEngine with a perfect and a random draft token-exact with JAX's engine and with
plain generate, slot reuse, spec_accept_sim at a = 0 and 1 (certain draws: JAX's tokens
exactly), the live acceptance estimate, the guard switching off a bad draft and leaving a
good one alone, sampled speculation in its greedy limit; merge_block_tokens and
paged_verify_step (f32, bf16 and int8 pools) against JAX's; PagedEngine with a draft
against JAX's engine and its own plain path (the int8 pool, accept_sim, the prefix cache,
chunked prefill, a fused-w4 target, the sampled greedy limit); K3's plan and parts at the
verify's folded groups and the parts' plain model there against the reference."""

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
from audio_flamingo_tpu.ops import sampling as js
from audio_flamingo_tpu.ops.pallas import paged_attention as jpa
from audio_flamingo_tpu.ops.quant4 import quantize_lm_params_w4 as jquantize_w4
from audio_flamingo_tpu.runtime import engine as jengine
from audio_flamingo_tpu.runtime import paged_cache as jpc
from audio_flamingo_tpu.runtime.paged_engine import PagedEngine as JPagedEngine
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.io.convert import lm_params_from_jax, params_from_jax
from audio_flamingo_tpu_torch.models import af3, qwen2
from audio_flamingo_tpu_torch.ops.kernels import paged_attention as pa
from audio_flamingo_tpu_torch.ops.sampling import SamplingParams
from audio_flamingo_tpu_torch.runtime import engine
from audio_flamingo_tpu_torch.runtime import generate as gen
from audio_flamingo_tpu_torch.runtime import paged_cache as pc
from audio_flamingo_tpu_torch.runtime.paged_engine import PagedEngine

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

JCFG = JAF3Config.tiny()
JDRAFT = JQwen2Config(vocab_size=448, hidden_size=32, intermediate_size=64, num_layers=1,
                      num_heads=4, num_kv_heads=2, tie_word_embeddings=True)
MAX_NEW = 12
SPEC = dict(spec_k=3, spec_rounds=2)
SLOTS = dict(num_slots=2, capacity=128)
PAGES = dict(num_rows=2, num_blocks=40, block_size=16, max_blocks_per_seq=8, chunk=4,
             preempt=False)
GREEDY_LIMIT = SamplingParams(greedy=False, temperature=1e-4)
VERIFY_TOL = 1e-4          # paged_verify_step logits, relative to max|logit|


def _pick(cls, obj):
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})


def lively(lm: dict) -> dict:
    """The LM's layer linears times 3, so the tiny random LM emits varied tokens."""
    layers = lm["layers"]
    for name in ("q", "k", "v", "o"):
        layers[name]["w"] = layers[name]["w"] * 3.0
    layers["mlp"] = {k: v * 3.0 for k, v in layers["mlp"].items()}
    return lm


@pytest.fixture(scope="module")
def m():
    params = jax.tree.map(np.asarray, jaf3.init(jax.random.PRNGKey(0), JCFG))
    params["lm"] = lively(params["lm"])
    jdraft = jax.tree.map(np.asarray, jqwen2.init(jax.random.PRNGKey(7), JDRAFT))
    cfg = C.AF3Config(encoder=_pick(C.WhisperEncoderConfig, JCFG.encoder),
                      lm=_pick(C.Qwen2Config, JCFG.lm), audio_token_id=JCFG.audio_token_id)
    model = af3.build(cfg, "cpu", torch.float32)
    model.load_state_dict(params_from_jax(params, cfg))
    dcfg = _pick(C.Qwen2Config, JDRAFT)
    draft = qwen2.Qwen2(dcfg, dtype=torch.float32)
    draft.load_state_dict(lm_params_from_jax(jdraft, dcfg))
    prompts = [np.random.default_rng(i).integers(0, 500, (1, 5 + 2 * i)).astype(np.int32)
               for i in range(4)]
    out = gen.generate(model, cfg, torch.from_numpy(prompts[0]).long(), max_new_tokens=8)
    eos = int(out.tokens[0, 5])      # a token the plain run emits: the EOS cut runs
    return dict(params=params, jdraft=jdraft, cfg=cfg, model=model, dcfg=dcfg, draft=draft,
                prompts=prompts, eos=eos)


def _drafts(m, perfect: bool):
    """(port draft, its cfg, JAX draft, its cfg)."""
    if perfect:
        return m["model"].lm, m["cfg"].lm, m["params"]["lm"], JCFG.lm
    return m["draft"], m["dcfg"], m["jdraft"], JDRAFT


def _port_run(m, cls, settings, prompts=None, model=None, **kw):
    eng = cls(model=model or m["model"], cfg=m["cfg"], eos_token_id=m["eos"], device="cpu",
              **settings, **kw)
    for i, p in enumerate(m["prompts"] if prompts is None else prompts):
        eng.submit(engine.Request(request_id=f"r{i}", ids=p, max_new_tokens=MAX_NEW))
    return eng.run_until_done(), eng


def _jax_run(m, cls, settings, prompts=None, params=None, sampling=None, **kw):
    sampling = js.SamplingParams(**(sampling or SamplingParams())._asdict())
    eng = cls(params=params or m["params"], cfg=JCFG, eos_token_id=m["eos"],
              sampling=sampling, compute_dtype=jnp.float32, **settings, **kw)
    for i, p in enumerate(m["prompts"] if prompts is None else prompts):
        eng.submit(jengine.Request(request_id=f"r{i}", ids=p, max_new_tokens=MAX_NEW))
    return eng.run_until_done(), eng


def _plain_generate(m, prompts=None):
    out = {}
    for i, p in enumerate(m["prompts"] if prompts is None else prompts):
        r = gen.generate(m["model"], m["cfg"], torch.from_numpy(p).long(),
                         max_new_tokens=MAX_NEW, eos_token_id=m["eos"])
        out[f"r{i}"] = r.tokens[0, : int(r.lengths[0])].tolist()
    return out


@pytest.fixture(scope="module")
def slot_refs(m):
    """JAX's BatchEngine on the slot cases, every one at SLOTS and SPEC."""
    refs = {}
    for perfect in (True, False):
        _, _, jd, jdc = _drafts(m, perfect)
        res, eng = _jax_run(m, jengine.BatchEngine, SLOTS, draft_params=jd, draft_cfg=jdc,
                            spec_guard=False, **SPEC)
        refs[perfect] = (res, eng.spec_stats)
    _, _, jd, jdc = _drafts(m, False)
    refs["reuse"] = _jax_run(m, jengine.BatchEngine, dict(SLOTS, num_slots=1),
                             draft_params=jd, draft_cfg=jdc, **SPEC)[0]
    for a in (0.0, 1.0):
        refs[("sim", a)] = _jax_run(m, jengine.BatchEngine, SLOTS, draft_params=jd,
                                    draft_cfg=jdc, spec_accept_sim=a, spec_guard=False,
                                    **SPEC)[0]
    res, eng = _jax_run(m, jengine.BatchEngine, SLOTS, draft_params=jd, draft_cfg=jdc,
                        spec_guard_warmup=8, **SPEC)
    refs["guard"] = (res, eng.spec_stats, eng.spec_disabled)
    return refs


# ------------------------------------------------------------------------- BatchEngine

@pytest.mark.parametrize("perfect", [True, False], ids=["perfect-draft", "random-draft"])
def test_slot_engine_matches_jax_and_plain(m, slot_refs, perfect):
    draft, dcfg, _, _ = _drafts(m, perfect)
    got, eng = _port_run(m, engine.BatchEngine, SLOTS, draft_params=draft, draft_cfg=dcfg,
                         spec_guard=False, **SPEC)
    want, jstats = slot_refs[perfect]
    assert got == want == _plain_generate(m)
    assert eng.spec_stats == jstats                       # emitted, round slots, estimate
    if perfect:
        assert eng.spec_stats["acceptance_est"] > 0.5
    assert any(m["eos"] in toks for toks in got.values())


def test_slot_reuse(m, slot_refs):
    got, _ = _port_run(m, engine.BatchEngine, dict(SLOTS, num_slots=1), draft_params=m["draft"],
                       draft_cfg=m["dcfg"], **SPEC)
    assert got == slot_refs["reuse"] == _plain_generate(m)


@pytest.mark.parametrize("a", [0.0, 1.0])
def test_accept_sim_matches_jax(m, slot_refs, a):
    got, eng = _port_run(m, engine.BatchEngine, SLOTS, draft_params=m["draft"],
                         draft_cfg=m["dcfg"], spec_accept_sim=a, spec_guard=False, **SPEC)
    assert got == slot_refs[("sim", a)]
    per_round = eng.spec_stats["emitted"] / eng.spec_stats["round_slots"]
    assert per_round <= 1.0 if a == 0.0 else per_round > 2.0


def test_guard_switches_a_bad_draft_off(m, slot_refs):
    got, eng = _port_run(m, engine.BatchEngine, SLOTS, draft_params=m["draft"],
                         draft_cfg=m["dcfg"], spec_guard_warmup=8, **SPEC)
    want, jstats, jdisabled = slot_refs["guard"]
    assert got == want == _plain_generate(m)
    assert eng.spec_disabled and jdisabled and eng.spec_stats == jstats
    assert eng.spec_stats["round_slots"] <= 8 + 2 * eng.spec_rounds
    assert not engine.speculating(eng)


def test_guard_leaves_a_good_draft_alone(m):
    got, eng = _port_run(m, engine.BatchEngine, SLOTS, draft_params=m["model"].lm,
                         draft_cfg=m["cfg"].lm, spec_guard_warmup=4, **SPEC)
    assert not eng.spec_disabled and "guard_disabled" not in eng.spec_stats
    assert got == _plain_generate(m)


def test_sampled_speculation_greedy_limit(m, slot_refs):
    got, eng = _port_run(m, engine.BatchEngine, SLOTS, draft_params=m["draft"],
                         draft_cfg=m["dcfg"], sampling=GREEDY_LIMIT, spec_guard=False, **SPEC)
    assert engine.speculating(eng) and not eng.sampling.greedy
    assert got == slot_refs[False][0]


def test_refusals(m):
    eng = engine.BatchEngine(model=m["model"], cfg=m["cfg"], device="cpu",
                             draft_params=m["draft"], draft_cfg=m["dcfg"], **SLOTS)
    ids = m["prompts"][0]
    for kw, msg in ((dict(sampling=SamplingParams(greedy=False)), "greedy-only"),
                    (dict(min_new_tokens=2), "not supported"),
                    (dict(stop=[[1, 2]]), "not supported"), (dict(logprobs=True), "not supported")):
        with pytest.raises(ValueError, match=msg):
            eng.submit(engine.Request(request_id="x", ids=ids, **kw))
    with pytest.raises(ValueError, match="draft_cfg"):
        engine.BatchEngine(model=m["model"], cfg=m["cfg"], device="cpu",
                           draft_params=m["draft"])
    with pytest.raises(ValueError, match="preempt=False"):
        PagedEngine(model=m["model"], cfg=m["cfg"], device="cpu", draft_params=m["draft"],
                    draft_cfg=m["dcfg"])


# ------------------------------------------------------------------- the paged verify

def test_merge_block_tokens_matches_jax():
    rng = np.random.default_rng(0)
    b, s, nkv, g, hd = 2, 3, 2, 2, 8
    arrs = dict(q=(b, s, nkv, g, hd), k=(b, s, nkv, hd), v=(b, s, nkv, hd),
                o=(b, s, nkv, g, hd), m=(b, s, nkv, g), l=(b, s, nkv, g))
    x = {n: rng.normal(size=shape).astype(np.float32) for n, shape in arrs.items()}
    x["l"] = np.abs(x["l"]) + 0.5
    x["m"][0, :, 0, 0] = pa.NEG_INF            # a row with no past key
    x["l"][0, :, 0, 0] = 0.0
    x["o"][0, :, 0, 0] = 0.0
    want = np.asarray(jpa.merge_block_tokens(*(jnp.asarray(x[n]) for n in "qkvoml")))
    got = pa.merge_block_tokens(*(torch.from_numpy(x[n]) for n in "qkvoml")).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _verify_case(cfg, pool: str, seed=3):
    """Pools of a 2-layer LM with rows of 13 and 37 tokens, shuffled tables, 4 fresh tokens a
    row; JAX's PagedKV and the port's, from the same numpy arrays."""
    rng = np.random.default_rng(seed)
    n_layers, nb, bs, nkv, hd = cfg.num_layers, 12, 16, cfg.num_kv_heads, cfg.resolved_head_dim()
    shape = (n_layers, nb, bs, nkv, hd)
    tables = np.full((2, 5), -1, np.int32)
    tables[0, :2] = [3, 7]
    tables[1, :4] = [1, 9, 4, 10]
    lengths = np.array([13, 37], np.int32)
    tokens = rng.integers(0, 500, (2, 4)).astype(np.int32)
    if pool == "int8":
        k, v = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
        ks, vs = ((rng.random(shape[:-1]) * 0.02 + 0.002).astype(np.float32) for _ in range(2))
        jk = jpc.PagedKV(jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
                         jnp.asarray(lengths), jnp.asarray(ks), jnp.asarray(vs))
        tk = pc.PagedKV(*(torch.from_numpy(a.copy()) for a in (k, v, tables, lengths, ks, vs)))
        return jk, tk, tokens
    k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if pool == "bfloat16" else (jnp.float32,
                                                                          torch.float32)
    jk = jpc.PagedKV(jnp.asarray(k, jdt), jnp.asarray(v, jdt), jnp.asarray(tables),
                     jnp.asarray(lengths))
    tk = pc.PagedKV(torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt),
                    torch.from_numpy(tables), torch.from_numpy(lengths))
    return jk, tk, tokens


@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8"])
def test_paged_verify_step_matches_jax(m, pool):
    jcache, tcache, tokens = _verify_case(m["cfg"].lm, pool)
    before = {n: getattr(tcache, n).clone() for n in ("k", "v", "k_scale", "v_scale")
              if getattr(tcache, n) is not None}
    jnew, jlogits = jpc.paged_verify_step(m["params"]["lm"], JCFG.lm, jcache,
                                          jnp.asarray(tokens), compute_dtype=jnp.float32,
                                          use_kernel=False)
    tnew, tlogits = pc.paged_verify_step(m["model"].lm, m["cfg"].lm, tcache,
                                         torch.from_numpy(tokens).long())
    want = np.asarray(jlogits)
    np.testing.assert_allclose(tlogits.numpy(), want, atol=VERIFY_TOL * np.abs(want).max(),
                               rtol=0)
    assert torch.equal(tnew.lengths, torch.tensor([13, 37], dtype=torch.int32))
    for name, old in before.items():
        got = getattr(tnew, name).float().numpy()
        ref = np.asarray(getattr(jnew, name)).astype(np.float32)
        written = (got != old.float().numpy()) | (ref != old.float().numpy())
        assert written.any()
        if pool == "int8" and name in ("k", "v"):        # codes: at most one step apart
            assert np.abs(got - ref).max() <= 1 and (got == ref).mean() > 0.99
        else:
            tol = 2 ** -8 if pool == "bfloat16" and name in ("k", "v") else 1e-5
            np.testing.assert_allclose(got, ref, atol=tol * np.abs(ref).max(), rtol=0)
        np.testing.assert_array_equal(got[~written], old.float().numpy()[~written])


# ------------------------------------------------------------------------- PagedEngine

@pytest.fixture(scope="module")
def paged_refs(m):
    refs = {}
    for perfect in (True, False):
        _, _, jd, jdc = _drafts(m, perfect)
        refs[perfect] = _jax_run(m, JPagedEngine, PAGES, draft_params=jd, draft_cfg=jdc,
                                 spec_guard=False, **SPEC)[0]
    return refs


@pytest.mark.parametrize("perfect", [True, False], ids=["perfect-draft", "random-draft"])
def test_paged_engine_matches_jax_and_plain(m, paged_refs, perfect):
    draft, dcfg, _, _ = _drafts(m, perfect)
    got, eng = _port_run(m, PagedEngine, PAGES, draft_params=draft, draft_cfg=dcfg,
                         spec_guard=False, **SPEC)
    assert got == paged_refs[perfect] == _plain_generate(m)
    assert len(eng.allocator.free) == eng.num_blocks - 1


@pytest.mark.parametrize("case", ["int8-pool", "prefix-cache", "chunked-prefill",
                                  "sampled-greedy-limit"])
def test_paged_engine_options_keep_the_plain_tokens(m, case):
    kw = {"int8-pool": dict(kv_dtype=torch.int8),
          "prefix-cache": dict(prefix_cache=True),
          "chunked-prefill": dict(prefill_chunk=16),
          "sampled-greedy-limit": {}}[case]
    rng = np.random.default_rng(5)
    shared = rng.integers(0, 500, (1, 32)).astype(np.int32)
    prompts = [shared, np.concatenate([shared, rng.integers(0, 500, (1, 4)).astype(np.int32)],
                                      axis=1), rng.integers(0, 500, (1, 40)).astype(np.int32)]
    plain, _ = _port_run(m, PagedEngine, PAGES, prompts, **kw)
    spec_kw = dict(sampling=GREEDY_LIMIT) if case == "sampled-greedy-limit" else {}
    got, eng = _port_run(m, PagedEngine, PAGES, prompts, draft_params=m["draft"],
                         draft_cfg=m["dcfg"], spec_guard=False, **SPEC, **kw, **spec_kw)
    assert got == plain
    if case == "prefix-cache":
        assert eng.store.hits > 0
    if case != "int8-pool":
        assert got == _plain_generate(m, prompts)


@pytest.mark.parametrize("a", [0.0, 1.0])
def test_paged_accept_sim_equals_the_slot_engine(m, slot_refs, a):
    got, _ = _port_run(m, PagedEngine, PAGES, draft_params=m["draft"], draft_cfg=m["dcfg"],
                       spec_accept_sim=a, spec_guard=False, **SPEC)
    assert got == slot_refs[("sim", a)]


def test_paged_engine_fused_w4_target(m):
    w4 = jquantize_w4(jax.tree.map(jnp.asarray, m["params"]["lm"]), group_size=32)
    assert "qkv" in w4["layers"]
    cfg = m["cfg"]
    tree = qwen2.unflatten(lm_params_from_jax(jax.tree.map(np.asarray, w4), cfg.lm))
    model = af3.build(cfg, "cpu", torch.float32, lm=qwen2.quantized_lm(tree, torch.float32,
                                                                       "cpu"))
    model.encoder.load_state_dict(m["model"].encoder.state_dict())
    model.adaptor.load_state_dict(m["model"].adaptor.state_dict())
    prompts = m["prompts"][:2]
    plain, _ = _port_run(m, PagedEngine, PAGES, prompts, model=model)
    got, _ = _port_run(m, PagedEngine, PAGES, prompts, model=model, draft_params=m["draft"],
                       draft_cfg=m["dcfg"], spec_guard=False, **SPEC)
    assert got == plain


# ------------------------------------------------------------------ K3 at folded groups

@pytest.mark.parametrize("g", [35, 64])
def test_k3_plan_and_parts_at_verify_groups(g):
    assert g <= pa.KERNEL_MAX_GROUP
    pl = pa.plan(4, 4, g, 128, 128, 32, pa.parts_for(4, 4, 32, 132, 1))
    bkg = 4 * 4 * g
    assert pl.scores == bkg * 32 * 2 * 64 and pl.pmax % 4 == 0
    # the engine's rows at g' = 35: 9.2 MB of scores a call (16.8 MB at 64)
    assert pl.scores * 4 == 4 * 4 * g * 32 * 128 * 4
    q = torch.zeros((1, 1, pa.KERNEL_MAX_GROUP + 1, 128))
    pools = torch.zeros((2, 16, 1, 128))
    tables, lengths = torch.zeros((1, 1), dtype=torch.int32), torch.ones(1, dtype=torch.int32)
    assert pa.paged_attention(q, pools, pools, tables, lengths)[0].shape == q.shape  # plain


def test_k3_parts_model_at_a_folded_group():
    rng = np.random.default_rng(1)
    b, nkv, s, g, hd, bs, mp = 2, 2, 5, 7, 128, 16, 6
    q = torch.from_numpy(rng.normal(size=(b, nkv, s * g, hd)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 20, bs, nkv, hd)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 20, bs, nkv, hd)).astype(np.float32))
    tables = torch.tensor([[4, 9, 2, -1, -1, -1], [1, 3, 5, 7, 11, 13]], dtype=torch.int32)
    lengths = torch.tensor([40, 90], dtype=torch.int32)
    o_r, m_r, l_r = pa.paged_attention_reference(q, k, v, tables, lengths, 1)
    for per in (1, 2, 6):
        o, m_, l = pa.merge_parts(*pa.paged_attention_parts_plain(
            q, k, v, tables, lengths, 1, pages_per_part=per))
        np.testing.assert_allclose((o / l[..., None]).numpy(), (o_r / l_r[..., None]).numpy(),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(m_.numpy(), m_r.numpy(), atol=1e-5, rtol=0)
