"""The port's GRPO (train/grpo.py) against the JAX package at f32: group advantages (the
population std), the chunked token logprobs with T - 1 not a multiple of the chunk, the
clipped objective and its gradients, one grpo_step (trainable="lm") on a fixed rollout
against JAX's (loss, mean reward, the updated LM), rollouts through both port engines
(shapes, gen_mask, lengths, EOS), the policy sync (an engine on the policy itself, on a
same-layout copy, and the refusal of another layout), the page pool's offload round
trip, the rewards on strings, and the prefix cache across an update (both packages serve
the next rollout's prompt from the pages the old policy computed)."""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.config import AF3Config as JAF3Config
from audio_flamingo_tpu.config import Qwen2Config as JQwen2Config
from audio_flamingo_tpu.config import WhisperEncoderConfig as JEncoderConfig
from audio_flamingo_tpu.models import af3 as jaf3
from audio_flamingo_tpu.ops.quant import quantize_lm_params as j_quantize_lm_params
from audio_flamingo_tpu.ops.sampling import SamplingParams as JSamplingParams
from audio_flamingo_tpu.runtime.engine import Request as JRequest
from audio_flamingo_tpu.runtime.paged_engine import PagedEngine as JPagedEngine
from audio_flamingo_tpu.train import grpo as jgrpo
from audio_flamingo_tpu.train import train_step as jts
from audio_flamingo_tpu.train.stages import MF_STAGES as J_MF_STAGES
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.io.convert import lm_params_from_jax, params_from_jax
from audio_flamingo_tpu_torch.models import af3, qwen2
from audio_flamingo_tpu_torch.ops.sampling import SamplingParams
from audio_flamingo_tpu_torch.runtime.engine import BatchEngine, Request
from audio_flamingo_tpu_torch.runtime.paged_engine import PagedEngine
from audio_flamingo_tpu_torch.train import grpo
from audio_flamingo_tpu_torch.train import train_step as tts
from audio_flamingo_tpu_torch.train.stages import MF_STAGES

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

G, NEW = 4, 6


def _pick(cls, obj):
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})


def _port_cfg(j):
    return C.AF3Config(encoder=_pick(C.WhisperEncoderConfig, j.encoder),
                       lm=_pick(C.Qwen2Config, j.lm), audio_token_id=j.audio_token_id)


def _port_model(jcfg, params) -> af3.AF3Model:
    cfg = _port_cfg(jcfg)
    sd = params_from_jax(jax.tree.map(np.asarray, params), cfg)
    qlm = None
    if "lm.ln_f_w" in sd:
        qlm = qwen2.quantized_lm(qwen2.unflatten({k[3:]: v for k, v in sd.items()
                                                  if k.startswith("lm.")}), torch.float32, "cpu")
        sd = {k: v for k, v in sd.items() if not k.startswith("lm.")}
    model = af3.build(cfg, "cpu", torch.float32, lm=qlm)
    model.load_state_dict(sd, strict=qlm is None)
    return model


def _decode(toks) -> str:
    return " ".join(str(t) for t in toks)


def _reward(text: str) -> float:
    words = text.split()
    return len(set(w[-1] for w in words)) / max(len(words), 1)


@pytest.fixture(scope="module")
def tiny():
    """Tiny AF3, a prompt with a 30 s window of mels (8 audio positions), and
    a fixed rollout of G rows: NEW sampled-looking tokens a row, rows ending at different
    lengths (EOS 3 included in the mask)."""
    cfg = JAF3Config.tiny()
    params = jaf3.init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    t = 20
    ids = rng.integers(5, 250, (1, t)).astype(np.int32)
    ids[:, 1:9] = cfg.audio_token_id
    mels = (rng.normal(size=(1, 1, 3000, cfg.encoder.num_mel_bins)) * 0.1).astype(np.float32)
    full = np.concatenate([np.tile(ids, (G, 1)), rng.integers(5, 250, (G, NEW))], 1)
    lengths = np.array([NEW, 3, 5, 1])
    gen_mask = np.zeros(full.shape, bool)
    for i, n in enumerate(lengths):
        gen_mask[i, t: t + n] = True
        full[i, t + n - 1] = 3 if n < NEW else full[i, t + n - 1]
        full[i, t + n:] = 3
    return cfg, params, {"ids": ids, "mels": mels}, (full.astype(np.int32), gen_mask, lengths)


def test_group_advantages_match_jax():
    for r in ([1.0, 0.0, 0.5, 0.25], [0.3, 0.3, 0.3, 0.3], [2.0, -1.0]):
        want = np.asarray(jgrpo.group_advantages(jnp.asarray(r, jnp.float32)))
        got = grpo.group_advantages(torch.tensor(r)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("chunk", [8, 256])
def test_token_logp_matches_jax(tiny, chunk):
    """T - 1 = 25: three chunks of 8 and a tail of 1, or one chunk; within 1e-4."""
    jcfg, params, prompt, (full, _, _) = tiny
    mels = np.tile(prompt["mels"], (G, 1, 1, 1))
    want = np.asarray(jgrpo._token_logp(params, jcfg, jnp.asarray(full), jnp.asarray(mels),
                                        jnp.float32, chunk=chunk))
    model = _port_model(jcfg, params)
    with torch.no_grad():
        got = grpo._token_logp(model, _port_cfg(jcfg), torch.from_numpy(full).long(),
                               torch.from_numpy(mels), chunk=chunk).numpy()
    assert got.shape == want.shape == (G, full.shape[1] - 1)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def _lm_grads_jax(jcfg, params, args):
    def lm_loss(lm_p):
        return jgrpo.grpo_loss({**params, "lm": lm_p}, *args)
    loss, g = jax.value_and_grad(lm_loss)(params["lm"])
    return float(loss), jax.tree.map(np.asarray, g)


def test_grpo_loss_and_grads_match_jax(tiny):
    """The clipped objective with a KL term on off-policy logprobs (old and ref moved off
    the policy's), and its LM gradients, within 1e-4."""
    jcfg, params, prompt, (full, gen_mask, _) = tiny
    cfg = _port_cfg(jcfg)
    mels = np.tile(prompt["mels"], (G, 1, 1, 1))
    rng = np.random.default_rng(3)
    adv = np.asarray([1.2, -0.4, 0.3, -1.1], np.float32)
    lp = np.asarray(jgrpo._token_logp(params, jcfg, jnp.asarray(full), jnp.asarray(mels),
                                      jnp.float32))
    old = (lp + rng.normal(size=lp.shape) * 0.3).astype(np.float32)
    ref = (lp + rng.normal(size=lp.shape) * 0.2).astype(np.float32)
    gcfg = jgrpo.GRPOConfig(group_size=G, max_new_tokens=NEW)
    jargs = (jnp.asarray(ref), jcfg, jnp.asarray(full), jnp.asarray(mels), jnp.asarray(gen_mask),
             jnp.asarray(adv), jnp.asarray(old), gcfg, jnp.float32)
    jloss, jg = _lm_grads_jax(jcfg, params, jargs)
    want = lm_params_from_jax(jg, cfg.lm)
    model = _port_model(jcfg, params)
    wrt = dict(model.lm.named_parameters())
    for p in wrt.values():
        p.requires_grad_(True)
    loss = grpo.grpo_loss(model, torch.from_numpy(ref), cfg, torch.from_numpy(full).long(),
                          torch.from_numpy(mels), torch.from_numpy(gen_mask),
                          torch.from_numpy(adv), torch.from_numpy(old),
                          grpo.GRPOConfig(group_size=G, max_new_tokens=NEW))
    grads = dict(zip(wrt, torch.autograd.grad(loss, list(wrt.values()))))
    assert abs(loss.item() - jloss) <= 1e-4 * abs(jloss)
    for n, g in grads.items():
        w = want[n].numpy()
        assert np.abs(g.numpy() - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-6), n


class _SGD:
    """p -= lr g over the named parameters, in the port's optimizer interface."""

    def __init__(self, hot, lr):
        self.hot, self.lr = tuple(hot), lr

    def init(self, module):
        return {}

    @torch.no_grad()
    def update(self, grads, opt_state, module):
        params = dict(module.named_parameters())
        for n in self.hot:
            params[n].sub_(self.lr * grads[n])


def test_grpo_step_matches_jax(tiny):
    """One grpo_step, trainable="lm", the reference sharing the towers with its LM in
    int8, the same fixed rollout on both sides (a plain callable): loss and mean reward
    within 1e-4, the first update's ratio exactly 1 on every token, the towers unchanged.
    The update goes through SGD (optax.sgd in JAX), whose change is linear in the
    gradient, at lr 1e4 so that the largest change is about 0.4: the updated LM within
    1e-4 (absolute, as tests/test_torch_train_step.py holds its steps). On-policy, the
    rows' advantages sum to zero and their gradients cancel to a few % of each row's
    part, so the two packages' f32 sums differ by about 1e-4 of the gradient's largest
    element (the embedding's). AdamW's first step is g / (|g| + eps) per element and
    follows the sign of near-zero elements; the port's AdamW is held to optax's in
    tests/test_torch_train_step.py, and a GRPO step runs with it in
    test_offload_round_trip_in_grpo_step."""
    jcfg, params, prompt, (full, gen_mask, lengths) = tiny
    cfg = _port_cfg(jcfg)
    lr = 1e4
    gcfg = dict(group_size=G, max_new_tokens=NEW)
    jparams = jax.tree.map(jnp.copy, params)
    jref = {"encoder": params["encoder"], "adaptor": params["adaptor"],
            "lm": j_quantize_lm_params(params["lm"])}
    jopt = optax.sgd(lr)
    jroll = lambda *a: (jnp.asarray(full), jnp.asarray(gen_mask), jnp.asarray(lengths))  # noqa: E731
    jout, _, jm = jgrpo.grpo_step(
        jparams, jref, jopt, jopt.init(jparams["lm"]), jcfg, [prompt], _reward,
        jgrpo.GRPOConfig(**gcfg), 3, jax.random.PRNGKey(0), _decode,
        compute_dtype=jnp.float32, rollout_fn=jroll, trainable="lm")
    want = lm_params_from_jax(jax.tree.map(np.asarray, jout["lm"]), cfg.lm)

    model = _port_model(jcfg, params)
    ref = af3.AF3Model(model.encoder, model.adaptor, _port_model(jcfg, jref).lm)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = _SGD([n for n, _ in model.lm.named_parameters()], lr)
    tfull = torch.from_numpy(full).long()
    roll = lambda *a: (tfull, torch.from_numpy(gen_mask), torch.from_numpy(lengths))  # noqa: E731
    mels = torch.from_numpy(np.tile(prompt["mels"], (G, 1, 1, 1)))
    with torch.no_grad():
        old = grpo._token_logp(model, cfg, tfull, mels)
    for p in model.lm.parameters():
        p.requires_grad_(True)
    _, ratio = grpo._loss_terms(model, old, cfg, tfull, mels, torch.from_numpy(gen_mask),
                                torch.zeros(G), old, grpo.GRPOConfig(**gcfg))
    assert bool((ratio == 1).all())
    _, _, m = grpo.grpo_step(model, ref, opt, opt.init(model.lm), cfg, [prompt], _reward,
                             grpo.GRPOConfig(**gcfg), 3, None, _decode, rollout_fn=roll,
                             trainable="lm")
    assert abs(m["loss"] - float(jm["loss"])) <= 1e-4 * abs(float(jm["loss"]))
    assert abs(m["mean_reward"] - float(jm["mean_reward"])) <= 1e-4
    got = model.lm.state_dict()
    largest = max((got[n] - before["lm." + n]).abs().max().item() for n in got)
    assert 0.1 < largest < 10
    for n, v in got.items():
        assert (v - want[n]).abs().max().item() <= 1e-4, n
    for n, v in model.state_dict().items():
        if not n.startswith("lm."):
            assert torch.equal(v, before[n]), n


ENCODER = JEncoderConfig(num_mel_bins=16, d_model=32, num_layers=1, num_heads=4, ffn_dim=64,
                         max_source_positions=12)
ENGINE_CFG = JAF3Config(encoder=ENCODER, audio_token_id=90, lm=JQwen2Config(
    vocab_size=96, hidden_size=48, intermediate_size=96, num_layers=2, num_heads=4,
    num_kv_heads=2, tie_word_embeddings=True))
BLOCK = 8


@pytest.fixture(scope="module")
def small():
    params = jaf3.init(jax.random.PRNGKey(1), ENGINE_CFG)
    ids = np.random.default_rng(2).integers(0, 89, (1, 19)).astype(np.int32)
    return params, _port_model(ENGINE_CFG, params), ids


def _engines(model, cfg, eos, prefix_cache=True):
    common = dict(model=model, cfg=cfg, eos_token_id=eos, device="cpu")
    return {"paged": PagedEngine(num_rows=G, num_blocks=24, block_size=BLOCK,
                                 max_blocks_per_seq=4, prefix_cache=prefix_cache, **common),
            "slot": BatchEngine(num_slots=G, capacity=64, **common)}


@pytest.mark.parametrize("kind", ["paged", "slot"])
def test_engine_rollout(small, kind):
    """top_k 1 makes the samples the greedy tokens: every row equals the others; with the
    EOS set to the first greedy token each row stops there, its mask covering the tokens
    up to it (EOS included), the rest filled with EOS."""
    _, model, ids = small
    cfg = _port_cfg(ENGINE_CFG)
    gcfg = grpo.GRPOConfig(group_size=G, max_new_tokens=NEW, top_k=1)
    full, gen_mask, lengths = grpo.make_engine_rollout(_engines(model, cfg, -1)[kind])(
        ids, None, gcfg, -1)
    t = ids.shape[1]
    assert full.shape == gen_mask.shape == (G, t + NEW) and lengths.tolist() == [NEW] * G
    assert (full[:, :t] == torch.from_numpy(ids).long()).all() and (full == full[:1]).all()
    assert gen_mask[:, t:].all() and not gen_mask[:, :t].any()
    # a tiny random LM repeats its first greedy token: as the EOS it ends every row there
    eos = int(full[0, t])
    stop = full[0, t:].tolist().index(eos) + 1
    roll = grpo.make_engine_rollout(_engines(model, cfg, eos)[kind])
    full, gen_mask, lengths = roll(ids, None, gcfg, eos)
    assert lengths.tolist() == [stop] * G
    assert (full[:, t + stop - 1:] == eos).all()
    assert gen_mask[:, t:t + stop].all() and not gen_mask[:, t + stop:].any()
    assert roll.engine.finished and len(roll.engine.finished) == G


def test_dense_rollout_and_step(small):
    """rollout on generate with a torch.Generator: the prompt repeated, gen_mask over each
    row's generated tokens, the same draws from the same seed and other rows' draws
    differing; grpo_step on it (no engine) updates the LM in place."""
    params, _, ids = small
    model = _port_model(ENGINE_CFG, params)
    cfg = _port_cfg(ENGINE_CFG)
    gcfg = grpo.GRPOConfig(group_size=G, max_new_tokens=NEW, temperature=1.0)
    outs = [grpo.rollout(model, cfg, ids, None, gcfg, -1, torch.Generator().manual_seed(s))
            for s in (3, 3, 4)]
    full, gen_mask, lengths = outs[0]
    t = ids.shape[1]
    assert full.shape == gen_mask.shape == (G, t + NEW) and lengths.tolist() == [NEW] * G
    assert (full[:, :t] == torch.from_numpy(ids).long()).all()
    assert gen_mask[:, t:].all() and not gen_mask[:, :t].any()
    assert torch.equal(outs[1][0], full) and not torch.equal(outs[2][0], full)
    assert len({tuple(r) for r in full[:, t:].tolist()}) > 1
    ref = af3.AF3Model(model.encoder, model.adaptor, _port_model(ENGINE_CFG, params).lm)
    opt = tts.make_optimizer(MF_STAGES["mf_3_grpo"], model.lm, warmup_steps=0)
    lm0 = {k: v.clone() for k, v in model.lm.state_dict().items()}
    _, _, m = grpo.grpo_step(model, ref, opt, opt.init(model.lm), cfg, [{"ids": ids}], _reward,
                             gcfg, -1, torch.Generator().manual_seed(5), _decode,
                             trainable="lm")
    assert np.isfinite(m["loss"]) and 0 <= m["mean_reward"] <= 1
    assert any(not torch.equal(v, lm0[k]) for k, v in model.lm.state_dict().items())


def test_sync_keeps_the_engine_on_policy(small):
    """An engine on the policy module stays as it is; one on another module of the same
    layout is pointed at the policy; an int8 copy of the LM raises, as in JAX."""
    params, model, _ = small
    cfg = _port_cfg(ENGINE_CFG)
    roll = grpo.make_engine_rollout(_engines(model, cfg, -1)["paged"])
    grpo._sync_engine_policy(roll, model)
    assert roll.engine.model is model
    other = _port_model(ENGINE_CFG, params)
    roll = grpo.make_engine_rollout(_engines(other, cfg, -1)["paged"])
    grpo._sync_engine_policy(roll, model)
    assert roll.engine.model is model
    quant = _port_model(ENGINE_CFG, {**params, "lm": j_quantize_lm_params(params["lm"])})
    roll = grpo.make_engine_rollout(_engines(quant, cfg, -1)["paged"])
    with pytest.raises(ValueError, match="another layout"):
        grpo._sync_engine_policy(roll, model)
    grpo._sync_engine_policy(lambda *a: None, model)      # a plain callable: left alone


@pytest.mark.parametrize("kind", ["paged", "slot"])
def test_engine_reads_the_policy_in_place(small, kind):
    """No copy of an LM weight lives on an engine's path: after the policy's weights change
    in place, the engine (no prefix cache) answers as a new engine on the changed model."""
    params, _, ids = small
    model = _port_model(ENGINE_CFG, params)
    cfg = _port_cfg(ENGINE_CFG)

    def make():
        return _engines(model, cfg, -1, prefix_cache=False)[kind]

    def answer(engine, rid):
        engine.submit(Request(request_id=rid, ids=ids.copy(), max_new_tokens=NEW))
        return list(engine.run_until_done()[rid])

    engine = make()
    before = answer(engine, "a")
    with torch.no_grad():
        for layer in model.lm.layers:
            for lin in (layer.q_proj, layer.o_proj, layer.up_proj):
                lin.weight.mul_(3.0)
    after = answer(engine, "b")
    assert after == answer(make(), "c") and after != before


def test_offload_round_trip_in_grpo_step(small):
    """grpo_step(offload_pool=True) on a PagedEngine rollout: the pool leaves for host
    memory during the update and comes back bit-identical; the engine then samples the
    updated policy (its module is the policy's)."""
    params, _, ids = small
    model = _port_model(ENGINE_CFG, params)
    cfg = _port_cfg(ENGINE_CFG)
    engine = _engines(model, cfg, -1)["paged"]
    roll = grpo.make_engine_rollout(engine)
    gcfg = grpo.GRPOConfig(group_size=G, max_new_tokens=NEW)
    pool, seen = {}, []
    update, offload = grpo._grpo_update, engine.offload_pool

    def spy(*a, **kw):
        seen.append(engine.cache)
        return update(*a, **kw)

    def offload_spy():
        pool.update({n: getattr(engine.cache, n).clone() for n in ("k", "v")})
        offload()

    grpo._grpo_update, engine.offload_pool = spy, offload_spy
    try:
        ref = af3.AF3Model(model.encoder, model.adaptor, _port_model(ENGINE_CFG, params).lm)
        opt = tts.make_optimizer(MF_STAGES["mf_3_grpo"], model.lm, warmup_steps=0)
        lm0 = {k: v.clone() for k, v in model.lm.state_dict().items()}
        grpo.grpo_step(model, ref, opt, opt.init(model.lm), cfg, [{"ids": ids}], _reward,
                       gcfg, -1, None, _decode, rollout_fn=roll, trainable="lm",
                       offload_pool=True)
    finally:
        grpo._grpo_update = update
    assert seen == [None]                    # the pool was away during the update
    for n, t in pool.items():
        assert torch.equal(getattr(engine.cache, n), t), n
    assert engine.model is model
    assert any(not torch.equal(v, lm0[k]) for k, v in model.lm.state_dict().items())


def test_rewards_match_jax():
    texts = ["<think>a b</think> Piano", "no thinking here, piano", "<think>open only",
             "close</think> only", "</think>x<think>", ""]
    for make, args in ((grpo.format_reward, ()), (grpo.exact_match_reward, ("piano",))):
        jmake = getattr(jgrpo, make.__name__)
        for t in texts:
            assert make(*args)(t) == jmake(*args)(t), (make.__name__, t)


def test_prefix_cache_serves_old_policy_pages_in_both_packages(small):
    """Both packages keep the prefix store across a policy change: after the LM's weights
    change (the engine's params reassigned in JAX, the module updated in place in the
    port), the same prompt's full blocks are served from the store (hits, the encoder and
    prefill over them skipped), so the K/V of the old policy feed the new one's decode.
    The two packages agree token for token before and after, and a fresh engine on the
    new weights (no stale pages) answers otherwise."""
    params, _, ids = small
    model = _port_model(ENGINE_CFG, params)
    cfg = _port_cfg(ENGINE_CFG)
    kw = dict(num_rows=2, num_blocks=24, block_size=BLOCK, max_blocks_per_seq=4,
              prefix_cache=True, eos_token_id=-1)
    je = JPagedEngine(params=params, cfg=ENGINE_CFG, compute_dtype=jnp.float32,
                      sampling=JSamplingParams(greedy=True), **kw)
    te = PagedEngine(model=model, cfg=cfg, device="cpu", **kw)

    def serve(rid):
        je.submit(JRequest(request_id=rid, ids=ids.copy(), max_new_tokens=NEW))
        te.submit(Request(request_id=rid, ids=ids.copy(), max_new_tokens=NEW))
        return list(je.run_until_done()[rid]), list(te.run_until_done()[rid])

    a = serve("a")
    assert a[0] == a[1]
    scale = 3.0
    new_lm = jax.tree.map(lambda x: x * scale if x.ndim == 3 else x, params["lm"])
    je.params = {**params, "lm": new_lm}
    with torch.no_grad():
        for layer in model.lm.layers:
            for lin in (layer.q_proj, layer.k_proj, layer.v_proj, layer.o_proj,
                        layer.gate_proj, layer.up_proj, layer.down_proj):
                lin.weight.mul_(scale)
    hits = (je.store.hits, te.store.hits)
    b = serve("b")
    assert b[0] == b[1]
    assert je.store.hits - hits[0] == te.store.hits - hits[1] == ids.shape[1] // BLOCK
    fresh = PagedEngine(model=model, cfg=cfg, device="cpu", **kw)
    fresh.submit(Request(request_id="c", ids=ids.copy(), max_new_tokens=NEW))
    assert list(fresh.run_until_done()["c"]) != b[1]
