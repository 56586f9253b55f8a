"""Decode with its state on the device (``runtime/generate``'s step function, the one a
CUDA graph captures on the card; eager here) against the JAX package at f32:

- the device-index ``KVCache`` and ``Q8KVCache`` through ``decode_step`` against JAX's
  ``decode_step``, 4 steps, on float, int8 and fused w4 LMs (the w4 one through K6's
  plain path: its widths are the smallest the suffix kernels take), logits within 1e-4
  and ids exact;
- ``generate`` on ``AF3Config.tiny()`` with EOS forced at every step from 1 to
  ``2 * SYNC_EVERY + 1`` against JAX's ``decode_loop``: tokens, lengths and logprobs,
  and the steps run (whole ``SYNC_EVERY`` chunks);
- the step function reads nothing back to the host (no ``_local_scalar_dense``) on the
  float, int8, q8 and w4 LMs, with every processor on;
- decode attention over a bf16 cache: bit for bit the widened einsum form the port had,
  and within the bf16 bound of JAX's ``gqa_attention``;
- ``utils/profiling`` against JAX's: a trace file holding an annotated name, and
  ``PhaseTimer.summary()``'s keys and counts."""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.config import AF3Config as JAF3Config
from audio_flamingo_tpu.models import af3 as jaf3
from audio_flamingo_tpu.models import qwen2 as jqwen2
from audio_flamingo_tpu.ops import quant as jquant
from audio_flamingo_tpu.ops import quant4 as jquant4
from audio_flamingo_tpu.ops.attention import gqa_attention as j_gqa_attention
from audio_flamingo_tpu.ops.sampling import SamplingParams as JSamplingParams
from audio_flamingo_tpu.runtime import generate as jgen
from audio_flamingo_tpu.utils import profiling as jprof
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.io.convert import lm_params_from_jax, params_from_jax
from audio_flamingo_tpu_torch.models import af3, qwen2
from audio_flamingo_tpu_torch.ops import attention
from audio_flamingo_tpu_torch.ops.sampling import SamplingParams
from audio_flamingo_tpu_torch.runtime import generate as tgen
from audio_flamingo_tpu_torch.utils import profiling as tprof

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

LOGITS_TOL = 1e-4
LP_TOL = 1e-5
TINY = JAF3Config.tiny()
# tiny's LM at the smallest widths the fused w4 suffix takes ((K / 2) % 128 == 0)
JLM = dataclasses.replace(TINY.lm, vocab_size=128, hidden_size=256, intermediate_size=512,
                          head_dim=64, tie_word_embeddings=False)


def _pick(cls, obj):
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})


def _port_af3_cfg(j):
    return C.AF3Config(encoder=_pick(C.WhisperEncoderConfig, j.encoder),
                       lm=_pick(C.Qwen2Config, j.lm), audio_token_id=j.audio_token_id)


@pytest.fixture(scope="module")
def trees():
    """JAX params of JLM: float, int8 and fused w4 (group 64)."""
    fp = jax.jit(jqwen2.init, static_argnums=1)(jax.random.PRNGKey(2), JLM)
    return {"float": fp, "int8": jax.jit(jquant.quantize_lm_params)(fp),
            "w4": jax.jit(jquant4.quantize_lm_params_w4, static_argnames=("group_size",))(
                fp, group_size=64)}


def _port_lm(jp):
    cfg = _pick(C.Qwen2Config, JLM)
    state = lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    if "ln_f_w" in state:
        return qwen2.quantized_lm(qwen2.unflatten(state), torch.float32, "cpu")
    with torch.device("meta"):
        lm = qwen2.Qwen2(cfg, dtype=torch.float32)
    lm = lm.to_empty(device="cpu")
    lm.load_state_dict(state)
    return lm.eval()


def _prefilled(jp, kind: str, b: int, t0: int, cap: int):
    """A JAX cache of ``kind`` after a t0-token prefill, the port's cache holding the same
    K/V (codes and scales) and index, and the greedy next ids. The port starts from
    JAX's K/V because an f32 difference in a prefill's K or V can move an int8 code by
    one, which moves the logits by more than the tolerance."""
    ids = np.random.default_rng(1).integers(0, JLM.vocab_size, (b, t0)).astype(np.int32)
    pos = np.broadcast_to(np.arange(t0), (b, t0)).astype(np.int32)
    jcache = (jqwen2.init_cache_q8(JLM, b, cap) if kind == "q8"
              else jqwen2.init_cache(JLM, b, cap, dtype=jnp.float32))
    jx = jqwen2.embed(jp, jnp.asarray(ids), dtype=jnp.float32)
    jh, jcache = jqwen2.forward(jp, JLM, jx, jnp.asarray(pos), cache=jcache, is_prefill=True)
    leaves = {k: torch.from_numpy(np.array(v)) for k, v in jcache._asdict().items()
              if k != "index"}
    tcache = (qwen2.Q8KVCache if kind == "q8" else qwen2.KVCache)(**leaves, index=t0)
    return jcache, tcache, np.asarray(jqwen2.unembed(jp, JLM, jh[:, -1])).argmax(-1)


@pytest.mark.parametrize("kind", ["bf16_layout", "q8"])
@pytest.mark.parametrize("tree", ["float", "int8", "w4"])
def test_device_index_caches_match_jax_decode_step(trees, monkeypatch, tree, kind):
    jp = trees[tree]
    lm = _port_lm(jp)
    cfg = _pick(C.Qwen2Config, JLM)
    suffix_calls = []
    real = qwen2.w4_suffix_a
    monkeypatch.setattr(qwen2, "w4_suffix_a", lambda *a, **k: suffix_calls.append(1)
                        or real(*a, **k))
    b, t0, cap, steps = 2, 9, 24, 4
    jcache, tcache, tok = _prefilled(jp, kind, b, t0, cap)
    jcfg = dataclasses.replace(TINY, lm=JLM)
    assert tcache.index.dtype == torch.long and tcache.index.ndim == 0
    assert int(tcache.index) == tcache.host_index == t0
    # the q8 cache eagerly: under jit XLA divides its scales by 127 through its reciprocal
    j_step = jgen.decode_step.__wrapped__ if kind == "q8" else jgen.decode_step
    for step in range(steps):
        jcache, jl = j_step({"lm": jp}, jcfg, jcache, jnp.asarray(tok),
                            jnp.asarray(t0 + step, jnp.int32), compute_dtype=jnp.float32)
        with torch.inference_mode():
            tcache, tl = tgen.decode_step(lm, cfg, tcache, torch.from_numpy(tok).long(),
                                          torch.tensor(t0 + step))
        want, got = np.asarray(jl), tl.numpy()
        np.testing.assert_allclose(got, want, atol=LOGITS_TOL, rtol=0, err_msg=f"step {step}")
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        tok = want.argmax(-1)
    assert int(tcache.index) == tcache.host_index == int(jcache.index) == t0 + steps
    assert len(suffix_calls) == (steps * JLM.num_layers if tree == "w4" else 0)


# ---------------------------------------------------------------------- EOS at every step

MAX_NEW = 2 * tgen.SYNC_EVERY + 3
EOS_STEPS = list(range(1, 2 * tgen.SYNC_EVERY + 2))
# the n-gram ban of size 1 bans every token seen, so each row's greedy stream is distinct
# and an EOS id taken from step k of row 0's stream first appears there
NGRAM1 = dict(no_repeat_ngram_size=1)


@pytest.fixture(scope="module")
def tiny():
    params = jaf3.init(jax.random.PRNGKey(0), TINY)
    cfg = _port_af3_cfg(TINY)
    model = af3.build(cfg, "cpu", torch.float32)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), cfg))
    ids = np.random.default_rng(0).integers(0, TINY.audio_token_id, (2, 7)).astype(np.int32)
    cache, logits = jgen.prefill(params, TINY, jnp.asarray(ids), None, 128,
                                 compute_dtype=jnp.float32)

    def loop(first_logits, cache, eos):
        return jgen.decode_loop(
            first_logits, cache, ids.shape[1],
            lambda c, tok, p: jgen.decode_step(params, TINY, c, tok, p, jnp.float32),
            max_new_tokens=MAX_NEW, eos_token_id=eos, sampling=JSamplingParams(**NGRAM1),
            rng=jax.random.PRNGKey(0), return_logprobs=True, prompt_tokens=jnp.asarray(ids))

    loop = jax.jit(loop)   # the EOS id traced: one compile for every case
    base = np.asarray(loop(logits, cache, -2)[0])
    assert len(set(base[0].tolist())) == MAX_NEW   # every step's token is a new one
    return dict(cfg=cfg, model=model, ids=ids, base=base,
                jax=lambda eos: [np.asarray(a) for a in loop(logits, cache, eos)])


@pytest.mark.parametrize("eos_step", EOS_STEPS)
def test_generate_matches_decode_loop_with_eos_at_each_step(tiny, eos_step):
    eos = int(tiny["base"][0, eos_step])
    toks, lens, lps = tiny["jax"](eos)
    assert toks[0, eos_step] == eos and lens[0] == eos_step + 1
    out = tgen.generate(tiny["model"], tiny["cfg"], torch.from_numpy(tiny["ids"]).long(),
                        max_new_tokens=MAX_NEW, eos_token_id=eos, capacity=128,
                        sampling=SamplingParams(**NGRAM1), return_logprobs=True)
    np.testing.assert_array_equal(out.tokens.numpy(), toks)
    np.testing.assert_array_equal(out.lengths.numpy(), lens)
    np.testing.assert_allclose(out.logprobs.numpy(), lps, atol=LP_TOL, rtol=0)
    # JAX's loop runs until the last row's end; the port in whole chunks of SYNC_EVERY
    jax_steps = max(int(n) - 1 if eos in row else MAX_NEW - 1 for n, row in zip(lens, toks))
    assert out.decode_steps == min(-(-jax_steps // tgen.SYNC_EVERY) * tgen.SYNC_EVERY,
                                   MAX_NEW - 1)


@pytest.mark.parametrize("max_new", [1, 6])
def test_generate_at_the_least_capacity(tiny, max_new):
    """A capacity of exactly prompt + max_new_tokens - 1 slots (every decode position, the
    history's last token one past them) gives what a roomy one gives; one token runs no
    step. The n-gram ban and the penalty keep the history on."""
    ids = torch.from_numpy(tiny["ids"]).long()
    kw = dict(max_new_tokens=max_new, eos_token_id=-2,
              sampling=SamplingParams(repetition_penalty=1.2, **NGRAM1))
    tight = tgen.generate(tiny["model"], tiny["cfg"], ids, capacity=ids.shape[1] + max_new - 1,
                          **kw)
    roomy = tgen.generate(tiny["model"], tiny["cfg"], ids, **kw)
    assert torch.equal(tight.tokens, roomy.tokens) and tight.decode_steps == max_new - 1
    with pytest.raises(ValueError, match="cannot take"):
        tgen.generate(tiny["model"], tiny["cfg"], ids, capacity=ids.shape[1] + max_new - 2,
                      **kw)


# ------------------------------------------------------------------- no host reads


class _NoHostReads(TorchDispatchMode):
    """Raises on any op that copies a device value to a Python scalar."""

    READS = {torch.ops.aten._local_scalar_dense.default, torch.ops.aten.item.default,
             torch.ops.aten.is_nonzero.default, torch.ops.aten.equal.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.READS:
            raise AssertionError(f"the decode step read the device: {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("greedy", [True, False])
@pytest.mark.parametrize("tree,kind", [("float", "bf16_layout"), ("int8", "bf16_layout"),
                                       ("int8", "q8"), ("w4", "bf16_layout")])
def test_step_reads_nothing_back(trees, tree, kind, greedy):
    jp = trees[tree]
    lm = _port_lm(jp)
    cfg = _pick(C.Qwen2Config, JLM)
    _, tcache, tok = _prefilled(jp, kind, 2, 9, 24)
    spec = tgen.DecodeSpec(
        max_new_tokens=8, eos_token_id=7, stop_sequences=((3, 4), (5,)), return_logprobs=True,
        sampling=SamplingParams(greedy=greedy, temperature=0.7, top_k=20, top_p=0.9,
                                repetition_penalty=1.2, min_new_tokens=3,
                                no_repeat_ngram_size=2))
    st = tgen.new_state(cfg, spec, tcache, torch.Generator().manual_seed(0))
    with torch.inference_mode():
        st.seq[:, :9] = 1
        tgen.begin(st, spec, torch.from_numpy(tok).long(), 9, st.logits)
        with _NoHostReads():
            for _ in range(3):
                tgen.decode_body(lm, cfg, spec, st)
    assert int(st.step) == 3 and int(st.position) == 12 and int(st.cache.index) == 12
    assert torch.isfinite(st.logits).all() and (st.logprobs[:, :4] <= 0).all()


# ------------------------------------------------------------------- bf16 decode attention


def _widened_gqa_attention(q, k, v, mask):
    """The port's gqa_attention before decode read the bf16 cache as it is: every operand
    widened to f32 and multiplied by einsum."""
    b, q_len, nh, hd = q.shape
    kv_len, nkv = k.shape[1], k.shape[2]
    group = nh // nkv
    qg = q.reshape(b, q_len, nkv, group, hd).float()
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * hd ** -0.5
    scores = scores.masked_fill(~mask[:, :, None], attention.NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype).float()
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return out.reshape(b, q_len, nh, hd).to(q.dtype)


@pytest.mark.parametrize("b", [1, 3])
def test_bf16_decode_attention(b):
    nh, nkv, hd, cap, filled = 8, 2, 64, 96, 70
    rng = np.random.default_rng(b)
    q, k, v = (rng.normal(size=(b, 1, n, hd)).astype(np.float32) if n == nh else
               rng.normal(size=(b, cap, n, hd)).astype(np.float32) for n in (nh, nkv, nkv))
    mask = np.broadcast_to(np.arange(cap) < filled, (b, 1, 1, cap)).copy()
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    tmask = torch.from_numpy(mask)
    got = attention.gqa_attention(tq, tk, tv, tmask)
    assert got.dtype == torch.bfloat16 and got.shape == (b, 1, nh, hd)
    assert torch.equal(got, _widened_gqa_attention(tq, tk, tv, tmask))
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(j_gqa_attention(jq, jk, jv, jnp.asarray(mask)).astype(jnp.float32))
    diff = np.abs(got.float().numpy() - want)
    assert (diff <= 2.0 ** -7 * np.abs(want) + 1e-3).all(), diff.max()


# ------------------------------------------------------------------- utils/profiling


def test_profiling_matches_jax(tmp_path):
    with tprof.trace(str(tmp_path)):
        with tprof.annotate("decode_probe"):
            torch.ones(8).cumsum(0)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "decode_probe" for e in events)
    timers = {"jax": jprof.PhaseTimer(), "torch": tprof.PhaseTimer()}
    for name, timer in timers.items():
        for phase in ("prefill", "decode", "decode"):
            with timer.phase(phase) as out:
                out["result"] = jnp.ones(3) if name == "jax" else torch.ones(3)
    j, t = timers["jax"].summary(), timers["torch"].summary()
    assert j.keys() == t.keys() == {"prefill", "decode"}
    for phase in j:
        assert j[phase].keys() == t[phase].keys() and j[phase]["count"] == t[phase]["count"]
    try:
        tprof.enable_nan_checks()
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
    finally:
        tprof.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
