"""Port's training step against the JAX package at f32: the loss and its gradients, one
to three train steps (hot parameters, frozen parameters bit-identical), the hand-written
AdamW against optax, gradient accumulation, the chunked CE, the remat policies, an
LM-only step through flash attention (JAX's Pallas kernels in interpret mode) and a
frozen int8 LM."""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.config import AF3Config as JAF3Config
from audio_flamingo_tpu.models import af3 as jaf3
from audio_flamingo_tpu.ops.quant import quantize_lm_params as j_quantize_lm_params
from audio_flamingo_tpu.train import train_step as jts
from audio_flamingo_tpu.train.stages import AF3_STAGES as J_STAGES
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.io.convert import params_from_jax
from audio_flamingo_tpu_torch.models import af3, qwen2
from audio_flamingo_tpu_torch.ops.remat import REMAT_POLICIES, remat_wrap
from audio_flamingo_tpu_torch.train import train_step as tts
from audio_flamingo_tpu_torch.train.stages import AF3_STAGES

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)


def _port_cfg(j):
    pick = lambda cls, obj: cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})
    return C.AF3Config(encoder=pick(C.WhisperEncoderConfig, j.encoder),
                       lm=pick(C.Qwen2Config, j.lm), audio_token_id=j.audio_token_id)


def _port_model(jcfg, params) -> af3.AF3Model:
    """The port's AF3Model on the CPU at f32 from a JAX params tree (float or int8 LM)."""
    cfg = _port_cfg(jcfg)
    sd = params_from_jax(jax.tree.map(np.asarray, params), cfg)
    lm = None
    if "lm.ln_f_w" in sd:
        lm = qwen2.quantized_lm(qwen2.unflatten({k[3:]: v for k, v in sd.items()
                                                 if k.startswith("lm.")}),
                                torch.float32, "cpu")
        sd = {k: v for k, v in sd.items() if not k.startswith("lm.")}
    model = af3.build(cfg, "cpu", torch.float32, lm=lm)
    model.load_state_dict(sd, strict=lm is None)
    return model


def _with(jcfg, *, enc_remat="none", lm_remat="none", use_flash=False):
    return dataclasses.replace(
        jcfg, encoder=dataclasses.replace(jcfg.encoder, remat=enc_remat, use_flash=use_flash),
        lm=dataclasses.replace(jcfg.lm, remat=lm_remat, use_flash=use_flash))


@pytest.fixture(scope="module")
def tiny():
    """Tiny AF3 (vocab 256) and a 2-row batch with one 30 s window of mels per row, 8
    audio positions and uneven label masking (row i trains on its last 6 (i + 1))."""
    cfg = JAF3Config.tiny()
    cfg = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, vocab_size=256))
    params = jaf3.init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    b, t = 2, 32
    ids = rng.integers(5, 250, (b, t)).astype(np.int32)
    ids[:, 1:9] = cfg.audio_token_id
    labels = ids.copy()
    for i in range(b):
        labels[i, : t - 6 * (i + 1)] = -100
    mels = (rng.normal(size=(b, 1, 3000, cfg.encoder.num_mel_bins)) * 0.1).astype(np.float32)
    return cfg, params, {"ids": ids, "labels": labels, "mels": mels}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_grads(model, cfg, batch, ce_chunk=0, parts=("encoder", "adaptor", "lm")):
    """(loss, {name: grad}) of af3.loss over every float parameter of ``parts``."""
    params = {n: p for n, p in model.named_parameters() if n.split(".")[0] in parts}
    for p in params.values():
        p.requires_grad_(True)
    tb = _torch_batch(batch)
    loss = af3.loss(model, cfg, tb["ids"].long(), tb["labels"].long(), tb.get("mels"),
                    ce_chunk=ce_chunk)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.item(), dict(zip(params, grads))


def _jax_grads_as_port(jcfg, params, batch, hot=None):
    """JAX value_and_grad of af3.loss, its grads carried into the port's names. hot:
    the top-level parts differentiated (the rest held fixed), None for all."""
    hot = hot or tuple(params)
    fixed = {k: v for k, v in params.items() if k not in hot}

    def fn(tr):
        return jaf3.loss({**tr, **fixed}, jcfg, jnp.asarray(batch["ids"]),
                         jnp.asarray(batch["labels"]),
                         None if batch.get("mels") is None else jnp.asarray(batch["mels"]),
                         compute_dtype=jnp.float32)

    loss, g = jax.value_and_grad(fn)({k: params[k] for k in hot})
    full = {**jax.tree.map(np.zeros_like, jax.tree.map(np.asarray, fixed)),
            **jax.tree.map(np.asarray, g)}
    if "lm" not in hot:
        full["lm"] = jax.tree.map(np.asarray, params["lm"])   # placeholder, not compared
    sd = params_from_jax(full, _port_cfg(jcfg))
    return float(loss), sd


def _assert_grads_close(got: dict, want: dict, names) -> None:
    for n in names:
        w = want[n].numpy()
        np.testing.assert_allclose(got[n].numpy(), w, atol=1e-5 * max(1.0, np.abs(w).max()),
                                   rtol=1e-4, err_msg=n)


def test_loss_and_grads_match_jax(tiny):
    jcfg, params, batch = tiny
    model = _port_model(jcfg, params)
    loss, grads = _port_grads(model, _port_cfg(jcfg), batch)
    jloss, jgrads = _jax_grads_as_port(jcfg, params, batch)
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    _assert_grads_close(grads, jgrads, grads)


@pytest.mark.parametrize("stage", ["2_encoder_tuning", "3_full_ft"])
def test_train_steps_match_jax(tiny, stage):
    """Three steps (warmup 1, so the first update is zero, as in JAX): loss and grad
    norm per step within 1e-5 relative, hot parameters within 1e-5, a frozen LM
    bit-identical. On this all-float model both grad norms take every parameter's
    gradient, the frozen LM's included."""
    jcfg, params, batch = tiny
    jstate, jopt = jts.init_state(jax.tree.map(jnp.copy, params), J_STAGES[stage],
                                  warmup_steps=1, total_steps=5)
    jstep = jts.make_jit_train_step(jcfg, jopt, compute_dtype=jnp.float32)
    model = _port_model(jcfg, params)
    lm_before = {k: v.clone() for k, v in model.lm.state_dict().items()}
    state, opt = tts.init_state(model, AF3_STAGES[stage], warmup_steps=1, total_steps=5)
    frozen_lm = not AF3_STAGES[stage].train_lm
    assert opt.hot and frozen_lm == all(n.split(".")[0] != "lm" for n in opt.hot)
    assert set(state.opt_state["mu"]) == set(opt.hot)
    cfg = _port_cfg(jcfg)
    tb = _torch_batch(batch)
    for i in range(3):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = tts.train_step(state, tb, cfg=cfg, opt=opt)
        assert abs(m["loss"].item() - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"])), i
        assert abs(m["grad_norm"].item() - float(jm["grad_norm"])) <= (
            1e-5 * float(jm["grad_norm"])), i
    assert state.step == 3 and state.opt_state["count"] == 3
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg)
    got = model.state_dict()
    for name in opt.hot:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)
    moved = max((got[n] - _port_model(jcfg, params).state_dict()[n]).abs().max().item()
                for n in opt.hot)
    assert moved > 0
    if not frozen_lm:
        return
    for k, v in model.lm.state_dict().items():
        assert torch.equal(v, lm_before[k]), k
        assert torch.equal(v, want["lm." + k]), k


def test_optimizer_matches_optax_step_by_step():
    """AdamW.update and the schedule against optax's chain (clip 1.0, adamw b1 0.9, b2
    0.95, eps 1e-8, wd 0.01, warmup cosine) on grads that clip at some steps and not at
    others; a frozen parameter keeps no state and does not move."""
    rng = np.random.default_rng(1)
    w0 = {"a": rng.normal(size=(5, 3)).astype(np.float32),
          "b": rng.normal(size=(7,)).astype(np.float32)}
    module = torch.nn.Module()
    module.a = torch.nn.Parameter(torch.from_numpy(w0["a"].copy()))
    module.b = torch.nn.Parameter(torch.from_numpy(w0["b"].copy()))
    module.frozen = torch.nn.Parameter(torch.ones(3), requires_grad=False)
    opt = tts.AdamW(("a", "b"), lr=1e-2, warmup_steps=2, total_steps=6)
    state = opt.init(module)
    assert set(state["mu"]) == {"a", "b"}
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 6, 1e-2 * 0.1)
    for count in range(10):
        assert abs(opt.learning_rate(count) - float(sched(count))) <= 1e-7 * 1e-2, count
    jopt = optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adamw(sched, b1=0.9, b2=0.95, weight_decay=0.01))
    jparams = jax.tree.map(jnp.asarray, w0)
    jstate = jopt.init(jparams)
    for step, size in enumerate((3.0, 0.05, 2.0, 0.2, 0.01)):
        g = {k: (rng.normal(size=v.shape) * size).astype(np.float32) for k, v in w0.items()}
        clipped = float(optax.global_norm(g)) >= 1.0
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        opt.update({k: torch.from_numpy(v) for k, v in g.items()}, state, module)
        for k in ("a", "b"):
            np.testing.assert_allclose(getattr(module, k).detach().numpy(),
                                       np.asarray(jparams[k]), rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {step} ({'clipped' if clipped else 'not clipped'})")
    assert torch.equal(module.frozen, torch.ones(3))


def test_accum_steps_equals_one_batch(tiny):
    """accum_steps=2 (one row per microbatch, uneven valid counts) gives the full batch's
    loss and update."""
    jcfg, params, batch = tiny
    cfg = _port_cfg(jcfg)
    out = []
    for accum in (1, 2):
        model = _port_model(jcfg, params)
        state, opt = tts.init_state(model, AF3_STAGES["1_pretrain"], warmup_steps=0,
                                    total_steps=5)
        state, m = tts.train_step(state, _torch_batch(batch), cfg=cfg, opt=opt,
                                  accum_steps=accum)
        out.append((m, {n: p.detach().clone() for n, p in model.named_parameters()
                        if p.requires_grad}))
    (m1, p1), (m2, p2) = out
    assert abs(m1["loss"].item() - m2["loss"].item()) <= 1e-6 * abs(m1["loss"].item())
    assert abs(m1["grad_norm"].item() - m2["grad_norm"].item()) <= 1e-5 * m1["grad_norm"].item()
    for n in p1:
        torch.testing.assert_close(p1[n], p2[n], atol=1e-7, rtol=1e-6)


def test_ce_chunk_equals_dense(tiny):
    """A chunk of 5 tokens (31 shifted positions: the tail padded with -100) gives the
    dense loss and gradients."""
    jcfg, params, batch = tiny
    cfg = _port_cfg(jcfg)
    loss0, g0 = _port_grads(_port_model(jcfg, params), cfg, batch)
    loss5, g5 = _port_grads(_port_model(jcfg, params), cfg, batch, ce_chunk=5)
    assert abs(loss0 - loss5) <= 1e-6 * abs(loss0)
    for n in g0:
        torch.testing.assert_close(g5[n], g0[n], atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("enc_remat,lm_remat,use_flash", [
    ("dots", "none", False), ("full", "full", False), ("dots", "dots", True),
    ("none", "full", True)])
def test_remat_policies_equal_none(tiny, enc_remat, lm_remat, use_flash):
    """Recompute changes nothing, with plain attention or through the flash autograd
    Function (recomputed under "dots" and "full")."""
    jcfg, params, batch = tiny
    base = _with(jcfg, use_flash=use_flash)
    loss0, g0 = _port_grads(_port_model(base, params), _port_cfg(base), batch)
    rcfg = _with(jcfg, enc_remat=enc_remat, lm_remat=lm_remat, use_flash=use_flash)
    loss1, g1 = _port_grads(_port_model(rcfg, params), _port_cfg(rcfg), batch)
    assert loss1 == loss0
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], atol=1e-7, rtol=1e-6)


def test_remat_wrap_rejects_a_bad_policy_and_recomputes():
    with pytest.raises(ValueError, match="remat must be one of"):
        remat_wrap(lambda x: x, "everything")
    calls = []

    def layer(x):
        calls.append(1)
        return torch.tanh(x @ x.t()).sum()

    for policy in REMAT_POLICIES:
        calls.clear()
        x = torch.randn(4, 4, requires_grad=True)
        remat_wrap(layer, policy)(x).backward()
        assert len(calls) == (1 if policy == "none" else 2), policy
    calls.clear()
    with torch.no_grad():
        remat_wrap(layer, "full")(torch.randn(4, 4))
    assert len(calls) == 1


def test_lm_only_flash_step_matches_jax(tiny):
    """A text-only loss with use_flash on both sides: JAX's flash forward and backward
    Pallas kernels (interpret mode) against the port's plain flash versions."""
    jcfg, params, batch = tiny
    jcfg = _with(jcfg, use_flash=True)
    text = {"ids": np.where(batch["ids"] == jcfg.audio_token_id, 7, batch["ids"]),
            "labels": batch["labels"]}
    loss, grads = _port_grads(_port_model(jcfg, params), _port_cfg(jcfg), text,
                              parts=("lm",))
    jloss, jgrads = _jax_grads_as_port(jcfg, params, text, hot=("lm",))
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    _assert_grads_close(grads, jgrads, grads)


def test_frozen_int8_lm_stage2_grads_match_jax(tiny):
    """AF3 stage 2 on a frozen int8 LM: the gradients flow back through the int8
    products into the encoder and adaptor, as JAX's (bench.py bench_train_mm)."""
    jcfg, params, batch = tiny
    qparams = {**params, "lm": j_quantize_lm_params(params["lm"])}
    model = _port_model(jcfg, qparams)
    cfg = _port_cfg(jcfg)
    state, opt = tts.init_state(model, AF3_STAGES["2_encoder_tuning"])
    tb = _torch_batch(batch)
    loss = af3.loss(model, cfg, tb["ids"].long(), tb["labels"].long(), tb["mels"])
    hot = dict(model.named_parameters())
    grads = dict(zip(opt.hot, torch.autograd.grad(loss, [hot[n] for n in opt.hot])))
    jloss, jgrads = _jax_grads_as_port(jcfg, qparams, batch, hot=("encoder", "adaptor"))
    assert abs(loss.item() - jloss) <= 1e-5 * abs(jloss)
    _assert_grads_close(grads, jgrads, opt.hot)


def test_unported_options_raise(tiny):
    jcfg, params, batch = tiny
    cfg = _port_cfg(jcfg)
    model = _port_model(jcfg, params)
    with pytest.raises(ValueError, match="lora_only: stage '3_full_ft' leaves no LoRA"):
        tts.make_optimizer(AF3_STAGES["3_full_ft"], model, lora_only=True)
    state, opt = tts.init_state(model, AF3_STAGES["1_pretrain"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tts.train_step(state, _torch_batch(batch), cfg=cfg, opt=opt, sp_mesh=object())
    with pytest.raises(NotImplementedError, match="weights' dtype"):
        tts.train_step(state, _torch_batch(batch), cfg=cfg, opt=opt,
                       compute_dtype=torch.bfloat16)
    qmodel = _port_model(jcfg, {**params, "lm": j_quantize_lm_params(params["lm"])})
    with pytest.raises(NotImplementedError, match="quantized codes.*lora_only=True"):
        tts.init_state(qmodel, AF3_STAGES["3_full_ft"])
