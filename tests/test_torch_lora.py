"""The port's LoRA / QLoRA (models/lora.py and ops/lora.py, threaded through models/qwen2.py and
train/train_step.py) against the JAX package at f32: identity at init on the float, int8
and fused-qkv trees (the fused tree gets JAX's adapter set), the forward with non-zero
adapters on the float, int8 and a8 paths, the adapter gradients of a QLoRA loss against
JAX's value_and_grad over the partition_lora leaves, one make_optimizer(lora_only=True)
step against optax's, the adapter files across the two packages both ways, merge_lora,
and the refusals (an int8 merge, an int4 base, a fused gate|up)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.config import AF3Config as JAF3Config
from audio_flamingo_tpu.config import Qwen2Config as JQwen2Config
from audio_flamingo_tpu.io.safetensors import load_safetensors as j_load_safetensors
from audio_flamingo_tpu.models import af3 as jaf3
from audio_flamingo_tpu.models import qwen2 as jqwen2
from audio_flamingo_tpu.ops import lora as jlora
from audio_flamingo_tpu.ops.quant import quantize_lm_params as j_quantize_lm_params
from audio_flamingo_tpu.ops.quant4 import quantize_lm_params_w4 as j_quantize_w4
from audio_flamingo_tpu.train import train_step as jts
from audio_flamingo_tpu.train.stages import AF3_STAGES as J_STAGES
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.io.convert import (lm_params_from_jax, lm_params_to_jax,
                                                 params_from_jax)
from audio_flamingo_tpu_torch.io.safetensors import load_safetensors
from audio_flamingo_tpu_torch.models import af3, lora, qwen2
from audio_flamingo_tpu_torch.ops import lora as lora_ops
from audio_flamingo_tpu_torch.train import train_step as tts
from audio_flamingo_tpu_torch.train.stages import AF3_STAGES

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

RANK = 4
# q|k|v and gate|up fuse into w4 (hidden 256 splits into groups); o (K = 2 x 64 = 128)
# and down stay int8 where they do not split, so o can carry adapters
JLM = JQwen2Config(vocab_size=128, hidden_size=256, intermediate_size=512, num_layers=2,
                   num_heads=2, num_kv_heads=1, head_dim=64, tie_word_embeddings=False)


def _pick(cls, obj):
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})


def _port_cfg(j):
    return C.AF3Config(encoder=_pick(C.WhisperEncoderConfig, j.encoder),
                       lm=_pick(C.Qwen2Config, j.lm), audio_token_id=j.audio_token_id)


def _lively(tree: dict, seed: int) -> dict:
    """A JAX adapter tree with lora_b off zero (seeded numpy), so that adapters act."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: (jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * 0.03)
                        if k == "lora_b" else walk(v)) for k, v in node.items()}
        return node
    return walk(tree)


def _with_adapter_slots(lm, sd: dict, prefix: str = "") -> None:
    """Give a float Qwen2 the adapters a state dict carries (rank, targets), so that
    load_state_dict can fill them."""
    targets = tuple(t for t, m in lora.MODULES.items() if f"{prefix}layers.0.{m}.lora_a" in sd)
    if targets:
        rank = sd[f"{prefix}layers.0.{lora.MODULES[targets[0]]}.lora_a"].shape[-1]
        lora.add_lora(torch.Generator().manual_seed(0), lm, rank=rank, targets=targets)


def _port_lm(jtree: dict, jcfg) -> torch.nn.Module:
    """The port's LM at f32 on the CPU from a JAX Qwen2 tree (float or quantized, with or
    without adapters)."""
    cfg = _pick(C.Qwen2Config, jcfg)
    sd = lm_params_from_jax(jax.tree.map(np.asarray, jtree), cfg)
    if "embed_tokens" not in sd:
        return qwen2.quantized_lm(qwen2.unflatten(sd), torch.float32, "cpu")
    with torch.device("meta"):
        lm = qwen2.Qwen2(cfg, dtype=torch.float32)
    lm = lm.to_empty(device="cpu").requires_grad_(False)
    _with_adapter_slots(lm, sd)
    lm.load_state_dict(sd)
    return lm


def _port_model(jcfg, params) -> af3.AF3Model:
    cfg = _port_cfg(jcfg)
    sd = params_from_jax(jax.tree.map(np.asarray, params), cfg)
    qlm = None
    if "lm.ln_f_w" in sd:
        qlm = qwen2.quantized_lm(qwen2.unflatten({k[3:]: v for k, v in sd.items()
                                                  if k.startswith("lm.")}), torch.float32, "cpu")
        sd = {k: v for k, v in sd.items() if not k.startswith("lm.")}
    model = af3.build(cfg, "cpu", torch.float32, lm=qlm)
    if qlm is None:
        _with_adapter_slots(model.lm, sd, "lm.")
    model.load_state_dict(sd, strict=qlm is None)
    return model


def _logits(lm, cfg, ids: np.ndarray) -> np.ndarray:
    b, t = ids.shape
    with torch.inference_mode():
        x = qwen2.embed(lm, torch.from_numpy(ids).long())
        h, _ = qwen2.forward(lm, cfg, x, torch.arange(t)[None].expand(b, t))
        return qwen2.unembed(lm, h).numpy()


@pytest.fixture(scope="module")
def base():
    params = jqwen2.init(jax.random.PRNGKey(0), JLM)
    ids = np.random.default_rng(0).integers(0, 128, (2, 24)).astype(np.int32)
    return params, ids


def _jax_adapter_names(tree: dict) -> set:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(p.key for p in path) for path, _ in flat if path[-1].key == "lora_a"}


def _port_adapter_names(lm) -> set:
    return {("layers/mlp/" if t in lora.MLP_TARGETS else "layers/") + t + "/lora_a"
            for t in lora.adapters(lm)}


@pytest.mark.parametrize("layout", ["float", "int8", "fused_w4"])
def test_identity_at_init(base, layout):
    """add_lora leaves the logits bit-identical; on the fused-qkv w4 tree (qkv and gate|up
    packed int4, o int8) the attention targets give adapters on o alone, as JAX's."""
    params, ids = base
    tree = {"float": lambda p: p, "int8": j_quantize_lm_params,
            "fused_w4": lambda p: j_quantize_w4(p, fuse=True)}[layout](params)
    cfg = _pick(C.Qwen2Config, JLM)
    lm = _port_lm(tree, JLM)
    before = _logits(lm, cfg, ids)
    targets = lora.ATTN_TARGETS if layout == "fused_w4" else lora.DEFAULT_TARGETS
    lora.add_lora(torch.Generator().manual_seed(1), lm, rank=RANK, targets=targets)
    assert np.array_equal(_logits(lm, cfg, ids), before)
    jtree = jlora.add_lora(jax.random.PRNGKey(3), tree, rank=RANK, targets=targets)
    assert _port_adapter_names(lm) == _jax_adapter_names(jtree)
    if layout == "fused_w4":
        assert _port_adapter_names(lm) == {"layers/o/lora_a"}
    for t, leaves in lora.adapters(lm).items():
        assert leaves["lora_a"].shape[::2] == (JLM.num_layers, RANK)
        assert not leaves["lora_b"].any() and leaves["lora_s"].eq(1.0).all()
        assert all(not p.requires_grad for p in leaves.values())


def test_refusals(base):
    """An int4 base refuses adapters (JAX's assert), a fused gate|up refuses the mlp
    targets (JAX's KeyError), an int8 base refuses merge_lora (JAX's assert)."""
    params, _ = base
    gen = torch.Generator().manual_seed(0)
    w4 = _port_lm(j_quantize_w4(params, fuse=False), JLM)
    with pytest.raises(ValueError, match="fused-w4 trees cannot carry adapters"):
        lora.add_lora(gen, w4, rank=RANK)
    with pytest.raises(AssertionError):
        jlora.add_lora(jax.random.PRNGKey(0), j_quantize_w4(params, fuse=False), rank=RANK)
    fused = _port_lm(j_quantize_w4(params, fuse=True), JLM)
    with pytest.raises(KeyError, match="fused gate"):
        lora.add_lora(gen, fused, rank=RANK)
    with pytest.raises(KeyError):
        jlora.add_lora(jax.random.PRNGKey(0), j_quantize_w4(params, fuse=True), rank=RANK)
    int8 = lora.add_lora(gen, _port_lm(j_quantize_lm_params(params), JLM), rank=RANK)
    with pytest.raises(ValueError, match="dense float base"):
        lora.merge_lora(int8)


@pytest.mark.parametrize("layout", ["float", "int8", "fused_w4"])
def test_forward_with_adapters_matches_jax(base, layout):
    """Non-zero lora_b on every target: logits against JAX qwen2.forward within 1e-4 of
    max|logit|."""
    params, ids = base
    tree = {"float": lambda p: p, "int8": j_quantize_lm_params,
            "fused_w4": lambda p: j_quantize_w4(p, fuse=True)}[layout](params)
    targets = lora.ATTN_TARGETS if layout == "fused_w4" else lora.DEFAULT_TARGETS
    jtree = _lively(jlora.add_lora(jax.random.PRNGKey(3), tree, rank=RANK, targets=targets), 7)
    want = np.asarray(jqwen2.logits_from_ids(jtree, JLM, jnp.asarray(ids)))
    got = _logits(_port_lm(jtree, JLM), _pick(C.Qwen2Config, JLM), ids)
    off = np.asarray(jqwen2.logits_from_ids(tree, JLM, jnp.asarray(ids)))
    assert np.abs(want - off).max() > 1e-2 * np.abs(want).max()     # the adapters act
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_a8_path_with_adapters_matches_jax(base):
    """The a8 prefill of an int8 LM with adapters: every linear (q|k|v and gate|up on one
    shared activation quantization, o and down on their own) against eager JAX's
    ``_linear_shared_a8`` / ``_linear(a8=True)`` within 1e-4 of max|y|, adapters on the
    float activation. Through the whole LM the a8 model moves by its activation codes (a
    code at a rounding edge follows the attention's sum order, and the adapters' q moves
    the attention), so the logits are held to JAX's a8 band, 5e-2 of max|logit|
    (tests/test_torch_quant_a8.py), with equal argmax."""
    from audio_flamingo_tpu.ops.quant import quantize_act as j_quantize_act
    from audio_flamingo_tpu_torch.ops.quant import quantize_act

    params, ids = base
    jtree = _lively(jlora.add_lora(jax.random.PRNGKey(3), j_quantize_lm_params(params),
                                   rank=RANK), 7)
    lm = _port_lm(jtree, JLM)
    rng = np.random.default_rng(1)
    for i in range(JLM.num_layers):
        lp = jax.tree.map(lambda a: a[i], jtree["layers"])
        for names, k in ((("q", "k", "v"), JLM.hidden_size), (("o",), 128),
                         (("gate", "up"), JLM.hidden_size), (("down",), JLM.intermediate_size)):
            x = rng.normal(size=(2, 24, k)).astype(np.float32)
            xt = torch.from_numpy(x)
            with jax.disable_jit():
                xq = j_quantize_act(jnp.asarray(x))
                for n in names:
                    jp = lp["mlp"][n] if n in lora.MLP_TARGETS else lp[n]
                    want = np.asarray(jqwen2._linear_shared_a8(xq, jnp.asarray(x), jp))
                    node = lm.layers["mlp"][n] if n in lora.MLP_TARGETS else lm.layers[n]
                    got = qwen2._qlinear_a8(quantize_act(xt), xt, node, i).detach().numpy()
                    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), (i, n)
    jc = dataclasses.replace(JLM, a8_prefill=True)
    want = np.asarray(jqwen2.logits_from_ids(jtree, jc, jnp.asarray(ids)))
    got = _logits(lm, _pick(C.Qwen2Config, jc), ids)
    assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()
    assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.fixture(scope="module")
def tiny():
    """Tiny AF3 (vocab 256) with rank-4 adapters (lora_b off zero) on its LM, and a 2-row
    batch with a 30 s window of mels a row."""
    cfg = JAF3Config.tiny()
    cfg = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, vocab_size=256))
    params = jaf3.init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    b, t = 2, 32
    ids = rng.integers(5, 250, (b, t)).astype(np.int32)
    ids[:, 1:9] = cfg.audio_token_id
    labels = ids.copy()
    labels[:, :12] = -100
    mels = (rng.normal(size=(b, 1, 3000, cfg.encoder.num_mel_bins)) * 0.1).astype(np.float32)
    return cfg, params, {"ids": ids, "labels": labels, "mels": mels}


def _jax_loss_fn(jcfg, batch):
    def fn(params):
        return jaf3.loss(params, jcfg, jnp.asarray(batch["ids"]), jnp.asarray(batch["labels"]),
                         jnp.asarray(batch["mels"]), compute_dtype=jnp.float32)
    return fn


def test_qlora_adapter_grads_match_jax(tiny):
    """QLoRA: an int8 LM with adapters; JAX differentiates the partition_lora leaves, the
    port make_optimizer(lora_only=True)'s hot set. Loss within 1e-5, each adapter gradient
    within 1e-4 of its largest; the base codes get no gradient."""
    jcfg, params, batch = tiny
    jlm = _lively(jlora.add_lora(jax.random.PRNGKey(3), j_quantize_lm_params(params["lm"]),
                                 rank=RANK), 5)
    jparams = {**params, "lm": jlm}
    leaves, base_leaves, rebuild = jlora.partition_lora(jparams)
    loss_fn = _jax_loss_fn(jcfg, batch)
    jloss, jg = jax.value_and_grad(lambda lv: loss_fn(rebuild(lv, base_leaves)))(leaves)
    jgrads = rebuild([np.asarray(g) for g in jg], [np.zeros(np.shape(x)) for x in base_leaves])
    want = lm_params_from_jax(jax.tree.map(np.asarray, jgrads["lm"]), _port_cfg(jcfg).lm, "lm.")
    model = _port_model(jcfg, jparams)
    state, opt = tts.init_state(model, AF3_STAGES["3_full_ft"], lora_only=True, warmup_steps=0,
                                total_steps=5)
    assert set(opt.hot) == {k for k in want if k.split(".")[-1] in ("lora_a", "lora_b")}
    loss, grads = tts.loss_and_grads(model, {k: torch.from_numpy(v) for k, v in batch.items()},
                                     cfg=_port_cfg(jcfg), opt=opt)
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert set(grads) == set(opt.hot)
    assert {n for n, hot in lora_ops.lora_mask(model).items() if hot} == set(opt.hot)
    for n in opt.hot:
        w = want[n].numpy()
        assert np.abs(grads[n].numpy() - w).max() <= 1e-4 * np.abs(w).max(), n
    assert all(not p.requires_grad for n, p in model.named_parameters() if n not in opt.hot)
    # a QLoRA step: the adapters move, the int8 base and everything else stay bit-identical
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tts.train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                   cfg=_port_cfg(jcfg), opt=opt)
    after = model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items() if k not in opt.hot)
    assert all(not torch.equal(after[k], before[k]) for k in opt.hot)


def test_lora_only_step_matches_optax(tiny):
    """One train_step with make_optimizer(lora_only=True) on a float base with adapters
    (stage 3: the LM's adapters hot, the encoder, adaptor and base frozen) against JAX's
    train_step with the same optimizer: loss and grad norm within 1e-5 relative, the
    updated adapters within 1e-5 of their largest change (plus one f32 spacing of the
    weight, where p + change rounds), every other tensor bit-identical."""
    jcfg, params, batch = tiny
    jparams = {**params, "lm": _lively(jlora.add_lora(jax.random.PRNGKey(3), params["lm"],
                                                      rank=RANK), 6)}
    stage = "3_full_ft"
    jstate, jopt = jts.init_state(jparams, J_STAGES[stage], warmup_steps=0, total_steps=5,
                                  lora_only=True)
    jstate, jm = jts.train_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                cfg=jcfg, opt=jopt, compute_dtype=jnp.float32)
    model = _port_model(jcfg, jparams)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, opt = tts.init_state(model, AF3_STAGES[stage], warmup_steps=0, total_steps=5,
                                lora_only=True)
    state, m = tts.train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                              cfg=_port_cfg(jcfg), opt=opt)
    assert abs(m["loss"].item() - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
    assert abs(m["grad_norm"].item() - float(jm["grad_norm"])) <= 1e-5 * float(jm["grad_norm"])
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params), _port_cfg(jcfg))
    got = model.state_dict()
    largest = max((got[n] - before[n]).abs().max().item() for n in opt.hot)
    assert largest > 0
    for n in opt.hot:
        # beyond 1e-5 of the largest change, p + change may round to the neighbouring f32
        lim = 1e-5 * largest + np.spacing(np.abs(want[n].numpy()))
        assert ((got[n] - want[n]).abs().numpy() <= lim).all(), n
    for n, v in got.items():
        if n not in opt.hot:
            assert torch.equal(v, before[n]), n


@pytest.mark.parametrize("layout", ["float", "int8"])
def test_adapter_files_cross_both_ways(base, tmp_path, layout):
    """save_lora of either package loads in the other (the same tensors, JAX's names and
    metadata), and lm_params_to_jax gives back JAX's adapter tree (the float mlp entries
    wrapped as JAX wraps them)."""
    params, ids = base
    tree = params if layout == "float" else j_quantize_lm_params(params)
    jtree = _lively(jlora.add_lora(jax.random.PRNGKey(3), tree, rank=RANK), 8)
    cfg = _pick(C.Qwen2Config, JLM)
    # JAX -> port
    jlora.save_lora(str(tmp_path / "j.safetensors"), jtree)
    lm = lora.load_lora(str(tmp_path / "j.safetensors"), _port_lm(tree, JLM))
    ref = _port_lm(jtree, JLM)
    for t, leaves in lora.adapters(ref).items():
        for k, v in leaves.items():
            assert torch.equal(lora.adapters(lm)[t][k], v), (t, k)
    assert np.array_equal(_logits(lm, cfg, ids), _logits(ref, cfg, ids))
    # port -> JAX
    lora.save_lora(str(tmp_path / "p.safetensors"), ref)
    from audio_flamingo_tpu.io.safetensors import SafetensorsFile
    assert SafetensorsFile(str(tmp_path / "p.safetensors")).metadata == {"format": "lora"}
    assert (set(j_load_safetensors(str(tmp_path / "p.safetensors")))
            == set(load_safetensors(str(tmp_path / "j.safetensors"))))
    back = jlora.load_lora(str(tmp_path / "p.safetensors"), tree)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        node = back
        for p in path:
            node = node[p.key]
        assert np.array_equal(np.asarray(node), np.asarray(leaf)), path
    flat = lm_params_to_jax(ref.state_dict(), cfg)
    want = {".".join(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    assert set(flat) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], v.astype(flat[k].dtype), err_msg=k)


def test_merge_matches_jax(base):
    """merge_lora on a float base against JAX's: the merged weights within 1e-6 of
    max|w|, no adapter left, the merged logits equal to the adapted ones within 1e-4."""
    params, ids = base
    jtree = _lively(jlora.add_lora(jax.random.PRNGKey(3), params, rank=RANK), 9)
    cfg = _pick(C.Qwen2Config, JLM)
    lm = _port_lm(jtree, JLM)
    adapted = _logits(lm, cfg, ids)
    lora.merge_lora(lm)
    assert not lora.adapters(lm) and not any("lora" in n for n in lm.state_dict())
    want = lm_params_from_jax(jax.tree.map(np.asarray, jlora.merge_lora(jtree)), cfg)
    for n, v in lm.state_dict().items():
        w = want[n].numpy()
        assert np.abs(v.numpy() - w).max() <= 1e-6 * max(1.0, np.abs(w).max()), n
    merged = _logits(lm, cfg, ids)
    assert np.abs(merged - adapted).max() <= 1e-4 * np.abs(adapted).max()
