"""The port's CLAP text tower (models/clap_text.py) and the AF2 HF importers
(io/hf_import.py) against the JAX package at f32: ``encode`` (pooled and embeds, padded
rows) and ``contrastive_loss`` within 1e-4, the weights across both ways, and
``import_clap_audio`` (with and without fusion), ``import_clap_text`` and ``import_opt``
on seeded HF state dicts (transformers' ClapModel and OPTForCausalLM) against JAX's
importers crossed through io/convert: equal tensors."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.config import ClapAudioConfig as JClapAudioConfig
from audio_flamingo_tpu.config import OPTConfig as JOPTConfig
from audio_flamingo_tpu.io import hf_import as jhf
from audio_flamingo_tpu.models import clap_text as jclap_text
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.io import hf_import
from audio_flamingo_tpu_torch.io.convert import (clap_params_from_jax, clap_text_params_from_jax,
                                                 clap_text_params_to_jax, opt_params_from_jax)
from audio_flamingo_tpu_torch.models import clap_text

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

JCFG = jclap_text.ClapTextConfig(vocab_size=100, hidden_size=32, num_layers=2, num_heads=4,
                                 intermediate_size=64, max_position_embeddings=40,
                                 projection_dim=16)
CFG = clap_text.ClapTextConfig(**dataclasses.asdict(JCFG))


def _pick(cls, obj):
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})


def _tower(params) -> clap_text.ClapTextTower:
    tower = clap_text.build(CFG, "cpu", torch.float32)
    tower.load_state_dict(clap_text_params_from_jax(jax.tree.map(np.asarray, params), CFG))
    return tower


def test_encode_matches_jax():
    params = jclap_text.init(jax.random.PRNGKey(0), JCFG)
    rng = np.random.default_rng(0)
    ids = rng.integers(2, 100, size=(3, 11)).astype(np.int64)
    ids[1, 7:] = 1                                     # pads
    ids[2, 4:] = 1
    mask = (ids != 1).astype(np.int64)
    tower = _tower(params)
    for m in (mask, None):
        want = jclap_text.encode(params, JCFG, jnp.asarray(ids),
                                 None if m is None else jnp.asarray(m))
        with torch.no_grad():
            got = clap_text.encode(tower, CFG, torch.from_numpy(ids),
                                   None if m is None else torch.from_numpy(m))
        for k in ("pooled", "embeds"):
            w = np.asarray(want[k])
            assert np.abs(got[k].numpy() - w).max() <= 1e-4 * np.abs(w).max(), k
    back = clap_text_params_to_jax(tower.state_dict(), CFG)
    flat = {".".join(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert set(back) == set(flat)
    assert all(np.array_equal(back[k], flat[k]) for k in flat)


def test_init_distributions():
    tower = clap_text.build(CFG, "cpu", torch.float32)
    clap_text.init_(tower, torch.Generator().manual_seed(0))
    jp = jclap_text.init(jax.random.PRNGKey(0), JCFG)
    std = lambda x: float(np.asarray(x).std())   # noqa: E731
    assert abs(tower.word_emb.std().item() - std(jp["word_emb"])) < 2e-3
    assert abs(tower.layers[0].fc1.weight.std().item() - std(jp["layers"]["fc1"]["w"][0])) < 0.01
    assert not tower.pooler.bias.any() and tower.ln_emb.weight.eq(1).all()


def test_contrastive_loss_matches_jax():
    rng = np.random.default_rng(1)
    a, t = rng.normal(size=(2, 5, 16)).astype(np.float32)
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    for sa, st in ((2.3, 2.6), (0.0, 1.0)):
        want = float(jclap_text.contrastive_loss(jnp.asarray(a), jnp.asarray(t),
                                                 jnp.asarray(sa), jnp.asarray(st)))
        got = clap_text.contrastive_loss(torch.from_numpy(a), torch.from_numpy(t),
                                         torch.tensor(sa), torch.tensor(st)).item()
        assert abs(got - want) <= 1e-4 * abs(want)


@pytest.fixture(scope="module")
def hf_clap():
    from transformers.models.clap.configuration_clap import ClapAudioConfig as HFAudio
    from transformers.models.clap.configuration_clap import ClapConfig
    from transformers.models.clap.configuration_clap import ClapTextConfig as HFText
    from transformers.models.clap.modeling_clap import ClapModel

    def make(fusion: bool):
        txt = HFText(vocab_size=100, hidden_size=32, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=64, max_position_embeddings=40,
                     projection_dim=16)
        aud = HFAudio(num_mel_bins=16, spec_size=64, patch_size=4, patch_stride=[4, 4],
                      patch_embeds_hidden_size=24, depths=[2, 2], num_attention_heads=[2, 4],
                      window_size=4, enable_fusion=fusion, fusion_type=None, projection_dim=16)
        torch.manual_seed(0)
        model = ClapModel(ClapConfig(text_config=txt.to_dict(), audio_config=aud.to_dict(),
                                     projection_dim=16))
        return {k: v.numpy() for k, v in model.state_dict().items()}

    return {fusion: make(fusion) for fusion in (False, True)}


def _equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("fusion", [False, True])
def test_import_clap_audio_matches_jax(hf_clap, fusion):
    jcfg = JClapAudioConfig(num_mel_bins=16, spec_size=64, patch_size=4, patch_stride=4,
                            patch_embed_dim=24, depths=(2, 2), num_heads=(2, 4), window_size=4,
                            projection_dim=16, enable_fusion=fusion)
    cfg = _pick(C.ClapAudioConfig, jcfg)
    sd = hf_clap[fusion]
    want = clap_params_from_jax(jax.tree.map(np.asarray, jhf.import_clap_audio(sd, jcfg)), cfg)
    _equal(hf_import.import_clap_audio(sd, cfg), want)


def test_import_clap_text_matches_jax(hf_clap):
    sd = hf_clap[False]
    want = clap_text_params_from_jax(jax.tree.map(np.asarray, jhf.import_clap_text(sd, JCFG)), CFG)
    got = hf_import.import_clap_text({k: torch.from_numpy(v) for k, v in sd.items()}, CFG)
    _equal(got, want)
    tower = clap_text.build(CFG, "cpu", torch.float32)
    tower.load_state_dict(got)                         # every weight of the tower


def test_import_opt_matches_jax():
    from transformers import OPTConfig as HFOPTConfig
    from transformers import OPTForCausalLM

    from audio_flamingo_tpu_torch.models import opt

    hf_cfg = HFOPTConfig(vocab_size=100, hidden_size=32, ffn_dim=64, num_hidden_layers=2,
                         num_attention_heads=4, max_position_embeddings=64,
                         do_layer_norm_before=True, dropout=0.0, word_embed_proj_dim=16)
    torch.manual_seed(0)
    sd = {k: v.numpy() for k, v in OPTForCausalLM(hf_cfg).state_dict().items()}
    jcfg = JOPTConfig(vocab_size=100, hidden_size=32, ffn_dim=64, num_layers=2, num_heads=4,
                      max_position_embeddings=64, word_embed_proj_dim=16)
    cfg = _pick(C.OPTConfig, jcfg)
    want = opt_params_from_jax(jax.tree.map(np.asarray, jhf.import_opt(sd, jcfg)), cfg)
    got = hf_import.import_opt(sd, cfg)
    _equal(got, want)
    opt.build(cfg, "cpu", torch.float32).load_state_dict(got)
