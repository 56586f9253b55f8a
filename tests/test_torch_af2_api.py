"""Port's AudioFlamingo2 against the JAX package's at f32, on the same weights (crossed by
io/convert) and tokenizer: the same answer string for a short clip, a 15 s multi-window
clip and a two-turn chat; encode_audio; save_af2 / load_af2 both ways (JAX's file read by
the port, the port's by JAX); the AF1 (OPT) round trip; and the configs against JAX's."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from audio_flamingo_tpu import api as japi
from audio_flamingo_tpu import config as JC
from audio_flamingo_tpu_torch import api
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.io.convert import af2_params_from_jax, clap_params_from_jax
from audio_flamingo_tpu_torch.runtime.tokenizer import BBPETokenizer

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

SR = 48_000
# tests/test_af2_pipeline.py's small HTSAT
JCLAP = JC.ClapAudioConfig(num_mel_bins=64, spec_size=64, patch_size=4, patch_stride=4,
                           patch_embed_dim=24, depths=(2, 2), num_heads=(2, 4), window_size=4,
                           projection_dim=512, enable_fusion=True)
TONE = (0.2 * np.sin(2 * np.pi * 440 * np.arange(SR * 2) / SR)).astype(np.float32)
NOISE = (np.random.default_rng(0).normal(size=SR * 15) * 0.1).astype(np.float32)


def _pick(cls, obj, **kw):
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)}, **kw)


def port_cfg(j) -> C.AF2Config:
    lm_cls = C.OPTConfig if isinstance(j.lm, JC.OPTConfig) else C.Qwen2Config
    return C.AF2Config(clap=_pick(C.ClapAudioConfig, j.clap), lm=_pick(lm_cls, j.lm),
                       xattn=_pick(C.GatedXAttnConfig, j.xattn),
                       num_audio_transform_layers=j.num_audio_transform_layers,
                       audio_embed_dim=j.audio_embed_dim, mel=_pick(C.ClapMelConfig, j.mel))


def _lively(params: dict) -> dict:
    """Nonzero gates and a livelier LM (see tests/test_torch_flamingo.py)."""
    rng = np.random.default_rng(1)
    params = jax.tree.map(np.asarray, params)
    n_x = params["xattn"]["alpha_xattn"].shape[0]
    params["xattn"]["alpha_xattn"] = rng.uniform(0.5, 1.5, n_x).astype(np.float32)
    params["xattn"]["alpha_dense"] = rng.uniform(-1.0, 1.0, n_x).astype(np.float32)
    lm = params["lm"]
    for p in lm["layers"].values():
        if isinstance(p, dict) and "w" in p:
            p["w"] = p["w"] * 3.0
    if "pos_embed" in lm:
        lm["embed"], lm["pos_embed"] = lm["embed"] * 3.0, lm["pos_embed"] * 30.0
    else:
        lm["embed"] = lm["embed"] * 30.0
    return params


def _port_model(jm) -> api.AudioFlamingo2:
    cfg, clap_cfg = port_cfg(jm.cfg), _pick(C.ClapAudioConfig, jm.clap_tower.cfg)
    tok = jm.processor.tokenizer
    return api.AudioFlamingo2.from_state_dicts(
        cfg, clap_cfg, af2_params_from_jax(jm.params, cfg),
        clap_params_from_jax(jm.clap_params, clap_cfg), BBPETokenizer(tok.vocab, tok.merges),
        device="cpu")


@pytest.fixture(scope="module")
def models():
    jm = japi.AudioFlamingo2.from_random(clap_cfg=JCLAP)
    jm.params = _lively(jm.params)
    return jm, _port_model(jm)


@pytest.mark.parametrize("clip", ["short", "15s"])
def test_generate_matches_jax(models, clip):
    jm, tm = models
    wav = TONE if clip == "short" else NOISE
    want = jm.generate(sound=wav, prompt="Describe.", max_new_tokens=8)
    got = tm.generate(sound=wav, prompt="Describe.", max_new_tokens=8)
    assert got == want
    if clip == "15s":
        assert len(set(tm.last_output.tokens[0].tolist())) > 1
    nw = 1 if clip == "short" else 2
    assert tm.last_tower_s >= 0 and tm.last_processor_s > 0
    assert tm.last_output.tokens.shape == (1, 8)
    batch = tm.processor(text="<sound>", audios=[wav])
    assert batch["mels"].shape[:2] == (1, nw)


def test_two_turn_chat_matches_jax(models):
    """The second turn re-reads the first turn's clip from the history."""
    jm, tm = models
    answers = []
    for m in (jm, tm):
        m.reset_chat()
        first = m.generate(sound=TONE, prompt="What is this?", max_new_tokens=6, chat=True)
        second = m.generate(prompt="And then?", max_new_tokens=6, chat=True)
        answers.append((first, second))
        assert len(m.history) == 4
    assert answers[1] == answers[0]


def test_encode_audio_matches_jax(models):
    jm, tm = models
    batch = tm.processor(text="a <sound> b <sound>", audios=[TONE, NOISE])
    jbatch = jm.processor(text="a <sound> b <sound>", audios=[TONE, NOISE])
    want = np.asarray(jm.encode_audio(jbatch["mels"], jbatch["is_longer"]))
    got = tm.encode_audio(batch["mels"], batch["is_longer"]).numpy()
    assert got.shape == want.shape == (1, 2, 2, 512)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_jax_save_read_by_port(models, tmp_path):
    jm, _ = models
    japi.save_af2(str(tmp_path), jm)
    tm = api.load_af2(str(tmp_path), device="cpu")
    assert tm.cfg == port_cfg(jm.cfg)
    assert tm.generate(sound=NOISE, prompt="Describe.", max_new_tokens=8) == \
        jm.generate(sound=NOISE, prompt="Describe.", max_new_tokens=8)


def test_port_save_read_by_jax(models, tmp_path):
    jm, tm = models
    api.save_af2(str(tmp_path), tm)
    jm2 = japi.load_af2(str(tmp_path))
    for got, want in ((jm2.params, jm.params), (jm2.clap_params, jm.clap_params)):
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert jm2.generate(sound=TONE, prompt="Describe.", max_new_tokens=8) == \
        tm.generate(sound=TONE, prompt="Describe.", max_new_tokens=8)


def test_af1_opt_round_trip(tmp_path):
    """AF1 (OPT) written by the port, read by JAX and by the port: one answer."""
    jcfg = JC.AF1Config.make(
        lm=JC.OPTConfig(vocab_size=512, hidden_size=32, ffn_dim=64, num_layers=2, num_heads=4,
                        max_position_embeddings=256),
        xattn=JC.GatedXAttnConfig(cross_every_n_layers=1, num_heads=4, ffn_mult=2),
        audio_embed_dim=512)
    jm = japi.AudioFlamingo2.from_random(cfg=jcfg, clap_cfg=JCLAP)
    jm.params = _lively(jm.params)
    tm = _port_model(jm)
    api.save_af2(str(tmp_path), tm)
    back = api.load_af2(str(tmp_path), device="cpu")
    want = jm.generate(sound=TONE, prompt="Describe.", max_new_tokens=6)
    assert tm.generate(sound=TONE, prompt="Describe.", max_new_tokens=6) == want
    assert back.generate(sound=TONE, prompt="Describe.", max_new_tokens=6) == want
    assert japi.load_af2(str(tmp_path)).generate(sound=TONE, prompt="Describe.",
                                                 max_new_tokens=6) == want


@pytest.mark.parametrize("with_audio", [False, True])
def test_think_puts_the_instruction_after_the_audio(models, with_audio):
    """think=True against JAX's user turn. Without a clip both write the same turn and
    answer alike. With one, JAX drops the instruction when it prepends <sound> (JAX
    api.py:227-232), a known difference that the port does not copy: its turn is JAX's
    plus the instruction, and it answers as JAX does when given that turn as the prompt."""
    jm, tm = models
    sound = TONE if with_audio else None
    turns, answers = [], []
    for m in (jm, tm):
        m.reset_chat()
        answers.append(m.generate(sound=sound, prompt="Why?", max_new_tokens=4, think=True,
                                  chat=True))
        turns.append(m.history[-2]["content"])
        m.reset_chat()
    jax_turn, port_turn = turns
    if with_audio:
        assert jax_turn == "<sound>Why?"
        assert port_turn == f"{jax_turn}\n{tm.THINK_INSTRUCTION}"
        assert answers[1] == jm.generate(sound=sound, prompt=port_turn, max_new_tokens=4)
    else:
        assert port_turn == jax_turn == f"Why?\n{tm.THINK_INSTRUCTION}"
        assert answers[1] == answers[0]


def test_beams_raise_until_ported(models):
    """Beams are served now (runtime/beam.generate_beam_xattn on the exact prompt): the
    same answer as JAX's for num_beams = 2 and 3, the best beam cut at its first EOS."""
    jm, tm = models
    for kw in (dict(num_beams=2), dict(num_beams=3, length_penalty=1.5)):
        want = jm.generate(sound=NOISE, prompt="Describe.", max_new_tokens=6, **kw)
        got = tm.generate(sound=NOISE, prompt="Describe.", max_new_tokens=6, **kw)
        assert got == want
        assert tm.last_output is None


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card rule")
def test_entry_points_need_a_card_or_a_device(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        api.AudioFlamingo2.from_random()
    with pytest.raises(RuntimeError, match="CUDA"):
        api.load_af2(str(tmp_path))


def test_from_random_is_seeded():
    cfg = C.AF2Config(lm=C.Qwen2Config(vocab_size=512, hidden_size=32, intermediate_size=64,
                                       num_layers=2, num_heads=4, num_kv_heads=2,
                                       tie_word_embeddings=True),
                      xattn=C.GatedXAttnConfig(num_heads=4, ffn_mult=2),
                      num_audio_transform_layers=1, audio_embed_dim=512)
    clap_cfg = _pick(C.ClapAudioConfig, JCLAP)
    a, b = (api.AudioFlamingo2.from_random(cfg, seed=3, clap_cfg=clap_cfg, device="cpu")
            for _ in range(2))
    for x, y in zip(list(a.model.state_dict().values()) + list(a.tower.state_dict().values()),
                    list(b.model.state_dict().values()) + list(b.tower.state_dict().values())):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------- configs

@pytest.mark.parametrize("name", ["AF2Config", "ClapMelConfig", "ClapAudioConfig", "OPTConfig",
                                  "GatedXAttnConfig", "AF1", "qwen25_3b", "qwen25_1_5b"])
def test_configs_match_jax(name):
    """Every field the port has, with JAX's default (the port's Qwen2Config leaves out
    max_position_embeddings, which JAX's Qwen2 reads nowhere)."""
    make = {"AF1": lambda m: m.AF1Config.make(), "qwen25_3b": lambda m: m.Qwen2Config.qwen25_3b(),
            "qwen25_1_5b": lambda m: m.Qwen2Config.qwen25_1_5b()}.get(
        name, lambda m: getattr(m, name)())

    def compare(got, want):
        for f in dataclasses.fields(got):
            g, w = getattr(got, f.name), getattr(want, f.name)
            if dataclasses.is_dataclass(g):
                compare(g, w)
            else:
                assert g == w, f"{type(got).__name__}.{f.name}: {g} != {w}"

    compare(make(C), make(JC))


def test_af3_config_parity_fields_match_jax():
    for got, want in ((C.AF3Config(), JC.AF3Config()),
                      (C.AF3Config.music_flamingo(), JC.AF3Config.music_flamingo())):
        assert (got.adaptor_hidden, got.max_windows) == (want.adaptor_hidden, want.max_windows)
        assert dataclasses.asdict(got.mel) == dataclasses.asdict(want.mel)
    assert C.AF3Config.music_flamingo().max_windows == 30
