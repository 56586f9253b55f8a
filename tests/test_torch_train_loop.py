"""Port's training loop: loop.run lowers the loss and keeps the frozen parts as they were
(as tests/test_train.py does for JAX), save-then-resume equals an uninterrupted run, a
checkpoint of other parameters is refused, and the safetensors export round-trips."""

import numpy as np
import pytest
import torch

from audio_flamingo_tpu_torch.api import AudioFlamingo
from audio_flamingo_tpu_torch.config import AF3Config
from audio_flamingo_tpu_torch.models import af3, qwen2
from audio_flamingo_tpu_torch.ops.quant import quantize_lm_params
from audio_flamingo_tpu_torch.runtime.processor import AUDIO_TOKEN
from audio_flamingo_tpu_torch.train import checkpoints, loop
from audio_flamingo_tpu_torch.train.data import BatchBuilder, MixtureSampler, Source
from audio_flamingo_tpu_torch.train.stages import AF3_STAGES
from audio_flamingo_tpu_torch.train.train_step import init_state

torch.set_num_threads(2)


def _model():
    return AudioFlamingo.from_random(AF3Config.tiny(), seed=0, device="cpu")


def _example(rng):
    wav = (rng.normal(size=16000) * 0.1).astype(np.float32)
    return [wav], f"What is {AUDIO_TOKEN}?", "a dog barks"


def _hot(model, names=("adaptor",)):
    return {n: p.detach().clone() for n, p in model.named_parameters()
            if n.split(".")[0] in names}


def test_run_lowers_the_loss_and_keeps_frozen_parts():
    m = _model()
    enc, lm, ada = _hot(m.model, ("encoder",)), _hot(m.model, ("lm",)), _hot(m.model)
    sampler = MixtureSampler([Source("synthetic", 1.0, _example)], seed=0)
    run_cfg = loop.TrainRunConfig(stage="1_pretrain", batch_size=2, num_steps=8, log_every=1,
                                  warmup_steps=1)
    state, metrics = loop.run(m.cfg, m.model, sampler, BatchBuilder(processor=m.processor),
                              run_cfg, device="cpu")
    losses = [r["loss"] for r in metrics.records]
    assert [r["step"] for r in metrics.records] == list(range(1, 9))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert state.step == 8
    after = dict(m.model.named_parameters())
    assert all(torch.equal(after[n], v) for n, v in {**enc, **lm}.items())
    assert max((after[n] - v).abs().max().item() for n, v in ada.items()) > 0


def test_run_needs_a_card_unless_told_cpu(monkeypatch):
    m = _model()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loop.run(m.cfg, m.model, MixtureSampler([Source("s", 1.0, _example)]),
                 BatchBuilder(processor=m.processor), loop.TrainRunConfig(num_steps=1))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        loop.run(m.cfg, m.model, MixtureSampler([Source("s", 1.0, _example)]),
                 BatchBuilder(processor=m.processor), loop.TrainRunConfig(num_steps=1),
                 mesh=object(), device="cpu")


class Interrupted(Exception):
    pass


class _StopAfter:
    """An example source that fails after ``n`` examples, as a crash mid-run would."""

    def __init__(self, n):
        self.n = n

    def __call__(self, rng):
        if self.n == 0:
            raise Interrupted
        self.n -= 1
        return _example(rng)


def test_resume_equals_an_uninterrupted_run(tmp_path):
    """4 steps (stage 2, ckpt every 2) in one go, against a run cut after step 2 and
    resumed from its checkpoint: the same hot parameters, optimizer state and losses,
    bit for bit. The loop does not checkpoint the sampler (as in JAX), so the resumed
    run is handed a sampler advanced past the batches the first run took."""
    run_cfg = dict(stage="2_encoder_tuning", batch_size=2, num_steps=4, log_every=1,
                   warmup_steps=1)

    def sampler(fn=_example, skip=0):
        s = MixtureSampler([Source("synthetic", 1.0, fn)], seed=0)
        for _ in range(skip):
            s.sample()
        return s

    full = _model()
    state_a, metrics_a = loop.run(full.cfg, full.model, sampler(),
                                  BatchBuilder(processor=full.processor),
                                  loop.TrainRunConfig(**run_cfg), device="cpu")

    ckpt = str(tmp_path / "ckpt")
    cut = _model()
    with pytest.raises(Interrupted):
        loop.run(cut.cfg, cut.model, sampler(_StopAfter(4)), BatchBuilder(processor=cut.processor),
                 loop.TrainRunConfig(**run_cfg, ckpt_dir=ckpt, ckpt_every=2), device="cpu")
    assert checkpoints.latest_step(ckpt) == 2
    resumed = _model()
    state_b, metrics_b = loop.run(resumed.cfg, resumed.model, sampler(skip=4),
                                  BatchBuilder(processor=resumed.processor),
                                  loop.TrainRunConfig(**run_cfg, ckpt_dir=ckpt, ckpt_every=2),
                                  device="cpu")
    assert [r["step"] for r in metrics_b.records] == [3, 4]
    assert [r["loss"] for r in metrics_b.records] == [r["loss"] for r in metrics_a.records[2:]]
    assert state_b.step == state_a.step == 4
    assert state_b.opt_state["count"] == state_a.opt_state["count"] == 4
    a, b = dict(full.model.named_parameters()), dict(resumed.model.named_parameters())
    for n in a:
        assert torch.equal(a[n], b[n]), n
    for key in ("mu", "nu"):
        for n, v in state_a.opt_state[key].items():
            assert torch.equal(v, state_b.opt_state[key][n]), (key, n)
    assert checkpoints.latest_step(ckpt) == 4


def test_restore_refuses_a_checkpoint_of_other_parameters(tmp_path):
    m = _model()
    state, _ = init_state(m.model, AF3_STAGES["1_pretrain"])
    checkpoints.save(str(tmp_path), state, step=7)
    assert checkpoints.latest_step(str(tmp_path)) == 7
    other, _ = init_state(_model().model, AF3_STAGES["2_encoder_tuning"])
    with pytest.raises(ValueError, match="checkpoint holds parameters"):
        checkpoints.restore(str(tmp_path), other, step=7)
    again, _ = init_state(_model().model, AF3_STAGES["1_pretrain"])
    assert checkpoints.restore(str(tmp_path), again, step=7).step == 0


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8_lm"])
def test_safetensors_export_import_roundtrip(tmp_path, kind):
    m = _model()
    model = m.model
    if kind == "bf16":
        model = model.to(torch.bfloat16)
    elif kind == "int8_lm":
        lm = qwen2.quantized_lm(quantize_lm_params(model.lm.state_dict()), torch.float32, "cpu")
        model = af3.AF3Model(model.encoder, model.adaptor, lm)
    sd = model.state_dict()
    path = str(tmp_path / "params.safetensors")
    checkpoints.export_safetensors(path, sd)
    template = {k: torch.zeros_like(v) for k, v in sd.items()}
    back = checkpoints.import_safetensors(path, template)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    if kind == "int8_lm":
        assert back["lm.layers.q.w_q"].dtype == torch.int8
