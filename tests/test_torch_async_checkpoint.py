"""The port's AsyncCheckpointer (train/checkpoints.py): restore reads what its save
wrote (the synchronous save's layout, latest_step included), an in-place update made
while the write is still waiting does not reach the file, close waits for the writes,
and a failed write raises at wait."""

import os
import threading
import time

import pytest
import torch

from audio_flamingo_tpu_torch.config import AF3Config
from audio_flamingo_tpu_torch.models import af3
from audio_flamingo_tpu_torch.train import checkpoints
from audio_flamingo_tpu_torch.train.stages import AF3_STAGES
from audio_flamingo_tpu_torch.train.train_step import init_state

torch.set_num_threads(2)


def _state(seed: int):
    cfg = AF3Config.tiny()
    model = af3.build(cfg, "cpu", torch.float32)
    af3.init_(model, cfg, torch.Generator().manual_seed(seed))
    state, _ = init_state(model, AF3_STAGES["2_encoder_tuning"])
    for k in ("mu", "nu"):
        for t in state.opt_state[k].values():
            t.normal_(generator=torch.Generator().manual_seed(seed + 1))
    state.opt_state["count"], state.step = 3, 3
    return state


def _hot(state) -> dict:
    return {n: p.detach().clone() for n, p in state.model.named_parameters() if p.requires_grad}


def test_restore_reads_what_async_save_wrote(tmp_path):
    state = _state(0)
    want, mu = _hot(state), {n: t.clone() for n, t in state.opt_state["mu"].items()}
    ck = checkpoints.AsyncCheckpointer()
    ck.save(str(tmp_path), state, step=3)
    ck.save(str(tmp_path), state, step=5)
    ck.close()
    assert checkpoints.latest_step(str(tmp_path)) == 5
    other = _state(1)
    checkpoints.restore(str(tmp_path), other, step=3)
    assert other.step == 3 and other.opt_state["count"] == 3
    for n, p in other.model.named_parameters():
        if p.requires_grad:
            assert torch.equal(p, want[n]), n
    for n, t in other.opt_state["mu"].items():
        assert torch.equal(t, mu[n]), n
    # the same bytes as the synchronous save's
    checkpoints.save(str(tmp_path / "sync"), state, step=3)
    a = torch.load(os.path.join(tmp_path, "step_3", checkpoints.STATE_FILE), weights_only=True)
    b = torch.load(os.path.join(tmp_path, "sync", "step_3", checkpoints.STATE_FILE),
                   weights_only=True)
    assert a.keys() == b.keys() and a["step"] == b["step"]
    assert all(torch.equal(a["hot"][n], b["hot"][n]) for n in b["hot"])


def test_update_after_save_does_not_reach_the_file(tmp_path, monkeypatch):
    state = _state(0)
    want = _hot(state)
    go = threading.Event()
    write = checkpoints._write

    def held_write(*a):
        go.wait(10)
        write(*a)

    monkeypatch.setattr(checkpoints, "_write", held_write)
    ck = checkpoints.AsyncCheckpointer()
    ck.save(str(tmp_path), state, step=1)
    with torch.no_grad():                  # the next step, in place, before the write
        for p in state.model.parameters():
            p.add_(1.0)
        for t in state.opt_state["mu"].values():
            t.add_(1.0)
    go.set()
    ck.close()
    other = _state(2)
    checkpoints.restore(str(tmp_path), other, step=1)
    for n, p in other.model.named_parameters():
        if p.requires_grad:
            assert torch.equal(p, want[n]), n


def test_close_waits_and_a_failed_write_raises(tmp_path, monkeypatch):
    state = _state(0)
    write = checkpoints._write

    def slow_write(*a):
        time.sleep(0.3)
        write(*a)

    monkeypatch.setattr(checkpoints, "_write", slow_write)
    ck = checkpoints.AsyncCheckpointer()
    ck.save(str(tmp_path), state, step=7)
    assert not os.path.exists(os.path.join(tmp_path, "step_7", checkpoints.STATE_FILE))
    ck.close()
    assert os.path.exists(os.path.join(tmp_path, "step_7", checkpoints.STATE_FILE))

    def failing_write(*a):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoints, "_write", failing_write)
    ck = checkpoints.AsyncCheckpointer()
    ck.save(str(tmp_path), state, step=8)
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.close()
