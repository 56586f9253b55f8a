"""The port stands alone: no module of it (nor chip_smoke.py) imports jax or the JAX
package, and its entry points refuse to fall back to the CPU without a card."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_every_port_module_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import audio_flamingo_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'audio_flamingo_tpu_torch.')]\n"
        "assert len(names) >= 20, names\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'jaxlib'\n"
        "       or m == 'audio_flamingo_tpu' or m.startswith('audio_flamingo_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _is_jax(name):
    return name.split(".")[0] in ("jax", "jaxlib", "audio_flamingo_tpu")


def test_sources_name_no_jax_import():
    pkg = os.path.join(REPO, "audio_flamingo_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs if f.endswith(".py")]
    for path in files:
        assert not [n for n in _imports(path) if _is_jax(n)], path


def test_entry_points_require_cuda_or_explicit_cpu(monkeypatch, tmp_path):
    from audio_flamingo_tpu_torch import api
    from audio_flamingo_tpu_torch.audio.mel import WhisperMelFrontend
    from audio_flamingo_tpu_torch.config import AF3Config
    from audio_flamingo_tpu_torch.runtime.processor import AF3Processor
    from audio_flamingo_tpu_torch.runtime.tokenizer import BBPETokenizer, train_bpe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tok = BBPETokenizer(*train_bpe(["describe the sound"], 300))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.AudioFlamingo.from_random()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.load(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WhisperMelFrontend()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AF3Processor(tokenizer=tok, cfg=AF3Config.tiny())
    assert api.resolve_device("cpu") == torch.device("cpu")
    assert WhisperMelFrontend(device="cpu").device == torch.device("cpu")
    assert AF3Processor(tokenizer=tok, cfg=AF3Config.tiny(), device="cpu").device == \
        torch.device("cpu")
