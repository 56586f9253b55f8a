"""Example functions for tests/test_torch_grain_pipeline.py, in a module of their own that
imports no JAX: the pipeline's spawned workers import it to unpickle them."""

import numpy as np

AUDIO_TOKEN = "<sound>"


def speech(rng):
    """A 1-2 s clip and an answer whose length the rng picks."""
    wav = (rng.normal(size=int(rng.integers(16000, 32000))) * 0.1).astype(np.float32)
    words = ["a", "dog", "barks", "music", "plays", "loudly"]
    answer = " ".join(words[int(i)] for i in rng.integers(0, len(words), rng.integers(2, 9)))
    return [wav], f"What is {AUDIO_TOKEN}?", answer


def text(rng):
    return [], "Say something.", "someone speaks " * int(rng.integers(1, 4))
