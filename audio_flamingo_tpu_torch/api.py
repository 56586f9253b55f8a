"""Top-level user API of the port: load a model, run waveform -> text, multi-turn chat.

Mirrors ``audio_flamingo_tpu/api.py`` (``AudioFlamingo.generate``, ``from_random``,
``load``). Entry points run on CUDA unless the caller passes ``device="cpu"``; with no
card and no explicit device they raise instead of running on the CPU. Weights are made
on the target device in the compute dtype.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from audio_flamingo_tpu_torch.config import (NOT_PORTED, AF3Config, Qwen2Config,
                                             WhisperEncoderConfig, bucket_tokens)
from audio_flamingo_tpu_torch.device import resolve_device
from audio_flamingo_tpu_torch.models import af3
from audio_flamingo_tpu_torch.ops.sampling import SamplingParams
from audio_flamingo_tpu_torch.runtime import generate as gen
from audio_flamingo_tpu_torch.runtime.processor import AUDIO_TOKEN, AF3Processor
from audio_flamingo_tpu_torch.runtime.tokenizer import BBPETokenizer, train_bpe

@dataclass
class AudioFlamingo:
    """An AF3-family model ready for inference."""

    cfg: AF3Config
    model: af3.AF3Model
    processor: AF3Processor
    eos_token_id: int
    history: list = field(default_factory=list)
    last_output: gen.GenerateOutput | None = None   # ids, prefill logits and timings
    last_processor_s: float | None = None   # the last generate's processor, device-synced

    THINK_INSTRUCTION = ("Please think and reason about the input audio before you "
                         "respond. Put your thoughts between <think> and </think>, then "
                         "give the final answer.")

    @property
    def device(self) -> torch.device:
        return self.model.lm.embed_tokens.device

    def with_config(self, cfg: AF3Config) -> "AudioFlamingo":
        """The same weights under another config (e.g. the flash switches flipped)."""
        return dataclasses.replace(self, cfg=cfg, history=[], last_output=None,
                                   last_processor_s=None)

    def generate(self, sound: np.ndarray | list[np.ndarray] | None = None,
                 prompt: str = "Describe the audio.", *, max_new_tokens: int = 256,
                 sampling: SamplingParams = SamplingParams(), seed: int = 0,
                 chat: bool = False, stream: bool = False, think: bool = False,
                 num_beams: int = 1, length_penalty: float = 1.0,
                 early_stopping: bool | str = False) -> str:
        """sound: mono 16 kHz float32 waveform(s). Returns the decoded answer.

        think=True asks the model to reason inside <think>...</think> first. The run's
        token ids, prefill logits and timings are kept in ``last_output``, and the
        processor's time (chat template, log-mel, tokenizer; device-synchronized) in
        ``last_processor_s``: it runs before ``last_output.ttft_s`` starts, so the TTFT a
        caller sees is their sum. length_penalty and early_stopping are beam-search
        options, as in the JAX API."""
        if num_beams > 1 or length_penalty != 1.0 or early_stopping is not False:
            raise NotImplementedError(NOT_PORTED.format(
                "beam search (num_beams, length_penalty, early_stopping)", "runtime/beam.py"))
        if stream:
            raise NotImplementedError(NOT_PORTED.format(
                "streaming", "generate features of runtime/generate.py"))
        audios = None
        text = prompt
        if sound is not None:
            audios = [sound] if isinstance(sound, np.ndarray) else list(sound)
            if AUDIO_TOKEN not in prompt:
                text = f"{AUDIO_TOKEN}{prompt}"
        if think:
            text = f"{text}\n{self.THINK_INSTRUCTION}"
        # each turn keeps its audio so old placeholders stay paired with their clips
        history_audios = [a for m in (self.history if chat else []) for a in m.get("audios", [])]
        all_audios = history_audios + (audios or [])
        messages = ([{k: v for k, v in m.items() if k != "audios"} for m in self.history]
                    if chat else []) + [{"role": "user", "content": text}]
        t0 = time.perf_counter()
        batch = self.processor(messages=messages, audios=all_audios or None)
        ids = torch.as_tensor(batch["ids"], dtype=torch.long, device=self.device)
        gen.sync(self.device)
        self.last_processor_s = time.perf_counter() - t0

        # right-pad the prompt with EOS to its token bucket: one prefill shape per bucket
        t = ids.shape[1]
        bucket = bucket_tokens(t)
        prompt_len = None
        if bucket != t:
            pad = torch.full((ids.shape[0], bucket - t), self.eos_token_id, dtype=torch.long,
                             device=self.device)
            ids = torch.cat([ids, pad], dim=1)
            prompt_len = t
        generator = torch.Generator(device=self.device).manual_seed(seed)
        out = gen.generate(self.model, self.cfg, ids, batch["mels"],
                           max_new_tokens=max_new_tokens, eos_token_id=self.eos_token_id,
                           sampling=sampling, generator=generator, prompt_len=prompt_len)
        self.last_output = out
        out_ids = out.tokens[0, : int(out.lengths[0])].tolist()
        answer = self.processor.tokenizer.decode(out_ids, skip_special=True)
        if chat:
            self.history.append({"role": "user", "content": text, "audios": audios or []})
            self.history.append({"role": "assistant", "content": answer})
        return answer

    def reset_chat(self) -> None:
        self.history.clear()

    # ---------------------------------------------------------------------- factories
    @staticmethod
    def from_state_dict(cfg: AF3Config, state: dict[str, torch.Tensor],
                        tokenizer: BBPETokenizer, compute_dtype: torch.dtype = torch.float32,
                        device: torch.device | str | None = None) -> "AudioFlamingo":
        """Weights in the port's names (io/convert.py) -> model in compute_dtype on device."""
        device = resolve_device(device)
        model = af3.build(cfg, device, compute_dtype,
                          adaptor_layers=2 if "adaptor.fc2.weight" in state else 1)
        model.load_state_dict(state, strict=True)
        return AudioFlamingo._assemble(cfg, model, tokenizer, device)

    @staticmethod
    def from_random(cfg: AF3Config | None = None, tokenizer: BBPETokenizer | None = None,
                    seed: int = 0, compute_dtype: torch.dtype = torch.float32,
                    device: torch.device | str | None = None) -> "AudioFlamingo":
        """Random-weight model (tests/benchmarks). Weights are allocated on ``device`` in
        ``compute_dtype`` and filled there by a generator seeded with ``seed``."""
        cfg = cfg or AF3Config.tiny()
        device = resolve_device(device)
        if tokenizer is None:
            vocab, merges = train_bpe(["describe the sound of music and speech"],
                                      min(400, cfg.lm.vocab_size))
            tokenizer = BBPETokenizer(vocab, merges)
        cfg = dataclasses.replace(cfg, audio_token_id=tokenizer.special_tokens[AUDIO_TOKEN])
        model = af3.build(cfg, device, compute_dtype)
        af3.init_(model, cfg, torch.Generator(device=device).manual_seed(seed))
        return AudioFlamingo._assemble(cfg, model, tokenizer, device)

    @staticmethod
    def _assemble(cfg, model, tokenizer, device) -> "AudioFlamingo":
        proc = AF3Processor(tokenizer=tokenizer, cfg=cfg, device=device)
        eos = tokenizer.special_tokens.get("<|im_end|>", -1)
        return AudioFlamingo(cfg=cfg, model=model, processor=proc, eos_token_id=eos)


def config_from_hf(raw: dict) -> AF3Config:
    """qwen2_audio-style config.json -> AF3Config."""
    aud = raw.get("audio_config", {})
    txt = raw.get("text_config", {})
    return AF3Config(
        encoder=WhisperEncoderConfig(
            num_mel_bins=aud.get("num_mel_bins", 128),
            d_model=aud.get("d_model", 1280),
            num_layers=aud.get("encoder_layers", 32),
            num_heads=aud.get("encoder_attention_heads", 20),
            ffn_dim=aud.get("encoder_ffn_dim", 5120),
            max_source_positions=aud.get("max_source_positions", 1500),
        ),
        lm=Qwen2Config(
            vocab_size=txt.get("vocab_size", 152_064),
            hidden_size=txt.get("hidden_size", 3584),
            intermediate_size=txt.get("intermediate_size", 18_944),
            num_layers=txt.get("num_hidden_layers", 28),
            num_heads=txt.get("num_attention_heads", 28),
            num_kv_heads=txt.get("num_key_value_heads", 4),
            rope_theta=txt.get("rope_theta", 1e6),
            tie_word_embeddings=txt.get("tie_word_embeddings", False),
            # HF nulls sliding_window unless use_sliding_window
            sliding_window=(txt.get("sliding_window", None)
                            if txt.get("use_sliding_window", False) else None),
            max_window_layers=txt.get("max_window_layers", 0),
        ),
        audio_token_id=raw.get("audio_token_id", raw.get("audio_token_index", 151_646)),
    )


def load(model_path: str, compute_dtype: torch.dtype = torch.bfloat16, *,
         quantize_lm: bool | str = False, use_flash: bool = True, a8_prefill: bool = False,
         a8_encoder: bool = False, device: torch.device | str | None = None) -> AudioFlamingo:
    """Load an AF3-family checkpoint directory (HF '-hf' layout): config.json,
    tokenizer.json (or vocab.json + merges.txt), model.safetensors[.index.json].
    use_flash routes the encoder and the LM prefill through the flash-attention kernel.
    quantize_lm, a8_prefill and a8_encoder are the JAX API's quantization options."""
    from audio_flamingo_tpu_torch.io.convert import state_dict_from_hf
    from audio_flamingo_tpu_torch.io.safetensors import load_checkpoint_dir

    for name, value in (("quantize_lm", quantize_lm), ("a8_prefill", a8_prefill),
                        ("a8_encoder", a8_encoder)):
        if value:
            raise NotImplementedError(NOT_PORTED.format(
                name, "quantized weights and activations"))
    device = resolve_device(device)
    with open(os.path.join(model_path, "config.json")) as f:
        cfg = config_from_hf(json.load(f))
    cfg = dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, use_flash=use_flash),
        lm=dataclasses.replace(cfg.lm, use_flash=use_flash))
    sd = {}
    for k, v in load_checkpoint_dir(model_path, upcast_bf16=False).items():
        v = np.array(v)   # writable copy; bf16 arrives as raw uint16
        sd[k] = (torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
                 if v.dtype == np.uint16 else torch.from_numpy(v))
    tokenizer = BBPETokenizer.from_pretrained_dir(model_path)
    return AudioFlamingo.from_state_dict(cfg, state_dict_from_hf(sd, cfg), tokenizer,
                                         compute_dtype=compute_dtype, device=device)


def load_draft(model_path: str, compute_dtype: torch.dtype = torch.bfloat16, **kwargs):
    """Speculative-decoding draft loader of the JAX API (api.load_draft)."""
    raise NotImplementedError(NOT_PORTED.format("speculative decoding",
                                                 "speculative decoding"))
