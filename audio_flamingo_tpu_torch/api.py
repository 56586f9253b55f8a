"""Top-level user API of the port: load a model, run waveform -> text, multi-turn chat.

Mirrors ``audio_flamingo_tpu/api.py``: ``AudioFlamingo`` (AF3: ``generate``,
``from_random``, ``load``, ``load_draft``) and ``AudioFlamingo2`` (the AF1/AF2 family:
``generate``, ``from_random``, ``save_af2``, ``load_af2``). Entry points run on CUDA
unless the caller passes ``device="cpu"``; with no card and no explicit device they raise
instead of running on the CPU. Weights are made on the target device in the compute
dtype.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from audio_flamingo_tpu_torch.config import (AF2Config, AF3Config,
                                             ClapAudioConfig, ClapMelConfig, GatedXAttnConfig,
                                             OPTConfig, Qwen2Config, WhisperEncoderConfig,
                                             asdict, bucket_tokens)
from audio_flamingo_tpu_torch.device import resolve_device
from audio_flamingo_tpu_torch.models import af3, clap, flamingo, qwen2, whisper_encoder
from audio_flamingo_tpu_torch.ops.quant import quantize_encoder_params, quantize_lm_params
from audio_flamingo_tpu_torch.ops.quant4 import quantize_lm_params_w4
from audio_flamingo_tpu_torch.ops.sampling import SamplingParams
from audio_flamingo_tpu_torch.runtime import beam
from audio_flamingo_tpu_torch.runtime import generate as gen
from audio_flamingo_tpu_torch.runtime import speculative
from audio_flamingo_tpu_torch.runtime.clap_processor import AF2Processor
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
    # an optional speculative draft: a small Qwen2 / QuantQwen2 LM on the model's device
    # sharing the tokenizer (``load_draft``), its config and the proposals a round
    draft: object = None
    draft_cfg: Qwen2Config | None = None
    spec_k: int = 4
    last_spec: speculative.SpecOutput | None = None   # the last speculative run's stats

    THINK_INSTRUCTION = ("Please think and reason about the input audio before you "
                         "respond. Put your thoughts between <think> and </think>, then "
                         "give the final answer.")

    @property
    def device(self) -> torch.device:
        return next(self.model.encoder.parameters()).device

    def with_config(self, cfg: AF3Config) -> "AudioFlamingo":
        """The same weights under another config (e.g. the flash switches flipped)."""
        return dataclasses.replace(self, cfg=cfg, history=[], last_output=None,
                                   last_processor_s=None, last_spec=None)

    def generate(self, sound: np.ndarray | list[np.ndarray] | None = None,
                 prompt: str = "Describe the audio.", *, max_new_tokens: int = 256,
                 sampling: SamplingParams = SamplingParams(), seed: int = 0,
                 chat: bool = False, stream: bool = False, think: bool = False,
                 num_beams: int = 1, length_penalty: float = 1.0,
                 early_stopping: bool | str = False):
        """sound: mono 16 kHz float32 waveform(s). Returns the decoded answer, or with
        ``stream=True`` an iterator of token ids (``runtime/generate.generate_stream`` on
        the exact prompt, as in JAX; it keeps no chat history and no ``last_output``).

        think=True asks the model to reason inside <think>...</think> first. The run's
        token ids, prefill logits and timings are kept in ``last_output``, and the
        processor's time (chat template, log-mel, tokenizer; device-synchronized) in
        ``last_processor_s``: it runs before ``last_output.ttft_s`` starts, so the TTFT a
        caller sees is their sum.

        num_beams > 1 runs beam search (``runtime/beam.generate_beam``, HF
        ``_beam_search``) on the exact prompt with ``length_penalty``, ``early_stopping``
        and ``sampling.min_new_tokens``, and answers with the best beam up to its first
        EOS (``last_output`` is None then); it does not stream. With num_beams == 1 the
        two beam options are ignored, as in JAX.

        With a ``draft`` attached, batch 1 and no repetition penalty, generate speculates
        (``runtime/speculative.generate_speculative``, ``spec_k`` proposals a round; greedy
        output equals the plain path's, sampled output has its law) on the exact-length
        prompt, as JAX routes it; ``last_spec`` keeps the run's acceptance and timings
        (``last_output`` is None then)."""
        if num_beams > 1 and stream:
            raise ValueError("streaming and beam search are mutually exclusive")
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
        if num_beams > 1:
            seqs, _ = beam.generate_beam(
                self.model, self.cfg, ids, batch["mels"], num_beams=num_beams,
                max_new_tokens=max_new_tokens, eos_token_id=self.eos_token_id,
                length_penalty=length_penalty, early_stopping=early_stopping,
                min_new_tokens=sampling.min_new_tokens)
            seq = seqs[0, 0].tolist()
            if self.eos_token_id in seq:
                seq = seq[: seq.index(self.eos_token_id) + 1]
            self.last_output = None
            return self._answer(seq, text, audios, chat)
        if stream:
            return gen.generate_stream(
                self.model, self.cfg, ids, batch["mels"], max_new_tokens=max_new_tokens,
                eos_token_id=self.eos_token_id, sampling=sampling,
                generator=torch.Generator(device=self.device).manual_seed(seed))

        if (self.draft is not None and ids.shape[0] == 1
                and sampling.repetition_penalty == 1.0):
            # the exact-length prompt: the speculative loop has no prompt_len
            out = speculative.generate_speculative(
                self.model, self.cfg, self.draft, self.draft_cfg, ids, batch["mels"],
                k=self.spec_k, max_new_tokens=max_new_tokens, eos_token_id=self.eos_token_id,
                sampling=sampling, generator=torch.Generator(device=self.device).manual_seed(seed))
            self.last_output, self.last_spec = None, out
            return self._answer(out.tokens[0, : int(out.lengths[0])].tolist(), text, audios,
                                chat)

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
        return self._answer(out.tokens[0, : int(out.lengths[0])].tolist(), text, audios, chat)

    def _answer(self, ids: list, text: str, audios, chat: bool) -> str:
        """Detokenize the answer and, in a chat, keep the turn."""
        answer = self.processor.tokenizer.decode(ids, skip_special=True)
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
        """Weights in the port's names (io/convert.py) -> model in compute_dtype on device.
        A quantized LM (``lm.*`` in the JAX tree layout, e.g. ``lm.layers.qkv.w_p``) and a
        quantized encoder (``encoder.layers.*``, e.g. ``encoder.layers.qkv.w_q``) keep
        their integer codes and f32 scales."""
        device = resolve_device(device)
        adaptor_layers = 2 if "adaptor.fc2.weight" in state else 1
        lm = encoder = None
        if "lm.ln_f_w" in state:
            lm = qwen2.quantized_lm(
                qwen2.unflatten({k[3:]: v for k, v in state.items() if k.startswith("lm.")}),
                compute_dtype, device)
            state = {k: v for k, v in state.items() if not k.startswith("lm.")}
        if "encoder.layers.ln1_w" in state:
            enc = {k[8:]: v for k, v in state.items() if k.startswith("encoder.")}
            tree = qwen2.unflatten({k[7:]: v for k, v in enc.items() if k.startswith("layers.")})
            encoder = whisper_encoder.quantized_encoder(
                cfg.encoder, {k: v for k, v in enc.items() if not k.startswith("layers.")},
                tree, compute_dtype, device)
            state = {k: v for k, v in state.items() if not k.startswith("encoder.")}
        model = af3.build(cfg, device, compute_dtype, adaptor_layers=adaptor_layers, lm=lm,
                          encoder=encoder)
        built = tuple(name for name, part in (("lm.", lm), ("encoder.", encoder))
                      if part is not None)
        missing, unexpected = model.load_state_dict(state, strict=not built)
        if built and (unexpected or [k for k in missing if not k.startswith(built)]):
            raise RuntimeError(f"state dict does not match the model: missing {missing}, "
                               f"unexpected {unexpected}")
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
    quantize_lm=True (or "int8") stores the LM's linears, head and embedding in int8
    (weight-only, per channel, ``ops/quant.py``); quantize_lm="int4" packs the layer
    linears to group-scale int4 (``ops/quant4.py``, embedding and head int8), decoded
    through the K5 and K6 kernels. a8_prefill (needs the int8 LM) runs the LM's
    multi-token products w8a8 (decode stays w8a16); a8_encoder quantizes the encoder's
    layer linears to int8 (``quantize_encoder_params``) and runs them w8a8. Both are the
    TTFT option of JAX's ``load``; its other switches (``a8_attention``, the fused encoder
    layout and ``fused_stages``) are reached as in JAX, through ``with_config`` and the
    quantizers (``whisper_encoder.quantize``). The weights are quantized from the
    checkpoint's own values on ``device`` before the cast to compute_dtype; scales stay
    f32."""
    from audio_flamingo_tpu_torch.io.convert import state_dict_from_hf
    from audio_flamingo_tpu_torch.io.safetensors import load_checkpoint_dir

    if a8_prefill and quantize_lm not in (True, "int8"):
        raise ValueError("a8_prefill requires quantize_lm=True/'int8' (w8a8 has no int4 "
                         "mode)")
    device = resolve_device(device)
    with open(os.path.join(model_path, "config.json")) as f:
        cfg = config_from_hf(json.load(f))
    cfg = dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, use_flash=use_flash),
        lm=dataclasses.replace(cfg.lm, use_flash=use_flash, a8_prefill=a8_prefill))
    sd = {}
    for k, v in load_checkpoint_dir(model_path, upcast_bf16=False).items():
        v = np.array(v)   # writable copy; bf16 arrives as raw uint16
        sd[k] = (torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
                 if v.dtype == np.uint16 else torch.from_numpy(v))
    tokenizer = BBPETokenizer.from_pretrained_dir(model_path)
    state = state_dict_from_hf(sd, cfg)
    if quantize_lm:
        lm_state = {k[3:]: state.pop(k).to(device) for k in [k for k in state
                                                             if k.startswith("lm.")]}
        tree = (quantize_lm_params_w4(lm_state) if quantize_lm == "int4"
                else quantize_lm_params(lm_state))
        del lm_state
        state.update(qwen2.flatten(tree, "lm."))
    if a8_encoder:
        enc_state = {k[8:]: state.pop(k).to(device) for k in [k for k in state
                                                             if k.startswith("encoder.layers.")]}
        state.update(qwen2.flatten(quantize_encoder_params(enc_state), "encoder.layers."))
        del enc_state
    return AudioFlamingo.from_state_dict(cfg, state, tokenizer, compute_dtype=compute_dtype,
                                         device=device)


def draft_config_from_hf(raw: dict) -> Qwen2Config:
    """A plain Qwen2 config.json (or its ``text_config``) -> Qwen2Config, as JAX's
    ``load_draft`` reads it: an untied checkpoint that omits ``tie_word_embeddings`` keeps
    its lm_head (HF's default is False)."""
    txt = raw.get("text_config", raw)
    return Qwen2Config(
        vocab_size=txt.get("vocab_size", 151_936),
        hidden_size=txt["hidden_size"],
        intermediate_size=txt["intermediate_size"],
        num_layers=txt["num_hidden_layers"],
        num_heads=txt["num_attention_heads"],
        num_kv_heads=txt.get("num_key_value_heads", txt["num_attention_heads"]),
        rope_theta=txt.get("rope_theta", 1e6),
        tie_word_embeddings=txt.get("tie_word_embeddings", False),
        sliding_window=(txt.get("sliding_window", None)
                        if txt.get("use_sliding_window", False) else None),
        max_window_layers=txt.get("max_window_layers", 0),
    )


def load_draft(model_path: str, compute_dtype: torch.dtype = torch.bfloat16, *,
               quantize: bool = False, device: torch.device | str | None = None):
    """Load a plain Qwen2 CausalLM checkpoint directory (config.json + safetensors) as a
    speculative draft (JAX ``api.load_draft`` :421). The draft must share the target's
    tokenizer (e.g. Qwen2.5-0.5B beside the AF3 7B backbone): only token ids reach it.
    Returns (draft, draft_cfg) for ``AudioFlamingo(draft=..., draft_cfg=...)`` or an
    engine's ``draft_params=`` / ``draft_cfg=``. quantize=True stores it w8a16
    (``ops/quant.quantize_lm_params``, from the checkpoint's f32 values on ``device``)."""
    from audio_flamingo_tpu_torch.io.convert import qwen2_state_from_hf
    from audio_flamingo_tpu_torch.io.safetensors import load_checkpoint_dir

    device = resolve_device(device)
    with open(os.path.join(model_path, "config.json")) as f:
        cfg = draft_config_from_hf(json.load(f))
    state = qwen2_state_from_hf(load_checkpoint_dir(model_path), cfg)
    if quantize:
        tree = quantize_lm_params({k: v.float().to(device) for k, v in state.items()})
        return qwen2.quantized_lm(tree, compute_dtype, device), cfg
    with torch.device("meta"):
        lm = qwen2.Qwen2(cfg, dtype=compute_dtype)
    lm = lm.to_empty(device=device)
    lm.load_state_dict({k: v.to(compute_dtype) for k, v in state.items()})
    return lm.eval().requires_grad_(False), cfg


# ---------------------------------------------------------------------------- AF1 / AF2

@dataclass
class AudioFlamingo2:
    """An AF1/AF2-family model: CLAP tower -> audio transform -> gated-xattn LM
    (``cfg.lm`` a ``Qwen2Config`` for AF2, an ``OPTConfig`` for AF1)."""

    cfg: AF2Config
    model: flamingo.FlamingoModel
    tower: clap.ClapAudioTower
    processor: AF2Processor
    eos_token_id: int
    history: list = field(default_factory=list)
    last_output: gen.GenerateOutput | None = None   # ids, prefill logits and timings
    last_processor_s: float | None = None   # the last generate's processor (chat template,
                                            # CLAP mel, tokenizer), device-synced
    last_tower_s: float | None = None       # and its HTSAT tower, device-synced

    THINK_INSTRUCTION = AudioFlamingo.THINK_INSTRUCTION

    @property
    def device(self) -> torch.device:
        return self.tower.proj_fc1.weight.device

    def encode_audio(self, mels: torch.Tensor, is_longer: torch.Tensor) -> torch.Tensor:
        """[n_media, n_windows, C, T, M] mel stacks -> [1, n_media, n_windows, proj]."""
        nm, nw = mels.shape[:2]
        out = self.tower.encode(mels.reshape((nm * nw,) + tuple(mels.shape[2:])),
                                is_longer.reshape(nm * nw, 1))
        return out["embeds"].reshape(1, nm, nw, -1)

    def generate(self, sound: np.ndarray | list[np.ndarray] | None = None,
                 prompt: str = "Describe the audio.", *, max_new_tokens: int = 128,
                 sampling: SamplingParams = SamplingParams(), seed: int = 0,
                 chat: bool = False, think: bool = False, num_beams: int = 1,
                 length_penalty: float = 1.0, early_stopping: bool | str = False) -> str:
        """sound: mono 48 kHz waveform(s) (f32, or int16 PCM). Every text token attends to
        every clip (JAX's generate passes no media mask). The prompt is right-padded with
        EOS to its token bucket and decoded from ``prompt_len``
        (``models/flamingo.generate``; the step captured on the card). The run's ids,
        prefill logits and timings are kept in ``last_output``, the processor's and the
        tower's times in ``last_processor_s`` and ``last_tower_s``. think=True appends the
        thinking instruction after the audio marker. num_beams > 1 runs beam search
        (``runtime/beam.generate_beam_xattn``, the step captured on the card) on the exact,
        unpadded prompt, as JAX does, and answers with the best beam cut after its first
        EOS (``last_output`` is None then)."""
        audios = None
        text = prompt
        if sound is not None:
            audios = [sound] if isinstance(sound, (np.ndarray, torch.Tensor)) else list(sound)
            if AUDIO_TOKEN not in prompt:
                text = f"{AUDIO_TOKEN}{prompt}"
        if think:
            text = f"{text}\n{self.THINK_INSTRUCTION}"
        history_audios = [a for m in (self.history if chat else []) for a in m.get("audios", [])]
        all_audios = history_audios + (audios or [])
        messages = ([{k: v for k, v in m.items() if k != "audios"} for m in self.history]
                    if chat else []) + [{"role": "user", "content": text}]
        device = self.device
        t0 = time.perf_counter()
        batch = self.processor(messages=messages, audios=all_audios or None)
        ids = torch.as_tensor(batch["ids"], dtype=torch.long, device=device)
        gen.sync(device)
        t1 = time.perf_counter()
        if batch["mels"] is not None:
            wins = self.encode_audio(batch["mels"], batch["is_longer"])
        else:
            wins = torch.zeros((1, 1, 1, self.cfg.audio_embed_dim),
                               dtype=flamingo.compute_dtype(self.model), device=device)
        gen.sync(device)
        self.last_processor_s, self.last_tower_s = t1 - t0, time.perf_counter() - t1
        if num_beams > 1:
            seqs, _ = beam.generate_beam_xattn(
                self.model, self.cfg, ids, wins, num_beams=num_beams,
                max_new_tokens=max_new_tokens, eos_token_id=self.eos_token_id,
                length_penalty=length_penalty, early_stopping=early_stopping,
                min_new_tokens=sampling.min_new_tokens)
            seq = seqs[0, 0].tolist()
            if self.eos_token_id in seq:
                seq = seq[: seq.index(self.eos_token_id) + 1]
            self.last_output = None
            return self._answer(seq, text, audios, chat)
        t = ids.shape[1]
        bucket = bucket_tokens(t)
        prompt_len = None
        if bucket != t:
            ids = torch.cat([ids, torch.full((1, bucket - t), self.eos_token_id,
                                             dtype=torch.long, device=device)], dim=1)
            prompt_len = t
        out = flamingo.generate(self.model, self.cfg, ids, wins, max_new_tokens=max_new_tokens,
                                eos_token_id=self.eos_token_id, sampling=sampling,
                                generator=torch.Generator(device=device).manual_seed(seed),
                                prompt_len=prompt_len)
        self.last_output = out
        return self._answer(out.tokens[0, : int(out.lengths[0])].tolist(), text, audios, chat)

    def _answer(self, ids: list, text: str, audios, chat: bool) -> str:
        """Detokenize the answer and, in a chat, keep the turn."""
        answer = self.processor.tokenizer.decode(ids, skip_special=True)
        if chat:
            self.history.append({"role": "user", "content": text, "audios": audios or []})
            self.history.append({"role": "assistant", "content": answer})
        return answer

    def reset_chat(self) -> None:
        self.history.clear()

    @staticmethod
    def from_random(cfg: AF2Config | None = None, seed: int = 0,
                    compute_dtype: torch.dtype = torch.float32,
                    clap_cfg: ClapAudioConfig | None = None,
                    device: torch.device | str | None = None,
                    tokenizer: BBPETokenizer | None = None) -> "AudioFlamingo2":
        """Random-weight model (tests/benchmarks), made on ``device`` in ``compute_dtype``
        by a generator seeded with ``seed``. The defaults are JAX's: a tiny Qwen2 LM with
        xattn blocks of 4 heads, and an HTSAT-base tower with fusion."""
        cfg = cfg or AF2Config(
            lm=Qwen2Config(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
                           num_heads=4, num_kv_heads=2, tie_word_embeddings=True),
            xattn=GatedXAttnConfig(cross_every_n_layers=1, num_heads=4, ffn_mult=2))
        clap_cfg = clap_cfg or ClapAudioConfig(enable_fusion=True)
        device = resolve_device(device)
        generator = torch.Generator(device=device).manual_seed(seed)
        model = flamingo.init(cfg, generator, device, compute_dtype)
        tower = clap.build(clap_cfg, device, compute_dtype)
        clap.init_(tower, generator)
        return AudioFlamingo2._assemble(cfg, model, tower, tokenizer, device)

    @staticmethod
    def _assemble(cfg, model, tower, tokenizer, device) -> "AudioFlamingo2":
        if tokenizer is None:
            vocab, merges = train_bpe(["describe the sound of music"],
                                      min(400, cfg.lm.vocab_size))
            tokenizer = BBPETokenizer(vocab, merges)
        proc = AF2Processor(tokenizer=tokenizer, cfg=cfg, device=device)
        eos = tokenizer.special_tokens.get("<|im_end|>", -1)
        return AudioFlamingo2(cfg=cfg, model=model, tower=tower, processor=proc,
                              eos_token_id=eos)

    @staticmethod
    def from_state_dicts(cfg: AF2Config, clap_cfg: ClapAudioConfig, state: dict,
                         clap_state: dict, tokenizer: BBPETokenizer,
                         compute_dtype: torch.dtype = torch.float32,
                         device: torch.device | str | None = None) -> "AudioFlamingo2":
        """Weights in the port's names (``io/convert.af2_params_from_jax`` /
        ``clap_params_from_jax``) -> model in compute_dtype on device. A quantized Qwen2
        LM (``lm.*`` in the JAX tree layout) keeps its codes and f32 scales."""
        device = resolve_device(device)
        lm = None
        if "lm.embed.w_q" in state:
            lm = qwen2.quantized_lm(
                qwen2.unflatten({k[3:]: v for k, v in state.items() if k.startswith("lm.")}),
                compute_dtype, device)
            state = {k: v for k, v in state.items() if not k.startswith("lm.")}
        model = flamingo.build(cfg, device, compute_dtype, lm=lm)
        missing, unexpected = model.load_state_dict(state, strict=lm is None)
        if lm is not None and (unexpected or [k for k in missing if not k.startswith("lm.")]):
            raise RuntimeError(f"state dict does not match the model: missing {missing}, "
                               f"unexpected {unexpected}")
        tower = clap.build(clap_cfg, device, compute_dtype)
        tower.load_state_dict(clap_state)
        return AudioFlamingo2._assemble(cfg, model, tower, tokenizer, device)


def _dataclass_from(cls, raw: dict, **nested):
    """A config dataclass from its asdict() form: tuples restored, keys the port's class
    lacks dropped (the JAX Qwen2Config's max_position_embeddings)."""
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in raw.items() if k in names}
    kw.update(nested)
    return cls(**kw)


def save_af2(path: str, model: AudioFlamingo2) -> None:
    """Persist an AF1/AF2-family model as JAX's ``save_af2`` does: flamingo.safetensors and
    clap.safetensors under the JAX trees' flat names (f32), config.json ({"af2", "clap",
    "lm_family"}), vocab.json and merges.txt. JAX's ``load_af2`` reads it back."""
    from audio_flamingo_tpu_torch.io.convert import af2_params_to_jax, clap_params_to_jax
    from audio_flamingo_tpu_torch.io.safetensors import save_safetensors

    os.makedirs(path, exist_ok=True)
    save_safetensors(os.path.join(path, "flamingo.safetensors"),
                     af2_params_to_jax(model.model.state_dict(), model.cfg))
    save_safetensors(os.path.join(path, "clap.safetensors"),
                     clap_params_to_jax(model.tower.state_dict(), model.tower.cfg))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"af2": asdict(model.cfg), "clap": asdict(model.tower.cfg),
                   "lm_family": "opt" if flamingo.is_opt(model.cfg) else "qwen2"}, f, indent=1)
    tok = model.processor.tokenizer
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(tok.vocab, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
        for a, b in tok.merges:
            f.write(f"{a} {b}\n")


def load_af2(path: str, compute_dtype: torch.dtype = torch.float32,
             device: torch.device | str | None = None) -> AudioFlamingo2:
    """Load an AF1/AF2-family model saved by ``save_af2`` (this package's or JAX's)."""
    from audio_flamingo_tpu_torch.io.convert import af2_params_from_jax, clap_params_from_jax
    from audio_flamingo_tpu_torch.io.safetensors import load_safetensors

    device = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        raw = json.load(f)
    a = raw["af2"]
    lm_cls = OPTConfig if raw.get("lm_family") == "opt" else Qwen2Config
    cfg = _dataclass_from(AF2Config, a, clap=_dataclass_from(ClapAudioConfig, a["clap"]),
                          lm=_dataclass_from(lm_cls, a["lm"]),
                          xattn=_dataclass_from(GatedXAttnConfig, a["xattn"]),
                          mel=_dataclass_from(ClapMelConfig, a["mel"]))
    clap_cfg = _dataclass_from(ClapAudioConfig, raw["clap"])
    state = af2_params_from_jax(load_safetensors(os.path.join(path, "flamingo.safetensors")),
                                cfg)
    clap_state = clap_params_from_jax(load_safetensors(os.path.join(path, "clap.safetensors")),
                                      clap_cfg)
    return AudioFlamingo2.from_state_dicts(cfg, clap_cfg, state, clap_state,
                                           BBPETokenizer.from_pretrained_dir(path),
                                           compute_dtype=compute_dtype, device=device)
