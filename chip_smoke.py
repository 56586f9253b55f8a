#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (audio_flamingo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root; needs one CUDA card, nvcc and g++

Phases, each line stamped with elapsed seconds:
  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: every csrc/*.cu in one nvcc call (seconds, ptxas report);
  3. kernels against their plain PyTorch versions, with their time (CUDA events, median),
     the plain version's time, one PyTorch library call's time as a yardstick where one
     computes the same function, and the bound:
     a. flash attention (K2) at the 30 s main path's shapes, f32 and bf16, scores drawn
        broad (std 1) and peaked (std 3-4);
     b. the fused log-mel (K1) at [1, 480000] and [20, 480000], on a tone plus noise and
        on normal x 0.1;
     c. K2 at the 10-minute path's shapes, [20,1500,20,64] and causal [1,16384,28,128],
        f32 and bf16, the plain version evaluated over blocks of query rows;
  4. the 30 s main path: AudioFlamingo.from_random at full AF3 width (Whisper-large
     encoder + Qwen2.5-7B, bf16, random weights from a seed) and generate() on a 30 s
     waveform, three times, greedy; launch counts per generate, identical ids, finite
     logits, and the prefill logits against the plain-attention path on the same weights.
     K2's launches inside the warm generate are timed with CUDA events and their inputs
     captured; each is then replayed against the plain version and timed beside it;
  5. a 10-minute file, in to answer out: a 600 s 48 kHz 16-bit stereo WAV written from a
     seed, read by load_audio (native decode, mono mix, resample to 16 kHz), then
     generate() with the log-mel kernel in the processor's frontend: K1 on 20 windows,
     the encoder on 20 windows, a 16,384-token prefill, 4 greedy tokens; run twice, the
     warm run's end-to-end time, processor share, TTFT, kernel device times, launch
     shapes and peak memory;
  6. f32 card against CPU: full width, 2 encoder and 2 LM layers, weights made on the CPU
     from a seed and moved to the card; af3.logits within 1e-4 and greedy ids
     token-exact (and not all one token), with flash and the log-mel kernel on the card.
Prints a {"kernels": [...]} JSON line and, last, {"ok": true, "device": {...}}. Any
failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np
import torch
import torch.nn.functional as F

T0 = time.perf_counter()
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM dense: bf16 tensor, f32 CUDA cores
PEAK_BYTES = 3.35e12                                   # H100 SXM HBM3
TOL = {"float32": 2e-5, "bfloat16": 2e-2}              # max |o - o_plain|: f32 sums, bf16 output rounding
BF16_ULP_TOL = (2.0 ** -7, 1e-3)                       # bf16 o: |o - o_plain| <= 2^-7 |o_plain| + 1e-3
LSE_TOL = 1e-4                                         # f32 LSE in both dtypes (values up to ~40)
MEL_TOL = (5e-4, 1e-4)                                 # K1: |x - plain| <= 5e-4 + 1e-4 |plain|
LOGITS_TOL = 1e-4                                      # f32 af3.logits, card vs CPU


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def time_ms(fn, reps: int = 15, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_bound_ms(q_shape, k_shape, causal: bool, q_offset: int, dtype: str) -> tuple:
    """Least time for the function on the card: max(FLOPs / peak, bytes / HBM rate)."""
    b, tq, h, d = q_shape
    tk, hkv = k_shape[1], k_shape[2]
    if causal:
        pairs = sum(max(0, min(tk, i + q_offset + 1)) for i in range(tq))
    else:
        pairs = tq * tk
    flops = 4.0 * b * h * d * pairs
    item = 4 if dtype == "float32" else 2
    nbytes = item * (2 * b * tq * h * d + 2 * b * tk * hkv * d) + 4 * b * tq * h
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def compare(fa, q, k, v, kw, plain=None) -> dict:
    """One kernel launch against the plain version on the same inputs.

    err: max |o - o_plain|; ratio: the largest |o - o_plain| over its limit (2e-5 in f32,
    2^-7 |o_plain| + 1e-3 in bf16), which must stay <= 1; lse_err: max |lse - lse_plain|.
    plain: the plain version to hold it to (default: fa.flash_attention_reference)."""
    dn = str(q.dtype).split(".")[-1]
    o, lse = fa.flash_attention_lse(q, k, v, **kw)
    o_ref, lse_ref = (plain or fa.flash_attention_reference)(q, k, v, **kw)
    diff = (o.float() - o_ref.float()).abs()
    if dn == "bfloat16":
        rel, floor = BF16_ULP_TOL
        ratio = (diff / (rel * o_ref.float().abs() + floor)).max().item()
    else:
        ratio = diff.max().item() / TOL[dn]
    finite = torch.isfinite(lse_ref)
    lse_err = (lse - lse_ref)[finite].abs().max().item()
    check(bool((lse[~finite] == lse_ref[~finite]).all()), "lse of rows with no key")
    return dict(err=diff.max().item(), ratio=ratio, lse_err=lse_err, dtype=dn)


def check_compare(name: str, r: dict) -> None:
    dn = r["dtype"]
    check(r["err"] <= TOL[dn], f"{name} {dn}: max|o - plain| {r['err']} > {TOL[dn]}")
    check(r["ratio"] <= 1.0, f"{name} {dn}: |o - plain| at {r['ratio']:.3f} of its limit")
    check(r["lse_err"] <= LSE_TOL, f"{name} {dn}: max|lse - plain| {r['lse_err']} > {LSE_TOL}")


def kernel_phase(fa) -> dict:
    """Flash kernel vs its plain version at the encoder, LM-prefill and a ragged shape.

    q is drawn so that the scores q.k * scale have the stated standard deviation: 1 gives
    a broad softmax, 4 a peaked one whose running max moves, exercising the rescale."""
    cases = [  # name, q shape, k shape, causal, scale, q_offset, score std, timed
        ("encoder", (1, 1500, 20, 64), (1, 1500, 20, 64), False, 1.0, 0, 1.0, True),
        ("lm_prefill", (1, 1024, 28, 128), (1, 1024, 4, 128), True, None, 0, 1.0, True),
        ("ragged", (1, 100, 28, 128), (1, 300, 4, 128), True, None, 200, 3.0, True),
        ("encoder_peaked", (1, 1500, 20, 64), (1, 1500, 20, 64), False, 1.0, 0, 4.0, False),
        ("lm_peaked", (1, 1024, 28, 128), (1, 1024, 4, 128), True, None, 0, 4.0, False),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for name, qs, ks, causal, scale, q_offset, score_std, timed in cases:
        d = qs[-1]
        q_mul = score_std / (d ** 0.5 * (scale if scale is not None else d ** -0.5))
        q32 = torch.randn(qs, generator=gen, device="cuda") * q_mul
        k32 = torch.randn(ks, generator=gen, device="cuda")
        v32 = torch.randn(ks, generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = q32.to(dtype), k32.to(dtype), v32.to(dtype)
            kw = dict(causal=causal, scale=scale, q_offset=q_offset)
            r = compare(fa, q, k, v, kw)
            dn = r["dtype"]
            msg = (f"flash {name:14s} {dn:8s} q{list(qs)} k{list(ks)} causal={causal} "
                   f"q_offset={q_offset} score_std={score_std}: max|o-plain|={r['err']:.3e} "
                   f"(at {r['ratio']:.3f} of its limit) max|lse-plain|={r['lse_err']:.3e}")
            if timed:
                r["ms"] = time_ms(lambda: fa.flash_attention_lse(q, k, v, **kw))
                r["plain_ms"] = time_ms(
                    lambda: fa.flash_attention_reference(q, k, v, **kw), reps=10)
                r["library_ms"] = None
                if q_offset == 0 and qs[1] == ks[1]:
                    r["library_ms"] = time_ms(sdpa_call(q, k, v, kw))
                r["bound_ms"], r["bound_by"] = attention_bound_ms(qs, ks, causal, q_offset, dn)
                lib = r["library_ms"]
                msg += (f" ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms="
                        f"{'n/a' if lib is None else f'{lib:.4f}'} "
                        f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']})")
            log(msg)
            check_compare(name, r)
            results[(name, dn)] = r
    return results


def sdpa_call(q, k, v, kw):
    """One torch SDPA call on the same inputs (KV heads expanded outside the timing)."""
    rep = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(rep, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    scale = kw["scale"] if kw["scale"] is not None else q.shape[-1] ** -0.5
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=kw["causal"],
                                                  scale=scale)


def replay_phase(fa, captured: list) -> dict:
    """The main path's own launches, replayed one by one on their captured inputs: each
    held against the plain version, and the kernel, the plain version and SDPA timed
    (median of 5 after 1 warm-up), summed over the launches of one generate."""
    tot = dict(kernel_ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, err=0.0,
               ratio=0.0, lse_err=0.0)
    bound_by = set()
    for i, (q, k, v, kw) in enumerate(captured):
        r = compare(fa, q, k, v, kw)
        check_compare(f"main-path launch {i}", r)
        for key in ("err", "ratio", "lse_err"):
            tot[key] = max(tot[key], r[key])
        tot["kernel_ms"] += time_ms(lambda: fa.flash_attention_lse(q, k, v, **kw), 5, 1)
        tot["plain_ms"] += time_ms(lambda: fa.flash_attention_reference(q, k, v, **kw), 5, 1)
        tot["library_ms"] += time_ms(sdpa_call(q, k, v, kw), 5, 1)
        b_ms, b_by = attention_bound_ms(tuple(q.shape), tuple(k.shape), kw["causal"],
                                        kw["q_offset"], r["dtype"])
        tot["bound_ms"] += b_ms
        bound_by.add(b_by)
    tot["bound_by"] = "operations" if bound_by == {"operations"} else "bytes"
    return tot


def unembed_phase(lm) -> None:
    """The decode step's unembed on a bf16 row: the path's bf16 x bf16 product with f32
    accumulation and output, against upcasting both to f32 first, timed and compared."""
    from audio_flamingo_tpu_torch.models import qwen2

    gen = torch.Generator(device="cuda").manual_seed(1)
    h = torch.randn((1, lm.embed_tokens.shape[1]), generator=gen, device="cuda").bfloat16()
    head = lm.embed_tokens if lm.lm_head is None else lm.lm_head
    new = qwen2.unembed(lm, h)
    old = F.linear(h.float(), head.float())
    err = ((new - old).abs().max() / old.abs().max()).item()
    new_ms = time_ms(lambda: qwen2.unembed(lm, h))
    old_ms = time_ms(lambda: F.linear(h.float(), head.float()))
    log(f"unembed [1,{h.shape[1]}] x {list(head.shape)} bf16: {new_ms:.4f} ms, f32 upcast "
        f"{old_ms:.4f} ms; max|diff|/max|logit| = {err:.2e}")
    check(new.dtype == torch.float32 and err <= 1e-5, f"unembed differs from f32: {err}")


def sdpa_call(q, k, v, kw):
    """One torch SDPA call on the same inputs (KV heads expanded outside the timing).
    Its fused backends only: the unfused one would materialize the whole score tensor."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    rep = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(rep, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    scale = kw["scale"] if kw["scale"] is not None else q.shape[-1] ** -0.5
    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]

    def call():
        with sdpa_kernel(fused):
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=kw["causal"],
                                                  scale=scale)
    return call


def plain_blocked(fa, rows: int):
    """The plain version over blocks of ``rows`` query rows (q_offset shifted by each
    block's start; under causal masking only the keys the block can see), so no score
    tensor of the whole call ([H, Tq, Tk] f32: 30 GB at 16,384 tokens) is made."""
    def plain(q, k, v, *, causal, scale, q_offset):
        outs, lses = [], []
        for r0 in range(0, q.shape[1], rows):
            qb = q[:, r0:r0 + rows]
            off = q_offset + r0
            kb, vb = k, v
            if causal:
                end = max(0, min(k.shape[1], off + qb.shape[1]))
                kb, vb = k[:, :end], v[:, :end]
            o, lse = fa.flash_attention_reference(qb, kb, vb, causal=causal, scale=scale,
                                                  q_offset=off)
            outs.append(o)
            lses.append(lse)
        return torch.cat(outs, 1), torch.cat(lses, 1)
    return plain


def long_attention_phase(fa) -> dict:
    """K2 at the 10-minute path's shapes against the plain version over row blocks, in
    f32 and bf16, with the kernel, the plain version and SDPA timed (few repetitions: a
    16,384-token causal launch takes a tenth of a second or more)."""
    cases = [  # name, q shape, k shape, causal, scale, plain rows per block
        ("encoder_10min", (20, 1500, 20, 64), (20, 1500, 20, 64), False, 1.0, 500),
        ("lm_prefill_16k", (1, 16384, 28, 128), (1, 16384, 4, 128), True, None, 1024),
    ]
    gen = torch.Generator(device="cuda").manual_seed(2)
    results = {}
    for name, qs, ks, causal, scale, rows in cases:
        d = qs[-1]
        q_mul = 1.0 / (d ** 0.5 * (scale if scale is not None else d ** -0.5))
        q32 = torch.randn(qs, generator=gen, device="cuda") * q_mul
        k32 = torch.randn(ks, generator=gen, device="cuda")
        v32 = torch.randn(ks, generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = q32.to(dtype), k32.to(dtype), v32.to(dtype)
            kw = dict(causal=causal, scale=scale, q_offset=0)
            plain = plain_blocked(fa, rows)
            r = compare(fa, q, k, v, kw, plain)
            r["ms"] = time_ms(lambda: fa.flash_attention_lse(q, k, v, **kw), 3, 1)
            r["plain_ms"] = time_ms(lambda: plain(q, k, v, **kw), 2, 1)
            r["library_ms"] = time_ms(sdpa_call(q, k, v, kw), 3, 1)
            r["bound_ms"], r["bound_by"] = attention_bound_ms(qs, ks, causal, 0, r["dtype"])
            log(f"flash {name:14s} {r['dtype']:8s} q{list(qs)} k{list(ks)} causal={causal}: "
                f"max|o-plain|={r['err']:.3e} (at {r['ratio']:.3f} of its limit) "
                f"max|lse-plain|={r['lse_err']:.3e} ms={r['ms']:.3f} plain_ms="
                f"{r['plain_ms']:.3f} (blocks of {rows} rows) library_ms={r['library_ms']:.3f} "
                f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}); "
                f"{r['bound_ms'] / r['ms'] * 100:.2f} % of the bound")
            check_compare(name, r)
            results[(name, r["dtype"])] = r
        del q32, k32, v32, q, k, v
        torch.cuda.empty_cache()
    return results


def log_mel_bound_ms(n: int, fe) -> tuple:
    """Least time for K1 on n windows: the f32 DFT and mel products on CUDA cores against
    each input read once and the output written once."""
    cfg = fe.cfg
    n_fft, n_bins, n_mels = cfg.n_fft, cfg.n_fft // 2 + 1, cfg.num_mel_bins
    frames = fe.frames_per_window
    flops = n * frames * (n_fft * 2 * n_bins * 2 + n_bins * n_mels * 2)
    nbytes = 4 * (n * fe.window_samples + 2 * n_fft * n_bins + n_bins * n_mels
                  + n * frames * n_mels)
    t_ops, t_bytes = flops / PEAK_FLOPS["float32"], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def log_mel_phase(lm, fe) -> dict:
    """K1 against its plain version at [1, 480000] and [20, 480000], on a seeded tone plus
    noise and on normal x 0.1, held to |x - plain| <= 5e-4 + 1e-4 |plain| (the JAX
    kernel's own test bound); kernel and plain version timed on the normal input."""
    rng = np.random.default_rng(3)
    t = np.arange(fe.window_samples) / 16000.0
    results = {}
    for n in (1, 20):
        for kind in ("tone", "normal"):
            if kind == "tone":
                w = np.stack([0.3 * np.sin(2 * np.pi * (220.0 + 37.0 * i) * t)
                              + 0.05 * rng.standard_normal(t.size) for i in range(n)])
            else:
                w = rng.standard_normal((n, fe.window_samples)) * 0.1
            wins = torch.tensor(w, dtype=torch.float32, device="cuda")
            args = (wins, fe.dft_cos, fe.dft_sin, fe.mel_weights, fe.cfg.hop_length,
                    fe.frames_per_window)
            out = lm.fused_log_mel(*args)
            ref = lm.log_mel_reference(*args)
            diff = (out - ref).abs()
            atol, rtol = MEL_TOL
            r = dict(err=diff.max().item(),
                     ratio=(diff / (atol + rtol * ref.abs())).max().item())
            check(out.shape == (n, fe.frames_per_window, fe.cfg.num_mel_bins),
                  f"K1 output shape {tuple(out.shape)}")
            check(bool(torch.isfinite(out).all()), "K1 output not finite")
            msg = (f"log_mel [{n},{fe.window_samples}] {kind:6s}: max|x-plain|={r['err']:.3e} "
                   f"(at {r['ratio']:.3f} of its limit)")
            if kind == "normal":
                r["ms"] = time_ms(lambda: lm.fused_log_mel(*args))
                r["plain_ms"] = time_ms(lambda: lm.log_mel_reference(*args), 10, 2)
                r["bound_ms"], r["bound_by"] = log_mel_bound_ms(n, fe)
                msg += (f" ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms=none "
                        f"(no single PyTorch call computes this function) bound_ms="
                        f"{r['bound_ms']:.4f} ({r['bound_by']}); "
                        f"{r['bound_ms'] / r['ms'] * 100:.1f} % of the bound")
            log(msg)
            check(r["ratio"] <= 1.0, f"K1 [{n}] {kind}: |x - plain| at {r['ratio']:.3f} "
                                     "of its limit")
            results[(n, kind)] = r
    return results


def write_wav(path: str, seconds: int, sr: int, seed: int) -> None:
    """A 16-bit stereo WAV: a tone per channel plus noise, from a numpy seed."""
    rng = np.random.default_rng(seed)
    t = np.arange(seconds * sr, dtype=np.float64) / sr
    left = 0.3 * np.sin(2 * np.pi * 440.0 * t) + 0.05 * rng.standard_normal(t.size)
    right = 0.2 * np.sin(2 * np.pi * 660.0 * t) + 0.05 * rng.standard_normal(t.size)
    pcm = np.clip(np.stack([left, right], 1) * 32767, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def ten_minute_phase(model, fa, lm) -> dict:
    """A 600 s 48 kHz stereo WAV in, answer out: load_audio, then generate() through a
    processor whose frontend runs the log-mel kernel, twice; returns the warm run."""
    from audio_flamingo_tpu_torch.audio import io as aio
    from audio_flamingo_tpu_torch.audio.mel import WhisperMelFrontend
    from audio_flamingo_tpu_torch.config import MelConfig
    from audio_flamingo_tpu_torch.runtime.processor import AF3Processor

    seconds, sr = 600, 48_000
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ten_minutes.wav")
        t0 = time.perf_counter()
        write_wav(path, seconds, sr, seed=4)
        log(f"10-minute file: wrote {os.path.getsize(path) / 1e6:.1f} MB ({seconds} s, "
            f"{sr} Hz, 16-bit stereo) in {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        wav = aio.load_audio(path, target_sr=16_000)
        load_s = time.perf_counter() - t0
        with open(path, "rb") as f:
            data = f.read()
    check(wav.shape == (seconds * 16_000,) and wav.dtype == np.float32,
          f"load_audio gave {wav.shape} {wav.dtype}")
    check(bool(np.isfinite(wav).all()), "load_audio output not finite")
    # the native decode against the numpy one on the whole file, and the native resampler
    # against numpy's over the first 9 s (their inputs lie inside the first 10 s)
    mono, _ = aio.decode_wav_np(data)
    native, _ = aio.decode_wav(data)
    dec_err = float(np.abs(native - mono).max())
    res_err = float(np.abs(aio.resample_np(mono[: 10 * sr], sr, 16_000)[: 9 * 16_000]
                           - wav[: 9 * 16_000]).max())
    log(f"load_audio: {wav.size} samples at 16 kHz in {load_s:.2f}s (host); native vs numpy "
        f"decode max|d|={dec_err:.2e}, resample (first 9 s) max|d|={res_err:.2e}")
    check(dec_err <= 1e-6 and res_err <= 1e-5, "native audio input differs from numpy")
    del data, mono, native

    frontend = WhisperMelFrontend(MelConfig(num_mel_bins=model.cfg.encoder.num_mel_bins),
                                  use_pallas=True)
    long = dataclasses.replace(model, processor=AF3Processor(
        tokenizer=model.processor.tokenizer, cfg=model.cfg, frontend=frontend),
        history=[], last_output=None, last_processor_s=None)
    runs = []
    for i in range(2):
        for counter in (fa.LAUNCHES, lm.LAUNCHES):
            counter.reset()
            counter.timing = True
        torch.cuda.reset_peak_memory_stats()
        _, e2e, split = timed_generate(long, sound=wav, prompt="What do you hear?",
                                       max_new_tokens=4)
        out = long.last_output
        run = dict(e2e=e2e, proc=long.last_processor_s, ttft=out.ttft_s,
                   ids=out.tokens[0, : int(out.lengths[0])].tolist(),
                   logits_finite=bool(torch.isfinite(out.first_logits).all()),
                   k1_ms=lm.LAUNCHES.device_ms(), k1_launches=lm.LAUNCHES.count,
                   k1_shapes=dict(lm.LAUNCHES.shapes), k2_ms=fa.LAUNCHES.device_ms(),
                   k2_launches=fa.LAUNCHES.count, k2_shapes=dict(fa.LAUNCHES.shapes),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        for counter in (fa.LAUNCHES, lm.LAUNCHES):
            counter.timing = False
            counter.reset()
        log(f"10-minute generate #{i + 1}: ids={run['ids']} {split}; K1 "
            f"{run['k1_launches']} launches {run['k1_ms']:.3f} ms; K2 {run['k2_launches']} "
            f"launches {run['k2_ms']:.1f} ms; peak GPU memory {run['peak_gib']:.2f} GiB")
        runs.append(run)
    prompt_len = int(long.processor(messages=[{"role": "user", "content": "<sound>What do you "
                                                "hear?"}], audios=[wav])["ids"].shape[1])
    check(8192 < prompt_len <= 16384, f"10-minute prompt of {prompt_len} tokens is not in the "
                                      "16,384 bucket")
    k1_expected = {("log_mel", (20, 480_000)): 1, ("clamp", (20, 3000, 128)): 1}
    k2_expected = {((20, 1500, 20, 64), (20, 1500, 20, 64), False): 32,
                   ((1, 16384, 28, 128), (1, 16384, 4, 128), True): 28}
    for run in runs:
        check(run["k1_launches"] == 2 and run["k1_shapes"] == k1_expected,
              f"K1 launches {run['k1_shapes']} != {k1_expected}")
        check(run["k2_launches"] == 60 and run["k2_shapes"] == k2_expected,
              f"K2 launches {run['k2_shapes']} != {k2_expected}")
        check(run["logits_finite"], "10-minute prefill logits not finite")
        check(all(0 <= t < model.cfg.lm.vocab_size for t in run["ids"]), "ids out of vocab")
    check(runs[0]["ids"] == runs[1]["ids"], f"10-minute greedy ids differ: "
                                            f"{runs[0]['ids']} vs {runs[1]['ids']}")
    warm = runs[1]
    log(f"10-minute warm run: prompt of {prompt_len} tokens in the 16,384 bucket, end to end "
        f"{warm['e2e']:.3f} s, user TTFT {warm['proc'] + warm['ttft']:.3f} s, of which processor {warm['proc']:.3f} s "
        f"(K1 {warm['k1_ms']:.3f} ms), K2 {warm['k2_ms'] / 1e3:.3f} s, rest of the prefill "
        f"{warm['ttft'] - warm['k2_ms'] / 1e3:.3f} s")
    return warm


def f32_card_vs_cpu_phase(fa, lm) -> None:
    """The same weights at f32 on the card and on the CPU (whose path the CPU tests pin to
    the JAX package): full width, 2 encoder and 2 LM layers, weights made on the CPU from
    a seed. af3.logits with a 30 s clip within 1e-4; a greedy 8-token generate
    token-exact, and not all one token. The card runs flash and the log-mel kernel."""
    from audio_flamingo_tpu_torch.api import AudioFlamingo
    from audio_flamingo_tpu_torch.audio.mel import WhisperMelFrontend
    from audio_flamingo_tpu_torch.config import AF3Config, MelConfig
    from audio_flamingo_tpu_torch.models import af3
    from audio_flamingo_tpu_torch.runtime.processor import AF3Processor

    full = AF3Config()
    cfg = with_flash(dataclasses.replace(
        full, encoder=dataclasses.replace(full.encoder, num_layers=2),
        lm=dataclasses.replace(full.lm, num_layers=2)), True)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False      # the conv stem in full f32 (README)
    try:
        t0 = time.perf_counter()
        cpu = AudioFlamingo.from_random(cfg, seed=0, compute_dtype=torch.float32, device="cpu")
        card = AudioFlamingo.from_state_dict(cpu.cfg, cpu.model.state_dict(),
                                             cpu.processor.tokenizer, torch.float32,
                                             device="cuda")
        card = dataclasses.replace(card, processor=AF3Processor(
            tokenizer=card.processor.tokenizer, cfg=card.cfg, frontend=WhisperMelFrontend(
                MelConfig(num_mel_bins=cfg.encoder.num_mel_bins), use_pallas=True)))
        log(f"f32 card vs CPU: {sum(p.numel() for p in cpu.model.parameters()) / 1e9:.3f} B "
            f"params (2 + 2 layers, full width), built on the CPU and copied in "
            f"{time.perf_counter() - t0:.1f}s")
        rng = np.random.default_rng(0)
        t = np.arange(30 * 16000) / 16000.0
        wav = (0.3 * np.sin(2 * np.pi * 440.0 * t)
               + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
        msgs = [{"role": "user", "content": "<sound>What do you hear?"}]
        bc = cpu.processor(messages=msgs, audios=[wav])
        lm.LAUNCHES.reset()
        bg = card.processor(messages=msgs, audios=[wav])
        check(lm.LAUNCHES.count == 2, f"the card's log-mel made {lm.LAUNCHES.count} K1 "
                                      "launches, not 2")
        check(np.array_equal(bc["ids"], bg["ids"]), "processor ids differ card vs CPU")
        fa.LAUNCHES.reset()
        lc = af3.logits(cpu.model, cpu.cfg, torch.as_tensor(bc["ids"]).long(), bc["mels"])
        lg = af3.logits(card.model, card.cfg, torch.as_tensor(bg["ids"], device="cuda").long(),
                        bg["mels"]).cpu()
        launches = fa.LAUNCHES.count
        err = (lg - lc).abs().max().item()
        mel_err = (bg["mels"].cpu() - bc["mels"]).abs().max().item()
        log(f"f32 af3.logits {tuple(lc.shape)}: max|card - CPU| = {err:.3e} (limit "
            f"{LOGITS_TOL}), max|logit| {lc.abs().max().item():.3f}; log-mel max|card - CPU| "
            f"{mel_err:.2e}; flash launches on the card {launches}")
        check(launches == 4, f"f32 card logits made {launches} flash launches, not 2 + 2")
        check(err <= LOGITS_TOL, f"f32 logits card vs CPU {err} > {LOGITS_TOL}")
        cpu.generate(prompt="What do you hear?", max_new_tokens=8)
        _, _, split = timed_generate(card, prompt="What do you hear?", max_new_tokens=8)
        ids = [m.last_output.tokens[0, : int(m.last_output.lengths[0])].tolist()
               for m in (cpu, card)]
        log(f"f32 greedy 8 tokens: CPU {ids[0]}, card {ids[1]} (card {split})")
        check(ids[0] == ids[1], "f32 greedy ids differ card vs CPU")
        check(len(set(ids[0])) > 1, f"f32 greedy ids are all one token: {ids[0]}")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def timed_generate(model, **kw) -> tuple:
    """One AudioFlamingo.generate call timed from its start: (text, wall seconds, and a
    line splitting it into the processor's share, ttft_s, their sum (the TTFT a user
    sees) and the decode after it). generate ends device-synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text = model.generate(**kw)
    wall = time.perf_counter() - t0
    proc, ttft = model.last_processor_s, model.last_output.ttft_s
    split = (f"call {wall * 1e3:.1f} ms = processor {proc * 1e3:.1f} ms + ttft "
             f"{ttft * 1e3:.1f} ms + decode {(wall - proc - ttft) * 1e3:.1f} ms; user TTFT "
             f"{(proc + ttft) * 1e3:.1f} ms")
    return text, wall, split


def with_flash(cfg, on: bool):
    return dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, use_flash=on),
                               lm=dataclasses.replace(cfg.lm, use_flash=on))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    from audio_flamingo_tpu_torch.api import AudioFlamingo
    from audio_flamingo_tpu_torch.audio.mel import WhisperMelFrontend
    from audio_flamingo_tpu_torch.config import AF3Config, MelConfig
    from audio_flamingo_tpu_torch.ops.kernels import _build
    from audio_flamingo_tpu_torch.ops.kernels import flash_attention as fa
    from audio_flamingo_tpu_torch.ops.kernels import log_mel as lm

    # 1. card
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    log(f"card: {card}; {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # 2. build
    path = _build.build()
    _build.load_library()
    log(f"build: {path} in {_build.build_seconds or 0.0:.1f}s (one nvcc call)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # 3. kernels against their plain versions
    res = kernel_phase(fa)
    fe = WhisperMelFrontend(MelConfig(num_mel_bins=128))
    mel_res = log_mel_phase(lm, fe)
    long_res = long_attention_phase(fa)

    # 4. the 30 s main path at full AF3 width
    cfg = with_flash(AF3Config(), True)
    model = AudioFlamingo.from_random(cfg, seed=0, compute_dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_params = sum(p.numel() for p in model.model.parameters())
    log(f"from_random: {n_params / 1e9:.3f} B params, bf16, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    rng = np.random.default_rng(0)
    t = np.arange(30 * 16000) / 16000.0
    wav = (0.3 * np.sin(2 * np.pi * 440.0 * t) + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    runs = []
    for i in range(3):
        fa.LAUNCHES.reset()
        lm.LAUNCHES.reset()
        fa.LAUNCHES.timing, fa.LAUNCHES.capture = True, i == 2
        text, _, split = timed_generate(model, sound=wav, prompt="What do you hear?",
                                        max_new_tokens=16)
        launches, shapes = fa.LAUNCHES.count, dict(fa.LAUNCHES.shapes)
        check(lm.LAUNCHES.count == 0, "the 30 s path's plain frontend launched K1")
        kernel_ms, captured = fa.LAUNCHES.device_ms(), list(fa.LAUNCHES.inputs)
        fa.LAUNCHES.timing = fa.LAUNCHES.capture = False
        out = model.last_output
        ids = out.tokens[0, : int(out.lengths[0])].tolist()
        tps = out.decode_steps / out.decode_s if out.decode_s > 0 else float("nan")
        log(f"generate #{i + 1}: ids={ids} text={text!r} {split}; decode={tps:.1f} tok/s "
            f"({out.decode_steps} steps) flash launches={launches}, their device time in the "
            f"path {kernel_ms:.3f} ms")
        runs.append((ids, out, launches, shapes, kernel_ms))
        if i == 1:
            log(f"peak GPU memory through two generates: "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    fa.LAUNCHES.reset()
    unembed_phase(model.model.lm)
    # a decode step reads every LM weight but the embedding table once
    step_bytes = sum(p.numel() * p.element_size() for n, p in model.model.lm.named_parameters()
                     if n != "embed_tokens" or cfg.lm.tie_word_embeddings)
    log(f"decode bound: {step_bytes / 1e9:.2f} GB of LM weights per step = "
        f"{step_bytes / PEAK_BYTES * 1e3:.2f} ms/step at {PEAK_BYTES / 1e12:.2f} TB/s "
        f"({PEAK_BYTES / step_bytes:.0f} tok/s)")
    expected = {((1, 1500, 20, 64), (1, 1500, 20, 64), False): 32,
                ((1, 1024, 28, 128), (1, 1024, 4, 128), True): 28}
    for ids, out, launches, shapes, _ in runs:
        check(launches == 60, f"flash launches per generate {launches} != 60")
        check(shapes == expected, f"flash launch shapes {shapes} != {expected}")
        check(all(0 <= i < cfg.lm.vocab_size for i in ids), f"ids out of vocab: {ids}")
        check(bool(torch.isfinite(out.first_logits).all()), "prefill logits not finite")
    check(all(r[0] == runs[0][0] for r in runs), f"greedy ids differ: {[r[0] for r in runs]}")
    check(len(captured) == 60, f"captured {len(captured)} launches, not 60")

    rep = replay_phase(fa, captured)
    del captured
    log(f"main-path launches replayed on their own inputs (60, bf16): max|o-plain|="
        f"{rep['err']:.3e} (at {rep['ratio']:.3f} of its limit) max|lse-plain|="
        f"{rep['lse_err']:.3e}; summed kernel {rep['kernel_ms']:.3f} ms (in the path "
        f"{runs[2][4]:.3f} ms), plain {rep['plain_ms']:.3f} ms, SDPA "
        f"{rep['library_ms']:.3f} ms, bound {rep['bound_ms']:.4f} ms ({rep['bound_by']})")

    plain = model.with_config(with_flash(model.cfg, False))
    fa.LAUNCHES.reset()
    _, _, split = timed_generate(plain, sound=wav, prompt="What do you hear?", max_new_tokens=1)
    check(fa.LAUNCHES.count == 0, "plain path launched the flash kernel")
    log(f"plain-attention prefill: {split}")
    a, b = runs[0][1].first_logits.double(), plain.last_output.first_logits.double()
    cos = F.cosine_similarity(a, b, dim=-1).min().item()
    log(f"prefill logits flash vs plain attention: cosine={cos:.6f} "
        f"max|diff|={(a - b).abs().max().item():.4f} "
        f"argmax {int(a.argmax())} vs {int(b.argmax())}")
    check(cos >= 0.999, f"prefill logit cosine {cos} < 0.999")
    log(f"peak GPU memory since from_random {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del plain

    # 5. a 10-minute file, in to answer out
    warm = ten_minute_phase(model, fa, lm)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # 6. f32 card against CPU
    f32_card_vs_cpu_phase(fa, lm)

    for (name, dn), r in long_res.items():
        log(f"K2 {name} {dn}: {r['ms']:.3f} ms, bound {r['bound_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.3f} ms, SDPA {r['library_ms']:.3f} ms")
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "audio_flamingo_tpu_torch/csrc/flash_attention.cu",
        "replaces": "audio_flamingo_tpu/ops/pallas/flash_attention.py:258",
        "launches": runs[1][2],
        "max_abs_err": max([r["err"] for r in res.values()] + [rep["err"]]
                           + [r["err"] for r in long_res.values()]),
        "ms": runs[1][4],
        "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"],
        "bound_by": rep["bound_by"],
        "library_ms": rep["library_ms"],
    }, {
        "name": "log_mel",
        "route": "cuda",
        "source": "audio_flamingo_tpu_torch/csrc/log_mel.cu",
        "replaces": "audio_flamingo_tpu/ops/pallas/stft_mel.py:58",
        "launches": warm["k1_launches"],
        "max_abs_err": max(r["err"] for r in mel_res.values()),
        "ms": warm["k1_ms"],
        "plain_ms": mel_res[(20, "normal")]["plain_ms"],
        "bound_ms": mel_res[(20, "normal")]["bound_ms"],
        "bound_by": mel_res[(20, "normal")]["bound_by"],
        "library_ms": None,
    }]
    log("kernel line: flash_attention_fwd per warm 30 s generate: ms = the 60 launches' device "
        "time inside generate #2 (CUDA events around each launch); plain_ms, library_ms = the "
        "plain version and SDPA timed on each launch's captured inputs, summed; bound_ms = "
        "summed per-launch bounds. log_mel per warm 10-minute generate: ms = its 2 launches' "
        "device time inside it; plain_ms and bound_ms at [20, 480000]; library_ms null: no "
        "single PyTorch call computes this function")
    print(json.dumps({"kernels": kernels}), flush=True)
    log("done")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
