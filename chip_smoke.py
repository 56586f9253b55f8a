#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (audio_flamingo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root; needs one CUDA card and nvcc

Phases, each line stamped with elapsed seconds:
  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: every csrc/*.cu in one nvcc call (seconds, ptxas report);
  3. kernels: each hand-written kernel against its plain PyTorch version at the shapes
     the main path gives it, in f32 and bf16, with its time (CUDA events, median), the
     plain version's time, one PyTorch library call's time as a yardstick, and the bound;
     scores are drawn broad (std 1) and peaked (std 3-4);
  4. main path: AudioFlamingo.from_random at full AF3 width (Whisper-large encoder +
     Qwen2.5-7B, bf16, random weights from a seed) and generate() on a 30 s waveform,
     three times, greedy; launch counts per generate, identical ids, finite logits, and the
     prefill logits against the plain-attention path on the same weights. The kernel's
     launches inside the warm generate are timed with CUDA events and their inputs
     captured; each is then replayed against the plain version and timed beside it.
Prints a {"kernels": [...]} JSON line and, last, {"ok": true, "device": {...}}. Any
failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

T0 = time.perf_counter()
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM dense: bf16 tensor, f32 CUDA cores
PEAK_BYTES = 3.35e12                                   # H100 SXM HBM3
TOL = {"float32": 2e-5, "bfloat16": 2e-2}              # max |o - o_plain|: f32 sums, bf16 output rounding
BF16_ULP_TOL = (2.0 ** -7, 1e-3)                       # bf16 o: |o - o_plain| <= 2^-7 |o_plain| + 1e-3
LSE_TOL = 1e-4                                         # f32 LSE in both dtypes (values up to ~40)


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


def compare(fa, q, k, v, kw) -> dict:
    """One kernel launch against the plain version on the same inputs.

    err: max |o - o_plain|; ratio: the largest |o - o_plain| over its limit (2e-5 in f32,
    2^-7 |o_plain| + 1e-3 in bf16), which must stay <= 1; lse_err: max |lse - lse_plain|."""
    dn = str(q.dtype).split(".")[-1]
    o, lse = fa.flash_attention_lse(q, k, v, **kw)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, **kw)
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


def with_flash(cfg, on: bool):
    return dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, use_flash=on),
                               lm=dataclasses.replace(cfg.lm, use_flash=on))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    from audio_flamingo_tpu_torch.api import AudioFlamingo
    from audio_flamingo_tpu_torch.config import AF3Config
    from audio_flamingo_tpu_torch.ops.kernels import _build
    from audio_flamingo_tpu_torch.ops.kernels import flash_attention as fa

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

    # 4. the main path at full AF3 width
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
        fa.LAUNCHES.timing, fa.LAUNCHES.capture = True, i == 2
        text = model.generate(sound=wav, prompt="What do you hear?", max_new_tokens=16)
        launches, shapes = fa.LAUNCHES.count, dict(fa.LAUNCHES.shapes)
        kernel_ms, captured = fa.LAUNCHES.device_ms(), list(fa.LAUNCHES.inputs)
        fa.LAUNCHES.timing = fa.LAUNCHES.capture = False
        out = model.last_output
        ids = out.tokens[0, : int(out.lengths[0])].tolist()
        tps = out.decode_steps / out.decode_s if out.decode_s > 0 else float("nan")
        log(f"generate #{i + 1}: ids={ids} text={text!r} ttft={out.ttft_s * 1e3:.1f} ms "
            f"decode={tps:.1f} tok/s ({out.decode_steps} steps) flash launches={launches}, "
            f"their device time in the path {kernel_ms:.3f} ms")
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
    plain.generate(sound=wav, prompt="What do you hear?", max_new_tokens=1)
    check(fa.LAUNCHES.count == 0, "plain path launched the flash kernel")
    log(f"plain-attention prefill: ttft={plain.last_output.ttft_s * 1e3:.1f} ms")
    a, b = runs[0][1].first_logits.double(), plain.last_output.first_logits.double()
    cos = F.cosine_similarity(a, b, dim=-1).min().item()
    log(f"prefill logits flash vs plain attention: cosine={cos:.6f} "
        f"max|diff|={(a - b).abs().max().item():.4f} "
        f"argmax {int(a.argmax())} vs {int(b.argmax())}")
    check(cos >= 0.999, f"prefill logit cosine {cos} < 0.999")

    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "audio_flamingo_tpu_torch/csrc/flash_attention.cu",
        "replaces": "audio_flamingo_tpu/ops/pallas/flash_attention.py:258",
        "launches": runs[1][2],
        "max_abs_err": max([r["err"] for r in res.values()] + [rep["err"]]),
        "ms": runs[1][4],
        "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"],
        "bound_by": rep["bound_by"],
        "library_ms": rep["library_ms"],
    }]
    log("kernel line, per warm generate: ms = the 60 launches' device time inside generate #2 "
        "(CUDA events around each launch); plain_ms, library_ms = the plain version and SDPA "
        "timed on each launch's captured inputs, summed; bound_ms = summed per-launch bounds")
    print(json.dumps({"kernels": kernels}), flush=True)
    log(f"done; peak GPU memory since from_random {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
