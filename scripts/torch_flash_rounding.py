#!/usr/bin/env python3
"""Why the port's bf16 flash forward (K2) recomputes some scores: measured on one GPU.

    python3 scripts/torch_flash_rounding.py     # from the repo root; one CUDA card and nvcc

K2's bf16 check holds the kernel to its plain version within one bf16 step of o. P.V
takes p rounded to bf16, so the check needs p to round as the plain version's does. At
the 30 s path's two shapes (normal inputs, q scaled so that the scores have deviation 1,
4 or 8) this script measures:

1. the plain version's f32 scores (``reference_scores``) against the sequential fmaf sum
   over d = 0 .. D-1 that K2 recomputes scores by (``score_sums``): the share equal bit
   for bit;
2. K2's tensor-core scores (``score_sums``) against the plain ones: the largest
   |s - s_plain| per unit of 2^-18 (|s| + 1) after the scale;
3. the plain version's steps after its score product (``reference_from_scores``) fed
   exactly rounded scores (float64 sums) and fed its own: the largest difference of the
   bf16 outputs over the tolerance 2^-7 |o| + 1e-3. Above 1, no score sum but the plain
   version's own order passes on that shape;
4. K2's device time (torch.profiler) as built, and built with -DAF_FLASH_RECOMPUTE=0,
   which leaves the recomputed scores out (its output is not checked).

Prints one JSON line last. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from audio_flamingo_tpu_torch.ops.kernels import _build  # noqa: E402
from audio_flamingo_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402

# name, q shape, k shape, causal, scale, score deviation
SHAPES = [("encoder", (1, 1500, 20, 64), (1, 1500, 20, 64), False, 1.0, 1.0),
          ("encoder_peaked", (1, 1500, 20, 64), (1, 1500, 20, 64), False, 1.0, 4.0),
          ("lm_prefill", (1, 1024, 28, 128), (1, 1024, 4, 128), True, None, 1.0),
          ("lm_peaked", (1, 1024, 28, 128), (1, 1024, 4, 128), True, None, 4.0),
          ("encoder_dev8", (1, 1500, 20, 64), (1, 1500, 20, 64), False, 1.0, 8.0)]
TIMED = [("encoder_10min", (20, 1500, 20, 64), (20, 1500, 20, 64), False, 1.0),
         ("lm_prefill_16k", (1, 16384, 28, 128), (1, 16384, 4, 128), True, None)]


def draw(gen, qs, ks, scale, dev):
    d = qs[-1]
    sc = scale if scale is not None else d ** -0.5
    q = (torch.randn(qs, generator=gen, device="cuda") * (dev / (d ** 0.5 * sc))).bfloat16()
    k = torch.randn(ks, generator=gen, device="cuda").bfloat16()
    v = torch.randn(ks, generator=gen, device="cuda").bfloat16()
    return q, k, v, sc


def rounding() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for name, qs, ks, causal, scale, dev in SHAPES:
        q, k, v, sc = draw(gen, qs, ks, scale, dev)
        s_plain = fa.reference_scores(q, k)                      # [B, Hkv, G, Tq, Tk]
        s_mma, s_seq = (x.view(s_plain.shape) for x in fa.score_sums(q, k))
        x_plain = s_plain * sc
        err = (s_mma * sc - x_plain).abs() / (x_plain.abs() + 1) * 2 ** 18
        if causal:
            err = err.tril()
        rep = qs[2] // ks[2]
        s_exact = torch.einsum("bqkgd,bskd->bkgqs",
                               q.double().reshape(*qs[:2], ks[2], rep, qs[-1]),
                               k.double()).float()
        kw = dict(causal=causal, q_offset=0, dtype=torch.bfloat16)
        o_plain = fa.reference_from_scores(x_plain, v, **kw)[0].float()
        o_exact = fa.reference_from_scores(s_exact * sc, v, **kw)[0].float()
        ratio = ((o_exact - o_plain).abs() / (2 ** -7 * o_plain.abs() + 1e-3)).max().item()
        out[name] = dict(plain_equals_sequential=(s_plain == s_seq).float().mean().item(),
                         tc_error_per_2e18=err.max().item(),
                         exact_scores_ratio_to_tolerance=ratio)
        log(f"{name}: plain scores == sequential fmaf sum for "
            f"{out[name]['plain_equals_sequential'] * 100:.3f} %; tensor-core scores within "
            f"{out[name]['tc_error_per_2e18']:.3f} x 2^-18 (|s| + 1); exactly rounded scores "
            f"give o at {ratio:.3f} of K2's bf16 tolerance")
        del s_plain, s_seq, s_mma, s_exact, err
        torch.cuda.empty_cache()
    return out


def device_ms(fn, n: int = 5) -> float:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if "flash_fwd_mma_kernel" in e.key) / n / 1e3


def timing() -> dict:
    libs = {"as_built": _build.build(),
            "no_recompute": _build.compile_library(
                _build.find_nvcc(), (*_build.NVCC_FLAGS, "-DAF_FLASH_RECOMPUTE=0"),
                _build.sources(), "libaf_kernels")[0]}
    gen = torch.Generator(device="cuda").manual_seed(1)
    inputs = [(name, *draw(gen, qs, ks, scale, 1.0)[:3], dict(causal=causal, scale=scale))
              for name, qs, ks, causal, scale in TIMED]
    out = {}
    for tag, path in libs.items():
        _build.load_library(path)
        for name, q, k, v, kw in inputs:
            out[(name, tag)] = device_ms(lambda: fa.flash_attention_lse(q, k, v, **kw))
    _build.load_library(libs["as_built"])
    for name, *_ in inputs:
        a, b = out[(name, "as_built")], out[(name, "no_recompute")]
        log(f"K2 {name} bf16 device time: {a:.4f} ms as built, {b:.4f} ms without the "
            f"recomputed scores ({(a - b) / a * 100:.1f} % of the time)")
    return {f"{name}/{tag}": ms for (name, tag), ms in out.items()}


def log(msg: str) -> None:
    print(msg, flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_flash_rounding: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    log(f"card: {card}")
    result = dict(card=card, rounding=rounding(), k2_device_ms=timing())
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
