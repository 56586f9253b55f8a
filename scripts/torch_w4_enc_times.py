#!/usr/bin/env python3
"""Device times of the port's w4a16 matmul (K5), its w4 suffixes (K6), the fused encoder
MLP (K9 ``enc_mlp``) and the fused log-mel (K1) on one GPU, beside the library call and
the composed torch form, so that two trees can be compared on one card in one run.

    python3 scripts/torch_w4_enc_times.py [--root DIR] [--tag NAME] [--reps N]
                                          [--only k5,k6,mlp,k1,decode] [--check]

``--root`` names the repository checkout whose ``audio_flamingo_tpu_torch`` is measured
(default: this one), so a parent commit unpacked beside the tree can be timed in the
same call (parent, change, change, parent). Every time is a device time: the calls
captured in a CUDA graph, the replay timed with CUDA events (median of ``--reps`` after
3) and divided by the calls in it, the host left out.

- K5 at the 7B int4 LM's shapes (qkv [3584, 4608], o [3584, 3584], gate|up [3584,
  37888], down [18944, 3584], group 128) on random codes stacked over 28 layers, m 1, 8
  and 256, f32 and bf16 x: ``warm`` is 28 launches on layer 0 in one graph, divided by
  28 (its weights stay in the 50 MB L2 when they fit, as the library call's do; the
  graph's own launch cost is spread over the 28), ``cold`` is one launch per
  layer in one graph over the 28 layers, divided by 28 (the weights stream from HBM, as
  in a decode step); the int4 head [3584, 152064] at m 1 and 8 (one matrix, always
  cold). The library call is ``torch._weight_int4pack_mm`` on the same codes (bf16 x),
  timed as ``warm`` is (its repacked copy of layer 0 only).
- K6 A and B at m 1 and 8: 8 calls on layer 0 in one graph, divided by 8, and one decode
  step's 28 A + 28 B (layer after layer, as a step reads them).
- ``enc_mlp`` at m 1500 and 30,000 (d 1280, ffn 5120), bf16 and f32, beside the composed
  torch form (``whisper_encoder.stage_mlp(..., fused=False)``).
- the int4 7B decode (``--only decode``, bench.py's ``bench_decode_w4`` point): the LM from
  ``random_quantized_lm_w4`` on a bf16 cache, batch 1, capacity 1024, 32 greedy steps
  (a warm run, then the median of 3): ms per step and tok/s, host included, and K6's
  launches timed with CUDA events around each in one more run (K6 in the path).
- K1 at [1, 480000] and [20, 480000] (normal x 0.1 samples): the frontend's
  ``_window_mels`` with the kernel (4 and 2 calls a graph), beside both of its bounds: the
  f32 products on the CUDA cores (67 TFLOP/s) and in 3xTF32 on the tensor cores (three
  times the work at 495 TFLOP/s).

``--check`` first holds the tree's K6 and K1 to their plain versions (K6 at the 7B shapes
on random codes, m 1, 3 and 8, f32 and bf16, layers 0 and 27, at chip_smoke's limits; K1
on a tone and on noise at both shapes within 5e-4 + 1e-4 |plain|), checks that two
launches on the same inputs agree bit for bit, and counts with ``torch.profiler`` the
kernels one call launches; a failed check exits 1.

Each case prints one JSON line; the last line holds them all, with the card's name and
power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys

import torch

PEAK_BYTES = 3.35e12
PEAK_F32, PEAK_TF32 = 67e12, 495e12                      # H100 SXM dense
W4_F32_TOL = 1e-5                                         # chip_smoke's K5/K6 limits
W4_BF16_TOL = (2.0 ** -7, 2.0 ** -9)
MEL_TOL = (5e-4, 1e-4)                                    # chip_smoke's K1 limit


def graph_ms(fn, reps: int, calls: int = 1) -> float:
    """Device ms of one call: ``calls`` calls captured in one CUDA graph, the replay timed
    (median of ``reps`` after 3) and divided by ``calls``."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    for _ in range(3):
        graph.replay()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times) / calls


def w4_bytes(k: int, n: int, group: int) -> int:
    return k // 2 * n + k // group * n * 4


def random_w4(gen, layers: int, k: int, n: int, group: int) -> dict:
    w_p = torch.randint(-128, 128, (layers, k // 2, n), generator=gen, device="cuda",
                        dtype=torch.int8)
    gscale = torch.rand((layers, k // group, n), generator=gen, device="cuda") * 0.02 + 1e-3
    return {"w_p": w_p, "gscale": gscale}


def int4pack(x, w_p, gscale):
    """torch._weight_int4pack_mm on the same codes (q = code + 8, [N, K], bf16 scales)."""
    from audio_flamingo_tpu_torch.ops.quant4 import unpack_w4

    k, n = 2 * w_p.shape[0], w_p.shape[1]
    group = k // gscale.shape[0]
    q = (unpack_w4(w_p).to(torch.int32) + 8).t().contiguous()
    w = torch._convert_weight_to_int4pack((q[:, ::2] << 4 | q[:, 1::2]).to(torch.uint8), 8)
    del q
    sz = torch.stack([gscale, torch.zeros_like(gscale)], -1).to(torch.bfloat16).contiguous()
    return lambda: torch._weight_int4pack_mm(x, w, group, sz)


def emit(rows: list, **row) -> None:
    rows.append(row)
    print(json.dumps(row), flush=True)


def k5_cases(k5, rows: list, reps: int) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    layers, group = 28, 128
    shapes = {"qkv": (3584, 4608), "o": (3584, 3584), "gateup": (3584, 37888),
              "down": (18944, 3584)}
    for name, (k, n) in shapes.items():
        p = random_w4(gen, layers, k, n, group)
        for m in (1, 8, 256):
            x32 = torch.randn((m, k), generator=gen, device="cuda")
            for dtype in (torch.float32, torch.bfloat16):
                x = x32.to(dtype)
                warm = graph_ms(lambda: k5.w4a16_matmul_stacked(x, p["w_p"], p["gscale"], 0),
                                reps, layers)

                def every_layer():
                    for i in range(layers):
                        k5.w4a16_matmul_stacked(x, p["w_p"], p["gscale"], i)

                cold = graph_ms(every_layer, reps) / layers
                lib = (graph_ms(int4pack(x, p["w_p"][0], p["gscale"][0]), reps, layers)
                       if dtype == torch.bfloat16 else None)
                emit(rows, kernel="K5", shape=name, m=m, k=k, n=n,
                     dtype=str(dtype).split(".")[-1], warm_ms=warm, cold_ms=cold,
                     library_ms=lib, bytes_ms=w4_bytes(k, n, group) / PEAK_BYTES * 1e3)
        del p
        torch.cuda.empty_cache()
    k, n = 3584, 152064
    head = random_w4(gen, 1, k, n, group)
    w_p, gs = head["w_p"][0], head["gscale"][0]
    for m in (1, 8):
        x32 = torch.randn((m, k), generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            t = graph_ms(lambda: k5.w4a16_matmul(x, w_p, gs), reps, 4)
            lib = graph_ms(int4pack(x, w_p, gs), reps, 4) if dtype == torch.bfloat16 else None
            emit(rows, kernel="K5", shape="head", m=m, k=k, n=n,
                 dtype=str(dtype).split(".")[-1], warm_ms=t, cold_ms=t, library_ms=lib,
                 bytes_ms=w4_bytes(k, n, group) / PEAK_BYTES * 1e3)
    del head, w_p, gs
    torch.cuda.empty_cache()


def k6_cases(k6, rows: list, reps: int) -> None:
    gen = torch.Generator(device="cuda").manual_seed(1)
    layers, group, d, f = 28, 128, 3584, 18944
    o = random_w4(gen, layers, d, d, group)
    gu = random_w4(gen, layers, d, 2 * f, group)
    down = random_w4(gen, layers, f, d, group)
    qkv = random_w4(gen, layers, d, 4608, group)
    for m in (1, 8):
        for dtype in (torch.float32, torch.bfloat16):
            attn = torch.randn((m, d), generator=gen, device="cuda").to(dtype)
            h = torch.randn((m, d), generator=gen, device="cuda").to(dtype)
            ln = (1.0 + 0.1 * torch.randn((d,), generator=gen, device="cuda")).to(dtype)
            act, h1 = k6.w4_suffix_a(attn, h, ln, o, gu, 0)
            a_ms = graph_ms(lambda: k6.w4_suffix_a(attn, h, ln, o, gu, 0), reps, 8)
            b_ms = graph_ms(lambda: k6.w4_suffix_b(act, h1, ln, down, qkv, 0, 1), reps, 8)

            def step():
                for i in range(layers):
                    k6.w4_suffix_a(attn, h, ln, o, gu, i)
                    k6.w4_suffix_b(act, h1, ln, down, qkv, i, min(i + 1, layers - 1))

            step_ms = graph_ms(step, reps)
            emit(rows, kernel="K6", m=m, dtype=str(dtype).split(".")[-1], a_ms=a_ms,
                 b_ms=b_ms, step_ms=step_ms)
    del o, gu, down, qkv
    torch.cuda.empty_cache()


def k6_weights(gen, layers: int = 28, group: int = 128, d: int = 3584, f: int = 18944,
               n_qkv: int = 4608) -> tuple:
    return (random_w4(gen, layers, d, d, group), random_w4(gen, layers, d, 2 * f, group),
            random_w4(gen, layers, f, d, group), random_w4(gen, layers, d, n_qkv, group))


def kernels_per_call(fn) -> int:
    """Device kernels one call of fn launches, as torch.profiler sees them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and "memcpy" not in e.name.lower() and "memset" not in e.name.lower())


def w4_ratio(y: torch.Tensor, ref: torch.Tensor) -> float:
    diff = (y.float() - ref.float()).abs()
    scale = ref.float().abs().max().item()
    if y.dtype == torch.float32:
        return (diff / (W4_F32_TOL * scale)).max().item()
    return (diff / (W4_BF16_TOL[0] * ref.float().abs() + W4_BF16_TOL[1] * scale)).max().item()


def check_k6(k6, failures: list) -> None:
    gen = torch.Generator(device="cuda").manual_seed(11)
    o, gu, down, qkv = k6_weights(gen)
    d, f = 3584, 18944
    for m in (1, 3, 8):
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            attn = torch.randn((m, d), generator=gen, device="cuda").to(dtype)
            h = torch.randn((m, d), generator=gen, device="cuda").to(dtype)
            ln = (1.0 + 0.1 * torch.randn((d,), generator=gen, device="cuda")).to(dtype)
            for layer in (0, 27):
                nxt = min(layer + 1, 27)
                a = k6.w4_suffix_a(attn, h, ln, o, gu, layer)
                a2 = k6.w4_suffix_a(attn, h, ln, o, gu, layer)
                ra = k6.w4_suffix_a_reference(attn, h, ln, o, gu, layer)
                b = k6.w4_suffix_b(a[0], a[1], ln, down, qkv, layer, nxt)
                b2 = k6.w4_suffix_b(a[0], a[1], ln, down, qkv, layer, nxt)
                rb = k6.w4_suffix_b_reference(a[0], a[1], ln, down, qkv, layer, nxt)
                ratios = {name: w4_ratio(u, v) for name, u, v in (
                    ("act", a[0], ra[0]), ("h", a[1], ra[1]), ("h2", b[0], rb[0]),
                    ("qkv", b[1], rb[1]))}
                same = all(torch.equal(u, v) for u, v in zip((*a, *b), (*a2, *b2)))
                finite = all(bool(torch.isfinite(u.float()).all()) for u in (*a, *b))
                ok = max(ratios.values()) <= 1.0 and same and finite
                print(json.dumps({"check": "K6", "m": m, "dtype": dn, "layer": layer,
                                  "ratios": ratios, "replay_identical": same, "ok": ok}),
                      flush=True)
                if not ok:
                    failures.append(f"K6 m={m} {dn} layer {layer}")
            if m in (1, 8):
                act, h1 = k6.w4_suffix_a(attn, h, ln, o, gu, 0)
                na = kernels_per_call(lambda: k6.w4_suffix_a(attn, h, ln, o, gu, 0))
                nb = kernels_per_call(lambda: k6.w4_suffix_b(act, h1, ln, down, qkv, 0, 1))
                print(json.dumps({"check": "K6 kernels per call", "m": m, "dtype": dn,
                                  "a": na, "b": nb}), flush=True)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    ga = k6.w4_suffix_a(attn, h, ln, o, gu, 0)
                graph.replay()
                torch.cuda.synchronize()
                first = [t.clone() for t in ga]
                graph.replay()
                torch.cuda.synchronize()
                same = all(torch.equal(u, v) for u, v in zip(first, ga))
                eager = k6.w4_suffix_a(attn, h, ln, o, gu, 0)
                same = same and all(torch.equal(u, v) for u, v in zip(first, eager))
                print(json.dumps({"check": "K6 graph replays", "m": m, "dtype": dn,
                                  "identical": same}), flush=True)
                if not same:
                    failures.append(f"K6 graph replay m={m} {dn}")
    del o, gu, down, qkv
    torch.cuda.empty_cache()


def mel_frontend():
    from audio_flamingo_tpu_torch.audio.mel import WhisperMelFrontend
    from audio_flamingo_tpu_torch.config import MelConfig

    return WhisperMelFrontend(MelConfig(num_mel_bins=128), use_pallas=True, device="cuda")


def check_k1(lm, failures: list) -> None:
    fe = mel_frontend()
    rng = torch.Generator(device="cuda").manual_seed(3)
    t = torch.arange(fe.window_samples, device="cuda") / 16000.0
    for n in (1, 20):
        for kind in ("tone", "normal"):
            if kind == "tone":
                w = torch.stack([0.3 * torch.sin(2 * torch.pi * (220.0 + 37.0 * i) * t)
                                 for i in range(n)])
                w = w + 0.05 * torch.randn(w.shape, generator=rng, device="cuda")
            else:
                w = 0.1 * torch.randn((n, fe.window_samples), generator=rng, device="cuda")
            args = (w, fe.dft_cos, fe.dft_sin, fe.mel_weights, fe.cfg.hop_length,
                    fe.frames_per_window)
            out, out2 = fe._window_mels(w), fe._window_mels(w)
            ref = lm.log_mel_reference(*args)
            ratio = ((out - ref).abs() / (MEL_TOL[0] + MEL_TOL[1] * ref.abs())).max().item()
            same = torch.equal(out, out2)
            ok = ratio <= 1.0 and same and bool(torch.isfinite(out).all())
            print(json.dumps({"check": "K1", "n": n, "input": kind, "ratio": ratio,
                              "max_abs_err": (out - ref).abs().max().item(),
                              "replay_identical": same, "ok": ok}), flush=True)
            if not ok:
                failures.append(f"K1 [{n}] {kind}")
    w = 0.1 * torch.randn((1, fe.window_samples), generator=rng, device="cuda")
    print(json.dumps({"check": "K1 kernels per call",
                      "kernels": kernels_per_call(lambda: fe._window_mels(w))}), flush=True)


def k1_bounds_ms(fe, n: int) -> tuple:
    cfg = fe.cfg
    n_bins = cfg.n_fft // 2 + 1
    flops = n * fe.frames_per_window * (cfg.n_fft * 2 * n_bins * 2 + n_bins * cfg.num_mel_bins * 2)
    return flops / PEAK_F32 * 1e3, 3 * flops / PEAK_TF32 * 1e3


def k1_cases(rows: list, reps: int) -> None:
    fe = mel_frontend()
    gen = torch.Generator(device="cuda").manual_seed(4)
    for n in (1, 20):
        w = 0.1 * torch.randn((n, fe.window_samples), generator=gen, device="cuda")
        t = graph_ms(lambda: fe._window_mels(w), reps, 4 if n == 1 else 2)
        f32_ms, tf32_ms = k1_bounds_ms(fe, n)
        emit(rows, kernel="K1", n=n, ms=t, bound_f32_ms=f32_ms, bound_3xtf32_ms=tf32_ms)


def decode_cases(k6, rows: list) -> None:
    import time

    from audio_flamingo_tpu_torch.config import AF3Config
    from audio_flamingo_tpu_torch.models import qwen2
    from audio_flamingo_tpu_torch.ops.quant4 import random_quantized_lm_w4

    cfg = AF3Config().lm
    lm = qwen2.quantized_lm(random_quantized_lm_w4(torch.Generator(device="cuda").manual_seed(0),
                                                   cfg, "cuda"), torch.bfloat16, "cuda")
    steps = 32

    def run() -> float:
        cache = qwen2.init_cache(cfg, 1, 1024, torch.bfloat16, "cuda")
        token = torch.zeros((1,), dtype=torch.long, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            for _ in range(steps):
                x = qwen2.embed(lm, token[:, None])
                # the host count (an older checkout's index is a Python int)
                pos = torch.full((1, 1), getattr(cache, "host_index", cache.index),
                                 dtype=torch.long, device="cuda")
                h, cache = qwen2.forward(lm, cfg, x, pos, cache=cache)
                token = qwen2.unembed(lm, h[:, 0]).argmax(-1)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run()
    ms = statistics.median(run() for _ in range(3)) / steps * 1e3
    for c in (k6.LAUNCHES_A, k6.LAUNCHES_B):
        c.reset()
        c.timing = True
    run()
    path = (k6.LAUNCHES_A.device_ms() + k6.LAUNCHES_B.device_ms()) / steps
    for c in (k6.LAUNCHES_A, k6.LAUNCHES_B):
        c.timing = False
        c.reset()
    emit(rows, kernel="int4 decode", ms_per_step=ms, tok_s=1e3 / ms, k6_path_ms_per_step=path)
    del lm
    torch.cuda.empty_cache()


def enc_mlp_cases(ef, rows: list, reps: int) -> None:
    from audio_flamingo_tpu_torch.models import whisper_encoder as wenc
    from audio_flamingo_tpu_torch.models.qwen2 import TensorTree, cast_quantized
    from audio_flamingo_tpu_torch.ops.quant import quantize_encoder_params_fused

    d, f = 1280, 5120
    gen = torch.Generator(device="cuda").manual_seed(2)
    state = {}
    for name, (a, b) in {"q_proj": (d, d), "k_proj": (d, d), "v_proj": (d, d),
                         "out_proj": (d, d), "fc1": (d, f), "fc2": (f, d)}.items():
        state[f"layers.0.{name}.weight"] = ((torch.rand((b, a), generator=gen, device="cuda")
                                             * 2 - 1) * a ** -0.5)
        if name != "k_proj":
            state[f"layers.0.{name}.bias"] = 0.02 * torch.randn(b, generator=gen, device="cuda")
    for norm in ("self_attn_layer_norm", "final_layer_norm"):
        state[f"layers.0.{norm}.weight"] = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        state[f"layers.0.{norm}.bias"] = 0.1 * torch.randn(d, generator=gen, device="cuda")
    tree = quantize_encoder_params_fused(state, head_dim=64)
    takes_kmajor = "kmajor" in inspect.signature(ef.enc_mlp).parameters
    for m, dtype in ((1500, torch.bfloat16), (30_000, torch.bfloat16), (1500, torch.float32),
                     (30_000, torch.float32)):
        lp = TensorTree(cast_quantized(tree, dtype, "cuda"))
        f1, f2 = lp["fc1"], lp["fc2"]
        x2 = torch.randn((m, d), generator=gen, device="cuda").to(dtype)
        h = torch.randn((m, d), generator=gen, device="cuda")
        hs = h.abs().amax(-1, keepdim=True) / 127
        hq = torch.round(h / hs).clamp(-127, 127).to(torch.int8)
        args = (hq, hs, f1["w_q"][0], f1["scale"][0], f1["b"][0], f2["w_q"][0],
                f2["scale"][0], f2["b"][0], x2)
        kw = {"kmajor": ef.mlp_kmajor(args[2], args[5])} if takes_kmajor else {}
        big = m > 10_000
        t = graph_ms(lambda: ef.enc_mlp(*args, **kw), 5 if big else reps)
        composed = graph_ms(lambda: wenc.stage_mlp(hq, hs, x2, lp, 0, f, False),
                            5 if big else reps)
        emit(rows, kernel="K9 enc_mlp", m=m, dtype=str(dtype).split(".")[-1], ms=t,
             composed_ms=composed)
        del lp, x2, h, hs, hq, args, kw
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default="k5,k6,mlp,k1")
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from audio_flamingo_tpu_torch.ops.kernels import enc_fused as ef
    from audio_flamingo_tpu_torch.ops.kernels import log_mel as lm
    from audio_flamingo_tpu_torch.ops.kernels import w4_suffix as k6
    from audio_flamingo_tpu_torch.ops.kernels import w4a16_matmul as k5

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    rows: list = []
    only = set(args.only.split(","))
    if args.check:
        failures: list = []
        if "k6" in only:
            check_k6(k6, failures)
        if "k1" in only:
            check_k1(lm, failures)
        if failures:
            print(json.dumps({"tag": args.tag, "failed": failures}), flush=True)
            return 1
    if "k5" in only:
        k5_cases(k5, rows, args.reps)
    if "k6" in only:
        k6_cases(k6, rows, args.reps)
    if "mlp" in only:
        enc_mlp_cases(ef, rows, args.reps)
    if "k1" in only:
        k1_cases(rows, args.reps)
    if "decode" in only:
        decode_cases(k6, rows)
    print(json.dumps({"tag": args.tag, "root": args.root, "card": card,
                      "torch": torch.__version__, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
