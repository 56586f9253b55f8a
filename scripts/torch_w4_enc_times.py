#!/usr/bin/env python3
"""Device times of the port's w4a16 matmul (K5), its w4 suffixes (K6) and the fused
encoder MLP (K9 ``enc_mlp``) on one GPU, beside the library call and the composed torch
form, so that two trees can be compared on one card in one run.

    python3 scripts/torch_w4_enc_times.py [--root DIR] [--tag NAME] [--reps N]

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
    ap.add_argument("--only", default="k5,k6,mlp")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from audio_flamingo_tpu_torch.ops.kernels import enc_fused as ef
    from audio_flamingo_tpu_torch.ops.kernels import w4_suffix as k6
    from audio_flamingo_tpu_torch.ops.kernels import w4a16_matmul as k5

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    rows: list = []
    only = set(args.only.split(","))
    if "k5" in only:
        k5_cases(k5, rows, args.reps)
    if "k6" in only:
        k6_cases(k6, rows, args.reps)
    if "mlp" in only:
        enc_mlp_cases(ef, rows, args.reps)
    print(json.dumps({"tag": args.tag, "root": args.root, "card": card,
                      "torch": torch.__version__, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
