#!/usr/bin/env python3
"""Device times of the port's int8-QK flash attention (K8, its prelude and its body) and
its w8a16 matmul (K4) on one GPU, so that two trees can be compared on one card in one
run; with ``--check``, also each kernel held to its plain version.

    python3 scripts/torch_a8_w8_times.py [--root DIR] [--tag NAME] [--reps N] [--check]

``--root`` names the repository checkout whose ``audio_flamingo_tpu_torch`` is measured
(default: this one), so a parent commit unpacked beside the tree can be timed in the
same call (parent, change, change, parent). Every time is a device time: the calls
captured in a CUDA graph, the replay timed with CUDA events (median of ``--reps`` after
3) and divided by the calls in it, the host left out.

- K8 at chip_smoke.py phase 10a's five cases (the encoder [1|20,1500,20,64] non-causal at
  scale 1 and block_k 2048; the LM [1,1024|16384,28,128] causal over 4 KV heads; a
  ragged causal block with a q_offset), bf16: the body on the torch prelude's outputs,
  the torch prelude, and, where the tree has it, the CUDA prelude.
- K4 at the 7B int8 LM's shapes on random codes stacked over 28 layers (q, o [3584,
  3584], k, v [3584, 512], gate, up [3584, 18944], down [18944, 3584]) and the head
  [3584, 152064], bf16 x: ``cold`` is one call per layer in turn in one graph, divided by
  28 (the weights stream from HBM, as in a decode step), at m 1, 8 and 32 (the head once
  per graph); where the tree has ``w8a16_matmul_group``, q|k|v and gate|up in one launch
  each; one decode step's K4 calls (28 layers and the head) in one graph; and K4 against
  the library route (the codes copied to bf16 per call, cuBLAS) on up [3584, 18944] at m
  32-1024, layer 0.
- bench.py's ``bench_decode`` point on the tree's own int8 7B LM (``decode``): ms per
  greedy step on the host clock (batch 1, bf16 cache, capacity 1024), the end-to-end
  number K4's launches feed.

``--check`` (a tree with the CUDA prelude and the grouped launch) holds, before timing:
K8 on the CUDA prelude's outputs against the plain version on the same outputs (f32
``1e-5 max|plain|``, bf16 ``2^-7 |plain| + 1e-3``), replays bit-identical, in f32 and bf16
at the five cases; the CUDA prelude against the torch prelude on the card (q codes and qs
equal, k codes equal in >= 99.99 % and never more than 1 apart, ks and rowc within 1e-6
relative); K4's grouped and single launches against the plain version per product
(f32 ``1e-5 max|plain|``, bf16 ``2^-7 |plain| + 2^-9 max|plain|``), bit-identical replays,
at m 1, 3, 8, 17, 32 and 64, bf16 and f32 x. A failed check exits 1.

Each case prints one JSON line; the last line holds them all, with the card's name and
power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

PEAK_BYTES = 3.35e12
K8_CASES = [  # name, q shape, k shape, causal, scale, q_offset, block_k
    ("encoder", (1, 1500, 20, 64), (1, 1500, 20, 64), False, 1.0, 0, 2048),
    ("encoder_10min", (20, 1500, 20, 64), (20, 1500, 20, 64), False, 1.0, 0, 2048),
    ("lm_prefill", (1, 1024, 28, 128), (1, 1024, 4, 128), True, None, 0, 1024),
    ("lm_prefill_16k", (1, 16384, 28, 128), (1, 16384, 4, 128), True, None, 0, 1024),
    ("ragged", (1, 100, 28, 128), (1, 300, 4, 128), True, None, 200, 1024),
]
K4_SHAPES = {"q": (3584, 3584), "k": (3584, 512), "v": (3584, 512), "o": (3584, 3584),
             "gate": (3584, 18944), "up": (3584, 18944), "down": (18944, 3584)}
FAILED: list = []


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


def emit(rows: list, **row) -> None:
    rows.append(row)
    print(json.dumps(row), flush=True)


def held(name: str, ok: bool, detail: str) -> None:
    print(f"check {'ok  ' if ok else 'FAIL'} {name}: {detail}", flush=True)
    if not ok:
        FAILED.append(name)


def k8_inputs(gen, qs, ks, scale):
    d = qs[-1]
    q_mul = 1.0 / (d ** 0.5 * (scale if scale is not None else d ** -0.5))
    q = torch.randn(qs, generator=gen, device="cuda") * q_mul
    k = torch.randn(ks, generator=gen, device="cuda") + 0.5   # a common-mode part
    v = torch.randn(ks, generator=gen, device="cuda")
    return q, k, v


def k8_check(fa8) -> None:
    gen = torch.Generator(device="cuda").manual_seed(10)
    for name, qs, ks, causal, scale, q_offset, block_k in K8_CASES:
        q32, k32, v32 = k8_inputs(gen, qs, ks, scale)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = q32.to(dtype), k32.to(dtype), v32.to(dtype)
            kw = dict(causal=causal, scale=scale, q_offset=q_offset, block_q=512,
                      block_k=block_k)
            tag = f"K8 {name} {str(dtype).split('.')[-1]}"
            ref_pre = fa8.prelude(q, k, v, **kw)
            pre = fa8.prelude_kernel(q, k, v, **kw)
            kq = (pre.k_i8.int() - ref_pre.k_i8.int()).abs()
            rel = lambda a, b: ((a - b).abs() / b.abs()).max().item()
            held(f"{tag} prelude", torch.equal(pre.q_i8, ref_pre.q_i8)
                 and torch.equal(pre.qs, ref_pre.qs) and kq.max().item() <= 1
                 and (kq == 0).float().mean().item() >= 0.9999
                 and rel(pre.ks, ref_pre.ks) <= 1e-6 and rel(pre.rowc, ref_pre.rowc) <= 1e-6,
                 f"q codes equal {torch.equal(pre.q_i8, ref_pre.q_i8)}, qs equal "
                 f"{torch.equal(pre.qs, ref_pre.qs)}, k codes equal "
                 f"{(kq == 0).float().mean().item():.6f} (max diff {kq.max().item()}), ks rel "
                 f"{rel(pre.ks, ref_pre.ks):.2e}, rowc rel {rel(pre.rowc, ref_pre.rowc):.2e}")
            o = fa8.flash_attention_a8_kernel(pre)
            o2 = fa8.flash_attention_a8_kernel(pre)
            ref = fa8.flash_attention_a8_reference(pre).float()
            diff = (o.float() - ref).abs()
            if dtype == torch.float32:
                ratio = diff.max().item() / (1e-5 * ref.abs().max().item())
            else:
                ratio = (diff / (2.0 ** -7 * ref.abs() + 1e-3)).max().item()
            held(f"{tag} body", ratio <= 1.0 and torch.equal(o, o2)
                 and bool(torch.isfinite(o).all()),
                 f"max|o - plain| {diff.max().item():.3e} at {ratio:.3f} of its limit, replay "
                 f"bit-identical {torch.equal(o, o2)}")
            del ref_pre, pre, o, o2, ref, diff
        del q32, k32, v32
        torch.cuda.empty_cache()


def k8_times(fa8, rows: list, reps: int) -> None:
    gen = torch.Generator(device="cuda").manual_seed(10)
    for name, qs, ks, causal, scale, q_offset, block_k in K8_CASES:
        q, k, v = (t.bfloat16() for t in k8_inputs(gen, qs, ks, scale))
        kw = dict(causal=causal, scale=scale, q_offset=q_offset, block_q=512, block_k=block_k)
        pre = fa8.prelude(q, k, v, **kw)
        big = qs[0] * qs[1] > 10_000
        r = reps // 4 if big else reps
        body = graph_ms(lambda: fa8.flash_attention_a8_kernel(pre), r)
        torch_pre = graph_ms(lambda: fa8.prelude(q, k, v, **kw), r)
        cuda_pre = (graph_ms(lambda: fa8.prelude_kernel(q, k, v, **kw), r)
                    if hasattr(fa8, "prelude_kernel") else None)
        emit(rows, kernel="K8", case=name, q=list(qs), k=list(ks), body_ms=body,
             torch_prelude_ms=torch_pre, cuda_prelude_ms=cuda_pre)
        del q, k, v, pre
        torch.cuda.empty_cache()


def k4_check(k4) -> None:
    gen = torch.Generator(device="cuda").manual_seed(11)
    ws = {n: (torch.randint(-127, 128, (k, n_), generator=gen, device="cuda",
                            dtype=torch.int8),
              torch.rand((n_,), generator=gen, device="cuda") * 0.02 / 127 + 1e-5)
          for n, (k, n_) in K4_SHAPES.items()}
    groups = {"qkv": ("q", "k", "v"), "gateup": ("gate", "up"), "o": ("o",),
              "down": ("down",)}
    for m in (1, 3, 8, 17, 32, 64):
        for xd, od in ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
                       (torch.float32, torch.float32)):
            for gname, names in groups.items():
                x = torch.randn((m, ws[names[0]][0].shape[0]), generator=gen,
                                device="cuda").to(xd)
                prods = [{"w_q": ws[n][0], "scale": ws[n][1]} for n in names]
                ys = k4.w8a16_matmul_group(x, prods, od)
                ys2 = k4.w8a16_matmul_group(x, prods, od)
                singles = [k4.w8a16_matmul(x, p["w_q"], p["scale"], od) for p in prods]
                worst, same = 0.0, True
                for y, y2, y1, p in zip(ys, ys2, singles, prods):
                    ref = k4.w8a16_matmul_reference(x, p["w_q"], p["scale"], od).float()
                    mx = ref.abs().max().item()
                    for got in (y, y1):
                        d = (got.float() - ref).abs()
                        lim = (1e-5 * mx if xd == torch.float32 and od == torch.float32
                               else 2.0 ** -7 * ref.abs() + 2.0 ** -9 * mx)
                        worst = max(worst, (d / lim).max().item())
                    same = same and torch.equal(y, y2)
                held(f"K4 {gname} m={m} {xd}->{od}", worst <= 1.0 and same,
                     f"|y - plain| at {worst:.3f} of its limit, replay bit-identical {same}")


def k4_times(k4, rows: list, reps: int) -> None:
    from audio_flamingo_tpu_torch.ops.quant import mm_f32

    gen = torch.Generator(device="cuda").manual_seed(12)
    layers = 28
    ws = {n: (torch.randint(-127, 128, (layers, k, n_), generator=gen, device="cuda",
                            dtype=torch.int8),
              torch.rand((layers, n_), generator=gen, device="cuda") * 0.02 / 127 + 1e-5)
          for n, (k, n_) in K4_SHAPES.items()}
    head = (torch.randint(-127, 128, (3584, 152064), generator=gen, device="cuda",
                          dtype=torch.int8),
            torch.rand((152064,), generator=gen, device="cuda") * 0.02 / 127 + 1e-5)
    group = getattr(k4, "w8a16_matmul_group", None)
    for m in (1, 8, 32):
        xs = {k: torch.randn((m, k), generator=gen, device="cuda").bfloat16()
              for k in (3584, 18944)}
        for name, (k, n) in K4_SHAPES.items():
            w, s = ws[name]
            x = xs[k]

            def every_layer():
                for i in range(layers):
                    k4.w8a16_matmul(x, w[i], s[i])

            emit(rows, kernel="K4", shape=name, m=m, k=k, n=n,
                 cold_ms=graph_ms(every_layer, reps) / layers,
                 bytes_ms=(k * n + 4 * n) / PEAK_BYTES * 1e3)
        x = xs[3584]
        emit(rows, kernel="K4", shape="head", m=m, k=3584, n=152064,
             cold_ms=graph_ms(lambda: k4.w8a16_matmul(x, head[0], head[1], torch.float32), reps),
             bytes_ms=(3584 * 152064 + 4 * 152064) / PEAK_BYTES * 1e3)
        if group is not None:
            for gname, names in (("q|k|v", ("q", "k", "v")), ("gate|up", ("gate", "up"))):
                def every_layer_group():
                    for i in range(layers):
                        group(x, [{"w_q": ws[n][0][i], "scale": ws[n][1][i]} for n in names])

                nt = sum(K4_SHAPES[n][1] for n in names)
                emit(rows, kernel="K4", shape=gname, m=m, k=3584, n=nt,
                     cold_ms=graph_ms(every_layer_group, reps) / layers,
                     bytes_ms=(3584 * nt + 4 * nt) / PEAK_BYTES * 1e3)

        def step():
            for i in range(layers):
                p = {n: {"w_q": ws[n][0][i], "scale": ws[n][1][i]} for n in K4_SHAPES}
                if group is not None:
                    group(xs[3584], [p["q"], p["k"], p["v"]])
                    k4.w8a16_matmul(xs[3584], p["o"]["w_q"], p["o"]["scale"])
                    group(xs[3584], [p["gate"], p["up"]])
                else:
                    for n in ("q", "k", "v", "o", "gate", "up"):
                        k4.w8a16_matmul(xs[3584], p[n]["w_q"], p[n]["scale"])
                k4.w8a16_matmul(xs[18944], p["down"]["w_q"], p["down"]["scale"])
            k4.w8a16_matmul(xs[3584], head[0], head[1], torch.float32)

        step_bytes = (sum(layers * (k * n + 4 * n) for k, n in K4_SHAPES.values())
                      + 3584 * 152064 + 4 * 152064)
        emit(rows, kernel="K4", shape="step", m=m, step_ms=graph_ms(step, max(3, reps // 4)),
             bytes_ms=step_bytes / PEAK_BYTES * 1e3)
    w, s = ws["up"][0][0], ws["up"][1][0]
    for m in (32, 64, 128, 256, 1024):
        x = torch.randn((m, 3584), generator=gen, device="cuda").bfloat16()
        emit(rows, kernel="K4", shape="up route", m=m,
             kernel_ms=graph_ms(lambda: k4.w8a16_matmul(x, w, s), reps),
             route_ms=graph_ms(lambda: (mm_f32(x, w) * s).to(torch.bfloat16), reps))


def decode_times(rows: list, steps: int = 32, runs: int = 3) -> None:
    """bench.py's bench_decode point on the tree's own code: the 7B int8 LM
    (random_quantized_lm, made on the card) on a bf16 KVCache, batch 1, capacity 1024,
    ``steps`` greedy steps from a zero token, host clock around each synchronized run;
    ms per step (median of ``runs`` after a warm run) and the step's K4 launches."""
    from audio_flamingo_tpu_torch.config import AF3Config
    from audio_flamingo_tpu_torch.models import qwen2
    from audio_flamingo_tpu_torch.ops.kernels import w8a16_matmul as k4
    from audio_flamingo_tpu_torch.ops.quant import random_quantized_lm

    cfg = AF3Config().lm
    lm = qwen2.quantized_lm(random_quantized_lm(torch.Generator(device="cuda").manual_seed(0),
                                                cfg, "cuda"), torch.bfloat16, "cuda")

    def run():
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
        return (time.perf_counter() - t0) / steps * 1e3

    run()
    k4.LAUNCHES.reset()
    times = [run() for _ in range(runs)]
    emit(rows, kernel="decode", ms_per_step=statistics.median(times), runs=times,
         k4_per_step=k4.LAUNCHES.count / (runs * steps))
    del lm
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default="k8,k4,decode")
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from audio_flamingo_tpu_torch.ops.kernels import flash_attention_a8 as fa8
    from audio_flamingo_tpu_torch.ops.kernels import w8a16_matmul as k4

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    only = set(args.only.split(","))
    if args.check:
        if "k8" in only:
            k8_check(fa8)
        if "k4" in only:
            k4_check(k4)
    rows: list = []
    if "k8" in only:
        k8_times(fa8, rows, args.reps)
    if "k4" in only:
        k4_times(k4, rows, args.reps)
    if "decode" in only:
        decode_times(rows)
    print(json.dumps({"tag": args.tag, "root": args.root, "card": card,
                      "torch": torch.__version__, "failed": FAILED, "rows": rows}), flush=True)
    return 1 if FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
