#!/usr/bin/env python3
"""Device times of the port's paged-attention decode (K3) and of the w8a8 encoder fusions
(K9: enc_ln_qkv, enc_out_ln, enc_mlp) on one GPU, so that two trees can be compared on one
card in one run; with ``--check``, also each kernel held to its plain version first.

    python3 scripts/torch_k3_k9_times.py [--root DIR] [--tag NAME] [--reps N] [--check]
        [--only k3,k9,serving] [--parts P,..] [--clusters C,..] [--profile] [--tiles]

``--root`` names the repository checkout whose ``audio_flamingo_tpu_torch`` is measured
(default: this one), so a parent commit unpacked beside the tree can be timed in the same
call (parent, change, change, parent). Every kernel time is a device time: the calls
captured in a CUDA graph, the replay timed with CUDA events (median of ``--reps`` after 3)
and divided by the calls in it, the host left out.

- K3 at chip_smoke.py phase 8a's inputs: q [4, 4, 7, 128], the stacked pools [28, 88, 128,
  4, 128] at layer 5, tables over shuffled pages; the check rows {548, 3848, 1, 0} and the
  engine's mixed rows {548, 548, 3848, 3848}; q f32 over f32, bf16 and int8 pools, q bf16
  over bf16 and int8 pools; 10 calls a graph; beside each, the byte bound (the live keys'
  K and V, and their int8 scales, at 3.35 TB/s). ``--parts`` adds the mixed rows, q bf16
  over bf16 and int8 pools, at each given count of parts (the tree's ``kernel_parts``
  replaced).
- K9 on one full-width encoder layer in the fused int8 layout (d 1280, ffn 5120, the
  port's quantizer on random float weights) at m = 1500 and 30,000 rows, bf16: each stage
  as the encoder calls it (the K-major weight copies made once, where the tree's wrappers
  take them), beside its bound (int8 ops at 1979 TOPS, or bytes). ``--clusters`` adds
  enc_ln_qkv at each given cluster size (the tree's ``LN_QKV_CLUSTER``; a tree without
  that override is not swept).
- ``serving`` (not in the default ``--only``): the main path K3 serves, at full AF3 width
  (bf16, random weights from seed 0, flash on), as chip_smoke.py phases 4 and 8b drive it:
  the 30 s clip's generate three times (the third run's user TTFT and decode rate), then
  8b's mixed workload on PagedEngine with a bf16 and an int8 pool, each after a warm-up
  instance: one run with nothing timed (tokens/s, median TTFT from submit), and a second
  with every K3 launch timed with CUDA events and its inputs kept (its ids equal to the
  first run's), those launches then replayed in one CUDA graph: K3's device time in the
  serving path beside the events figure, which holds the host's gaps.
- ``--tiles``: K3's eight-head-tile kernels (kT = 8, which take 8 < g <= 64) at the
  decode's g = 7, beside the one-tile kernels (kT = 1) the tree launches there: the kernel
  library is built a second time from a copy of ``csrc/`` (under ``_build/``) whose K3
  dispatch sends every g to kT = 8, held to the plain version at the check rows, and the
  mixed rows timed in all five dtype pairs in the order tree, kT = 8, kT = 8, tree.
- ``--profile``: each CUDA kernel's device time per call from torch.profiler, for K3 at the
  mixed bf16 rows and the K9 stages at m = 30,000.

``--check`` holds, before timing: K3 against its plain version at the check rows, layers 0
and 27, the current token merged (f32 ``1e-5 max|plain|``, bf16 ``2^-7 |plain| + 1e-3`` on
o/l, m and l within 1e-5 relative), rows with no key exactly (0, NEG_INF, 0), two launches
bit-identical, in all five dtype pairs; K9's enc_ln_qkv and enc_out_ln at m = 1500 and
30,000, f32 and bf16, against their plain versions (every output within ``2^-7 |plain| +
2^-6 max|plain|``, 99.9 % within ``2^-7 |plain| + 1e-6 max|plain|``, enc_out_ln's codes
99.9 % equal), replays bit-identical. The limits are chip_smoke.py's (imported from this
script's checkout). A failed check exits 1.

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

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_BYTES = 3.35e12
K3_ROWS = {"check": [548, 3848, 1, 0], "mixed": [548, 548, 3848, 3848]}
K3_PAIRS = ((torch.float32, "float32"), (torch.float32, "bfloat16"), (torch.float32, "int8"),
            (torch.bfloat16, "bfloat16"), (torch.bfloat16, "int8"))
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


# ------------------------------------------------------------------ K3

def k3_inputs():
    """chip_smoke.py 8a's pools, q and current token (seed 8), and a table maker."""
    n_layers, nb, block, nkv, g, hd, mp = 28, 88, 128, 4, 7, 128, 32
    gen = torch.Generator(device="cuda").manual_seed(8)
    perm = (torch.randperm(nb - 1, generator=gen, device="cuda") + 1).int()

    def tables_for(lengths):
        t = torch.full((len(lengths), mp), -1, dtype=torch.int32, device="cuda")
        ptr = 0
        for row, n in enumerate(lengths):
            pages = -(-n // block)
            t[row, :pages] = perm[ptr:ptr + pages]
            ptr += pages
        return t, torch.tensor(lengths, dtype=torch.int32, device="cuda")

    shape = (n_layers, nb, block, nkv, hd)
    kf = torch.randn(shape, generator=gen, device="cuda")
    vf = torch.randn(shape, generator=gen, device="cuda")
    k8 = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
    v8 = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
    ks = torch.rand(shape[:-1], generator=gen, device="cuda") * 0.018 + 0.002
    vs = torch.rand(shape[:-1], generator=gen, device="cuda") * 0.018 + 0.002
    q32 = torch.randn((4, nkv, g, hd), generator=gen, device="cuda")
    k_cur = torch.randn((4, nkv, hd), generator=gen, device="cuda")
    v_cur = torch.randn((4, nkv, hd), generator=gen, device="cuda")

    def pools(kv_name):
        if kv_name == "int8":
            return k8, v8, ks, vs
        dt = getattr(torch, kv_name)
        return kf.to(dt), vf.to(dt), None, None

    return dict(q32=q32, k_cur=k_cur, v_cur=v_cur, pools=pools, tables_for=tables_for,
                block=block, mp=mp, n_layers=n_layers)


def k3_bound_ms(lengths, block: int, kv_dtype, nkv: int = 4, hd: int = 128) -> float:
    """The live keys' K and V rows (and int8 scales) at the HBM rate: the bytes no call can
    avoid (q, the tables and the outputs add under 0.1 %)."""
    keys = sum(int(n) for n in lengths)
    item = torch.empty((), dtype=kv_dtype).element_size()
    nbytes = keys * nkv * hd * item * 2 + (keys * nkv * 8 if kv_dtype == torch.int8 else 0)
    return nbytes / PEAK_BYTES * 1e3


def k3_check(pa, smoke, inp) -> None:
    for q_dtype, kv_name in K3_PAIRS:
        q = inp["q32"].to(q_dtype)
        k, v, ks, vs = inp["pools"](kv_name)
        tables, lengths = inp["tables_for"](K3_ROWS["check"])
        tag = f"K3 q {str(q_dtype).split('.')[-1]} pool {kv_name}"
        for layer in (0, inp["n_layers"] - 1):
            args = (q, k, v, tables, lengths, layer, ks, vs, None)
            try:
                r = smoke.paged_compare(pa, args, inp["k_cur"], inp["v_cur"])
                ok, detail = r["ratio"] <= 1.0, (f"max|o/l - plain| {r['err']:.3e} at "
                                                 f"{r['ratio']:.3f} of its limit")
            except RuntimeError as e:   # a row with no key that is not (0, NEG_INF, 0)
                ok, detail = False, str(e)
            held(f"{tag} layer {layer}", ok, detail)
            a = pa.paged_attention(q, k, v, tables, lengths, layer, k_scale=ks, v_scale=vs)
            b = pa.paged_attention(q, k, v, tables, lengths, layer, k_scale=ks, v_scale=vs)
            held(f"{tag} layer {layer} replay", all(torch.equal(x, y) for x, y in zip(a, b)),
                 "two launches bit-identical")


def k3_times(pa, inp, rows: list, reps: int, parts_list) -> None:
    for q_dtype, kv_name in K3_PAIRS:
        q = inp["q32"].to(q_dtype)
        k, v, ks, vs = inp["pools"](kv_name)
        for name, lens in K3_ROWS.items():
            tables, lengths = inp["tables_for"](lens)
            call = lambda: pa.paged_attention(q, k, v, tables, lengths, 5, k_scale=ks,
                                              v_scale=vs)
            ms = graph_ms(call, reps, 10)
            bound = k3_bound_ms(lens, inp["block"], k.dtype)
            emit(rows, kernel="K3", q=str(q_dtype).split(".")[-1], pool=kv_name, lengths=name,
                 device_ms=ms, bound_ms=bound, share=bound / ms)
    q = inp["q32"].to(torch.bfloat16)
    tables, lengths = inp["tables_for"](K3_ROWS["mixed"])
    real = pa.kernel_parts
    for kv_name in ("bfloat16", "int8") if parts_list else ():
        k, v, ks, vs = inp["pools"](kv_name)
        for parts in parts_list:
            pa.kernel_parts = lambda *a, p=parts: p
            try:
                ms = graph_ms(lambda: pa.paged_attention(q, k, v, tables, lengths, 5,
                                                         k_scale=ks, v_scale=vs), reps, 10)
            finally:
                pa.kernel_parts = real
            emit(rows, kernel="K3", q="bfloat16", pool=kv_name, lengths="mixed", parts=parts,
                 device_ms=ms)


def tiles8_library() -> str:
    """The kernel library built from a copy of csrc/ in which K3 takes its eight-head-tile
    kernels at every g (the g <= 8 branches of launch_rows and occupancy_rows never
    taken); returns its path."""
    import glob

    from audio_flamingo_tpu_torch.ops.kernels import _build

    src = os.path.join(_build.BUILD_DIR, "tiles8_src")
    os.makedirs(src, exist_ok=True)
    cases = (("  if (g <= kTile)\n    return launch<", "  if (false)\n    return launch<"),
             ("return g <= kTile ? attend_occupancy", "return false ? attend_occupancy"))
    for path in glob.glob(os.path.join(_build.CSRC, "*.cu")) + glob.glob(
            os.path.join(_build.CSRC, "*.cuh")):
        with open(path) as f:
            text = f.read()
        if os.path.basename(path) == "paged_attention.cu":
            for old, new in cases:
                if text.count(old) != 1:
                    raise RuntimeError(f"paged_attention.cu: the dispatch {old!r} not found once")
                text = text.replace(old, new)
        with open(os.path.join(src, os.path.basename(path)), "w") as f:
            f.write(text)
    out, _, _ = _build.compile_library(_build.find_nvcc(), _build.NVCC_FLAGS,
                                       sorted(glob.glob(os.path.join(src, "*.cu"))),
                                       "libaf_tiles8")
    return out


def k3_tiles(pa, smoke, inp, rows: list, reps: int) -> None:
    """kT = 8 against kT = 1 at g = 7 (``--tiles``)."""
    from audio_flamingo_tpu_torch.ops.kernels import _build

    tree_lib = _build.load_library()
    tiles_path = tiles8_library()

    def use(lib_path):
        if lib_path is None:
            _build._lib = tree_lib
        else:
            _build.load_library(lib_path)
        pa._attend_blocks_per_sm.cache_clear()

    try:
        use(tiles_path)
        for q_dtype, kv_name in K3_PAIRS:
            q = inp["q32"].to(q_dtype)
            k, v, ks, vs = inp["pools"](kv_name)
            tables, lengths = inp["tables_for"](K3_ROWS["check"])
            tag = f"K3 kT=8 at g=7 q {str(q_dtype).split('.')[-1]} pool {kv_name}"
            r = smoke.paged_compare(pa, (q, k, v, tables, lengths, 0, ks, vs, None),
                                    inp["k_cur"], inp["v_cur"])
            held(tag, r["ratio"] <= 1.0, f"max|o/l - plain| {r['err']:.3e} at "
                                         f"{r['ratio']:.3f} of its limit")
        for q_dtype, kv_name in K3_PAIRS:
            q = inp["q32"].to(q_dtype)
            k, v, ks, vs = inp["pools"](kv_name)
            tables, lengths = inp["tables_for"](K3_ROWS["mixed"])
            call = lambda: pa.paged_attention(q, k, v, tables, lengths, 5, k_scale=ks,
                                              v_scale=vs)
            ms = {}
            for i, (name, lib_path) in enumerate((("kT1", None), ("kT8", tiles_path),
                                                  ("kT8", tiles_path), ("kT1", None))):
                use(lib_path)
                ms.setdefault(name, []).append(graph_ms(call, reps, 10))
            emit(rows, kernel="K3 tiles", q=str(q_dtype).split(".")[-1], pool=kv_name,
                 lengths="mixed", g=7, kT1_ms=ms["kT1"], kT8_ms=ms["kT8"],
                 bound_ms=k3_bound_ms(K3_ROWS["mixed"], inp["block"], k.dtype),
                 kT8_over_kT1=statistics.mean(ms["kT8"]) / statistics.mean(ms["kT1"]))
    finally:
        use(None)


# ------------------------------------------------------------------ K9

def k9_tree(d: int = 1280, f: int = 5120):
    """chip_smoke.py 10b's layer: one full-width layer in the fused int8 layout (seed 11)."""
    from audio_flamingo_tpu_torch.ops.quant import quantize_encoder_params_fused

    gen = torch.Generator(device="cuda").manual_seed(11)

    def lin(n_in, n_out, bias=True):
        w = (torch.rand((n_out, n_in), generator=gen, device="cuda") * 2 - 1) * n_in ** -0.5
        out = {"weight": w}
        if bias:
            out["bias"] = 0.02 * torch.randn(n_out, generator=gen, device="cuda")
        return out

    state = {}
    for name, (a, b, bias) in {"q_proj": (d, d, True), "k_proj": (d, d, False),
                               "v_proj": (d, d, True), "out_proj": (d, d, True),
                               "fc1": (d, f, True), "fc2": (f, d, True)}.items():
        state.update({f"layers.0.{name}.{k}": v for k, v in lin(a, b, bias).items()})
    for norm in ("self_attn_layer_norm", "final_layer_norm"):
        state[f"layers.0.{norm}.weight"] = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        state[f"layers.0.{norm}.bias"] = 0.1 * torch.randn(d, generator=gen, device="cuda")
    return quantize_encoder_params_fused(state, head_dim=64)


def k9_bound_ms(kind: str, m: int, d: int, n: int, x_bytes: int) -> float:
    """chip_smoke.py's k9_bound_ms: max(int8 ops at 1979 TOPS, bytes at 3.35 TB/s)."""
    if kind == "enc_ln_qkv":
        ops = 2.0 * m * d * n
        nbytes = m * d * x_bytes + d * n + m * n * x_bytes + 4 * (2 * d + 2 * n)
    elif kind == "enc_out_ln":
        ops = 2.0 * m * d * d
        nbytes = 2 * m * d * x_bytes + d * d + m * d * (x_bytes + 1) + 4 * m + 16 * d
    else:
        ops = 4.0 * m * d * n
        nbytes = m * d + 4 * m + 2 * d * n + 2 * m * d * x_bytes + 8 * (n + d)
    return max(ops / 1979e12, nbytes / PEAK_BYTES) * 1e3


def k9_calls(ef, tree, m: int, dtype, gen):
    """The three stages' calls on one layer at m rows, as the encoder makes them: the
    K-major copies made once and handed to every wrapper that takes them."""
    from audio_flamingo_tpu_torch.models.qwen2 import TensorTree, cast_quantized

    lp = TensorTree(cast_quantized(tree, dtype, "cuda"))
    d = lp["ln1_w"].shape[-1]
    x = torch.randn((m, d), generator=gen, device="cuda").to(dtype)
    attn = (0.5 * torch.randn((m, d), generator=gen, device="cuda")).to(dtype)
    qkv, o, f1, f2 = (lp[n] for n in ("qkv", "o", "fc1", "fc2"))
    args = {
        "enc_ln_qkv": (x, lp["ln1_w"][0], lp["ln1_b"][0], qkv["w_q"][0], qkv["scale"][0],
                       qkv["b"][0]),
        "enc_out_ln": (attn, x, o["w_q"][0], o["scale"][0], o["b"][0], lp["ln2_w"][0],
                       lp["ln2_b"][0]),
    }
    x2, hq, hs = ef.enc_out_ln_reference(*args["enc_out_ln"])
    args["enc_mlp"] = (hq, hs, f1["w_q"][0], f1["scale"][0], f1["b"][0], f2["w_q"][0],
                       f2["scale"][0], f2["b"][0], x2)
    kw = {"enc_mlp": {"kmajor": ef.mlp_kmajor(f1["w_q"][0], f2["w_q"][0])}}
    for name, w in (("enc_ln_qkv", qkv["w_q"][0]), ("enc_out_ln", o["w_q"][0])):
        takes = "w_t" in inspect.signature(getattr(ef, name)).parameters
        kw[name] = {"w_t": w.transpose(0, 1).contiguous()} if takes else {}
    return {name: (lambda n=name: getattr(ef, n)(*args[n], **kw[n])) for name in args}, args


def k9_check(ef, smoke, tree) -> None:
    gen = torch.Generator(device="cuda").manual_seed(12)
    for m, dtype in ((1500, torch.bfloat16), (30_000, torch.bfloat16), (1500, torch.float32),
                     (30_000, torch.float32)):
        calls, args = k9_calls(ef, tree, m, dtype, gen)
        dn = str(dtype).split(".")[-1]
        for name in ("enc_ln_qkv", "enc_out_ln"):
            y, y2 = calls[name](), calls[name]()
            ref = getattr(ef, name + "_reference")(*args[name])
            if name == "enc_out_ln":
                r = smoke.k9_compare(y[0], ref[0])
                codes = (y[1] == ref[1]).float().mean().item()
                scale_rel = ((y[2] - ref[2]).abs() / ref[2]).max().item()
                replay = all(torch.equal(a, b) for a, b in zip(y, y2))
                extra = f", codes equal {codes:.6f}, scales rel {scale_rel:.2e}"
                ok_codes = codes >= smoke.K9_SHARE
            else:
                r = smoke.k9_compare(y, ref)
                replay, extra, ok_codes = torch.equal(y, y2), "", True
            ok = (r["finite"] and r["near"] >= smoke.K9_SHARE and r["ratio"] <= 1.0
                  and ok_codes)
            held(f"K9 {name} m={m} {dn}", ok,
                 f"max|y - plain| {r['err']:.3e} at {r['ratio']:.3f} of its limit, "
                 f"{r['near']:.6f} within one step{extra}")
            held(f"K9 {name} m={m} {dn} replay", replay, "two launches bit-identical")
        del calls, args
        torch.cuda.empty_cache()


def k9_times(ef, tree, rows: list, reps: int, clusters) -> None:
    gen = torch.Generator(device="cuda").manual_seed(12)
    for m in (1500, 30_000):
        calls, _ = k9_calls(ef, tree, m, torch.bfloat16, gen)
        n_calls = 10 if m <= 1500 else 2
        for name in ("enc_ln_qkv", "enc_out_ln", "enc_mlp"):
            ms = graph_ms(calls[name], reps, n_calls)
            n = {"enc_ln_qkv": 3840, "enc_out_ln": 1280, "enc_mlp": 5120}[name]
            bound = k9_bound_ms(name, m, 1280, n, 2)
            emit(rows, kernel="K9", stage=name, m=m, dtype="bfloat16", device_ms=ms,
                 bound_ms=bound, share=bound / ms)
        for c in clusters if hasattr(ef, "LN_QKV_CLUSTER") else ():
            ef.LN_QKV_CLUSTER = c
            try:
                ms = graph_ms(calls["enc_ln_qkv"], reps, n_calls)
            finally:
                ef.LN_QKV_CLUSTER = 0
            emit(rows, kernel="K9", stage="enc_ln_qkv", m=m, dtype="bfloat16", cluster=c,
                 device_ms=ms)
        del calls
        torch.cuda.empty_cache()


# ------------------------------------------------------------------ serving

def serving(pa, smoke, rows: list) -> None:
    from audio_flamingo_tpu_torch.api import AudioFlamingo
    from audio_flamingo_tpu_torch.config import AF3Config
    from audio_flamingo_tpu_torch.runtime.paged_engine import PagedEngine

    model = AudioFlamingo.from_random(smoke.with_flash(AF3Config(), True), seed=0,
                                      compute_dtype=torch.bfloat16, device="cuda")
    rng = np.random.default_rng(0)
    t = np.arange(30 * 16000) / 16000.0
    wav = (0.3 * np.sin(2 * np.pi * 440.0 * t)
           + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    for _ in range(3):
        smoke.timed_generate(model, sound=wav, prompt="What do you hear?", max_new_tokens=16)
    out = model.last_output
    emit(rows, kernel="generate", clip_s=30,
         user_ttft_ms=(model.last_processor_s + out.ttft_s) * 1e3,
         decode_tok_s=out.decode_steps / out.decode_s)
    specs = smoke.mixed_workload(model, wav)
    n_layers = model.cfg.lm.num_layers
    for kv_dtype, pool in ((torch.bfloat16, "bfloat16"), (torch.int8, "int8")):
        make = lambda: PagedEngine(model=model.model, cfg=model.cfg, kv_dtype=kv_dtype,
                                   **smoke.ENGINE)
        smoke.serve(make(), specs[:2], 48)                     # warm-up instance
        eng = make()
        results, wall = smoke.serve(eng, specs, 48)
        tokens = sum(len(v) for v in results.values())
        ttft = statistics.median(m["ttft_s"] for m in eng.request_metrics.values())
        pa.LAUNCHES.reset()
        pa.LAUNCHES.timing = pa.LAUNCHES.capture = True
        again, wall2 = smoke.serve(make(), specs, 48)
        pa.LAUNCHES.timing = pa.LAUNCHES.capture = False
        launches, events_ms = pa.LAUNCHES.count, pa.LAUNCHES.device_ms()
        kept = list(pa.LAUNCHES.inputs)
        pa.LAUNCHES.reset()
        held(f"serving {pool} pool", again == results and launches == len(kept) > 0
             and launches % n_layers == 0,
             f"the timed run's ids equal the first run's; {launches} K3 launches")
        graph = smoke.launches_graph_ms(pa, kept)
        pa.LAUNCHES.reset()
        emit(rows, kernel="serving", pool=pool, tokens=tokens, wall_s=wall,
             tok_s=tokens / wall, ttft_median_s=ttft, timed_run_s=wall2, k3_launches=launches,
             steps=launches // n_layers, k3_events_ms=events_ms, k3_graph_ms=graph)
        del eng, kept
        torch.cuda.empty_cache()


def profile(pa, ef, rows: list, calls: int = 20) -> None:
    """Each kernel's device time per call from torch.profiler (CUPTI), for K3 at the mixed
    bf16 rows and the K9 stages at m = 30,000 bf16: where a call's time goes."""
    from torch.profiler import ProfilerActivity, profile as prof

    inp = k3_inputs()
    q = inp["q32"].to(torch.bfloat16)
    k, v, _, _ = inp["pools"]("bfloat16")
    tables, lengths = inp["tables_for"](K3_ROWS["mixed"])
    gen = torch.Generator(device="cuda").manual_seed(12)
    k9, _ = k9_calls(ef, k9_tree(), 30_000, torch.bfloat16, gen)
    cases = {"K3 mixed bf16": lambda: pa.paged_attention(q, k, v, tables, lengths, 5),
             **{f"K9 {n} m=30000": f for n, f in k9.items()}}
    for name, fn in cases.items():
        fn()
        torch.cuda.synchronize()
        with prof(activities=[ProfilerActivity.CUDA]) as p:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = {}
        for evt in p.key_averages():
            t = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)
            if t:
                kernels[evt.key[:60]] = t / 1e3 / calls
        emit(rows, kernel="profile", case=name, ms_per_call=kernels)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default="k3,k9")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--parts", default="")
    ap.add_argument("--clusters", default="")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--tiles", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)              # chip_smoke.py's limits, from this checkout
    import chip_smoke as smoke
    sys.path.insert(0, os.path.abspath(args.root))
    from audio_flamingo_tpu_torch.ops.kernels import enc_fused as ef
    from audio_flamingo_tpu_torch.ops.kernels import paged_attention as pa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    only = set(args.only.split(","))
    ints = lambda s: [int(v) for v in s.split(",") if v]
    rows: list = []
    if "k3" in only:
        inp = k3_inputs()
        if args.check:
            k3_check(pa, smoke, inp)
        k3_times(pa, inp, rows, args.reps, ints(args.parts))
        if args.tiles:
            k3_tiles(pa, smoke, inp, rows, args.reps)
        del inp
        torch.cuda.empty_cache()
    if "k9" in only:
        tree = k9_tree()
        if args.check:
            k9_check(ef, smoke, tree)
        k9_times(ef, tree, rows, args.reps, ints(args.clusters))
        del tree
        torch.cuda.empty_cache()
    if "serving" in only:
        serving(pa, smoke, rows)
    if args.profile:
        profile(pa, ef, rows)
    print(json.dumps({"tag": args.tag, "root": args.root, "card": card,
                      "torch": torch.__version__, "failed": FAILED, "rows": rows}), flush=True)
    return 1 if FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
