"""Command-line interface of the port: infer / chat / train / demo / bench, as
``audio_flamingo_tpu/cli.py``.

    python -m audio_flamingo_tpu_torch infer --model DIR --audio clip.wav
    python -m audio_flamingo_tpu_torch chat --model DIR      # ':audio <path>' attaches a clip

Without ``--model`` a random tiny AF3 runs (no checkpoint needed). Every command runs on
CUDA unless ``--device`` names another device (``--device cpu``); with no card and no
``--device`` it raises. ``bench`` is not ported yet and says so.
"""

from __future__ import annotations

import argparse
import sys


def _build_model(args):
    import torch

    from audio_flamingo_tpu_torch.api import AudioFlamingo, load, load_draft

    quant = getattr(args, "quantize", "none")
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    if args.model:
        model = load(args.model, compute_dtype=dtype,
                     quantize_lm={"none": False, "int8": "int8", "int4": "int4"}[quant],
                     device=args.device)
    else:
        model = AudioFlamingo.from_random(compute_dtype=dtype, device=args.device)
    if getattr(args, "draft", None):
        # speculative decoding: greedy batch-1 requests ride the draft/verify loop (api
        # docstring); the draft must share the target's tokenizer
        model.draft, model.draft_cfg = load_draft(
            args.draft, compute_dtype=dtype, quantize=quant != "none", device=model.device)
    return model


def cmd_infer(args):
    from audio_flamingo_tpu_torch.audio.io import load_audio
    from audio_flamingo_tpu_torch.ops.sampling import SamplingParams
    from audio_flamingo_tpu_torch.utils.metrics import RequestTimer

    model = _build_model(args)
    wav = load_audio(args.audio, target_sr=16_000) if args.audio else None
    timer = RequestTimer(audio_seconds=len(wav) / 16_000 if wav is not None else 0.0)
    sampling = SamplingParams(greedy=not args.sample, temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p)
    out = model.generate(sound=wav, prompt=args.prompt, max_new_tokens=args.max_new_tokens,
                         sampling=sampling, think=args.think)
    timer.token()
    stats = timer.finish()
    print(out)
    print(f"[{stats['total_s']:.2f}s"
          + (f", RTFx {stats['rtfx']:.0f}" if stats["rtfx"] else "") + "]",
          file=sys.stderr)


def cmd_chat(args):
    from audio_flamingo_tpu_torch.audio.io import load_audio

    model = _build_model(args)
    print("multi-turn chat; ':audio <path>' attaches a clip to the next message; "
          "':reset' clears history; ctrl-d exits", file=sys.stderr)
    pending_audio = None
    while True:
        try:
            line = input("user> ").strip()
        except EOFError:
            return
        if not line:
            continue
        if line == ":reset":
            model.reset_chat()
            pending_audio = None
            continue
        if line.startswith(":audio "):
            pending_audio = load_audio(line.split(" ", 1)[1], target_sr=16_000)
            print(f"[attached {len(pending_audio)/16000:.1f}s of audio]", file=sys.stderr)
            continue
        out = model.generate(sound=pending_audio, prompt=line, chat=True,
                             max_new_tokens=args.max_new_tokens, think=args.think)
        pending_audio = None
        print(f"assistant> {out}")


def cmd_bench(args):
    from audio_flamingo_tpu_torch.config import NOT_PORTED

    raise NotImplementedError(NOT_PORTED.format("the benchmark harness (bench)",
                                                "13, the port's benchmark harness"))


def cmd_train(args):
    import dataclasses

    import torch

    from audio_flamingo_tpu_torch.device import resolve_device
    from audio_flamingo_tpu_torch.models import af3
    from audio_flamingo_tpu_torch.runtime.processor import AUDIO_TOKEN, AF3Processor
    from audio_flamingo_tpu_torch.runtime.tokenizer import BBPETokenizer, train_bpe
    from audio_flamingo_tpu_torch.train.config import load_train_config
    from audio_flamingo_tpu_torch.train.data import BatchBuilder
    from audio_flamingo_tpu_torch.train.loop import run

    device = resolve_device(args.device)
    model_cfg, run_cfg, make_sampler = load_train_config(args.config)
    if args.tokenizer:
        tok = BBPETokenizer.from_pretrained_dir(args.tokenizer)
    else:
        vocab, merges = train_bpe(["describe the audio"], min(400, model_cfg.lm.vocab_size))
        tok = BBPETokenizer(vocab, merges)
    model_cfg = dataclasses.replace(model_cfg, audio_token_id=tok.special_tokens[AUDIO_TOKEN])
    model = af3.build(model_cfg, device, torch.float32)
    af3.init_(model, model_cfg, torch.Generator(device=device).manual_seed(args.seed))
    builder = BatchBuilder(processor=AF3Processor(tokenizer=tok, cfg=model_cfg, device=device))
    state, metrics = run(model_cfg, model, make_sampler(args.seed), builder, run_cfg,
                         device=device)
    print(f"done: step {int(state.step)}, last loss {metrics.latest('loss')}")


def cmd_demo(args):
    from audio_flamingo_tpu_torch.serve.demo import main as demo_main

    argv = ["--host", args.host, "--port", str(args.port)]
    if args.model:
        argv += ["--model", args.model]
    else:
        argv += ["--random-tiny"]
    if args.quantize_lm:
        argv += ["--quantize-lm"]
    if args.device:
        argv += ["--device", args.device]
    demo_main(argv)


def main(argv=None):
    p = argparse.ArgumentParser(prog="audio_flamingo_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_flag(sp):
        sp.add_argument("--device", default=None,
                        help="torch device, e.g. cpu or cuda:1 (default: CUDA; raises "
                             "without a card)")

    def common(sp):
        sp.add_argument("--model", default=None, help="HF-layout checkpoint dir")
        sp.add_argument("--bf16", action="store_true", default=True)
        sp.add_argument("--fp32", dest="bf16", action="store_false")
        sp.add_argument("--max-new-tokens", type=int, default=256)
        sp.add_argument("--think", action="store_true", help="AF-Think reasoning mode")
        sp.add_argument("--draft", default=None,
                        help="Qwen2 draft checkpoint dir (speculative decoding; "
                             "must share the target's tokenizer)")
        sp.add_argument("--quantize", choices=("none", "int8", "int4"),
                        default="none",
                        help="weight-only LM quantization (int8 on the w8a16 kernel; "
                             "int4 = fastest decode, ops/quant4.py)")
        device_flag(sp)

    sp = sub.add_parser("infer", help="one-shot: wav in -> answer out")
    common(sp)
    sp.add_argument("--audio", default=None, help="path to a WAV or FLAC file")
    sp.add_argument("--prompt", default="Describe the audio in detail.")
    sp.add_argument("--sample", action="store_true")
    sp.add_argument("--temperature", type=float, default=0.7)
    sp.add_argument("--top-k", type=int, default=50)
    sp.add_argument("--top-p", type=float, default=0.95)
    sp.set_defaults(fn=cmd_infer)

    sp = sub.add_parser("chat", help="interactive multi-turn chat")
    common(sp)
    sp.set_defaults(fn=cmd_chat)

    sp = sub.add_parser("bench", help="run the benchmark harness (not ported yet)")
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("train", help="train from a YAML config (stage + mixture)")
    sp.add_argument("--config", required=True)
    sp.add_argument("--tokenizer", default=None, help="tokenizer dir (vocab/merges)")
    sp.add_argument("--seed", type=int, default=0)
    device_flag(sp)
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("demo", help="interactive browser demo (audio upload + chat)")
    sp.add_argument("--model", default=None, help="HF-layout checkpoint dir")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=7860)
    sp.add_argument("--quantize-lm", action="store_true")
    device_flag(sp)
    sp.set_defaults(fn=cmd_demo)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
