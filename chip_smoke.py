#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (audio_flamingo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root; needs one CUDA card, nvcc and g++

Phases, each line stamped with elapsed seconds:
  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: every csrc/*.cu by its own nvcc process, all at once, then one link (seconds;
     ptxas's registers, spilled bytes and static shared memory of every kernel, the bf16
     flash kernels, the w4a16 and enc_mlp routes' kernels, the persistent w4 suffix
     kernel and the 3xTF32 log-mel required);
  3. kernels against their plain PyTorch versions, with their time (CUDA events, median),
     the plain version's time, one PyTorch library call's time as a yardstick where one
     computes the same function, and the bound:
     a. flash attention (K2) at the 30 s main path's shapes, f32 (CUDA cores) and bf16
        (tensor cores), scores drawn broad (std 1) and peaked (std 3-4), and at shapes
        either route must take: D = 64 causal with a q_offset, D = 128 non-causal with
        Tk != Tq, a negative q_offset (rows with no key: o = 0, lse = -inf); two launches
        on the same inputs bit-identical; before each bf16 case's output, the two facts
        its tolerance rests on: the plain version's f32 scores equal the sequential fmaf
        sum K2 recomputes some scores by, and K2's tensor-core scores lie within its
        err_bound of them;
     b. the fused log-mel (K1, 3xTF32 on the tensor cores) at [1, 480000] and [20, 480000],
        on a tone plus noise and on normal x 0.1, two launches bit-identical; its device
        time (CUDA graph) beside the parent's figure (PERF.md) and both bounds (f32 on the
        CUDA cores, 3xTF32 on the tensor cores);
     c. K2 at the 10-minute path's shapes, [20,1500,20,64] and causal [1,16384,28,128],
        f32 and bf16, the plain version evaluated over blocks of query rows;
  4. the 30 s main path: AudioFlamingo.from_random at full AF3 width (Whisper-large
     encoder + Qwen2.5-7B, bf16, random weights from a seed) and generate() on a 30 s
     waveform, three times, greedy (decode, here and in every generate below, replays the
     step runtime/generate captures in a CUDA graph on its first call with a key; the
     held steps' bytes are logged after phase 5 and released between phases); launch
     counts per generate, identical ids, finite
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
     from a seed and moved to the card (one model, made once, f32_base, is the CPU side of
     6, 7c, 8e, 9c, 10e, 12d and 13d); af3.logits within 1e-4 and greedy ids
     token-exact (and not all one token), with flash and the log-mel kernel on the card;
  7. the int4 LM (load(quantize_lm="int4")'s quantize_lm_params_w4), run after phase 5:
     a. the w4a16 matmul (K5) and the fused decode suffixes (K6) against their plain
        versions at the 7B shapes in f32 and bf16, on the quantized LM's own codes: K5 at
        m 1, 8, 256 for qkv, o, gate|up and down at layers 0 and 27 and at the int4 head's
        shape; K6 A and B at m 1, 3 and 8, two launches bit-identical, the kernels one
        call launches counted by torch.profiler (one per suffix); timed beside the plain
        version, the int4pack library call (K5), the bound and (K6) the parent's figure
        from PERF.md, with the wrapper and as device times (CUDA graphs: K5 and the
        library call repeated on layer 0, K5 on every layer in turn, K6 repeated and one
        decode step's 28 A + 28 B);
     b. the 30 s path with phase 4's bf16 model's LM quantized on the card (encoder
        shared): generate() three times, greedy, 32 tokens, the first capturing the decode
        step and the others reusing it; identical ids, 56 K6 launches, 1 K5 and 1 K4 (the
        int8 head) per decode step as the replays count them (no K5 in the 1024-row
        prefill, one K4 for its head), K2 still 60, TTFT split, decode rate against the
        weight-streaming bound, the capture time and held bytes, the int8 head's per-step
        cost; then the captured step against the eager step function (the module's
        decode_step loop) on the same prompt, 31 steps: ids equal, the first 4 steps' f32
        logits bit-identical, one replay's kernels by torch.profiler (1 K5 + 28 + 28 K6 +
        1 K4) equal to the eager step's launches, one replay and one eager step under
        torch.cuda.set_sync_debug_mode("error"), ms per step of both beside the bound, a
        trace of 2 replays (utils/profiling.trace, chip_smoke_traces/) with its
        device-busy share; the kernels' device time in the warm run (the prefill's by CUDA
        events, the decode's as its steps times the profiled replay's), and every K5 and
        K6 launch of the eager steps replayed against (and timed beside) the plain
        versions;
     c. (after phase 6) f32 int4 card against CPU: full width, 2 + 2 layers, the int4 LM
        quantized on the CPU and moved to the card (and quantized on the card as well:
        every code and scale equal); logits within 1e-4, greedy ids token-exact and not
        all one token, through K2, K5 and K6;
  8. the paged serving engine (runtime/paged_engine.PagedEngine), run after phase 7b on
     the same bf16 model:
     a. paged-attention decode (K3) against its plain version at the 7B shapes (q
        [4,4,7,128], stacked pools [28,88,128,4,128], tables shuffled over the pool, rows
        of 548, 3848, 1 and 0 tokens, a current token merged), q f32 over f32, bf16 and
        int8 pools and q bf16 over bf16 and int8 pools, timed with its plain version and
        bound at those rows and at the engine's mixed rows, with the wrapper and as device
        time (10 calls in a CUDA graph, replayed) beside the bound;
     b. bench.py's mixed workload (3 x 500 and 3 x 3800 random ids, 32 greedy tokens
        each, plus a 30 s clip through the processor) on PagedEngine with its settings (4
        rows, 88 x 128-token pages, 32 pages per row, chunks of 16), with a bf16 and an
        int8 pool, each after a warm-up instance (16 tokens a request): every request
        finishes, the pool comes back, 28 K3 launches per decode step and no other
        attention inside decode, tok/s, TTFT, K3 ms per step, pool bytes and peak memory; a
        second run gives the same ids, holds the first chunk's K3 launches to the plain
        version (all of a step's launches in one plain call) and replays them in one CUDA
        graph, runs one chunk under torch.cuda.set_sync_debug_mode("error") and bounds
        each chunk's temporaries; a third (bf16 pool, 8 tokens a request) keeps every K3
        launch's inputs: their
        plain time and bounds summed, and all of them replayed in one CUDA graph (K3's device time in the serving path, beside
        the CUDA-events figure, which includes the host's gaps);
     c. prefix caching: two requests with one system prompt and clip; the second hits the
        shared pages and skips the encoder; both TTFTs;
     d. the int4 LM (quantized on the card as in 7b) with an int8 pool, 2 requests, twice:
        per decode step 28 K3, 1 K5, 28 + 28 K6 and 1 K4 launches, identical ids;
     e. (after 7c) f32 card against CPU, full width, 2 + 2 layers: three requests through
        PagedEngine on both with f32 and int8 pools; ids token-exact and not all one
        token, first-token logits within 1e-4, and on the card the ids of generate();
        quantize_kv's codes equal card vs CPU.
  9. training (after every earlier phase's model is freed):
     a. the flash-attention backward (K7) against its plain version at AF3 stage 2's
        shapes ([4,1500,20,64] non-causal at scale 1, [4,1024,28,128] causal over 4 KV
        heads), an unaligned causal case with a q_offset, a case with an LSE cotangent
        and a negative q_offset (zero, finite gradients for rows with no key), f32 and
        bf16; two launches on the same inputs bit-identical; timed beside the plain
        version, SDPA's backward and the bound;
     b. AF3 stage 2 at full width through train/loop.run: bf16 encoder and adaptor hot,
        the 7B LM frozen in int8 (quantize_lm_params on the card), remat="full" and flash
        on both towers, ce_chunk 256, batch 4 of one 30 s clip and ~64 answer tokens
        from BatchBuilder (bucket 1024), warmup 1, 3 steps, twice from the same weights:
        finite losses, per-step losses of the two runs within 1e-3, the frozen LM
        bit-identical, the hot weights moved, 60 K7 and 120 K2 launches per step; ms per
        step, tokens/s, audio-s/s, K7's and K2's device time per step beside their
        bounds, peak memory; one more step's 60 K7 and 120 K2 launches replayed against
        their plain versions (and the int8 product's bf16 backward against f32);
     c. f32 card against CPU, full width, 2 + 2 layers, batch 1: one stage-2 train step
        (loss, grad norm, every hot gradient, the step's change) within 1e-4, through
        K2 and K7 on the card.
 10. the w8a8 TTFT path (load(quantize_lm=True, a8_prefill=True, a8_encoder=True) with
     a8_attention, and the fused encoder layout), after every earlier model is freed:
     a. the int8-QK flash attention (K8) against its plain version from the same CUDA
        prelude outputs at the encoder's shapes ([1,1500,20,64], [20,1500,20,64],
        non-causal, block_k 2048) and the LM's ([1,1024,28,128], [1,16384,28,128] causal,
        and an unaligned block with a q_offset), f32 and bf16, replays bit-identical; the
        CUDA prelude against the torch prelude on the card (q codes and qs equal, k codes
        >= 99.99 % equal and at most 1 apart, ks and rowc within 1e-6 relative); timed
        beside both preludes, the plain version, SDPA on the float inputs (a yardstick)
        and the bounds;
     b. the three encoder fusions (K9) against their plain versions at m = 1500 and 30,000
        rows, bf16 and f32, on one full-width layer: codes >= 99.9 % equal, every output
        within its bound, replays bit-identical; timed beside the composed torch form of
        the same stage (fused_stages=()), the plain version and the bound; each kernel
        (reading the K-major copies the encoder holds) also as device time (10 calls, 2 at
        m = 30,000, in a CUDA graph), and enc_mlp's composed form;
     c. the 30 s clip at full width with the LM quantized on the card to int8 and the
        encoder by quantize_encoder_params, a8_prefill and a8_attention on both towers:
        generate() three times, 60 K8 launches (and 60 CUDA preludes) each, identical
        ids, the prefill logits within JAX's a8 band of the w8a16 model's, every K8
        launch replayed against the plain version and every prelude held to the torch
        prelude; user TTFT beside phases 4 and 7;
     d. the 10-minute file on the fused layout (fused_stages all three, K2 attention) with
        the a8 prefill and K8 at 16,384 tokens, twice: 96 K9 and 28 K8 (and prelude) per
        generate, identical ids; user TTFT beside phase 5's, kernel times beside bounds;
        then twice with fused_stages ("qkv", "out") (the MLP composed): its warm TTFT;
     e. f32 card against CPU, full width, 2 + 2 layers, plain and fused encoder layouts:
        the weight codes equal, the prefill logits within JAX's a8 band, the ids logged.
 11. the int8 LM's decode (load(quantize_lm=True)), after phase 10's models are freed:
     a. the w8a16 matmul (K4) against its plain version on the 7B int8 LM's codes
        (random_quantized_lm, made on the card): q, k, v, o, gate, up, down at layers 0
        and 27 (read in place from the stacks), the grouped launches q|k|v and gate|up
        (each product against its own plain version) and the head at m 1, 8, 32, bf16 x
        to bf16 and to f32 and f32 x to f32, the tied layout (the embedding through its
        transposed view), replays bit-identical; timed beside the plain version, the
        library route (the per-call bf16 copy into cuBLAS), torch._weight_int8pack_mm
        and the bound; the LM's launches with the codes streaming and one decode step's
        113 launches in one graph (device times); K4 against the library route at m
        32-1024 (KERNEL_MAX_ROWS);
     b. bench.py's bench_decode: that LM on a bf16 KVCache, batch 1, capacity 1024, 64
        greedy steps, as the module's step function captured in a CUDA graph against the
        same step run eagerly (timed_decode / decode_loop_run: ids equal, the first 4
        steps' logits bit-identical, 113 K4 launches per step counted eagerly, by the
        replays and by torch.profiler in one replay, sync debug on one replay and one
        eager step); ms per step of the graph (median of 2 runs) and eager side by side,
        K4's device time (profiled replay) and the device-busy share beside the
        weight-streaming bound; the same LM sampled, top-p 0.9 at temperature 0.7, 16
        tokens: graph (its generator registered with the graph) and eager draw the same
        ids from one seed;
     c. bench_decode_matrix's b8 c8192 on the dense int8 cache (init_cache_q8, 32 steps),
        and bench_decode_w4's b1 c1024 on it with the fused int4 LM (per step 1 K5, 28 +
        28 K6 and 1 K4, the int8 head), each graph against eager as in b;
     d. the 30 s clip on the int8 LM (the bf16 model's LM quantized on the card): generate()
        twice, 32 greedy tokens, the first capturing the step, identical ids, 113 K4
        launches per decode step plus the prefill's head (and its products where its rows
        are at most KERNEL_MAX_ROWS); generate(stream=True), one replay a token, gives
        generate's ids, and generate reuses the stream's captured step; the captured step
        against the eager one on that prompt as in 7b (113 K4 in one replay); the
        prefill's and one eager step's K4 launches replayed against the plain version;
        generate sampled (top-p 0.9, temperature 0.7, 16 tokens) twice from one seed gives
        one answer;
     e. f32 card against CPU, full width, 2 LM layers: the int8 LM prefills through flash
        into a Q8KVCache and decodes 8 greedy steps; logits within 1e-4 of max|logit|,
        ids token-exact; quantize_kv's codes and the int4 group scales equal card vs CPU
        (checked in 7c and 8e as well).
 12. beam search, the slot engine and the beam lane (runtime/beam.py, runtime/engine.py,
     runtime/beam_lane.py), after every earlier model is freed:
     a. a new bf16 AF3 at full width (seed 0) on the 30 s clip: api.generate(num_beams=4,
        32 new tokens) twice (32 + 28 K2 launches each, one answer) and generate_beam with
        every beam (its best beam decodes to the answer, scores finite and best first);
        the captured beam step (the held graph both used) against the eager step from one
        prefill, 32 steps: every state tensor and the cache bit-identical, two replays after
        the search ended change none of them; ms per step of
        both beside the bound (LM weights + the gather's read and write of the K-row cache
        + the filled K/V), one replay and one eager step under set_sync_debug_mode("error"),
        two replays under torch.profiler (the top-k's, gather's and copies' share), the
        held graph's bytes;
     b. the beam lane on PagedEngine (8b's settings, lane chunk 8) beside two requests of
        500 random ids: the lane equals generate_beam on the same bucket-padded prompt bit
        for bit, the normal ids equal a run without the lane;
     c. bench.py's mixed workload without the clip (3 x 500 + 3 x 3800 ids, 32 greedy
        tokens) on BatchEngine (4 slots of 4096, chunk 16) and on PagedEngine, each after a
        warm-up instance: tok/s, TTFT, 28 K2 launches per prefill, requests with equal ids;
     d. f32 card against CPU, full width, 2 + 2 layers: the beam (K 4, every beam, ids
        exact, scores within 1e-4), BatchEngine (and each request against generate() on the
        card), ragged generate (and each row against the row alone); the int4 LM on
        BatchEngine at 4 rows in f32 (card vs CPU) and bf16, every K5, K6 and K4 launch
        (m = 4) re-run against its plain version, K6 timed at m = 4 in bf16; the int8 LM's
        beam at K = 4 in f32 (card vs CPU), two eager steps' K4 launches (m = 4) in f32 and
        bf16 against the plain version, each bf16 launch shape timed.
 13. speculative decoding (runtime/speculative.py, the engines' draft path, the paged
     verify), after every earlier model is freed:
     a. K3 at the verify's folded groups (g' = (k + 1) g: 35 at k = 4 on the 7B, and the
        kernel's limit 64) against its plain version on 8a's pools: rows of {548, 3848, 1,
        0} at layers 0 and 27 with a 5-token block merged by merge_block_tokens, bf16 q over
        bf16 and int8 pools and f32 over f32, two launches bit-identical; the device time
        (10 calls in a graph) at 8a's mixed rows beside the bound (and the bound with the
        scores scratch written and read) and beside five g = 7 calls on the same rows (the
        same verify as decode calls); 8a's g = 7 shapes re-timed beside 8a's figures;
     b. dense speculation on the 30 s clip at full width: a new bf16 7B (seed 0) as its own
        draft, k = 4, 32 tokens, api.generate with the draft twice (the round captured once
        and replayed, one answer, 32 + 2 x 28 K2 launches: the encoder, both prefills), the measured
        acceptance, ms a round replayed and eager, tok/s beside plain generate, how many
        ids agree with plain greedy (bf16: the 5-token verify and the 1-token step round
        differently), every emitted token the argmax of the verify at its position (an
        instrumented eager run), sampled (temperature 0.7, top-p 0.9) twice from one seed;
     c. bench.py's bench_spec_engine cut to fit (the 7B int8 target at full width and 14 of
        its 28 layers, SPEC_TARGET_LAYERS, and a 0.5B int8 draft from random_quantized_lm,
        8 requests of 500 random ids, SPEC_MAX_NEW tokens):
        BatchEngine (8 slots of 1024, k 4, 6 rounds) plain and at spec_accept_sim 0.6 and
        1.0, tok/s; PagedEngine with the draft at a = 1.0 on a bf16 and an int8 pool: tok/s,
        every K3 launch a verify at g' = 35 (6 x 28 a chunk), one chunk's launches re-run
        against the plain version, timed in the path and in one graph beside the bound;
        one BatchEngine round's K4 launches (the draft at m = 8, the verify at m = 40)
        re-run against the plain version, each shape timed alone (device, one call in a
        CUDA graph) beside its bound, plain version and torch._weight_int8pack_mm;
     d. f32 card against CPU, full width, 2 + 2 layers with a random 2-layer draft at the
        0.5B's widths (vocab 151,936: clamp and pad): generate_speculative, BatchEngine and
        PagedEngine (bf16 and int8 pools) token-exact card vs CPU and equal to the plain
        paths on the card.
 14. voice out (models/tts.py, audio/neural_vocoder.py, audio/vocoder.py, audio/rvq.py,
     runtime/voice.py), on 13b's bf16 7B before it is freed; no kernel of its own (the
     convs, DFT and TTS products are plain torch, as JAX's are plain XLA):
     a. the shipped trained vocoder on the card (default_vocoder(), f32): its weights equal
        the CPU load bit for bit; evaluate and envelope_correlation(num_speakers=16) within
        the JAX test's bands of vocoder_eval.json and above its floors; apply on 64
        held-out frames card vs CPU (the legacy layout, the same generator without the
        source, within 1e-5; the harmonic layout within a bound derived from the F0 head's
        card-vs-CPU difference and the generator's measured sensitivity to the source's
        phase), two launches bit-identical; stream_synthesize against apply in the JAX
        tests' setups and bands, and the trained vocoder's stream in the mel domain (its
        samples depart from the full pass: the window's edge F0 enters the phase, as in
        JAX);
     b. the voice path at full width: generate(stream=True, 64 tokens) on the 30 s clip into
        speak_stream, a StreamingTTSSession with TTSConfig() (random weights from a seed on
        the card) and the trained vocoder, twice: time to the first audio chunk, chunks
        (4 of 10,240 samples), TTS and vocoder ms per chunk (CUDA events), seconds of audio
        per wall second, peak memory, K2's launches (60, no other kernel); ids and samples
        identical across the runs, samples finite in (-1, 1); Griffin-Lim (32 rounds) on the
        same mels, timed;
     c. f32 card against CPU at small size: a 2-layer TTSConfig at d 256, synthesize_chunk
        within 1e-4 with and without a speaker; RVQ codes equal and decode within 1e-5;
        Griffin-Lim from one injected phase, 4 rounds, within 1e-4 from the same magnitude.
 15. the AF1/AF2 family (models/clap.py, models/flamingo.py, api.AudioFlamingo2), after
     every earlier model is freed; no kernel of its own (the CLAP mel, the HTSAT tower, the
     audio-transform and xattn products are plain torch, as JAX's are plain XLA), the LM's
     products on K4 (int8) or K5 (fused w4):
     a. AF2 at full width as bench.py's bench_clap builds it (AF2Config(): HTSAT-base with
        fusion, 36 xattn blocks; Qwen2.5-3B as an int8 tree from random_quantized_lm; the
        fusion stacks and the tower bf16, random from a seed on the card, the xattn gates
        set nonzero): AudioFlamingo2.generate, 32 greedy tokens, on a 30 s 48 kHz clip (3
        windows, bucket 4) twice (ids identical, the step captured once) and bench_clap's
        5-minute clip (30 windows) once, 145 K4 launches a step and none of K5 or K6;
        the captured decode against the eager step function from the same prefill (ids
        equal); sampled (top-p 0.9, temperature 0.7) twice from one seed (equal) and a
        second 30 s clip right after the first through the same captured step (equal to its
        own eager run, unequal to the first clip's: the media buffer is refilled); the TTFT
        split into mel, tower and prefill by CUDA events; decode tok/s replayed and eager;
        one eager step's 145 K4 launches re-run against the plain version and each 3B shape
        timed alone beside its bound, plain version and torch._weight_int8pack_mm; two
        replays under torch.profiler (K4's and cuBLAS's shares); peak memory;
     b. the same fusion stacks and tower with the LM as a fused-w4 tree (a bf16 3B made on
        the card, quantize_lm_params_w4): generate on the 30 s clip twice, 144 K5 and 1 K4
        launches a step, no K6 (the suffixes cannot run between xattn blocks), one eager
        step's K5 launches re-run against the plain version, each shape timed beside its
        bound, plain version and torch._weight_int4pack_mm;
     c. f32 card against CPU at full width, 2 + 2 layers: the HTSAT-base tower's embeds on
        one fusion window, flamingo logits (float, int8 and fused-w4 trees) within 1e-4 of
        max|logit| and greedy ids token-exact;
     d. AF1 at OPT-IML-1.3B's widths (AF1Config.make()), 2 layers, f32: greedy generate
        token-exact and logits_with_media_mask on 4 media x 4 windows ('last') within 1e-4
        of max|logit|, card against CPU.
 16. the AF1/AF2 serving engines (runtime/flamingo_engine.py, runtime/paged_flamingo_engine.py),
     the AF2 beam (runtime/beam.generate_beam_xattn) and K3 at OPT's head dim 64, after
     every earlier model is freed:
     a. K3 at hd 64 (AF1's pools [24, 56, 128, 32, 64], scale 1) against its plain version:
        g = 1 over f32, bf16 and int8 pools with f32 and bf16 q, a current token merged;
        g' = 5 (a k = 4 verify) over bf16/bf16, bf16/int8 and f32/f32 with its block merged
        (merge_block_tokens); rows {400, 1500, 1, 0} at layers 0 and 23, two launches
        bit-identical; each shape timed at the engine's rows with the wrapper and as device
        time beside its plain version and bound; a CUDA call at hd 96 refused;
     b. AF2 at full width and 18 of its 36 layers (15a's build otherwise; XATTN_LAYERS)
        behind bench_xattn_engines' settings and requests
        (3 x (400, 1500 random ids), 30 windows each, 16 greedy tokens): FlamingoEngine (4
        slots of 2048), PagedFlamingoEngine (4 rows, 56 pages of 128) on a bf16 and an int8
        pool; each a warm-up instance, then the six requests twice (ids equal): tok/s, TTFT
        from submit, per decode step 73 K4 and 18 K3 (paged) launches counted inside the
        chunks; every K3 launch of the second paged runs held to the plain version right
        after its chunk, and (bf16 pool) the first chunk's launches replayed in one CUDA
        graph beside their bounds and the plain version timed on each; the slot and paged
        engines' ids compared (they need not agree at bf16);
     c. AF1 at full width and 12 of its 24 layers (AF1Config.make with xattn every second
        layer, OPT-IML-1.3B's widths, bf16 from a seed) behind PagedFlamingoEngine on a bf16
        and an int8 pool, as 16b: 12 K3 launches a step at hd 64, every one held to the
        plain version;
     d. the AF2 beam: AudioFlamingo2.generate(num_beams=4, 16 tokens) on a 30 s clip twice
        (one answer, the step captured once), the captured step against the eager one from
        one prefill (the search's sequences, scores and flags equal), ms a step beside the
        bound, 73 K4 launches a step;
     e. f32 card against CPU at full width, 2 + 2 layers, lively (liven): AF2 on both
        engines (f32 and int8 pools) and AF1 on the paged engine (K3 at hd 64), three
        requests each, ids token-exact and varying; a speculative run on AF2's slot and
        f32-pool paged engines and AF1's, with a random 2-layer Qwen2 draft at the 0.5B's
        widths, equal to the plain run; the AF2 beam (K 4) equal card vs CPU.
 17. LoRA / QLoRA and GRPO training (models/lora.py, train/grpo.py), after every earlier
     model is freed:
     a. QLoRA-7B, bench_train_mm's second recipe: the int8 7B made on the card (a bf16
        model from a seed, quantize_lm_params), rank-16 adapters on the 7 targets, flash
        and remat "full", the recipe's tiny encoder and no mels, batch 4 x 1024 random ids,
        ce_chunk 256, the port's AdamW at 1e-4 over the adapters (make_optimizer with
        lora_only); one warm and three timed steps: ms a step, tokens/s, peak, K2 and K7 a
        step beside their bounds; the base bit-identical, lora_b off zero, step 0's loss
        the base's; every K2 and K7 launch of one step re-run against its plain version;
        the adapters through save_lora and load_lora into the bare base, 8 greedy tokens
        through the captured step (K4 plus the deltas) against the eager step, one step's
        113 K4 launches re-run against the plain version;
     b. GRPO-1.5B, bench_grpo: a bf16 Qwen2.5-1.5B policy with the full encoder, the
        reference's LM in int8, PagedEngine (8 rows, 80 pages of 128, prefix cache),
        G = 8 rollouts of 750 <sound> + 64 text ids with a 30 s mel, 32 new tokens
        (temperature 1, top-k 50): rollout tok/s, one chunk's K3 launches at g = 6 held
        to the plain version; one grpo_step(trainable="lm", offload_pool=True): the pool
        restored bit-identical, the first ratio 1, the towers unchanged and the LM moved,
        the engine on the policy's tensors; the update's seconds, peak, K2 and K7;
     c. f32 card against CPU at full width, 2 + 2 layers, 1 x 128 tokens: a QLoRA step's
        loss and adapter gradients (the 7B's widths) and grpo_loss with its LM gradients
        (the 1.5B's widths) within 1e-4.
 18. the user entry points and 15 minutes of Music Flamingo, after every earlier model is
     freed; no kernel of its own (K1 and K2 run on its paths):
     a. the native BPE (runtime/cpp/bpe.cpp, built by g++ into _build/) against the Python
        merge loop, token for token, with and without the special tokens, on a 20,000-word
        mixed-script text, a repeated mixed text, a chat-templated 30 s prompt and every
        prompt of this phase, for a 152,064-id tokenizer (the 256 byte symbols, random
        merges, the specials: random weights then answer in text) and from_random's
        trained one; both timed on the longest text;
     b. python -m audio_flamingo_tpu_torch in subprocesses, one at a time, on a full-width
        AF3 checkpoint at 2 + 2 layers written in bf16 by io/hf_export.save_pretrained:
        infer on a 30 s 16 kHz WAV (16 tokens) prints load(DIR).generate's greedy answer;
        chat with two turns on stdin (':audio <path>', then two prompts) prints
        generate(chat=True)'s two answers; every exit code 0;
     c. serve/demo.DemoServer on port 0 over a full-depth bf16 7B (AF3Config.music_flamingo(),
        its held decode steps released so that the first request captures on a handler
        thread): a WAV upload and a mic-PCM turn, each answer equal to generate(chat=True) on
        the same input; the page; /api/reset; a bad upload answering 400;
     d. eval/harness.evaluate and evaluate_batched (BatchEngine, 4 slots) on four 30 s
        examples (asr, mcq, qa, caption; 16 tokens) on that 7B: both finish, each route's
        scores are _score of its answers, the answers that differ between the routes
        counted; then on 18b's checkpoint loaded in f32, where both routes answer alike;
     e. 15 minutes of Music Flamingo on that 7B: a 900 s 16 kHz mono WAV through
        load_audio and the K1 frontend (30 windows), the encoder, a ~22.6k-token prefill
        (past the last token bucket: unpadded), 16 greedy tokens, twice (ids identical);
        K1 at [30, 480000] on the clip's windows and the first encoder and prefill K2
        launches held to their plain versions (the prefill's over blocks of 1024 rows),
        timed beside SDPA and the bounds; user TTFT and peak memory.
Prints a {"kernels": [...]} JSON line and, last, {"ok": true, "device": {...}}. Any
failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import unicodedata
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
PEAK_TF32 = 495e12                                     # H100 SXM dense TF32 (K1's 3xTF32 route)
# the kernels before their Hopper redesign (PERF.md section 6, "before" of the rows that this
# script's phases 3b and 7a read; H100 80GB HBM3 at 700 W): K1 at [20, 480000] with the
# wrapper (ms), K6 device ms in 7a's eight-call graphs and one decode step's 56 calls
K1_BEFORE_MS = {20: 1.2754}
K6_BEFORE_MS = {("A", 1): 0.0566, ("A", 8): 0.0621, ("B", 1): 0.0453, ("B", 8): 0.0477,
                ("step", 1): 2.841}
LOGITS_TOL = 1e-4                                      # f32 af3.logits, card vs CPU
# K2 and K7 route by dtype; the main paths run bf16
FLASH_ROUTES = {"bfloat16": "bf16 mma.sync", "float32": "f32 CUDA cores"}


def ptxas_report(build_log: str) -> list:
    """One record per compiled kernel from nvcc's ``-Xptxas -v`` report: its name with its
    integer template arguments, registers, stack frame, spill stores + loads and static
    shared memory (dynamic shared memory is set at launch). A cached library keeps the
    report of the build that made it."""
    import re

    out, cur = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '_ZN([^']+)'", line)
        if m:
            mangled, pos, name = m.group(1), 0, None
            while name is None and (n := re.match(r"\d+", mangled[pos:])):
                pos += n.end() + int(n.group())          # <length><identifier> ...
                ident = mangled[pos - int(n.group()):pos]
                if ident.endswith("kernel"):
                    args = mangled[pos:].split("EE", 1)[0] + "E" if mangled[pos] == "I" else ""
                    vals = re.findall(r"Li(-?\d+)E", args)
                    name = f"{ident}<{','.join(vals)}>" if vals else ident
            cur = dict(kernel=name or m.group(1), registers=None, stack_bytes=0, spill_bytes=0,
                       smem_bytes=0)
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m:
            cur["stack_bytes"] = int(m.group(1))
            cur["spill_bytes"] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem_bytes"] = int(s.group(1)) if s else 0
    return out


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


def visible_pairs(tq: int, tk: int, causal: bool, q_offset: int) -> int:
    """(query row, key) pairs that attention computes: all, or under causal masking the
    keys at or before each row's position q_offset + i."""
    if not causal:
        return tq * tk
    return sum(max(0, min(tk, i + q_offset + 1)) for i in range(tq))


def attention_bound_ms(q_shape, k_shape, causal: bool, q_offset: int, dtype: str) -> tuple:
    """Least time for the function on the card: max(FLOPs / peak, bytes / HBM rate)."""
    b, tq, h, d = q_shape
    tk, hkv = k_shape[1], k_shape[2]
    flops = 4.0 * b * h * d * visible_pairs(tq, tk, causal, q_offset)
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


def score_sums_check(fa, name: str, q, k, scale) -> str:
    """The two measured facts that K2's bf16 tolerance rests on, held on one case's inputs
    before its output is: the plain version's f32 scores (its own einsum) equal bit for bit
    the sequential fmaf sum by which K2 recomputes the scores that set the running max or
    sit near a rounding edge of p (cuBLAS's summation order, which no document fixes), and
    K2's tensor-core scores lie within its err_bound, (|x| + 1) 2^-16 after the scale."""
    s_mma, s_seq = fa.score_sums(q, k)
    s_plain = fa.reference_scores(q, k).flatten(1, 2)
    differ = int((s_plain != s_seq).sum().item())
    check(differ == 0,
          f"flash {name} bfloat16: the plain version's f32 scores differ from the sequential "
          f"fmaf sum at {differ} of {s_plain.numel()} pairs; K2's bf16 route recomputes "
          f"scores in that order, so its tolerance no longer holds: the f32 product's "
          f"summation order changed")
    sc = scale if scale is not None else q.shape[-1] ** -0.5
    x_plain = s_plain * sc
    ratio = ((s_mma * sc - x_plain).abs() / ((x_plain.abs() + 1) * 2.0 ** -16)).max().item()
    check(ratio <= 1.0,
          f"flash {name} bfloat16: K2's tensor-core scores at {ratio:.3f} of its err_bound "
          f"(|x| + 1) 2^-16 from the plain ones; its recompute masks assume <= 1")
    return (f"flash {name:14s} bfloat16 scores: plain == sequential fmaf sum at all "
            f"{s_plain.numel()} pairs; tensor-core scores within {ratio:.3f} of err_bound")


def kernel_phase(fa) -> dict:
    """Flash kernel vs its plain version at the encoder, LM-prefill and a ragged shape, and
    at shapes no path gives but either route must take: D = 64 causal with a q_offset,
    D = 128 non-causal with Tk != Tq, and a negative q_offset whose first rows see no key
    (o = 0, lse = -inf). Every case runs twice on the same inputs: bit-identical. Each bf16
    case first holds the facts its tolerance rests on (score_sums_check).

    q is drawn so that the scores q.k * scale have the stated standard deviation: 1 gives
    a broad softmax, 4 a peaked one whose running max moves, exercising the rescale."""
    cases = [  # name, q shape, k shape, causal, scale, q_offset, score std, timed
        ("encoder", (1, 1500, 20, 64), (1, 1500, 20, 64), False, 1.0, 0, 1.0, True),
        ("lm_prefill", (1, 1024, 28, 128), (1, 1024, 4, 128), True, None, 0, 1.0, True),
        ("ragged", (1, 100, 28, 128), (1, 300, 4, 128), True, None, 200, 3.0, True),
        ("encoder_peaked", (1, 1500, 20, 64), (1, 1500, 20, 64), False, 1.0, 0, 4.0, False),
        ("lm_peaked", (1, 1024, 28, 128), (1, 1024, 4, 128), True, None, 0, 4.0, False),
        ("d64_offset", (2, 333, 8, 64), (2, 500, 2, 64), True, None, 150, 3.0, False),
        ("d128_tk_ne_tq", (2, 200, 8, 128), (2, 461, 4, 128), False, None, 0, 3.0, False),
        ("no_key_rows", (1, 230, 8, 64), (1, 300, 4, 64), True, None, -90, 1.0, False),
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
            if dtype == torch.bfloat16:
                log(score_sums_check(fa, name, q, k, scale))
            r = compare(fa, q, k, v, kw)
            dn = r["dtype"]
            (o1, lse1), (o2, lse2) = (fa.flash_attention_lse(q, k, v, **kw) for _ in range(2))
            check(torch.equal(o1, o2) and torch.equal(lse1, lse2),
                  f"flash {name} {dn}: two launches on the same inputs differ")
            if q_offset < 0:     # rows i < -q_offset see no key
                check(bool((o1[:, :-q_offset] == 0).all())
                      and bool(torch.isneginf(lse1[:, :-q_offset]).all())
                      and bool(torch.isfinite(lse1[:, -q_offset:]).all()),
                      f"flash {name} {dn}: rows without a visible key are not o = 0, lse = -inf")
            msg = (f"flash {name:14s} {dn:8s} q{list(qs)} k{list(ks)} causal={causal} "
                   f"q_offset={q_offset} score_std={score_std}: max|o-plain|={r['err']:.3e} "
                   f"(at {r['ratio']:.3f} of its limit) max|lse-plain|={r['lse_err']:.3e}, "
                   f"replay bit-identical")
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
    """Least time for K1 on n windows: each input read once and the output written once,
    against the products' operations in 3xTF32 on the tensor cores (three passes at 495
    TFLOP/s, the route the kernel takes) -> (ms, "operations" or "bytes", the f32 bound:
    the same operations on the CUDA cores at 67 TFLOP/s, the route K1 took before)."""
    cfg = fe.cfg
    n_fft, n_bins, n_mels = cfg.n_fft, cfg.n_fft // 2 + 1, cfg.num_mel_bins
    frames = fe.frames_per_window
    flops = n * frames * (n_fft * 2 * n_bins * 2 + n_bins * n_mels * 2)
    nbytes = 4 * (n * fe.window_samples + 2 * n_fft * n_bins + n_bins * n_mels
                  + n * frames * n_mels)
    t_ops, t_bytes = 3 * flops / PEAK_TF32, nbytes / PEAK_BYTES
    f32_ms = max(flops / PEAK_FLOPS["float32"], t_bytes) * 1e3
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), f32_ms


def log_mel_phase(lm, fe) -> dict:
    """K1 against its plain version at [1, 480000] and [20, 480000], on a seeded tone plus
    noise and on normal x 0.1, held to |x - plain| <= 5e-4 + 1e-4 |plain| (the JAX
    kernel's own test bound), two launches on the same inputs bit-identical; kernel and
    plain version timed on the normal input, the kernel also as device time (a CUDA graph
    of 4 or 2 calls) beside the parent's figure and both bounds."""
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
            call = lambda: lm.fused_log_mel(*args, bases=fe.kernel_bases)
            out, again = call(), call()
            ref = lm.log_mel_reference(*args)
            diff = (out - ref).abs()
            atol, rtol = MEL_TOL
            r = dict(err=diff.max().item(),
                     ratio=(diff / (atol + rtol * ref.abs())).max().item())
            check(out.shape == (n, fe.frames_per_window, fe.cfg.num_mel_bins),
                  f"K1 output shape {tuple(out.shape)}")
            check(bool(torch.isfinite(out).all()), "K1 output not finite")
            check(torch.equal(out, again), f"K1 [{n}] {kind}: two launches differ")
            msg = (f"log_mel [{n},{fe.window_samples}] {kind:6s}: max|x-plain|={r['err']:.3e} "
                   f"(at {r['ratio']:.3f} of its limit), replay bit-identical")
            if kind == "normal":
                r["ms"] = time_ms(call)
                r["dev_ms"] = graph_ms(call, 10, 4 if n == 1 else 2)
                r["plain_ms"] = time_ms(lambda: lm.log_mel_reference(*args), 10, 2)
                r["bound_ms"], r["bound_by"], r["bound_f32_ms"] = log_mel_bound_ms(n, fe)
                before = K1_BEFORE_MS.get(n)
                msg += (f" ms={r['ms']:.4f} (parent, PERF.md: "
                        f"{'not listed' if before is None else f'{before:.4f}'}) device "
                        f"{r['dev_ms']:.4f} ms; plain_ms={r['plain_ms']:.4f} library_ms=none "
                        f"(no single PyTorch call computes this function); bound_ms="
                        f"{r['bound_ms']:.4f} (3xTF32 on the tensor cores, {r['bound_by']}) = "
                        f"{r['bound_ms'] / r['dev_ms'] * 100:.1f} % of the device time; the f32 "
                        f"CUDA-core bound {r['bound_f32_ms']:.4f} ms = "
                        f"{r['bound_f32_ms'] / r['dev_ms'] * 100:.1f} %")
            log(msg)
            check(r["ratio"] <= 1.0, f"K1 [{n}] {kind}: |x - plain| at {r['ratio']:.3f} "
                                     "of its limit")
            results[(n, kind)] = r
    return results


def write_wav(path: str, seconds: int, sr: int, seed: int, mono: bool = False) -> None:
    """A 16-bit stereo WAV: a tone per channel plus noise, from a numpy seed (mono: the
    left channel alone)."""
    rng = np.random.default_rng(seed)
    t = np.arange(seconds * sr, dtype=np.float64) / sr
    left = 0.3 * np.sin(2 * np.pi * 440.0 * t) + 0.05 * rng.standard_normal(t.size)
    right = 0.2 * np.sin(2 * np.pi * 660.0 * t) + 0.05 * rng.standard_normal(t.size)
    pcm = np.clip(np.stack([left] if mono else [left, right], 1) * 32767, -32768,
                  32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1 if mono else 2)
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
    warm["wav"] = wav      # phase 10d answers the same file on the w8a8 path
    return warm


_F32_BASE: list = []   # f32_base's model, made once
F32_FLAGS = ("use_flash", "remat", "a8_attention", "a8_prefill", "fused_stages")


def f32_base(cfg):
    """The f32 AF3 at full width and 2 + 2 layers, its weights made on the CPU from seed 0
    (the CPU side of phases 6, 7c, 8e, 9c, 10e, 12d and 13d), under ``cfg``: that config's
    switches (flash, remat, the a8 flags) over the same weights, whose shapes ``cfg`` must
    give. Before PR 24 each of those phases made the same weights itself, 12-20 s a build
    on the card's host; now they are made once and shared, so no phase may change them
    (9c trains copies). ``release_f32_base`` frees them after 13d."""
    from audio_flamingo_tpu_torch.api import AudioFlamingo
    from audio_flamingo_tpu_torch.config import AF3Config

    def shapes(c):
        return dataclasses.replace(
            c, audio_token_id=0,
            encoder=dataclasses.replace(c.encoder, **{f: getattr(AF3Config().encoder, f)
                                                      for f in F32_FLAGS
                                                      if hasattr(c.encoder, f)}),
            lm=dataclasses.replace(c.lm, **{f: getattr(AF3Config().lm, f) for f in F32_FLAGS
                                            if hasattr(c.lm, f)}))

    full = AF3Config()
    if not _F32_BASE:
        dims = with_flash(dataclasses.replace(
            full, encoder=dataclasses.replace(full.encoder, num_layers=2),
            lm=dataclasses.replace(full.lm, num_layers=2)), True)
        t0 = time.perf_counter()
        _F32_BASE.append(AudioFlamingo.from_random(dims, seed=0, compute_dtype=torch.float32,
                                                   device="cpu"))
        log(f"f32 base: AF3 at full width, 2 + 2 layers, made on the CPU from seed 0 in "
            f"{time.perf_counter() - t0:.1f}s (shared by 6, 7c, 8e, 9c, 10e, 12d, 13d)")
    base = _F32_BASE[0]
    check(shapes(cfg) == shapes(base.cfg), "f32_base: the config's shapes are not the base's")
    return base.with_config(dataclasses.replace(cfg, audio_token_id=base.cfg.audio_token_id))


def release_f32_base() -> None:
    _F32_BASE.clear()
    gc.collect()


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
        cpu = f32_base(cfg)
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


W4_F32_TOL = 1e-5                    # f32 K5/K6: max|y - plain| <= 1e-5 max|plain| (CPU tests' bound)
W4_BF16_TOL = (2.0 ** -7, 2.0 ** -9)  # bf16: |y - plain| <= 2^-7 |plain| + 2^-9 max|plain|


def w4_compare(y: torch.Tensor, ref: torch.Tensor) -> dict:
    """err: max |y - plain|; ratio: the largest |y - plain| over its limit (must be <= 1).
    f32: 1e-5 of max|plain| (sums in another order). bf16: one ulp of the output's rounding
    (2^-7 |plain|) plus 2^-9 max|plain| for outputs moved by a bf16 intermediate (K6's
    normed row) that rounded the other way after an f32 difference in the last place."""
    diff = (y.float() - ref.float()).abs()
    scale = ref.float().abs().max().item()
    if y.dtype == torch.float32:
        limit = torch.full_like(diff, W4_F32_TOL * scale)
    else:
        limit = W4_BF16_TOL[0] * ref.float().abs() + W4_BF16_TOL[1] * scale
    return dict(err=diff.max().item(), ratio=(diff / limit).max().item(),
                finite=bool(torch.isfinite(y.float()).all()))


def w4_bound_ms(products, m: int, dtype: str, io_elems: int | None = None) -> tuple:
    """Least time for w4 products of m rows: each (K, N, group) reads its packed codes
    (K/2 N bytes) and f32 scales (K/G N 4) once, plus the call's inputs and outputs
    (``io_elems`` values of the dtype; default each product's x and y), against 2 m K N
    operations at the dtype's peak."""
    item = 4 if dtype == "float32" else 2
    nbytes, flops = 0, 0.0
    for k, n, group in products:
        nbytes += k // 2 * n + k // group * n * 4
        flops += 2.0 * m * k * n
    nbytes += item * (io_elems if io_elems is not None else
                      sum(m * (k + n) for k, n, _ in products))
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def k5_shape(w_p, gscale) -> tuple:
    k, n = 2 * w_p.shape[-2], w_p.shape[-1]
    return k, n, k // gscale.shape[-2]


def suffix_bound_ms(first, second, m: int, dtype: str, gated: bool) -> tuple:
    """Bound of a suffix call: both weight sets, the [m, K1] and [m, D] inputs, the norm
    weight [D] and the two outputs: [m, D] and [m, N2/2] act for A (``gated``: its second
    product is gate|up), [m, D] and [m, N2] qkv for B."""
    (k1, d, g1), (_, n2, g2) = (k5_shape(p["w_p"], p["gscale"]) for p in (first, second))
    out2 = n2 // 2 if gated else n2
    return w4_bound_ms([(k1, d, g1), (d, n2, g2)], m, dtype, m * (k1 + 2 * d + out2) + d)


def int8pack_call(x, w_q, scale):
    """One torch._weight_int8pack_mm call on an int8 [K, N] head's codes, laid out [N, K]
    with bf16 scales (the library's layout), as the yardstick of K4 (w8a16). Returns
    (call, None) or (None, the reason it is refused)."""
    try:
        w = w_q.t().contiguous()
        s = scale.to(x.dtype)
        call = lambda: torch._weight_int8pack_mm(x, w, s)
        call()
        torch.cuda.synchronize()
        return call, None
    except (RuntimeError, TypeError, AttributeError, NotImplementedError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"


def int4pack_call(x, w_p, gscale):
    """One torch._weight_int4pack_mm call on the same codes: unpacked to q = code + 8 in
    [1, 15], laid out [N, K] with two codes a byte, repacked by
    torch._convert_weight_to_int4pack, with scale = the group scale and zero point 0, so
    (q - 8) scale + 0 gives the same symmetric values (the scales rounded to bf16, the
    library's only scale type). Returns (call, None) or (None, the reason it is refused)."""
    from audio_flamingo_tpu_torch.ops.quant4 import unpack_w4

    if x.dtype != torch.bfloat16:
        return None, "the library call takes bf16/f16 x only"
    k, n, group = k5_shape(w_p, gscale)
    try:
        q = (unpack_w4(w_p).to(torch.int32) + 8).t().contiguous()          # [N, K]
        packed = (q[:, ::2] << 4 | q[:, 1::2]).to(torch.uint8)
        del q
        w = torch._convert_weight_to_int4pack(packed, 8)
        sz = torch.stack([gscale, torch.zeros_like(gscale)], -1).to(torch.bfloat16).contiguous()
        call = lambda: torch._weight_int4pack_mm(x, w, group, sz)
        call()
        torch.cuda.synchronize()
        return call, None
    except (RuntimeError, TypeError, AttributeError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"


def w4_kernel_phase(k5, k6, qlm, head_w4) -> dict:
    """7a. K5 and K6 against their plain versions at the 7B shapes, on the int4 LM's own
    stacked codes (quantized from its normal weights) and random normal x, in f32 and
    bf16: K5 stacked at m 1, 8, 256 for qkv, o, gate|up and down at layers 0 and L-1; K5
    unstacked at the int4 head's shape; K6 A and B at m 1 and 8, layers 0 and L-1 (B of
    the last layer computes the discarded qkv of that layer). Timed at layer 0 (median
    of 15 after 3, wrapper included): kernel, plain version, the int4pack library call
    (K5, bf16); and as device times (graph_ms): K5 and the library call L times on layer 0
    in one graph (small weights then sit in L2), K5 once on every layer in turn (the
    weights stream from memory, as in a decode step), K6 8 times on layer 0 and one decode
    step's L A + L B."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    layers = qlm.layers
    n_layers = layers["ln1_w"].shape[0]
    mats = {"qkv": layers["qkv"], "o": layers["o"], "gateup": layers["mlp"]["gateup"],
            "down": layers["mlp"]["down"]}
    res = {}
    for name, p in mats.items():
        k = 2 * p["w_p"].shape[1]
        for m in (1, 8, 256):
            x32 = torch.randn((m, k), generator=gen, device="cuda")
            for dtype in (torch.float32, torch.bfloat16):
                x = x32.to(dtype)
                dn = str(dtype).split(".")[-1]
                for layer in (0, n_layers - 1):
                    y = k5.w4a16_matmul_stacked(x, p["w_p"], p["gscale"], layer)
                    ref = k5.w4a16_matmul_reference(x, p["w_p"][layer], p["gscale"][layer])
                    r = w4_compare(y, ref)
                    check(r["finite"] and r["ratio"] <= 1.0,
                          f"K5 {name} m={m} {dn} layer {layer}: |y - plain| at "
                          f"{r['ratio']:.3f} of its limit")
                    res[("k5", name, m, dn, layer)] = r
                r = res[("k5", name, m, dn, 0)]
                w_p, gs = p["w_p"][0], p["gscale"][0]
                call = lambda: k5.w4a16_matmul_stacked(x, p["w_p"], p["gscale"], 0)
                r["ms"] = time_ms(call)
                r["dev_ms"] = graph_ms(call, 10, n_layers)

                def every_layer():
                    for i in range(n_layers):
                        k5.w4a16_matmul_stacked(x, p["w_p"], p["gscale"], i)

                r["cold_ms"] = graph_ms(every_layer, 10) / n_layers
                r["plain_ms"] = time_ms(lambda: k5.w4a16_matmul_reference(x, w_p, gs), 5, 1)
                lib, why = int4pack_call(x, w_p, gs)
                r["library_ms"] = time_ms(lib) if lib else None
                r["library_dev_ms"] = graph_ms(lib, 10, n_layers) if lib else None
                r["bound_ms"], r["bound_by"] = w4_bound_ms([k5_shape(w_p, gs)], m, dn)
                log(f"K5 {name:6s} [{m},{k}]x[{k // 2},{w_p.shape[1]}] {dn:8s}: max|y-plain| "
                    f"layer 0 {r['err']:.3e} / layer {n_layers - 1} "
                    f"{res[('k5', name, m, dn, n_layers - 1)]['err']:.3e} (at "
                    f"{max(r['ratio'], res[('k5', name, m, dn, n_layers - 1)]['ratio']):.3f} of "
                    f"the limit); ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms="
                    f"{'null (' + why + ')' if lib is None else f'{r['library_ms']:.4f}'} "
                    f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}); device: layer 0 "
                    f"{r['dev_ms']:.4f} ms, library "
                    f"{'null' if lib is None else f'{r['library_dev_ms']:.4f}'} ms, every layer "
                    f"in turn {r['cold_ms']:.4f} ms = {r['bound_ms'] / r['cold_ms'] * 100:.1f} % "
                    f"of the bound")
                del lib
    k = 2 * head_w4["w_p"].shape[0]
    for m in (1, 8):
        x32 = torch.randn((m, k), generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            x, dn = x32.to(dtype), str(dtype).split(".")[-1]
            y = k5.w4a16_matmul(x, head_w4["w_p"], head_w4["gscale"])
            r = w4_compare(y, k5.w4a16_matmul_reference(x, head_w4["w_p"], head_w4["gscale"]))
            check(r["finite"] and r["ratio"] <= 1.0,
                  f"K5 head m={m} {dn}: |y - plain| at {r['ratio']:.3f} of its limit")
            call = lambda: k5.w4a16_matmul(x, head_w4["w_p"], head_w4["gscale"])
            r["ms"] = time_ms(call)
            r["dev_ms"] = r["cold_ms"] = graph_ms(call, 10, 4)   # 290 MB: never in L2
            r["plain_ms"] = time_ms(lambda: k5.w4a16_matmul_reference(
                x, head_w4["w_p"], head_w4["gscale"]), 5, 1)
            lib, why = int4pack_call(x, head_w4["w_p"], head_w4["gscale"])
            r["library_ms"] = time_ms(lib) if lib else None
            r["library_dev_ms"] = graph_ms(lib, 10, 4) if lib else None
            del lib
            r["bound_ms"], r["bound_by"] = w4_bound_ms(
                [k5_shape(head_w4["w_p"], head_w4["gscale"])], m, dn)
            log(f"K5 head   [{m},{k}]x{list(head_w4['w_p'].shape)} {dn:8s} (unstacked): "
                f"max|y-plain|={r['err']:.3e} (at {r['ratio']:.3f} of the limit) ms="
                f"{r['ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms="
                f"{'null (' + why + ')' if r['library_ms'] is None else f'{r['library_ms']:.4f}'} "
                f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}); device {r['dev_ms']:.4f} ms, "
                f"library {'null' if r['library_dev_ms'] is None else f'{r['library_dev_ms']:.4f}'}"
                f" ms = {r['bound_ms'] / r['dev_ms'] * 100:.1f} % of the bound")
            res[("k5", "head", m, dn, 0)] = r
    d = layers["ln1_w"].shape[1]
    k_o = 2 * layers["o"]["w_p"].shape[1]
    o, gu, down, qkv = (mats[n] for n in ("o", "gateup", "down", "qkv"))
    for m in (1, 3, 8):
        attn32 = torch.randn((m, k_o), generator=gen, device="cuda")
        h32 = torch.randn((m, d), generator=gen, device="cuda")
        ln32 = 1.0 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            attn, h, ln = attn32.to(dtype), h32.to(dtype), ln32.to(dtype)
            dn = str(dtype).split(".")[-1]
            for layer in (0, n_layers - 1):
                nxt = min(layer + 1, n_layers - 1)
                a = k6.w4_suffix_a(attn, h, ln, o, gu, layer)
                a_ref = k6.w4_suffix_a_reference(attn, h, ln, o, gu, layer)
                b = k6.w4_suffix_b(a[0], a[1], ln, down, qkv, layer, nxt)
                b_ref = k6.w4_suffix_b_reference(a[0], a[1], ln, down, qkv, layer, nxt)
                a2 = k6.w4_suffix_a(attn, h, ln, o, gu, layer)
                b2 = k6.w4_suffix_b(a[0], a[1], ln, down, qkv, layer, nxt)
                check(all(torch.equal(u, v) for u, v in zip((*a, *b), (*a2, *b2))),
                      f"K6 m={m} {dn} layer {layer}: two launches differ")
                rs = {name: w4_compare(u, v) for name, u, v in (
                    ("act", a[0], a_ref[0]), ("h", a[1], a_ref[1]),
                    ("h2", b[0], b_ref[0]), ("qkv", b[1], b_ref[1]))}
                for name, r in rs.items():
                    check(r["finite"] and r["ratio"] <= 1.0,
                          f"K6 {name} m={m} {dn} layer {layer}: |y - plain| at "
                          f"{r['ratio']:.3f} of its limit")
                res[("k6", m, dn, layer)] = rs
            a = k6.w4_suffix_a(attn, h, ln, o, gu, 0)
            per_call = (kernels_per_call(lambda: k6.w4_suffix_a(attn, h, ln, o, gu, 0)),
                        kernels_per_call(lambda: k6.w4_suffix_b(a[0], a[1], ln, down, qkv, 0, 1)))
            log(f"K6 m={m} {dn}: replays bit-identical; kernels per call (torch.profiler) A "
                f"{per_call[0]}, B {per_call[1]}")
            check(per_call == (1, 1), f"K6 m={m} {dn}: {per_call} kernels per suffix call, not 1")
            res[("k6calls", m, dn)] = per_call
            if m == 3:   # checked, not timed
                continue
            ra = dict(err=max(res[("k6", m, dn, i)][n]["err"] for i in (0, n_layers - 1)
                              for n in ("act", "h")),
                      ratio=max(res[("k6", m, dn, i)][n]["ratio"] for i in (0, n_layers - 1)
                                for n in ("act", "h")))
            rb = dict(err=max(res[("k6", m, dn, i)][n]["err"] for i in (0, n_layers - 1)
                              for n in ("h2", "qkv")),
                      ratio=max(res[("k6", m, dn, i)][n]["ratio"] for i in (0, n_layers - 1)
                                for n in ("h2", "qkv")))
            a = k6.w4_suffix_a(attn, h, ln, o, gu, 0)
            ra["ms"] = time_ms(lambda: k6.w4_suffix_a(attn, h, ln, o, gu, 0))
            ra["dev_ms"] = graph_ms(lambda: k6.w4_suffix_a(attn, h, ln, o, gu, 0), 10, 8)
            rb["dev_ms"] = graph_ms(lambda: k6.w4_suffix_b(a[0], a[1], ln, down, qkv, 0, 1), 10, 8)

            def step():   # one decode step's suffixes, layer after layer
                for i in range(n_layers):
                    k6.w4_suffix_a(attn, h, ln, o, gu, i)
                    k6.w4_suffix_b(a[0], a[1], ln, down, qkv, i, min(i + 1, n_layers - 1))

            ra["step_dev_ms"] = graph_ms(step, 10)
            ra["plain_ms"] = time_ms(lambda: k6.w4_suffix_a_reference(attn, h, ln, o, gu, 0), 5, 1)
            rb["ms"] = time_ms(lambda: k6.w4_suffix_b(a[0], a[1], ln, down, qkv, 0, 1))
            rb["plain_ms"] = time_ms(
                lambda: k6.w4_suffix_b_reference(a[0], a[1], ln, down, qkv, 0, 1), 5, 1)
            ra["bound_ms"], ra["bound_by"] = suffix_bound_ms(o, gu, m, dn, gated=True)
            rb["bound_ms"], rb["bound_by"] = suffix_bound_ms(down, qkv, m, dn, gated=False)
            for name, r in (("A", ra), ("B", rb)):
                before = K6_BEFORE_MS.get((name, m)) if dn == "bfloat16" else None
                log(f"K6 suffix {name} m={m} {dn:8s}: max|y-plain|={r['err']:.3e} (at "
                    f"{r['ratio']:.3f} of the limit, layers 0 and {n_layers - 1}) ms="
                    f"{r['ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms=null (no single "
                    f"PyTorch call computes the fused suffix) bound_ms={r['bound_ms']:.5f} "
                    f"({r['bound_by']}); device {r['dev_ms']:.4f} ms = "
                    f"{r['bound_ms'] / r['dev_ms'] * 100:.1f} % of the bound (the parent, "
                    f"PERF.md: {'not listed' if before is None else f'{before:.4f} ms'})")
                res[("k6" + name, m, dn)] = r
            before = K6_BEFORE_MS.get(("step", m)) if dn == "bfloat16" else None
            log(f"K6 per decode step m={m} {dn:8s} ({n_layers} A + {n_layers} B, layer after "
                f"layer): device {ra['step_dev_ms']:.3f} ms against a bound of "
                f"{n_layers * (ra['bound_ms'] + rb['bound_ms']):.3f} ms (the parent, PERF.md: "
                f"{'not listed' if before is None else f'{before:.3f} ms'})")
    return res


# ------------------------------------------------------------ decode: captured against eager
# the decode kernels by the CUDA kernel names torch.profiler reports (csrc/*.cu)
DECODE_KERNELS = {"K4": ("w8_mma_kernel", "w8_fma_kernel", "w8_nk_kernel"),
                  "K5": ("w4_mma_kernel", "w4_fma_kernel"),
                  "K6": ("w4_suffix_kernel",)}
LOGITS_STEPS = 4   # steps whose f32 logits the captured step must give bit for bit


def profile_replays(graph, tag: str, replays: int, kernel_groups: dict = DECODE_KERNELS) -> dict:
    """``replays`` replays of a captured decode step under utils/profiling.trace (the
    Chrome trace in chip_smoke_traces/<tag>/), each in its own annotated range, after
    one more that is not counted (the profiler can miss the first kernels it sees): per
    group of ``kernel_groups`` (kernel name parts) its kernels and their device ms per
    replay, every kernel's device ms per replay, and the device-busy share of the counted
    window: the kernels' time over the span of the replays' ranges on the device (the gaps
    between replays included); ``ordered``: each group's kernel times (ms) in the order
    they ran."""
    from audio_flamingo_tpu_torch.utils import profiling

    labels = [f"{tag} replay {i}" for i in range(replays + 1)]
    torch.cuda.synchronize()
    with profiling.trace(os.path.join("chip_smoke_traces", tag)) as prof:
        for label in labels:
            with profiling.annotate(label):
                graph.replay()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    # an annotated range shows on the device as the span of its kernels
    ranges = {e.name: e.time_range for e in events if e.name in labels}
    check(all(label in ranges for label in labels[1:]),
          f"{tag}: torch.profiler shows {sorted(ranges)} of the replays' ranges on the device")
    t0, t1 = ranges[labels[1]].start, ranges[labels[-1]].end
    kernels = [e for e in events if e.name not in labels and t0 <= e.time_range.start < t1
               and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
    check(len(kernels) > 0, f"{tag}: torch.profiler saw no kernel in the replays")
    groups = {g: [0, 0.0] for g in kernel_groups}
    ordered = {g: [] for g in kernel_groups}
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        g = next((g for g, names in kernel_groups.items() if any(n in e.name for n in names)),
                 None)
        if g is not None:
            groups[g][0] += 1
            groups[g][1] += e.time_range.elapsed_us() / 1e3
            ordered[g].append(e.time_range.elapsed_us() / 1e3)
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    span = (t1 - t0) / 1e3
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us() / 1e3
    return dict(groups={g: (n / replays, ms / replays) for g, (n, ms) in groups.items()},
                replays=replays, ordered=ordered, kernels=len(kernels) / replays,
                busy_ms=busy / replays, span_ms=span / replays, busy_share=busy / span,
                by_name={k: (n / replays, ms / replays) for k, (n, ms) in by_name.items()})


def copy_state(dst, src) -> None:
    """dst's tensors, its cache's included, set to src's."""
    for name in ("tok", "position", "step", "out", "done", "logits", "logprobs", "seq"):
        if getattr(dst, name) is not None:
            getattr(dst, name).copy_(getattr(src, name))
    for name, t in vars(dst.cache).items():
        if isinstance(t, torch.Tensor):
            t.copy_(getattr(src.cache, name))
    dst.cache.host_index = src.cache.host_index


def graph_against_eager(tag, lm, cfg, spec, make_cache, start, steps: int, counters: dict,
                        keep_inputs=(), groups: dict | None = None, seed: int = 0,
                        timed_runs: int = 2) -> dict:
    """Decode through the captured step (runtime/generate.DecodeGraph) against the eager
    step function (generate.decode_body, the module's decode_step loop) from one start.

    ``start(state, generator)`` begins a sequence on a state (a prefill and its first
    token, or token 0 at position 0); the eager state copies it, and a sampled step's
    generators start from one seed. Both run ``steps`` steps: the ids must be equal over
    every step and the first LOGITS_STEPS steps' f32 logits bit-identical (the graph
    replays the eager step's kernels in its order). The eager steps' launches, counted by
    the wrappers (``keep_inputs``: the counters whose inputs are kept), must equal per
    step the launches the replays count and, for each DECODE_KERNELS group in
    ``groups`` (its counters), the kernels torch.profiler sees in one replay. One replay
    and one eager step run under set_sync_debug_mode("error"). Logged: ms per step of both
    (device-synchronized host clock; the graph as the median of ``timed_runs`` runs),
    the capture's seconds and bytes, and the profile of 2 replays with its device-busy
    share (2 replays keep each trace a few MB)."""
    from audio_flamingo_tpu_torch.runtime import generate as gen

    sampled = not spec.sampling.greedy
    with torch.inference_mode():
        st = gen.new_state(cfg, spec, make_cache(),
                           torch.Generator(device="cuda") if sampled else None)
        t0 = time.perf_counter()
        graph = gen.DecodeGraph(lm, cfg, spec, st)
        capture_s = time.perf_counter() - t0
        eager = gen.new_state(cfg, spec, make_cache(),
                              torch.Generator(device="cuda") if sampled else None)

        def begin():
            g = torch.Generator(device="cuda").manual_seed(seed) if sampled else None
            start(st, g)
            copy_state(eager, st)
            if sampled:
                graph.load_generator(g)
                eager.generator.set_state(g.get_state())

        begin()
        for name, c in counters.items():
            c.reset()
            c.capture = name in keep_inputs
        logits_eager = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            gen.decode_body(lm, cfg, spec, eager)
            if i < LOGITS_STEPS:
                logits_eager.append(eager.logits.clone())
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) / steps * 1e3
        eager_counts = {n: c.count for n, c in counters.items()}
        inputs = {n: list(counters[n].inputs) for n in keep_inputs}
        for c in counters.values():
            c.capture = False
            c.reset()
        logits_graph = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            graph.replay()
            if i < LOGITS_STEPS:
                logits_graph.append(st.logits.clone())
        torch.cuda.synchronize()
        first_graph_ms = (time.perf_counter() - t0) / steps * 1e3
        graph_counts = {n: c.count for n, c in counters.items()}
        for c in counters.values():
            c.reset()
        same_ids = torch.equal(st.out, eager.out)
        n_out = min(steps + 1, st.out.shape[1])
        ids = st.out[:, :n_out].clone().cpu()
        logit_diff = max((a.double() - b.double()).abs().max().item()
                         for a, b in zip(logits_graph, logits_eager))
        bit_equal = all(torch.equal(a, b) for a, b in zip(logits_graph, logits_eager))
        check(same_ids, f"{tag}: graph ids {st.out[0, :n_out].tolist()} != eager "
                        f"{eager.out[0, :n_out].tolist()}")
        check(bit_equal, f"{tag}: the first {LOGITS_STEPS} steps' logits differ graph vs eager "
                         f"(max {logit_diff:.3e})")
        check(graph_counts == eager_counts,
              f"{tag}: launches counted over the replays {graph_counts} != eager {eager_counts}")
        graph_times = []
        for _ in range(timed_runs):
            begin()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                graph.replay()
            torch.cuda.synchronize()
            graph_times.append((time.perf_counter() - t0) / steps * 1e3)
        graph_ms = statistics.median(graph_times)
        begin()
        prof = profile_replays(graph, tag.split()[0], 2)
        for g, names in (groups or {}).items():
            want = sum(eager_counts[n] for n in names) / steps
            check(prof["groups"][g][0] == want,
                  f"{tag}: torch.profiler counts {prof['groups'][g][0]} {g} kernels in one "
                  f"replay, the eager step launches {want}")
        begin()
        torch.cuda.set_sync_debug_mode("error")
        try:
            graph.replay()
            gen.decode_body(lm, cfg, spec, eager)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check(torch.equal(st.logits, eager.logits), f"{tag}: the synced-debug step's logits differ")
        nbytes = graph.nbytes()
        graph.graph.reset()
    del st, eager, graph
    log(f"{tag}: captured step against the eager step over {steps} steps: ids equal "
        f"({ids[0, :8].tolist()}...), the first {LOGITS_STEPS} steps' f32 logits bit-identical; "
        f"{graph_ms:.3f} ms per step in the graph (median of {timed_runs} runs; "
        f"{first_graph_ms:.3f} ms in the compared run) against {eager_ms:.3f} ms eager; "
        f"capture {capture_s:.2f}s (one eager step + the capture), it holds cache "
        f"{nbytes['cache'] / 2**20:.1f} MiB, state {nbytes['state'] / 2**20:.2f} MiB, graph "
        f"pool {nbytes['graph'] / 2**20:.1f} MiB; one replay under torch.profiler: "
        f"{prof['kernels']:g} kernels, {prof['busy_ms']:.3f} ms busy of {prof['span_ms']:.3f} ms "
        f"(device busy {prof['busy_share'] * 100:.1f} %), "
        + ", ".join(f"{g} {n} ({ms:.3f} ms)" for g, (n, ms) in prof["groups"].items() if n)
        + "; eager launches per step " + ", ".join(
            f"{n} {v / steps:g}" for n, v in eager_counts.items())
        + "; one replay and one eager step ran under set_sync_debug_mode('error')")
    return dict(graph_ms=graph_ms, eager_ms=eager_ms, first_graph_ms=first_graph_ms,
                capture_s=capture_s, nbytes=nbytes, prof=prof, ids=ids,
                counts={n: v / steps for n, v in eager_counts.items()}, inputs=inputs)


def int4_path_phase(model, fa, k5, k6, wav, bf16_logits) -> dict:
    """7b. The int4 main path: the bf16 model's LM quantized on the card by
    quantize_lm_params_w4 (what load(quantize_lm="int4") calls), the encoder shared, and
    generate() on the 30 s clip three times, greedy, 32 tokens; decode replays the captured
    step (the first run captures it). Launch counts per decode step (the replays count
    the launches captured in the step, the capture's eager warm-up step counts its own),
    identical ids, TTFT split, decode rate against the weight-streaming bound, the capture
    time and held bytes, peak memory, and the int4 prefill logits' cosine against the bf16
    ones (logged: with random weights it measures quantization error, not the port). Then
    the captured step against the eager one on the same prompt (graph_against_eager: ids,
    logits, 1 K5 + 28 + 28 K6 + 1 K4 in one replay by torch.profiler, sync debug), whose
    eager launches' inputs are replayed against the plain versions. The kernels' device
    time in the warm run: CUDA events around the prefill's launches plus the profiled
    replay's per-step time times the decode steps. Returns the numbers the kernel line
    needs."""
    from audio_flamingo_tpu_torch.models import af3, qwen2
    from audio_flamingo_tpu_torch.ops.quant4 import quantize_linear_w4, quantize_lm_params_w4

    lm_cfg = model.cfg.lm
    t0 = time.perf_counter()
    qlm = qwen2.quantized_lm(quantize_lm_params_w4(model.model.lm.state_dict()),
                             torch.bfloat16, "cuda")
    head_w4 = quantize_linear_w4(model.model.lm.lm_head.t())   # the head_w4 shape, for 7a
    torch.cuda.synchronize()
    nbytes = {k: v.numel() * v.element_size() for k, v in qlm.state_dict().items()}
    step_bytes = sum(v for k, v in nbytes.items() if not k.startswith("embed."))
    log(f"int4 LM: quantize_lm_params_w4 on the card in {time.perf_counter() - t0:.1f}s; "
        f"{sum(nbytes.values()) / 1e9:.3f} GB ({step_bytes / 1e9:.3f} GB read per decode step: "
        f"w4 layers, int8 head, norms, biases; the int8 embedding is gathered)")
    check(k6.suffix_supported(qwen2.split_stacked_w4(qlm.layers), lm_cfg),
          "the 7B int4 tree is not eligible for the suffix path")

    res = w4_kernel_phase(k5, k6, qlm, head_w4)
    del head_w4

    int4 = dataclasses.replace(model, model=af3.AF3Model(model.model.encoder, model.model.adaptor,
                                                         qlm),
                               history=[], last_output=None, last_processor_s=None)
    from audio_flamingo_tpu_torch.ops.kernels import w8a16_matmul as k4

    from audio_flamingo_tpu_torch.runtime import generate as gen

    counters = {"K2": fa.LAUNCHES, "K5": k5.LAUNCHES, "K6A": k6.LAUNCHES_A,
                "K6B": k6.LAUNCHES_B, "K4": k4.LAUNCHES}
    n_layers = lm_cfg.num_layers
    runs = []
    for i in range(3):
        for c in counters.values():
            c.reset()
            c.timing = True     # the prefill's launches; the replays' are profiled below
        torch.cuda.reset_peak_memory_stats()
        text, wall, split = timed_generate(int4, sound=wav, prompt="What do you hear?",
                                           max_new_tokens=32)
        out = int4.last_output
        run = dict(ids=out.tokens[0, : int(out.lengths[0])].tolist(), steps=out.decode_steps,
                   tps=out.decode_steps / out.decode_s, decode_s=out.decode_s,
                   proc=int4.last_processor_s, ttft=out.ttft_s, wall=wall,
                   capture_s=out.capture_s, first_logits=out.first_logits,
                   peak=torch.cuda.max_memory_allocated() / 2**30,
                   **{name: (c.count, dict(c.shapes), c.device_ms()) for name, c in counters.items()})
        for c in counters.values():
            c.timing = False
            c.reset()
        steps = run["steps"]
        warm_step = int(out.capture_s > 0)   # the capture's eager step
        log(f"int4 generate #{i + 1}: ids={run['ids'][:8]}... ({len(run['ids'])}) {split}; "
            f"decode {run['tps']:.1f} tok/s ({steps} steps, the captured step replayed; "
            f"capture {out.capture_s:.2f}s outside ttft and decode); launches K2 "
            f"{run['K2'][0]}, K5 {run['K5'][0]}, K6 A {run['K6A'][0]}, K6 B {run['K6B'][0]}, "
            f"K4 (the int8 head) {run['K4'][0]}; peak GPU memory {run['peak']:.2f} GiB")
        check(steps >= 1, "the int4 generate made no decode step")
        k2_expected = model.cfg.encoder.num_layers + n_layers   # one window + the prefill
        check(run["K2"][0] == k2_expected,
              f"int4 path: K2 launches {run['K2'][0]} != {k2_expected}")
        n_qkv = (lm_cfg.num_heads + 2 * lm_cfg.num_kv_heads) * lm_cfg.resolved_head_dim()
        check(run["K5"][1] == {(1, lm_cfg.hidden_size, n_qkv, True): steps + warm_step},
              f"int4 path: K5 launches {run['K5'][1]} != one seed qkv per decode step")
        check(run["K6A"][0] == n_layers * (steps + warm_step)
              and run["K6B"][0] == n_layers * (steps + warm_step),
              f"int4 path: K6 launches A {run['K6A'][0]}, B {run['K6B'][0]} != "
              f"{n_layers} each per decode step x {steps} (+ {warm_step} warm-up step)")
        check(run["K4"][0] == steps + warm_step + 1,
              f"int4 path: K4 launches {run['K4'][0]} != one int8 head per decode step and "
              f"the prefill's")
        check(bool(torch.isfinite(out.first_logits).all()), "int4 prefill logits not finite")
        check(all(0 <= t < lm_cfg.vocab_size for t in run["ids"]), "int4 ids out of vocab")
        runs.append(run)
    check(all(r["ids"] == runs[0]["ids"] for r in runs),
          f"int4 greedy ids differ: {[r['ids'] for r in runs]}")
    check(runs[0]["capture_s"] > 0 and runs[1]["capture_s"] == runs[2]["capture_s"] == 0,
          "the int4 path did not capture its step once and reuse it")
    held = gen.held_bytes()
    log(f"int4 path: held captured steps {held['steps']}: cache {held['cache'] / 2**20:.1f} MiB, "
        f"state {held['state'] / 2**20:.2f} MiB, graph pools {held['graph'] / 2**20:.1f} MiB")

    # the captured step against the eager one on the same (unpadded) prompt
    batch = int4.processor(messages=[{"role": "user", "content": "<sound>What do you hear?"}],
                           audios=[wav])
    ids = torch.as_tensor(batch["ids"], device="cuda").long()
    t_ids = ids.shape[1]
    capacity = -(-(t_ids + 32) // 128) * 128
    spec = gen.DecodeSpec(max_new_tokens=32, eos_token_id=int4.eos_token_id)

    def start(st, generator):
        _, logits = gen.prefill(int4.model, int4.cfg, ids, batch["mels"], capacity,
                                cache=st.cache)
        gen.start_decode(st, spec, logits, ids, t_ids, generator)

    cmp = graph_against_eager(
        "7b int4 LM, the 30 s prompt", qlm, lm_cfg, spec,
        lambda: qwen2.init_cache(lm_cfg, 1, capacity, torch.bfloat16, "cuda"), start, 31,
        counters, keep_inputs=("K5", "K6A", "K6B"),
        groups={"K5": ("K5",), "K6": ("K6A", "K6B"), "K4": ("K4",)})
    captured = cmp["inputs"]
    per_step = cmp["prof"]["groups"]
    check(per_step["K5"][0] == 1 and per_step["K6"][0] == 2 * n_layers and per_step["K4"][0] == 1,
          f"7b: one replay holds {per_step} kernels, not 1 K5 + {n_layers} + {n_layers} K6 + 1 K4")
    # each kernel's device time in the path: the prefill's events + the replays' profile
    # (a layer runs suffix A, then B: the K6 kernels alternate)
    replays = cmp["prof"]["replays"]
    k6_a, k6_b = (sum(cmp["prof"]["ordered"]["K6"][i::2]) / replays for i in (0, 1))
    for run in runs:
        for name, ms in (("K5", per_step["K5"][1]), ("K6A", k6_a), ("K6B", k6_b),
                         ("K4", per_step["K4"][1])):
            count, shapes, events_ms = run[name]
            run[name] = (count, shapes, events_ms + ms * run["steps"])
    warm = runs[1]
    a, b = warm["first_logits"].double(), bf16_logits.double()
    cos = F.cosine_similarity(a, b, dim=-1).min().item()
    log(f"int4 warm run: user TTFT {(warm['proc'] + warm['ttft']) * 1e3:.1f} ms = processor "
        f"{warm['proc'] * 1e3:.1f} ms + ttft {warm['ttft'] * 1e3:.1f} ms; decode "
        f"{warm['tps']:.1f} tok/s = {warm['decode_s'] / warm['steps'] * 1e3:.2f} ms/step "
        f"(captured step: {cmp['graph_ms']:.3f} ms/step in the graph against "
        f"{cmp['eager_ms']:.3f} ms/step eager, 7b's comparison) "
        f"against a bound of {step_bytes / PEAK_BYTES * 1e3:.3f} ms/step "
        f"({step_bytes / 1e9:.3f} GB at {PEAK_BYTES / 1e12:.2f} TB/s, "
        f"{PEAK_BYTES / step_bytes:.0f} tok/s); kernels per decode step (profiled replay) K5 "
        f"{warm['K5'][2] / warm['steps']:.3f} ms, K6 A {warm['K6A'][2] / warm['steps']:.3f} ms, "
        f"K6 B {warm['K6B'][2] / warm['steps']:.3f} ms, K4 (the int8 head) "
        f"{warm['K4'][2] / (warm['steps'] + 1):.3f} ms; int4 vs bf16 prefill logits "
        f"cosine {cos:.4f} (not gated: quantization error on random weights)")

    # the int8 head's per-step cost: K4, against the library route's bf16 copy + cuBLAS
    h = torch.randn((1, lm_cfg.hidden_size), device="cuda").bfloat16()
    unembed_ms = time_ms(lambda: qwen2.unembed(qlm, h))
    route_ms = time_ms(library_route_call(h, qlm.lm_head["w_q"], qlm.lm_head["scale"],
                                          torch.float32))
    convert_ms = time_ms(lambda: qlm.lm_head["w_q"].to(torch.bfloat16))
    lib, why = int8pack_call(h, qlm.lm_head["w_q"], qlm.lm_head["scale"])
    lib_ms = f"{time_ms(lib):.4f} ms" if lib else f"none ({why})"
    del lib
    log(f"int8 head unembed [1,{lm_cfg.hidden_size}] x {list(qlm.lm_head['w_q'].shape)} on K4: "
        f"{unembed_ms:.4f} ms per step; the library route {route_ms:.4f} ms, of which the "
        f"int8 -> bf16 copy of the codes {convert_ms:.4f} ms; its bound "
        f"{(nbytes['lm_head.w_q'] + nbytes['lm_head.scale']) / PEAK_BYTES * 1e3:.4f} ms; "
        f"torch._weight_int8pack_mm on the same codes: {lib_ms}")

    # the path's step's own launches (the eager step of the comparison above, which the
    # graph replays), every one replayed on its captured inputs
    x0, w_p0, gscale0, layer0 = captured["K5"][0]
    lib, why = int4pack_call(x0, w_p0[layer0], gscale0[layer0])
    k5_tot = dict(err=0.0, ratio=0.0, plain_ms=0.0, library_ms=0.0 if lib else None, bound_ms=0.0)
    for x, w_p, gscale, layer in captured["K5"]:
        r = w4_compare(k5.w4a16_matmul_stacked(x, w_p, gscale, layer),
                       k5.w4a16_matmul_reference(x, w_p[layer], gscale[layer]))
        check(r["ratio"] <= 1.0, f"main-path K5 launch: |y - plain| at {r['ratio']:.3f}")
        k5_tot["err"], k5_tot["ratio"] = max(k5_tot["err"], r["err"]), max(k5_tot["ratio"], r["ratio"])
        k5_tot["plain_ms"] += time_ms(lambda: k5.w4a16_matmul_reference(x, w_p[layer],
                                                                       gscale[layer]), 5, 1)
        if lib:   # the library call on the first launch's operands: same shape
            k5_tot["library_ms"] += time_ms(lib, 5, 1)
        b_ms, k5_tot["bound_by"] = w4_bound_ms([k5_shape(w_p, gscale)], x.shape[0], "bfloat16")
        k5_tot["bound_ms"] += b_ms
    del lib
    k6_tot = {}
    for name, fn, plain in (("K6A", k6.w4_suffix_a, k6.w4_suffix_a_reference),
                            ("K6B", k6.w4_suffix_b, k6.w4_suffix_b_reference)):
        launches = captured[name]
        tot = dict(err=0.0, ratio=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0)
        for args in launches:
            for u, v in zip(fn(*args), plain(*args)):
                r = w4_compare(u, v)
                check(r["ratio"] <= 1.0, f"main-path {name} launch: |y - plain| at "
                                         f"{r['ratio']:.3f} of its limit")
                tot["err"], tot["ratio"] = max(tot["err"], r["err"]), max(tot["ratio"], r["ratio"])
            tot["ms"] += time_ms(lambda: fn(*args), 3, 1)
            tot["plain_ms"] += time_ms(lambda: plain(*args), 3, 1)
        x, p1, p2 = launches[0][0], launches[0][3], launches[0][4]
        b_ms, tot["bound_by"] = suffix_bound_ms(p1, p2, x.shape[0], "bfloat16",
                                                gated=name == "K6A")
        tot["bound_ms"] = b_ms * len(launches)
        k6_tot[name] = tot
        log(f"{name} main-path launches ({len(launches)}) replayed: max|y-plain|="
            f"{tot['err']:.3e} (at {tot['ratio']:.3f} of the limit); summed kernel "
            f"{tot['ms']:.3f} ms (in the path {warm[name][2]:.3f} ms), plain "
            f"{tot['plain_ms']:.3f} ms, bound {tot['bound_ms']:.4f} ms ({tot['bound_by']})")
    log(f"K5 main-path launches ({len(captured['K5'])}) replayed: max|y-plain|={k5_tot['err']:.3e} "
        f"(at {k5_tot['ratio']:.3f} of the limit); summed plain {k5_tot['plain_ms']:.3f} ms, "
        f"library {'null (' + why + ')' if k5_tot['library_ms'] is None else f'{k5_tot['library_ms']:.3f} ms'}, "
        f"bound {k5_tot['bound_ms']:.4f} ms; in the path {warm['K5'][2]:.3f} ms")
    del int4, qlm, captured
    log(f"7b: released the held captured steps ({gen.release_graphs() / 2**20:.1f} MiB)")
    return dict(warm=warm, kernels=res, k5=k5_tot, k6=k6_tot, unembed_ms=unembed_ms,
                convert_ms=convert_ms, step_bytes=step_bytes, cos=cos, graph=cmp)


def f32_int4_card_vs_cpu_phase(fa, k5, k6) -> None:
    """7c. The same seed weights, int4-quantized on the CPU, at f32 on the CPU and on the
    card: full width, 2 encoder + 2 LM layers. af3.logits on a 30 s clip within 1e-4 (the
    prefill's m = 840 rows take the dequant route) and a greedy 8-token generate
    token-exact and not all one token, the card through K2, K5 and K6."""
    from audio_flamingo_tpu_torch.api import AudioFlamingo
    from audio_flamingo_tpu_torch.config import AF3Config
    from audio_flamingo_tpu_torch.models import af3, qwen2
    from audio_flamingo_tpu_torch.ops.quant4 import quantize_lm_params_w4

    full = AF3Config()
    cfg = with_flash(dataclasses.replace(
        full, encoder=dataclasses.replace(full.encoder, num_layers=2),
        lm=dataclasses.replace(full.lm, num_layers=2)), True)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False      # the conv stem in full f32 (README)
    try:
        t0 = time.perf_counter()
        cpu = f32_base(cfg)
        tree = quantize_lm_params_w4(cpu.model.lm.state_dict())
        # Queue 3 item 8: the same tree quantized on the card, codes and group scales equal
        lm_state = {k: v.cuda() for k, v in cpu.model.lm.state_dict().items()}
        card_tree = qwen2.flatten(quantize_lm_params_w4(lm_state))
        del lm_state
        flips = {k: int((v.cpu() != card_tree[k].cpu()).sum())
                 for k, v in qwen2.flatten(tree).items()}
        del card_tree
        log(f"7c: quantize_lm_params_w4 on the card vs the CPU: {sum(flips.values())} values "
            f"differ over {len(flips)} tensors")
        check(not any(flips.values()), f"7c: int4 codes or scales differ card vs CPU: "
                                       f"{ {k: v for k, v in flips.items() if v} }")
        cpu = dataclasses.replace(cpu, model=af3.AF3Model(
            cpu.model.encoder, cpu.model.adaptor, qwen2.quantized_lm(tree, torch.float32, "cpu")))
        state = {k: v for k, v in cpu.model.state_dict().items() if not k.startswith("lm.")}
        state.update(qwen2.flatten(tree, "lm."))
        del tree
        card = AudioFlamingo.from_state_dict(cpu.cfg, state, cpu.processor.tokenizer,
                                             torch.float32, device="cuda")
        del state
        check(isinstance(card.model.lm, qwen2.QuantQwen2), "card LM is not the int4 tree")
        log(f"f32 int4 card vs CPU: 2 + 2 layers at full width, int4 LM quantized on the CPU "
            f"and moved to the card in {time.perf_counter() - t0:.1f}s")
        rng = np.random.default_rng(0)
        t = np.arange(30 * 16000) / 16000.0
        wav = (0.3 * np.sin(2 * np.pi * 440.0 * t)
               + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
        msgs = [{"role": "user", "content": "<sound>What do you hear?"}]
        bc = cpu.processor(messages=msgs, audios=[wav])
        bg = card.processor(messages=msgs, audios=[wav])
        check(np.array_equal(bc["ids"], bg["ids"]), "processor ids differ card vs CPU")
        lc = af3.logits(cpu.model, cpu.cfg, torch.as_tensor(bc["ids"]).long(), bc["mels"])
        fa.LAUNCHES.reset()
        lg = af3.logits(card.model, card.cfg, torch.as_tensor(bg["ids"], device="cuda").long(),
                        bg["mels"]).cpu()
        err = (lg - lc).abs().max().item()
        log(f"f32 int4 af3.logits {tuple(lc.shape)}: max|card - CPU| = {err:.3e} (limit "
            f"{LOGITS_TOL}), max|logit| {lc.abs().max().item():.3f}; K2 launches "
            f"{fa.LAUNCHES.count}")
        check(fa.LAUNCHES.count == 4, f"f32 int4 logits made {fa.LAUNCHES.count} K2 launches")
        check(err <= LOGITS_TOL, f"f32 int4 logits card vs CPU {err} > {LOGITS_TOL}")
        cpu.generate(prompt="What do you hear?", max_new_tokens=8)
        for c in (fa.LAUNCHES, k5.LAUNCHES, k6.LAUNCHES_A, k6.LAUNCHES_B):
            c.reset()
        _, _, split = timed_generate(card, prompt="What do you hear?", max_new_tokens=8)
        counts = [c.count for c in (fa.LAUNCHES, k5.LAUNCHES, k6.LAUNCHES_A, k6.LAUNCHES_B)]
        ids = [m.last_output.tokens[0, : int(m.last_output.lengths[0])].tolist()
               for m in (cpu, card)]
        log(f"f32 int4 greedy 8 tokens: CPU {ids[0]}, card {ids[1]} (card {split}); launches "
            f"K2 {counts[0]}, K5 {counts[1]}, K6 A {counts[2]}, K6 B {counts[3]}")
        check(ids[0] == ids[1], "f32 int4 greedy ids differ card vs CPU")
        check(len(set(ids[0])) > 1, f"f32 int4 greedy ids are all one token: {ids[0]}")
        check(all(n > 0 for n in counts), f"f32 int4 generate missed a kernel: {counts}")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


PAGED_F32_TOL = 1e-5                 # K3 f32: o/l to 1e-5 max|plain|; m, l to 1e-5 relative
#                                      (m relative to max(|m|, 1))
PAGED_BF16_TOL = (2.0 ** -7, 1e-3)   # K3 bf16: |o/l - plain| <= 2^-7 |plain| + 1e-3
PAGED_NO_LIBRARY = ("none (no single PyTorch call computes it: SDPA over a gathered copy "
                    "has no block table and returns no (o, m, l))")
ENGINE = dict(num_rows=4, num_blocks=88, block_size=128, max_blocks_per_seq=32, chunk=16,
              eos_token_id=151_645)    # bench.py:486-488, the JAX mixed-workload engine


def kernels_per_call(fn) -> int:
    """Device kernels one call of fn launches, as torch.profiler sees them in the call's
    annotated range, after one call in the same window that is not counted (the profiler
    can miss the first kernels it sees; copies and memsets left out). A window whose trace
    holds no device range for the annotation (seen once in a full run, at K6 m = 8) is
    taken again, up to three windows."""
    from torch.profiler import ProfilerActivity, profile, record_function

    label, windows = "counted call", 3
    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            with record_function(label):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        span = next((e.time_range for e in events if e.name == label), None)
        if span is not None:
            return sum(1 for e in events if e.name != label
                       and span.start <= e.time_range.start < span.end
                       and "memcpy" not in e.name.lower() and "memset" not in e.name.lower())
    check(False, f"torch.profiler shows no device range of the counted call in {windows} "
                 "windows")


def graph_ms(fn, reps: int = 20, calls: int = 1) -> float:
    """Device time of fn alone: fn captured ``calls`` times in one CUDA graph, the replay
    timed with CUDA events (median) and divided by ``calls``, so the host's launch overhead
    is left out (and, over many calls, the graph's own launch too)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_ms(graph.replay, reps, 3) / calls


def paged_bound_ms(lengths, block: int, max_pages: int, q_shape, q_dtype, kv_dtype) -> tuple:
    """Least time for one K3 launch on these lengths: the K and V rows of the keys below
    each row's length (and their int8 scales), the table entries read, q, and the (o, m, l)
    written, over the HBM rate, against 4 nkv g hd per visible key (QK and PV) at the q
    dtype's peak. Keys past a row's length in its last page are masked and not counted."""
    b, nkv, g, hd = q_shape
    pages = sum(min(-(-int(n) // block), max_pages) for n in lengths)
    keys = sum(min(int(n), max_pages * block) for n in lengths)
    kv_item = torch.empty((), dtype=kv_dtype).element_size()
    q_item = torch.empty((), dtype=q_dtype).element_size()
    nbytes = (keys * nkv * hd * kv_item * 2
              + (keys * nkv * 4 * 2 if kv_dtype == torch.int8 else 0)
              + pages * 4 + b * 4 + b * nkv * g * hd * q_item + b * nkv * g * (hd + 2) * 4)
    flops = 4.0 * nkv * g * hd * keys
    t_ops = flops / PEAK_FLOPS[str(q_dtype).split(".")[-1]]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def paged_compare(pa, args: tuple, k_cur=None, v_cur=None) -> dict:
    """One K3 launch against its plain version on the same inputs. f32: the normalized
    output o/l within 1e-5 max|plain|, m and l within 1e-5 relative (m to max(|m|, 1),
    since a row's max score can sit near 0); bf16: o/l per
    element within 2^-7 |plain| + 1e-3, m and l as in f32. Rows with no key must give
    exactly o = 0, l = 0, m = NEG_INF; with (k_cur, v_cur) the merged output is held to
    the same limits on every row. ratio: the largest error over its limit (<= 1)."""
    q, k, v, tables, lengths, layer, ks, vs, scale = args
    o, m, l = pa.paged_attention(q, k, v, tables, lengths, layer, k_scale=ks, v_scale=vs,
                                 scale=scale)
    o_p, m_p, l_p = pa.paged_attention_plain(q, k, v, tables, lengths, layer, k_scale=ks,
                                             v_scale=vs, scale=scale)
    r = k3_held(pa, q.dtype, (o, m, l), (o_p, m_p, l_p))
    if k_cur is not None:
        merged = pa.merge_current_token(q, k_cur, v_cur, o, m, l, scale=scale)
        merged_p = pa.merge_current_token(q, k_cur, v_cur, o_p, m_p, l_p, scale=scale)
        err, ratio = _k3_within(q.dtype, merged, merged_p)
        r.update(merged_err=err, ratio=max(r["ratio"], ratio))
    return r


def _k3_within(q_dtype, x, ref) -> tuple:
    """(max |x - ref|, its ratio to K3's limit for q's dtype)."""
    diff = (x - ref).abs()
    if q_dtype == torch.float32:
        return diff.max().item(), diff.max().item() / (PAGED_F32_TOL * ref.abs().max().item()
                                                         + 1e-30)
    rel, floor = PAGED_BF16_TOL
    return diff.max().item(), (diff / (rel * ref.abs() + floor)).max().item()


def k3_held(pa, q_dtype, got: tuple, plain: tuple) -> dict:
    """K3's (o, m, l) against the plain version's, as paged_compare holds them: o/l on rows
    with keys within K3's limit, m and l within PAGED_F32_TOL relative, rows with no key
    exactly (0, NEG_INF, 0). Returns o_err, err, ratio (its largest over its limit)."""
    (o, m, l), (o_p, m_p, l_p) = got, plain
    keys = l_p > 0
    r = dict(o_err=(o - o_p).abs().max().item(), ratio=0.0, err=0.0)
    if bool(keys.any()):
        err, ratio = _k3_within(q_dtype, (o / l.clamp(min=1e-30)[..., None])[keys],
                                (o_p / l_p.clamp(min=1e-30)[..., None])[keys])
        # m relative to max(|m|, 1): a row's max score can sit near 0 at O(1) scores
        stat = max(((m - m_p).abs() / m_p.abs().clamp(min=1.0))[keys].max().item(),
                   ((l - l_p).abs() / l_p.clamp(min=1e-30))[keys].max().item())
        r.update(err=err, ratio=max(ratio, stat / PAGED_F32_TOL), stat=stat)
    empty = ~keys
    check(bool((o[empty] == 0).all() and (l[empty] == 0).all()
               and (m[empty] == pa.NEG_INF).all()), "K3: a row with no key is not (0, NEG_INF, 0)")
    return r


def paged_kernel_phase(pa) -> dict:
    """8a. K3 alone at the 7B shapes: q [4, 4, 7, 128], stacked pools [28, 88, 128, 4, 128]
    with the layer chosen in the kernel, tables shuffled over pages 1..87 (0 is the trash
    page); rows of {548, 3848, 1, 0} tokens (partial pages, a one-token row, an empty
    row) held to the plain version at layers 0 and 27 with a current token merged, for
    q f32 over f32, bf16 and int8 pools and q bf16 over bf16 and int8 pools; timed at
    layer 5 on those rows and on the engine's mixed rows {548, 548, 3848, 3848}, beside the
    same launch with one part per row (no page split)."""
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
    shapes = {"check": [548, 3848, 1, 0], "mixed": [548, 548, 3848, 3848]}
    results = {}
    for q_dtype, kv_name in ((torch.float32, "float32"), (torch.float32, "bfloat16"),
                             (torch.float32, "int8"), (torch.bfloat16, "bfloat16"),
                             (torch.bfloat16, "int8")):
        q = q32.to(q_dtype)
        if kv_name == "int8":
            pools = (k8, v8, ks, vs)
        else:
            dt = getattr(torch, kv_name)
            pools = (kf.to(dt), vf.to(dt), None, None)
        qn = str(q_dtype).split(".")[-1]
        worst = dict(err=0.0, ratio=0.0, o_err=0.0)
        tables, lengths = tables_for(shapes["check"])
        for layer in (0, n_layers - 1):
            args = (q, pools[0], pools[1], tables, lengths, layer, pools[2], pools[3], None)
            r = paged_compare(pa, args, k_cur, v_cur)
            check(r["ratio"] <= 1.0, f"K3 q {qn} pool {kv_name} layer {layer}: at "
                                     f"{r['ratio']:.3f} of its limit")
            for key in worst:
                worst[key] = max(worst[key], r[key])
        for name, lens in shapes.items():
            tables, lengths = tables_for(lens)
            args = (q, pools[0], pools[1], tables, lengths, 5, pools[2], pools[3], None)
            call = lambda: pa.paged_attention(*args[:6], k_scale=args[6], v_scale=args[7])
            plain = lambda: pa.paged_attention_plain(*args[:6], k_scale=args[6], v_scale=args[7])
            r = dict(worst, ms=time_ms(call), plain_ms=time_ms(plain, 3, 1), library_ms=None,
                     graph_ms=graph_ms(call, calls=10))   # the graph's own launch shared by 10
            split = pa.kernel_parts      # the same launch without the page split, beside it
            pa.kernel_parts = lambda *a: 1
            try:
                r["one_part_ms"] = time_ms(call)
            finally:
                pa.kernel_parts = split
            r["bound_ms"], r["bound_by"] = paged_bound_ms(lens, block, mp, tuple(q.shape),
                                                          q_dtype, pools[0].dtype)
            parts = pa.kernel_parts(len(lens), nkv, mp, q.device, q.dtype, pools[0].dtype)
            log(f"K3 q {qn:8s} pool {kv_name:8s} rows {lens}: max|o/l - plain| "
                f"{r['err']:.3e} (at {r['ratio']:.3f} of its limit, merged rows included) "
                f"{parts} parts (from the V pass's occupancy on this card) "
                f"ms={r['ms']:.4f} (the call; device alone, 10 calls in a CUDA graph: "
                f"{r['graph_ms']:.4f}; one part per row, no split: {r['one_part_ms']:.4f}) "
                f"plain_ms={r['plain_ms']:.4f} library_ms={PAGED_NO_LIBRARY} "
                f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}); "
                f"{r['bound_ms'] / r['ms'] * 100:.2f} % of the bound with the wrapper, "
                f"{r['bound_ms'] / r['graph_ms'] * 100:.2f} % as device time")
            results[(qn, kv_name, name)] = r
        del pools
    del kf, vf, k8, v8, ks, vs
    torch.cuda.empty_cache()
    return results


class ChunkProbe:
    """Stands in for paged_engine.paged_decode_chunk while the engine runs: counts chunks
    and the plain attention calls made inside them; on request it measures each chunk's
    peak memory over what was allocated before it, runs one chunk under
    torch.cuda.set_sync_debug_mode("error") (a host sync inside raises), and captures
    one chunk's K3 launches and replays each against the plain version right after the
    chunk (before any page can be reused)."""

    def __init__(self, pe, qwen2, pa):
        self.pe, self.pa, self.qwen2 = pe, pa, qwen2
        self.real_chunk, self.real_gqa = pe.paged_decode_chunk, qwen2.gqa_attention
        self.reset()

    def reset(self, memory=False, sync_chunk=None, replay_chunk=None, plain_step=False):
        self.chunks, self.steps, self.gqa, self.gqa_in_chunks = 0, 0, 0, 0
        self.memory, self.sync_chunk, self.replay_chunk = memory, sync_chunk, replay_chunk
        self.mem_delta, self.replay, self.plain_step = 0, None, plain_step

    def __enter__(self):
        self.pe.paged_decode_chunk = self
        self.qwen2.gqa_attention = self._gqa
        return self

    def __exit__(self, *exc):
        self.pe.paged_decode_chunk = self.real_chunk
        self.qwen2.gqa_attention = self.real_gqa

    def _gqa(self, *a, **kw):
        self.gqa += 1
        return self.real_gqa(*a, **kw)

    def __call__(self, *args, chunk: int, **kw):
        index = self.chunks
        self.chunks += 1
        self.steps += chunk
        gqa0 = self.gqa
        counter = self.pa.LAUNCHES
        # the captured chunk holds every launch's inputs, so its memory is not measured
        memory = self.memory and index != self.replay_chunk
        if memory:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        if index == self.replay_chunk:
            ms0 = counter.device_ms()
            counter.capture = True
        if index == self.sync_chunk:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = self.real_chunk(*args, chunk=chunk, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if memory:
            torch.cuda.synchronize()
            self.mem_delta = max(self.mem_delta, torch.cuda.max_memory_allocated() - base)
        self.gqa_in_chunks += self.gqa - gqa0
        if index == self.replay_chunk:
            counter.capture = False
            launches = list(counter.inputs)
            counter.inputs.clear()
            self.replay = self._replay(launches, counter.device_ms() - ms0, chunk)
        return out

    def _replay(self, launches, path_ms: float, steps: int) -> dict:
        """The chunk's K3 launches held to the plain version (k3_hold_batched), replayed in
        one CUDA graph (device ms) beside their bounds; the plain version is timed on each
        launch in the third run only (the kernels line's row), or with ``plain_step`` on
        each launch of the chunk's first step, times its steps (``plain_ms``)."""
        counter = self.pa.LAUNCHES
        timing, counter.timing = counter.timing, False
        tot = dict(steps=steps, path_ms=path_ms,
                   **k3_hold_batched(self.pa, launches, "main-path K3 launch"))
        tot.update(ms=launches_graph_ms(self.pa, launches), **launch_bounds(launches))
        if self.plain_step:
            first = [a for a in launches if a[4] is launches[0][4]]
            tot["plain_step_ms"] = launch_sums(self.pa, first)["plain_ms"]
            tot["plain_ms"] = tot["plain_step_ms"] * len(launches) / len(first)
        counter.timing = timing
        return tot


def launches_graph_ms(pa, launches) -> float:
    """Device time of a run's K3 launches: every kept launch replayed on its own inputs,
    all of them captured in one CUDA graph (median of 3 replays)."""
    def run():
        for q, k, v, tables, lengths, layer, ks, vs, scale in launches:
            pa.paged_attention(q, k, v, tables, lengths, layer, k_scale=ks, v_scale=vs,
                               scale=scale)
    return graph_ms(run, reps=3)


def launch_bounds(launches) -> dict:
    """The captured K3 launches' bounds, summed: bound_ms, bound_by."""
    tot, by = dict(bound_ms=0.0), set()
    for q, k, v, tables, lengths, layer, ks, vs, scale in launches:
        b_ms, b_by = paged_bound_ms(lengths.tolist(), k.shape[2], tables.shape[1],
                                    tuple(q.shape), q.dtype, k.dtype)
        tot["bound_ms"] += b_ms
        by.add(b_by)
    tot["bound_by"] = "operations" if by == {"operations"} else "bytes"
    return tot


def launch_sums(pa, launches) -> dict:
    """K3's plain version timed on each captured launch's inputs (one call each), and the
    launches' bounds, summed: plain_ms, bound_ms, bound_by."""
    plain = 0.0
    for q, k, v, tables, lengths, layer, ks, vs, scale in launches:
        plain += time_ms(lambda: pa.paged_attention_plain(
            q, k, v, tables, lengths, layer, k_scale=ks, v_scale=vs, scale=scale), 1, 0)
    return dict(plain_ms=plain, **launch_bounds(launches))


def k2_launch_sums(fa, launches) -> dict:
    """K2's captured launches of a serving run, each held against the plain version
    (over row blocks) and its plain version and SDPA timed once on its inputs: summed
    plain_ms, library_ms and bound_ms, with the largest error."""
    tot, by = dict(err=0.0, ratio=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0), set()
    plain = plain_blocked(fa, 1024)
    for q, k, v, kw in launches:
        r = compare(fa, q, k, v, kw, plain=plain)
        check_compare("serving K2 launch", r)
        tot["err"], tot["ratio"] = max(tot["err"], r["err"]), max(tot["ratio"], r["ratio"])
        tot["plain_ms"] += time_ms(lambda: plain(q, k, v, **kw), 1, 0)
        tot["library_ms"] += time_ms(sdpa_call(q, k, v, kw), 1, 1)
        b_ms, b_by = attention_bound_ms(tuple(q.shape), tuple(k.shape), kw["causal"],
                                        kw["q_offset"], r["dtype"])
        tot["bound_ms"] += b_ms
        by.add(b_by)
    tot["bound_by"] = "operations" if by == {"operations"} else "bytes"
    return tot


def mixed_workload(model, wav) -> list:
    """The JAX bench's mixed workload (bench.py:452-462): 3 prompts of 500 and 3 of 3800
    random ids, interleaved, plus one request with a 30 s clip through the processor."""
    rng = np.random.default_rng(0)
    specs = []
    for i in range(3):
        specs.append((f"s{i}", rng.integers(0, 150_000, (1, 500)).astype(np.int32), None))
        specs.append((f"l{i}", rng.integers(0, 150_000, (1, 3800)).astype(np.int32), None))
    batch = model.processor(messages=[{"role": "user", "content": "<sound>What do you hear?"}],
                            audios=[wav])
    specs.append(("clip", np.asarray(batch["ids"], np.int32), batch["mels"]))
    return specs


def serve(engine, specs, max_new_tokens: int) -> tuple:
    """Submit every request, run the engine to the end: (results, wall seconds)."""
    from audio_flamingo_tpu_torch.runtime.engine import Request

    for rid, ids, mels in specs:
        engine.submit(Request(request_id=rid, ids=ids.copy(), mels=mels,
                              max_new_tokens=max_new_tokens))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = engine.run_until_done()
    torch.cuda.synchronize()
    return results, time.perf_counter() - t0


THIRD_RUN_TOKENS = 8    # 8b's third run (the K3 row's launches), short to keep the script in its limit
WARM_TOKENS = 16        # the warm-up instances' tokens (8b, 12c): they measure nothing
SERVE_TOKENS = 32       # 8b's and 12c's measured runs (bench.py's mixed workload asks 48,
                        # the script's before phase 16)


def paged_engine_phase(model, fa, pa, probe, wav, kv_dtype) -> dict:
    """8b. The mixed workload on PagedEngine at full width (bf16 LM, random weights),
    bench.py's engine settings, greedy, SERVE_TOKENS each: a warm-up instance, the measured
    run (K2 and K3 launches counted from 0 and timed), a second run on a fresh engine
    with the first chunk's K3 launches replayed against the plain version, the second
    under sync-debug "error", and every chunk's peak memory over its start, and (bf16 pool
    only, the kernels line's K3 row; the int8 pool's took about 100 s and was cut to make
    room for phase 12) a third of THIRD_RUN_TOKENS tokens a request (its ids the first
    run's first ones) whose every K3 launch is timed in the path and kept, so that the
    plain version's time and the bound are summed over the same launches (kept inputs
    hold memory, so neither the measured run nor the second keeps them all)."""
    from audio_flamingo_tpu_torch.runtime.paged_engine import PagedEngine

    lm_cfg = model.cfg.lm
    name = "int8" if kv_dtype is torch.int8 else "bf16"
    specs = mixed_workload(model, wav)
    make = lambda: PagedEngine(model=model.model, cfg=model.cfg, kv_dtype=kv_dtype, **ENGINE)
    serve(make(), specs[:2], WARM_TOKENS)                      # warm-up instance
    for c in (fa.LAUNCHES, pa.LAUNCHES):
        c.reset()
        c.timing = True
    probe.reset()
    torch.cuda.reset_peak_memory_stats()
    eng = make()
    results, wall = serve(eng, specs, SERVE_TOKENS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    k3_ms, k2_ms = pa.LAUNCHES.device_ms(), fa.LAUNCHES.device_ms()
    run = dict(wall=wall, tokens=sum(len(v) for v in results.values()), steps=probe.steps,
               chunks=probe.chunks, k3=pa.LAUNCHES.count, k3_shapes=dict(pa.LAUNCHES.shapes),
               k2=fa.LAUNCHES.count, k3_ms=k3_ms, k2_ms=k2_ms, gqa=probe.gqa_in_chunks,
               ttft=sorted(m["ttft_s"] for m in eng.request_metrics.values()), peak=peak)
    for c in (fa.LAUNCHES, pa.LAUNCHES):
        c.timing = False
    pool_bytes = sum(t.numel() * t.element_size() for t in
                     (eng.cache.k, eng.cache.v, eng.cache.k_scale, eng.cache.v_scale)
                     if t is not None)
    check(set(results) == {rid for rid, _, _ in specs} and all(results.values()),
          f"paged {name}: not every request finished: {sorted(results)}")
    check(len(eng.allocator.free) == eng.num_blocks - 1, f"paged {name}: pool not released "
                                                         f"({len(eng.allocator.free)} free)")
    check(run["k3"] == lm_cfg.num_layers * run["steps"] and run["steps"] > 0,
          f"paged {name}: {run['k3']} K3 launches for {run['steps']} decode steps")
    check(run["gqa"] == 0, f"paged {name}: {run['gqa']} plain attention calls inside decode")
    n_prefill = len(specs)
    k2_want = lm_cfg.num_layers * n_prefill + model.cfg.encoder.num_layers
    check(run["k2"] == k2_want, f"paged {name}: {run['k2']} K2 launches, not {k2_want} "
                                "(28 per fresh prefill + 32 for the clip's window)")
    med = statistics.median(run["ttft"])
    log(f"paged {name} pool, mixed workload ({len(specs)} requests, 4 rows, 88 x 128-token "
        f"pages): {run['tokens']} tokens in {wall:.3f} s = {run['tokens'] / wall:.1f} tok/s; "
        f"TTFT median {med:.3f} s, max {run['ttft'][-1]:.3f} s (from submit); "
        f"{run['chunks']} chunks, {run['steps']} decode steps; K3 {run['k3']} launches "
        f"({run['k3'] / run['steps']:.0f} per step), {run['k3_ms']:.2f} ms = "
        f"{run['k3_ms'] / run['steps']:.3f} ms per step; K2 {run['k2']} launches "
        f"{run['k2_ms']:.1f} ms; plain attention calls in decode {run['gqa']}; pool "
        f"{pool_bytes / 1e6:.1f} MB; peak GPU memory {peak:.2f} GiB")

    probe.reset(memory=True, sync_chunk=1, replay_chunk=0)
    pa.LAUNCHES.reset()
    pa.LAUNCHES.timing = True
    eng2 = make()
    again, wall2 = serve(eng2, specs, SERVE_TOKENS)
    pa.LAUNCHES.timing = False
    pa.LAUNCHES.reset()
    rep = probe.replay
    check(again == results, f"paged {name}: greedy ids differ between two runs")
    check(len(eng2.allocator.free) == eng2.num_blocks - 1, f"paged {name}: pool not released")
    layer_bytes = pool_bytes // lm_cfg.num_layers
    check(probe.mem_delta < layer_bytes, f"paged {name}: a decode chunk allocated "
                                         f"{probe.mem_delta / 1e6:.1f} MB over its start, more "
                                         f"than one layer's pool ({layer_bytes / 1e6:.1f} MB)")
    log(f"paged {name}: second run identical ids ({wall2:.3f} s with the replay); a decode "
        f"chunk's peak over its start {probe.mem_delta / 1e6:.2f} MB at most (chunks 1 on; "
        f"one layer's pool "
        f"{layer_bytes / 1e6:.1f} MB); chunk 1 ran under sync-debug 'error' without a host "
        f"sync; chunk 0's {rep['launches']} K3 launches ({rep['steps']} steps) re-run and held "
        f"to the plain version: max|o/l - plain| {rep['err']:.3e} (at {rep['ratio']:.3f} of "
        f"its limit); in the path {rep['path_ms']:.3f} ms = {rep['path_ms'] / rep['steps']:.3f} "
        f"ms per step, replayed in one CUDA graph {rep['ms']:.3f} ms, bound "
        f"{rep['bound_ms']:.4f} ms = {rep['bound_ms'] / rep['steps']:.4f} ms per step "
        f"({rep['bound_by']}), library {PAGED_NO_LIBRARY}")

    if name != "bf16":
        del eng, eng2
        return dict(run=run, replay=rep, full=None, pool_bytes=pool_bytes,
                    tps=run["tokens"] / wall)
    probe.reset()
    for c in (fa.LAUNCHES, pa.LAUNCHES):
        c.reset()
    pa.LAUNCHES.timing = pa.LAUNCHES.capture = True
    fa.LAUNCHES.timing = fa.LAUNCHES.capture = True   # K2's serving row
    third, _ = serve(make(), specs, THIRD_RUN_TOKENS)
    pa.LAUNCHES.timing = pa.LAUNCHES.capture = False
    full = dict(launches=pa.LAUNCHES.count, steps=probe.steps, ms=pa.LAUNCHES.device_ms())
    fa.LAUNCHES.timing = fa.LAUNCHES.capture = False
    path = dict(launches=fa.LAUNCHES.count, ms=fa.LAUNCHES.device_ms())
    captured = list(fa.LAUNCHES.inputs)
    fa.LAUNCHES.reset()
    k2 = {**k2_launch_sums(fa, captured), **path}   # the replays launch K2 again
    fa.LAUNCHES.reset()
    del captured
    check(k2["launches"] == k2_want, f"paged {name}: third run {k2['launches']} K2 launches")
    full["k2"] = k2
    log(f"paged {name}: third run's {k2['launches']} K2 launches (7 fresh prefills x 28 + "
        f"the clip's window x 32): in the path {k2['ms']:.2f} ms; each replayed on its "
        f"inputs: max|o-plain| {k2['err']:.3e} (at {k2['ratio']:.3f} of its limit), "
        f"plain {k2['plain_ms']:.1f} ms, SDPA {k2['library_ms']:.2f} ms, bound "
        f"{k2['bound_ms']:.4f} ms ({k2['bound_by']}), summed")
    check(third == {rid: ids[:THIRD_RUN_TOKENS] for rid, ids in results.items()},
          f"paged {name}: greedy ids differ in the third run")
    check(full["launches"] == lm_cfg.num_layers * full["steps"] == len(pa.LAUNCHES.inputs),
          f"paged {name}: third run {full['launches']} K3 launches for {full['steps']} steps")
    full.update(launch_sums(pa, pa.LAUNCHES.inputs))
    full["graph_ms"] = launches_graph_ms(pa, pa.LAUNCHES.inputs)
    pa.LAUNCHES.reset()
    steps = full["steps"]
    log(f"paged {name}: third run identical ids; all {full['launches']} K3 launches "
        f"({steps} steps): in the path {full['ms']:.3f} ms = {full['ms'] / steps:.4f} ms per "
        f"step (CUDA events around each launch, the host's gaps included); replayed in one "
        f"CUDA graph {full['graph_ms']:.3f} ms = {full['graph_ms'] / steps:.4f} ms per step "
        f"(device time); plain {full['plain_ms']:.3f} ms = {full['plain_ms'] / steps:.3f} ms per step "
        f"(timed on each launch's inputs), bound {full['bound_ms']:.4f} ms = "
        f"{full['bound_ms'] / steps:.5f} ms per step ({full['bound_by']}); "
        f"{full['bound_ms'] / full['ms'] * 100:.2f} % of the bound in the path, "
        f"{full['bound_ms'] / full['graph_ms'] * 100:.2f} % as device time")
    del eng, eng2
    return dict(run=run, replay=rep, full=full, pool_bytes=pool_bytes,
                tps=run["tokens"] / wall)


def prefix_phase(model, probe) -> None:
    """8c. prefix_cache=True: two requests with the same system prompt and 30 s clip and
    different questions, served one after the other; the second must hit the shared pages
    (which cover every audio token) and skip the encoder."""
    from audio_flamingo_tpu_torch.models import af3
    from audio_flamingo_tpu_torch.runtime.paged_engine import PagedEngine

    rng = np.random.default_rng(1)
    t = np.arange(30 * 16000) / 16000.0
    wav = (0.3 * np.sin(2 * np.pi * 330.0 * t) + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    block = ENGINE["block_size"]
    sentence = "Listen to the whole clip, then describe the sound of the music and the speech. "

    def batch(reps, question):
        msgs = [{"role": "system", "content": "You are a careful listener."},
                {"role": "user", "content": f"<sound>{sentence * reps}{question}"}]
        return model.processor(messages=msgs, audios=[wav])

    for reps in range(1, 64):   # shared ids must cover 8 full pages past the audio
        a, b = batch(reps, "What do you hear?"), batch(reps, "Which instruments play?")
        ia, ib = np.asarray(a["ids"][0]), np.asarray(b["ids"][0])
        n = min(ia.size, ib.size)
        common = int(np.argmax(ia[:n] != ib[:n])) if (ia[:n] != ib[:n]).any() else n
        if common > 8 * block:
            break
    audio_end = int(np.nonzero(ib == model.cfg.audio_token_id)[0][-1])
    check(audio_end < 8 * block < common, f"prefix workload: audio ends at {audio_end}, "
                                          f"shared {common} tokens")
    encoded = []
    real = af3.encode_audio
    af3.encode_audio = lambda *x: encoded.append(1) or real(*x)
    try:
        eng = PagedEngine(model=model.model, cfg=model.cfg, prefix_cache=True, **ENGINE)
        probe.reset()
        serve(eng, [("first", np.asarray(a["ids"], np.int32), a["mels"])], 16)
        n_enc = len(encoded)
        serve(eng, [("second", np.asarray(b["ids"], np.int32), b["mels"])], 16)
    finally:
        af3.encode_audio = real
    ttft = [eng.request_metrics[r]["ttft_s"] for r in ("first", "second")]
    log(f"prefix cache: prompts of {ia.size} and {ib.size} tokens sharing {common} (audio "
        f"ends at {audio_end}); store hits {eng.store.hits} pages, misses "
        f"{eng.store.misses}; encoder runs {n_enc} then {len(encoded) - n_enc}; TTFT first "
        f"{ttft[0] * 1e3:.1f} ms, second (hit) {ttft[1] * 1e3:.1f} ms")
    check(eng.store.hits > 0, "prefix cache: the second request did not hit")
    check(n_enc == 1 and len(encoded) == 1, "prefix cache: the hit did not skip the encoder")
    check(len(eng.allocator.free) + len(eng.store.entries) == eng.num_blocks - 1,
          "prefix cache: pages lost")


def int4_engine_phase(model, fa, pa, k5, k6, probe) -> None:
    """8d. The same engine over the bf16 model's LM quantized to int4 on the card
    (quantize_lm_params_w4, as phase 7b) with an int8 pool: 2 requests of 500 ids, 16
    tokens each, twice; per decode step 28 K3, 1 K5 (layer 0's qkv), 28 + 28 K6 and 1 K4
    (the int8 head, which also runs once per prefill)."""
    from audio_flamingo_tpu_torch.models import af3, qwen2
    from audio_flamingo_tpu_torch.ops.quant4 import quantize_lm_params_w4
    from audio_flamingo_tpu_torch.runtime.paged_engine import PagedEngine

    qlm = qwen2.quantized_lm(quantize_lm_params_w4(model.model.lm.state_dict()),
                             torch.bfloat16, "cuda")
    m4 = af3.AF3Model(model.model.encoder, model.model.adaptor, qlm)
    rng = np.random.default_rng(2)
    specs = [(f"q{i}", rng.integers(0, 150_000, (1, 500)).astype(np.int32), None)
             for i in range(2)]
    from audio_flamingo_tpu_torch.ops.kernels import w8a16_matmul as k4

    counters = {"K3": pa.LAUNCHES, "K5": k5.LAUNCHES, "K6A": k6.LAUNCHES_A,
                "K6B": k6.LAUNCHES_B, "K4": k4.LAUNCHES}
    runs = []
    for _ in range(2):
        for c in counters.values():
            c.reset()
        probe.reset()
        eng = PagedEngine(model=m4, cfg=model.cfg, kv_dtype=torch.int8, **ENGINE)
        results, wall = serve(eng, specs, 16)
        counts = {n: c.count for n, c in counters.items()}
        steps = probe.steps
        log(f"int4 LM + int8 pool: {sum(len(v) for v in results.values())} tokens in "
            f"{wall:.3f} s, {steps} decode steps; launches K3 {counts['K3']}, K5 "
            f"{counts['K5']}, K6 A {counts['K6A']}, K6 B {counts['K6B']}, K4 {counts['K4']}")
        n_layers = model.cfg.lm.num_layers
        # K4: the int8 head of every decode step and of each request's prefill
        want = {"K3": n_layers * steps, "K5": steps, "K6A": n_layers * steps,
                "K6B": n_layers * steps, "K4": steps + len(specs)}
        check(steps > 0 and counts == want, f"int4 engine launches {counts} != {want}")
        check(len(eng.allocator.free) == eng.num_blocks - 1, "int4 engine: pool not released")
        runs.append(results)
    check(runs[0] == runs[1], "int4 engine: greedy ids differ between two runs")
    del qlm, m4


def f32_engine_card_vs_cpu_phase(pa) -> None:
    """8e. f32, full width, 2 encoder + 2 LM layers, the same weights on the card and on
    the CPU: three requests (two text prompts and the 30 s clip) through PagedEngine on
    both, with f32 and with int8 pools. Greedy ids token-exact and, for each request, not
    all one token; first-token logits within 1e-4; and on the card the same ids as
    generate(). The clip's chat prompt ends in 8 random ids: with random weights and the
    template's fixed ending, its greedy ids were one token repeated, which would make
    their comparison nearly empty."""
    from audio_flamingo_tpu_torch.api import AudioFlamingo
    from audio_flamingo_tpu_torch.config import AF3Config
    from audio_flamingo_tpu_torch.runtime import generate as gen
    from audio_flamingo_tpu_torch.runtime import paged_engine as pe

    codes_card_vs_cpu("8e")     # the int8 pool's quantizer, Queue 3 item 8
    full = AF3Config()
    cfg = with_flash(dataclasses.replace(
        full, encoder=dataclasses.replace(full.encoder, num_layers=2),
        lm=dataclasses.replace(full.lm, num_layers=2)), True)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    real_emit = pe._emit_first_token
    try:
        cpu = f32_base(cfg)
        card = AudioFlamingo.from_state_dict(cpu.cfg, cpu.model.state_dict(),
                                             cpu.processor.tokenizer, torch.float32,
                                             device="cuda")
        rng = np.random.default_rng(3)
        t = np.arange(30 * 16000) / 16000.0
        wav = (0.3 * np.sin(2 * np.pi * 440.0 * t)
               + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
        msgs = [{"role": "user", "content": "<sound>What do you hear?"}]
        text = [rng.integers(0, 150_000, (1, n)).astype(np.int32) for n in (60, 100, 8)]

        def specs(m):
            b = m.processor(messages=msgs, audios=[wav])
            clip = np.concatenate([np.asarray(b["ids"], np.int32), text[2]], axis=1)
            return [("t0", text[0], None), ("t1", text[1], None), ("clip", clip, b["mels"])]

        engine_cfg = dict(num_rows=4, num_blocks=32, block_size=128, max_blocks_per_seq=16,
                          chunk=8, eos_token_id=card.eos_token_id)
        for kv_dtype in (None, torch.int8):
            out, first = {}, {}
            for where, m in (("cpu", cpu), ("card", card)):
                first[where] = {}
                pe._emit_first_token = (lambda e, r, lg, where=where: first[where].__setitem__(
                    r.request_id, lg.float().cpu()) or real_emit(e, r, lg))
                pa.LAUNCHES.reset()
                eng = pe.PagedEngine(model=m.model, cfg=m.cfg, kv_dtype=kv_dtype,
                                     device=where if where == "cpu" else None, **engine_cfg)
                out[where], _ = serve(eng, specs(m), 8)
                if where == "card":
                    check(pa.LAUNCHES.count > 0, "f32 engine on the card made no K3 launch")
            err = max((first["card"][r] - first["cpu"][r]).abs().max().item() for r in first["cpu"])
            name = "int8" if kv_dtype is torch.int8 else "f32"
            log(f"f32 engine card vs CPU, {name} pool (2 + 2 layers, full width): ids card "
                f"{out['card']} CPU {out['cpu']}; first-token logits max|card - CPU| {err:.3e} "
                f"(limit {LOGITS_TOL})")
            check(out["card"] == out["cpu"], f"f32 engine ids differ card vs CPU ({name} pool)")
            for rid, v in out["card"].items():
                check(len(set(v)) > 1, f"f32 engine {rid} ids are all one token ({name} pool)")
            check(err <= LOGITS_TOL, f"f32 engine first-token logits card vs CPU {err}")
            if kv_dtype is None:
                for rid, ids, mels in specs(card):
                    g = gen.generate(card.model, card.cfg, torch.as_tensor(ids, device="cuda").long(),
                                     mels, max_new_tokens=8, eos_token_id=card.eos_token_id)
                    want = g.tokens[0, : int(g.lengths[0])].tolist()
                    n = min(len(want), len(out["card"][rid]))
                    check(n >= 1 and out["card"][rid][:n] == want[:n],
                          f"f32 engine {rid} != generate: {out['card'][rid]} vs {want}")
                log("f32 engine on the card: every request's ids equal generate()'s")
    finally:
        pe._emit_first_token = real_emit
        torch.backends.cudnn.allow_tf32 = tf32


K7_F32_TOL = 1e-5                   # K7 f32: max|d - plain| <= 1e-5 max|plain|, each of dq, dk, dv
K7_BF16_TOL = (2.0 ** -7, 2.0 ** -7)  # bf16: |d - plain| <= 2^-7 |plain| + 2^-7 max|plain|
TRAIN_F32_TOL = 1e-4                # 9c, f32 card vs CPU: loss, grad norm, grads, the step's change
STAGE2_LOSS_RTOL = 1e-3             # 9b: two runs from one seed, each step's loss, relative
STAGE2_WORDS = "describe the sound of music and speech".split()   # the random tokenizer's corpus
STAGE2_STEPS = 3                     # 9b: steps a run (5 before phase 17 needed the room)


def k7_bound_ms(q_shape, k_shape, causal: bool, q_offset: int, dtype: str,
                g_lse: bool = False) -> tuple:
    """Least time for the backward on the card: five products of 2 B H D per visible
    (row, key) pair (S and dP, each recomputed once, dV, dK, dQ counted once each) over
    the dtype's peak, or the bytes of q, k, v, o, dO, lse (and g_lse) read and dq, dk,
    dv written over the HBM rate, whichever is larger."""
    b, tq, h, d = q_shape
    tk, hkv = k_shape[1], k_shape[2]
    flops = 5 * 2.0 * b * h * d * visible_pairs(tq, tk, causal, q_offset)
    item = 4 if dtype == "float32" else 2
    q_elems, kv_elems = b * tq * h * d, b * tk * hkv * d
    nbytes = (item * (3 * q_elems + 2 * kv_elems) + 4 * b * tq * h * (2 if g_lse else 1)
              + item * (q_elems + 2 * kv_elems))
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def k7_compare(grads, plain) -> dict:
    """err: the largest |d - plain| over dq, dk, dv; ratio: the largest |d - plain| over
    its limit (K7_F32_TOL in f32, K7_BF16_TOL per element in bf16), which must be <= 1."""
    err = ratio = 0.0
    for a, r in zip(grads, plain):
        check(bool(torch.isfinite(a).all()), "K7 gradient not finite")
        diff = (a.float() - r.float()).abs()
        mx = r.float().abs().max()
        if a.dtype == torch.float32:
            lim = K7_F32_TOL * mx
        else:
            rel, floor = K7_BF16_TOL
            lim = rel * r.float().abs() + floor * mx
        err = max(err, diff.max().item())
        ratio = max(ratio, (diff / lim).max().item())
    return dict(err=err, ratio=ratio)


def sdpa_backward_call(q, k, v, do, kw):
    """SDPA's backward alone on the same inputs: one retained SDPA graph (fused backends,
    KV heads expanded outside) differentiated by torch.autograd.grad on each call."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    rep = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt = k.repeat_interleave(rep, dim=2).transpose(1, 2).detach().requires_grad_()
    vt = v.repeat_interleave(rep, dim=2).transpose(1, 2).detach().requires_grad_()
    dot = do.transpose(1, 2)
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                      SDPBackend.CUDNN_ATTENTION]):
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=kw["causal"],
                                             scale=kw["scale"])

    def call():
        return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
    return call


def k7_phase(fa) -> dict:
    """9a. K7 against its plain backward at AF3 stage 2's shapes (encoder non-causal at
    scale 1, LM causal GQA), an unaligned causal case with a q_offset, a case with an LSE
    cotangent and a negative q_offset whose first rows see no key (zero, finite
    gradients), in f32 and bf16; two launches on the same inputs bit-identical; the first
    two timed beside the plain version, SDPA's backward and the bound."""
    cases = [  # name, q shape, k shape, causal, scale, q_offset, with g_lse, timed
        ("encoder", (4, 1500, 20, 64), (4, 1500, 20, 64), False, 1.0, 0, False, True),
        ("lm", (4, 1024, 28, 128), (4, 1024, 4, 128), True, None, 0, False, True),
        ("unaligned", (2, 300, 28, 128), (2, 700, 4, 128), True, None, 400, False, False),
        ("g_lse", (2, 512, 28, 128), (2, 512, 4, 128), True, None, 0, True, False),
        ("no_key_rows", (2, 230, 8, 64), (2, 300, 4, 64), True, None, -90, False, False),
    ]
    gen = torch.Generator(device="cuda").manual_seed(9)
    results = {}
    for name, qs, ks, causal, scale, q_offset, with_glse, timed in cases:
        d = qs[-1]
        sc = scale if scale is not None else d ** -0.5
        q32 = torch.randn(qs, generator=gen, device="cuda") / (d ** 0.5 * sc)   # score std 1
        k32 = torch.randn(ks, generator=gen, device="cuda")
        v32 = torch.randn(ks, generator=gen, device="cuda")
        do32 = torch.randn(qs, generator=gen, device="cuda")
        gl = torch.randn(qs[:3], generator=gen, device="cuda") if with_glse else None
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            q, k, v, do = (x.to(dtype) for x in (q32, k32, v32, do32))
            kw = dict(causal=causal, scale=sc, q_offset=q_offset)
            o, lse = fa.flash_attention_lse(q, k, v, **kw)

            def k7():
                return fa.flash_attention_backward(q, k, v, o, lse, do, gl, **kw)

            def plain():
                return fa.flash_attention_backward_reference(q, k, v, o, lse, do, gl, **kw)

            out, again = k7(), k7()
            check(all(torch.equal(a, b) for a, b in zip(out, again)),
                  f"K7 {name} {dn}: two launches on the same inputs differ")
            if q_offset < 0:     # rows i < -q_offset see no key: zero gradient
                check(bool((out[0][:, :-q_offset] == 0).all()),
                      f"K7 {name} {dn}: dq of rows without a visible key is not 0")
            r = k7_compare(out, plain())
            msg = (f"K7 {name:9s} {dn:8s} q{list(qs)} k{list(ks)} causal={causal} "
                   f"q_offset={q_offset} g_lse={with_glse}: max|d-plain|={r['err']:.3e} (at "
                   f"{r['ratio']:.3f} of its limit), replay bit-identical")
            if timed:
                r["ms"] = time_ms(k7, reps=10)
                r["plain_ms"] = time_ms(plain, reps=3, warm=1)
                r["library_ms"] = time_ms(sdpa_backward_call(q, k, v, do, kw), reps=10)
                r["bound_ms"], r["bound_by"] = k7_bound_ms(qs, ks, causal, q_offset, dn,
                                                           with_glse)
                msg += (f"; ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} SDPA-backward "
                        f"ms={r['library_ms']:.4f} bound_ms={r['bound_ms']:.5f} "
                        f"({r['bound_by']})")
            log(msg)
            check(r["ratio"] <= 1.0, f"K7 {name} {dn}: |d - plain| at {r['ratio']:.3f} of "
                                     "its limit")
            results[(name, dn)] = r
            del out, again, o, lse
        torch.cuda.empty_cache()
    return results


def k7_launch_sums(fa, captured: list, tag: str) -> dict:
    """Every captured K7 launch re-run and held to its plain backward (k7_compare), and the
    kernel, its plain version and SDPA's backward timed on its inputs: summed kernel_ms,
    plain_ms, library_ms and bound_ms, with the largest error."""
    rep = dict(err=0.0, ratio=0.0, kernel_ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    bound_by = set()
    for q, k, v, o, lse, do, g_lse, kw in captured:
        def k7():
            return fa.flash_attention_backward(q, k, v, o, lse, do, g_lse, **kw)

        def plain():
            return fa.flash_attention_backward_reference(q, k, v, o, lse, do, g_lse, **kw)

        r = k7_compare(k7(), plain())
        rep["err"], rep["ratio"] = max(rep["err"], r["err"]), max(rep["ratio"], r["ratio"])
        rep["kernel_ms"] += time_ms(k7, 5, 1)
        rep["plain_ms"] += time_ms(plain, 3, 1)
        rep["library_ms"] += time_ms(sdpa_backward_call(q, k, v, do, kw), 3, 1)
        b_ms, b_by = k7_bound_ms(tuple(q.shape), tuple(k.shape), kw["causal"], kw["q_offset"],
                                 str(q.dtype).split(".")[-1], g_lse is not None)
        rep["bound_ms"] += b_ms
        bound_by.add(b_by)
    rep["bound_by"] = "operations" if bound_by == {"operations"} else "bytes"
    check(rep["ratio"] <= 1.0, f"{tag} at {rep['ratio']:.3f} of its limit")
    return rep


def stage2_example(rng):
    """One row of AF3 stage 2: a 30 s clip (a tone at a drawn pitch plus noise), a prompt
    with <sound>, and an answer of 56 words of the random tokenizer's corpus (about 64
    tokens): 750 audio tokens, bucket 1024."""
    t = np.arange(30 * 16000) / 16000.0
    wav = (0.3 * np.sin(2 * np.pi * rng.uniform(200.0, 800.0) * t)
           + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    answer = " ".join(STAGE2_WORDS[i] for i in rng.integers(0, len(STAGE2_WORDS), 56))
    return [wav], "<sound>What do you hear?", answer


def matmul_f32_backward_check(qlm) -> None:
    """The bf16 int8 product's backward on the card (ops/quant._MatmulF32Out, which the
    frozen int8 LM's layers and head run in 9b): the input gradient of q_matmul against
    the f32 product g (w_q * scale)^T, within bf16's rounding of the output."""
    from audio_flamingo_tpu_torch.ops.quant import q_matmul

    gen = torch.Generator(device="cuda").manual_seed(3)
    p = {"w_q": qlm.layers["q"]["w_q"][0], "scale": qlm.layers["q"]["scale"][0]}
    x = torch.randn((1024, p["w_q"].shape[0]), generator=gen, device="cuda")
    x = x.bfloat16().requires_grad_()
    g = torch.randn((1024, p["w_q"].shape[1]), generator=gen, device="cuda").bfloat16()
    (gx,) = torch.autograd.grad(q_matmul(x, p), x, g)
    ref = (g.float() * p["scale"]) @ p["w_q"].float().t()
    err = ((gx.float() - ref).abs().max() / ref.abs().max()).item()
    log(f"int8 q_matmul backward, bf16 [1024,{x.shape[1]}]: max|grad - f32|/max|f32| = "
        f"{err:.2e} (limit 2^-8)")
    check(gx.dtype == torch.bfloat16 and err <= 2.0 ** -8, f"int8 matmul backward off: {err}")


def stage2_phase(fa) -> dict:
    """9b. AF3 stage 2 at full width through the port's train/loop.run: a bf16 encoder and
    adaptor hot, the 7B LM frozen in int8 (quantize_lm_params on the card, as
    load(quantize_lm=True)), remat="full" and flash on both towers, ce_chunk 256, batch
    4 from BatchBuilder, warmup 1, STAGE2_STEPS steps; twice from the same weights."""
    from audio_flamingo_tpu_torch.api import AudioFlamingo
    from audio_flamingo_tpu_torch.config import AF3Config
    from audio_flamingo_tpu_torch.models import af3, qwen2
    from audio_flamingo_tpu_torch.ops.quant import quantize_lm_params
    from audio_flamingo_tpu_torch.train import loop
    from audio_flamingo_tpu_torch.train.data import BatchBuilder, MixtureSampler, Source
    from audio_flamingo_tpu_torch.train.stages import AF3_STAGES
    from audio_flamingo_tpu_torch.train.train_step import init_state, loss_and_grads
    from audio_flamingo_tpu_torch.utils.metrics import MetricsLogger

    full = AF3Config()
    cfg = dataclasses.replace(
        full, encoder=dataclasses.replace(full.encoder, use_flash=True, remat="full"),
        lm=dataclasses.replace(full.lm, use_flash=True, remat="full"))
    t0 = time.perf_counter()
    m = AudioFlamingo.from_random(cfg, seed=0, compute_dtype=torch.bfloat16, device="cuda")
    cfg = m.cfg                                  # audio_token_id: the tokenizer's <sound>
    qlm = qwen2.quantized_lm(quantize_lm_params(m.model.lm.state_dict()), torch.bfloat16,
                             "cuda")
    model = af3.AF3Model(m.model.encoder, m.model.adaptor, qlm)
    m = dataclasses.replace(m, model=model)
    gc.collect()
    torch.cuda.empty_cache()
    n_hot = sum(p.numel() for n, p in model.named_parameters())
    lm_bytes = sum(t.numel() * t.element_size() for t in qlm.state_dict().values())
    log(f"stage 2: from_random (bf16) and quantize_lm_params on the card in "
        f"{time.perf_counter() - t0:.1f}s: encoder + adaptor {n_hot / 1e9:.3f} B params bf16 "
        f"(hot), int8 LM {lm_bytes / 1e9:.2f} GB (frozen)")
    matmul_f32_backward_check(qlm)
    hot0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    lm0 = {n: t.clone() for n, t in qlm.state_dict().items()}
    run_cfg = loop.TrainRunConfig(stage="2_encoder_tuning", batch_size=4, num_steps=STAGE2_STEPS,
                                  log_every=1, warmup_steps=1, ce_chunk=256)
    steps = run_cfg.num_steps
    builder = BatchBuilder(processor=m.processor)
    batch = builder.build([stage2_example(np.random.default_rng(5)) for _ in range(4)])
    n_audio = (batch["ids"] == cfg.audio_token_id).sum(dim=1).tolist()
    n_label = (batch["labels"] >= 0).sum(dim=1).tolist()
    log(f"stage 2 batch: ids {tuple(batch['ids'].shape)} on {batch['ids'].device}, mels "
        f"{tuple(batch['mels'].shape)} on {batch['mels'].device}; audio tokens per row "
        f"{n_audio}, answer labels per row {n_label}")
    check(tuple(batch["ids"].shape) == (4, 1024) and n_audio == [750] * 4
          and batch["mels"].is_cuda, "the stage-2 batch is not 4 x 1024 with 750 audio tokens "
                                     "per row on the card")
    runs = []
    for i in range(2):
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(hot0[n])
        for counter in (fa.LAUNCHES, fa.BWD_LAUNCHES):
            counter.reset()
            counter.timing = i == 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, metrics = loop.run(cfg, model, MixtureSampler([Source("stage2", 1.0,
                                                                     stage2_example)], seed=0),
                                  builder, run_cfg, metrics=MetricsLogger(verbose=False),
                                  device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k2, k7 = fa.LAUNCHES.count, fa.BWD_LAUNCHES.count
        k2_shapes, k7_shapes = dict(fa.LAUNCHES.shapes), dict(fa.BWD_LAUNCHES.shapes)
        k2_ms = fa.LAUNCHES.device_ms() if i == 0 else None
        k7_ms = fa.BWD_LAUNCHES.device_ms() if i == 0 else None
        for counter in (fa.LAUNCHES, fa.BWD_LAUNCHES):
            counter.timing = False
            counter.reset()
        recs = metrics.records
        ends = [r["s_per_step"] * r["step"] for r in recs]
        step_s = [b - a for a, b in zip([0.0] + ends[:-1], ends)]
        runs.append(dict(losses=[r["loss"] for r in recs], gnorms=[r["grad_norm"] for r in recs],
                         step_s=step_s, wall=wall, k2=k2, k7=k7, k2_shapes=k2_shapes,
                         k7_shapes=k7_shapes, k2_ms=k2_ms, k7_ms=k7_ms,
                         peak=torch.cuda.max_memory_allocated() / 2 ** 30))
        log(f"stage 2 run #{i + 1}: {steps} steps in {wall:.2f}s; losses "
            f"{[round(x, 6) for x in runs[-1]['losses']]}; grad norms "
            f"{[round(x, 4) for x in runs[-1]['gnorms']]}; s per step "
            f"{[round(x, 3) for x in step_s]}; K2 {k2} and K7 {k7} launches; peak "
            f"{runs[-1]['peak']:.2f} GiB")
    r1, r2 = runs
    enc_q, lm_q = (4, 1500, 20, 64), (4, 1024, 28, 128)
    want_k7 = {(enc_q, enc_q, False): 32 * steps, (lm_q, (4, 1024, 4, 128), True): 28 * steps}
    want_k2 = {k: 2 * n for k, n in want_k7.items()}
    for r in runs:
        check(all(np.isfinite(r["losses"])) and len(r["losses"]) == steps,
              f"stage 2 losses {r['losses']}")
        check(r["k7"] == 60 * steps and r["k7_shapes"] == want_k7,
              f"K7 launches {r['k7_shapes']} != 60 per step {want_k7}")
        check(r["k2"] == 120 * steps and r["k2_shapes"] == want_k2,
              f"K2 launches {r['k2_shapes']} != 120 per step (forward + recompute) {want_k2}")
    dloss = max(abs(a - b) / abs(a) for a, b in zip(r1["losses"], r2["losses"]))
    log(f"stage 2: two runs from one seed, each step's loss within {dloss:.3e} relative "
        f"(limit {STAGE2_LOSS_RTOL})")
    check(dloss <= STAGE2_LOSS_RTOL, f"stage 2 runs differ: {r1['losses']} vs {r2['losses']}")
    check(all(torch.equal(t, lm0[n]) for n, t in qlm.state_dict().items()),
          "the frozen int8 LM changed")
    moved = {part: max((p - hot0[n]).abs().max().item() for n, p in model.named_parameters()
                       if n.startswith(part))
             for part in ("encoder.", "adaptor.")}
    log(f"stage 2: the frozen LM bit-identical after both runs; largest change of the hot "
        f"weights: {moved}")
    check(min(moved.values()) > 0, f"a hot part did not move: {moved}")
    del lm0, hot0

    # one more step's K7 and K2 launches kept, replayed against the plain versions, timed
    _, opt = init_state(model, AF3_STAGES["2_encoder_tuning"])
    for counter in (fa.LAUNCHES, fa.BWD_LAUNCHES):
        counter.reset()
        counter.capture = True
    loss_and_grads(model, batch, cfg=cfg, opt=opt, ce_chunk=256)
    captured, k2_captured = list(fa.BWD_LAUNCHES.inputs), list(fa.LAUNCHES.inputs)
    for counter in (fa.LAUNCHES, fa.BWD_LAUNCHES):
        counter.capture = False
        counter.reset()
    check(len(captured) == 60 and len(k2_captured) == 120,
          f"captured {len(captured)} K7 and {len(k2_captured)} K2 launches, not 60 and 120")
    k2_rep = k2_launch_sums(fa, k2_captured)
    del k2_captured
    rep = k7_launch_sums(fa, captured, "a stage-2 K7 launch")
    del captured
    tokens = 4 * 1024
    step = statistics.median(r1["step_s"][1:])
    log(f"stage 2 K7 launches of one step replayed on their own inputs (60, bf16): "
        f"max|d-plain|={rep['err']:.3e} (at {rep['ratio']:.3f} of its limit); summed kernel "
        f"{rep['kernel_ms']:.3f} ms, plain {rep['plain_ms']:.3f} ms, SDPA backward "
        f"{rep['library_ms']:.3f} ms, bound {rep['bound_ms']:.4f} ms ({rep['bound_by']})")
    log(f"stage 2 K2 launches of the same step replayed on their own inputs (120, bf16): "
        f"max|o-plain|={k2_rep['err']:.3e} (at {k2_rep['ratio']:.3f} of its limit); plain "
        f"{k2_rep['plain_ms']:.3f} ms, SDPA {k2_rep['library_ms']:.3f} ms, bound "
        f"{k2_rep['bound_ms']:.4f} ms ({k2_rep['bound_by']}), summed")
    log(f"stage 2 step (run #1, steps 2-{steps}, median, batch built inside the step's "
        f"time): {step * 1e3:.1f} ms = {tokens / step:.1f} tokens/s ({tokens} bucket tokens "
        f"per step) = {4 * 30.0 / step:.2f} audio-s/s; first step {r1['step_s'][0]:.3f} s; "
        f"per step K7 {r1['k7_ms'] / steps:.2f} ms (60 launches, bound "
        f"{rep['bound_ms']:.3f} ms) and K2 {r1['k2_ms'] / steps:.2f} ms (120 launches, bound "
        f"{k2_rep['bound_ms']:.3f} ms) in the path; peak {r1['peak']:.2f} GiB")
    del model, m, qlm, state, opt, batch
    gc.collect()
    torch.cuda.empty_cache()
    return dict(run=r1, replay=rep, step_s=step, steps=steps)


def f32_train_card_vs_cpu_phase(fa) -> None:
    """9c. One stage-2 train step at f32, full width, 2 encoder + 2 LM layers, batch 1,
    on the card and on the CPU from the same weights (the LM int8 by quantize_lm_params
    on the CPU) and the same batch: the loss, the grad norm and every hot gradient (the
    step's first half, loss_and_grads) within 1e-4 (relative; a gradient relative to its
    tensor's largest), and the step's second half, AdamW's update on the card, within
    1e-4 of the largest change (plus one f32 spacing of the weight, where p + change
    rounds) of the CPU's update of the same gradients. The change each
    side makes from its own gradients is printed, not held: after clipping (norm ~66),
    many clipped gradients lie near AdamW's eps (1e-8), where the first step
    g / (|g| + eps) follows a gradient's low digits. The card runs K2 and K7, the CPU
    their plain versions."""
    import copy

    from audio_flamingo_tpu_torch.api import AudioFlamingo
    from audio_flamingo_tpu_torch.config import AF3Config
    from audio_flamingo_tpu_torch.models import af3, qwen2
    from audio_flamingo_tpu_torch.ops.quant import quantize_lm_params
    from audio_flamingo_tpu_torch.train.data import BatchBuilder
    from audio_flamingo_tpu_torch.train.stages import AF3_STAGES
    from audio_flamingo_tpu_torch.train.train_step import global_norm, init_state, loss_and_grads

    full = AF3Config()
    cfg = dataclasses.replace(
        full, encoder=dataclasses.replace(full.encoder, num_layers=2, use_flash=True,
                                          remat="full"),
        lm=dataclasses.replace(full.lm, num_layers=2, use_flash=True, remat="full"))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False      # the conv stem in full f32 (README)
    try:
        t0 = time.perf_counter()
        cpu = f32_base(cfg)
        cfg = cpu.cfg                            # audio_token_id: the tokenizer's <sound>
        tree = quantize_lm_params(cpu.model.lm.state_dict())
        models = {"cpu": af3.AF3Model(copy.deepcopy(cpu.model.encoder),
                                      copy.deepcopy(cpu.model.adaptor),
                                      qwen2.quantized_lm(tree, torch.float32, "cpu")),
                  "card": af3.AF3Model(copy.deepcopy(cpu.model.encoder).to("cuda"),
                                       copy.deepcopy(cpu.model.adaptor).to("cuda"),
                                       qwen2.quantized_lm(tree, torch.float32, "cuda"))}
        del tree
        batch = BatchBuilder(processor=cpu.processor).build(
            [stage2_example(np.random.default_rng(1))])
        check(int((batch["ids"] == cfg.audio_token_id).sum()) == 750,
              "the f32 step's batch lacks its 750 audio tokens")
        log(f"f32 train step card vs CPU: 2 + 2 layers at full width, int8 LM, batch "
            f"{tuple(batch['ids'].shape)}, built in {time.perf_counter() - t0:.1f}s")
        out = {}
        for side, model in models.items():
            state, opt = init_state(model, AF3_STAGES["2_encoder_tuning"], warmup_steps=0,
                                    total_steps=10)
            before = {n: p.detach().clone() for n, p in model.named_parameters()}
            fa.LAUNCHES.reset()
            fa.BWD_LAUNCHES.reset()
            t0 = time.perf_counter()
            loss, grads = loss_and_grads(model, batch, cfg=cfg, opt=opt, ce_chunk=256)
            opt.update(grads, state.opt_state, model)
            if side == "card":
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            change = {n: (p.detach() - before[n]).cpu() for n, p in model.named_parameters()
                      if n in grads}
            out[side] = dict(loss=loss.item(), gnorm=global_norm(grads.values()).item(),
                             grads={n: g.cpu() for n, g in grads.items()}, change=change,
                             before={n: b.cpu() for n, b in before.items() if n in grads},
                             k2=fa.LAUNCHES.count, k7=fa.BWD_LAUNCHES.count, s=seconds)
        cpu_r, card_r = out["cpu"], out["card"]
        check(card_r["k7"] == 4 and card_r["k2"] == 8,
              f"card step: {card_r['k7']} K7 and {card_r['k2']} K2 launches, not 4 and 8")
        check(cpu_r["k7"] == 0 and cpu_r["k2"] == 0, "the CPU step launched a kernel")
        dl = abs(card_r["loss"] - cpu_r["loss"]) / abs(cpu_r["loss"])
        dn = abs(card_r["gnorm"] - cpu_r["gnorm"]) / cpu_r["gnorm"]
        dg = max(((card_r["grads"][n] - g).abs().max() / g.abs().max()).item()
                 for n, g in cpu_r["grads"].items())
        # the CPU's AdamW on the card's gradients, from the same weights
        model = models["cpu"]
        state, opt = init_state(model, AF3_STAGES["2_encoder_tuning"], warmup_steps=0,
                                total_steps=10)
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n in cpu_r["before"]:
                    p.copy_(cpu_r["before"][n])
        opt.update(card_r["grads"], state.opt_state, model)
        params = dict(model.named_parameters())
        same = {n: params[n].detach() - cpu_r["before"][n] for n in card_r["change"]}
        largest = max(c.abs().max().item() for c in same.values())
        # beyond 1e-4 of the largest change, each side may round p + change to the
        # neighbouring f32 (6e-8 at a norm weight of 1, 3e-3 of a 2e-5 change)
        eps = torch.finfo(torch.float32).eps
        held = max((((card_r["change"][n] - c).abs() - eps * params[n].detach().abs())
                    .clamp(min=0).max() / largest).item() for n, c in same.items())
        own = max(((card_r["change"][n] - c).abs().max() / largest).item()
                  for n, c in cpu_r["change"].items())
        n_own = sum(int(((card_r["change"][n] - c).abs() > TRAIN_F32_TOL * largest).sum())
                    for n, c in cpu_r["change"].items())
        n_elems = sum(c.numel() for c in cpu_r["change"].values())
        log(f"f32 train step: loss CPU {cpu_r['loss']:.6f} card {card_r['loss']:.6f} "
            f"({dl:.2e} rel); grad norm {cpu_r['gnorm']:.6f} vs {card_r['gnorm']:.6f} "
            f"({dn:.2e}); hot grads max|card - CPU| / max|CPU| {dg:.2e}; AdamW's change on "
            f"the card within {held:.2e} of the largest (largest {largest:.3e}; beyond one "
            f"f32 spacing of the weight) of the CPU's on the same gradients; from each side's own gradients {own:.2e} ({n_own} of "
            f"{n_elems} elements past {TRAIN_F32_TOL}: clipped gradients near eps); CPU "
            f"{cpu_r['s']:.1f}s, card {card_r['s']:.3f}s; card launches K2 {card_r['k2']}, K7 "
            f"{card_r['k7']}")
        for name, x in (("loss", dl), ("grad norm", dn), ("grads", dg), ("step change", held)):
            check(x <= TRAIN_F32_TOL, f"f32 train step {name} card vs CPU {x} > {TRAIN_F32_TOL}")
        check(largest > 0, "the f32 step did not move the hot weights")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


# ------------------------------------------------------------------ 10. the w8a8 path
K8_F32_TOL = 1e-5                    # f32 o: max|o - plain| <= 1e-5 max|plain| (sum order, exp)
K8_BF16_TOL = (2.0 ** -7, 1e-3)      # bf16 o: |o - plain| <= 2^-7 |plain| + 1e-3 (one bf16 step)
K9_NEAR = (2.0 ** -7, 1e-6)          # K9 y "near": |y - plain| <= 2^-7 |plain| + 1e-6 max|plain|
K9_TOL = (2.0 ** -7, 2.0 ** -6)      # every y: |y - plain| <= 2^-7 |plain| + 2^-6 max|plain|
K9_SHARE = 0.999                     # share of K9 outputs "near", and of equal int8 codes
A8_BAND = 0.05                       # a8 vs w8a16 prefill logits, rel max (JAX's band)
A8_F32_TOL = A8_BAND                 # 10e: card vs CPU prefill logits, rel max (see 10e)
K8_PRELUDE_SHARE = 0.9999           # CUDA prelude vs torch prelude: share of equal k codes
K8_PRELUDE_REL = 1e-6                # and ks, rowc relative
K8_NO_LIBRARY = ("none: SDPA computes float attention, not the int8-QK function; its time "
                 "on the float inputs is logged as a yardstick")


PEAK_INT8 = 1979e12                  # H100 SXM dense int8 tensor-core ops


def k8_bound_ms(q_shape, k_shape, causal: bool, q_offset: int, out_dtype: str) -> tuple:
    """Least time of K8's body: max(int8 QK^T ops at 1979 TOPS + bf16 P.V FLOPs at 989
    TFLOP/s, 2 B H D per visible pair each, bytes at 3.35 TB/s); the bytes are the
    prelude's outputs read once (int8 q and k, bf16 v, f32 rowc) and o written once."""
    b, tq, h, d = q_shape
    tk, hkv = k_shape[1], k_shape[2]
    work = 2.0 * b * h * d * visible_pairs(tq, tk, causal, q_offset)
    t_ops = work / PEAK_INT8 + work / PEAK_FLOPS["bfloat16"]
    item = 4 if out_dtype == "float32" else 2
    nbytes = b * tq * h * d * (1 + item) + b * tk * hkv * d * 3 + 4 * b * tq * h
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def k9_bound_ms(kind: str, m: int, d: int, n: int, x_bytes: int) -> tuple:
    """Least time of one K9 call: max(int8 ops at 1979 TOPS, bytes at 3.35 TB/s), each
    input read once and each output written once (n: 3d for ln_qkv, the ffn for mlp;
    x_bytes: the activations' element size)."""
    if kind == "ln_qkv":
        ops = 2.0 * m * d * n
        nbytes = m * d * x_bytes + d * n + m * n * x_bytes + 4 * (2 * d + 2 * n)
    elif kind == "out_ln":
        ops = 2.0 * m * d * d
        nbytes = 2 * m * d * x_bytes + d * d + m * d * (x_bytes + 1) + 4 * m + 16 * d
    else:
        ops = 4.0 * m * d * n
        nbytes = m * d + 4 * m + 2 * d * n + 2 * m * d * x_bytes + 8 * (n + d)
    t_ops, t_bytes = ops / PEAK_INT8, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def k8_compare(fa8, pre) -> dict:
    """One K8 launch against the plain version on the same prelude outputs, and a second
    launch (a replay must be bit-identical)."""
    o = fa8.flash_attention_a8_kernel(pre)
    o2 = fa8.flash_attention_a8_kernel(pre)
    ref = fa8.flash_attention_a8_reference(pre).float()
    diff = (o.float() - ref).abs()
    if pre.out_dtype == torch.float32:
        ratio = diff.max().item() / (K8_F32_TOL * ref.abs().max().item())
    else:
        ratio = (diff / (K8_BF16_TOL[0] * ref.abs() + K8_BF16_TOL[1])).max().item()
    return dict(err=diff.max().item(), ratio=ratio, replay=torch.equal(o, o2),
                finite=bool(torch.isfinite(o).all()))


def check_k8(name: str, r: dict) -> None:
    check(r["finite"], f"K8 {name}: output not finite")
    check(r["ratio"] <= 1.0, f"K8 {name}: |o - plain| at {r['ratio']:.3f} of its limit")
    check(r["replay"], f"K8 {name}: two launches on the same inputs differ")


def k8_prelude_bound_ms(q_shape, k_shape, tq_pad: int, tk_pad: int, dtype: str) -> tuple:
    """Least time of the CUDA prelude: bytes at 3.35 TB/s, q and k read once, the int8
    codes and f32 rowc written once (an f32 v also read, and written once as bf16)."""
    b, tq, h, d = q_shape
    tk, hkv = k_shape[1], k_shape[2]
    item = 4 if dtype == "float32" else 2
    nbytes = (b * tq * h * d + b * tk * hkv * d) * item + b * h * tq_pad * (d + 4) \
        + b * hkv * tk_pad * d
    if dtype == "float32":
        nbytes += b * tk * hkv * d * (4 + 2)
    return nbytes / PEAK_BYTES * 1e3, "bytes"


def k8_prelude_compare(fa8, ref, pre) -> dict:
    """The CUDA prelude's outputs against the torch prelude's on the card: q codes and qs
    equal, k codes equal in >= 99.99 % of entries and never more than 1 apart (the K mean
    is summed in another order), ks and rowc within 1e-6 relative."""
    kq = (pre.k_i8.int() - ref.k_i8.int()).abs()

    def rel(a, b):
        return ((a - b).abs() / b.abs()).max().item()

    r = dict(q_equal=torch.equal(pre.q_i8, ref.q_i8), qs_equal=torch.equal(pre.qs, ref.qs),
             k_share=(kq == 0).float().mean().item(), k_max=kq.max().item(),
             ks_rel=rel(pre.ks, ref.ks), rowc_rel=rel(pre.rowc, ref.rowc))
    r["ok"] = (r["q_equal"] and r["qs_equal"] and r["k_share"] >= K8_PRELUDE_SHARE
               and r["k_max"] <= 1 and r["ks_rel"] <= K8_PRELUDE_REL
               and r["rowc_rel"] <= K8_PRELUDE_REL)
    r["err"] = max(float(r["k_max"]), (pre.rowc - ref.rowc).abs().max().item())
    return r


def k8_phase(fa8) -> dict:
    """10a. K8 against its plain version from the same (CUDA) prelude outputs, at the
    encoder's shapes (30 s and 10 minutes, non-causal, scale 1, block_k 2048), the LM's
    prefill (1024 and 16,384 tokens, causal over 4 KV heads) and an unaligned causal block
    with a q_offset, in f32 and bf16; the CUDA prelude against the torch prelude on the
    card; the kernel, both preludes, the plain version and SDPA on the float inputs timed
    beside the bounds."""
    cases = [  # name, q shape, k shape, causal, scale, q_offset, block_k
        ("encoder", (1, 1500, 20, 64), (1, 1500, 20, 64), False, 1.0, 0, 2048),
        ("encoder_10min", (20, 1500, 20, 64), (20, 1500, 20, 64), False, 1.0, 0, 2048),
        ("lm_prefill", (1, 1024, 28, 128), (1, 1024, 4, 128), True, None, 0, 1024),
        ("lm_prefill_16k", (1, 16384, 28, 128), (1, 16384, 4, 128), True, None, 0, 1024),
        ("ragged", (1, 100, 28, 128), (1, 300, 4, 128), True, None, 200, 1024),
    ]
    gen = torch.Generator(device="cuda").manual_seed(10)
    results = {}
    for name, qs, ks, causal, scale, q_offset, block_k in cases:
        d = qs[-1]
        q_mul = 1.0 / (d ** 0.5 * (scale if scale is not None else d ** -0.5))
        q32 = torch.randn(qs, generator=gen, device="cuda") * q_mul
        k32 = torch.randn(ks, generator=gen, device="cuda") + 0.5   # a common-mode part
        v32 = torch.randn(ks, generator=gen, device="cuda")
        big = qs[0] * qs[1] > 10_000
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = q32.to(dtype), k32.to(dtype), v32.to(dtype)
            kw = dict(causal=causal, scale=scale, q_offset=q_offset, block_q=512,
                      block_k=block_k)
            dn = str(dtype).split(".")[-1]
            ref_pre = fa8.prelude(q, k, v, **kw)
            pre = fa8.prelude_kernel(q, k, v, **kw)
            pc = k8_prelude_compare(fa8, ref_pre, pre)
            check(pc["ok"], f"K8 prelude {name} {dn}: {pc}")
            r = k8_compare(fa8, pre)
            r["prelude"] = pc
            r["ms"] = time_ms(lambda: fa8.flash_attention_a8_kernel(pre), 3 if big else 10)
            r["prelude_ms"] = time_ms(lambda: fa8.prelude_kernel(q, k, v, **kw), 3 if big else 10)
            r["torch_prelude_ms"] = time_ms(lambda: fa8.prelude(q, k, v, **kw), 3 if big else 10)
            r["plain_ms"] = time_ms(lambda: fa8.flash_attention_a8_reference(pre), 1, 1)
            r["sdpa_ms"] = (time_ms(sdpa_call(q, k, v, dict(causal=causal, scale=scale)),
                                    3 if big else 10) if q_offset == 0 else None)
            r["bound_ms"], r["bound_by"] = k8_bound_ms(qs, ks, causal, q_offset, dn)
            r["prelude_bound_ms"], _ = k8_prelude_bound_ms(qs, ks, ref_pre.q_i8.shape[1],
                                                           ref_pre.k_i8.shape[1], dn)
            sdpa = "n/a" if r["sdpa_ms"] is None else f"{r['sdpa_ms']:.4f}"
            log(f"K8 {name:14s} {dn:8s} q{list(qs)} k{list(ks)} causal={causal} q_offset="
                f"{q_offset} block_k={block_k}: max|o-plain|={r['err']:.3e} (at "
                f"{r['ratio']:.3f} of its limit), replay bit-identical {r['replay']}; ms="
                f"{r['ms']:.4f} bound_ms={r['bound_ms']:.5f} ({r['bound_by']}), "
                f"{r['bound_ms'] / r['ms'] * 100:.2f} % of the bound; prelude: CUDA "
                f"{r['prelude_ms']:.4f} ms (bound {r['prelude_bound_ms']:.5f}, bytes; "
                f"{r['prelude_bound_ms'] / r['prelude_ms'] * 100:.1f} %), torch "
                f"{r['torch_prelude_ms']:.4f} ms; q codes equal {pc['q_equal']}, qs equal "
                f"{pc['qs_equal']}, k codes equal {pc['k_share']:.6f} (max diff {pc['k_max']}), "
                f"ks rel {pc['ks_rel']:.1e}, rowc rel {pc['rowc_rel']:.1e}; plain_ms="
                f"{r['plain_ms']:.2f} SDPA (float, yardstick) ms={sdpa}")
            check_k8(f"{name} {dn}", r)
            results[(name, dn)] = r
            del pre, ref_pre
        del q32, k32, v32, q, k, v
        torch.cuda.empty_cache()
    return results


def k9_layer(d: int, f: int, seed: int):
    """One encoder layer in the fused int8 layout (a 1-layer tree) at width d and ffn f,
    quantized by the port's quantizer from random float weights of the encoder
    init's scale, with unit-ish LayerNorms and small biases."""
    from audio_flamingo_tpu_torch.ops.quant import quantize_encoder_params_fused

    gen = torch.Generator(device="cuda").manual_seed(seed)

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


def k9_compare(y, ref) -> dict:
    y, ref = y.float(), ref.float()
    diff = (y - ref).abs()
    mx = ref.abs().max().item()
    near = (diff <= K9_NEAR[0] * ref.abs() + K9_NEAR[1] * mx).float().mean().item()
    ratio = (diff / (K9_TOL[0] * ref.abs() + K9_TOL[1] * mx)).max().item()
    return dict(err=diff.max().item(), near=near, ratio=ratio, finite=bool(torch.isfinite(y).all()))


def check_k9(name: str, r: dict) -> None:
    check(r["finite"], f"K9 {name}: output not finite")
    check(r["near"] >= K9_SHARE, f"K9 {name}: {r['near']:.6f} of outputs within one step")
    check(r["ratio"] <= 1.0, f"K9 {name}: |y - plain| at {r['ratio']:.3f} of its limit")


def k9_phase(ef, wenc) -> dict:
    """10b. K9's three kernels against their plain versions at m = 1500 and 30,000 rows
    (the 30 s and 10-minute encoder calls) in bf16 and f32, on one full-
    width layer in the fused layout; codes of enc_out_ln held to a share, every output to
    a bound; two launches bit-identical; each kernel timed beside its bound, its plain
    version and the composed torch form of the same stage (what fused_stages=() runs);
    enc_mlp (reading the K-major weight copies the encoder holds) and its composed form
    also as device times (graph_ms)."""
    from audio_flamingo_tpu_torch.models.qwen2 import TensorTree, cast_quantized

    d, f = 1280, 5120
    tree = k9_layer(d, f, seed=11)
    gen = torch.Generator(device="cuda").manual_seed(12)
    results = {}
    for m, dtype in ((1500, torch.bfloat16), (30_000, torch.bfloat16), (1500, torch.float32),
                     (30_000, torch.float32)):
        lp = TensorTree(cast_quantized(tree, dtype, "cuda"))
        dn = str(dtype).split(".")[-1]
        xb = dtype.itemsize
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
        # the K-major copies, as the encoder holds them
        kmajor = ef.mlp_kmajor(f1["w_q"][0], f2["w_q"][0])
        w_t = {"enc_ln_qkv": ef.kmajor(qkv["w_q"][0]), "enc_out_ln": ef.kmajor(o["w_q"][0])}
        composed = {"enc_ln_qkv": lambda: wenc.stage_qkv(x, lp, 0, False),
                    "enc_out_ln": lambda: wenc.stage_out(attn, x, lp, 0, False),
                    "enc_mlp": lambda: wenc.stage_mlp(hq, hs, x2, lp, 0, f, False)}
        bounds = {"enc_ln_qkv": k9_bound_ms("ln_qkv", m, d, 3 * d, xb),
                  "enc_out_ln": k9_bound_ms("out_ln", m, d, d, xb),
                  "enc_mlp": k9_bound_ms("mlp", m, d, f, xb)}
        for name in ("enc_ln_qkv", "enc_out_ln", "enc_mlp"):
            kernel, plain = getattr(ef, name), getattr(ef, name + "_reference")
            if name == "enc_mlp":
                kernel = lambda *a: ef.enc_mlp(*a, kmajor=kmajor)
            else:
                kernel = lambda *a, f=kernel, n=name: f(*a, w_t=w_t[n])
            y, y2, ref = kernel(*args[name]), kernel(*args[name]), plain(*args[name])
            if name == "enc_out_ln":
                r = k9_compare(y[0], ref[0])
                r["codes"] = (y[1] == ref[1]).float().mean().item()
                r["scale_rel"] = ((y[2] - ref[2]).abs() / ref[2]).max().item()
                r["replay"] = all(torch.equal(a, b) for a, b in zip(y, y2))
            else:
                r = k9_compare(y, ref)
                r["replay"] = torch.equal(y, y2)
            big = m > 10_000
            r["ms"] = time_ms(lambda: kernel(*args[name]), 5 if big else 10)
            r["plain_ms"] = time_ms(lambda: plain(*args[name]), 2, 1)
            r["composed_ms"] = time_ms(composed[name], 5 if big else 10)
            r["dev_ms"] = graph_ms(lambda: kernel(*args[name]), 5 if big else 10,
                                   2 if big else 10)   # calls a graph
            if name == "enc_mlp":   # and its composed form's
                r["composed_dev_ms"] = graph_ms(composed[name], 5 if big else 10)
            r["bound_ms"], r["bound_by"] = bounds[name]
            codes = ("" if name != "enc_out_ln" else
                     f" codes equal {r['codes']:.6f} scales rel {r['scale_rel']:.2e};")
            dev = (f"; device {r['dev_ms']:.4f} ms = "
                   f"{r['bound_ms'] / r['dev_ms'] * 100:.2f} % of the bound"
                   + ("" if name != "enc_mlp" else
                      f", the composed form's {r['composed_dev_ms']:.4f} ms"))
            log(f"K9 {name:10s} m={m:6d} {dn:8s}: max|y-plain|={r['err']:.3e} (at "
                f"{r['ratio']:.3f} of its limit), {r['near']:.6f} within one step;{codes} "
                f"replay bit-identical {r['replay']}; ms={r['ms']:.4f} composed_ms="
                f"{r['composed_ms']:.4f} plain_ms={r['plain_ms']:.2f} bound_ms="
                f"{r['bound_ms']:.5f} ({r['bound_by']}); {r['bound_ms'] / r['ms'] * 100:.2f} % "
                f"of the bound{dev}")
            check_k9(f"{name} m={m} {dn}", r)
            check(r["replay"], f"K9 {name} m={m} {dn}: two launches differ")
            if name == "enc_out_ln":
                check(r["codes"] >= K9_SHARE, f"K9 enc_out_ln codes equal {r['codes']}")
            results[(name, m, dn)] = r
        del lp, x, attn, x2, hq, hs, args, composed, kmajor, w_t
        torch.cuda.empty_cache()
    return results


def a8_models(cfg, seed: int = 0):
    """The bf16 model at full width with its LM quantized on the card to int8 as
    load(quantize_lm=True) does (the float LM freed): returns (the w8a16 model, its float
    encoder) for the a8 variants to take their encoders from."""
    from audio_flamingo_tpu_torch.api import AudioFlamingo
    from audio_flamingo_tpu_torch.models import af3, qwen2
    from audio_flamingo_tpu_torch.ops.quant import quantize_lm_params

    t0 = time.perf_counter()
    base = AudioFlamingo.from_random(cfg, seed=seed, compute_dtype=torch.bfloat16, device="cuda")
    qlm = qwen2.quantized_lm(quantize_lm_params(base.model.lm.state_dict()), torch.bfloat16,
                             "cuda")
    w8 = dataclasses.replace(base, model=af3.AF3Model(base.model.encoder, base.model.adaptor,
                                                      qlm))
    del base
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    log(f"a8 models: bf16 AF3 at full width made and its LM quantized to int8 on the card in "
        f"{time.perf_counter() - t0:.1f}s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated")
    return w8


def a8_variant(w8, enc, enc_flags: dict, lm_flags: dict):
    """w8 with the encoder ``enc`` and the config switches of the two flag dicts."""
    from audio_flamingo_tpu_torch.models import af3

    cfg = w8.cfg
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, **enc_flags),
                              lm=dataclasses.replace(cfg.lm, **lm_flags))
    return dataclasses.replace(w8, cfg=cfg, model=af3.AF3Model(enc, w8.model.adaptor,
                                                             w8.model.lm),
                               history=[], last_output=None, last_processor_s=None)


def k8_replay(fa8, captured: list) -> dict:
    """The path's own K8 launches replayed on their captured prelude outputs: each held to
    the plain version, and the kernel and the plain version timed (median of 3 after one
    warm-up), summed with the per-launch bounds."""
    tot = dict(err=0.0, ratio=0.0, kernel_ms=0.0, plain_ms=0.0, bound_ms=0.0)
    by = set()
    for i, (pre,) in enumerate(captured):
        r = k8_compare(fa8, pre)
        check_k8(f"path launch {i}", r)
        tot["err"], tot["ratio"] = max(tot["err"], r["err"]), max(tot["ratio"], r["ratio"])
        tot["kernel_ms"] += time_ms(lambda: fa8.flash_attention_a8_kernel(pre), 3, 1)
        tot["plain_ms"] += time_ms(lambda: fa8.flash_attention_a8_reference(pre), 3, 1)
        qs = (pre.batch, pre.tq, pre.heads, pre.q_i8.shape[-1])
        ks = (pre.batch, pre.kv_len, pre.kv_heads, pre.q_i8.shape[-1])
        b_ms, b_by = k8_bound_ms(qs, ks, pre.causal, pre.q_offset,
                                  str(pre.out_dtype).split(".")[-1])
        tot["bound_ms"] += b_ms
        by.add(b_by)
    tot["bound_by"] = "operations" if by == {"operations"} else "bytes"
    return tot


def k8_prelude_replay(fa8, captured: list) -> dict:
    """The path's own CUDA prelude launches replayed on their captured inputs: each held to
    the torch prelude on the card, the torch prelude timed (median of 3 after one warm-up)
    and summed with the per-launch byte bounds."""
    tot = dict(err=0.0, plain_ms=0.0, bound_ms=0.0)
    for i, (q, k, v, kw) in enumerate(captured):
        ref = fa8.prelude(q, k, v, **kw)
        pc = k8_prelude_compare(fa8, ref, fa8.prelude_kernel(q, k, v, **kw))
        check(pc["ok"], f"K8 prelude path launch {i}: {pc}")
        tot["err"] = max(tot["err"], pc["err"])
        tot["plain_ms"] += time_ms(lambda: fa8.prelude(q, k, v, **kw), 3, 1)
        tot["bound_ms"] += k8_prelude_bound_ms(tuple(q.shape), tuple(k.shape),
                                               ref.q_i8.shape[1], ref.k_i8.shape[1],
                                               str(q.dtype).split(".")[-1])[0]
    return tot


def a8_clip_phase(w8, fa, fa8, wav, ref_ttft: dict) -> dict:
    """10c. The 30 s clip on the a8 path at full width: the w8a16 model's encoder
    quantized by quantize_encoder_params (what load(a8_encoder=True) runs), a8_prefill,
    a8_attention on both towers, flash on; generate() three times, greedy, 16 tokens: 60
    K8 launches (32 encoder + 28 LM) and no K2 per generate, identical ids, finite logits;
    the warm (second) run's prefill logits against the same int8 LM with a8 off and the
    float encoder (load(quantize_lm=True)); every K8 launch of the third run replayed
    against the plain version. The warm run's user TTFT beside phases 4 and 7, K8's time
    in it, peak memory."""
    from audio_flamingo_tpu_torch.models import whisper_encoder

    enc8 = whisper_encoder.quantize(w8.model.encoder, w8.cfg.encoder)
    a8 = a8_variant(w8, enc8, dict(a8_attention=True), dict(a8_prefill=True, a8_attention=True))
    runs = []
    pl8 = fa8.PRELUDE_LAUNCHES
    for i in range(3):
        for c in (fa.LAUNCHES, fa8.LAUNCHES, pl8):
            c.reset()
        fa8.LAUNCHES.timing, fa8.LAUNCHES.capture = True, i == 2
        pl8.timing, pl8.capture = True, i == 2
        torch.cuda.reset_peak_memory_stats()
        text, _, split = timed_generate(a8, sound=wav, prompt="What do you hear?",
                                        max_new_tokens=16)
        out = a8.last_output
        run = dict(ids=out.tokens[0, : int(out.lengths[0])].tolist(), proc=a8.last_processor_s,
                   ttft=out.ttft_s, first_logits=out.first_logits, k8=fa8.LAUNCHES.count,
                   k8_shapes=dict(fa8.LAUNCHES.shapes), k8_ms=fa8.LAUNCHES.device_ms(),
                   pre=pl8.count, pre_ms=pl8.device_ms(),
                   k2=fa.LAUNCHES.count, peak=torch.cuda.max_memory_allocated() / 2**30)
        captured, captured_pre = list(fa8.LAUNCHES.inputs), list(pl8.inputs)
        for c in (fa8.LAUNCHES, pl8):
            c.timing = c.capture = False
            c.reset()
        log(f"a8 generate #{i + 1}: ids={run['ids']} text={text!r} {split}; K8 launches "
            f"{run['k8']} ({run['k8_ms']:.3f} ms in the path), its CUDA prelude {run['pre']} "
            f"({run['pre_ms']:.3f} ms), K2 {run['k2']}; peak GPU memory {run['peak']:.2f} GiB")
        runs.append(run)
    expected = {((1, 1500, 20, 64), (1, 1500, 20, 64), False): 32,
                ((1, 1024, 28, 128), (1, 1024, 4, 128), True): 28}
    for run in runs:
        check(run["k8"] == 60 and run["k8_shapes"] == expected,
              f"K8 launches per a8 generate {run['k8_shapes']} != {expected}")
        check(run["pre"] == 60, f"K8 prelude launches per a8 generate {run['pre']} != 60")
        check(run["k2"] == 0, f"the a8 path launched K2 {run['k2']} times")
        check(bool(torch.isfinite(run["first_logits"]).all()), "a8 prefill logits not finite")
    check(all(r["ids"] == runs[0]["ids"] for r in runs),
          f"a8 greedy ids differ: {[r['ids'] for r in runs]}")
    rep = k8_replay(fa8, captured)
    pre_rep = k8_prelude_replay(fa8, captured_pre)
    del captured, captured_pre
    log(f"a8 path's 60 K8 launches replayed: max|o-plain|={rep['err']:.3e} (at "
        f"{rep['ratio']:.3f} of its limit); summed kernel {rep['kernel_ms']:.3f} ms (in the "
        f"path {runs[2]['k8_ms']:.3f} ms), plain {rep['plain_ms']:.2f} ms, bound "
        f"{rep['bound_ms']:.4f} ms ({rep['bound_by']}); the 60 CUDA preludes held to the torch "
        f"prelude (max diff {pre_rep['err']:.3e}), {runs[2]['pre_ms']:.3f} ms in the path, "
        f"the torch prelude {pre_rep['plain_ms']:.3f} ms, bound {pre_rep['bound_ms']:.4f} ms")
    fa8.LAUNCHES.reset()
    _, _, split = timed_generate(w8, sound=wav, prompt="What do you hear?", max_new_tokens=1)
    check(fa8.LAUNCHES.count == 0, "the w8a16 path launched K8")
    a, b = runs[1]["first_logits"].double(), w8.last_output.first_logits.double()
    cos = F.cosine_similarity(a, b, dim=-1).min().item()
    rel = ((a - b).abs().max() / b.abs().max()).item()
    warm = runs[1]
    log(f"a8 vs w8a16 prefill logits (same int8 LM; float encoder, no a8): cosine {cos:.6f}, "
        f"max|diff| / max|logit| {rel:.4f} (JAX's band: < {A8_BAND}), argmax {int(a.argmax())} "
        f"vs {int(b.argmax())}; w8a16 {split}")
    log(f"a8 warm run: user TTFT {(warm['proc'] + warm['ttft']) * 1e3:.1f} ms (processor "
        f"{warm['proc'] * 1e3:.1f} + ttft {warm['ttft'] * 1e3:.1f}) against bf16 (phase 4) "
        f"{ref_ttft['bf16'] * 1e3:.1f} ms and int4 (phase 7) {ref_ttft['int4'] * 1e3:.1f} ms; "
        f"K8 {warm['k8_ms']:.3f} ms in the path; peak {warm['peak']:.2f} GiB")
    check(rel < A8_BAND, f"a8 prefill logits {rel} off the w8a16 ones (band {A8_BAND})")
    del a8, enc8
    gc.collect()
    torch.cuda.empty_cache()
    return dict(warm=warm, replay=rep, prelude=pre_rep)


def a8_ten_minute_phase(w8, fa, fa8, ef, lm, wav, ref: dict) -> dict:
    """10d. The 10-minute file on the fused a8 path (the reference's ttft_10min_a8f_s
    pipeline with a8_attention): phase 5's 600 s input through K1, the encoder in the
    fused layout with fused_stages ("qkv", "out", "mlp") and K2 for its attention, the a8
    prefill with K8 at 16,384 tokens, 4 greedy tokens, twice: 96 K9 and 28 K8 launches per
    generate, identical ids. User TTFT beside phase 5's; K9's, K8's and K2's time in the
    path beside their summed bounds; peak memory. Then the same file twice with
    fused_stages ("qkv", "out") (the MLP composed, no enc_mlp launch): its warm TTFT."""
    from audio_flamingo_tpu_torch.audio.mel import WhisperMelFrontend
    from audio_flamingo_tpu_torch.config import MelConfig
    from audio_flamingo_tpu_torch.models import whisper_encoder
    from audio_flamingo_tpu_torch.runtime.processor import AF3Processor

    encf = whisper_encoder.quantize(w8.model.encoder, w8.cfg.encoder, fused=True)
    a8f = a8_variant(w8, encf, dict(fused_stages=("qkv", "out", "mlp")),
                     dict(a8_prefill=True, a8_attention=True))
    frontend = WhisperMelFrontend(MelConfig(num_mel_bins=a8f.cfg.encoder.num_mel_bins),
                                  use_pallas=True)
    a8f = dataclasses.replace(a8f, processor=AF3Processor(
        tokenizer=a8f.processor.tokenizer, cfg=a8f.cfg, frontend=frontend))
    counters = {"K9 ln_qkv": ef.LN_QKV_LAUNCHES, "K9 out_ln": ef.OUT_LN_LAUNCHES,
                "K9 mlp": ef.MLP_LAUNCHES, "K8": fa8.LAUNCHES,
                "K8 prelude": fa8.PRELUDE_LAUNCHES, "K2": fa.LAUNCHES, "K1": lm.LAUNCHES}
    runs = []
    for i in range(2):
        for c in counters.values():
            c.reset()
            c.timing = True
        torch.cuda.reset_peak_memory_stats()
        _, e2e, split = timed_generate(a8f, sound=wav, prompt="What do you hear?",
                                       max_new_tokens=4)
        out = a8f.last_output
        run = dict(ids=out.tokens[0, : int(out.lengths[0])].tolist(), proc=a8f.last_processor_s,
                   ttft=out.ttft_s, e2e=e2e, finite=bool(torch.isfinite(out.first_logits).all()),
                   peak=torch.cuda.max_memory_allocated() / 2**30,
                   **{n: (c.count, dict(c.shapes), c.device_ms()) for n, c in counters.items()})
        for c in counters.values():
            c.timing = False
            c.reset()
        log(f"a8 10-minute generate #{i + 1}: ids={run['ids']} {split}; "
            + ", ".join(f"{n} {run[n][0]} ({run[n][2]:.1f} ms)" for n in counters)
            + f"; peak GPU memory {run['peak']:.2f} GiB")
        runs.append(run)
    for run in runs:
        for name in ("K9 ln_qkv", "K9 out_ln", "K9 mlp"):
            check(run[name][0] == 32, f"{name} launches per 10-minute a8 generate "
                                      f"{run[name][0]} != 32")
        check(run["K8"][0] == 28 and run["K8"][1] == {
            ((1, 16384, 28, 128), (1, 16384, 4, 128), True): 28},
            f"K8 launches per 10-minute a8 generate {run['K8'][1]}")
        check(run["K8 prelude"][0] == 28, f"K8 prelude launches per 10-minute a8 generate "
                                          f"{run['K8 prelude'][0]} != 28")
        check(run["K2"][0] == 32, f"K2 launches {run['K2'][0]} != 32 (the encoder's)")
        check(run["K1"][0] == 2, f"K1 launches {run['K1'][0]} != 2")
        check(run["finite"], "10-minute a8 prefill logits not finite")
    check(runs[0]["ids"] == runs[1]["ids"], f"10-minute a8 greedy ids differ: "
                                            f"{runs[0]['ids']} vs {runs[1]['ids']}")
    warm = runs[1]
    k9_ms = sum(warm[n][2] for n in ("K9 ln_qkv", "K9 out_ln", "K9 mlp"))
    m = 20 * 1500
    bounds = {"K9": 32 * sum(k9_bound_ms(kind, m, 1280, n, 2)[0] for kind, n in
                             (("ln_qkv", 3840), ("out_ln", 1280), ("mlp", 5120))),
              "K8": 28 * k8_bound_ms((1, 16384, 28, 128), (1, 16384, 4, 128), True, 0,
                                      "bfloat16")[0],
              "K8 prelude": 28 * k8_prelude_bound_ms((1, 16384, 28, 128), (1, 16384, 4, 128),
                                                     16384, 16384, "bfloat16")[0],
              "K2": 32 * attention_bound_ms((20, 1500, 20, 64), (20, 1500, 20, 64), False, 0,
                                            "bfloat16")[0]}
    # the same file with the MLP composed (fused_stages ("qkv", "out")): does K9's MLP pay?
    a8q = a8_variant(w8, encf, dict(fused_stages=("qkv", "out")),
                     dict(a8_prefill=True, a8_attention=True))
    a8q = dataclasses.replace(a8q, processor=a8f.processor)
    for i in range(2):
        for c in counters.values():
            c.reset()
        _, _, split_q = timed_generate(a8q, sound=wav, prompt="What do you hear?",
                                       max_new_tokens=4)
        check(ef.MLP_LAUNCHES.count == 0 and ef.LN_QKV_LAUNCHES.count == 32
              and ef.OUT_LN_LAUNCHES.count == 32,
              f"fused_stages ('qkv', 'out'): K9 launches qkv {ef.LN_QKV_LAUNCHES.count}, out "
              f"{ef.OUT_LN_LAUNCHES.count}, mlp {ef.MLP_LAUNCHES.count}")
        check(bool(torch.isfinite(a8q.last_output.first_logits).all()),
              "fused_stages ('qkv', 'out'): prefill logits not finite")
    qo_ttft = a8q.last_processor_s + a8q.last_output.ttft_s
    log(f"a8 10-minute warm run with fused_stages ('qkv', 'out') (the MLP composed): user "
        f"TTFT {qo_ttft:.3f} s ({split_q}) against {warm['proc'] + warm['ttft']:.3f} s with all "
        f"three fused stages")
    for c in counters.values():
        c.reset()
    del a8q
    log(f"a8 10-minute warm run: user TTFT {warm['proc'] + warm['ttft']:.3f} s (processor "
        f"{warm['proc']:.3f} + ttft {warm['ttft']:.3f}) against phase 5's "
        f"{ref['proc'] + ref['ttft']:.3f} s; "
        f"in the path K9 {k9_ms:.1f} ms (bound {bounds['K9']:.2f} ms), K8 {warm['K8'][2]:.1f} ms "
        f"(bound {bounds['K8']:.2f} ms), its CUDA prelude "
        f"{warm['K8 prelude'][2]:.2f} ms (bound {bounds['K8 prelude']:.3f} ms), K2 {warm['K2'][2]:.1f} ms (bound {bounds['K2']:.2f} "
        f"ms); peak {warm['peak']:.2f} GiB")
    del a8f, encf
    gc.collect()
    torch.cuda.empty_cache()
    return dict(warm=warm, bounds=bounds, qkv_out_ttft=qo_ttft)


def a8_f32_card_vs_cpu_phase(fa8, ef) -> None:
    """10e. f32 card against CPU at full width, 2 + 2 layers, weights made on the CPU from a
    seed: the LM quantized to int8 and the encoder in the plain int8 layout (a8_attention)
    and then in the fused layout (every stage fused), each quantized on its own side, with
    a8_prefill and a8_attention in the LM. The card runs K8 and K9, the CPU their plain
    versions. Held: the weight codes quantized on the two sides equal, the first layer's
    enc_out_ln codes on the same inputs at >= 99.9 % equal, the prefill logits of a 30 s
    clip within JAX's a8 band (5e-2 of max|logit|); the greedy ids (8 tokens) logged.
    Activation codes flip wherever the two sides' floats differ in the last bit, and the
    a8 model amplifies a flip: as a yardstick, the CPU's own logits are logged under a
    1e-7 relative perturbation of the mels."""
    import copy

    from audio_flamingo_tpu_torch.api import AudioFlamingo
    from audio_flamingo_tpu_torch.config import AF3Config
    from audio_flamingo_tpu_torch.models import af3, qwen2, whisper_encoder
    from audio_flamingo_tpu_torch.ops.quant import quantize_lm_params
    from audio_flamingo_tpu_torch.runtime.processor import AF3Processor

    full = AF3Config()
    cfg = with_flash(dataclasses.replace(
        full, encoder=dataclasses.replace(full.encoder, num_layers=2),
        lm=dataclasses.replace(full.lm, num_layers=2, a8_prefill=True, a8_attention=True)),
        True)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False      # the conv stem in full f32 (README)
    try:
        t0 = time.perf_counter()
        cpu = f32_base(cfg)
        cfg = cpu.cfg
        float_enc = {"cpu": cpu.model.encoder,
                     "cuda": copy.deepcopy(cpu.model.encoder).to("cuda")}
        lms = {dev: qwen2.quantized_lm(quantize_lm_params(
            {k: v.to(dev) for k, v in cpu.model.lm.state_dict().items()}), torch.float32, dev)
            for dev in ("cpu", "cuda")}
        adaptors = {"cpu": cpu.model.adaptor, "cuda": copy.deepcopy(cpu.model.adaptor).to("cuda")}
        same = [torch.equal(a.cpu(), b) for a, b in zip(lms["cuda"].state_dict().values(),
                                                         lms["cpu"].state_dict().values())]
        log(f"a8 f32 card vs CPU: 2 + 2 layers at full width, built in "
            f"{time.perf_counter() - t0:.1f}s; int8 LM quantized on each side: "
            f"{sum(same)}/{len(same)} tensors equal")
        check(all(same), "the LM's int8 codes or scales differ card vs CPU")
        rng = np.random.default_rng(0)
        t = np.arange(30 * 16000) / 16000.0
        wav = (0.3 * np.sin(2 * np.pi * 440.0 * t)
               + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
        for layout, enc_flags in (("plain", dict(a8_attention=True)),
                                  ("fused", dict(fused_stages=("qkv", "out", "mlp")))):
            ecfg = dataclasses.replace(cfg.encoder, **enc_flags)
            mcfg = dataclasses.replace(cfg, encoder=ecfg)
            models = {}
            for dev in ("cpu", "cuda"):
                enc = whisper_encoder.quantize(float_enc[dev], ecfg, fused=layout == "fused")
                models[dev] = dataclasses.replace(
                    cpu, cfg=mcfg, model=af3.AF3Model(enc, adaptors[dev], lms[dev]), history=[],
                    last_output=None, last_processor_s=None)
                if dev == "cuda":
                    models[dev] = dataclasses.replace(models[dev], processor=AF3Processor(
                        tokenizer=cpu.processor.tokenizer, cfg=mcfg, device="cuda"))
            codes = [torch.equal(a.cpu(), b) for a, b in zip(
                models["cuda"].model.encoder.layers.state_dict().values(),
                models["cpu"].model.encoder.layers.state_dict().values())]
            check(all(codes), f"{layout} encoder's int8 layers differ card vs CPU")
            for c in (fa8.LAUNCHES, ef.OUT_LN_LAUNCHES):
                c.reset()
            ef.OUT_LN_LAUNCHES.capture = True
            out = {}
            for dev, model in models.items():
                t0 = time.perf_counter()
                model.generate(sound=wav, prompt="What do you hear?", max_new_tokens=8)
                o = model.last_output
                out[dev] = dict(ids=o.tokens[0, : int(o.lengths[0])].tolist(),
                                logits=o.first_logits.double().cpu(), s=time.perf_counter() - t0)
            ef.OUT_LN_LAUNCHES.capture = False
            captured = list(ef.OUT_LN_LAUNCHES.inputs)
            k8, k9 = fa8.LAUNCHES.count, ef.OUT_LN_LAUNCHES.count   # the two generates' own
            share = None
            if captured:   # layer 0's enc_out_ln on the card's inputs: kernel vs CPU plain
                args = captured[0]
                got = ef.enc_out_ln(*args[:7], eps=args[7])[1].cpu()
                want = ef.enc_out_ln_reference(*(a.cpu() for a in args[:7]), eps=args[7])[1]
                share = (got == want).float().mean().item()
            a, b = out["cuda"]["logits"], out["cpu"]["logits"]
            rel = ((a - b).abs().max() / b.abs().max()).item()
            if layout == "plain":
                cpu_model = models["cpu"]
                batch = cpu_model.processor(
                    messages=[{"role": "user", "content": "<sound>What do you hear?"}],
                    audios=[wav])
                ids = torch.as_tensor(batch["ids"]).long()
                noise = torch.randn(batch["mels"].shape, generator=torch.Generator().manual_seed(5))
                l0, l1 = (af3.logits(cpu_model.model, mcfg, ids, mels)[0, -1].double()
                          for mels in (batch["mels"], batch["mels"] * (1 + 1e-7 * noise)))
                log(f"a8 f32 plain encoder, yardstick: the CPU's own last-position logits "
                    f"move by {((l1 - l0).abs().max() / l0.abs().max()).item():.3e} of "
                    f"max|logit| under a 1e-7 relative perturbation of the mels")
            ef.OUT_LN_LAUNCHES.reset()
            same_ids = "equal" if out["cpu"]["ids"] == out["cuda"]["ids"] else "DIFFER"
            log(f"a8 f32 {layout} encoder: prefill logits max|card - CPU| / max|logit| "
                f"{rel:.3e} (limit {A8_F32_TOL}); greedy ids CPU {out['cpu']['ids']} card "
                f"{out['cuda']['ids']} ({same_ids}); "
                f"layer-0 enc_out_ln codes equal card vs CPU on the card's inputs: "
                f"{'n/a' if share is None else f'{share:.6f}'}; card launches K8 {k8}, "
                f"enc_out_ln {k9}; CPU {out['cpu']['s']:.1f}s, card {out['cuda']['s']:.2f}s")
            check(rel <= A8_F32_TOL, f"a8 f32 {layout} logits card vs CPU {rel} > {A8_F32_TOL}")
            check(k8 == (4 if layout == "plain" else 2), f"a8 f32 {layout}: {k8} K8 launches")
            check(layout == "plain" or (k9 == 2 and share is not None and share >= K9_SHARE),
                  f"a8 f32 fused: {k9} enc_out_ln launches, codes card vs CPU {share}")
            del models
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


# ------------------------------------------------------------------ 11. the int8 LM's decode
K4_ROUTE_ROWS = (64, 128, 256, 1024)   # 11a: K4 against the library route, to set the limit


def k4_step_launches(n_layers: int) -> int:
    """K4 launches in one int8 decode step: q|k|v, o, gate|up and down per layer, the head."""
    return 4 * n_layers + 1


def k4_bound_ms(m: int, k: int, n: int, x_dtype, out_dtype) -> tuple:
    """Least time of one w8a16 product: its codes (K N bytes), f32 scales, x and y each moved
    once, against 2 m K N operations at x's dtype's peak."""
    xb, ob = (torch.tensor([], dtype=d).element_size() for d in (x_dtype, out_dtype))
    nbytes = k * n + 4 * n + m * k * xb + m * n * ob
    t_ops = 2.0 * m * k * n / PEAK_FLOPS[str(x_dtype).split(".")[-1]]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def library_route_call(x, w_q, scale, out_dtype):
    """The product q_matmul takes above KERNEL_MAX_ROWS rows (and every w8a16 product took
    before K4): the codes copied to bf16 on each call, cuBLAS with f32 output, the scale."""
    from audio_flamingo_tpu_torch.ops.quant import mm_f32

    return lambda: (mm_f32(x, w_q) * scale).to(out_dtype)


def k4_case(k4, x, w_q, scale, out_dtype, timed: bool) -> dict:
    """One K4 call against its plain version (K5's tolerances), replayed bit-identical;
    with ``timed`` also the kernel's time (CUDA events around the call, and its device
    time alone from a CUDA graph replay), the plain version's, the library route's and
    torch._weight_int8pack_mm's (bf16 x) beside the bound."""
    y = k4.w8a16_matmul(x, w_q, scale, out_dtype)
    r = w4_compare(y, k4.w8a16_matmul_reference(x, w_q, scale, out_dtype))
    r["replay_equal"] = torch.equal(y, k4.w8a16_matmul(x, w_q, scale, out_dtype))
    if timed:
        r["ms"] = time_ms(lambda: k4.w8a16_matmul(x, w_q, scale, out_dtype))
        r["graph_ms"] = graph_ms(lambda: k4.w8a16_matmul(x, w_q, scale, out_dtype))
        r["plain_ms"] = time_ms(lambda: k4.w8a16_matmul_reference(x, w_q, scale, out_dtype), 5, 1)
        r["route_ms"] = time_ms(library_route_call(x, w_q, scale, out_dtype), 5, 1)
        lib, r["library_why"] = (int8pack_call(x, w_q, scale) if x.dtype == torch.bfloat16
                                 else (None, "the library call takes bf16 x"))
        r["library_ms"] = time_ms(lib, 5, 1) if lib else None
        del lib
        r["bound_ms"], r["bound_by"] = k4_bound_ms(x.shape[0], *w_q.shape, x.dtype, out_dtype)
    return r


def k4_group_case(k4, x, prods, out_dtype, timed: bool) -> dict:
    """One grouped K4 launch (products sharing x) against the plain version of each
    product (K5's tolerances), replayed bit-identical; with ``timed`` the launch's time
    with the wrapper and as a device time, and the bound of its products together."""
    ys = k4.w8a16_matmul_group(x, prods, out_dtype)
    ys2 = k4.w8a16_matmul_group(x, prods, out_dtype)
    rs = [w4_compare(y, k4.w8a16_matmul_reference(x, p["w_q"], p["scale"], out_dtype))
          for y, p in zip(ys, prods)]
    r = dict(err=max(q["err"] for q in rs), ratio=max(q["ratio"] for q in rs),
             finite=all(q["finite"] for q in rs),
             replay_equal=all(torch.equal(a, b) for a, b in zip(ys, ys2)))
    if timed:
        r["ms"] = time_ms(lambda: k4.w8a16_matmul_group(x, prods, out_dtype))
        r["graph_ms"] = graph_ms(lambda: k4.w8a16_matmul_group(x, prods, out_dtype))
        n = sum(p["w_q"].shape[1] for p in prods)
        r["bound_ms"], r["bound_by"] = k4_bound_ms(x.shape[0], x.shape[1], n, x.dtype, out_dtype)
    return r


def k4_phase(k4, qlm) -> dict:
    """11a. K4 against its plain version at the 7B shapes, on the int8 LM's own codes
    (random_quantized_lm, made on the card) and normal x: the seven layer products (q, k,
    v, o, gate, up, down; layers 0 and 27, read in place from the stacks), the grouped
    launches the LM makes (q|k|v and gate|up, each product held to its own plain version)
    and the head [3584, 152064] at m 1, 8, 32, bf16 x to bf16 and to f32 and f32 x to f32;
    the tied layout (the embedding [152064, 3584] read through its transposed view) at the
    same m; every call replayed bit-identical. The bf16-x cases (the paths' own) timed at
    layer 0 (median of 15 after 3) beside the plain version, the library route (bf16 copy +
    cuBLAS), _weight_int8pack_mm and the bound; the LM's launches also streaming (one call
    per layer in turn in one graph, so the codes come from HBM as in a decode step), and
    one decode step's 113 launches in one graph; then K4 against the library route at m
    64-1024 on [3584, 18944] (device times), the rows that set KERNEL_MAX_ROWS."""
    from audio_flamingo_tpu_torch.ops.quant import KERNEL_MAX_ROWS

    gen = torch.Generator(device="cuda").manual_seed(11)
    layers = qlm.layers
    last = layers["ln1_w"].shape[0] - 1
    mats = {n: layers[n] for n in ("q", "k", "v", "o")}
    mats.update({n: layers["mlp"][n] for n in ("gate", "up", "down")})
    groups = {"q|k|v": ("q", "k", "v"), "gate|up": ("gate", "up")}
    precisions = ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
                  (torch.float32, torch.float32))
    res = {}

    def tag_of(xd, od):
        return f"{str(xd).split('.')[-1]}->{str(od).split('.')[-1]}"

    def report(name, shape, m, tag, r):
        lib = (f"{r['library_ms']:.4f}" if r.get("library_ms") is not None
               else f"null ({r.get('library_why', 'no single library call')})")
        route = f" library route {r['route_ms']:.4f}" if "route_ms" in r else ""
        plain = f" plain_ms={r['plain_ms']:.4f}" if "plain_ms" in r else ""
        log(f"K4 {name:7s} [{m},{shape[0]}]x[{shape[0]},{shape[1]}] {tag:17s}: "
            f"max|y-plain|={r['err']:.3e} (at {r['ratio']:.3f} of the limit) ms="
            f"{r['ms']:.4f} (device {r['graph_ms']:.4f}){plain}{route} "
            f"library_ms={lib} bound_ms={r['bound_ms']:.5f} ({r['bound_by']}); the "
            f"device time at {r['bound_ms'] / r['graph_ms'] * 100:.1f} % of the bound")

    def run(name, w_q, scale, m, layer=None):
        x32 = torch.randn((m, w_q.shape[0]), generator=gen, device="cuda")
        for xd, od in precisions:
            if name == "tied" and od != torch.float32:
                continue       # the tied head only ever writes f32 logits
            r = k4_case(k4, x32.to(xd), w_q, scale, od,
                        timed=layer in (None, 0) and xd == torch.bfloat16)
            tag = tag_of(xd, od)
            check(r["finite"] and r["ratio"] <= 1.0 and r["replay_equal"],
                  f"K4 {name} m={m} {tag} layer {layer}: |y - plain| at {r['ratio']:.3f} of its "
                  f"limit, replay equal {r['replay_equal']}")
            res[(name, m, tag, layer)] = r
            if "ms" in r:
                report(name, tuple(w_q.shape), m, tag, r)

    def run_group(name, m, layer):
        prods = [{"w_q": mats[n]["w_q"][layer], "scale": mats[n]["scale"][layer]}
                 for n in groups[name]]
        x32 = torch.randn((m, prods[0]["w_q"].shape[0]), generator=gen, device="cuda")
        for xd, od in precisions:
            r = k4_group_case(k4, x32.to(xd), prods, od,
                              timed=layer == 0 and xd == torch.bfloat16)
            tag = tag_of(xd, od)
            check(r["finite"] and r["ratio"] <= 1.0 and r["replay_equal"],
                  f"K4 {name} m={m} {tag} layer {layer}: |y - plain| at {r['ratio']:.3f} of "
                  f"its limit, replay equal {r['replay_equal']}")
            res[(name, m, tag, layer)] = r
            if "ms" in r:
                n = sum(p["w_q"].shape[1] for p in prods)
                report(name, (prods[0]["w_q"].shape[0], n), m, tag, r)

    for m in (1, 8, 32):
        for name, p in mats.items():
            for layer in (0, last):
                run(name, p["w_q"][layer], p["scale"][layer], m, layer)
        for name in groups:
            for layer in (0, last):
                run_group(name, m, layer)
        run("head", qlm.lm_head["w_q"], qlm.lm_head["scale"], m)
        run("tied", qlm.embed["w_q"].t(), qlm.embed["scale"], m)
    # the LM's launches with the codes streaming from HBM, and one decode step's launches
    stream = {}
    n_layers = last + 1
    for m in (1, 8, 32):
        xs = {k: torch.randn((m, k), generator=gen, device="cuda").bfloat16()
              for k in (3584, 18944)}
        for name in ("q|k|v", "o", "gate|up", "down"):
            names = groups.get(name, (name,))

            def every_layer(names=names):
                x = xs[mats[names[0]]["w_q"].shape[1]]
                for i in range(n_layers):
                    k4.w8a16_matmul_group(x, [{"w_q": mats[n]["w_q"][i],
                                               "scale": mats[n]["scale"][i]} for n in names])

            n = sum(mats[nm]["w_q"].shape[2] for nm in names)
            k = mats[names[0]]["w_q"].shape[1]
            t = graph_ms(every_layer, 10) / n_layers
            b_ms, _ = k4_bound_ms(m, k, n, torch.bfloat16, torch.bfloat16)
            stream[(name, m)] = (t, b_ms)
        x = xs[3584]

        def step():
            for i in range(n_layers):
                p = {nm: {"w_q": mats[nm]["w_q"][i], "scale": mats[nm]["scale"][i]} for nm in mats}
                k4.w8a16_matmul_group(x, [p["q"], p["k"], p["v"]])
                k4.w8a16_matmul(x, p["o"]["w_q"], p["o"]["scale"])
                k4.w8a16_matmul_group(x, [p["gate"], p["up"]])
                k4.w8a16_matmul(xs[18944], p["down"]["w_q"], p["down"]["scale"])
            k4.w8a16_matmul(x, qlm.lm_head["w_q"], qlm.lm_head["scale"], torch.float32)

        step_bounds = n_layers * sum(b for (nm, mm), (_, b) in stream.items() if mm == m) \
            + k4_bound_ms(m, 3584, 152064, torch.bfloat16, torch.float32)[0]
        stream[("step", m)] = (graph_ms(step, 5), step_bounds)
        log(f"K4 bf16 m={m}, the codes streaming (one launch per layer in turn, device ms per "
            f"launch, its bound, the share): "
            + "; ".join(f"{nm} {stream[(nm, m)][0]:.4f} (bound {stream[(nm, m)][1]:.5f}, "
                        f"{stream[(nm, m)][1] / stream[(nm, m)][0] * 100:.1f} %)"
                        for nm in ("q|k|v", "o", "gate|up", "down"))
            + f"; one decode step's {4 * n_layers + 1} launches in one graph "
              f"{stream[('step', m)][0]:.3f} ms (bound {step_bounds:.3f} ms, "
              f"{step_bounds / stream[('step', m)][0] * 100:.1f} %)")
    w, sc = layers["mlp"]["up"]["w_q"][0], layers["mlp"]["up"]["scale"][0]
    route = {}
    for m in (32,) + K4_ROUTE_ROWS:
        x = torch.randn((m, w.shape[0]), generator=gen, device="cuda").bfloat16()
        route[m] = (graph_ms(lambda: k4.w8a16_matmul(x, w, sc), 10),
                    graph_ms(library_route_call(x, w, sc, torch.bfloat16), 10))

    def bound(m):
        b_ms, b_by = k4_bound_ms(m, *w.shape, torch.bfloat16, torch.bfloat16)
        return f"bound {b_ms:.5f} ({b_by})"
    log(f"K4 against the library route at [m,3584]x[3584,18944] bf16 (device ms, kernel / "
        f"route, bound): " + "; ".join(f"m={m} {a:.4f} / {b:.4f}, {bound(m)}"
                                       for m, (a, b) in route.items())
        + f"; KERNEL_MAX_ROWS = {KERNEL_MAX_ROWS}")
    # one bf16 decode step at m = 1 from the single launches' graph replays (layer 0)
    per = {n: res[(n, 1, "bfloat16->bfloat16", 0)]["graph_ms"] for n in ("q|k|v", "o",
                                                                          "gate|up", "down")}
    head_ms = res[("head", 1, "bfloat16->float32", None)]["graph_ms"]
    log(f"K4 device time of one 7B decode step at m = 1: {stream[('step', 1)][0]:.3f} ms in one "
        f"graph of its {4 * n_layers + 1} launches; from layer 0's replays {n_layers} x ("
        + " + ".join(f"{n} {v * 1e3:.1f}" for n, v in per.items())
        + f" us) + the head {head_ms:.4f} ms = {n_layers * sum(per.values()) + head_ms:.3f} ms")
    return dict(cases=res, route=route, stream=stream, step_ms=stream[("step", 1)][0])


def decode_loop_run(name, lm, cfg, make_cache, steps: int, batch: int, counters: dict,
                    groups: dict, spec=None, timed_runs: int = 2, keep_inputs=()) -> dict:
    """bench.py's decode body (embed -> forward -> unembed -> argmax, ``steps`` times from
    token 0 at position 0 on an empty cache) as the module's step function, through the
    captured step against the eager one (graph_against_eager: ids, logits, launches per
    step and the profiled replay's kernels, sync debug). ``spec``: another DecodeSpec (a
    sampled one) than greedy with no EOS."""
    from audio_flamingo_tpu_torch.runtime import generate as gen

    spec = spec or gen.DecodeSpec(max_new_tokens=steps + 1)

    def start(st, generator):
        st.cache.rewind(0)
        gen.begin(st, spec, torch.zeros((batch,), dtype=torch.long, device=st.tok.device), 0)

    return graph_against_eager(name, lm, cfg, spec, make_cache, start, steps, counters,
                               keep_inputs=keep_inputs, groups=groups, timed_runs=timed_runs)


def timed_decode(name, lm, cfg, make_cache, steps: int, batch: int, counters: dict,
                 step_bytes: int, groups: dict, runs: int = 2) -> dict:
    """decode_loop_run, then ms per step of the captured step (median of ``runs`` runs)
    and of the eager step function (one run) side by side, tok/s, launches per step of
    each counter and the profiled replay's device ms per kernel group, against the
    bytes-per-step bound."""
    r = decode_loop_run(name, lm, cfg, make_cache, steps, batch, counters, groups,
                        timed_runs=runs)
    ids, ms = r["ids"][:, 1:], r["graph_ms"]
    counts = {n: round(v * steps) for n, v in r["counts"].items()}
    dev = {g: r["prof"]["groups"][g][1] for g in groups}
    bound = step_bytes / PEAK_BYTES * 1e3
    check(bool(((ids >= 0) & (ids < cfg.vocab_size)).all()), f"{name}: ids out of vocab")
    log(f"{name}: {ms:.3f} ms per step = {batch * 1e3 / ms:.1f} tok/s through the captured step "
        f"(median of {runs} runs of {steps} steps, batch {batch}), {r['eager_ms']:.3f} ms per "
        f"step eager, against a bound of {bound:.3f} ms per step "
        f"({step_bytes / 1e9:.3f} GB at {PEAK_BYTES / 1e12:.2f} TB/s, {batch * 1e3 / bound:.0f} "
        f"tok/s); launches per step " + ", ".join(f"{n} {counts[n] / steps:g}" for n in counters)
        + "; device ms per step (profiled replay) " + ", ".join(
            f"{g} {ms_:.3f}" for g, ms_ in dev.items())
        + f", all kernels {r['prof']['busy_ms']:.3f} (device busy "
        f"{r['prof']['busy_share'] * 100:.1f} %); ids {ids[0, :6].tolist()}...")
    return dict(ms=ms, eager_ms=r["eager_ms"], tps=batch * 1e3 / ms, bound_ms=bound,
                counts=counts, dev=dev, steps=steps, ids=ids, graph=r)


def lm_step_bytes(lm) -> int:
    """Bytes a decode step reads of the LM: every tensor but the gathered embedding."""
    return sum(v.numel() * v.element_size() for k, v in lm.state_dict().items()
               if not k.startswith("embed."))


def int8_decode_phase(k4, k5, k6, qlm, cfg) -> dict:
    """11b, 11c. bench.py's decode points on the int8 7B LM, each through the captured step
    against the eager step function (decode_loop_run): bench_decode (bf16 KVCache, batch
    1, capacity 1024, 64 greedy steps) with 28 x 4 + 1 = 113 K4 launches per step (q|k|v
    and gate|up one launch each), and the same LM sampled (top-p 0.9 at temperature 0.7,
    16 tokens: the same ids from one seed); bench_decode_matrix's b8 c8192 on the dense
    int8 cache (init_cache_q8, 32 steps); and bench_decode_w4's b1 c1024 on the q8 cache
    with the fused int4 LM (random_quantized_lm_w4): per step 1 K5, 28 + 28 K6 and 1 K4
    (the int8 head)."""
    from audio_flamingo_tpu_torch.models import qwen2
    from audio_flamingo_tpu_torch.ops.quant4 import random_quantized_lm_w4
    from audio_flamingo_tpu_torch.ops.sampling import SamplingParams
    from audio_flamingo_tpu_torch.runtime import generate as gen

    n_layers = cfg.num_layers
    weights = lm_step_bytes(qlm)
    res = {}
    res["b1"] = timed_decode(
        "11b int8 7B decode, bf16 cache c1024", qlm, cfg,
        lambda: qwen2.init_cache(cfg, 1, 1024, torch.bfloat16, "cuda"), 64, 1,
        {"K4": k4.LAUNCHES}, weights, {"K4": ("K4",)})
    check(res["b1"]["counts"]["K4"] == k4_step_launches(n_layers) * 64,
          f"11b: K4 launches {res['b1']['counts']['K4']} != {k4_step_launches(n_layers)} per step")
    # sampled: the draws captured with a generator registered to the graph
    sp = SamplingParams(greedy=False, temperature=0.7, top_p=0.9)
    res["sampled"] = decode_loop_run(
        "11b-sampled int8 7B decode, top-p 0.9 at temperature 0.7, 16 tokens", qlm, cfg,
        lambda: qwen2.init_cache(cfg, 1, 1024, torch.bfloat16, "cuda"), 15, 1,
        {"K4": k4.LAUNCHES}, {"K4": ("K4",)}, spec=gen.DecodeSpec(16, sampling=sp),
        timed_runs=1)
    sampled_ids = res["sampled"]["ids"][0].tolist()
    check(len(set(sampled_ids[1:])) > 1, f"11b sampled: ids all one token {sampled_ids}")
    log(f"11b sampled: graph and eager draw the same ids from seed 0: {sampled_ids}")
    hd = cfg.resolved_head_dim()
    q8_bytes = 2 * n_layers * 8 * 8192 * cfg.num_kv_heads * (hd + 4)
    res["b8"] = timed_decode(
        "11c-q8 int8 7B decode, q8 cache b8 c8192", qlm, cfg,
        lambda: qwen2.init_cache_q8(cfg, 8, 8192, "cuda"), 32, 8, {"K4": k4.LAUNCHES},
        weights + q8_bytes, {"K4": ("K4",)})
    check(res["b8"]["counts"]["K4"] == k4_step_launches(n_layers) * 32,
          f"11c: K4 launches {res['b8']['counts']['K4']} != {k4_step_launches(n_layers)} per step")
    log(f"11c: the q8 cache holds {q8_bytes / 1e9:.3f} GB of codes and scales, read every step")
    w4 = qwen2.quantized_lm(random_quantized_lm_w4(torch.Generator(device="cuda").manual_seed(0),
                                                   cfg, "cuda"), torch.bfloat16, "cuda")
    counters = {"K4": k4.LAUNCHES, "K5": k5.LAUNCHES, "K6A": k6.LAUNCHES_A,
                "K6B": k6.LAUNCHES_B}
    res["w4"] = timed_decode(
        "11c-w4 int4 7B decode, q8 cache b1 c1024", w4, cfg,
        lambda: qwen2.init_cache_q8(cfg, 1, 1024, "cuda"), 32, 1, counters,
        lm_step_bytes(w4) + 2 * n_layers * 1024 * cfg.num_kv_heads * (hd + 4),
        {"K4": ("K4",), "K5": ("K5",), "K6": ("K6A", "K6B")})
    want = {"K4": 32, "K5": 32, "K6A": n_layers * 32, "K6B": n_layers * 32}
    check(res["w4"]["counts"] == want, f"11c w4: launches {res['w4']['counts']} != {want}")
    del w4
    return res


def int8_clip_phase(k4, wav) -> dict:
    """11d. The 30 s clip on the int8 LM: the bf16 AF3 at full width with its LM quantized
    on the card as load(quantize_lm=True) does; generate() twice, greedy, 32 tokens, decode
    replaying the captured step (the first run captures it): identical ids, 113 K4
    launches per decode step (the replays count the captured launches, the capture's
    warm-up step its own) plus the prefill's head (and its products where its rows are at
    most KERNEL_MAX_ROWS), decode tok/s (the first run, uninstrumented) and K4's time in
    the second (CUDA events around the prefill's launches, the profiled replay's K4 time
    per decode step); generate(stream=True), one replay a token, yields the ids that
    runtime/generate.generate gives on the same (unpadded) prompt; the captured step
    against the eager one on that prompt (graph_against_eager, 113 K4 in one replay by
    torch.profiler); the prefill's K4 launches and the eager step's replayed against the
    plain version, each shape timed with its plain version, library call and bound; and
    AudioFlamingo.generate sampled (top-p 0.9 at temperature 0.7, 16 tokens) twice from
    one seed: the same ids."""
    from audio_flamingo_tpu_torch.config import AF3Config
    from audio_flamingo_tpu_torch.models import qwen2
    from audio_flamingo_tpu_torch.ops.quant import KERNEL_MAX_ROWS
    from audio_flamingo_tpu_torch.ops.sampling import SamplingParams
    from audio_flamingo_tpu_torch.runtime import generate as gen

    w8 = a8_models(with_flash(AF3Config(), True))
    n_layers = w8.cfg.lm.num_layers
    runs = []
    for i in range(2):
        k4.LAUNCHES.reset()
        k4.LAUNCHES.timing, k4.LAUNCHES.capture = i == 1, i == 1
        text, _, split = timed_generate(w8, sound=wav, prompt="What do you hear?",
                                        max_new_tokens=32)
        out = w8.last_output
        run = dict(ids=out.tokens[0, : int(out.lengths[0])].tolist(), steps=out.decode_steps,
                   tps=out.decode_steps / out.decode_s, ttft=out.ttft_s,
                   proc=w8.last_processor_s, k4=k4.LAUNCHES.count, capture_s=out.capture_s,
                   k4_shapes=dict(k4.LAUNCHES.shapes), k4_ms=k4.LAUNCHES.device_ms())
        captured = list(k4.LAUNCHES.inputs)     # the prefill's: the replays keep none
        k4.LAUNCHES.timing = k4.LAUNCHES.capture = False
        k4.LAUNCHES.reset()
        log(f"int8 LM generate #{i + 1}: ids={run['ids'][:8]}... ({len(run['ids'])}) {split}; "
            f"decode {run['tps']:.1f} tok/s ({run['steps']} steps, the captured step replayed; "
            f"capture {out.capture_s:.2f}s outside ttft and decode); K4 launches {run['k4']}"
            + (" (this run brackets the prefill's K4 launches with CUDA events and keeps "
               "their inputs)" if i == 1 else ""))
        rows = max(key[0] for key in run["k4_shapes"])   # the prefill's rows, if on K4
        warm_step = int(out.capture_s > 0)   # the capture's eager step
        want = (k4_step_launches(n_layers) * (run["steps"] + warm_step) + 1
                + (4 * n_layers if rows > 1 else 0))
        check(run["k4"] == want and (rows == 1 or rows <= KERNEL_MAX_ROWS),
              f"int8 LM generate: K4 launches {run['k4']} != {k4_step_launches(n_layers)} per "
              f"decode step x {run['steps']} + 1 (the prefill's head)"
              + (f" + {4 * n_layers} (its {rows}-row products)" if rows > 1 else ""))
        check(bool(torch.isfinite(out.first_logits).all()), "int8 LM prefill logits not finite")
        runs.append(run)
    check(runs[0]["ids"] == runs[1]["ids"], f"int8 LM greedy ids differ: {[r['ids'] for r in runs]}")
    check(runs[0]["capture_s"] > 0 and runs[1]["capture_s"] == 0,
          "the int8 path did not capture its step once and reuse it")
    streamed = list(w8.generate(sound=wav, prompt="What do you hear?", max_new_tokens=32,
                                stream=True))
    batch = w8.processor(messages=[{"role": "user", "content": "<sound>What do you hear?"}],
                         audios=[wav])
    ids = torch.as_tensor(batch["ids"], device="cuda").long()
    ref = gen.generate(w8.model, w8.cfg, ids, batch["mels"], max_new_tokens=32,
                       eos_token_id=w8.eos_token_id)
    ref_ids = ref.tokens[0, : int(ref.lengths[0])].tolist()
    log(f"int8 LM generate(stream=True): {len(streamed)} ids {streamed[:8]}...; runtime "
        f"generate on the same unpadded prompt {'equal' if streamed == ref_ids else ref_ids}; "
        f"against the bucket-padded generate: {'equal' if streamed == runs[0]['ids'] else 'differs'}")
    check(streamed == ref_ids, "generate(stream=True) ids differ from generate's")
    held = gen.held_bytes()
    log(f"11d: held captured steps {held['steps']} (the stream's step was reused by generate "
        f"on the unpadded prompt: capture {ref.capture_s:.2f}s): cache "
        f"{held['cache'] / 2**20:.1f} MiB, state {held['state'] / 2**20:.2f} MiB, graph pools "
        f"{held['graph'] / 2**20:.1f} MiB")
    check(ref.capture_s == 0, "generate did not reuse the stream's captured step")

    # the captured step against the eager one on the unpadded prompt
    lm_cfg = w8.cfg.lm
    t_ids = ids.shape[1]
    capacity = -(-(t_ids + 32) // 128) * 128
    spec = gen.DecodeSpec(max_new_tokens=32, eos_token_id=w8.eos_token_id)

    def start(st, generator):
        _, logits = gen.prefill(w8.model, w8.cfg, ids, batch["mels"], capacity, cache=st.cache)
        gen.start_decode(st, spec, logits, ids, t_ids, generator)

    cmp = graph_against_eager(
        "11d int8 LM, the 30 s prompt", w8.model.lm, lm_cfg, spec,
        lambda: qwen2.init_cache(lm_cfg, 1, capacity, torch.bfloat16, "cuda"), start, 31,
        {"K4": k4.LAUNCHES}, keep_inputs=("K4",), groups={"K4": ("K4",)})
    check(cmp["prof"]["groups"]["K4"][0] == k4_step_launches(n_layers),
          f"11d: one replay holds {cmp['prof']['groups']['K4'][0]} K4 kernels, not "
          f"{k4_step_launches(n_layers)}")
    captured += cmp["inputs"]["K4"][: k4_step_launches(n_layers)]
    for run in runs:   # K4's device time in the path: the prefill's events + the replays
        run["k4_ms"] += cmp["prof"]["groups"]["K4"][1] * run["steps"]

    # sampled through the API: one seed, the same draws in the graph
    sp = SamplingParams(greedy=False, temperature=0.7, top_p=0.9)
    sampled = [w8.generate(sound=wav, prompt="What do you hear?", max_new_tokens=16,
                           sampling=sp, seed=3) for _ in range(2)]
    sampled_ids = [w8.last_output.tokens[0].tolist()]
    log(f"11d sampled generate (top-p 0.9, temperature 0.7, 16 tokens, seed 3) twice: "
        f"{'equal' if sampled[0] == sampled[1] else 'different'} answers; ids {sampled_ids}")
    check(sampled[0] == sampled[1], "sampled generate from one seed differs between runs")
    warm = runs[1]
    # the prefill's launches and the first decode step's, replayed; per shape the plain
    # version, the library call and the bound, weighted by the launches
    head_key = next(k for k in warm["k4_shapes"] if k[2] == (w8.cfg.lm.vocab_size,))
    tot = dict(err=0.0, ratio=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    by = set()
    for x, prods, od in captured:
        ys = k4.w8a16_matmul_group(x, [{"w_q": w, "scale": sc} for w, sc in prods], od) \
            if len(prods) > 1 else [k4.w8a16_matmul(x, *prods[0], od)]
        for y, (w_q, scale) in zip(ys, prods):
            r = w4_compare(y, k4.w8a16_matmul_reference(x, w_q, scale, od))
            check(r["ratio"] <= 1.0, f"main-path K4 launch: |y - plain| at {r['ratio']:.3f}")
            tot["err"], tot["ratio"] = max(tot["err"], r["err"]), max(tot["ratio"], r["ratio"])
    seen = set()
    for x, prods, od in captured:
        key = (x.shape[0], x.shape[1], tuple(w.shape[1] for w, _ in prods),
               int(not prods[0][0].is_contiguous()))
        if key in seen:
            continue
        seen.add(key)
        n = warm["k4_shapes"][key]
        tot["plain_ms"] += n * sum(time_ms(lambda: k4.w8a16_matmul_reference(x, w_q, scale, od),
                                           5, 1) for w_q, scale in prods)
        for w_q, scale in prods:
            lib, _ = int8pack_call(x, w_q, scale)
            tot["library_ms"] = (None if lib is None or tot["library_ms"] is None
                                 else tot["library_ms"] + n * time_ms(lib, 5, 1))
            del lib
        b_ms, b_by = k4_bound_ms(x.shape[0], x.shape[1], sum(w.shape[1] for w, _ in prods),
                                 x.dtype, od)
        tot["bound_ms"] += n * b_ms
        by.add(b_by)
    tot["bound_by"] = "operations" if by == {"operations"} else "bytes"
    log(f"int8 LM warm generate: {warm['k4']} K4 launches ({len(seen)} shapes; the head "
        f"{warm['k4_shapes'][head_key]}), {warm['k4_ms']:.3f} ms device, {warm['k4_ms'] / warm['k4'] * 1e3:.1f} us "
        f"per launch; replayed (the prefill's launches and one decode step): max|y-plain|="
        f"{tot['err']:.3e} (at {tot['ratio']:.3f} of the limit); over every launch: plain "
        f"{tot['plain_ms']:.2f} ms, library "
        f"{'null' if tot['library_ms'] is None else f'{tot['library_ms']:.3f} ms'}, bound "
        f"{tot['bound_ms']:.3f} ms ({tot['bound_by']}); user TTFT "
        f"{(warm['proc'] + warm['ttft']) * 1e3:.1f} ms")
    del w8, captured
    log(f"11d: released the held captured steps ({gen.release_graphs() / 2**20:.1f} MiB)")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(warm=warm, path=tot, graph=cmp)


def codes_card_vs_cpu(tag: str) -> None:
    """ROADMAP Queue 3 item 8: quantize_kv's codes and scales, and the int4 group scales
    and packed codes, equal on the card and on the CPU for the same f32 inputs (both
    divide by a 0-dim tensor: a true division, where a Python divisor on the card goes
    through its reciprocal)."""
    from audio_flamingo_tpu_torch.models.qwen2 import quantize_kv
    from audio_flamingo_tpu_torch.ops.quant4 import quantize_linear_w4

    rng = np.random.default_rng(8)
    kv = torch.from_numpy((rng.standard_normal((4, 64, 4, 128))
                           * rng.uniform(0.01, 8.0, (4, 64, 4, 1))).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((1024, 512)) * 0.05).astype(np.float32))
    pairs = list(zip(quantize_kv(kv), quantize_kv(kv.cuda())))
    pairs += list(zip(quantize_linear_w4(w).values(), quantize_linear_w4(w.cuda()).values()))
    flips = [int((a != b.cpu()).sum()) for a, b in pairs]
    log(f"{tag}: quantize_kv codes/scales and int4 codes/group scales card vs CPU: "
        f"{flips} values differ (of {[a.numel() for a, _ in pairs]})")
    check(not any(flips), f"{tag}: quantized codes or scales differ card vs CPU: {flips}")


def f32_q8_card_vs_cpu_phase(fa, k4) -> None:
    """11e. f32, full width, 2 LM layers: the same int8 LM (quantized on the CPU, moved to
    the card) prefills 300 random ids through flash (K2 on the card) into a Q8KVCache and
    decodes 8 greedy steps on both; logits within 1e-4 of max|logit| at every step, ids
    token-exact, K4 on every card step; and item 8's codes card vs CPU."""
    from audio_flamingo_tpu_torch.config import AF3Config
    from audio_flamingo_tpu_torch.models import qwen2
    from audio_flamingo_tpu_torch.ops.quant import KERNEL_MAX_ROWS, quantize_lm_params

    codes_card_vs_cpu("11e")
    full = AF3Config().lm
    cfg = dataclasses.replace(full, num_layers=2, use_flash=True)
    t0 = time.perf_counter()
    with torch.device("meta"):
        flm = qwen2.Qwen2(cfg, dtype=torch.float32)
    flm = flm.to_empty(device="cpu")
    qwen2.init_(flm, torch.Generator().manual_seed(0))
    tree = quantize_lm_params(flm.state_dict())
    del flm
    lms = {"cpu": qwen2.quantized_lm(tree, torch.float32, "cpu"),
           "card": qwen2.quantized_lm(tree, torch.float32, "cuda")}
    del tree
    log(f"11e: f32 int8 LM, 2 layers at full width, quantized on the CPU and moved in "
        f"{time.perf_counter() - t0:.1f}s")
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, 150_000, (1, 300))).long()
    caches = {w: qwen2.init_cache_q8(cfg, 1, 320, w if w == "cpu" else "cuda") for w in lms}
    tok = {w: ids if w == "cpu" else ids.cuda() for w in lms}
    out = {w: [] for w in lms}
    errs = []
    fa.LAUNCHES.reset()
    k4.LAUNCHES.reset()
    with torch.inference_mode():
        for step in range(9):     # the flash prefill, then 8 decode steps
            logits = {}
            for w, lm in lms.items():
                dev = tok[w].device
                start = caches[w].host_index
                s = tok[w].shape[1]
                pos = torch.arange(start, start + s, device=dev)[None]
                h, caches[w] = qwen2.forward(lm, cfg, qwen2.embed(lm, tok[w]), pos,
                                             cache=caches[w], is_prefill=step == 0)
                logits[w] = qwen2.unembed(lm, h[:, -1]).cpu()
                out[w].append(int(logits[w].argmax()))
                tok[w] = logits[w].argmax(-1, keepdim=True).to(dev)
            errs.append(((logits["card"] - logits["cpu"]).abs().max()
                         / logits["cpu"].abs().max()).item())
    log(f"11e: f32 int8 LM on Q8KVCache card vs CPU: ids card {out['card']} CPU {out['cpu']}; "
        f"max|card - CPU| / max|logit| per step {[f'{e:.1e}' for e in errs]} (limit "
        f"{LOGITS_TOL}); K2 launches {fa.LAUNCHES.count}, K4 {k4.LAUNCHES.count}")
    check(out["card"] == out["cpu"], "11e: greedy ids differ card vs CPU")
    check(len(set(out["card"])) > 1, f"11e: greedy ids are all one token: {out['card']}")
    check(max(errs) <= LOGITS_TOL, f"11e: logits card vs CPU {max(errs)} > {LOGITS_TOL}")
    want = 9 + 8 * 4 * cfg.num_layers + (4 * cfg.num_layers if 300 <= KERNEL_MAX_ROWS else 0)
    check(fa.LAUNCHES.count == cfg.num_layers and k4.LAUNCHES.count == want,
          f"11e: launches K2 {fa.LAUNCHES.count}, K4 {k4.LAUNCHES.count} (expected {want})")
    del lms, caches


# ----------------------------------------------------------------------------------------
# 12. beam search, the slot engine and the beam lane

BEAM_K, BEAM_NEW = 4, 32            # 12a-12b: beams and new tokens on the 30 s clip
BEAM_SCORE_TOL = 1e-4               # 12d, f32 card vs CPU: beam scores
# one replay of the beam step split by kernel name (torch.topk's kernels; the cache rows'
# gather and small index_selects; the elementwise copies, the gather's write-back among them)
BEAM_GROUPS = {"top-k": ("TopK", "topk", "Radix", "radix", "Sort", "sort", "Blockwise",
                         "KthCounts"),
               "gather": ("indexSelect", "index_select", "IndexSelect"),
               "copy": ("direct_copy_kernel",)}
SLOT_ENGINE = dict(num_slots=4, capacity=4096, chunk=16, eos_token_id=ENGINE["eos_token_id"])
BEAM_STATE = ("i", "t", "logits", "run_seq", "run_sc", "fin_seq", "fin_sc", "is_fin",
              "heur_ok", "alive", "hist")


def clip_prompt(model, wav, prompt: str) -> tuple:
    """The processor's ids [1, T] on the card and mels of one clip and prompt."""
    batch = model.processor(messages=[{"role": "user", "content": f"<sound>{prompt}"}],
                            audios=[wav])
    return torch.as_tensor(batch["ids"], dtype=torch.long, device="cuda"), batch["mels"]


def lm_weight_bytes(lm, tied: bool) -> int:
    """Bytes a decode step reads of a float LM: every weight but the embedding table
    (read a row a token) unless it is the tied head."""
    return sum(p.numel() * p.element_size() for n, p in lm.named_parameters()
               if n != "embed_tokens" or tied)


def beam_graph_phase(model, fa, wav) -> dict:
    """12a. Beam search on the 30 s clip at full width, bf16, K = 4, 32 new tokens:
    api.generate(num_beams=4) twice (K2's 32 + 28 launches each) and generate_beam with
    every beam returned (its best beam is the answer); then the captured step (the held
    graph both used) against the eager step function from one prefill, 32 steps: every
    state tensor and the cache bit-identical, and unchanged by two replays after the
    search ended; ms per step of both beside the bound (the
    LM's weights, the gather's read and write of the K-row cache, the filled K/V read);
    one replay under set_sync_debug_mode("error"); two replays profiled: the top-k's, the
    gather's and the copies' share; the held graph's bytes."""
    from audio_flamingo_tpu_torch.runtime import beam
    from audio_flamingo_tpu_torch.runtime import generate as gen

    cfg, lm, eos = model.cfg, model.model.lm, model.eos_token_id
    prompt = "What do you hear?"
    ids, mels = clip_prompt(model, wav, prompt)
    t = ids.shape[1]
    capacity = -(-(t + BEAM_NEW) // 128) * 128
    fa.LAUNCHES.reset()
    answers, walls, k2_path = [], [], []
    for i in range(2):
        fa.LAUNCHES.timing, fa.LAUNCHES.capture = True, i == 1
        ms0 = fa.LAUNCHES.device_ms()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        answers.append(model.generate(sound=wav, prompt=prompt, num_beams=BEAM_K,
                                      max_new_tokens=BEAM_NEW))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        k2_path.append(fa.LAUNCHES.device_ms() - ms0)
    fa.LAUNCHES.timing = fa.LAUNCHES.capture = False
    k2_launches = list(fa.LAUNCHES.inputs)
    k2 = fa.LAUNCHES.count
    k2_want = 2 * (cfg.encoder.num_layers + cfg.lm.num_layers)
    check(k2 == k2_want, f"12a: {k2} K2 launches over two beam generates, not {k2_want}")
    check(answers[0] == answers[1], f"12a: two beam answers differ: {answers}")
    seqs, scores = beam.generate_beam(model.model, cfg, ids, mels, num_beams=BEAM_K,
                                      max_new_tokens=BEAM_NEW, eos_token_id=eos,
                                      num_return_sequences=BEAM_K)
    best = seqs[0, 0].tolist()
    if eos in best:
        best = best[: best.index(eos) + 1]
    check(model.processor.tokenizer.decode(best, skip_special=True) == answers[0],
          "12a: generate_beam's best beam is not api.generate's answer")
    check(bool(torch.isfinite(scores).all()) and bool((scores[0, :-1] >= scores[0, 1:]).all()),
          f"12a: beam scores not finite and best first: {scores.tolist()}")
    check(all(0 <= i < cfg.lm.vocab_size for i in seqs.flatten().tolist()), "12a: ids out of vocab")

    spec = beam.BeamSpec(BEAM_K, BEAM_NEW, eos)
    device = ids.device                     # the held step's key holds the device as given
    with torch.inference_mode():
        cache, logits0 = gen.prefill(model.model, cfg, ids, mels, capacity)
    search = beam.BeamSearch(model.model, cfg, spec, 1, capacity, device)
    check(search.capture_s == 0.0, "12a: the held beam step of the API's key was not reused")
    eager = beam.new_beam_state(cfg.lm, spec, 1, capacity, torch.bfloat16, device)

    def start():
        search.begin(logits0, cache, t, ids)
        with torch.inference_mode():
            beam.begin(eager, spec, logits0, cache, t, ids)

    def same_state() -> bool:
        st = search.state
        return (all(torch.equal(getattr(st, n), getattr(eager, n)) for n in BEAM_STATE)
                and torch.equal(st.cache.k, eager.cache.k) and torch.equal(st.cache.v, eager.cache.v)
                and torch.equal(st.cache.index, eager.cache.index))

    try:
        start()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            for _ in range(BEAM_NEW):
                beam.beam_body(lm, cfg.lm, spec, eager)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) / BEAM_NEW * 1e3
        t0 = time.perf_counter()
        for _ in range(BEAM_NEW):
            search.graph.replay()
        torch.cuda.synchronize()
        first_graph_ms = (time.perf_counter() - t0) / BEAM_NEW * 1e3
        st = search.state
        steps = int(st.i)
        check(same_state(), "12a: the captured step's state differs from the eager step's after "
                            f"{BEAM_NEW} steps")
        check(torch.equal(st.fin_seq, seqs) and torch.equal(st.fin_sc, scores),
              "12a: the compared run differs from generate_beam's")
        # JAX's loop runs no body once alive is false: two replays past the end change nothing
        check(not bool(st.alive), "12a: the search is alive after max_new_tokens steps")
        before = [getattr(st, n).clone() for n in BEAM_STATE]
        before += [st.cache.k.clone(), st.cache.v.clone(), st.cache.index.clone()]
        for _ in range(2):
            search.graph.replay()
        after = [getattr(st, n) for n in BEAM_STATE] + [st.cache.k, st.cache.v, st.cache.index]
        check(all(torch.equal(a, b) for a, b in zip(after, before)),
              "12a: a replay after the search ended changed the state")
        del before, after
        graph_times = []
        for _ in range(2):
            start()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(BEAM_NEW):
                search.graph.replay()
            torch.cuda.synchronize()
            graph_times.append((time.perf_counter() - t0) / BEAM_NEW * 1e3)
        graph_ms_ = statistics.median(graph_times)
        start()
        torch.cuda.set_sync_debug_mode("error")
        try:
            search.graph.replay()
            with torch.inference_mode():
                beam.beam_body(lm, cfg.lm, spec, eager)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check(same_state(), "12a: the synced-debug step's states differ")
        start()
        prof = profile_replays(search.graph, "12a", 2, BEAM_GROUPS)
        nbytes = search.graph.nbytes()
    finally:
        search.close()
    del eager, cache
    cache_bytes = nbytes["cache"]
    weights = lm_weight_bytes(lm, cfg.lm.tie_word_embeddings)
    per_pos = cache_bytes // capacity                       # K and V of one position, K rows
    kv_read = per_pos * (t + (steps + 1) / 2)               # the filled positions, on average
    bound_ms = (weights + 2 * cache_bytes + kv_read) / PEAK_BYTES * 1e3
    groups = {g: (n, ms) for g, (n, ms) in prof["groups"].items()}
    log(f"12a beam on the 30 s clip (bf16, K {BEAM_K}, {BEAM_NEW} new, prompt {t}, capacity "
        f"{capacity}): api.generate {walls[0]:.3f} s (capture included) and {walls[1]:.3f} s; "
        f"answer {answers[0]!r}; generate_beam's {BEAM_K} beams {seqs[0, :, :8].tolist()}... "
        f"scores {[round(x, 4) for x in scores[0].tolist()]}; the search ran {steps} steps")
    log(f"12a captured beam step against the eager step over {BEAM_NEW} steps from one "
        f"prefill: every state tensor and the cache bit-identical, and unchanged by two "
        f"replays after the search ended; {graph_ms_:.3f} ms per step "
        f"in the graph (median of 2 runs; {first_graph_ms:.3f} ms in the compared run) against "
        f"{eager_ms:.3f} ms eager; bound {bound_ms:.3f} ms (LM weights {weights / 1e9:.3f} GB + "
        f"the gather's read and write of the {cache_bytes / 1e6:.1f} MB cache + the filled K/V "
        f"{kv_read / 1e6:.1f} MB, at {PEAK_BYTES / 1e12:.2f} TB/s); one replay under "
        f"torch.profiler: {prof['kernels']:g} kernels, {prof['busy_ms']:.3f} ms busy of "
        f"{prof['span_ms']:.3f} ms (device busy {prof['busy_share'] * 100:.1f} %); "
        + ", ".join(f"{g} {n:g} kernels {ms:.3f} ms ({ms / prof['busy_ms'] * 100:.1f} %)"
                    for g, (n, ms) in groups.items())
        + f"; held graph: cache {nbytes['cache'] / 2**20:.1f} MiB, state "
        f"{nbytes['state'] / 2**20:.2f} MiB, graph pool {nbytes['graph'] / 2**20:.1f} MiB; "
        f"one replay and one eager step ran under set_sync_debug_mode('error')")
    k2_sums = k2_launch_sums(fa, k2_launches)
    log(f"12a K2 in the path: {len(k2_launches)} launches a beam generate, "
        f"{k2_path[1]:.3f} ms device time (CUDA events; {k2_path[0]:.3f} in the first), plain "
        f"{k2_sums['plain_ms']:.3f} ms, SDPA {k2_sums['library_ms']:.3f} ms, bound "
        f"{k2_sums['bound_ms']:.4f} ms ({k2_sums['bound_by']}), max|o - plain| "
        f"{k2_sums['err']:.3e}")
    return dict(ids=ids, mels=mels, seqs=seqs, scores=scores, k2=k2, graph_ms=graph_ms_,
                eager_ms=eager_ms, bound_ms=bound_ms, prof=prof, nbytes=nbytes, steps=steps,
                k2_path=dict(k2_sums, ms=k2_path[1], launches=len(k2_launches)))


def beam_lane_phase(model, ref: dict) -> dict:
    """12b. The beam lane on PagedEngine (bench.py's engine settings, lane chunk 8) beside
    two requests of 500 random ids, 32 greedy tokens each: the lane's sequences and scores
    equal generate_beam's on the same bucket-padded prompt bit for bit; the normal
    requests' ids equal those of a run without the lane."""
    from audio_flamingo_tpu_torch.config import bucket_tokens
    from audio_flamingo_tpu_torch.runtime import beam
    from audio_flamingo_tpu_torch.runtime.beam_lane import BeamRequest
    from audio_flamingo_tpu_torch.runtime.engine import Request
    from audio_flamingo_tpu_torch.runtime.paged_engine import PagedEngine

    eos = ENGINE["eos_token_id"]
    ids, mels = ref["ids"], ref["mels"]
    t = ids.shape[1]
    rng = np.random.default_rng(4)
    normal = [(f"n{i}", rng.integers(0, 150_000, (1, 500)).astype(np.int32)) for i in range(2)]

    def run(with_beam: bool):
        eng = PagedEngine(model=model.model, cfg=model.cfg, **ENGINE)
        for rid, x in normal:
            eng.submit(Request(request_id=rid, ids=x.copy(), max_new_tokens=BEAM_NEW))
        if with_beam:
            eng.submit_beam(BeamRequest(request_id="beam", ids=ids.cpu().numpy(), mels=mels,
                                        num_beams=BEAM_K, max_new_tokens=BEAM_NEW,
                                        num_return_sequences=BEAM_K))
            eng.beam_lane.chunk = 8
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.run_until_done()
        torch.cuda.synchronize()
        return out, dict(eng.finished_beams), time.perf_counter() - t0

    plain, _, wall0 = run(False)
    mixed, beams, wall1 = run(True)
    check(mixed == plain, "12b: the normal requests' ids changed beside the beam lane")
    check(set(beams) == {"beam"}, f"12b: the lane finished {sorted(beams)}")
    bucket = bucket_tokens(t)
    padded = torch.cat([ids, torch.full((1, bucket - t), max(eos, 0), dtype=torch.long,
                                        device=ids.device)], dim=1)
    capacity = -(-(bucket + BEAM_NEW) // 128) * 128
    want, want_sc = beam.generate_beam(model.model, model.cfg, padded, mels, prompt_len=t,
                                       capacity=capacity, num_beams=BEAM_K,
                                       max_new_tokens=BEAM_NEW, eos_token_id=eos,
                                       num_return_sequences=BEAM_K)
    got, got_sc = beams["beam"]
    check(np.array_equal(got, want[0].cpu().numpy()) and np.array_equal(got_sc, want_sc[0].cpu().numpy()),
          "12b: the lane's result differs from generate_beam's on the same padded prompt")
    unpadded = np.array_equal(got, ref["seqs"][0].cpu().numpy())
    log(f"12b beam lane on PagedEngine (chunk 8) beside 2 x 500-id requests: the lane's "
        f"{BEAM_K} beams and scores equal generate_beam's on the bucket-padded prompt ({t} -> "
        f"{bucket}) bit for bit; against 12a's unpadded prompt the beams are "
        f"{'equal' if unpadded else 'different'}; the normal ids equal a run without the lane "
        f"({wall0:.3f} s without, {wall1:.3f} s with)")
    return dict(wall_plain=wall0, wall_lane=wall1, unpadded_equal=unpadded)


def slot_engine_phase(model, fa, wav) -> dict:
    """12c. bench.py's mixed workload (3 prompts of 500 and 3 of 3800 random ids, 32 greedy
    tokens each) on BatchEngine (4 slots of 4096, chunk 16) and on PagedEngine (8b's
    settings), each after a warm-up instance, in this run: aggregate tok/s, TTFT from
    submit, K2's launches (28 per prefill), how many requests give the same ids."""
    from audio_flamingo_tpu_torch.runtime.engine import BatchEngine
    from audio_flamingo_tpu_torch.runtime.paged_engine import PagedEngine

    specs = mixed_workload(model, wav)[:6]
    make = {"slot": lambda: BatchEngine(model=model.model, cfg=model.cfg, **SLOT_ENGINE),
            "paged": lambda: PagedEngine(model=model.model, cfg=model.cfg, **ENGINE)}
    res = {}
    for name, mk in make.items():
        serve(mk(), specs[:2], WARM_TOKENS)                      # warm-up instance
        fa.LAUNCHES.reset()
        eng = mk()
        fa.LAUNCHES.timing = fa.LAUNCHES.capture = name == "slot"
        out, wall = serve(eng, specs, SERVE_TOKENS)
        fa.LAUNCHES.timing = fa.LAUNCHES.capture = False
        tokens = sum(len(v) for v in out.values())
        ttft = sorted(m["ttft_s"] for m in eng.request_metrics.values())
        res[name] = dict(out=out, wall=wall, tokens=tokens, tps=tokens / wall, ttft=ttft,
                         k2=fa.LAUNCHES.count)
        if name == "slot":   # K2 in the path: the launches' device time, plain, SDPA, bound
            launches, path_ms = list(fa.LAUNCHES.inputs), fa.LAUNCHES.device_ms()
            fa.LAUNCHES.reset()
            res[name]["k2_path"] = dict(k2_launch_sums(fa, launches), ms=path_ms,
                                        launches=len(launches))
            del launches
        check(set(out) == {rid for rid, _, _ in specs} and all(out.values()),
              f"12c {name}: not every request finished")
        check(res[name]["k2"] == len(specs) * model.cfg.lm.num_layers,
              f"12c {name}: {res[name]['k2']} K2 launches for {len(specs)} prefills")
        del eng
    same = sum(res["slot"]["out"][r] == res["paged"]["out"][r] for r in res["slot"]["out"])
    log(f"12c mixed workload (3 x 500 + 3 x 3800 ids, {SERVE_TOKENS} greedy tokens): " + "; ".join(
        f"{n} engine {r['tokens']} tokens in {r['wall']:.3f} s = {r['tps']:.1f} tok/s, TTFT "
        f"median {statistics.median(r['ttft']):.3f} s max {r['ttft'][-1]:.3f} s, K2 {r['k2']}"
        for n, r in res.items()) + f"; {same} of {len(specs)} requests give the same ids on "
        "both engines (bf16: their summation orders differ); K2 in BatchEngine's path: "
        f"{res['slot']['k2_path']['ms']:.3f} ms device (CUDA events), plain "
        f"{res['slot']['k2_path']['plain_ms']:.3f} ms, SDPA "
        f"{res['slot']['k2_path']['library_ms']:.3f} ms, bound "
        f"{res['slot']['k2_path']['bound_ms']:.4f} ms ({res['slot']['k2_path']['bound_by']})")
    return dict(res=res, same=same)


def captured_w4_checks(k5, k6, inputs: dict) -> dict:
    """Every captured K5 and K6 launch re-run on its inputs against its plain version
    (7a's tolerances)."""
    worst = {"K5": [0.0, 0.0], "K6A": [0.0, 0.0], "K6B": [0.0, 0.0]}

    def note(key, y, ref):
        r = w4_compare(y, ref)
        check(r["finite"] and r["ratio"] <= 1.0,
              f"12d {key} m={y.shape[0]}: |y - plain| at {r['ratio']:.3f} of its limit")
        worst[key] = [max(worst[key][0], r["err"]), max(worst[key][1], r["ratio"])]

    for x, w_p, gscale, layer in inputs["K5"]:
        if layer is None:
            note("K5", k5.w4a16_matmul(x, w_p, gscale), k5.w4a16_matmul_reference(x, w_p, gscale))
        else:
            note("K5", k5.w4a16_matmul_stacked(x, w_p, gscale, layer),
                 k5.w4a16_matmul_reference(x, w_p[layer], gscale[layer]))
    for args in inputs["K6A"]:
        for y, ref in zip(k6.w4_suffix_a(*args), k6.w4_suffix_a_reference(*args)):
            note("K6A", y, ref)
    for args in inputs["K6B"]:
        for y, ref in zip(k6.w4_suffix_b(*args), k6.w4_suffix_b_reference(*args)):
            note("K6B", y, ref)
    return worst


def captured_k4_checks(k4, inputs: list, tag: str = "12d") -> list:
    """Every captured K4 launch re-run on its inputs against the plain version of each of
    its products (K5's tolerances): [err, ratio]."""
    worst = [0.0, 0.0]
    for x, prods, od in inputs:
        ys = (k4.w8a16_matmul_group(x, [{"w_q": w, "scale": sc} for w, sc in prods], od)
              if len(prods) > 1 else [k4.w8a16_matmul(x, *prods[0], od)])
        for y, (w_q, scale) in zip(ys, prods):
            r = w4_compare(y, k4.w8a16_matmul_reference(x, w_q, scale, od))
            check(r["finite"] and r["ratio"] <= 1.0,
                  f"{tag} K4 m={x.shape[0]}: |y - plain| at {r['ratio']:.3f} of its limit")
            worst = [max(worst[0], r["err"]), max(worst[1], r["ratio"])]
    return worst


def k4_launch_timing(k4, captured: list) -> dict:
    """Per distinct shape of the captured K4 launches (x's K, the products' N, the output
    dtype, m), one launch timed: with the wrapper, as device time (one call in a CUDA graph,
    its own launch included), the plain version's, torch._weight_int8pack_mm's with its call
    and as device time the same way (a grouped launch: its products' summed), the bound; and
    how many launches had it."""
    timing = {}
    for x, prods, od in captured:
        key = (x.shape[1], tuple(w.shape[1] for w, _ in prods), str(od).split(".")[-1],
               x.shape[0])
        if key in timing:
            timing[key]["count"] += 1
            continue
        libs = [int8pack_call(x, w, sc)[0] for w, sc in prods]
        if len(prods) > 1:
            r = k4_group_case(k4, x, [{"w_q": w, "scale": sc} for w, sc in prods], od, True)
            r["plain_ms"] = sum(time_ms(lambda w=w, sc=sc: k4.w8a16_matmul_reference(
                x, w, sc, od), 5, 1) for w, sc in prods)
            r["library_ms"] = sum(time_ms(f, 5, 1) for f in libs) if all(libs) else None
        else:
            r = k4_case(k4, x, *prods[0], od, True)
        r["library_graph_ms"] = sum(graph_ms(f) for f in libs) if all(libs) else None
        del libs
        r["count"] = 1
        timing[key] = r
    k4.LAUNCHES.reset()
    return timing


def f32_beam_slot_phase(k4, k5, k6) -> dict:
    """12d. Full width, 2 + 2 layers, weights made on the CPU from a seed and moved to the
    card: (1) f32 beam search card vs CPU (K = 4, 12 new tokens, every beam: ids exact,
    scores within 1e-4); (2) BatchEngine card vs CPU and each request against generate()
    on the card; (3) ragged generate card vs CPU; (4) the int4 LM on BatchEngine at 4 rows
    in f32 (card vs CPU) and bf16, every K5 and K6 launch (m = 4) held to its plain version,
    K6 timed at m = 4 in bf16; (5) the int8 LM's beam at K = 4 in f32 (card vs CPU) and
    bf16, the launches of two eager steps (K4 at m = 4) held to the plain version, each
    K4 launch shape timed at m = 4 in bf16."""
    from audio_flamingo_tpu_torch.api import AudioFlamingo
    from audio_flamingo_tpu_torch.config import AF3Config
    from audio_flamingo_tpu_torch.models import af3, qwen2
    from audio_flamingo_tpu_torch.ops.quant import quantize_lm_params
    from audio_flamingo_tpu_torch.ops.quant4 import quantize_lm_params_w4
    from audio_flamingo_tpu_torch.runtime import beam
    from audio_flamingo_tpu_torch.runtime import generate as gen
    from audio_flamingo_tpu_torch.runtime.engine import BatchEngine

    full = AF3Config()
    cfg = with_flash(dataclasses.replace(
        full, encoder=dataclasses.replace(full.encoder, num_layers=2),
        lm=dataclasses.replace(full.lm, num_layers=2)), True)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    out: dict = {}
    try:
        cpu = f32_base(cfg)
        card = AudioFlamingo.from_state_dict(cpu.cfg, cpu.model.state_dict(),
                                             cpu.processor.tokenizer, torch.float32,
                                             device="cuda")
        eos = card.eos_token_id
        rng = np.random.default_rng(6)
        prompts = [rng.integers(0, 150_000, (1, n)).astype(np.int32) for n in (48, 80, 33, 61)]
        models = {"cpu": cpu.model, "card": card.model}
        on = {"cpu": lambda p: torch.as_tensor(p, dtype=torch.long),
              "card": lambda p: torch.as_tensor(p, dtype=torch.long, device="cuda")}
        beam_kw = dict(num_beams=BEAM_K, max_new_tokens=12, eos_token_id=eos,
                       num_return_sequences=BEAM_K)

        def beams_both(mods: dict, tag: str) -> tuple:
            got = {w: beam.generate_beam(m, cpu.cfg, on[w](prompts[0]), **beam_kw)
                   for w, m in mods.items()}
            seqs = {w: s.cpu() for w, (s, _) in got.items()}
            err = (got["card"][1].cpu() - got["cpu"][1]).abs().max().item()
            check(torch.equal(seqs["card"], seqs["cpu"]),
                  f"12d {tag}: beams differ card {seqs['card'][0].tolist()} vs CPU "
                  f"{seqs['cpu'][0].tolist()}")
            check(err <= BEAM_SCORE_TOL, f"12d {tag}: beam scores card vs CPU {err}")
            check(len(set(seqs["card"][0, 0].tolist())) > 1, f"12d {tag}: the best beam is one token")
            return seqs["card"], err

        # (1) the beam, f32
        seqs, err = beams_both(models, "f32 beam")
        log(f"12d f32 beam card vs CPU (2 + 2 layers, K {BEAM_K}, 12 tokens): {BEAM_K} beams "
            f"equal ({seqs[0, 0].tolist()}), scores max|card - CPU| {err:.3e} (limit "
            f"{BEAM_SCORE_TOL})")
        out["beam_err"] = err

        # (2) BatchEngine
        eng_kw = dict(num_slots=4, capacity=256, chunk=8, eos_token_id=eos)
        specs = [(f"r{i}", p, None) for i, p in enumerate(prompts)]
        res = {}
        for w, m in models.items():
            eng = BatchEngine(model=m, cfg=cpu.cfg, device="cpu" if w == "cpu" else None,
                              **eng_kw)
            res[w], _ = serve(eng, specs, 8)
        check(res["card"] == res["cpu"], f"12d BatchEngine ids differ card vs CPU")
        for rid, p, _ in specs:
            g = gen.generate(card.model, cpu.cfg, on["card"](p), max_new_tokens=8, eos_token_id=eos)
            want = g.tokens[0, : int(g.lengths[0])].tolist()
            n = min(len(want), len(res["card"][rid]))
            check(n >= 1 and res["card"][rid][:n] == want[:n],
                  f"12d BatchEngine {rid} != generate: {res['card'][rid]} vs {want}")
            check(len(set(res["card"][rid])) > 1, f"12d BatchEngine {rid} ids are one token")
        log(f"12d f32 BatchEngine (4 slots, chunk 8) card vs CPU: ids equal {res['card']}; "
            "each request's ids equal generate()'s on the card")

        # (3) ragged generate
        width = max(p.shape[1] for p in prompts)
        padded = np.stack([np.pad(p[0], (0, width - p.shape[1]), constant_values=0)
                           for p in prompts])
        plen = [p.shape[1] for p in prompts]
        rag = {w: gen.generate(m, cpu.cfg, on[w](padded), max_new_tokens=8, eos_token_id=eos,
                               prompt_len=torch.tensor(plen, device="cpu" if w == "cpu" else "cuda"))
               for w, m in models.items()}
        check(torch.equal(rag["card"].tokens.cpu(), rag["cpu"].tokens),
              "12d ragged generate ids differ card vs CPU")
        for r, p in enumerate(prompts):
            one = gen.generate(card.model, cpu.cfg, on["card"](p), max_new_tokens=8,
                               eos_token_id=eos)
            check(torch.equal(one.tokens[0], rag["card"].tokens[r]),
                  f"12d ragged row {r} differs from the row generated alone")
        log(f"12d ragged generate (prompt_len {plen}, width {width}) card vs CPU: ids equal, "
            "each row equal to the row generated alone on the card")

        # (4) the int4 LM on the slot engine at 4 rows
        counters = {"K5": k5.LAUNCHES, "K6A": k6.LAUNCHES_A, "K6B": k6.LAUNCHES_B,
                    "K4": k4.LAUNCHES}
        tree_cpu = quantize_lm_params_w4(cpu.model.lm.state_dict())
        tree_card = quantize_lm_params_w4(card.model.lm.state_dict())
        w4 = {}
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            m4 = af3.AF3Model(card.model.encoder, card.model.adaptor,
                              qwen2.quantized_lm(tree_card, dtype, "cuda"))
            for c in counters.values():
                c.reset()
                c.capture = True
            got, _ = serve(BatchEngine(model=m4, cfg=cpu.cfg, **eng_kw), specs, 8)
            counts = {n: c.count for n, c in counters.items()}
            shapes = {n: dict(c.shapes) for n, c in counters.items()}
            inputs = {n: list(c.inputs) for n, c in counters.items()}
            for c in counters.values():
                c.capture = False
                c.reset()
            check(all(counts[n] > 0 for n in ("K5", "K6A", "K6B", "K4")),
                  f"12d int4 slot engine {dn}: a kernel of the path did not launch: {counts}")
            check(all(k[0] == 4 for n in ("K6A", "K6B") for k in shapes[n]),
                  f"12d int4 slot engine {dn}: K6 launched at {shapes['K6A']}, not m = 4")
            worst = captured_w4_checks(k5, k6, inputs)
            worst["K4"] = captured_k4_checks(k4, inputs["K4"])
            if dtype == torch.float32:
                m4_cpu = af3.AF3Model(cpu.model.encoder, cpu.model.adaptor,
                                      qwen2.quantized_lm(tree_cpu, dtype, "cpu"))
                want, _ = serve(BatchEngine(model=m4_cpu, cfg=cpu.cfg, device="cpu", **eng_kw),
                                specs, 8)
                check(got == want, f"12d int4 slot engine f32 ids differ card vs CPU")
            timing = {}
            if dtype == torch.bfloat16:
                x5, wp5, gs5, l5 = next(a for a in inputs["K5"] if a[0].shape[0] == 4)
                wp5, gs5 = (wp5, gs5) if l5 is None else (wp5[l5], gs5[l5])
                lib5, why5 = int4pack_call(x5, wp5, gs5)
                timing["K5"] = dict(
                    ms=time_ms(lambda: k5.w4a16_matmul(x5, wp5, gs5)),
                    device_ms=graph_ms(lambda: k5.w4a16_matmul(x5, wp5, gs5), 20, 8),
                    plain_ms=time_ms(lambda: k5.w4a16_matmul_reference(x5, wp5, gs5), 5, 1),
                    library_ms=time_ms(lib5, 5, 1) if lib5 else None, library_why=why5,
                    bound=w4_bound_ms([k5_shape(wp5, gs5)], 4, dn),
                    shape=f"[4,{x5.shape[1]}]x[{wp5.shape[0]},{wp5.shape[1]}]")
                del lib5
                a, b = inputs["K6A"][0], inputs["K6B"][0]
                for key, fn, ref, args, gated in (
                        ("K6A", k6.w4_suffix_a, k6.w4_suffix_a_reference, a, True),
                        ("K6B", k6.w4_suffix_b, k6.w4_suffix_b_reference, b, False)):
                    timing[key] = dict(
                        ms=time_ms(lambda: fn(*args)), device_ms=graph_ms(lambda: fn(*args), 20, 8),
                        plain_ms=time_ms(lambda: ref(*args), 5, 1),
                        bound=suffix_bound_ms(args[3], args[4], 4, dn, gated))
            w4[dn] = dict(counts=counts, worst=worst, timing=timing)
            log(f"12d int4 LM on BatchEngine at 4 rows, {dn}: launches K5 {counts['K5']}, K6 A "
                f"{counts['K6A']}, K6 B {counts['K6B']}, K4 {counts['K4']} (m = 4); every launch "
                f"re-run against its plain version: max|y - plain| K5 {worst['K5'][0]:.3e}, K6 A "
                f"{worst['K6A'][0]:.3e}, K6 B {worst['K6B'][0]:.3e}, K4 {worst['K4'][0]:.3e} "
                f"(at most {max(v[1] for v in worst.values()):.3f} of the limits)"
                + ("; ids equal card vs CPU" if dtype == torch.float32 else "")
                + "".join(f"; {k} at m = 4 (layer 0{', ' + v['shape'] if 'shape' in v else ''}): "
                          f"{v['ms']:.4f} ms with the wrapper, "
                          f"{v['device_ms']:.4f} ms device, plain {v['plain_ms']:.3f} ms, "
                          + (f"torch._weight_int4pack_mm {v['library_ms']} ms ({v['library_why']}), "
                             if k == "K5" else "")
                          + f"bound {v['bound'][0]:.5f} ms ({v['bound'][1]})"
                          for k, v in timing.items()))
            del m4
        out["w4"] = w4

        # (5) the int8 LM's beam at K = 4
        tree8_cpu = quantize_lm_params(cpu.model.lm.state_dict())
        tree8_card = quantize_lm_params(card.model.lm.state_dict())
        k4.LAUNCHES.reset()
        seqs8, err8 = beams_both(
            {"cpu": af3.AF3Model(cpu.model.encoder, cpu.model.adaptor,
                                 qwen2.quantized_lm(tree8_cpu, torch.float32, "cpu")),
             "card": af3.AF3Model(card.model.encoder, card.model.adaptor,
                                  qwen2.quantized_lm(tree8_card, torch.float32, "cuda"))},
            "int8 f32 beam")
        k4_beam = k4.LAUNCHES.count
        check(k4_beam > 0, "12d int8 beam: K4 did not launch")
        k4.LAUNCHES.reset()
        k4_res = {}
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            m8 = af3.AF3Model(card.model.encoder, card.model.adaptor,
                              qwen2.quantized_lm(tree8_card, dtype, "cuda"))
            spec = beam.BeamSpec(BEAM_K, 12, eos)
            ids = on["card"](prompts[0])
            with torch.inference_mode():
                cache, logits0 = gen.prefill(m8, cpu.cfg, ids, None, 128)
                st = beam.new_beam_state(cpu.cfg.lm, spec, 1, 128, dtype, torch.device("cuda"))
                beam.begin(st, spec, logits0, cache, ids.shape[1], ids)
                k4.LAUNCHES.reset()
                k4.LAUNCHES.capture = True
                for _ in range(2):
                    beam.beam_body(m8.lm, cpu.cfg.lm, spec, st)
            k4.LAUNCHES.capture = False
            captured = list(k4.LAUNCHES.inputs)
            k4.LAUNCHES.reset()
            check(captured and all(x.shape[0] == BEAM_K for x, _, _ in captured),
                  f"12d int8 beam {dn}: K4 launches not at m = {BEAM_K}")
            worst = captured_k4_checks(k4, captured)
            timing = k4_launch_timing(k4, captured) if dtype == torch.bfloat16 else {}
            k4_res[dn] = dict(worst=worst, launches=len(captured), timing=timing)
            log(f"12d int8 LM beam at K = {BEAM_K}, {dn}: two eager steps' {len(captured)} K4 "
                f"launches (m = {BEAM_K}) re-run against the plain version: max|y - plain| "
                f"{worst[0]:.3e} (at {worst[1]:.3f} of the limit)"
                + "".join(f"; K4 [4,{k[0]}]x[{k[0]},{'|'.join(map(str, k[1]))}] -> {k[2]}: "
                          f"{r['ms']:.4f} "
                          f"ms with the wrapper, {r['graph_ms']:.4f} ms device, plain "
                          f"{r['plain_ms']:.3f} ms, torch._weight_int8pack_mm "
                          f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} ms, "
                          f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})"
                          for k, r in timing.items()))
            del m8, st, cache
        log(f"12d int8 f32 beam card vs CPU: {BEAM_K} beams equal ({seqs8[0, 0].tolist()}), "
            f"scores max|card - CPU| {err8:.3e}; {k4_beam} K4 launches on the card (the warm-up "
            f"step's and the replays')")
        out.update(k4=k4_res, k4_beam_launches=k4_beam, int8_beam_err=err8)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return out


# ----------------------------------------------------------------------------------------
# 13. speculative decoding: K3 over folded verify groups, dense speculation, the engines


SPEC_K = 4                      # draft proposals a round (JAX AudioFlamingo.spec_k)
VERIFY_GROUPS = (35, 64)        # g' = (k + 1) g: k = 4 at g = 7, and the kernel's limit


def k3_scores_bytes(lengths, block: int, max_pages: int, b: int, nkv: int, g: int) -> int:
    """The score pass's f32 scratch written and read back by the V pass: 64-key steps of
    every live page of every (row, kv head), g scores a key (csrc Scratch)."""
    pages = sum(min(-(-int(n) // block), max_pages) for n in lengths)
    steps = -(-block // 64)
    return 2 * pages * nkv * steps * 64 * g * 4


def verify_kernel_phase(pa) -> dict:
    """13a. K3 at the verify's folded groups: q [4, 4, g', 128] for g' = 35 (k = 4 at g = 7)
    and 64 (the limit), 8a's stacked pools [28, 88, 128, 4, 128] with shuffled tables, rows
    of {548, 3848, 1, 0} (checked at layers 0 and 27, a verify block of 5 tokens merged by
    merge_block_tokens) and 8a's mixed rows {548, 548, 3848, 3848} (timed at layer 5): bf16
    q over bf16 and int8 pools, f32 q over f32. Two launches bit-identical. Device time (10
    calls in a CUDA graph) beside the bound and beside five g = 7 calls on the same rows (the
    same verify as five decode calls); 8a's g = 7 shapes re-timed beside it."""
    n_layers, nb, block, nkv, g7, hd, mp = 28, 88, 128, 4, 7, 128, 32
    gen = torch.Generator(device="cuda").manual_seed(13)
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
    check_rows, mixed = [548, 3848, 1, 0], [548, 548, 3848, 3848]
    results = {}
    for q_dtype, kv_name in ((torch.bfloat16, "bfloat16"), (torch.bfloat16, "int8"),
                             (torch.float32, "float32")):
        if kv_name == "int8":
            pools = (k8, v8, ks, vs)
        else:
            dt = getattr(torch, kv_name)
            pools = (kf.to(dt), vf.to(dt), None, None)
        qn = str(q_dtype).split(".")[-1]
        q7 = torch.randn((4, nkv, g7, hd), generator=gen, device="cuda").to(q_dtype)
        tables_m, lengths_m = tables_for(mixed)
        args7 = (q7, pools[0], pools[1], tables_m, lengths_m, 5)
        call7 = lambda: pa.paged_attention(*args7, k_scale=pools[2], v_scale=pools[3])
        g7_ms = graph_ms(call7, calls=10)
        for gw in VERIFY_GROUPS:
            q = torch.randn((4, nkv, gw, hd), generator=gen, device="cuda").to(q_dtype)
            worst = dict(err=0.0, ratio=0.0, o_err=0.0, merged_err=0.0)
            tables, lengths = tables_for(check_rows)
            for layer in (0, n_layers - 1):
                args = (q, pools[0], pools[1], tables, lengths, layer, pools[2], pools[3], None)
                r = paged_compare(pa, args)
                check(r["ratio"] <= 1.0, f"K3 verify g' {gw} q {qn} pool {kv_name} layer "
                                         f"{layer}: at {r['ratio']:.3f} of its limit")
                if gw % g7 == 0:   # the verify's merge of its own 5-token block
                    s = gw // g7
                    o, m, l = pa.paged_attention(*args[:6], k_scale=args[6], v_scale=args[7])
                    o_p, m_p, l_p = pa.paged_attention_plain(*args[:6], k_scale=args[6],
                                                             v_scale=args[7])
                    fold = lambda x: x.reshape(4, nkv, s, g7, *x.shape[3:]).transpose(1, 2)
                    qg = fold(q.float())
                    kb = torch.randn((4, s, nkv, hd), generator=gen, device="cuda")
                    vb = torch.randn((4, s, nkv, hd), generator=gen, device="cuda")
                    got = pa.merge_block_tokens(qg, kb, vb, fold(o), fold(m), fold(l))
                    ref = pa.merge_block_tokens(qg, kb, vb, fold(o_p), fold(m_p), fold(l_p))
                    diff = (got - ref).abs()
                    lim = (PAGED_F32_TOL * ref.abs().max() if q_dtype == torch.float32
                           else PAGED_BF16_TOL[0] * ref.abs() + PAGED_BF16_TOL[1])
                    check(bool((diff <= lim).all()), f"K3 verify g' {gw} {qn}/{kv_name}: the "
                          f"merged block is off by {diff.max().item():.3e}")
                    worst["merged_err"] = max(worst["merged_err"], diff.max().item())
                for key in ("err", "ratio", "o_err"):
                    worst[key] = max(worst[key], r[key])
                first = pa.paged_attention(*args[:6], k_scale=args[6], v_scale=args[7])
                again = pa.paged_attention(*args[:6], k_scale=args[6], v_scale=args[7])
                check(all(torch.equal(a, b) for a, b in zip(first, again)),
                      f"K3 verify g' {gw} {qn}/{kv_name}: two launches differ")
            args = (q, pools[0], pools[1], tables_m, lengths_m, 5)
            call = lambda: pa.paged_attention(*args, k_scale=pools[2], v_scale=pools[3])
            plain = lambda: pa.paged_attention_plain(*args, k_scale=pools[2], v_scale=pools[3])
            r = dict(worst, ms=time_ms(call), plain_ms=time_ms(plain, 3, 1),
                     graph_ms=graph_ms(call, calls=10), g7_graph_ms=g7_ms,
                     five_g7_ms=5 * g7_ms, library_ms=None)
            r["bound_ms"], r["bound_by"] = paged_bound_ms(mixed, block, mp, tuple(q.shape),
                                                          q_dtype, pools[0].dtype)
            scores = k3_scores_bytes(mixed, block, mp, 4, nkv, gw)
            r["with_scratch_ms"] = r["bound_ms"] + scores / PEAK_BYTES * 1e3
            parts = pa.kernel_parts(4, nkv, mp, q.device, q.dtype, pools[0].dtype, gw)
            log(f"13a K3 verify g'={gw} q {qn:8s} pool {kv_name:8s}: max|o/l - plain| "
                f"{r['err']:.3e} (at {r['ratio']:.3f} of its limit), merged block "
                f"{r['merged_err']:.3e}, replays bit-identical; {parts} parts; mixed rows "
                f"{mixed}: device {r['graph_ms']:.4f} ms (10 calls in a graph; the call with "
                f"the wrapper {r['ms']:.4f}) against five g=7 calls {r['five_g7_ms']:.4f} ms "
                f"(one {g7_ms:.4f}); bound {r['bound_ms']:.5f} ms ({r['bound_by']}; "
                f"{r['with_scratch_ms']:.5f} with the scores scratch written and read, "
                f"{scores / 1e6:.2f} MB); plain {r['plain_ms']:.3f} ms; "
                f"{r['bound_ms'] / r['graph_ms'] * 100:.2f} % of the bound")
            results[(qn, kv_name, gw)] = r
        del pools
    del kf, vf, k8, v8, ks, vs
    torch.cuda.empty_cache()
    return results


def common_prefix(a: list, b: list) -> int:
    n = 0
    while n < min(len(a), len(b)) and a[n] == b[n]:
        n += 1
    return n


def spec_rounds(model, cfg, draft, draft_cfg, ids, mels, n: int, eos: int, *, graph: bool,
                body=None, every: int = 0) -> dict:
    """generate_speculative's greedy rounds (k = SPEC_K) driven from one start outside it:
    new_state, start (both prefills), then the round, replayed from a generate.DecodeGraph
    over it (graph=True, on the card) or stepped eagerly (spec_body, or ``body`` of the
    DecodeGraph signature), reading done and n_out every ``every`` rounds
    (generate.SYNC_EVERY by default, as generate_speculative reads done). Returns the
    finished tokens, the emitted ids, the rounds run, their device-synchronized seconds and
    the tokens emitted between reads (with every = 1, m + 1 a round before done)."""
    from audio_flamingo_tpu_torch.runtime import generate as gen
    from audio_flamingo_tpu_torch.runtime import speculative as sp

    every = every or gen.SYNC_EVERY
    spec = sp.SpecSpec(SPEC_K, n, eos)
    capacity = -(-(ids.shape[1] + n + SPEC_K + 1) // 128) * 128
    lm = model.lm
    run = body or (lambda lm_, cfg_, spec_, st_: sp.spec_body(lm_, cfg_, draft, draft_cfg,
                                                              spec_, st_))
    with torch.inference_mode():
        st = sp.new_state(cfg.lm, draft_cfg, spec, capacity, gen.compute_dtype(lm),
                          gen.compute_dtype(draft), ids.device)
        step = (gen.DecodeGraph(lm, cfg.lm, spec, st, body=run).replay if graph
                else lambda: run(lm, cfg.lm, spec, st))
        sp.start(model, cfg, draft, draft_cfg, spec, st, ids, mels, None)
        gen.sync(ids.device)
        t0 = time.perf_counter()
        rounds_run, emitted = 0, []
        while rounds_run + 1 < n and not bool(st.done):
            n0, todo = int(st.n_out), min(every, n - 1 - rounds_run)
            for _ in range(todo):
                step()
            rounds_run += todo
            emitted.append(int(st.n_out) - n0)
        gen.sync(ids.device)
        decode_s = time.perf_counter() - t0
        tokens, lengths = sp.finish(st.out, st.n_out, n, eos)
    tokens = tokens[0].tolist()
    return dict(tokens=tokens, ids=tokens[: int(lengths[0])], rounds_run=rounds_run,
                decode_s=decode_s, emitted=emitted)


def spec_dense_phase(model, fa, wav) -> dict:
    """13b. Dense speculation on the 30 s clip at full width: the bf16 7B as its own draft,
    k = 4, 32 tokens. api.generate with the draft twice (the second reuses the held round;
    one answer), the measured acceptance, ms per round replayed against the same round run
    eagerly, tok/s beside plain generate on the exact prompt, how many ids agree with plain
    greedy (the 5-token verify and the 1-token decode round differently in bf16, so they
    need not all agree); the same rounds stepped eagerly from spec_body (spec_rounds),
    timed, with every emitted token checked to be the argmax of the verify logits at its
    position; sampled (temperature 0.7, top-p 0.9)
    twice from one seed, one answer."""
    from audio_flamingo_tpu_torch.ops.sampling import SamplingParams
    from audio_flamingo_tpu_torch.runtime import generate as gen
    from audio_flamingo_tpu_torch.runtime import speculative as sp

    n, k, prompt = 32, SPEC_K, "What do you hear?"
    lm, cfg, eos = model.model.lm, model.cfg, model.eos_token_id
    ids, mels = clip_prompt(model, wav, prompt)
    plain = [gen.generate(model.model, cfg, ids, mels, max_new_tokens=n, eos_token_id=eos)
             for _ in range(2)][1]
    plain_ids = plain.tokens[0, : int(plain.lengths[0])].tolist()
    drafted = dataclasses.replace(model, draft=lm, draft_cfg=cfg.lm, spec_k=k)
    runs = []
    for _ in range(2):
        fa.LAUNCHES.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        text = drafted.generate(sound=wav, prompt=prompt, max_new_tokens=n)
        runs.append((text, drafted.last_spec, time.perf_counter() - t0, fa.LAUNCHES.count))
    (text, first, _, _), (text2, out, wall, k2) = runs
    check(text == text2, f"13b: two speculative generates differ: {text!r} vs {text2!r}")
    check(first.capture_s > 0 and out.capture_s == 0,
          f"13b: the round was not captured once and reused ({first.capture_s}, {out.capture_s})")
    k2_want = cfg.encoder.num_layers + 2 * cfg.lm.num_layers   # the encoder, both prefills
    check(k2 == k2_want, f"13b: {k2} K2 launches, not the encoder's and the two prefills' "
                         f"{k2_want}")
    spec_ids = out.tokens[0, : int(out.lengths[0])].tolist()
    check(len(spec_ids) == n or spec_ids[-1] == eos, f"13b: short answer {spec_ids}")

    # the same rounds stepped eagerly (spec_body from one start) and timed, instrumented:
    # every emitted token is the argmax of the verify's logits at its position
    rec, real_fwd = [], sp._forward_tokens

    def fwd(lm_, cfg_, cache, tokens, start):
        logits = real_fwd(lm_, cfg_, cache, tokens, start)
        if lm_ is lm and cfg_ is cfg.lm and tokens.shape[1] == k + 1 and rec[-1]["verify"] is None:
            rec[-1]["verify"] = logits[0].argmax(dim=-1)
        return logits

    def body(lm_, cfg_, spec, st):
        rec.append(dict(n0=st.n_out.clone(), done=st.done.clone(), verify=None))
        sp.spec_body(lm_, cfg_, lm, cfg.lm, spec, st)
        rec[-1]["n1"] = st.n_out.clone()

    sp._forward_tokens = fwd
    try:
        eager = spec_rounds(model.model, cfg, lm, cfg.lm, ids, mels, n, eos, graph=False,
                            body=body)
    finally:
        sp._forward_tokens = real_fwd
    check(eager["ids"] == spec_ids, f"13b: the eager rounds give other ids ({eager['ids']}) "
                                    f"than the captured round ({spec_ids})")
    got = eager["tokens"]
    n_checked = 0
    for r in rec:
        if bool(r["done"]):
            continue
        n0, n1, arg = int(r["n0"]), int(r["n1"]), r["verify"].tolist()
        for i in range(n1 - n0):
            if n0 + i < n:
                check(got[n0 + i] == arg[i], f"13b: emitted token {n0 + i} ({got[n0 + i]}) is "
                                             f"not the verify's argmax ({arg[i]})")
                n_checked += 1
    check(n_checked == len(eager["ids"]) - 1,
          f"13b: {n_checked} tokens checked against the verify, {len(eager['ids']) - 1} emitted")

    # the draft sees ids only: on the clip its context lacks the audio; on a text prompt
    # it sees what the target sees, and only the rounding of the 5-token verify against
    # the 1-token steps parts them
    text_ids = torch.as_tensor(np.random.default_rng(13).integers(0, 150_000, (1, 200)),
                               device="cuda")
    text = sp.generate_speculative(model.model, cfg, lm, cfg.lm, text_ids, k=k,
                                   max_new_tokens=n, eos_token_id=eos)
    sampled = SamplingParams(greedy=False, temperature=0.7, top_p=0.9)
    answers = [drafted.generate(sound=wav, prompt=prompt, max_new_tokens=n, sampling=sampled,
                                seed=0) for _ in range(2)]
    check(answers[0] == answers[1], "13b: sampled speculation from one seed gave two answers")
    r = dict(acceptance=out.acceptance, rounds=out.rounds, rounds_run=out.rounds_run,
             graph_round_ms=out.decode_s / out.rounds_run * 1e3,
             eager_round_ms=eager["decode_s"] / eager["rounds_run"] * 1e3,
             spec_tps=(len(spec_ids) - 1) / out.decode_s,
             plain_tps=plain.decode_steps / plain.decode_s,
             plain_step_ms=plain.decode_s / plain.decode_steps * 1e3,
             agree=common_prefix(spec_ids, plain_ids), n_ids=len(spec_ids), k2=k2,
             ttft_s=out.ttft_s, capture_s=first.capture_s, wall=wall, checked=n_checked,
             text_acceptance=text.acceptance, text_rounds=text.rounds)
    log(f"13b dense speculation, bf16 7B as its own draft, k {k}, 30 s clip, {n} tokens: "
        f"acceptance {r['acceptance']:.4f} over {out.rounds} rounds ({out.rounds_run} run); "
        f"{r['graph_round_ms']:.3f} ms a round replayed, {r['eager_round_ms']:.3f} ms eager; "
        f"decode {r['spec_tps']:.1f} tok/s against plain generate's {r['plain_tps']:.1f} "
        f"({r['plain_step_ms']:.3f} ms a step); {r['agree']} of {len(spec_ids)} ids agree "
        f"with plain greedy before the first difference; TTFT {out.ttft_s:.3f} s (both "
        f"prefills), capture {first.capture_s:.2f} s (first call only), {k2} K2 launches "
        f"(32 encoder, 28 + 28 prefills); "
        f"{n_checked} emitted tokens each the verify's argmax; on a text prompt of 200 random "
        f"ids (the draft's context then equals the target's): acceptance "
        f"{text.acceptance:.4f} over {text.rounds} rounds; sampled: one answer from one "
        f"seed; spec ids {spec_ids}; plain ids {plain_ids}")
    return r


SPEC_ENGINE = dict(num_slots=8, capacity=1024, chunk=16, eos_token_id=ENGINE["eos_token_id"])
SPEC_MAX_NEW = 16      # bench_spec_engine's 256 tokens a request, cut to fit the run (64 before
                       # phase 15, 32 before phase 16)
SPEC_TARGET_LAYERS = 14   # 13c's 7B int8 target at half its 28 layers, full width (its eager
                          # engines take time by the layer; cut to make room for phase 18)


def spec_engine_phase(pa, k4) -> dict:
    """13c. bench.py's bench_spec_engine cut to fit: the 7B int8 target at full width and
    SPEC_TARGET_LAYERS of its 28 layers (random_quantized_lm, seed 0) and a Qwen2.5-0.5B int8 draft (seed 1), 8 requests of 500
    random ids, SPEC_MAX_NEW greedy tokens each. BatchEngine (8 slots of 1024, chunk 16, k 4,
    6 rounds): plain, then spec_accept_sim 0.6 and 1.0 with the guard off, each after a
    warm-up instance: tok/s. PagedEngine (8b's settings, preempt off) with the same draft
    at a = 1.0 on a bf16 and an int8 pool: tok/s, one chunk's K3 verify launches (g' =
    35) kept, re-run against the plain version and replayed in one CUDA graph."""
    from audio_flamingo_tpu_torch.config import AF3Config, Qwen2Config
    from audio_flamingo_tpu_torch.models import af3, qwen2
    from audio_flamingo_tpu_torch.ops.quant import random_quantized_lm
    from audio_flamingo_tpu_torch.runtime.engine import BatchEngine, Request
    from audio_flamingo_tpu_torch.runtime.paged_engine import PagedEngine

    full = AF3Config()
    cfg = with_flash(dataclasses.replace(
        full, lm=dataclasses.replace(full.lm, num_layers=SPEC_TARGET_LAYERS)), True)
    tree = random_quantized_lm(torch.Generator(device="cuda").manual_seed(0), cfg.lm, "cuda")
    # text-only requests never run the encoder: its weights are allocated, not made
    model = af3.build(cfg, "cuda", torch.bfloat16,
                      lm=qwen2.quantized_lm(tree, torch.bfloat16, "cuda"))
    del tree
    dcfg = Qwen2Config.qwen25_0_5b()
    draft = qwen2.quantized_lm(random_quantized_lm(torch.Generator(device="cuda").manual_seed(1),
                                                   dcfg, "cuda"), torch.bfloat16, "cuda")
    rng = np.random.default_rng(13)
    specs = [(f"r{i}", rng.integers(0, 150_000, (1, 500)).astype(np.int32), None)
             for i in range(8)]
    warm = [("w", rng.integers(0, 150_000, (1, 500)).astype(np.int32), None)]
    spec_kw = dict(draft_params=draft, draft_cfg=dcfg, spec_k=SPEC_K, spec_rounds=6,
                   spec_guard=False)
    res = {}
    for name, kw in (("plain", {}), ("a0.6", dict(spec_kw, spec_accept_sim=0.6)),
                     ("a1.0", dict(spec_kw, spec_accept_sim=1.0))):
        serve(BatchEngine(model=model, cfg=cfg, **SPEC_ENGINE, **kw), warm, 8)
        k4.LAUNCHES.reset()
        eng = BatchEngine(model=model, cfg=cfg, **SPEC_ENGINE, **kw)
        out, wall = serve(eng, specs, SPEC_MAX_NEW)
        tokens = sum(len(v) for v in out.values())
        check(set(out) == {s[0] for s in specs} and all(out.values()),
              f"13c BatchEngine {name}: not every request finished")
        res[name] = dict(tps=tokens / wall, wall=wall, tokens=tokens, k4=k4.LAUNCHES.count,
                         stats=getattr(eng, "spec_stats", None))
        del eng
    # one BatchEngine chunk's K4 launches kept (a = 1.0, the slots filled first): those of
    # its first round, the draft's steps at m = 8 and the verify at m = 8 (k + 1), re-run
    # against the plain version
    eng = BatchEngine(model=model, cfg=cfg, **SPEC_ENGINE, **dict(spec_kw, spec_accept_sim=1.0))
    for rid, ids, mels in specs:
        eng.submit(Request(request_id=rid, ids=ids.copy(), mels=mels,
                           max_new_tokens=SPEC_MAX_NEW))
    eng._fill_slots()
    k4.LAUNCHES.reset()
    k4.LAUNCHES.capture = True
    try:
        eng.step()
    finally:
        k4.LAUNCHES.capture = False
    captured = list(k4.LAUNCHES.inputs)
    k4.LAUNCHES.reset()
    per_round = len(captured) // 6
    check(per_round > 0 and len(captured) == 6 * per_round,
          f"13c BatchEngine: one chunk made {len(captured)} K4 launches, not 6 rounds' alike")
    first = captured[:per_round]
    rows = collections.Counter(x.shape[0] for x, _, _ in first)
    check(set(rows) == {8, 8 * (SPEC_K + 1)},
          f"13c BatchEngine: a round's K4 launches at m {dict(rows)}, not 8 and 40")
    err, ratio = captured_k4_checks(k4, first, "13c")
    shapes = sorted({(x.shape[0], x.shape[1], "|".join(str(w.shape[1]) for w, _ in prods))
                     for x, prods, _ in first})
    # each distinct shape of the round timed alone (one launch in a CUDA graph), beside its
    # bound and the library call; the round's sums weight each by its launches
    timing = k4_launch_timing(k4, first)
    sums = {n: sum(r["count"] * r[n] for r in timing.values())
            for n in ("graph_ms", "plain_ms", "bound_ms")}
    sums["library_ms"] = (sum(r["count"] * r["library_ms"] for r in timing.values())
                          if all(r["library_ms"] is not None for r in timing.values()) else None)
    k4_round = dict(launches=len(first), rows=dict(rows), err=err, ratio=ratio, shapes=shapes,
                    timing=timing, **{"round_" + n: v for n, v in sums.items()})
    log("13c one BatchEngine round's K4 shapes, each one launch timed alone (device: one call "
        "in a CUDA graph): " + "; ".join(
            f"[{k[3]},{k[0]}]x[{k[0]},{'|'.join(map(str, k[1]))}] -> {k[2]} x {r['count']}: "
            f"device {r['graph_ms']:.4f} ms (with the wrapper {r['ms']:.4f}), bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}), plain {r['plain_ms']:.3f} ms, "
            f"torch._weight_int8pack_mm {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} ms"
            for k, r in timing.items())
        + f"; the round ({len(first)} launches): device {sums['graph_ms']:.3f} ms, bound "
        f"{sums['bound_ms']:.4f} ms, plain {sums['plain_ms']:.2f} ms, library "
        f"{sums['library_ms'] if sums['library_ms'] is None else round(sums['library_ms'], 3)} ms")
    del eng, captured, first
    paged = {}
    for pool in (torch.bfloat16, torch.int8):
        pname = "int8" if pool is torch.int8 else "bf16"
        make = lambda: PagedEngine(model=model, cfg=cfg, kv_dtype=pool, preempt=False,
                                   spec_accept_sim=1.0, **ENGINE, **spec_kw)
        serve(make(), warm, 8)
        pa.LAUNCHES.reset()
        k4.LAUNCHES.reset()
        eng = make()
        out, wall = serve(eng, specs, SPEC_MAX_NEW)
        tokens = sum(len(v) for v in out.values())
        check(set(out) == {s[0] for s in specs} and all(out.values()),
              f"13c PagedEngine {pname}: not every request finished")
        verify = sum(c for key, c in pa.LAUNCHES.shapes.items() if key[2] == 5 * 7)
        check(verify == pa.LAUNCHES.count and verify > 0,
              f"13c PagedEngine {pname}: {pa.LAUNCHES.count} K3 launches, {verify} at g' = 35")
        check(verify % (6 * cfg.lm.num_layers) == 0,
              f"13c PagedEngine {pname}: {verify} verify launches, not 6 rounds x 28 a chunk")
        counts, stats = dict(k3=pa.LAUNCHES.count, k4=k4.LAUNCHES.count), eng.spec_stats
        # one chunk's verify launches kept and replayed against the plain version
        eng = make()
        for rid, ids, mels in specs[:4]:
            eng.submit(Request(request_id=rid, ids=ids.copy(), mels=mels, max_new_tokens=24))
        eng._admit()
        pa.LAUNCHES.reset()
        pa.LAUNCHES.capture, pa.LAUNCHES.timing = True, True
        try:
            eng.step()
            path_ms = pa.LAUNCHES.device_ms()
        finally:
            pa.LAUNCHES.capture = pa.LAUNCHES.timing = False
        launches = list(pa.LAUNCHES.inputs)
        pa.LAUNCHES.reset()
        check(len(launches) == 6 * cfg.lm.num_layers,
              f"13c: one chunk made {len(launches)} K3 launches, not 6 x 28")
        worst = dict(err=0.0, ratio=0.0)
        for args in launches:
            check(args[0].shape[2] == 5 * 7, f"13c: a verify launch at g' {args[0].shape[2]}")
            r = paged_compare(pa, args)
            check(r["ratio"] <= 1.0, f"13c verify launch at {r['ratio']:.3f} of its limit")
            worst = {key: max(worst[key], r[key]) for key in worst}
        sums = launch_sums(pa, launches)
        graph = launches_graph_ms(pa, launches)
        paged[pname] = dict(tps=tokens / wall, wall=wall, tokens=tokens, counts=counts,
                            stats=stats, chunk_launches=len(launches),
                            path_ms=path_ms, graph_ms=graph, **sums, **worst)
        del eng
    log(f"13c bench_spec_engine cut to fit (7B int8 target at {SPEC_TARGET_LAYERS} of its 28 "
        f"layers, 0.5B int8 draft, 8 x 500 random ids, {SPEC_MAX_NEW} greedy tokens each; k {SPEC_K}, 6 rounds a chunk): BatchEngine "
        + "; ".join(f"{n} {r['tps']:.1f} tok/s ({r['tokens']} tokens in {r['wall']:.3f} s, "
                    f"{r['k4']} K4 launches)" for n, r in res.items())
        + f"; a = 0.6 is {res['a0.6']['tps'] / res['plain']['tps']:.2f}x plain, a = 1.0 "
        f"{res['a1.0']['tps'] / res['plain']['tps']:.2f}x (the k + 1 = 5x ceiling); PagedEngine "
        "at a = 1.0 " + "; ".join(
            f"{p} pool {r['tps']:.1f} tok/s, {r['counts']['k3']} K3 verify launches (g' = 35), "
            f"{r['counts']['k4']} K4; one chunk's {r['chunk_launches']} verify launches: "
            f"{r['path_ms']:.3f} ms in the path (CUDA events), {r['graph_ms']:.3f} ms in one "
            f"graph, plain {r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), max|o/l - plain| {r['err']:.3e}"
            for p, r in paged.items())
        + f"; BatchEngine a = 1.0, one round's {k4_round['launches']} K4 launches (m: "
        f"{k4_round['rows']}; [m, K] x N: {k4_round['shapes']}) re-run against the plain "
        f"version: max|y - plain| {k4_round['err']:.3e} (at {k4_round['ratio']:.3f} of the "
        "limit)")
    del model, draft
    return dict(slot=res, paged=paged, k4_round=k4_round)


SPEC_LIVELY = 3.0     # 13d's partial-accept target: its layer linears scaled (the CPU tests')
SPEC_PERTURB = 0.3    # and its draft: that target, noise on its last down_proj (x its std)


def lively_pair(lm, noise: float, seed: int = 5) -> tuple:
    """A target LM whose greedy ids vary (``lm`` with every layer linear's weights times
    SPEC_LIVELY, as the CPU tests' ``lively``) and a draft that agrees with it in part: the
    same LM with Normal(0, noise std(w)) added to its last layer's down_proj."""
    import copy

    lm = copy.deepcopy(lm)
    with torch.no_grad():
        for layer in lm.layers:
            for lin in (layer.q_proj, layer.k_proj, layer.v_proj, layer.o_proj,
                        layer.gate_proj, layer.up_proj, layer.down_proj):
                lin.weight.mul_(SPEC_LIVELY)
        draft = copy.deepcopy(lm)
        w = draft.layers[-1].down_proj.weight
        z = torch.randn(w.shape, generator=torch.Generator().manual_seed(seed))
        w.add_(z.to(w.device) * (noise * float(w.std())))
    return lm, draft


def partial_accept_case(cpu, card, prompt, held, n: int = 16) -> dict:
    """13d's dense case where a round accepts part of its proposals (0 < m < k): the
    lively_pair of the 2 + 2-layer f32 LM, made on the CPU and moved to the card, greedy,
    k = SPEC_K, ``n`` tokens. Plain generate on the CPU (the CPU tests hold the CPU's
    speculation to it), generate_speculative on the card (the held captured round), the
    same rounds replayed one at a time from a captured round (m read after each) and plain
    generate on the card must give one list of ids."""
    from audio_flamingo_tpu_torch.models import af3
    from audio_flamingo_tpu_torch.runtime import generate as gen
    from audio_flamingo_tpu_torch.runtime import speculative as sp

    cfg, eos = cpu.cfg, cpu.eos_token_id
    lm, draft = lively_pair(cpu.model.lm, SPEC_PERTURB)
    g = gen.generate(af3.AF3Model(cpu.model.encoder, cpu.model.adaptor, lm), cfg,
                     torch.as_tensor(prompt).long(), max_new_tokens=n, eos_token_id=eos)
    on_cpu = g.tokens[0, : int(g.lengths[0])].tolist()
    target = af3.AF3Model(card.model.encoder, card.model.adaptor, lm.to("cuda"))
    draft.to("cuda")
    ids = torch.as_tensor(prompt).long().cuda()
    r = sp.generate_speculative(target, cfg, draft, cfg.lm, ids, k=SPEC_K, max_new_tokens=n,
                                eos_token_id=eos)
    on_card = r.tokens[0, : int(r.lengths[0])].tolist()
    held("partial-accept generate_speculative (card) against plain generate (CPU)", on_card,
         on_cpu, prompt, target)
    rounds = spec_rounds(target, cfg, draft, cfg.lm, ids, None, n, eos, graph=True, every=1)
    g = gen.generate(target, cfg, ids, max_new_tokens=n, eos_token_id=eos)
    plain = g.tokens[0, : int(g.lengths[0])].tolist()
    accepted = [e - 1 for e in rounds["emitted"]]
    check(rounds["ids"] == on_card, f"13d partial accept: the captured rounds one at a time "
                                    f"give {rounds['ids']}, generate_speculative {on_card}")
    check(on_card == plain, f"13d partial accept: speculative ids {on_card} != plain "
                            f"generate's {plain} on the card")
    check(any(0 < a < SPEC_K for a in accepted),
          f"13d partial accept: no round accepted part of its proposals (m {accepted})")
    del target, draft
    return dict(ids=plain, m=accepted, hist=dict(sorted(collections.Counter(accepted).items())))


def f32_spec_card_vs_cpu_phase() -> dict:
    """13d. f32, full width, 2 encoder + 2 LM layers, the same weights on the card and on
    the CPU, with a random 2-layer draft at Qwen2.5-0.5B's widths (vocabulary 151,936, so
    clamp and pad run): dense generate_speculative (k 4) on a text prompt, and
    partial_accept_case; BatchEngine and PagedEngine (f32 target; bf16 and int8 pools)
    with the draft on three requests. Ids token-exact card against CPU and, on the card, equal to the plain path's
    (generate, the engines without the draft). A divergence is reported with the top-2
    logit gap of the plain logits where it occurs; the check is not loosened."""
    import copy

    from audio_flamingo_tpu_torch.api import AudioFlamingo
    from audio_flamingo_tpu_torch.config import AF3Config, Qwen2Config
    from audio_flamingo_tpu_torch.models import af3, qwen2
    from audio_flamingo_tpu_torch.runtime import generate as gen
    from audio_flamingo_tpu_torch.runtime import speculative as sp
    from audio_flamingo_tpu_torch.runtime.engine import BatchEngine
    from audio_flamingo_tpu_torch.runtime.paged_engine import PagedEngine

    full = AF3Config()
    cfg = with_flash(dataclasses.replace(
        full, encoder=dataclasses.replace(full.encoder, num_layers=2),
        lm=dataclasses.replace(full.lm, num_layers=2)), True)
    dcfg = dataclasses.replace(Qwen2Config.qwen25_0_5b(), num_layers=2)
    cpu = f32_base(cfg)
    card = AudioFlamingo.from_state_dict(cpu.cfg, cpu.model.state_dict(), cpu.processor.tokenizer,
                                         torch.float32, device="cuda")
    d_cpu = qwen2.Qwen2(dcfg, dtype=torch.float32)
    qwen2.init_(d_cpu, torch.Generator().manual_seed(1))
    d_card = copy.deepcopy(d_cpu).to("cuda")
    eos = card.eos_token_id
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, 150_000, (1, n)).astype(np.int32) for n in (40, 90, 12)]
    n_new = 10

    def gap(model, ids, prefix):
        """The top-2 gap of the plain logits after the prompt and the common prefix."""
        seq = torch.cat([torch.as_tensor(ids).long(), torch.tensor([prefix])], dim=1)
        lg = af3.logits(model, cfg, seq.to("cuda"))[0, -1].float()
        top = lg.topk(2).values
        return float(top[0] - top[1])

    def held(name, got_card, got_cpu, ids=None, model=None):
        if got_card != got_cpu:
            msg = f"13d {name}: ids differ card vs CPU: {got_card} vs {got_cpu}"
            if ids is not None:
                p = common_prefix(got_card, got_cpu)
                msg += (f"; top-2 gap there {gap(model or card.model, ids, got_card[:p]):.3e} "
                        "(card)")
            check(False, msg)

    results = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        dense = {}
        for where, m, d in (("cpu", cpu, d_cpu), ("card", card, d_card)):
            out = sp.generate_speculative(m.model, m.cfg, d, dcfg,
                                          torch.as_tensor(prompts[0], device=m.device).long(),
                                          k=SPEC_K, max_new_tokens=n_new, eos_token_id=eos)
            dense[where] = out.tokens[0, : int(out.lengths[0])].tolist()
        held("generate_speculative", dense["card"], dense["cpu"], prompts[0])
        g = gen.generate(card.model, card.cfg, torch.as_tensor(prompts[0], device="cuda").long(),
                         max_new_tokens=n_new, eos_token_id=eos)
        plain = g.tokens[0, : int(g.lengths[0])].tolist()
        check(dense["card"] == plain, f"13d: speculative ids {dense['card']} != plain "
                                      f"generate's {plain} on the card")
        check(len(set(plain)) > 1, f"13d: the ids are one token repeated: {plain}")
        results["dense"] = dense["card"]
        results["partial"] = partial_accept_case(cpu, card, prompts[0], held)
        specs = [(f"r{i}", ids, None) for i, ids in enumerate(prompts)]
        engines = {"slot": (BatchEngine, dict(num_slots=2, capacity=256, chunk=4)),
                   "paged bf16": (PagedEngine, dict(num_rows=2, num_blocks=16, block_size=128,
                                                    max_blocks_per_seq=2, chunk=4, preempt=False,
                                                    kv_dtype=torch.bfloat16)),
                   "paged int8": (PagedEngine, dict(num_rows=2, num_blocks=16, block_size=128,
                                                    max_blocks_per_seq=2, chunk=4, preempt=False,
                                                    kv_dtype=torch.int8))}
        for name, (cls, kw) in engines.items():
            spec_kw = dict(spec_k=SPEC_K, spec_rounds=2, spec_guard=False, eos_token_id=eos)
            out = {}
            for where, m, d in (("cpu", cpu, d_cpu), ("card", card, d_card)):
                eng = cls(model=m.model, cfg=m.cfg, draft_params=d, draft_cfg=dcfg,
                          device=where if where == "cpu" else None, **kw, **spec_kw)
                out[where] = serve_any(eng, specs, n_new)
            plain = serve_any(cls(model=card.model, cfg=card.cfg, eos_token_id=eos, **kw),
                              specs, n_new)
            for rid, ids, _ in specs:
                held(f"{name} {rid}", out["card"][rid], out["cpu"][rid], ids)
            check(out["card"] == plain, f"13d {name}: speculative ids {out['card']} != the "
                                        f"plain engine's {plain}")
            results[name] = out["card"]
        part = results["partial"]
        log("13d f32 card vs CPU (2 + 2 layers at full width, a 2-layer 0.5B-width draft, "
            f"vocab {dcfg.vocab_size} against {cfg.lm.vocab_size}): generate_speculative, "
            "BatchEngine, PagedEngine with bf16 and int8 pools token-exact card vs CPU and "
            f"equal to the plain paths on the card: {results}; partial accept (the target's "
            f"layer linears x {SPEC_LIVELY}, its draft with noise {SPEC_PERTURB} std on the "
            f"last down_proj): {len(part['ids'])} ids equal in the held captured round, one "
            f"captured round at a time, plain generate on the card and on the CPU; m a round "
            f"{part['m']} (rounds by m: {part['hist']})")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return results


# ----------------------------------------------------------------------------------------
# 14. voice out: the trained vocoder, the streaming TTS head and session, Griffin-Lim, RVQ

VOICE_TOKENS = 64        # four TTS chunks of 16 tokens
VOICE_SAMPLES = 64 * 160   # a chunk's 64 mel frames at a 160-sample hop


def vocoder_phase() -> dict:
    """14a. The shipped trained vocoder on the card in f32: the asset loaded by
    default_vocoder() equals the CPU load; its held-out quality against the recorded
    vocoder_eval.json (the JAX test's bands and floors, tests/test_neural_vocoder.py);
    apply on 64 held-out frames card against CPU in both layouts, two launches
    bit-identical; stream_synthesize against apply."""
    import copy

    from audio_flamingo_tpu_torch.audio import neural_vocoder as nv

    t0 = time.perf_counter()
    check(os.path.exists(nv.ASSET), f"14a: the vocoder asset {nv.ASSET} is missing")
    voc = nv.default_vocoder()
    cfg = voc.cfg
    cpu = nv.load_vocoder(nv.ASSET, cfg, device="cpu")
    check(voc.device.type == "cuda" and all(
        torch.equal(a.cpu(), b) for a, b in zip(voc.voc.state_dict().values(),
                                                cpu.state_dict().values())),
          "14a: default_vocoder() on the card is not the asset's weights")
    with open(os.path.join(os.path.dirname(nv.ASSET), "vocoder_eval.json")) as f:
        rec = json.load(f)
    ev = nv.evaluate(voc.voc, cfg)
    corr = nv.envelope_correlation(voc.voc, cfg, num_speakers=16)
    check(abs(ev["mel_mse"] - rec["heldout_mel_mse"]) < 0.05 * max(rec["heldout_mel_mse"], 1e-6)
          and abs(corr - rec["heldout_envelope_corr"]) < 0.05
          and abs(ev["f0_mae_hz"] - rec["heldout_f0_mae_hz"])
          < max(0.2 * rec["heldout_f0_mae_hz"], 2.0),
          f"14a: the trained vocoder's quality {ev}, corr {corr:.4f} is off its record {rec}")
    check(ev["mel_mse"] < 1.0 and ev["f0_mae_hz"] <= 25.0 and corr > 0.5,
          f"14a: the trained vocoder misses the quality floors: {ev}, corr {corr:.4f}")

    # 64 held-out frames (the evaluation corpus's generator), their mel made on the CPU
    wav, _ = nv.synthetic_voice_batch(np.random.default_rng(123), 1, 0.64)
    mel = nv.VocoderMel(cfg, device="cpu")(wav)
    frames = mel.shape[1]
    legacy = nv.Vocoder(cfg, harmonic=False)     # the same generator without its source
    legacy.load_state_dict({k: v for k, v in cpu.state_dict().items()
                            if not k.startswith(("f0_head", "src"))})
    res = {}
    with torch.no_grad():
        for name, host, card in (("harmonic", cpu, voc.voc),
                                 ("legacy", legacy, copy.deepcopy(legacy).cuda())):
            y = nv.apply(card, cfg, mel.cuda())
            res[name] = dict(err=float((y.cpu() - nv.apply(host, cfg, mel)).abs().max()),
                             same=torch.equal(y, nv.apply(card, cfg, mel.cuda())),
                             ms=time_ms(lambda: nv.apply(card, cfg, mel.cuda()), 10, 2))
        # the harmonic bound: the F0 head's convs sum in another order on the card, so f0
        # moves by a few ulp; the source's phase integrates that over every earlier frame
        # and the frame's own ramp, at most 2 pi hop / sr (frames + 1) max|df0|; a voicing
        # change dv moves the source as a phase shift of sum(1/h) dv / H would. The
        # generator's sensitivity to a phase shift is measured on the CPU (phase0 = 1e-3
        # against 0), doubled for the linearization, plus the convs' own 1e-5
        f0_c, v_c = nv.predict_f0(voc.voc, cfg, mel.cuda())
        f0_h, v_h = nv.predict_f0(cpu, cfg, mel)
        df0 = float((f0_c.cpu() - f0_h).abs().max())
        dv = float((v_c.cpu() - v_h).abs().max())
        probe = 1e-3
        gain = float((nv.apply(cpu, cfg, mel, torch.full((1,), probe))
                      - nv.apply(cpu, cfg, mel, torch.zeros(1))).abs().max()) / probe
    dphi = 2 * np.pi * cfg.hop / cfg.sr * (frames + 1) * df0
    dphi_v = sum(1.0 / h for h in range(1, cfg.harmonics + 1)) * dv / cfg.harmonics
    bound = 1e-5 + 2 * gain * (dphi + dphi_v)
    res["harmonic"].update(df0=df0, dv=dv, gain=gain, dphi=dphi, bound=bound)
    check(res["legacy"]["err"] <= 1e-5, f"14a: legacy apply card vs CPU {res['legacy']}")
    check(res["harmonic"]["err"] <= bound, f"14a: harmonic apply card vs CPU {res['harmonic']}")
    check(res["harmonic"]["same"] and res["legacy"]["same"],
          "14a: two launches of apply on the card differ")

    # stream_synthesize against the full pass. The JAX tests' setups (tests/
    # test_neural_vocoder.py): random weights at channels 64, 64 random frames in chunks
    # of 16; legacy within 5e-5, harmonic within max 0.15, mean 2e-2. The trained vocoder
    # on 2 s of voice in the session's 64-frame chunks: the stream integrates the window's
    # edge F0 into its phase (JAX's design; the port's stream equals JAX's on the CPU), so
    # it departs from the full pass sample by sample and is held in the mel domain: its
    # log-mel against the full pass's closer than the vocoder's own recorded held-out
    # error, the envelopes correlated above 0.9
    tiny = nv.VocoderConfig(channels=64)
    band = {}
    for harmonic in (True, False):
        v = nv.init(tiny, harmonic, torch.Generator(device="cuda").manual_seed(0))
        m = torch.randn(64, 80, generator=torch.Generator(device="cuda").manual_seed(1),
                        device="cuda")
        with torch.no_grad():
            f = nv.apply(v, tiny, m[None], torch.zeros(1, device="cuda") if harmonic else None)
        d = np.abs(np.concatenate(list(nv.stream_synthesize(v, tiny, m.split(16))))
                   - f[0].cpu().numpy())
        band["harmonic" if harmonic else "legacy"] = (float(d.max()), float(d.mean()))
    check(band["legacy"][0] <= 5e-5 and band["harmonic"][0] < 0.15
          and band["harmonic"][1] < 2e-2, f"14a: stream_synthesize off apply: {band}")
    wav2, _ = nv.synthetic_voice_batch(np.random.default_rng(7), 1, 2.0)
    fe = nv.VocoderMel(cfg)
    mel2 = fe(wav2)[0]
    with torch.no_grad():
        full = nv.apply(voc.voc, cfg, mel2[None], torch.zeros(1, device="cuda"))[0].cpu().numpy()
    t1 = time.perf_counter()
    stream = np.concatenate(list(nv.stream_synthesize(voc.voc, cfg, mel2.split(64))))
    stream_s = time.perf_counter() - t1
    serr = np.abs(stream - full)
    ms, mf = fe(stream[None])[0], fe(full[None])[0]
    stream_mse = float(torch.mean((ms - mf) ** 2))
    a, b = ms - ms.mean(-1, keepdim=True), mf - mf.mean(-1, keepdim=True)
    stream_corr = float(((a * b).sum(-1) / torch.sqrt((a * a).sum(-1) * (b * b).sum(-1))).mean())
    check(stream.shape == full.shape and stream_mse < rec["heldout_mel_mse"]
          and stream_corr > 0.9, f"14a: the trained vocoder's stream off its full pass: mel "
                                 f"MSE {stream_mse:.4f}, envelope correlation {stream_corr:.4f}")
    r = dict(eval=ev, corr=corr, record=rec, apply=res, stream_max=float(serr.max()),
             stream_mean=float(serr.mean()), stream_mse=stream_mse, stream_corr=stream_corr,
             band=band, stream_s=stream_s, s=time.perf_counter() - t0)
    h = res["harmonic"]
    log(f"14a trained vocoder (the shipped asset, f32, card): mel MSE {ev['mel_mse']:.5f} "
        f"(recorded {rec['heldout_mel_mse']}), F0 MAE {ev['f0_mae_hz']:.2f} Hz (recorded "
        f"{rec['heldout_f0_mae_hz']}), envelope correlation {corr:.4f} (recorded "
        f"{rec['heldout_envelope_corr']}); apply on {frames} held-out frames card vs CPU: "
        f"legacy layout max|d| {res['legacy']['err']:.3e} (limit 1e-5), harmonic "
        f"{h['err']:.3e} (bound {bound:.3e}: max|df0| {df0:.3e} Hz -> phase {dphi:.3e} rad, "
        f"max|dv| {dv:.3e}, sensitivity {gain:.4f} per rad); two launches bit-identical; "
        f"apply {h['ms']:.3f} ms (legacy {res['legacy']['ms']:.3f} ms) with the host's "
        f"launches; stream_synthesize against apply, random weights at channels 64 in "
        f"16-frame chunks: legacy max {band['legacy'][0]:.3e}, harmonic max "
        f"{band['harmonic'][0]:.4f} mean {band['harmonic'][1]:.5f} (the JAX tests' bands "
        f"5e-5; 0.15, 2e-2); the trained vocoder over 2 s in 64-frame chunks: samples max "
        f"{serr.max():.4f} mean {serr.mean():.5f} (the window's edge F0 in the phase), mel MSE "
        f"{stream_mse:.4f} against the full pass (limit: the recorded held-out "
        f"{rec['heldout_mel_mse']}), envelope correlation {stream_corr:.4f} (limit 0.9), "
        f"{stream_s:.3f} s; 14a took {r['s']:.1f} s")
    return r


def voice_path_phase(model, fa, wav, counters: dict) -> dict:
    """14b. The voice path at full width: generate(stream=True) on the 30 s clip into
    speak_stream, a StreamingTTSSession with TTSConfig() (random weights from seed 0, on
    the card) and the trained vocoder, twice; Griffin-Lim (32 rounds) on the first run's
    mels."""
    from audio_flamingo_tpu_torch.audio import neural_vocoder as nv
    from audio_flamingo_tpu_torch.audio.vocoder import GriffinLim
    from audio_flamingo_tpu_torch.models import tts
    from audio_flamingo_tpu_torch.runtime import voice

    t0 = time.perf_counter()
    tcfg = tts.TTSConfig()
    head = tts.init(tcfg, torch.Generator(device="cuda").manual_seed(0)).requires_grad_(False)
    vocoder = nv.default_vocoder()
    spans = {"tts": [], "voc": [], "mels": []}

    def events():
        return [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    real_chunk = voice.synthesize_chunk

    def timed_chunk(*args, **kw):
        ev = events()
        ev[0].record()
        mel = real_chunk(*args, **kw)
        ev[1].record()
        spans["tts"].append(ev)
        spans["mels"].append(mel[0].clone())
        return mel

    class TimedVocoder:
        def mel_to_waveform(self, log_mel):
            ev = events()
            ev[0].record()
            out = vocoder.mel_to_waveform(log_mel)
            ev[1].record()
            spans["voc"].append(ev)
            return out

    runs = []
    voice.synthesize_chunk = timed_chunk
    try:
        for _ in range(2):
            for c in counters.values():
                c.reset()
            for v in spans.values():
                v.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ids = []
            sess = voice.StreamingTTSSession(tts=head, tts_cfg=tcfg, vocoder=TimedVocoder())

            def tap(stream):
                for tok in stream:
                    ids.append(tok)
                    yield tok

            start = time.perf_counter()
            stream = model.generate(sound=wav, prompt="What do you hear?", stream=True,
                                    max_new_tokens=VOICE_TOKENS)
            chunks, first = [], None
            for c in voice.speak_stream(tap(stream), sess):
                if first is None:
                    first = time.perf_counter() - start
                chunks.append(c)
            wall = time.perf_counter() - start
            torch.cuda.synchronize()
            runs.append(dict(ids=ids, chunks=chunks, first=first, wall=wall,
                             tts_ms=[a.elapsed_time(b) for a, b in spans["tts"]],
                             voc_ms=[a.elapsed_time(b) for a, b in spans["voc"]],
                             mels=list(spans["mels"]),
                             peak=torch.cuda.max_memory_allocated() / 2**30,
                             counts={n: c.count for n, c in counters.items()}))
    finally:
        voice.synthesize_chunk = real_chunk
    a, b = runs
    n_chunks = -(-len(a["ids"]) // tcfg.chunk_tokens)
    check(a["ids"] == b["ids"], f"14b: the two runs' ids differ: {a['ids']} vs {b['ids']}")
    check(len(a["chunks"]) == n_chunks == len(b["chunks"])
          and all(c.shape == (VOICE_SAMPLES,) for c in a["chunks"] + b["chunks"]),
          f"14b: {len(a['chunks'])} chunks of {[c.shape for c in a['chunks']]} for "
          f"{len(a['ids'])} tokens")
    check(all(np.array_equal(x, y) for x, y in zip(a["chunks"], b["chunks"])),
          "14b: the two runs' samples differ")
    samples = np.concatenate(a["chunks"])
    check(bool(np.isfinite(samples).all()) and float(np.abs(samples).max()) < 1.0,
          f"14b: samples not finite in (-1, 1): max|x| {np.abs(samples).max()}")
    for r in runs:
        others = {n: c for n, c in r["counts"].items() if n != "K2" and c}
        check(r["counts"]["K2"] == 60 and not others,
              f"14b: kernel launches {r['counts']}, not K2's 60 alone")
    gl = GriffinLim(n_iter=32)
    gl_s, gl_out = [], []
    for m in a["mels"]:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        gl_out.append(gl.mel_to_waveform(m))
        gl_s.append(time.perf_counter() - t1)
    check(all(o.shape == (VOICE_SAMPLES,) and np.isfinite(o).all() for o in gl_out),
          "14b: Griffin-Lim's waveform is not finite at the chunk's length")
    audio_s = samples.size / 16_000
    r = dict(ids=len(a["ids"]), chunks=len(a["chunks"]), samples=VOICE_SAMPLES,
             first_s=[q["first"] for q in runs], wall_s=[q["wall"] for q in runs],
             rtf=[audio_s / q["wall"] for q in runs],
             tts_ms=[statistics.median(q["tts_ms"]) for q in runs],
             voc_ms=[statistics.median(q["voc_ms"]) for q in runs],
             peak=[q["peak"] for q in runs], k2=a["counts"]["K2"],
             gl_ms=statistics.median(gl_s) * 1e3, s=time.perf_counter() - t0)
    log(f"14b voice path (bf16 7B generate(stream=True, {VOICE_TOKENS} tokens) on the 30 s "
        f"clip -> speak_stream, TTSConfig() f32 random (seed 0), the trained vocoder), two "
        f"runs: {r['ids']} ids, {r['chunks']} chunks of {VOICE_SAMPLES} samples "
        f"({audio_s:.2f} s of audio); time to the first audio chunk "
        + " / ".join(f"{x:.3f}" for x in r["first_s"]) + " s; whole stream "
        + " / ".join(f"{x:.3f}" for x in r["wall_s"]) + " s = "
        + " / ".join(f"{x:.2f}" for x in r["rtf"]) + " s of audio per wall second; per chunk "
        "(median, CUDA events) TTS " + " / ".join(f"{x:.3f}" for x in r["tts_ms"])
        + " ms (each: " + ", ".join(f"{x:.3f}" for x in a["tts_ms"]) + "), vocoder "
        + " / ".join(f"{x:.3f}" for x in r["voc_ms"]) + " ms (each: "
        + ", ".join(f"{x:.3f}" for x in a["voc_ms"]) + "); peak "
        + " / ".join(f"{x:.2f}" for x in r["peak"]) + f" GiB; {r['k2']} K2 launches a run and "
        f"no other kernel; ids and samples identical across the runs; Griffin-Lim (32 rounds) "
        f"on the same mels {r['gl_ms']:.1f} ms a chunk (median of {len(gl_s)}); 14b took "
        f"{r['s']:.1f} s; ids {a['ids']}")
    return r


def f32_voice_card_vs_cpu_phase() -> dict:
    """14c. f32 card against CPU at small size: a 2-layer TTSConfig at d 256 with speakers
    (synthesize_chunk within 1e-4, with and without a speaker), the RVQ codec (codes equal,
    decode within 1e-5), Griffin-Lim from one injected phase (4 rounds from the same
    magnitude within 1e-4; the magnitude's power within 1e-4 of its max)."""
    import copy

    from audio_flamingo_tpu_torch.audio import neural_vocoder as nv
    from audio_flamingo_tpu_torch.audio import rvq
    from audio_flamingo_tpu_torch.audio.vocoder import GriffinLim
    from audio_flamingo_tpu_torch.models import tts

    t0 = time.perf_counter()
    rng = np.random.default_rng(3)
    cfg = tts.TTSConfig(num_layers=2, num_speakers=4)
    head = tts.init(cfg, torch.Generator().manual_seed(3), device="cpu").requires_grad_(False)
    card = copy.deepcopy(head).cuda()
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, cfg.chunk_tokens)))
    prev = torch.as_tensor(rng.normal(size=(2, cfg.state_frames, cfg.n_mels)).astype(np.float32))
    tts_err = {}
    with torch.no_grad():
        for name, spk in (("no speaker", None), ("speakers [1, 3]", torch.tensor([1, 3]))):
            want = tts.synthesize_chunk(head, cfg, ids, prev, spk)
            got = tts.synthesize_chunk(card, cfg, ids.cuda(), prev.cuda(),
                                       None if spk is None else spk.cuda())
            tts_err[name] = float((got.cpu() - want).abs().max())
            check(tts_err[name] <= 1e-4, f"14c: synthesize_chunk ({name}) card vs CPU "
                                         f"{tts_err[name]:.3e}")
    rcfg = rvq.RVQConfig()
    codec = rvq.init(rcfg, torch.Generator().manual_seed(0),
                     data=torch.as_tensor(rng.normal(size=(1024, 80)).astype(np.float32)))
    ccard = copy.deepcopy(codec).cuda()
    x = torch.as_tensor(rng.normal(size=(2, 64, 80)).astype(np.float32))
    codes = rvq.encode(codec, rcfg, x)
    codes_c = rvq.encode(ccard, rcfg, x.cuda())
    check(torch.equal(codes, codes_c.cpu()), "14c: RVQ codes differ card vs CPU")
    dec_err = float((rvq.decode(ccard, rcfg, codes_c).cpu() - rvq.decode(codec, rcfg, codes))
                    .abs().max())
    check(dec_err <= 1e-5, f"14c: RVQ decode card vs CPU {dec_err:.3e}")
    wav, _ = nv.synthetic_voice_batch(np.random.default_rng(9), 1, 0.64)
    mel = nv.VocoderMel(device="cpu")(wav)[0]
    gl_h, gl_c = GriffinLim(n_iter=4, device="cpu"), GriffinLim(n_iter=4, device="cuda")
    phase = (torch.rand((mel.shape[0], 201), generator=torch.Generator().manual_seed(0))
             * (2 * np.pi) - np.pi)
    mag = gl_h._magnitude(mel)
    gl_err = float((gl_c.rounds(mag.cuda(), phase.cuda()).cpu() - gl_h.rounds(mag, phase))
                   .abs().max())
    power_h = torch.pow(10.0, mel) @ gl_h.mel_pinv
    power_err = float(((torch.pow(10.0, mel.cuda()) @ gl_c.mel_pinv).cpu() - power_h).abs().max())
    full_err = float((gl_c.from_phase(mel.cuda(), phase.cuda()).cpu()
                      - gl_h.from_phase(mel, phase)).abs().max())
    check(gl_err <= 1e-4 and power_err <= 1e-4 * float(power_h.abs().max()),
          f"14c: Griffin-Lim card vs CPU: rounds {gl_err:.3e}, power {power_err:.3e}")
    r = dict(tts=tts_err, rvq_decode=dec_err, gl_rounds=gl_err, gl_power=power_err,
             gl_from_phase=full_err, s=time.perf_counter() - t0)
    log(f"14c f32 card vs CPU: synthesize_chunk (2 layers, d 256) max|d| "
        + ", ".join(f"{n} {e:.3e}" for n, e in tts_err.items()) + f" (limit 1e-4); RVQ "
        f"(4 x 256 codes of 80) codes equal over {codes.numel()}, decode {dec_err:.3e}; "
        f"Griffin-Lim 4 rounds from one phase and magnitude {gl_err:.3e} (limit 1e-4), the "
        f"magnitude's power {power_err:.3e} (max {float(power_h.abs().max()):.1f}), from the "
        f"log-mel {full_err:.3e} (the sqrt of a power near zero is steep); 14c took "
        f"{r['s']:.1f} s")
    return r


AF2_TOKENS = 32          # greedy tokens of each AF2 generate (15a, 15b)
AF2_GATE = 0.5           # 15's random xattn gates: a zero gate makes its block an identity
AF2_SR = 48_000
AF2_PROMPT = "What do you hear?"
CUBLAS = ("nvjet", "gemm", "gemv", "xmma", "cutlass")   # cuBLAS kernel name parts


def clip48(seconds: int, seed: int, tone: float | None) -> np.ndarray:
    """A 48 kHz clip from a seed: a tone plus noise, or bench_clap's normal x 0.1."""
    rng = np.random.default_rng(seed)
    n = seconds * AF2_SR
    if tone is None:
        return (rng.normal(size=n) * 0.1).astype(np.float32)
    t = np.arange(n) / AF2_SR
    return (0.3 * np.sin(2 * np.pi * tone * t) + 0.05 * rng.standard_normal(n)).astype(np.float32)


def set_gates(model, value: float) -> None:
    with torch.no_grad():
        for block in model.xattn:
            block.alpha_xattn.fill_(value)
            block.alpha_dense.fill_(value)


def liven(model, seed: int, linear: float, embed: float) -> None:
    """Make a random 2 + 2-layer flamingo model lively, as the CPU tests' ``_lively``
    (tests/test_torch_flamingo.py) does: gates drawn from U(0.5, 1.5) and U(-1, 1), every
    LM layer linear times ``linear``, the token embedding times ``embed`` (OPT's position
    embedding x 30). Greedy ids then vary and depend on the audio; a random LM otherwise
    repeats one token. At the 3B's widths the tests' factors (3, 30) still repeat one
    token (the tied head then favours the last prompt token): 15c takes (10, 3)."""
    rng = np.random.default_rng(seed)
    lm = model.lm
    with torch.no_grad():
        for block in model.xattn:
            block.alpha_xattn.fill_(float(rng.uniform(0.5, 1.5)))
            block.alpha_dense.fill_(float(rng.uniform(-1.0, 1.0)))
        for layer in lm.layers:
            for lin in layer.modules():
                if isinstance(lin, torch.nn.Linear):
                    lin.weight.mul_(linear)
        if hasattr(lm, "pos_embed"):
            lm.embed.mul_(embed)
            lm.pos_embed.mul_(30.0)
        else:
            lm.embed_tokens.mul_(embed)
            if lm.lm_head is not None:
                lm.lm_head.mul_(embed)


def af2_inputs(af2, wav) -> dict:
    """AudioFlamingo2.generate's inputs, built as it builds them (processor, tower, the
    prompt right-padded with EOS to its bucket), with the CUDA-event ms of the processor
    (the CLAP mel; the tokenizer runs on the host meanwhile) and of the tower."""
    from audio_flamingo_tpu_torch.config import bucket_tokens

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    batch = af2.processor(messages=[{"role": "user", "content": f"<sound>{AF2_PROMPT}"}],
                          audios=[wav])
    ids = torch.as_tensor(batch["ids"], dtype=torch.long, device="cuda")
    ev[1].record()
    wins = af2.encode_audio(batch["mels"], batch["is_longer"])
    ev[2].record()
    torch.cuda.synchronize()
    t = ids.shape[1]
    bucket = bucket_tokens(t)
    ids = torch.cat([ids, torch.full((1, bucket - t), af2.eos_token_id, dtype=torch.long,
                                     device="cuda")], dim=1)
    return dict(ids=ids, wins=wins, plen=t if bucket != t else None, windows=wins.shape[2],
                mel_ms=ev[0].elapsed_time(ev[1]), tower_ms=ev[1].elapsed_time(ev[2]))


def af2_eager(af2, inp: dict, sampling=None, seed: int = 0, keep_step: int | None = None,
              counters: dict | None = None) -> dict:
    """The api's decode with the step run eagerly (models/flamingo.decode_body on a state
    of its own, no graph) from the same prefill: ids, ms per step; with ``keep_step`` the
    inputs and launch counts of ``counters`` in that step."""
    from audio_flamingo_tpu_torch.models import flamingo
    from audio_flamingo_tpu_torch.ops.sampling import SamplingParams
    from audio_flamingo_tpu_torch.runtime import generate as gen

    sampling = sampling or SamplingParams()
    counters = counters or {}
    spec = gen.DecodeSpec(AF2_TOKENS, af2.eos_token_id, sampling)
    ids, wins, plen = inp["ids"], inp["wins"], inp["plen"]
    b, t = ids.shape
    true_len = plen or t
    capacity = gen._capacity(t, true_len, AF2_TOKENS, 0)
    g = None if sampling.greedy else torch.Generator(device="cuda").manual_seed(seed)
    kept, counts, step_i = {}, {}, [0]
    with torch.inference_mode():
        st = flamingo.new_state(af2.model, af2.cfg, spec, b, capacity,
                                (b, wins.shape[1] * wins.shape[2], wins.shape[-1]), None,
                                torch.device("cuda"), g)
        _, media, logits = flamingo.prefill(af2.model, af2.cfg, ids, wins, capacity,
                                            prompt_len=plen, cache=st.cache)
        st.media.copy_(media)
        gen.start_decode(st, spec, logits, ids, true_len, g)

        def step():
            keep = step_i[0] == keep_step
            before = {n: c.count for n, c in counters.items()}
            for c in counters.values():
                c.inputs.clear()
                c.capture = keep
            flamingo.decode_body(af2.model, af2.cfg, spec, st)
            for n, c in counters.items():
                c.capture = False
                if keep:
                    kept[n], counts[n] = list(c.inputs), c.count - before[n]
            step_i[0] += 1

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = gen.run_decode(st, AF2_TOKENS, step)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / max(steps, 1) * 1e3
    return dict(ids=st.out[0].tolist(), ms=ms, steps=steps, inputs=kept, counts=counts)


def af2_prefill_ms(af2, inp: dict) -> float:
    """flamingo.prefill on the api's inputs, CUDA events around it (the audio transform, the
    36 xattn blocks and the LM over the bucket, the head at the last real row)."""
    from audio_flamingo_tpu_torch.models import flamingo
    from audio_flamingo_tpu_torch.runtime import generate as gen

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    capacity = gen._capacity(inp["ids"].shape[1], inp["plen"] or inp["ids"].shape[1],
                             AF2_TOKENS, 0)
    torch.cuda.synchronize()
    ev[0].record()
    flamingo.prefill(af2.model, af2.cfg, inp["ids"], inp["wins"], capacity,
                     prompt_len=inp["plen"])
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1])


def held_flamingo_graph():
    """The most recently used captured flamingo decode step that runtime/generate holds."""
    from audio_flamingo_tpu_torch.runtime import generate as gen

    graphs = [g for k, g in gen._HELD.items() if k[0] == "flamingo"]
    check(bool(graphs), "no captured flamingo decode step is held")
    return graphs[-1]


def af2_generate(af2, wav, counters: dict, **kw) -> dict:
    """One AudioFlamingo2.generate, every counter read from 0 just before it and just
    after; the wall time split into processor, tower, ttft and decode."""
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text = af2.generate(sound=wav, prompt=AF2_PROMPT, max_new_tokens=AF2_TOKENS, **kw)
    wall = time.perf_counter() - t0
    out = af2.last_output
    return dict(text=text, ids=out.tokens[0].tolist(), wall=wall, proc=af2.last_processor_s,
                tower=af2.last_tower_s, ttft=out.ttft_s, decode_s=out.decode_s,
                steps=out.decode_steps, capture_s=out.capture_s,
                tps=out.decode_steps / out.decode_s if out.decode_s > 0 else float("nan"),
                counts={n: c.count for n, c in counters.items()},
                finite=bool(torch.isfinite(out.first_logits).all()))


def k5_launch_timing(k5, captured: list) -> dict:
    """Per distinct shape of the captured K5 launches (m, K, N, dtype): held against the
    plain version, one launch timed with the wrapper and as device time (one call in a CUDA
    graph), the plain version's time, torch._weight_int4pack_mm's with its call and as
    device time the same way, and the bound; and how many launches had it."""
    timing = {}
    for x, w_p, gscale, layer in captured:
        wl, gl = (w_p, gscale) if layer is None else (w_p[layer], gscale[layer])
        k, n, group = k5_shape(wl, gl)
        dn = str(x.dtype).split(".")[-1]
        key = (x.shape[0], k, n, dn)
        if key in timing:
            timing[key]["count"] += 1
            continue
        call = ((lambda: k5.w4a16_matmul(x, w_p, gscale)) if layer is None else
                (lambda: k5.w4a16_matmul_stacked(x, w_p, gscale, layer)))
        r = w4_compare(call(), k5.w4a16_matmul_reference(x, wl, gl))
        r["ms"] = time_ms(call)
        r["graph_ms"] = graph_ms(call)
        r["plain_ms"] = time_ms(lambda: k5.w4a16_matmul_reference(x, wl, gl), 5, 1)
        lib, r["library_why"] = int4pack_call(x, wl, gl)
        r["library_ms"] = time_ms(lib, 5, 1) if lib else None
        r["library_graph_ms"] = graph_ms(lib) if lib else None
        del lib
        r["bound_ms"], r["bound_by"] = w4_bound_ms([(k, n, group)], x.shape[0], dn)
        r["count"] = 1
        timing[key] = r
    k5.LAUNCHES.reset()
    return timing


def shape_rows(timing: dict, kind: str) -> dict:
    """The kernels line's per-shape rows of k4_launch_timing / k5_launch_timing."""
    out = {}
    for key, r in timing.items():
        name = (f"[{key[3]},{key[0]}]x[{key[0]},{'|'.join(map(str, key[1]))}]->{key[2]}"
                if kind == "K4" else f"[{key[0]},{key[1]}]x[{key[1]},{key[2]}] {key[3]}")
        out[name] = {n: r.get(n) for n in ("count", "ms", "graph_ms", "plain_ms", "library_ms",
                                           "library_graph_ms", "bound_ms", "bound_by", "err",
                                           "ratio")}
    return out


def log_shapes(tag: str, kind: str, timing: dict) -> None:
    for name, r in shape_rows(timing, kind).items():
        lib = ("null" if r["library_ms"] is None else
               f"{r['library_ms']:.4f} ms with its call, {r['library_graph_ms']:.4f} ms device")
        log(f"{tag} {kind} {name} x{r['count']}: max|y-plain| {r['err']:.3e} (at "
            f"{r['ratio']:.3f} of the limit); {r['ms']:.4f} ms with the wrapper, "
            f"{r['graph_ms']:.4f} ms device (one call in a graph), plain {r['plain_ms']:.4f} ms, "
            f"library {lib}, bound {r['bound_ms']:.5f} ms ({r['bound_by']})")


def af2_int8_phase(k4, k5, k6) -> dict:
    """15a. AF2 at full width (AF2Config(): HTSAT-base with fusion, 3 audio-transform layers
    at 512, 36 xattn blocks of 32 heads; Qwen2.5-3B as an int8 tree from
    random_quantized_lm), the fusion stacks and the tower in bf16 from a seed, as bench.py's
    bench_clap builds it, the xattn gates set to AF2_GATE. AudioFlamingo2.generate, greedy,
    32 tokens, on a 30 s clip (3 windows, bucket 4) twice (the first captures the decode
    step, the second replays it) and on the 5-minute clip of bench_clap (30 windows):
    identical ids, K4 launches per generate (145 a step: q|k|v, o, gate|up, down in 36
    layers and the tied head; the 128-row prefill the same), no K5 or K6; the captured
    decode against the eager step function (models/flamingo.decode_body) on the same
    prefill: ids equal; sampled (top-p 0.9, temperature 0.7) twice from one seed: equal;
    a second 30 s clip right after the first through the same captured step, sampled: its
    ids equal its own eager run and differ from the first clip's (the media buffer is
    refilled); TTFT split into mel, tower and prefill (CUDA events); decode tok/s replayed
    and eager; one eager step's 145 K4 launches re-run against the plain version, each
    3B shape timed alone beside its bound, plain version and torch._weight_int8pack_mm;
    two replays profiled (K4 and cuBLAS shares); peak memory."""
    from audio_flamingo_tpu_torch.api import AudioFlamingo2
    from audio_flamingo_tpu_torch.config import AF2Config
    from audio_flamingo_tpu_torch.models import clap, flamingo, qwen2
    from audio_flamingo_tpu_torch.ops.quant import random_quantized_lm
    from audio_flamingo_tpu_torch.ops.sampling import SamplingParams
    from audio_flamingo_tpu_torch.runtime import generate as gen

    t_phase = time.perf_counter()
    cfg = AF2Config()
    n_layers = cfg.lm.num_layers
    g = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    qlm = qwen2.quantized_lm(random_quantized_lm(g, cfg.lm, "cuda"), torch.bfloat16, "cuda")
    model = flamingo.init_fusion(cfg, qlm, g, "cuda", torch.bfloat16)
    set_gates(model, AF2_GATE)
    tower = clap.build(cfg.clap, "cuda", torch.bfloat16)
    clap.init_(tower, g)
    af2 = AudioFlamingo2._assemble(cfg, model, tower, None, torch.device("cuda"))
    torch.cuda.synchronize()
    # a decode step reads every LM weight once (the tied int8 embedding as the head)
    lm_bytes = sum(v.numel() * v.element_size() for v in qlm.state_dict().values())
    xa_bytes = sum(p.numel() * p.element_size() for p in model.xattn.parameters())
    log(f"15a AF2 at full width: int8 Qwen2.5-3B ({lm_bytes / 1e9:.3f} GB), "
        f"{len(model.xattn)} xattn blocks ({xa_bytes / 1e9:.3f} GB bf16), "
        f"{sum(p.numel() for p in tower.parameters()) / 1e6:.1f} M HTSAT-base params, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    counters = {"K4": k4.LAUNCHES, "K5": k5.LAUNCHES, "K6A": k6.LAUNCHES_A, "K6B": k6.LAUNCHES_B}
    wav_a, wav_b = clip48(30, 1, 440.0), clip48(30, 2, 880.0)
    wav_5m = clip48(300, 0, None)
    step_k4 = k4_step_launches(n_layers)
    runs = {}
    for name, wav in (("30 s #1", wav_a), ("30 s #2", wav_a), ("5 min #1", wav_5m)):
        r = af2_generate(af2, wav, counters)
        warm = int(r["capture_s"] > 0)
        want = step_k4 * (1 + r["steps"] + warm)    # the 128-row prefill: one step's shapes
        check(r["counts"]["K4"] == want and r["counts"]["K5"] == 0
              and r["counts"]["K6A"] + r["counts"]["K6B"] == 0 and r["finite"],
              f"15a {name}: launches {r['counts']} (K4 should be {want}: {step_k4} x (the "
              f"prefill + {r['steps']} steps + {warm} warm-up)), finite logits {r['finite']}")
        runs[name] = r
        log(f"15a generate {name}: ids {r['ids'][:8]}...; call {r['wall'] * 1e3:.1f} ms = "
            f"processor {r['proc'] * 1e3:.1f} + tower {r['tower'] * 1e3:.1f} + ttft "
            f"{r['ttft'] * 1e3:.1f} + decode {r['decode_s'] * 1e3:.1f} ms; user TTFT "
            f"{(r['proc'] + r['tower'] + r['ttft']) * 1e3:.1f} ms; decode {r['tps']:.1f} tok/s "
            f"({r['steps']} steps replayed; capture {r['capture_s']:.2f} s outside ttft and "
            f"decode); K4 launches {r['counts']['K4']}")
    # one 5-minute run (its own captured step; a second was cut to make room for phase 16)
    check(runs["30 s #1"]["ids"] == runs["30 s #2"]["ids"], "15a 30 s: greedy ids differ "
                                                             "between runs")
    check(runs["30 s #1"]["capture_s"] > 0 and runs["30 s #2"]["capture_s"] == 0
          and runs["5 min #1"]["capture_s"] > 0,
          "15a: the decode step was not captured once a clip length and replayed")
    peak = torch.cuda.max_memory_allocated() / 2**30

    # the captured step against the eager one, and one eager step's K4 launches
    inp_a = af2_inputs(af2, wav_a)
    eager = af2_eager(af2, inp_a, keep_step=1, counters={"K4": k4.LAUNCHES})
    check(eager["ids"] == runs["30 s #2"]["ids"],
          f"15a: eager ids {eager['ids'][:8]} != captured {runs['30 s #2']['ids'][:8]}")
    check(eager["counts"]["K4"] == step_k4, f"15a: one eager step launched "
                                             f"{eager['counts']['K4']} K4, not {step_k4}")
    worst = captured_k4_checks(k4, eager["inputs"]["K4"], tag="15a")
    timing = k4_launch_timing(k4, eager["inputs"]["K4"])
    log_shapes("15a", "K4", timing)
    step_bound = sum(r["count"] * r["bound_ms"] for r in timing.values())
    k4_step_ms = sum(r["count"] * r["graph_ms"] for r in timing.values())

    # sampled: one seed twice, then a second clip through the same captured step
    sp = SamplingParams(greedy=False, temperature=0.7, top_p=0.9)
    sampled = [af2_generate(af2, wav, counters, sampling=sp, seed=3)
               for wav in (wav_a, wav_a, wav_b)]
    check(sampled[0]["ids"] == sampled[1]["ids"], "15a: sampled generate from one seed differs")
    check(sampled[2]["capture_s"] == 0, "15a: the second clip did not reuse the captured step")
    eager_b = af2_eager(af2, af2_inputs(af2, wav_b), sampling=sp, seed=3)
    check(eager_b["ids"] == sampled[2]["ids"],
          f"15a: the second clip's captured ids {sampled[2]['ids'][:8]} != its own eager run "
          f"{eager_b['ids'][:8]}")
    check(sampled[2]["ids"] != sampled[0]["ids"],
          "15a: both clips gave one sampled answer: the check of the media buffer saw nothing")
    log(f"15a sampled (top-p 0.9, temperature 0.7, seed 3): one clip twice equal "
        f"({sampled[0]['ids'][:6]}...); a second 30 s clip through the same captured step "
        f"{sampled[2]['ids'][:6]}... equals its own eager run and differs from the first")

    # TTFT split by CUDA events, both clips, warm
    split = {}
    for clip, wav in (("30 s", wav_a), ("5 min", wav_5m)):
        inp = af2_inputs(af2, wav)
        split[clip] = dict(mel_ms=inp["mel_ms"], tower_ms=inp["tower_ms"],
                           prefill_ms=af2_prefill_ms(af2, inp), windows=inp["windows"],
                           rows=inp["ids"].shape[1])
        s = split[clip]
        log(f"15a TTFT split, {clip} ({s['windows']} windows, {s['rows']}-row prompt), CUDA "
            f"events: mel {s['mel_ms']:.2f} ms, tower {s['tower_ms']:.2f} ms, prefill "
            f"{s['prefill_ms']:.2f} ms, sum {s['mel_ms'] + s['tower_ms'] + s['prefill_ms']:.2f} ms")

    # two replays of the 30 s clip's captured step profiled, from a fresh start (a replay
    # past the last token would write past the state's out)
    af2_generate(af2, wav_a, counters)
    graph = held_flamingo_graph()
    st, t = graph.state, inp_a["ids"].shape[1]
    with torch.inference_mode():
        _, media, logits = flamingo.prefill(af2.model, cfg, inp_a["ids"], inp_a["wins"],
                                            st.cache.capacity, prompt_len=inp_a["plen"],
                                            cache=st.cache)
        st.media.copy_(media)
        gen.start_decode(st, graph.spec, logits, inp_a["ids"], inp_a["plen"] or t, None)
    prof = profile_replays(graph, "15a", 2, {"K4": DECODE_KERNELS["K4"], "cuBLAS": CUBLAS})
    del graph, st
    warm = runs["30 s #2"]
    step_ms = 1e3 / warm["tps"]
    log(f"15a decode step (int8 3B + 36 bf16 xattn blocks): {step_ms:.3f} ms replayed "
        f"({warm['tps']:.1f} tok/s), {eager['ms']:.3f} ms eager; bound {(lm_bytes + xa_bytes) / PEAK_BYTES * 1e3:.3f} ms "
        f"({lm_bytes / 1e9:.3f} GB of int8 LM + {xa_bytes / 1e9:.3f} GB of xattn weights at "
        f"{PEAK_BYTES / 1e12:.2f} TB/s); K4 launches of one step summed alone {k4_step_ms:.3f} ms "
        f"device against their bound {step_bound:.3f} ms; one replay under torch.profiler: "
        f"{prof['kernels']:g} kernels, K4 {prof['groups']['K4'][0]:g} ({prof['groups']['K4'][1]:.3f} ms), "
        f"cuBLAS (the xattn and audio products, attention) {prof['groups']['cuBLAS'][0]:g} "
        f"({prof['groups']['cuBLAS'][1]:.3f} ms), busy {prof['busy_ms']:.3f} of "
        f"{prof['span_ms']:.3f} ms ({prof['busy_share'] * 100:.1f} %); peak memory {peak:.2f} GiB")
    check(prof["groups"]["K4"][0] == step_k4,
          f"15a: torch.profiler sees {prof['groups']['K4'][0]} K4 kernels in one replay")
    top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1][1])[:10]
    log("15a one replay's kernels by device time: " + "; ".join(
        f"{name[:70]} x{n:g} {ms:.3f} ms" for name, (n, ms) in top))
    res = dict(runs=runs, eager=eager, timing=timing, worst=worst, split=split, prof=prof,
               peak=peak, step_ms=step_ms, sampled=[s["ids"] for s in sampled],
               lm_bytes=lm_bytes, xa_bytes=xa_bytes,
               k4_launches=runs["30 s #2"]["counts"]["K4"])
    del eager["inputs"]
    return dict(res, af2=af2, s=time.perf_counter() - t_phase)


def af2_w4_phase(af2, k4, k5, k6, w4_state_seed: int = 1) -> dict:
    """15b. The same fusion stacks and tower with the LM as a fused-w4 tree: a bf16
    Qwen2.5-3B made on the card from a seed, quantize_lm_params_w4 on the card (what
    load(quantize_lm="int4") calls), the float LM freed. AudioFlamingo2.generate on the 30 s
    clip twice, greedy, 32 tokens: identical ids, per step 144 K5 (qkv, o, gate|up, down in
    36 layers; the 128-row prefill the same) and 1 K4 (the int8 head), no K6 (the suffixes
    cannot run between xattn blocks); one eager step's K5 launches re-run against the plain
    version, each 3B shape timed alone beside its bound, plain version and
    torch._weight_int4pack_mm."""
    import dataclasses as dc

    from audio_flamingo_tpu_torch.models import flamingo, qwen2
    from audio_flamingo_tpu_torch.ops.quant4 import quantize_lm_params_w4

    t_phase = time.perf_counter()
    cfg = af2.cfg
    n_layers = cfg.lm.num_layers
    with torch.device("meta"):
        flm = qwen2.Qwen2(cfg.lm, dtype=torch.bfloat16)
    flm = flm.to_empty(device="cuda").requires_grad_(False)
    qwen2.init_(flm, torch.Generator(device="cuda").manual_seed(w4_state_seed))
    t0 = time.perf_counter()
    qlm = qwen2.quantized_lm(quantize_lm_params_w4(flm.state_dict()), torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    del flm
    gc.collect()
    torch.cuda.empty_cache()
    check(qwen2.split_stacked_w4(qlm.layers) is not None, "15b: the w4 tree is not fused")
    w4 = dc.replace(af2, model=flamingo.FlamingoModel(af2.model.audio_transform,
                                                      af2.model.xattn, qlm),
                    history=[], last_output=None)
    counters = {"K4": k4.LAUNCHES, "K5": k5.LAUNCHES, "K6A": k6.LAUNCHES_A, "K6B": k6.LAUNCHES_B}
    wav = clip48(30, 1, 440.0)
    runs = []
    for i in range(2):
        r = af2_generate(w4, wav, counters)
        n = 1 + r["steps"] + int(r["capture_s"] > 0)
        check(r["counts"]["K5"] == 4 * n_layers * n and r["counts"]["K4"] == n
              and r["counts"]["K6A"] == r["counts"]["K6B"] == 0 and r["finite"],
              f"15b generate #{i + 1}: launches {r['counts']} (want K5 {4 * n_layers} and K4 1 "
              f"x {n}, no K6)")
        runs.append(r)
        log(f"15b w4 generate #{i + 1}: ids {r['ids'][:8]}...; user TTFT "
            f"{(r['proc'] + r['tower'] + r['ttft']) * 1e3:.1f} ms (ttft {r['ttft'] * 1e3:.1f}); "
            f"decode {r['tps']:.1f} tok/s ({r['steps']} steps, capture {r['capture_s']:.2f} s); "
            f"launches {r['counts']}")
    check(runs[0]["ids"] == runs[1]["ids"], "15b: greedy ids differ between runs")
    eager = af2_eager(w4, af2_inputs(w4, wav), keep_step=1,
                      counters={"K5": k5.LAUNCHES, "K6A": k6.LAUNCHES_A, "K6B": k6.LAUNCHES_B})
    check(eager["ids"] == runs[1]["ids"], "15b: eager ids differ from the captured run's")
    check(eager["counts"]["K5"] == 4 * n_layers and eager["counts"]["K6A"] == 0,
          f"15b: one eager step launched {eager['counts']}")
    worst = captured_w4_checks(k5, k6, {"K5": eager["inputs"]["K5"], "K6A": [], "K6B": []})
    timing = k5_launch_timing(k5, eager["inputs"]["K5"])
    log_shapes("15b", "K5", timing)
    step_bound = sum(r["count"] * r["bound_ms"] for r in timing.values())
    k5_step_ms = sum(r["count"] * r["graph_ms"] for r in timing.values())
    log(f"15b: quantize_lm_params_w4 of the bf16 3B on the card {quant_s:.1f} s; one step's "
        f"{4 * n_layers} K5 launches alone {k5_step_ms:.3f} ms device against their bound "
        f"{step_bound:.3f} ms; decode {1e3 / runs[1]['tps']:.3f} ms per step replayed, "
        f"{eager['ms']:.3f} ms eager; K6 launches in the flamingo path: 0")
    del eager["inputs"], w4, qlm
    return dict(runs=runs, timing=timing, worst=worst["K5"], eager_ms=eager["ms"],
                k5_launches=runs[1]["counts"]["K5"], k4_launches=runs[1]["counts"]["K4"],
                s=time.perf_counter() - t_phase)


def af2_f32_card_vs_cpu_phase() -> dict:
    """15c, 15d. f32 card against CPU at full width and 2 + 2 layers. 15c: the full
    HTSAT-base tower on one window's 4-channel mel with is_longer (the fusion branch), embeds
    within 1e-4; an AF2 of 2 LM layers at the 3B's widths and vocab with its 2 xattn blocks
    (made lively): flamingo.logits on the float LM and on its int8 and fused-w4 trees
    (quantized on the CPU, the trees moved) within 1e-4 of max|logit|, greedy generate
    token-exact (the card's step captured). 15d: AF1 at OPT-IML-1.3B's widths
    (AF1Config.make()) with 2 LM layers: greedy generate token-exact and
    logits_with_media_mask on 4 media x 4 windows in 'last' mode within 1e-4 of max|logit|.
    Both models are made lively (``liven``), and the CPU's greedy ids must not repeat one
    token, so that the token-exact check can see a wrong cache slot, position or media.
    cuDNN's TF32 is off for the tower's f32 convs."""
    import copy
    import dataclasses as dc

    from audio_flamingo_tpu_torch.config import AF1Config, AF2Config, OPTConfig, Qwen2Config
    from audio_flamingo_tpu_torch.models import clap, flamingo, qwen2
    from audio_flamingo_tpu_torch.ops.quant import quantize_lm_params
    from audio_flamingo_tpu_torch.ops.quant4 import quantize_lm_params_w4

    t0 = time.perf_counter()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False      # the HTSAT convs in full f32
    rng = np.random.default_rng(15)
    res = {}
    try:
        cfg = AF2Config(lm=dc.replace(Qwen2Config.qwen25_3b(), num_layers=2))
        gen_cpu = torch.Generator().manual_seed(15)
        tower = clap.build(cfg.clap, "cpu", torch.float32)
        clap.init_(tower, gen_cpu)
        mels = torch.as_tensor((rng.standard_normal((1, 4, 1001, 64)) * 10 - 40)
                               .astype(np.float32))
        longer = torch.tensor([True])
        want = tower.encode(mels, longer)["embeds"]
        got = copy.deepcopy(tower).cuda().encode(mels.cuda(), longer.cuda())["embeds"].cpu()
        res["tower"] = float((got - want).abs().max())
        check(res["tower"] <= 1e-4, f"15c: HTSAT-base embeds card vs CPU {res['tower']:.3e}")
        del tower

        model = flamingo.init(cfg, gen_cpu, "cpu", torch.float32)
        liven(model, 15, linear=10.0, embed=3.0)
        ids = torch.as_tensor(rng.integers(0, cfg.lm.vocab_size, (1, 24)))
        wins = torch.as_tensor(rng.standard_normal((1, 1, 4, 512)).astype(np.float32))
        state = model.lm.state_dict()
        trees = {"float": None, "int8": quantize_lm_params(state),
                 "w4": quantize_lm_params_w4(state)}
        for name, tree in trees.items():
            cpu = model if tree is None else flamingo.FlamingoModel(
                model.audio_transform, model.xattn, qwen2.quantized_lm(tree, torch.float32, "cpu"))
            card = copy.deepcopy(cpu).cuda()
            lg_h = flamingo.logits(cpu, cfg, ids, wins)
            lg_c = flamingo.logits(card, cfg, ids.cuda(), wins.cuda()).cpu()
            scale = float(lg_h.abs().max())
            err = float((lg_c - lg_h).abs().max())
            out_h = flamingo.generate(cpu, cfg, ids, wins, max_new_tokens=8).tokens
            out_c = flamingo.generate(card, cfg, ids.cuda(), wins.cuda(), max_new_tokens=8).tokens
            res[name] = dict(err=err, scale=scale, ids=out_h[0].tolist(),
                             equal=torch.equal(out_c.cpu(), out_h))
            check(len(set(res[name]["ids"])) > 1,
                  f"15c {name}: the CPU's greedy ids {res[name]['ids']} repeat one token")
            check(err <= 1e-4 * scale, f"15c {name}: logits card vs CPU {err:.3e} (max|logit| "
                                       f"{scale:.2f})")
            check(res[name]["equal"],
                  f"15c {name}: greedy ids card {out_c[0].tolist()} vs CPU {out_h[0].tolist()}")
            del card
        del model, trees, state

        cfg1 = AF1Config.make(lm=dc.replace(OPTConfig(), num_layers=2))
        af1 = flamingo.init(cfg1, torch.Generator().manual_seed(16), "cpu", torch.float32)
        liven(af1, 16, linear=3.0, embed=3.0)
        card = copy.deepcopy(af1).cuda()
        ids = torch.as_tensor(rng.integers(0, cfg1.lm.vocab_size, (1, 24)))
        wins = torch.as_tensor(rng.standard_normal((1, 4, 4, 512)).astype(np.float32))
        idx = torch.as_tensor(np.repeat(np.arange(1, 5), 6)[None])
        lg_h = flamingo.logits_with_media_mask(af1, cfg1, ids, wins, idx, 4, mode="last")
        lg_c = flamingo.logits_with_media_mask(card, cfg1, ids.cuda(), wins.cuda(), idx.cuda(),
                                               4, mode="last").cpu()
        scale = float(lg_h.abs().max())
        err = float((lg_c - lg_h).abs().max())
        out_h = flamingo.generate(af1, cfg1, ids, wins, max_new_tokens=8).tokens
        out_c = flamingo.generate(card, cfg1, ids.cuda(), wins.cuda(), max_new_tokens=8).tokens
        res["af1"] = dict(err=err, scale=scale, ids=out_h[0].tolist(),
                          equal=torch.equal(out_c.cpu(), out_h))
        check(len(set(res["af1"]["ids"])) > 1,
              f"15d AF1: the CPU's greedy ids {res['af1']['ids']} repeat one token")
        check(err <= 1e-4 * scale, f"15d AF1 logits_with_media_mask card vs CPU {err:.3e}")
        check(res["af1"]["equal"], f"15d AF1 greedy ids card {out_c[0].tolist()} vs CPU "
                                   f"{out_h[0].tolist()}")
        del af1, card
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    res["s"] = time.perf_counter() - t0
    log("15c f32 card vs CPU (full width, 2 + 2 layers): HTSAT-base embeds max|d| "
        f"{res['tower']:.3e} (limit 1e-4); flamingo logits and greedy ids, "
        + "; ".join(f"{n}: {res[n]['err']:.3e} of max|logit| {res[n]['scale']:.2f}, ids "
                    f"{res[n]['ids']} equal" for n in ("float", "int8", "w4"))
        + f". 15d AF1 (OPT-IML-1.3B widths, 2 layers): logits_with_media_mask (4 media x 4 "
          f"windows, 'last') {res['af1']['err']:.3e} of {res['af1']['scale']:.2f}, greedy ids "
          f"{res['af1']['ids']} equal; 15c + 15d took {res['s']:.1f} s")
    return res


AF1_K3 = dict(n_layers=24, nb=56, block=128, nkv=32, hd=64, mp=16)   # OPT-IML-1.3B's pools
AF1_K3_GROUPS = (1, 5)    # decode (g = 1: OPT has one query head a KV head) and a k = 4 verify
AF1_K3_PAIRS = ((torch.float32, "float32"), (torch.float32, "bfloat16"), (torch.float32, "int8"),
                (torch.bfloat16, "bfloat16"), (torch.bfloat16, "int8"))


def k3_hd64_phase(pa) -> dict:
    """16a. K3 at OPT's head dim 64 (AF1's paged engine): q [4, 32, g, 64] for g = 1
    (decode) and g' = 5 (a k = 4 verify folded into the group axis), scale 1 (OPT scales q
    before the product), stacked pools [24, 56, 128, 32, 64] with shuffled tables; rows of
    {400, 1500, 1, 0} checked at layers 0 and 23 against the plain version, g = 1 with a
    current token merged, g' = 5 with its 5-token block merged by merge_block_tokens; every
    dtype pair at g = 1, bf16/bf16, bf16/int8 and f32/f32 at g' = 5; two launches
    bit-identical; each shape timed at the engine's rows {416, 1516, 416, 1516} with the
    wrapper and as device time (one call in a CUDA graph) beside the plain version and the
    bound. A CUDA call at hd 96 is refused."""
    c = AF1_K3
    n_layers, nb, block, nkv, hd, mp = (c[k] for k in ("n_layers", "nb", "block", "nkv", "hd",
                                                       "mp"))
    gen = torch.Generator(device="cuda").manual_seed(16)
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
    kf = torch.randn(shape, generator=gen, device="cuda") * 0.5
    vf = torch.randn(shape, generator=gen, device="cuda")
    k8 = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
    v8 = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
    ks = torch.rand(shape[:-1], generator=gen, device="cuda") * 0.009 + 0.001
    vs = torch.rand(shape[:-1], generator=gen, device="cuda") * 0.018 + 0.002
    check_rows, mixed = [400, 1500, 1, 0], [416, 1516, 416, 1516]
    tables_c, lengths_c = tables_for(check_rows)
    tables_m, lengths_m = tables_for(mixed)
    results = {}
    for q_dtype, kv_name in AF1_K3_PAIRS:
        if kv_name == "int8":
            pools = (k8, v8, ks, vs)
        else:
            dt = getattr(torch, kv_name)
            pools = (kf.to(dt), vf.to(dt), None, None)
        qn = str(q_dtype).split(".")[-1]
        for g in AF1_K3_GROUPS:
            if g > 1 and (q_dtype, kv_name) not in ((torch.bfloat16, "bfloat16"),
                                                    (torch.bfloat16, "int8"),
                                                    (torch.float32, "float32")):
                continue
            q = (torch.randn((4, nkv, g, hd), generator=gen, device="cuda") * 0.125).to(q_dtype)
            worst = dict(err=0.0, ratio=0.0, o_err=0.0, merged_err=0.0)
            for layer in (0, n_layers - 1):
                args = (q, pools[0], pools[1], tables_c, lengths_c, layer, pools[2], pools[3],
                        1.0)
                if g == 1:
                    k_cur = torch.randn((4, nkv, hd), generator=gen, device="cuda") * 0.5
                    v_cur = torch.randn((4, nkv, hd), generator=gen, device="cuda")
                    r = paged_compare(pa, args, k_cur, v_cur)
                    worst["merged_err"] = max(worst["merged_err"], r["merged_err"])
                else:
                    r = paged_compare(pa, args)
                    o, m, l = pa.paged_attention(*args[:6], k_scale=args[6], v_scale=args[7],
                                                 scale=1.0)
                    o_p, m_p, l_p = pa.paged_attention_plain(*args[:6], k_scale=args[6],
                                                             v_scale=args[7], scale=1.0)
                    fold = lambda x: x.reshape(4, nkv, g, 1, *x.shape[3:]).transpose(1, 2)
                    qg = fold(q.float())
                    kb = torch.randn((4, g, nkv, hd), generator=gen, device="cuda") * 0.5
                    vb = torch.randn((4, g, nkv, hd), generator=gen, device="cuda")
                    got = pa.merge_block_tokens(qg, kb, vb, fold(o), fold(m), fold(l), scale=1.0)
                    ref = pa.merge_block_tokens(qg, kb, vb, fold(o_p), fold(m_p), fold(l_p),
                                                scale=1.0)
                    diff = (got - ref).abs()
                    lim = (PAGED_F32_TOL * ref.abs().max() if q_dtype == torch.float32
                           else PAGED_BF16_TOL[0] * ref.abs() + PAGED_BF16_TOL[1])
                    check(bool((diff <= lim).all()), f"16a K3 hd 64 g' {g} {qn}/{kv_name}: the "
                          f"merged block is off by {diff.max().item():.3e}")
                    worst["merged_err"] = max(worst["merged_err"], diff.max().item())
                check(r["ratio"] <= 1.0, f"16a K3 hd 64 g {g} q {qn} pool {kv_name} layer "
                                         f"{layer}: at {r['ratio']:.3f} of its limit")
                for key in ("err", "ratio", "o_err"):
                    worst[key] = max(worst[key], r[key])
                first = pa.paged_attention(*args[:6], k_scale=args[6], v_scale=args[7], scale=1.0)
                again = pa.paged_attention(*args[:6], k_scale=args[6], v_scale=args[7], scale=1.0)
                check(all(torch.equal(a, b) for a, b in zip(first, again)),
                      f"16a K3 hd 64 g {g} {qn}/{kv_name}: two launches differ")
            args = (q, pools[0], pools[1], tables_m, lengths_m, 5)
            call = lambda: pa.paged_attention(*args, k_scale=pools[2], v_scale=pools[3],
                                              scale=1.0)
            plain = lambda: pa.paged_attention_plain(*args, k_scale=pools[2], v_scale=pools[3],
                                                     scale=1.0)
            r = dict(worst, ms=time_ms(call), plain_ms=time_ms(plain, 3, 1),
                     graph_ms=graph_ms(call), library_ms=None)
            r["bound_ms"], r["bound_by"] = paged_bound_ms(mixed, block, mp, tuple(q.shape),
                                                          q_dtype, pools[0].dtype)
            parts = pa.kernel_parts(4, nkv, mp, q.device, q.dtype, pools[0].dtype, g, hd)
            log(f"16a K3 hd 64 g={g} q {qn:8s} pool {kv_name:8s}: max|o/l - plain| "
                f"{r['err']:.3e} (at {r['ratio']:.3f} of its limit), merged "
                f"{r['merged_err']:.3e}, two launches bit-identical; {parts} parts; rows "
                f"{mixed}: {r['ms']:.4f} ms with the wrapper, {r['graph_ms']:.4f} ms device "
                f"(one call in a graph), plain {r['plain_ms']:.3f} ms, bound "
                f"{r['bound_ms']:.5f} ms ({r['bound_by']}), "
                f"{r['bound_ms'] / r['graph_ms'] * 100:.2f} % of the bound as device time")
            results[(qn, kv_name, g)] = r
        del pools
    q96 = torch.zeros((1, 1, 1, 96), device="cuda")
    pool96 = torch.zeros((1, 128, 1, 96), device="cuda")
    try:
        pa.paged_attention(q96, pool96, pool96, torch.zeros((1, 1), dtype=torch.int32,
                                                            device="cuda"),
                           torch.ones((1,), dtype=torch.int32, device="cuda"))
        refused = False
    except ValueError:
        refused = True
    check(refused, "16a: K3 took a CUDA call at hd 96")
    del kf, vf, k8, v8, ks, vs
    torch.cuda.empty_cache()
    return results


XATTN_TOKENS = 16      # new tokens a request in 16b-16d (bench_xattn_engines asks 64; 32
#                        before phase 17 needed the room)
XATTN_LAYERS = {"af2": 18, "af1": 12}   # 16b-16d's depth at full width: half of the 3B's 36
#                        and OPT-IML-1.3B's 24 layers (all before phase 18 needed the room)
XATTN_WPM = 30         # media windows a request: bench_xattn_engines' 5-minute buffer
XATTN_EOS = {"af2": 151_645, "af1": 2}
SLOT_XATTN = dict(num_slots=4, capacity=2048, chunk=16)
PAGED_XATTN = dict(num_rows=4, num_blocks=56, block_size=128, max_blocks_per_seq=16, chunk=16)


def xattn_workload(vocab: int, d_audio: int, seed: int) -> list:
    """bench_xattn_engines' requests (bench.py:952-1070): 3 x (400, 1500 random ids),
    interleaved, each with 30 media windows of normal x 0.1."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(3):
        for tag, t in (("s", 400), ("l", 1500)):
            wins = (rng.normal(size=(1, 1, XATTN_WPM, d_audio)) * 0.1).astype(np.float32)
            reqs.append((f"{tag}{i}", rng.integers(0, vocab, (1, t)).astype(np.int32), wins))
    return reqs


def k3_hold_batched(pa, launches: list, tag: str) -> dict:
    """Every kept K3 launch re-run through the kernel on its inputs and held against the
    plain version on the same inputs (k3_held). The plain version is evaluated for all the
    launches of one decode step at once: their layers' pools addressed through one flat
    [L NB, BS, nkv, hd] view, each launch's table entries shifted to its layer's pages
    (rows are independent in the plain version, so every row is its own launch's plain
    result). Returns the largest err and ratio."""
    worst = dict(err=0.0, ratio=0.0, launches=len(launches))
    groups: list = []
    for args in launches:     # one group per decode step (the step's lengths tensor)
        if groups and args[4] is groups[-1][0][4] and args[1] is groups[-1][0][1]:
            groups[-1].append(args)
        else:
            groups.append([args])
    for grp in groups:
        q0, k, v, _, _, _, ks, vs, scale = grp[0]
        nb = k.shape[1]
        got = [pa.paged_attention(q, k, v, t, ln, layer, k_scale=ks, v_scale=vs, scale=scale)
               for q, _, _, t, ln, layer, _, _, _ in grp]
        flat = lambda p: None if p is None else p.view(-1, *p.shape[2:])
        plain = pa.paged_attention_plain(
            torch.cat([a[0] for a in grp]), flat(k), flat(v),
            torch.cat([torch.where(a[3] >= 0, a[3] + a[5] * nb, a[3]) for a in grp]),
            torch.cat([a[4] for a in grp]), k_scale=flat(ks), v_scale=flat(vs), scale=scale)
        r = k3_held(pa, q0.dtype, tuple(torch.cat(x) for x in zip(*got)), plain)
        check(r["ratio"] <= 1.0, f"{tag}: a K3 launch at {r['ratio']:.3f} of its limit")
        worst["err"], worst["ratio"] = max(worst["err"], r["err"]), max(worst["ratio"],
                                                                        r["ratio"])
    return worst


class XattnProbe:
    """Stands in for the engines' chunk loops (runtime/engine.decode_chunk and
    runtime/paged_engine.paged_decode_chunk, which the AF1/AF2 engines run with their own
    step) while an engine serves: counts chunks, decode steps and the K3 and K4 launches
    made inside them. With ``replay`` every chunk's K3 launches are kept and, right after
    the chunk (before any page can be handed to another row), held against the plain
    version (k3_hold_batched); the chunk ``graph_chunk``'s launches are also replayed in
    one CUDA graph (their device time) beside their bounds and, with ``time_plain``, the
    plain version's time on each, summed."""

    def __init__(self, pa, k4):
        from audio_flamingo_tpu_torch.runtime import engine as engine_mod
        from audio_flamingo_tpu_torch.runtime import paged_engine as pe_mod

        self.pa, self.k4 = pa, k4
        self.sites = [(engine_mod, "decode_chunk"), (pe_mod, "paged_decode_chunk")]
        self.reset()

    def reset(self, replay: bool = False, graph_chunk: int | None = None,
              time_plain: bool = False, tag: str = ""):
        self.chunks = self.steps = self.k3 = self.k4_count = 0
        self.replay, self.graph_chunk, self.tag = replay, graph_chunk, tag
        self.time_plain = time_plain
        self.hold = dict(err=0.0, ratio=0.0, launches=0)
        self.graph = None

    def __enter__(self):
        self.real = [getattr(mod, name) for mod, name in self.sites]
        for (mod, name), real in zip(self.sites, self.real):
            setattr(mod, name, self._wrap(real))
        return self

    def __exit__(self, *exc):
        for (mod, name), real in zip(self.sites, self.real):
            setattr(mod, name, real)

    def _wrap(self, real):
        def chunk_loop(*args, chunk: int, **kw):
            index = self.chunks
            self.chunks += 1
            self.steps += chunk
            c3 = self.pa.LAUNCHES
            n3, n4 = c3.count, self.k4.LAUNCHES.count
            keep = self.replay or index == self.graph_chunk
            c3.inputs.clear()
            c3.capture = keep
            try:
                out = real(*args, chunk=chunk, **kw)
            finally:
                c3.capture = False
            self.k3 += c3.count - n3
            self.k4_count += self.k4.LAUNCHES.count - n4
            if keep:
                launches = list(c3.inputs)
                c3.inputs.clear()
                if self.replay:
                    r = k3_hold_batched(self.pa, launches, self.tag)
                    self.hold = dict(err=max(self.hold["err"], r["err"]),
                                     ratio=max(self.hold["ratio"], r["ratio"]),
                                     launches=self.hold["launches"] + r["launches"])
                if index == self.graph_chunk:
                    self.graph = dict(launches=len(launches), steps=chunk, plain_ms=None,
                                      graph_ms=launches_graph_ms(self.pa, launches))
                    self.graph.update(launch_sums(self.pa, launches) if self.time_plain
                                      else launch_bounds(launches))
            return out
        return chunk_loop


def xattn_serve(make, reqs, probe, max_new: int = XATTN_TOKENS, **probe_kw) -> dict:
    """A new engine (``make()``) serves the requests to the end: ids, wall seconds, tok/s,
    each request's TTFT from its submit, and the probe's chunk steps and launches."""
    from audio_flamingo_tpu_torch.runtime.flamingo_engine import FlamingoRequest

    eng = make()
    probe.reset(**probe_kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for rid, ids, wins in reqs:
        eng.submit(FlamingoRequest(request_id=rid, ids=ids.copy(), window_embeds=wins,
                                   max_new_tokens=max_new))
    results = eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(set(results) == {r[0] for r in reqs} and not eng.active and not eng.queue,
          f"{probe.tag}: not every request finished: {sorted(results)}")
    tokens = sum(len(v) for v in results.values())
    return dict(ids=dict(results), wall=wall, tokens=tokens, tps=tokens / wall,
                ttft=sorted(m["ttft_s"] for m in eng.request_metrics.values()),
                steps=probe.steps, chunks=probe.chunks, k3=probe.k3, k4=probe.k4_count,
                hold=probe.hold, graph=probe.graph,
                preemptions=getattr(eng, "preemptions", 0))


def xattn_engine_runs(name: str, make, reqs, probe, n_layers: int, k4_step: int,
                      paged: bool, timed: bool = False) -> dict:
    """One engine configuration: a warm-up instance on two requests, the measured run,
    then a second run whose every K3 launch (paged) is held against the plain version and
    whose first chunk's K3 launches are timed in one CUDA graph beside their bounds (and,
    if ``timed``, the plain version's time on each). Ids equal across the runs; per
    decode step K3 = the LM's layers (paged) or 0, K4 = k4_step (0 for a float LM)."""
    xattn_serve(make, reqs[:2], probe, tag=f"{name} warm-up")
    run = xattn_serve(make, reqs, probe, tag=name)
    again = xattn_serve(make, reqs, probe, replay=paged, graph_chunk=0 if paged else None,
                        time_plain=timed, tag=f"{name} replay")
    check(run["ids"] == again["ids"], f"{name}: ids differ between two runs")
    for r in (run, again):
        check(r["k3"] == (n_layers * r["steps"] if paged else 0)
              and r["k4"] == k4_step * r["steps"],
              f"{name}: {r['k3']} K3 and {r['k4']} K4 launches over {r['steps']} decode steps "
              f"(want {n_layers if paged else 0} and {k4_step} a step)")
    g, hold = again["graph"], again["hold"]
    extra = ("" if not paged else
             f"; every K3 launch of the second run ({hold['launches']}) held to the plain "
             f"version: max|o/l - plain| {hold['err']:.3e} (at {hold['ratio']:.3f} of its "
             f"limit)")
    if g is not None:
        extra += (f"; its first chunk's {g['launches']} K3 launches in one CUDA graph "
                  f"{g['graph_ms']:.3f} ms ({g['graph_ms'] / g['steps']:.4f} ms a step) against "
                  f"their bound {g['bound_ms']:.4f} ms ({g['bound_by']})"
                  + ("" if g["plain_ms"] is None else f", plain {g['plain_ms']:.1f} ms"))
    log(f"{name}: {run['tokens']} tokens in {run['wall']:.2f} s = {run['tps']:.1f} tok/s, TTFT "
        f"from submit median {statistics.median(run['ttft']):.3f} s max {run['ttft'][-1]:.3f} s; "
        f"{run['steps']} decode steps in {run['chunks']} chunks, per step {run['k3'] // max(run['steps'], 1)} K3 "
        f"and {run['k4'] // max(run['steps'], 1)} K4; preemptions {run['preemptions']}; ids equal "
        f"over two runs{extra}")
    return dict(run=run, again=again)


def xattn_engines_phase(pa, k4) -> dict:
    """16b, 16d. AF2 at full width and XATTN_LAYERS["af2"] of the 3B's 36 layers (15a's
    build otherwise: HTSAT-base, an xattn block a layer,
    the int8 Qwen2.5-3B from random_quantized_lm, the fusion stacks and tower bf16 from a
    seed, gates AF2_GATE) behind the AF1/AF2 engines with bench_xattn_engines' settings and
    requests (XATTN_TOKENS greedy tokens each): FlamingoEngine (4 slots of 2048), then
    PagedFlamingoEngine (4 rows, 56 pages of 128, 16 a row) on a bf16 and an int8 pool
    (xattn_engine_runs); the slot and paged engines' ids compared (the slot engine's
    attention is plain torch, the paged K3: they need not agree at bf16). 16d: the beam,
    AudioFlamingo2.generate(num_beams=4) on a 30 s clip twice (one answer, the beam step
    captured once), the captured step against the eager one from one prefill (every
    state tensor equal after the search), ms a step beside its bound, K4 launches a step."""
    from audio_flamingo_tpu_torch.api import AudioFlamingo2
    from audio_flamingo_tpu_torch.config import AF2Config
    from audio_flamingo_tpu_torch.models import clap, flamingo, qwen2
    from audio_flamingo_tpu_torch.ops.quant import random_quantized_lm
    from audio_flamingo_tpu_torch.runtime import beam
    from audio_flamingo_tpu_torch.runtime.flamingo_engine import FlamingoEngine
    from audio_flamingo_tpu_torch.runtime.paged_flamingo_engine import PagedFlamingoEngine

    t_phase = time.perf_counter()
    cfg = AF2Config(lm=dataclasses.replace(AF2Config().lm, num_layers=XATTN_LAYERS["af2"]))
    n_layers = cfg.lm.num_layers
    g = torch.Generator(device="cuda").manual_seed(0)
    qlm = qwen2.quantized_lm(random_quantized_lm(g, cfg.lm, "cuda"), torch.bfloat16, "cuda")
    model = flamingo.init_fusion(cfg, qlm, g, "cuda", torch.bfloat16)
    set_gates(model, AF2_GATE)
    tower = clap.build(cfg.clap, "cuda", torch.bfloat16)
    clap.init_(tower, g)
    af2 = AudioFlamingo2._assemble(cfg, model, tower, None, torch.device("cuda"))
    reqs = xattn_workload(150_000, cfg.audio_embed_dim, seed=0)
    common = dict(eos_token_id=XATTN_EOS["af2"], n_media=1, windows_per_media=XATTN_WPM)
    makes = {
        "16b AF2 FlamingoEngine": (lambda: FlamingoEngine(model=model, cfg=cfg, **SLOT_XATTN,
                                                          **common), False),
        "16b AF2 PagedFlamingoEngine bf16 pool": (lambda: PagedFlamingoEngine(
            model=model, cfg=cfg, **PAGED_XATTN, **common), True),
        "16b AF2 PagedFlamingoEngine int8 pool": (lambda: PagedFlamingoEngine(
            model=model, cfg=cfg, kv_dtype=torch.int8, **PAGED_XATTN, **common), True)}
    res = {}
    with XattnProbe(pa, k4) as probe:
        for name, (make, paged) in makes.items():
            res[name] = xattn_engine_runs(name, make, reqs, probe, n_layers,
                                          k4_step_launches(n_layers), paged,
                                          timed="bf16" in name)
    slot_ids = res["16b AF2 FlamingoEngine"]["run"]["ids"]
    paged_ids = res["16b AF2 PagedFlamingoEngine bf16 pool"]["run"]["ids"]
    agree = {rid: common_prefix(slot_ids[rid], paged_ids[rid]) for rid in slot_ids}
    log(f"16b slot against paged (bf16): tokens in common from the start per request {agree} "
        f"of {XATTN_TOKENS} (plain attention against K3 in bf16; they need not agree)")

    # 16d. the beam at full width
    wav = clip48(30, 1, 440.0)
    answers, walls = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        answers.append(af2.generate(sound=wav, prompt=AF2_PROMPT, max_new_tokens=XATTN_TOKENS,
                                    num_beams=4))
        walls.append(time.perf_counter() - t0)
    check(answers[0] == answers[1], f"16d: two beam answers differ: {answers}")
    inp = af2_inputs(af2, wav)
    t = inp["plen"] or inp["ids"].shape[1]
    ids = inp["ids"][:, :t]
    capacity = -(-(t + XATTN_TOKENS) // 128) * 128
    opts = dict(num_beams=4, max_new_tokens=XATTN_TOKENS, eos_token_id=af2.eos_token_id,
                capacity=capacity)
    search = beam.beam_open_xattn(model, cfg, ids, inp["wins"], t, **opts)
    check(search.graph is not None and search.capture_s == 0,
          "16d: the beam did not reuse the step the api captured")
    k4.LAUNCHES.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = search.advance(XATTN_TOKENS)
    torch.cuda.synchronize()
    graph_step_ms = (time.perf_counter() - t0) / steps * 1e3
    check(k4.LAUNCHES.count == k4_step_launches(n_layers) * steps,
          f"16d: {k4.LAUNCHES.count} K4 launches over {steps} replayed beam steps")
    captured = {n: getattr(search.state, n).clone() for n in ("run_seq", "run_sc", "fin_seq",
                                                              "fin_sc", "is_fin", "alive", "i")}
    search.close()
    spec = beam._spec(4, XATTN_TOKENS, af2.eos_token_id, 1.0, False, 0, 0, False, 1.0)
    media_shape = (inp["wins"].shape[1] * inp["wins"].shape[2], cfg.audio_embed_dim)
    with torch.inference_mode():
        st = beam.new_beam_state(cfg, spec, 1, capacity, torch.bfloat16, torch.device("cuda"),
                                 None, media_shape)
        cache, media, logits = flamingo.prefill(model, cfg, ids, inp["wins"], capacity)
        beam.begin(st, spec, logits, cache, t, ids, media)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            beam.xattn_beam_body(model, cfg, spec, st)
        torch.cuda.synchronize()
        eager_step_ms = (time.perf_counter() - t0) / steps * 1e3
    same = all(torch.equal(getattr(st, n), v) for n, v in captured.items())
    check(same, "16d: the captured beam step and the eager one end in different states")
    lm_bytes = sum(v.numel() * v.element_size() for v in qlm.state_dict().values())
    xa_bytes = sum(p.numel() * p.element_size() for p in model.xattn.parameters())
    cache_bytes = st.cache.k.numel() * st.cache.k.element_size() * 2
    bound_ms = (lm_bytes + xa_bytes + 2 * cache_bytes) / PEAK_BYTES * 1e3
    log(f"16d AF2 beam (K 4, {XATTN_TOKENS} tokens, 30 s clip, {t}-token prompt, capacity "
        f"{capacity}): api answers equal ({walls[0]:.2f} s with the capture, {walls[1]:.2f} s "
        f"replayed); the captured step {graph_step_ms:.3f} ms a step, eager {eager_step_ms:.3f} "
        f"ms, every state tensor equal after {steps} steps; bound {bound_ms:.3f} ms a step "
        f"(int8 LM {lm_bytes / 1e9:.3f} GB + xattn {xa_bytes / 1e9:.3f} GB + the K-row cache "
        f"read and written by the reorder, {cache_bytes / 1e6:.1f} MB); "
        f"{k4_step_launches(n_layers)} K4 launches a step")
    del st, cache, search
    return dict(res=res, agree=agree, beam=dict(graph_ms=graph_step_ms, eager_ms=eager_step_ms,
                                                bound_ms=bound_ms, walls=walls, steps=steps),
                s=time.perf_counter() - t_phase)


def af1_engine_phase(pa) -> dict:
    """16c. AF1 at full width: AF1Config.make with xattn before every second layer (32
    heads), OPT-IML-1.3B's widths (XATTN_LAYERS["af1"] of its 24 layers, 32 heads of 64),
    the LM and the fusion stacks bf16 from a seed, gates AF2_GATE, behind
    PagedFlamingoEngine with 16b's settings and requests (ids from OPT's vocabulary) on a
    bf16 and an int8 pool (xattn_engine_runs): K3 at hd 64, g 1, scale 1, a launch a layer a
    decode step, every one held against the plain version."""
    from audio_flamingo_tpu_torch.config import AF1Config, GatedXAttnConfig
    from audio_flamingo_tpu_torch.models import flamingo
    from audio_flamingo_tpu_torch.ops.kernels import w8a16_matmul as k4
    from audio_flamingo_tpu_torch.runtime.paged_flamingo_engine import PagedFlamingoEngine

    t_phase = time.perf_counter()
    cfg = AF1Config.make(xattn=GatedXAttnConfig(cross_every_n_layers=2, num_heads=32))
    cfg = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, num_layers=XATTN_LAYERS["af1"]))
    model = flamingo.init(cfg, torch.Generator(device="cuda").manual_seed(1), "cuda",
                          torch.bfloat16)
    set_gates(model, AF2_GATE)
    reqs = xattn_workload(cfg.lm.vocab_size, cfg.audio_embed_dim, seed=1)
    res = {}
    with XattnProbe(pa, k4) as probe:
        for name, kv in (("16c AF1 PagedFlamingoEngine bf16 pool", None),
                         ("16c AF1 PagedFlamingoEngine int8 pool", torch.int8)):
            make = lambda: PagedFlamingoEngine(model=model, cfg=cfg, kv_dtype=kv, **PAGED_XATTN,
                                               eos_token_id=XATTN_EOS["af1"], n_media=1,
                                               windows_per_media=XATTN_WPM)
            res[name] = xattn_engine_runs(name, make, reqs, probe, cfg.lm.num_layers, 0, True,
                                          timed=kv is None)
    del model
    return dict(res=res, s=time.perf_counter() - t_phase)


def xattn_f32_card_vs_cpu_phase() -> dict:
    """16e. f32 card against CPU at full width, 2 + 2 layers, the models made lively
    (liven, as 15c and 15d): AF2 (the 3B's widths) on FlamingoEngine and on
    PagedFlamingoEngine with an f32 and an int8 pool, AF1 (OPT-IML-1.3B's widths, K3 at hd
    64) on PagedFlamingoEngine with both pools; three requests each (ids token-exact card
    against CPU, the CPU's not one repeated token); a speculative run on each engine's
    f32-pool configuration (AF2 slot and paged, AF1 paged) with a random 2-layer Qwen2
    draft at the 0.5B's widths (the target's vocabulary), its ids the plain engine's; and
    generate_beam_xattn (K 4) on AF2, sequences equal."""
    import copy
    import dataclasses as dc

    from audio_flamingo_tpu_torch.config import AF1Config, AF2Config, OPTConfig, Qwen2Config
    from audio_flamingo_tpu_torch.models import flamingo, qwen2
    from audio_flamingo_tpu_torch.runtime import beam
    from audio_flamingo_tpu_torch.runtime.flamingo_engine import FlamingoEngine, FlamingoRequest
    from audio_flamingo_tpu_torch.runtime.paged_flamingo_engine import PagedFlamingoEngine

    t0 = time.perf_counter()
    rng = np.random.default_rng(16)
    cfg2 = AF2Config(lm=dc.replace(Qwen2Config.qwen25_3b(), num_layers=2))
    af2 = flamingo.init(cfg2, torch.Generator().manual_seed(16), "cpu", torch.float32)
    liven(af2, 16, linear=10.0, embed=3.0)
    cfg1 = AF1Config.make(lm=dc.replace(OPTConfig(), num_layers=2))
    af1 = flamingo.init(cfg1, torch.Generator().manual_seed(17), "cpu", torch.float32)
    liven(af1, 17, linear=3.0, embed=3.0)

    def draft_for(vocab: int):
        dcfg = dc.replace(Qwen2Config.qwen25_0_5b(), num_layers=2, vocab_size=vocab)
        with torch.device("meta"):
            d = qwen2.Qwen2(dcfg, dtype=torch.float32)
        d = d.to_empty(device="cpu").eval().requires_grad_(False)
        qwen2.init_(d, torch.Generator().manual_seed(vocab))
        return d, dcfg

    models = {"af2": (cfg2, af2, draft_for(cfg2.lm.vocab_size)),
              "af1": (cfg1, af1, draft_for(cfg1.lm.vocab_size))}
    on_card = {k: (copy.deepcopy(m).cuda(), copy.deepcopy(d[0]).cuda())
               for k, (_, m, d) in models.items()}
    small = dict(n_media=1, windows_per_media=4, eos_token_id=-1)
    slot = dict(num_slots=2, capacity=256, chunk=4)
    paged = dict(num_rows=2, num_blocks=40, block_size=16, max_blocks_per_seq=16, chunk=4)
    spec = dict(spec_k=3, spec_rounds=2, spec_guard=False)
    engines = [("af2", "FlamingoEngine", FlamingoEngine, slot),
               ("af2", "PagedFlamingoEngine f32 pool", PagedFlamingoEngine, paged),
               ("af2", "PagedFlamingoEngine int8 pool", PagedFlamingoEngine,
                dict(paged, kv_dtype=torch.int8)),
               ("af1", "PagedFlamingoEngine f32 pool", PagedFlamingoEngine, paged),
               ("af1", "PagedFlamingoEngine int8 pool", PagedFlamingoEngine,
                dict(paged, kv_dtype=torch.int8))]
    reqs = {k: [(f"r{i}", rng.integers(0, cfg.lm.vocab_size, (1, t)).astype(np.int32),
                 rng.standard_normal((1, 1, 4, cfg.audio_embed_dim)).astype(np.float32))
                for i, t in enumerate((20, 33, 47))] for k, (cfg, _, _) in models.items()}

    def serve_on(eng, which):
        for rid, ids, wins in reqs[which]:
            eng.submit(FlamingoRequest(request_id=rid, ids=ids.copy(), window_embeds=wins,
                                       max_new_tokens=8))
        return eng.run_until_done()

    res = {}
    for which, name, cls, kw in engines:
        cfg, model, (draft, dcfg) = models[which]
        card, card_draft = on_card[which]
        out = {}
        for dev, m, d in (("cpu", model, draft), ("cuda", card, card_draft)):
            plain = serve_on(cls(model=m, cfg=cfg, device=dev, **small, **kw), which)
            if "int8" in name:     # the int8 pools' verify: the CPU tests and 16b's pools
                out[dev] = (plain, plain, 1)
                continue
            sp_kw = dict(kw, preempt=False) if cls is PagedFlamingoEngine else kw
            eng = cls(model=m, cfg=cfg, device=dev, draft_params=d, draft_cfg=dcfg, **small,
                      **sp_kw, **spec)
            out[dev] = (plain, serve_on(eng, which), eng.spec_stats["round_slots"])
        (cpu, cpu_spec, slots), (crd, crd_spec, _) = out["cpu"], out["cuda"]
        tag = f"16e {which.upper()} {name}"
        check(len({t for v in cpu.values() for t in v}) > 2,
              f"{tag}: the CPU's ids repeat one token: {cpu}")
        check(crd == cpu, f"{tag}: ids card {crd} vs CPU {cpu}")
        check(cpu_spec == cpu and crd_spec == crd and slots > 0,
              f"{tag}: speculative ids (CPU {cpu_spec}, card {crd_spec}) differ from the plain "
              f"engine's")
        res.setdefault("engines", {})[f"{which.upper()} {name}"] = cpu
    cfg, model, _ = models["af2"]
    ids, wins = reqs["af2"][1][1], reqs["af2"][1][2]
    got = [beam.generate_beam_xattn(m, cfg, torch.as_tensor(ids, device=dev).long(),
                                    torch.as_tensor(wins, device=dev), num_beams=4,
                                    max_new_tokens=8, eos_token_id=-1)
           for dev, m in (("cpu", model), ("cuda", on_card["af2"][0]))]
    check(torch.equal(got[0][0], got[1][0].cpu()) and
          float((got[0][1] - got[1][1].cpu()).abs().max()) <= 1e-4,
          f"16e AF2 beam: card {got[1][0].tolist()} vs CPU {got[0][0].tolist()}")
    res["beam"] = got[0][0][0].tolist()
    res["s"] = time.perf_counter() - t0
    log("16e f32 card vs CPU (full width, 2 + 2 layers, lively): ids token-exact on "
        + "; ".join(f"{n} {ids_['r0']}" for n, ids_ in res["engines"].items())
        + f"; a speculative run with a 2-layer draft equal to the plain run on AF2's slot and "
          f"f32-pool paged engines and AF1's; the AF2 beam (K 4) equal, best {res['beam']}; "
          f"{res['s']:.1f} s")
    del on_card
    return res


# ------------------------------------------------------------------ 17. LoRA / QLoRA and GRPO
QLORA_RANK = 16           # bench_train_mm's second recipe: rank-16 adapters on all 7 targets
QLORA_BATCH = (4, 1024)   # 4 x 1024 random ids, labels equal to the ids
QLORA_STEPS = 3           # timed steps after one warm step
QLORA_DECODE = 8          # greedy tokens of the adapted int8 7B, captured against eager
GRPO_G = 8                # bench_grpo: G = 8 rollouts of one prompt
GRPO_NEW = 32             # tokens a rollout (bench_grpo: 128 for the rollout, 64 for the step)
GRPO_LOGITS_BAND = 2.0 ** -6  # bf16 engine prefill vs the dense forward, max|diff| / max|logit|
GRPO_ENGINE = dict(num_rows=8, num_blocks=80, block_size=128, max_blocks_per_seq=8, chunk=16,
                   eos_token_id=-1, prefix_cache=True)


def flash_launch_rows(fa, k2_launches: dict, k2_ms: float, k7_launches: dict,
                      k7_ms: float) -> dict:
    """K2's and K7's launches of one step by shape ({(q, k, causal): count}) and their
    device ms (CUDA events) -> the path rows: count, ms, bound, and the plain version's
    and SDPA's time on one launch of each shape (random inputs at that shape) times its
    count (17b, whose update's launches are not captured)."""
    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(17)
    for name, launches, ms in (("K2", k2_launches, k2_ms), ("K7", k7_launches, k7_ms)):
        tot = dict(count=sum(launches.values()), ms=ms, bound_ms=0.0, plain_ms=0.0,
                   library_ms=0.0)
        by = set()
        for (qs, ks, causal), n in launches.items():
            q = torch.randn(qs, generator=gen, device="cuda", dtype=torch.bfloat16)
            k = torch.randn(ks, generator=gen, device="cuda", dtype=torch.bfloat16)
            v = torch.randn(ks, generator=gen, device="cuda", dtype=torch.bfloat16)
            # the LM's causal launches at the default scale, the encoder's at 1 (q pre-scaled)
            kw = dict(causal=causal, scale=qs[-1] ** -0.5 if causal else 1.0, q_offset=0)
            if name == "K2":
                b_ms, b_by = attention_bound_ms(qs, ks, causal, 0, "bfloat16")
                plain = time_ms(lambda: fa.flash_attention_reference(q, k, v, **kw), 2, 1)
                lib = time_ms(sdpa_call(q, k, v, kw), 3, 1)
            else:
                o, lse = fa.flash_attention_lse(q, k, v, **kw)
                do = torch.randn_like(q)
                b_ms, b_by = k7_bound_ms(qs, ks, causal, 0, "bfloat16")
                plain = time_ms(lambda: fa.flash_attention_backward_reference(
                    q, k, v, o, lse, do, None, **kw), 2, 1)
                lib = time_ms(sdpa_backward_call(q, k, v, do, kw), 3, 1)
            tot["bound_ms"] += n * b_ms
            tot["plain_ms"] += n * plain
            tot["library_ms"] += n * lib
            by.add(b_by)
        tot["bound_by"] = "operations" if by == {"operations"} else "bytes"
        rows[name] = tot
    torch.cuda.empty_cache()
    return rows


def qlora_phase(fa, k4) -> dict:
    """17a. QLoRA-7B at full width, bench_train_mm's second recipe: the int8 Qwen2.5-7B made
    on the card as phase 9 makes it (quantize_lm_params of a bf16 model from a seed), rank-16
    adapters on q, k, v, o, gate, up, down, use_flash and remat "full", the recipe's tiny
    encoder and adaptor and no mels, batch 4 x 1024 random ids with labels equal to the ids,
    ce_chunk 256, the port's AdamW at 1e-4 over the adapters (make_optimizer(lora_only=True));
    one warm step, then three timed. Held: every base code and scale bit-identical after the
    steps, lora_b off zero, finite losses, step 0's loss equal to the base's without adapters
    within phase 9's bf16 band, every K2 and K7 launch of one step re-run against its plain
    version; then the adapters through save_lora and load_lora into the bare base, and 8
    greedy tokens of the adapted LM through the captured step (K4 plus the deltas) against
    the eager step, one step's 113 K4 launches re-run against the plain version."""
    from audio_flamingo_tpu_torch.config import AF3Config, WhisperEncoderConfig
    from audio_flamingo_tpu_torch.models import adaptor, af3, qwen2, whisper_encoder
    from audio_flamingo_tpu_torch.models import lora
    from audio_flamingo_tpu_torch.ops.quant import quantize_lm_params
    from audio_flamingo_tpu_torch.runtime import generate as gen
    from audio_flamingo_tpu_torch.train.stages import Stage
    from audio_flamingo_tpu_torch.train.train_step import init_state, loss_and_grads, train_step

    t_phase = time.perf_counter()
    full = AF3Config()
    lm_cfg = dataclasses.replace(full.lm, use_flash=True, remat="full")
    enc_cfg = WhisperEncoderConfig(num_mel_bins=16, d_model=64, num_layers=2, num_heads=4,
                                   ffn_dim=128)
    cfg = AF3Config(encoder=enc_cfg, lm=lm_cfg)
    gen_ = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    with torch.device("meta"):
        float_lm = qwen2.Qwen2(lm_cfg, dtype=torch.bfloat16)
    float_lm = float_lm.to_empty(device="cuda").requires_grad_(False)
    qwen2.init_(float_lm, gen_)
    qlm = qwen2.quantized_lm(quantize_lm_params(float_lm.state_dict()), torch.bfloat16, "cuda")
    del float_lm
    gc.collect()
    torch.cuda.empty_cache()
    model = af3.build(cfg, "cuda", torch.bfloat16, lm=qlm)
    whisper_encoder.init_(model.encoder, enc_cfg, gen_)
    adaptor.init_(model.adaptor, gen_)
    base0 = {n: t.clone() for n, t in qlm.state_dict().items()}
    log(f"17a: the int8 7B made on the card (bf16 from a seed, quantize_lm_params) in "
        f"{time.perf_counter() - t0:.1f}s, {sum(t.numel() * t.element_size() for t in base0.values()) / 1e9:.2f} GB")
    rng = np.random.default_rng(0)
    b, t = QLORA_BATCH
    ids = torch.from_numpy(rng.integers(0, 150_000, (b, t))).cuda()
    batch = {"ids": ids, "labels": ids, "mels": None}
    with torch.no_grad():
        base_loss = af3.loss(model, cfg, ids, ids, None, ce_chunk=256).item()
    lora.add_lora(torch.Generator(device="cuda").manual_seed(3), model, rank=QLORA_RANK)
    stage = Stage("qlora", train_encoder=False, train_adaptor=False, train_lm=True, lr=1e-4)
    state, opt = init_state(model, stage, lora_only=True, warmup_steps=0, total_steps=10_000)
    n_adapt = sum(p.numel() for n, p in model.named_parameters() if n in opt.hot)
    check(len(opt.hot) == 14 and all(".lora_" in n for n in opt.hot),
          f"17a: the hot set is not the 7 targets' lora_a and lora_b: {opt.hot}")
    log(f"17a: rank-{QLORA_RANK} adapters on 7 targets x 28 layers, {n_adapt / 1e6:.2f} M "
        f"f32 parameters hot; the base's {len(base0)} tensors frozen (no gradient, no state)")
    for c in (fa.LAUNCHES, fa.BWD_LAUNCHES):
        c.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(1 + QLORA_STEPS):
        timed = i == 1
        for c in (fa.LAUNCHES, fa.BWD_LAUNCHES):
            c.reset()
            c.timing = timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(state, batch, cfg=cfg, opt=opt, ce_chunk=256)
        losses.append(m["loss"].item())
        times.append(time.perf_counter() - t0)
        if timed:
            k2_n, k7_n = dict(fa.LAUNCHES.shapes), dict(fa.BWD_LAUNCHES.shapes)
            k2_ms, k7_ms = fa.LAUNCHES.device_ms(), fa.BWD_LAUNCHES.device_ms()
    for c in (fa.LAUNCHES, fa.BWD_LAUNCHES):
        c.timing = False
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_s = statistics.median(times[1:])
    check(all(np.isfinite(losses)), f"17a: losses {losses}")
    dl = abs(losses[0] - base_loss) / abs(base_loss)
    check(dl <= STAGE2_LOSS_RTOL, f"17a: step 0's loss {losses[0]} != the base's {base_loss} "
                                  f"({dl:.2e} relative)")
    check(all(torch.equal(t_, base0[n]) for n, t_ in qlm.state_dict().items() if n in base0),
          "17a: a base code or scale changed")
    moved = max(lora.adapters(model)[n]["lora_b"].abs().max().item() for n in lora.DEFAULT_TARGETS)
    check(moved > 0, "17a: lora_b did not move")
    lm_q, lm_k = (b, t, lm_cfg.num_heads, 128), (b, t, lm_cfg.num_kv_heads, 128)
    want = {(lm_q, lm_k, True): 2 * lm_cfg.num_layers}
    check(k2_n == want and k7_n == {(lm_q, lm_k, True): lm_cfg.num_layers},
          f"17a: K2 {k2_n}, K7 {k7_n} launches in a step, not 56 and 28")
    # one more step's launches kept and re-run against the plain versions
    for c in (fa.LAUNCHES, fa.BWD_LAUNCHES):
        c.reset()
        c.capture = True
    loss_and_grads(model, batch, cfg=cfg, opt=opt, ce_chunk=256)
    k2_cap, k7_cap = list(fa.LAUNCHES.inputs), list(fa.BWD_LAUNCHES.inputs)
    for c in (fa.LAUNCHES, fa.BWD_LAUNCHES):
        c.capture = False
        c.reset()
    k2_rep = k2_launch_sums(fa, k2_cap)
    k7_rep = k7_launch_sums(fa, k7_cap, "a 17a K7 launch")
    del k2_cap, k7_cap
    tokens = b * t
    log(f"17a QLoRA-7B step (batch {b} x {t}, median of {QLORA_STEPS} after a warm step): "
        f"{step_s * 1e3:.1f} ms = {tokens / step_s:.1f} tokens/s; losses "
        f"{[round(x, 5) for x in losses]} (the base without adapters {base_loss:.5f}, "
        f"{dl:.2e} relative); peak {peak:.2f} GiB; K2 {sum(k2_n.values())} launches "
        f"{k2_ms:.3f} ms a step (bound {k2_rep['bound_ms']:.3f} ms, plain {k2_rep['plain_ms']:.1f}, "
        f"SDPA {k2_rep['library_ms']:.3f}; every launch within {k2_rep['ratio']:.3f} of its "
        f"limit), K7 {sum(k7_n.values())} launches {k7_ms:.3f} ms a step (bound "
        f"{k7_rep['bound_ms']:.3f} ms, plain {k7_rep['plain_ms']:.1f}, SDPA backward "
        f"{k7_rep['library_ms']:.3f}; within {k7_rep['ratio']:.3f} of its limit); the base "
        f"bit-identical, largest |lora_b| {moved:.3e}")
    del state, opt
    # the adapters shipped: save_lora, then load_lora into the bare base
    trained = {n: {k: v.detach().clone() for k, v in a.items()}
               for n, a in lora.adapters(model).items()}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "adapters.safetensors")
        lora.save_lora(path, qlm)                 # the LM's adapters: names layers/...
        size = os.path.getsize(path)
        bare = qwen2.QuantQwen2(qwen2.unflatten(
            {n: t_ for n, t_ in qlm.state_dict().items() if ".lora_" not in n}))
        lora.load_lora(path, bare)
    del model, qlm
    gc.collect()
    torch.cuda.empty_cache()
    check(all(torch.equal(lora.adapters(bare)[n][k], v) for n, a in trained.items()
              for k, v in a.items()), "17a: load_lora did not give back the trained adapters")
    log(f"17a: save_lora wrote {size / 1e6:.1f} MB; load_lora into the bare int8 base gave "
        f"back every adapter bit for bit")
    dec = decode_loop_run("17a adapted int8 7B decode, bf16 cache c1024", bare, lm_cfg,
                          lambda: qwen2.init_cache(lm_cfg, 1, 1024, torch.bfloat16, "cuda"),
                          QLORA_DECODE, 1, {"K4": k4.LAUNCHES}, {"K4": ("K4",)},
                          keep_inputs=("K4",))
    per_step = k4_step_launches(lm_cfg.num_layers)
    check(dec["counts"]["K4"] == per_step, f"17a: K4 launches a step {dec['counts']['K4']} "
                                          f"!= {per_step}")
    step_inputs = dec["inputs"]["K4"][:per_step]
    worst = captured_k4_checks(k4, step_inputs, "17a")
    timing = k4_launch_timing(k4, step_inputs)
    k4_row = dict(count=per_step, ms=dec["prof"]["groups"]["K4"][1],
                  plain_ms=sum(r["plain_ms"] * r["count"] for r in timing.values()),
                  library_ms=sum(r["library_ms"] * r["count"] for r in timing.values()
                                 if r["library_ms"] is not None),
                  bound_ms=sum(r["bound_ms"] * r["count"] for r in timing.values()),
                  bound_by="bytes", err=worst[0], ratio=worst[1],
                  step_ms=dec["graph_ms"], eager_ms=dec["eager_ms"])
    log(f"17a: the adapted int8 7B's decode step: {dec['graph_ms']:.3f} ms captured, "
        f"{dec['eager_ms']:.3f} ms eager; K4 {per_step} launches {k4_row['ms']:.3f} ms of device "
        f"time a step (profiled replay; bound {k4_row['bound_ms']:.3f} ms, plain "
        f"{k4_row['plain_ms']:.3f}, _weight_int8pack_mm {k4_row['library_ms']:.3f}), one "
        f"step's launches within {worst[1]:.3f} of their limit (max|y - plain| {worst[0]:.3e})")
    del bare, dec, step_inputs
    gen.release_graphs()
    gc.collect()
    torch.cuda.empty_cache()
    rows = {name: dict(count=sum(n.values()), ms=ms, bound_ms=rep["bound_ms"],
                       bound_by=rep["bound_by"], plain_ms=rep["plain_ms"],
                       library_ms=rep["library_ms"], err=rep["err"], ratio=rep["ratio"])
            for name, n, ms, rep in (("K2", k2_n, k2_ms, k2_rep), ("K7", k7_n, k7_ms, k7_rep))}
    s = time.perf_counter() - t_phase
    log(f"17a: took {s:.1f} s")
    return dict(step_s=step_s, tokens_s=tokens / step_s, peak=peak, losses=losses,
                base_loss=base_loss, rows=rows, k4=k4_row, s=s)


def grpo_phase(fa, pa) -> dict:
    """17b. GRPO-1.5B at full width, bench_grpo: a bf16 Qwen2.5-1.5B policy (28 layers, 1536
    wide, 12 / 2 heads) with the full bf16 encoder and adaptor; the reference shares the
    towers and holds its LM in int8 (quantize_lm_params); PagedEngine(num_rows=8,
    num_blocks=80, block_size=128, max_blocks_per_seq=8, chunk=16, prefix_cache=True),
    sampling at temperature 1.0, top-k 50; G = 8 rollouts of one prompt (750 <sound> ids
    and 64 text ids, a 30 s mel), 32 new tokens (the bench: 128 and 64); one warm rollout,
    one timed with no probe on (the rate), one probed with one chunk's K3 launches (g = 6)
    held to paged_attention_plain, then one grpo_step(trainable="lm", offload_pool=True)
    with the port's AdamW (the bench's is optax.adafactor). Held: the pool bit-identical
    after restore_pool, the first update's ratio 1 on every generated token, the encoder and
    adaptor unchanged, a nonzero gradient and the LM moved past its weight decay, the
    engine's LM tensors the policy's, and the engine's prefill of a new prompt giving the
    policy's first-token logits within GRPO_LOGITS_BAND; the update's K2 and K7 launches
    counted and timed."""
    from audio_flamingo_tpu_torch.api import AudioFlamingo
    from audio_flamingo_tpu_torch.config import AF3Config, Qwen2Config
    from audio_flamingo_tpu_torch.models import af3, qwen2
    from audio_flamingo_tpu_torch.ops.quant import quantize_lm_params
    from audio_flamingo_tpu_torch.ops.sampling import SamplingParams
    from audio_flamingo_tpu_torch.runtime import paged_engine as pe_mod
    from audio_flamingo_tpu_torch.train import grpo
    from audio_flamingo_tpu_torch.train.stages import MF_STAGES
    from audio_flamingo_tpu_torch.train.train_step import global_norm, make_optimizer

    t_phase = time.perf_counter()
    full = AF3Config()
    cfg = AF3Config(encoder=dataclasses.replace(full.encoder, use_flash=True),
                    lm=dataclasses.replace(Qwen2Config.qwen25_1_5b(), use_flash=True,
                                           remat="full"))
    m = AudioFlamingo.from_random(cfg, seed=0, compute_dtype=torch.bfloat16, device="cuda")
    cfg, model = m.cfg, m.model
    ref = af3.AF3Model(model.encoder, model.adaptor, qwen2.quantized_lm(
        quantize_lm_params(model.lm.state_dict()), torch.bfloat16, "cuda"))
    rng = np.random.default_rng(0)
    ntok, text = 750, 64
    ids = np.full((1, ntok + text), cfg.audio_token_id, np.int64)
    ids[0, ntok:] = rng.integers(1000, 150_000, text)
    mels = (rng.normal(size=(1, 1, 3000, 128)) * 0.1).astype(np.float32)
    prompt = {"ids": ids, "mels": mels}
    gcfg = grpo.GRPOConfig(group_size=GRPO_G, max_new_tokens=GRPO_NEW, temperature=1.0,
                           top_k=50)
    engine = pe_mod.PagedEngine(model=model, cfg=cfg, device="cuda",
                                sampling=SamplingParams(greedy=False, temperature=1.0, top_k=50),
                                **GRPO_ENGINE)
    roll = grpo.make_engine_rollout(engine)
    roll(ids, mels, gcfg, -1)                                  # warm every bucket
    # the rollout's rate: one run with no probe and no per-launch timing
    hits0 = engine.store.hits
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, lengths = roll(ids, mels, gcfg, -1)
    torch.cuda.synchronize()
    dt_roll = time.perf_counter() - t0
    gen_tok, hits = int(lengths.sum()), engine.store.hits - hits0
    # one more, probed: its K3 launches counted and timed, the first chunk held and replayed
    with ChunkProbe(pe_mod, qwen2, pa) as probe:
        probe.reset(replay_chunk=0, plain_step=True)
        pa.LAUNCHES.reset()
        pa.LAUNCHES.timing = True
        full_ids, gen_mask, _ = roll(ids, mels, gcfg, -1)
        k3_roll, k3_shapes = pa.LAUNCHES.count, dict(pa.LAUNCHES.shapes)
        pa.LAUNCHES.timing = False
        pa.LAUNCHES.reset()
        rep = probe.replay
    g = cfg.lm.num_heads // cfg.lm.num_kv_heads
    check(g == 6 and k3_shapes and all(k[2] == g for k in k3_shapes),
          f"17b: K3 launched at {k3_shapes}, not at g = 6")
    check(rep is not None and rep["launches"] > 0 and rep["ratio"] <= 1.0,
          f"17b: one rollout chunk's K3 launches not held: {rep}")
    log(f"17b rollout: {gen_tok} tokens of G = {GRPO_G} rows in {dt_roll:.3f} s = "
        f"{gen_tok / dt_roll:.1f} tok/s (paged engine, prefix hits {hits}, no probe); a probed "
        f"rollout: K3 {k3_roll} launches at g = {g} ({k3_shapes}); the first chunk's {rep['launches']} "
        f"launches ({rep['steps']} steps) held to paged_attention_plain (max|o/l - plain| "
        f"{rep['err']:.3e}, {rep['ratio']:.3f} of the limit), {rep['path_ms']:.3f} ms in the "
        f"path (events), {rep['ms']:.3f} ms replayed in one graph, bound {rep['bound_ms']:.4f} "
        f"ms ({rep['bound_by']}), plain {rep['plain_ms']:.1f} ms (a step's launches timed "
        f"alone, {rep['plain_step_ms']:.1f} ms, times the steps)")
    check(bool(gen_mask.any()) and tuple(full_ids.shape) == (GRPO_G, ids.shape[1] + GRPO_NEW),
          f"17b: rollout shapes {tuple(full_ids.shape)}")
    # the step
    opt = make_optimizer(MF_STAGES["mf_3_grpo"], model.lm, warmup_steps=0)
    opt_state = opt.init(model.lm)
    decay = 1.0 - opt.learning_rate(0) * opt.weight_decay
    towers0 = {n: t_.clone() for n, t_ in model.state_dict().items() if not n.startswith("lm.")}
    lm0 = {n: t_.clone() for n, t_ in model.lm.state_dict().items()}
    seen = dict(pool=None, restored=None, ratio=[], update=None, g_norm=None)

    class SeenOpt:
        """The optimizer, with the hot gradients' global norm kept."""

        def __getattr__(self, name):
            return getattr(opt, name)

        def update(self, grads, state_, module):
            seen["g_norm"] = global_norm(grads[n] for n in opt.hot).item()
            return opt.update(grads, state_, module)

    real = dict(offload=engine.offload_pool, restore=engine.restore_pool,
                terms=grpo._loss_terms, update=grpo._grpo_update)

    def offload():
        seen["pool"] = {n: getattr(engine.cache, n).clone() for n in ("k", "v")}
        real["offload"]()

    def restore():
        real["restore"]()
        seen["restored"] = all(torch.equal(getattr(engine.cache, n), t_)
                               for n, t_ in seen["pool"].items())

    def terms(model_, ref_logp, cfg_, ids_, mels_, mask, adv, old, gc_):
        loss, ratio = real["terms"](model_, ref_logp, cfg_, ids_, mels_, mask, adv, old, gc_)
        seen["ratio"].append((ratio, mask[:, 1:].clone()))
        return loss, ratio

    def update(*a, **kw):
        for c in (fa.LAUNCHES, fa.BWD_LAUNCHES):
            c.reset()
            c.timing = True
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = real["update"](*a, **kw)
        torch.cuda.synchronize()
        seen["update"] = dict(s=time.perf_counter() - t0,
                              peak=torch.cuda.max_memory_allocated() / 2 ** 30,
                              k2=dict(fa.LAUNCHES.shapes), k7=dict(fa.BWD_LAUNCHES.shapes),
                              k2_ms=fa.LAUNCHES.device_ms(), k7_ms=fa.BWD_LAUNCHES.device_ms())
        for c in (fa.LAUNCHES, fa.BWD_LAUNCHES):
            c.timing = False
            c.reset()
        return out

    engine.offload_pool, engine.restore_pool = offload, restore
    grpo._loss_terms, grpo._grpo_update = terms, update
    try:
        t0 = time.perf_counter()
        _, opt_state, metrics = grpo.grpo_step(
            model, ref, SeenOpt(), opt_state, cfg, [prompt],
            lambda txt: len(set(txt.split())) / max(len(txt.split()), 1), gcfg, -1, None,
            lambda toks: " ".join(str(x) for x in toks), rollout_fn=roll, trainable="lm",
            offload_pool=True)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    finally:
        engine.offload_pool, engine.restore_pool = real["offload"], real["restore"]
        grpo._loss_terms, grpo._grpo_update = real["terms"], real["update"]
    up = seen["update"]
    check(seen["restored"] is True, "17b: the pool after restore_pool differs from the pool "
                                   "before offload_pool")
    ratio, mask = seen["ratio"][0]
    check(bool((ratio[mask] == 1).all()), f"17b: the first update's ratio is not 1 on every "
          f"generated token: {ratio[mask].min().item()}..{ratio[mask].max().item()}")
    check(all(torch.equal(t_, towers0[n]) for n, t_ in model.state_dict().items()
              if n in towers0), "17b: the encoder or adaptor changed")
    g_norm = seen["g_norm"]
    check(g_norm is not None and np.isfinite(g_norm) and g_norm > 0,
          f"17b: the hot gradients' norm is {g_norm}")
    # moved: off the pure weight-decay step p (1 - lr wd) in the tensor's dtype
    lm_moved = sum(not torch.equal(t_, (lm0[n].float() * decay).to(t_.dtype))
                   for n, t_ in model.lm.state_dict().items() if n in opt.hot)
    check(lm_moved > 0, "17b: the LM did not move past its weight decay")
    check(engine.model is model and all(
        a.data_ptr() == b_.data_ptr() for a, b_ in zip(engine.model.lm.parameters(),
                                                       model.lm.parameters())),
          "17b: the engine's LM tensors are not the policy's")
    # one new prompt (no prefix hit) through the engine's own prefill into its pool: its
    # first-token logits against the policy's dense forward
    probe_ids = rng.integers(1000, 150_000, (1, 64)).astype(np.int32)
    first, real_emit = {}, pe_mod._emit_first_token
    pe_mod._emit_first_token = (lambda e, r, lg: first.__setitem__(r.request_id, lg.float())
                                or real_emit(e, r, lg))
    try:
        hits0 = engine.store.hits
        serve_any(engine, [("probe", probe_ids, None)], 1)
    finally:
        pe_mod._emit_first_token = real_emit
    with torch.no_grad():
        dense = af3.logits(model, cfg, torch.from_numpy(probe_ids).long().cuda())[0, -1].float()
    eng_rel = ((first["probe"].reshape(-1) - dense).abs().max() / dense.abs().max()).item()
    check(engine.store.hits == hits0 and eng_rel <= GRPO_LOGITS_BAND,
          f"17b: the engine's first-token logits {eng_rel:.3e} of max|logit| off the policy's "
          f"(band {GRPO_LOGITS_BAND}; prefix hits {engine.store.hits - hits0})")
    check(np.isfinite(metrics["loss"]), f"17b: GRPO loss {metrics['loss']}")
    enc_q = (GRPO_G, 1500, cfg.encoder.num_heads, cfg.encoder.d_model // cfg.encoder.num_heads)
    log(f"17b GRPO step (G = {GRPO_G}, {GRPO_NEW} new tokens, trainable lm, offload_pool): "
        f"{step_s:.2f} s in all, the update {up['s']:.2f} s (peak {up['peak']:.2f} GiB); loss "
        f"{metrics['loss']:.5f}, mean reward {metrics['mean_reward']:.4f}; the first ratio 1 on "
        f"all {int(mask.sum())} generated tokens; the pool restored bit-identical; the towers "
        f"unchanged, {lm_moved} LM tensors moved past the weight decay (hot gradients' norm "
        f"{g_norm:.3e}); the engine holds the policy's tensors, and its prefill of a new prompt "
        f"gives the policy's first-token logits within {eng_rel:.3e} of max|logit| (band "
        f"{GRPO_LOGITS_BAND}); the update's K2 {up['k2']} ({up['k2_ms']:.3f} ms), K7 {up['k7']} "
        f"({up['k7_ms']:.3f} ms)")
    rows = flash_launch_rows(fa, up["k2"], up["k2_ms"], up["k7"], up["k7_ms"])
    # one rollout chunk's K3 plain time: each launch of the chunk's first step timed alone,
    # times the chunk's steps
    k3_row = dict(launches=rep["launches"], steps=rep["steps"], path_ms=rep["path_ms"],
                  graph_ms=rep["ms"], bound_ms=rep["bound_ms"], bound_by=rep["bound_by"],
                  err=rep["err"], ratio=rep["ratio"], plain_ms=rep["plain_ms"],
                  rollout_launches=k3_roll)
    del engine, roll, m, model, ref, towers0, lm0, opt_state, seen, probe
    gc.collect()
    torch.cuda.empty_cache()
    s = time.perf_counter() - t_phase
    log(f"17b: took {s:.1f} s")
    return dict(rollout_tps=gen_tok / dt_roll, rollout_s=dt_roll, update_s=up["s"],
                step_s=step_s, peak=up["peak"], rows=rows, k3=k3_row, s=s,
                loss=metrics["loss"], enc_q=enc_q)


def f32_train17_card_vs_cpu_phase(fa) -> dict:
    """17c. f32 card against CPU at full width, 2 + 2 layers, 1 x 128 tokens: a QLoRA step's
    loss and adapter gradients (the 7B's widths, the int8 LM by quantize_lm_params,
    rank-16 adapters with lora_b off zero), and grpo_loss and its LM gradients (the 1.5B's
    widths, float, G = 2 rows of one fixed rollout, the same ids, advantages and
    off-policy logprobs on both sides), within 1e-4 (the loss relative, a gradient relative
    to its tensor's largest). The weights are made (and the LM quantized) on the card and
    copied to the CPU, so both sides hold the same tensors; the card runs K2 and K7, the
    CPU their plain versions."""
    from audio_flamingo_tpu_torch.config import AF3Config, Qwen2Config, WhisperEncoderConfig
    from audio_flamingo_tpu_torch.models import adaptor, af3, qwen2, whisper_encoder
    from audio_flamingo_tpu_torch.models import lora
    from audio_flamingo_tpu_torch.ops.quant import quantize_lm_params
    from audio_flamingo_tpu_torch.train import grpo
    from audio_flamingo_tpu_torch.train.stages import Stage
    from audio_flamingo_tpu_torch.train.train_step import init_state, loss_and_grads

    t_phase = time.perf_counter()
    enc_cfg = WhisperEncoderConfig(num_mel_bins=16, d_model=64, num_layers=2, num_heads=4,
                                   ffn_dim=128)
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.integers(0, 150_000, (1, 128)))
    res = {}
    # QLoRA at the 7B's widths
    lm_cfg = dataclasses.replace(AF3Config().lm, num_layers=2, use_flash=True, remat="full")
    cfg = AF3Config(encoder=enc_cfg, lm=lm_cfg)
    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.device("meta"):
        float_lm = qwen2.Qwen2(lm_cfg, dtype=torch.float32)
    float_lm = float_lm.to_empty(device="cuda").requires_grad_(False)
    qwen2.init_(float_lm, g)
    card_lm = qwen2.quantized_lm(quantize_lm_params(float_lm.state_dict()), torch.float32,
                                 "cuda")
    del float_lm
    lora.add_lora(g, card_lm, rank=QLORA_RANK)
    with torch.no_grad():
        for leaves in lora.adapters(card_lm).values():
            leaves["lora_b"].normal_(0.0, 0.01, generator=g)
    tree = qwen2.unflatten({n: t.cpu() for n, t in card_lm.state_dict().items()})
    models = {"cpu": af3.build(cfg, "cpu", torch.float32,
                               lm=qwen2.quantized_lm(tree, torch.float32, "cpu")),
              "card": af3.build(cfg, "cuda", torch.float32, lm=card_lm)}
    whisper_encoder.init_(models["card"].encoder, enc_cfg, g)
    adaptor.init_(models["card"].adaptor, g)
    models["cpu"].encoder.load_state_dict(models["card"].encoder.state_dict())
    models["cpu"].adaptor.load_state_dict(models["card"].adaptor.state_dict())
    stage = Stage("qlora", train_encoder=False, train_adaptor=False, train_lm=True, lr=1e-4)
    out = {}
    for side, model in models.items():
        dev = "cuda" if side == "card" else "cpu"
        _, opt = init_state(model, stage, lora_only=True)
        fa.LAUNCHES.reset()
        fa.BWD_LAUNCHES.reset()
        t0 = time.perf_counter()
        loss, grads = loss_and_grads(model, {"ids": ids.to(dev), "labels": ids.to(dev),
                                             "mels": None}, cfg=cfg, opt=opt, ce_chunk=256)
        out[side] = dict(loss=loss.item(), grads={n: x.cpu() for n, x in grads.items()},
                         s=time.perf_counter() - t0, k2=fa.LAUNCHES.count,
                         k7=fa.BWD_LAUNCHES.count)
    c, p = out["card"], out["cpu"]
    dl = abs(c["loss"] - p["loss"]) / abs(p["loss"])
    dg = max(((c["grads"][n] - x).abs().max() / x.abs().max()).item()
             for n, x in p["grads"].items())
    check(c["k2"] == 4 and c["k7"] == 2 and p["k2"] == p["k7"] == 0,
          f"17c QLoRA: launches card K2 {c['k2']} K7 {c['k7']}, CPU {p['k2']} {p['k7']}")
    log(f"17c f32 QLoRA step at the 7B's widths, 2 layers, 1 x 128: loss CPU {p['loss']:.6f} "
        f"card {c['loss']:.6f} ({dl:.2e} rel); {len(p['grads'])} adapter gradients within "
        f"{dg:.2e} of their largest; CPU {p['s']:.1f}s, card {c['s']:.3f}s")
    check(dl <= TRAIN_F32_TOL and dg <= TRAIN_F32_TOL,
          f"17c QLoRA card vs CPU: loss {dl:.2e}, grads {dg:.2e} > {TRAIN_F32_TOL}")
    res["qlora"] = dict(loss=dl, grads=dg)
    del models, card_lm, tree, out
    gc.collect()
    torch.cuda.empty_cache()
    # GRPO at the 1.5B's widths
    lm_cfg = dataclasses.replace(Qwen2Config.qwen25_1_5b(), num_layers=2, use_flash=True,
                                 remat="full")
    cfg = AF3Config(encoder=enc_cfg, lm=lm_cfg)
    card = af3.build(cfg, "cuda", torch.float32)
    af3.init_(card, cfg, torch.Generator(device="cuda").manual_seed(1))
    cpu = af3.build(cfg, "cpu", torch.float32)
    cpu.load_state_dict(card.state_dict())
    gcfg = grpo.GRPOConfig(group_size=2, max_new_tokens=16)
    full = ids.expand(2, 128).clone()
    full[1, 112:] = torch.from_numpy(rng.integers(0, 150_000, 16))
    gen_mask = torch.zeros((2, 128), dtype=torch.bool)
    gen_mask[0, 112:] = True
    gen_mask[1, 112:125] = True
    with torch.no_grad():
        lp = grpo._token_logp(cpu, cfg, full, None)
    old = lp + torch.from_numpy(rng.normal(size=lp.shape).astype(np.float32)) * 0.3
    ref_lp = lp + torch.from_numpy(rng.normal(size=lp.shape).astype(np.float32)) * 0.2
    adv = torch.tensor([1.0, -1.0])
    out = {}
    for side, model in (("cpu", cpu), ("card", card)):
        dev = "cuda" if side == "card" else "cpu"
        wrt = dict(model.lm.named_parameters())
        for x in wrt.values():
            x.requires_grad_(True)
        fa.LAUNCHES.reset()
        fa.BWD_LAUNCHES.reset()
        t0 = time.perf_counter()
        loss = grpo.grpo_loss(model, ref_lp.to(dev), cfg, full.to(dev), None, gen_mask.to(dev),
                              adv.to(dev), old.to(dev), gcfg)
        grads = torch.autograd.grad(loss, list(wrt.values()))
        out[side] = dict(loss=loss.item(), grads={n: x.cpu() for n, x in zip(wrt, grads)},
                         s=time.perf_counter() - t0, k2=fa.LAUNCHES.count,
                         k7=fa.BWD_LAUNCHES.count)
        for x in wrt.values():
            x.requires_grad_(False)
    c, p = out["card"], out["cpu"]
    dl = abs(c["loss"] - p["loss"]) / abs(p["loss"])
    dg = max(((c["grads"][n] - x).abs().max() / x.abs().max()).item()
             for n, x in p["grads"].items())
    check(c["k2"] == 4 and c["k7"] == 2 and p["k2"] == p["k7"] == 0,
          f"17c GRPO: launches card K2 {c['k2']} K7 {c['k7']}, CPU {p['k2']} {p['k7']}")
    log(f"17c f32 grpo_loss at the 1.5B's widths, 2 layers, G = 2 x 128, off-policy logprobs: "
        f"loss CPU {p['loss']:.6f} card {c['loss']:.6f} ({dl:.2e} rel); {len(p['grads'])} LM "
        f"gradients within {dg:.2e} of their largest; CPU {p['s']:.1f}s, card {c['s']:.3f}s")
    check(dl <= TRAIN_F32_TOL and dg <= TRAIN_F32_TOL,
          f"17c GRPO card vs CPU: loss {dl:.2e}, grads {dg:.2e} > {TRAIN_F32_TOL}")
    res["grpo"] = dict(loss=dl, grads=dg)
    del cpu, card, out
    gc.collect()
    torch.cuda.empty_cache()
    res["s"] = time.perf_counter() - t_phase
    log(f"17c: took {res['s']:.1f} s")
    return res


# ---------------------------------------------------------------------------------------
# Phase 18: the user entry points (the native BPE, python -m audio_flamingo_tpu_torch, the
# demo server, the eval harness) and 15 minutes of Music Flamingo

P18_TOKENS = 16                 # new tokens of every 18b-18e answer
CLI_LAYERS = (2, 2)             # 18b's checkpoint: encoder and LM layers, at full width
CLI_PROMPT = "Describe the audio in detail."   # the CLI's default infer prompt
CHAT_TURNS = ("What do you hear?", "And then?")
EVAL_TASKS = (("asr", "Transcribe the speech.", "the quick brown fox"),
              ("mcq", "Which instrument plays? (A) piano (B) drums. Answer with a letter.",
               "A"),
              ("qa", "What is the loudest sound?", "a tone"),
              ("caption", "Describe the audio.", ["a steady tone over noise",
                                                  "a high pitched hum"]))
MUSIC_SECONDS = 900             # 15 minutes: Music Flamingo's 30 windows
MIXED_TEXT = ("Audio Flamingo hört zu: «Ça sonne bien», говорит он; 音楽と音声を説明して"
              "ください。 صوت الموسيقى ١٢٣ 12,345.67 —   tabs\tand\r\nnew lines\n\n"
              " emoji 😀🎵 ♪ naïve café ﬁ 並 x\x1cy don't I'LL 'S  ")


def synthetic_tokenizer(vocab_size: int, seed: int):
    """A byte-level BPE tokenizer whose ids fill an LM's whole vocab: the 256 byte symbols,
    then merges of two earlier tokens drawn at random (each making a new string), then
    the special tokens. A random-weight model's greedy ids then decode to text, so that an
    answer compared as text (the CLI's stdout, the demo's reply) compares every token."""
    from audio_flamingo_tpu_torch.runtime.tokenizer import (DEFAULT_SPECIAL_TOKENS,
                                                            BBPETokenizer, bytes_to_unicode)

    rng = np.random.default_rng(seed)
    tokens = sorted(bytes_to_unicode().values())
    seen = set(tokens)
    merges = []
    n_merges = vocab_size - len(tokens) - len(DEFAULT_SPECIAL_TOKENS)
    while len(merges) < n_merges:
        # draw from the shorter half more often, so that merges of common pairs exist
        for a, b in rng.integers(0, len(tokens), (4096, 2)) // rng.integers(1, 3, (4096, 1)):
            new = tokens[a] + tokens[b]
            if new not in seen and len(merges) < n_merges:
                seen.add(new)
                tokens.append(new)
                merges.append((tokens[a], tokens[b]))
    vocab = {t: i for i, t in enumerate(tokens)}
    for t in DEFAULT_SPECIAL_TOKENS:
        vocab[t] = len(vocab)
    return BBPETokenizer(vocab, merges)


def bpe_phase(tokenizers: dict, texts: list) -> dict:
    """18a. The native BPE (runtime/cpp/bpe.cpp) against the Python merge loop, token for
    token, on every tokenizer given (a fresh copy of each path, so neither reads a cache
    the other filled) over the texts, each also with the special tokens off; and each
    path's time on the longest text."""
    from audio_flamingo_tpu_torch.runtime.tokenizer import BBPETokenizer

    out = {}
    for name, tok in tokenizers.items():
        native = BBPETokenizer(tok.vocab, tok.merges)
        plain = BBPETokenizer(tok.vocab, tok.merges, use_native=False)
        check(native._native is not None, f"18a {name}: the native BPE is not on")
        longest = max(texts, key=len)
        t0 = time.perf_counter()
        ids_native = native.encode(longest)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ids_plain = plain.encode(longest)
        plain_s = time.perf_counter() - t0
        check(ids_native == ids_plain, f"18a {name}: the longest text differs")
        n_ids = 0
        for text in texts:
            for special in (True, False):
                a, b = native.encode(text, special), plain.encode(text, special)
                check(a == b, f"18a {name}: native and Python ids differ on {text[:60]!r}")
                n_ids += len(a)
            check(native.decode(native.encode(text)) == unicodedata.normalize("NFC", text),
                  f"18a {name}: decode(encode(text)) != text for {text[:60]!r}")
        out[name] = dict(vocab=len(tok.vocab), texts=len(texts), ids=n_ids,
                         longest=(len(longest), len(ids_native)), native_s=native_s,
                         plain_s=plain_s)
        log(f"18a native BPE, {name} ({len(tok.vocab)} ids, {len(tok.merges)} merges): "
            f"{len(texts)} texts x 2, {n_ids} ids, token for token equal to the Python merge "
            f"loop; the longest ({len(longest)} chars, {len(ids_native)} ids) in "
            f"{native_s * 1e3:.1f} ms native, {plain_s * 1e3:.1f} ms Python (host, cold caches)")
    return out


def random_text(seed: int, words: int) -> str:
    """Words of 1-12 characters drawn from Latin, Cyrillic, Greek, CJK, kana, Arabic and
    digits, joined by spaces, punctuation and newlines: mostly distinct pretokens, so that
    the merge loops run instead of their caches."""
    rng = np.random.default_rng(seed)
    pools = [list(range(0x61, 0x7b)), list(range(0x430, 0x450)), list(range(0x3b1, 0x3ca)),
             list(range(0x4e00, 0x4f00)), list(range(0x3041, 0x3097)), list(range(0x627, 0x64b)),
             list(range(0x30, 0x3a))]
    seps = [" ", " ", " ", ", ", ". ", "\n", " — ", "'s ", "  "]
    out = []
    for _ in range(words):
        pool = pools[int(rng.integers(len(pools)))]
        out.append("".join(chr(pool[int(i)]) for i in rng.integers(0, len(pool),
                                                                    int(rng.integers(1, 13)))))
        out.append(seps[int(rng.integers(len(seps)))])
    return "".join(out)


def run_cli(args: list, stdin: str = "") -> tuple:
    """``python -m audio_flamingo_tpu_torch <args>`` from the repo root: (stdout, seconds).
    A non-zero exit fails the check with the process's stderr."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "audio_flamingo_tpu_torch", *args],
                          input=stdin.encode(), capture_output=True, cwd=root, timeout=600,
                          env=dict(os.environ, PYTHONIOENCODING="utf-8"))
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"18b `{' '.join(args[:1])}` exited {proc.returncode}: "
                                f"{proc.stderr.decode(errors='replace')[-3000:]}")
    return proc.stdout.decode("utf-8"), seconds


def cli_phase(fa, tok, tmp: str) -> dict:
    """18b. python -m audio_flamingo_tpu_torch infer and chat, one subprocess at a time, on
    a full-width AF3 checkpoint at CLI_LAYERS depth written in bf16 by
    io/hf_export.save_pretrained: each answer equal to load(DIR).generate in this process
    on the same file (the CLI's greedy sampling), every exit code 0."""
    from audio_flamingo_tpu_torch.api import AudioFlamingo, load
    from audio_flamingo_tpu_torch.audio.io import load_audio
    from audio_flamingo_tpu_torch.config import AF3Config
    from audio_flamingo_tpu_torch.io.hf_export import save_pretrained
    from audio_flamingo_tpu_torch.ops.sampling import SamplingParams

    t0 = time.perf_counter()
    full = AF3Config()
    cfg = with_flash(dataclasses.replace(
        full, encoder=dataclasses.replace(full.encoder, num_layers=CLI_LAYERS[0]),
        lm=dataclasses.replace(full.lm, num_layers=CLI_LAYERS[1])), True)
    src = AudioFlamingo.from_random(cfg, tokenizer=tok, seed=3, compute_dtype=torch.bfloat16,
                                    device="cuda")
    path = os.path.join(tmp, "af3_cli")
    save_pretrained(path, src.model, src.cfg, tok, dtype="bf16")
    n_params = sum(p.numel() for p in src.model.parameters())
    del src
    torch.cuda.empty_cache()
    size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    log(f"18b checkpoint: full AF3 width, {CLI_LAYERS[0]} encoder + {CLI_LAYERS[1]} LM layers "
        f"(of 32 + 28), bf16, {n_params / 1e9:.3f} B params, {size / 1e9:.2f} GB written by "
        f"save_pretrained in {time.perf_counter() - t0:.1f}s")
    clip = os.path.join(tmp, "clip30.wav")
    write_wav(clip, 30, 16_000, seed=6, mono=True)

    model = load(path, device="cuda")
    wav = load_audio(clip)
    sampling = SamplingParams(greedy=True, temperature=0.7, top_k=50, top_p=0.95)
    fa.LAUNCHES.reset()
    want = model.generate(sound=wav, prompt=CLI_PROMPT, max_new_tokens=P18_TOKENS,
                          sampling=sampling)
    k2 = fa.LAUNCHES.count
    check(k2 == sum(CLI_LAYERS), f"18b in-process generate launched K2 {k2} times")
    out, infer_s = run_cli(["infer", "--model", path, "--audio", clip, "--max-new-tokens",
                            str(P18_TOKENS)])
    check(out == want + "\n", f"18b infer printed {ascii(out)}, load(DIR).generate answers "
                               f"{ascii(want)}")
    model.reset_chat()
    answers = [model.generate(sound=wav if i == 0 else None, prompt=turn, chat=True,
                              max_new_tokens=P18_TOKENS) for i, turn in enumerate(CHAT_TURNS)]
    stdin = f":audio {clip}\n" + "".join(f"{turn}\n" for turn in CHAT_TURNS)
    out, chat_s = run_cli(["chat", "--model", path, "--max-new-tokens", str(P18_TOKENS)], stdin)
    expect = "user> " + "".join(f"user> assistant> {a}\n" for a in answers) + "user> "
    check(out == expect, f"18b chat printed {ascii(out)}, generate(chat=True) twice gives "
                         f"{ascii(expect)}")
    check(all(answers) and want, "18b: an answer is empty")
    log(f"18b infer: subprocess {infer_s:.1f}s (start, load, build cached, generate), stdout "
        f"equal to load(DIR).generate ({len(want)} chars: {ascii(want[:40])}...); chat, two turns "
        f"on stdin (':audio' then two prompts): {chat_s:.1f}s, both answers equal to "
        f"generate(chat=True); K2 {k2} launches in the in-process generate")
    return dict(path=path, clip=clip, wav=wav, infer_s=infer_s, chat_s=chat_s, model=model)


def _post(port: int, route: str, payload: dict) -> tuple:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{route}",
                                 data=json.dumps(payload).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def demo_phase(model, fa, clip: str) -> dict:
    """18c. DemoServer over the full-depth bf16 7B on port 0, its captured decode steps
    released first, so that the first request captures the step on a handler thread: a
    WAV upload and a mic-PCM turn, each answer equal to generate(chat=True) on the same
    input (replayed in this thread after /api/reset), the page, /api/reset and a bad
    upload answering 400."""
    import base64
    import urllib.request

    from audio_flamingo_tpu_torch.audio.io import decode_audio
    from audio_flamingo_tpu_torch.runtime import generate as gen
    from audio_flamingo_tpu_torch.serve.demo import DemoServer

    gen.release_graphs()
    with open(clip, "rb") as f:
        wav_bytes = f.read()
    rng = np.random.default_rng(7)
    t = np.arange(12 * 16_000) / 16_000
    mic = (0.2 * np.sin(2 * np.pi * 523.0 * t) + 0.05 * rng.standard_normal(t.size)).astype(
        np.float32)
    turns = [{"prompt": "Describe.", "file_b64": base64.b64encode(wav_bytes).decode()},
             {"prompt": "What do you hear?", "pcm_b64": base64.b64encode(mic.tobytes()).decode()}]
    model.reset_chat()
    srv = DemoServer(model, port=0, max_new_tokens=P18_TOKENS)
    srv.start_background()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/", timeout=30) as r:
            check(r.status == 200 and "/api/chat" in r.read().decode(), "18c: the page")
        fa.LAUNCHES.reset()
        replies, times = [], []
        for turn in turns:
            t0 = time.perf_counter()
            code, body = _post(srv.port, "/api/chat", turn)
            times.append(time.perf_counter() - t0)
            check(code == 200, f"18c /api/chat answered {code}: {body}")
            replies.append(body["text"])
        k2 = fa.LAUNCHES.count
        check(len(model.history) == 4, f"18c: {len(model.history)} history entries, not 4")
        code, body = _post(srv.port, "/api/reset", {})
        check(code == 200 and body == {"ok": True} and model.history == [], "18c /api/reset")
        code, body = _post(srv.port, "/api/chat", {"prompt": "x", "file_b64":
                                                   base64.b64encode(b"RIFFnope").decode()})
        check(code == 400 and "audio decode failed" in body.get("error", ""),
              f"18c: a bad upload answered {code}: {body}")
        check(model.history == [], "18c: a refused upload changed the history")
    finally:
        srv.shutdown()
    decoded, _ = decode_audio(wav_bytes)
    want = [model.generate(decoded, turns[0]["prompt"], chat=True, max_new_tokens=P18_TOKENS),
            model.generate(mic, turns[1]["prompt"], chat=True, max_new_tokens=P18_TOKENS)]
    model.reset_chat()
    check(replies == want, f"18c: the demo answered {ascii(replies)}, generate(chat=True) "
                           f"{ascii(want)}")
    check(k2 == 120, f"18c: K2 launched {k2} times in two demo turns, not 2 x 60")
    log(f"18c demo: WAV upload {times[0]:.2f}s (its decode step captured on the handler "
        f"thread), mic-PCM turn {times[1]:.2f}s, both answers equal to generate(chat=True) on "
        f"the same input; /api/reset cleared the history, a bad upload answered 400; K2 "
        f"{k2} launches in the two turns")
    return dict(times=times, k2=k2)


def eval_examples(seconds: int = 30) -> list:
    from audio_flamingo_tpu_torch.eval.harness import EvalExample

    rng = np.random.default_rng(8)
    t = np.arange(seconds * 16_000) / 16_000
    return [EvalExample(audio=(0.3 * np.sin(2 * np.pi * (220.0 * (i + 1)) * t)
                               + 0.05 * rng.standard_normal(t.size)).astype(np.float32),
                        prompt=prompt, target=target, task=task)
            for i, (task, prompt, target) in enumerate(EVAL_TASKS)]


def eval_routes(model, fa, examples, tag: str) -> dict:
    """evaluate and evaluate_batched (4 slots of 2048, chunks of 16) on the examples: both
    finish, each route's scores equal _score of its answers; K2's launches of each."""
    from audio_flamingo_tpu_torch.eval import harness

    out = {}
    for name, fn, kw in (("evaluate", harness.evaluate, {}),
                         ("evaluate_batched", harness.evaluate_batched,
                          dict(num_slots=4, capacity=2048, chunk=16))):
        fa.LAUNCHES.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(model, examples, max_new_tokens=P18_TOKENS, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        answers = [e["answer"] for e in res.per_example]
        by_task: dict = {}
        for e in res.per_example:
            by_task.setdefault(e["task"], []).append((e["target"], e["answer"]))
        check(len(answers) == len(examples), f"{tag} {name}: {len(answers)} answers")
        check(res.task_scores == harness._score(by_task),
              f"{tag} {name}: scores {res.task_scores} are not _score of the answers")
        check(set(res.task_scores) == {"asr_wer", "mcq_acc", "qa_acc", "caption_cider_d"},
              f"{tag} {name}: scores {res.task_scores}")
        out[name] = dict(answers=answers, scores=res.task_scores, s=seconds,
                         k2=fa.LAUNCHES.count)
        # generate: a launch per encoder and per LM layer an example (one window each); the
        # slot engine's prefill runs the same two towers
        per = model.cfg.encoder.num_layers + model.cfg.lm.num_layers
        check(fa.LAUNCHES.count == per * len(examples) if name == "evaluate"
              else fa.LAUNCHES.count > 0, f"{tag} {name}: K2 launched {fa.LAUNCHES.count} times")
        log(f"{tag} {name}: {len(examples)} examples in {seconds:.2f}s, scores "
            f"{ {k: round(v, 4) for k, v in res.task_scores.items()} }, K2 "
            f"{fa.LAUNCHES.count} launches")
    fa.LAUNCHES.reset()
    return out


def eval_phase(model, fa, cli_path: str) -> dict:
    """18d. The eval harness on four 30 s examples (asr, mcq, qa, caption), 16 tokens:
    evaluate and evaluate_batched on the full-depth bf16 7B (both finish, scores from
    their answers; the answers that differ between the routes counted: bf16's slot
    engine and generate round differently), then on 18b's checkpoint loaded in f32 (2 + 2
    layers at full width), where both routes must give the same answers."""
    from audio_flamingo_tpu_torch.api import load
    from audio_flamingo_tpu_torch.runtime import generate as gen

    examples = eval_examples()
    bf16 = eval_routes(model, fa, examples, "18d bf16 7B")
    differ = sum(a != b for a, b in zip(bf16["evaluate"]["answers"],
                                        bf16["evaluate_batched"]["answers"]))
    log(f"18d bf16 7B: {differ} of {len(examples)} answers differ between evaluate and "
        "evaluate_batched")
    gen.release_graphs()
    f32 = load(cli_path, torch.float32, device="cuda")
    fp = eval_routes(f32, fa, examples, "18d f32 2 + 2 layers")
    check(fp["evaluate"]["answers"] == fp["evaluate_batched"]["answers"],
          f"18d f32: the routes answer {ascii(fp['evaluate']['answers'])} and "
          f"{ascii(fp['evaluate_batched']['answers'])}")
    check(fp["evaluate"]["scores"] == fp["evaluate_batched"]["scores"], "18d f32: scores differ")
    check(any(fp["evaluate"]["answers"]), "18d f32: every answer is empty")
    del f32
    gen.release_graphs()
    return dict(bf16=bf16, bf16_differ=differ, f32=fp)


class FirstOfEachShape(list):
    """A launch counter's ``inputs`` that keeps the first launch of each shape only (the
    15-minute path's 60 K2 launches would hold ~17 GB of inputs)."""

    def __init__(self):
        super().__init__()
        self.keys = set()

    def append(self, inputs) -> None:
        q, k = inputs[0], inputs[1]
        key = (tuple(q.shape), tuple(k.shape))
        if key not in self.keys:
            self.keys.add(key)
            super().append(inputs)


def music_phase(model, fa, lm) -> dict:
    """18e. 15 minutes of Music Flamingo (AF3Config.music_flamingo(): 30 windows) at full
    width: a 900 s 16 kHz mono WAV (no resample), load_audio, generate() with the K1
    frontend: K1 on 30 windows, the encoder on 30 windows, a ~22.6k-token prefill (past
    the last token bucket: unpadded), 16 greedy tokens, twice (ids identical); K1 at
    [30, 480000] on the clip's own windows, and the first encoder and prefill K2 launches
    of run 1 (the prefill through the row-blocked plain version), held to their plain
    versions and timed beside SDPA and the bounds; user TTFT and peak memory."""
    from audio_flamingo_tpu_torch.audio import io as aio
    from audio_flamingo_tpu_torch.audio.mel import WhisperMelFrontend
    from audio_flamingo_tpu_torch.config import MelConfig
    from audio_flamingo_tpu_torch.runtime.processor import AF3Processor

    check(model.cfg.max_windows == 30, "18e: the model is not Music Flamingo's config")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fifteen_minutes.wav")
        write_wav(path, MUSIC_SECONDS, 16_000, seed=9, mono=True)
        t0 = time.perf_counter()
        wav = aio.load_audio(path)
        load_s = time.perf_counter() - t0
    check(wav.shape == (MUSIC_SECONDS * 16_000,), f"18e load_audio gave {wav.shape}")
    fe = WhisperMelFrontend(MelConfig(num_mel_bins=model.cfg.encoder.num_mel_bins),
                            use_pallas=True)
    music = dataclasses.replace(model, processor=AF3Processor(
        tokenizer=model.processor.tokenizer, cfg=model.cfg, frontend=fe),
        history=[], last_output=None, last_processor_s=None)
    prompt = "Describe this song: its genre, instruments and structure."
    prompt_len = int(music.processor(messages=[{"role": "user", "content": f"<sound>{prompt}"}],
                                     audios=[wav])["ids"].shape[1])
    check(16384 < prompt_len <= 32768, f"18e prompt of {prompt_len} tokens")
    runs = []
    for i in range(2):
        for counter in (fa.LAUNCHES, lm.LAUNCHES):
            counter.reset()
            counter.timing = True
        if i == 0:
            fa.LAUNCHES.inputs, fa.LAUNCHES.capture = FirstOfEachShape(), True
        torch.cuda.reset_peak_memory_stats()
        _, e2e, split = timed_generate(music, sound=wav, prompt=prompt,
                                       max_new_tokens=P18_TOKENS)
        out = music.last_output
        run = dict(e2e=e2e, proc=music.last_processor_s, ttft=out.ttft_s,
                   ids=out.tokens[0, : int(out.lengths[0])].tolist(),
                   finite=bool(torch.isfinite(out.first_logits).all()),
                   k1=lm.LAUNCHES.count, k1_shapes=dict(lm.LAUNCHES.shapes),
                   k1_ms=lm.LAUNCHES.device_ms(), k2=fa.LAUNCHES.count,
                   k2_shapes=dict(fa.LAUNCHES.shapes), k2_ms=fa.LAUNCHES.device_ms(),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        captured = list(fa.LAUNCHES.inputs)
        fa.LAUNCHES.capture = False
        fa.LAUNCHES.inputs = []
        for counter in (fa.LAUNCHES, lm.LAUNCHES):
            counter.timing = False
            counter.reset()
        log(f"18e 15-minute generate #{i + 1}: ids={run['ids'][:8]}... {split}; K1 "
            f"{run['k1']} launches {run['k1_ms']:.3f} ms; K2 {run['k2']} launches "
            f"{run['k2_ms']:.1f} ms; peak GPU memory {run['peak_gib']:.2f} GiB")
        runs.append(run)
        if i == 0:
            k2_rows = music_k2_holds(fa, captured)
        del captured
    k1_want = {("log_mel", (30, 480_000)): 1, ("clamp", (30, 3000, 128)): 1}
    k2_want = {((30, 1500, 20, 64), (30, 1500, 20, 64), False): 32,
               ((1, prompt_len, 28, 128), (1, prompt_len, 4, 128), True): 28}
    for run in runs:
        check(run["k1_shapes"] == k1_want, f"18e K1 launches {run['k1_shapes']}")
        check(run["k2_shapes"] == k2_want, f"18e K2 launches {run['k2_shapes']}")
        check(run["finite"], "18e prefill logits not finite")
        check(len(run["ids"]) >= 1 and all(0 <= t < model.cfg.lm.vocab_size
                                           for t in run["ids"]), "18e ids out of vocab")
    check(runs[0]["ids"] == runs[1]["ids"], f"18e greedy ids differ: {runs[0]['ids']} vs "
                                            f"{runs[1]['ids']}")
    k1_row = music_k1_hold(lm, fe, wav)
    warm = runs[1]
    log(f"18e 15-minute warm run: {prompt_len}-token prompt (past the 16,384 bucket, unpadded),"
        f" end to end {warm['e2e']:.3f} s, user TTFT {warm['proc'] + warm['ttft']:.3f} s, of "
        f"which processor {warm['proc']:.3f} s (K1 {warm['k1_ms']:.3f} ms), K2 "
        f"{warm['k2_ms'] / 1e3:.3f} s, rest of the prefill {warm['ttft'] - warm['k2_ms'] / 1e3:.3f}"
        f" s; load_audio {load_s:.2f}s (host); peak GPU memory {warm['peak_gib']:.2f} GiB")
    return dict(warm=warm, prompt_len=prompt_len, k2=k2_rows, k1=k1_row, runs=runs)


def music_k2_holds(fa, captured: list) -> dict:
    """The first encoder and prefill K2 launches of a 15-minute generate, on their own
    inputs: held to the plain version (the prefill's over blocks of 1024 query rows), the
    kernel, the plain version and SDPA timed, the bound."""
    rows = {}
    check(len(captured) == 2, f"18e captured {len(captured)} K2 launch shapes, not 2")
    for q, k, v, kw in captured:
        name = "encoder_15min" if not kw["causal"] else "lm_prefill_15min"
        plain = plain_blocked(fa, 1024) if kw["causal"] else plain_blocked(fa, 500)
        r = compare(fa, q, k, v, kw, plain)
        check_compare(f"18e {name}", r)
        r["ms"] = time_ms(lambda: fa.flash_attention_lse(q, k, v, **kw), 3, 1)
        r["plain_ms"] = time_ms(lambda: plain(q, k, v, **kw), 2, 1)
        r["library_ms"] = time_ms(sdpa_call(q, k, v, kw), 3, 1)
        r["bound_ms"], r["bound_by"] = attention_bound_ms(tuple(q.shape), tuple(k.shape),
                                                          kw["causal"], kw["q_offset"],
                                                          r["dtype"])
        r["shape"] = (tuple(q.shape), tuple(k.shape))
        log(f"18e K2 {name} {r['dtype']} q{list(q.shape)} k{list(k.shape)}: max|o-plain|="
            f"{r['err']:.3e} (at {r['ratio']:.3f} of its limit) max|lse-plain|="
            f"{r['lse_err']:.3e}; ms={r['ms']:.3f} plain_ms={r['plain_ms']:.3f} library_ms="
            f"{r['library_ms']:.3f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) = "
            f"{r['bound_ms'] / r['ms'] * 100:.2f} % of the kernel's time")
        rows[name] = r
    return rows


def music_k1_hold(lm, fe, wav) -> dict:
    """K1 at [30, 480000] on the 15-minute clip's own windows, held to the plain version,
    twice bit-identical, timed (and as device time) beside the plain version and bound."""
    wins = torch.tensor(fe.pad_or_trim(wav, num_windows=30).reshape(30, -1), device="cuda")
    args = (wins, fe.dft_cos, fe.dft_sin, fe.mel_weights, fe.cfg.hop_length,
            fe.frames_per_window)
    call = lambda: lm.fused_log_mel(*args, bases=fe.kernel_bases)
    out, again = call(), call()
    ref = lm.log_mel_reference(*args)
    diff = (out - ref).abs()
    atol, rtol = MEL_TOL
    r = dict(err=diff.max().item(), ratio=(diff / (atol + rtol * ref.abs())).max().item())
    check(out.shape == (30, fe.frames_per_window, fe.cfg.num_mel_bins), "18e K1 output shape")
    check(torch.equal(out, again), "18e K1 at [30, 480000]: two launches differ")
    check(r["ratio"] <= 1.0, f"18e K1 at [30, 480000]: |x - plain| at {r['ratio']:.3f} of its "
                             "limit")
    r["ms"] = time_ms(call)
    r["dev_ms"] = graph_ms(call, 10, 2)
    r["plain_ms"] = time_ms(lambda: lm.log_mel_reference(*args), 5, 1)
    r["bound_ms"], r["bound_by"], r["bound_f32_ms"] = log_mel_bound_ms(30, fe)
    log(f"18e K1 log_mel [30,480000] on the clip: max|x-plain|={r['err']:.3e} (at "
        f"{r['ratio']:.3f} of its limit), replay bit-identical; ms={r['ms']:.4f} device "
        f"{r['dev_ms']:.4f} ms; plain_ms={r['plain_ms']:.4f}; bound_ms={r['bound_ms']:.4f} "
        f"(3xTF32, {r['bound_by']}) = {r['bound_ms'] / r['dev_ms'] * 100:.1f} % of the device "
        f"time; f32 CUDA-core bound {r['bound_f32_ms']:.4f} ms")
    return r


def entry_points_phase(fa, lm) -> dict:
    """Phase 18, after every earlier model is freed: 18a the native BPE, 18b the CLI, 18c
    the demo, 18d the eval harness, 18e 15 minutes of Music Flamingo."""
    from audio_flamingo_tpu_torch.api import AudioFlamingo
    from audio_flamingo_tpu_torch.config import AF3Config
    from audio_flamingo_tpu_torch.runtime import generate as gen
    from audio_flamingo_tpu_torch.runtime.processor import AF3Processor
    from audio_flamingo_tpu_torch.runtime.tokenizer import BBPETokenizer, train_bpe

    t0 = time.perf_counter()
    seconds = {}
    tok = synthetic_tokenizer(AF3Config().lm.vocab_size, seed=0)
    small = BBPETokenizer(*train_bpe(["describe the sound of music and speech"], 400))
    proc = AF3Processor(tokenizer=tok, cfg=AF3Config(), device="cpu")
    one_clip = proc.expand_audio_tokens(proc.apply_chat_template(
        [{"role": "user", "content": "<sound>What do you hear?"}]), [1])
    texts = ([random_text(10, 20_000), MIXED_TEXT * 40, one_clip, CLI_PROMPT, *CHAT_TURNS, "Describe.",
              "What do you hear?", "Describe this song: its genre, instruments and structure."]
             + [p for _, p, _ in EVAL_TASKS] + [MIXED_TEXT[i:i + 50] for i in range(0, 200, 7)])
    bpe = bpe_phase({"the 152,064-id tokenizer of 18b-18e": tok,
                     "from_random's trained tokenizer": small}, texts)
    seconds["18a"] = time.perf_counter() - t0

    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cli = cli_phase(fa, tok, tmp)
        del cli["model"]
        gen.release_graphs()
        torch.cuda.empty_cache()
        seconds["18b"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        model = AudioFlamingo.from_random(with_flash(AF3Config.music_flamingo(), True),
                                          tokenizer=tok, seed=0, compute_dtype=torch.bfloat16,
                                          device="cuda")
        log(f"18c-18e model: AF3Config.music_flamingo() at full width (32 + 28 layers), bf16, "
            f"made on the card in {time.perf_counter() - t1:.1f}s")
        demo = demo_phase(model, fa, cli["clip"])
        seconds["18c"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        ev = eval_phase(model, fa, cli["path"])
        seconds["18d"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    gen.release_graphs()
    gc.collect()
    torch.cuda.empty_cache()
    music = music_phase(model, fa, lm)
    del model
    gen.release_graphs()
    gc.collect()
    torch.cuda.empty_cache()
    seconds["18e"] = time.perf_counter() - t1
    total = time.perf_counter() - t0
    log(f"18: phase 18 took {total:.1f} s (" + ", ".join(f"{k} {v:.1f}" for k, v in
                                                          seconds.items()) + ")")
    return dict(bpe=bpe, cli=cli, demo=demo, eval=ev, music=music, seconds=seconds, s=total)


def serve_any(engine, specs, max_new_tokens: int) -> dict:
    """``serve`` on any device (the CPU's engines need no synchronization)."""
    from audio_flamingo_tpu_torch.runtime.engine import Request

    for rid, ids, mels in specs:
        engine.submit(Request(request_id=rid, ids=ids.copy(), mels=mels,
                              max_new_tokens=max_new_tokens))
    return engine.run_until_done()


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
    from audio_flamingo_tpu_torch.models import whisper_encoder as wenc
    from audio_flamingo_tpu_torch.ops.kernels import _build
    from audio_flamingo_tpu_torch.ops.kernels import enc_fused as ef
    from audio_flamingo_tpu_torch.ops.kernels import flash_attention as fa
    from audio_flamingo_tpu_torch.ops.kernels import flash_attention_a8 as fa8
    from audio_flamingo_tpu_torch.ops.kernels import log_mel as lm
    from audio_flamingo_tpu_torch.ops.kernels import paged_attention as pa
    from audio_flamingo_tpu_torch.ops.kernels import w4_suffix as k6
    from audio_flamingo_tpu_torch.ops.kernels import w4a16_matmul as k5
    from audio_flamingo_tpu_torch.ops.kernels import w8a16_matmul as k4

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
    if _build.build_seconds is None:
        log(f"build: {path} was already built; ptxas's report below is that build's")
    else:
        log(f"build: {path} in {_build.build_seconds:.1f}s (an nvcc process a source, at once)")
    ptxas = ptxas_report(_build.build_log)
    for r in ptxas:
        log(f"  ptxas: {r['kernel']}: {r['registers']} registers, {r['stack_bytes']} bytes of "
            f"stack, {r['spill_bytes']} bytes spilled, {r['smem_bytes']} bytes static shared "
            f"memory")
    flash_ptxas = [r for r in ptxas if r["kernel"].startswith("flash_")]
    check({"flash_fwd_mma_kernel<64>", "flash_fwd_mma_kernel<128>",
                        "flash_bwd_dkv_mma_kernel<128>", "flash_bwd_dq_mma_kernel<128>"}
          <= {r["kernel"] for r in flash_ptxas}, "the bf16 flash kernels were not compiled")
    w4_ptxas = [r for r in ptxas if r["kernel"].startswith(("w4_mma_", "w4_fma_", "w4_reduce"))]
    mlp_ptxas = [r for r in ptxas if r["kernel"].startswith("mlp_")]
    check({"w4_mma_kernel<1>", "w4_mma_kernel<2>", "w4_mma_kernel<4>", "w4_fma_kernel<1>",
           "w4_fma_kernel<8>", "w4_fma_kernel<32>", "mlp_tile_kernel<1>", "mlp_tile_kernel<2>"}
          <= {r["kernel"] for r in w4_ptxas + mlp_ptxas},
          "the w4a16 and enc_mlp kernels were not compiled")
    k8_ptxas = [r for r in ptxas if r["kernel"].startswith("fa8_")]
    k4_ptxas = [r for r in ptxas if r["kernel"].startswith(("w8_mma_", "w8_fma_"))]
    check({"fa8_kernel<64>", "fa8_kernel<128>", "fa8_ksum_kernel<128>", "fa8_kmax_kernel<64>",
           "fa8_codes_kernel<128>", "w8_mma_kernel<1>", "w8_mma_kernel<4>", "w8_fma_kernel<1>",
           "w8_fma_kernel<8>"} <= {r["kernel"] for r in k8_ptxas + k4_ptxas},
          "the redesigned K8 and K4 kernels were not compiled")
    k6_ptxas = [r for r in ptxas if r["kernel"].startswith("w4_suffix_kernel")]
    k1_ptxas = [r for r in ptxas if r["kernel"].startswith("log_mel_")]
    check({"w4_suffix_kernel<1>", "w4_suffix_kernel<2>", "w4_suffix_kernel<4>",
           "w4_suffix_kernel<8>", "log_mel_power_kernel", "log_mel_clamp_kernel"}
          <= {r["kernel"] for r in k6_ptxas + k1_ptxas},
          "the redesigned K6 (one persistent kernel) and K1 (3xTF32) kernels were not compiled")
    k3_ptxas = [r for r in ptxas if r["kernel"].startswith(("score_kernel", "attend_kernel"))]
    k9_ptxas = [r for r in ptxas if r["kernel"].startswith(("ln_qkv_kernel", "out_ln_kernel"))]
    check({f"{k}<{t},{hd}>" for k in ("score_kernel", "attend_kernel") for t in (1, 8)
           for hd in pa.KERNEL_HEAD_DIMS} | {"ln_qkv_kernel", "out_ln_kernel"}
          <= {r["kernel"] for r in k3_ptxas + k9_ptxas},
          "the redesigned K3 (decode and folded verify groups, hd 64 and 128) and K9 kernels "
          "were not compiled")
    # K3's kernels are named <head tiles, head dim>. The verify's eight head tiles at hd 128
    # (<8,128>) must not spill; the decode kernels (<1,128>) keep the report they had before
    # them (one CUDA-core pair's V pass: 20 bytes, PERF.md); the hd-64 kernels' spills are
    # logged (the AF1 path runs <1,64>)
    check(all(r["spill_bytes"] == 0 for r in k3_ptxas if r["kernel"].endswith("<8,128>")),
          f"a K3 verify kernel spills: {[r for r in k3_ptxas if r['spill_bytes']]}")
    log("K3 hd-64 kernels' spilled bytes (an entry per dtype pair): "
        + ", ".join(f"{r['kernel']} {r['spill_bytes']}" for r in k3_ptxas
                    if r["kernel"].endswith(",64>")))

    # seconds each phase took, logged at the end (PERF.md section 5)
    marks = [("build", T0)]

    def mark(name: str) -> None:
        marks.append((name, time.perf_counter()))

    # 3. kernels against their plain versions
    mark("3")
    res = kernel_phase(fa)
    fe = WhisperMelFrontend(MelConfig(num_mel_bins=128))
    mel_res = log_mel_phase(lm, fe)
    long_res = long_attention_phase(fa)

    mark("4")
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
            f"({out.decode_steps} steps of the captured step; capture {out.capture_s:.2f}s "
            f"outside ttft and decode) flash launches={launches}, their device time in the "
            f"path {kernel_ms:.3f} ms")
        runs.append((ids, out, launches, shapes, kernel_ms))
        if i == 1:
            bf16_ttft = model.last_processor_s + out.ttft_s     # the warm run's, for phase 10
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

    mark("5")
    # 5. a 10-minute file, in to answer out
    warm = ten_minute_phase(model, fa, lm)
    wav10 = warm.pop("wav")
    from audio_flamingo_tpu_torch.runtime import generate as gen

    held = gen.held_bytes()
    log(f"held captured decode steps after phases 4 and 5: {held['steps']} (the 30 s and the "
        f"10-minute buckets): caches {held['cache'] / 2**30:.3f} GiB, states "
        f"{held['state'] / 2**20:.2f} MiB, graph pools {held['graph'] / 2**20:.1f} MiB; "
        f"released: {gen.release_graphs() / 2**30:.3f} GiB")

    mark("7a-7b")
    # 7a, 7b. the int4 LM: kernels at the 7B shapes, then the 30 s path through K5 and K6
    w4 = int4_path_phase(model, fa, k5, k6, wav, runs[0][1].first_logits)

    mark("8a-8d")
    # 8a-8d. the paged serving engine: K3 alone, the mixed workload, prefix cache, int4
    from audio_flamingo_tpu_torch.models import qwen2 as qwen2_mod
    from audio_flamingo_tpu_torch.runtime import paged_engine as pe_mod

    paged_k = paged_kernel_phase(pa)
    with ChunkProbe(pe_mod, qwen2_mod, pa) as probe:
        paged = {name: paged_engine_phase(model, fa, pa, probe, wav, dt)
                 for name, dt in (("bf16", None), ("int8", torch.int8))}
        prefix_phase(model, probe)
        int4_engine_phase(model, fa, pa, k5, k6, probe)
    del model
    gen.release_graphs()
    gc.collect()
    torch.cuda.empty_cache()

    mark("6, 7c, 8e")
    # 6. f32 card against CPU
    f32_card_vs_cpu_phase(fa, lm)
    # 7c. f32 int4 card against CPU
    f32_int4_card_vs_cpu_phase(fa, k5, k6)
    # 8e. f32 paged engine card against CPU
    f32_engine_card_vs_cpu_phase(pa)
    mark("9")
    # 9a-9c. training: K7 alone, AF3 stage 2 through loop.run, f32 card against CPU
    k7_res = k7_phase(fa)
    stage2 = stage2_phase(fa)
    f32_train_card_vs_cpu_phase(fa)
    mark("10")
    # 10a-10e. the w8a8 TTFT path: K8 and K9 alone, the 30 s clip, the 10-minute file on
    # the fused layout, f32 card against CPU
    k8_res = k8_phase(fa8)
    k9_res = k9_phase(ef, wenc)
    w8 = a8_models(with_flash(AF3Config(), True))
    a8_clip = a8_clip_phase(w8, fa, fa8, wav, {"bf16": bf16_ttft,
                                               "int4": w4["warm"]["proc"] + w4["warm"]["ttft"]})
    a8_10min = a8_ten_minute_phase(w8, fa, fa8, ef, lm, wav10, warm)
    del w8, wav10
    gen.release_graphs()
    gc.collect()
    torch.cuda.empty_cache()
    a8_f32_card_vs_cpu_phase(fa8, ef)
    mark("11")
    # 11a-11e. the int8 LM's decode: K4 alone on the 7B int8 LM's codes, bench.py's decode
    # points (bf16 cache, the q8 cache, the int4 LM on the q8 cache), the 30 s clip on the
    # int8 LM, f32 card against CPU on the q8 cache
    from audio_flamingo_tpu_torch.ops.quant import random_quantized_lm

    lm7b = AF3Config().lm
    qlm8 = qwen2_mod.quantized_lm(random_quantized_lm(
        torch.Generator(device="cuda").manual_seed(0), lm7b, "cuda"), torch.bfloat16, "cuda")
    k4_res = k4_phase(k4, qlm8)
    int8_decode_phase(k4, k5, k6, qlm8, lm7b)
    del qlm8
    gc.collect()
    torch.cuda.empty_cache()
    int8_clip = int8_clip_phase(k4, wav)
    f32_q8_card_vs_cpu_phase(fa, k4)
    mark("12")
    # 12a-12d. beam search (the step captured), the beam lane on PagedEngine, BatchEngine on
    # the mixed workload, then f32 card against CPU at 2 + 2 layers (K4, K5, K6 at m = 4)
    gen.release_graphs()
    gc.collect()
    torch.cuda.empty_cache()
    model = AudioFlamingo.from_random(with_flash(AF3Config(), True), seed=0,
                                      compute_dtype=torch.bfloat16, device="cuda")
    beam12 = beam_graph_phase(model, fa, wav)
    lane12 = beam_lane_phase(model, beam12)
    slot12 = slot_engine_phase(model, fa, wav)
    del model, beam12["mels"]
    log(f"12: released the held captured steps ({gen.release_graphs() / 2**20:.1f} MiB)")
    gc.collect()
    torch.cuda.empty_cache()
    f32_12 = f32_beam_slot_phase(k4, k5, k6)
    gen.release_graphs()
    mark("13-14")
    # 13a-13d. speculative decoding: K3 at the verify's folded groups (8a's g = 7 re-timed
    # beside it), dense speculation on the 30 s clip at full width, the engines with an int8
    # target and draft, f32 card against CPU at 2 + 2 layers
    gc.collect()
    torch.cuda.empty_cache()
    verify13 = verify_kernel_phase(pa)
    for (qn, kv, gw), r in verify13.items():
        if gw == VERIFY_GROUPS[0]:
            log(f"13a K3 g = 7, q {qn} pool {kv}, 8a's mixed rows: {r['g7_graph_ms']:.4f} ms "
                f"device now, {paged_k[(qn, kv, 'mixed')]['graph_ms']:.4f} ms in 8a")
    model = AudioFlamingo.from_random(with_flash(AF3Config(), True), seed=0,
                                      compute_dtype=torch.bfloat16, device="cuda")
    dense13 = spec_dense_phase(model, fa, wav)
    # 14a, 14b. voice out: the trained vocoder on the card, then the voice path on 13b's
    # model (its answer streamed into the TTS session), before the model is freed
    t14 = time.perf_counter()
    voc14 = vocoder_phase()
    counters = {"K2": fa.LAUNCHES, "K7": fa.BWD_LAUNCHES, "K1": lm.LAUNCHES, "K3": pa.LAUNCHES,
                "K4": k4.LAUNCHES, "K5": k5.LAUNCHES, "K6A": k6.LAUNCHES_A,
                "K6B": k6.LAUNCHES_B, "K8": fa8.LAUNCHES, "K8 prelude": fa8.PRELUDE_LAUNCHES,
                "K9 ln_qkv": ef.LN_QKV_LAUNCHES, "K9 out_ln": ef.OUT_LN_LAUNCHES,
                "K9 mlp": ef.MLP_LAUNCHES}
    voice14 = voice_path_phase(model, fa, wav, counters)
    phase14_s = time.perf_counter() - t14
    del model
    log(f"13: released the held captured steps ({gen.release_graphs() / 2**20:.1f} MiB)")
    gc.collect()
    torch.cuda.empty_cache()
    engines13 = spec_engine_phase(pa, k4)
    gc.collect()
    torch.cuda.empty_cache()
    f32_spec_card_vs_cpu_phase()
    release_f32_base()
    gen.release_graphs()
    # 14c. voice: f32 card against CPU at small size
    f32_14 = f32_voice_card_vs_cpu_phase()
    phase14_s += f32_14["s"]
    log(f"14: phase 14 took {phase14_s:.1f} s (14a {voc14['s']:.1f}, 14b {voice14['s']:.1f}, "
        f"14c {f32_14['s']:.1f})")
    mark("15")
    # 15a-15d. AF2 at full width: the int8 3B on K4, the fused-w4 3B on K5 (no K6), f32
    # card against CPU (AF2 at 2 + 2 layers, AF1)
    gc.collect()
    torch.cuda.empty_cache()
    af2_15 = af2_int8_phase(k4, k5, k6)
    w4_15 = af2_w4_phase(af2_15.pop("af2"), k4, k5, k6)
    log(f"15: released the held captured steps ({gen.release_graphs() / 2**20:.1f} MiB)")
    gc.collect()
    torch.cuda.empty_cache()
    f32_15 = af2_f32_card_vs_cpu_phase()
    gen.release_graphs()
    log(f"15: phase 15 took {af2_15['s'] + w4_15['s'] + f32_15['s']:.1f} s (15a "
        f"{af2_15['s']:.1f}, 15b {w4_15['s']:.1f}, 15c + 15d {f32_15['s']:.1f})")
    mark("16")
    # 16a-16e. the AF1/AF2 serving engines, the AF2 beam and K3 at OPT's head dim 64, after
    # every earlier model is freed
    gc.collect()
    torch.cuda.empty_cache()
    t16 = time.perf_counter()
    hd64_16 = k3_hd64_phase(pa)
    s16a = time.perf_counter() - t16
    eng16 = xattn_engines_phase(pa, k4)
    log(f"16: released the held captured steps ({gen.release_graphs() / 2**20:.1f} MiB)")
    gc.collect()
    torch.cuda.empty_cache()
    af1_16 = af1_engine_phase(pa)
    gc.collect()
    torch.cuda.empty_cache()
    f32_16 = xattn_f32_card_vs_cpu_phase()
    gen.release_graphs()
    log(f"16: phase 16 took {time.perf_counter() - t16:.1f} s (16a {s16a:.1f}, 16b + 16d "
        f"{eng16['s']:.1f}, 16c {af1_16['s']:.1f}, 16e {f32_16['s']:.1f})")
    mark("17")
    # 17a-17c. LoRA / QLoRA and GRPO training at full width, after every earlier model is
    # freed: QLoRA-7B, GRPO-1.5B on PagedEngine, f32 card against CPU
    gc.collect()
    torch.cuda.empty_cache()
    t17 = time.perf_counter()
    qlora17 = qlora_phase(fa, k4)
    grpo17 = grpo_phase(fa, pa)
    f32_17 = f32_train17_card_vs_cpu_phase(fa)
    gen.release_graphs()
    log(f"17: phase 17 took {time.perf_counter() - t17:.1f} s (17a {qlora17['s']:.1f}, 17b "
        f"{grpo17['s']:.1f}, 17c {f32_17['s']:.1f})")
    mark("18")
    # 18a-18e. the user entry points (the native BPE, the CLI in subprocesses, the demo
    # server, the eval harness) and 15 minutes of Music Flamingo, after every earlier model
    # is freed
    gc.collect()
    torch.cuda.empty_cache()
    p18 = entry_points_phase(fa, lm)

    mark("end")
    log("phase seconds: " + ", ".join(f"{a} {t1 - t0:.1f}" for (a, t0), (_, t1)
                                      in zip(marks, marks[1:])))
    for (name, dn), r in long_res.items():
        log(f"K2 {name} {dn}: {r['ms']:.3f} ms, bound {r['bound_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.3f} ms, SDPA {r['library_ms']:.3f} ms")
    per_gen = {"encoder_10min": 32, "lm_prefill_16k": 28}   # K2 launches per 10-minute generate
    log("K2 per 10-minute generate (bf16), summed from the per-shape rows above over its "
        + " + ".join(f"{n} x {k}" for k, n in per_gen.items()) + ": bound "
        f"{sum(n * long_res[(k, 'bfloat16')]['bound_ms'] for k, n in per_gen.items()):.3f} ms, "
        f"SDPA {sum(n * long_res[(k, 'bfloat16')]['library_ms'] for k, n in per_gen.items()):.3f} "
        f"ms, plain {sum(n * long_res[(k, 'bfloat16')]['plain_ms'] for k, n in per_gen.items()):.1f} "
        f"ms; in the path {warm['k2_ms']:.1f} ms")
    m18 = p18["music"]
    log("K2 per 15-minute generate (bf16), summed from 18e's rows over its 32 x "
        "encoder_15min + 28 x lm_prefill_15min: " + ", ".join(
            f"{key} {32 * m18['k2']['encoder_15min'][key] + 28 * m18['k2']['lm_prefill_15min'][key]:.3f} ms"
            for key in ("ms", "bound_ms", "library_ms", "plain_ms"))
        + f"; in the path {m18['warm']['k2_ms']:.1f} ms")
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "path_route": FLASH_ROUTES["bfloat16"],
        "routes": FLASH_ROUTES,
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
        "launches_phase12": {"12a beam, two api.generate(num_beams=4)": beam12["k2"],
                             "12c BatchEngine, mixed workload": slot12["res"]["slot"]["k2"]},
        "launches_phase13": {"13b speculative api.generate, encoder and both prefills":
                             dense13["k2"]},
        "launches_phase14": {"14b voice path, generate(stream=True) into speak_stream (a run)":
                             voice14["k2"]},
        "path_phase12": {"12a beam generate (the second)": beam12["k2_path"],
                         "12c BatchEngine, mixed workload": slot12["res"]["slot"]["k2_path"]},
        "launches_phase17": {"17a QLoRA-7B train step": qlora17["rows"]["K2"]["count"],
                             "17b GRPO-1.5B update": grpo17["rows"]["K2"]["count"]},
        "path_phase17": {"17a QLoRA-7B train step": qlora17["rows"]["K2"],
                         "17b GRPO-1.5B update": grpo17["rows"]["K2"]},
        "launches_phase18": {
            "18c demo, two turns": p18["demo"]["k2"],
            **{f"18d {route}, bf16 7B, 4 examples": r["k2"]
               for route, r in p18["eval"]["bf16"].items()},
            "18e 15-minute generate (the warm run)": m18["warm"]["k2"]},
        "shapes_18e": {name: {n: (list(map(list, r[n])) if n == "shape" else r[n])
                              for n in ("shape", "err", "ratio", "ms", "plain_ms",
                                        "library_ms", "bound_ms", "bound_by")}
                       for name, r in m18["k2"].items()},
        "ptxas": [r for r in flash_ptxas if r["kernel"].startswith("flash_fwd")],
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
        "bound_route": "3xTF32 tensor cores",
        "bound_f32_cuda_cores_ms": mel_res[(20, "normal")]["bound_f32_ms"],
        "device_ms": mel_res[(20, "normal")]["dev_ms"],
        "library_ms": None,
        "launches_phase18": {"18e 15-minute generate (the warm run)": m18["warm"]["k1"]},
        "shape_18e": {n: m18["k1"][n] for n in ("err", "ratio", "ms", "dev_ms", "plain_ms",
                                                "bound_ms", "bound_by", "bound_f32_ms")},
        "ptxas": k1_ptxas,
    }]
    iw = w4["warm"]
    k5_path = w4["k5"]
    kernels.append({
        "name": "w4a16_matmul",
        "route": "cuda",
        "source": "audio_flamingo_tpu_torch/csrc/w4a16_matmul.cu",
        "replaces": "audio_flamingo_tpu/ops/pallas/quant4_matmul.py:98",
        "launches": iw["K5"][0],
        "max_abs_err": max([r["err"] for key, r in w4["kernels"].items() if key[0] == "k5"]
                           + [k5_path["err"]]),
        "ms": iw["K5"][2],
        "plain_ms": k5_path["plain_ms"],
        "bound_ms": k5_path["bound_ms"],
        "bound_by": k5_path["bound_by"],
        "library_ms": k5_path["library_ms"],
        "launches_phase12": {f"12d int4 BatchEngine at 4 rows, {dn}": r["counts"]["K5"]
                             for dn, r in f32_12["w4"].items()},
        "max_abs_err_m4": max(r["worst"]["K5"][0] for r in f32_12["w4"].values()),
        "m4_bf16": {k: (v if k != "bound" else list(v))
                    for k, v in f32_12["w4"]["bfloat16"]["timing"]["K5"].items()},
        "launches_phase15": {"15b AF2 fused-w4 3B, api.generate 30 s clip (32 tokens)":
                             w4_15["k5_launches"]},
        "max_abs_err_15b": w4_15["worst"][0],
        "af2_3b_15b": shape_rows(w4_15["timing"], "K5"),
        "ptxas": w4_ptxas,
    })
    for name, key, line in (("w4_suffix_a", "K6A", 225), ("w4_suffix_b", "K6B", 288)):
        k6_path = w4["k6"][key]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "audio_flamingo_tpu_torch/csrc/w4_suffix.cu",
            "replaces": f"audio_flamingo_tpu/ops/pallas/quant4_block.py:{line}",
            "launches": iw[key][0],
            "max_abs_err": max([w4["kernels"][("k6" + key[-1], m, dn)]["err"]
                                for m in (1, 8) for dn in ("float32", "bfloat16")]
                               + [k6_path["err"]]),
            "ms": iw[key][2],
            "plain_ms": k6_path["plain_ms"],
            "bound_ms": k6_path["bound_ms"],
            "bound_by": k6_path["bound_by"],
            "library_ms": None,
            "kernels_per_call": max(w4["kernels"][("k6calls", m, dn)][key == "K6B"]
                                    for m in (1, 3, 8) for dn in ("float32", "bfloat16")),
            "launches_phase12": {f"12d int4 BatchEngine at 4 rows, {dn}": r["counts"][key]
                                 for dn, r in f32_12["w4"].items()},
            "max_abs_err_m4": max(r["worst"][key][0] for r in f32_12["w4"].values()),
            "m4_bf16": {k: (v if k != "bound" else list(v))
                        for k, v in f32_12["w4"]["bfloat16"]["timing"][key].items()},
            "ptxas": k6_ptxas,
        })
    full = paged["bf16"]["full"]
    kernels.append({
        "name": "paged_attention",
        "route": "cuda",
        "source": "audio_flamingo_tpu_torch/csrc/paged_attention.cu",
        "replaces": "audio_flamingo_tpu/ops/pallas/paged_attention.py:116",
        "launches": full["launches"],
        "max_abs_err": max([r["err"] for r in paged_k.values()]
                           + [p["replay"]["err"] for p in paged.values()]),
        "ms": full["ms"],
        "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"],
        "bound_by": full["bound_by"],
        "library_ms": None,
        "path_graph_ms": full["graph_ms"],
        "launches_phase13": {f"13c PagedEngine a = 1.0, {p} pool, verify at g' = 35":
                             r["counts"]["k3"] for p, r in engines13["paged"].items()},
        "max_abs_err_verify": {str(g): max(r["err"] for key, r in verify13.items()
                                           if key[2] == g) for g in VERIFY_GROUPS},
        "verify_13a": {f"g'={key[2]} q {key[0]} pool {key[1]}": {
            n: r[n] for n in ("ms", "graph_ms", "five_g7_ms", "g7_graph_ms", "plain_ms",
                              "bound_ms", "bound_by", "with_scratch_ms")}
            for key, r in verify13.items()},
        "verify_13c_chunk": {p: {n: r[n] for n in ("chunk_launches", "path_ms", "graph_ms",
                                                   "plain_ms", "bound_ms", "bound_by", "err")}
                             for p, r in engines13["paged"].items()},
        "launches_phase16": {n: r["run"]["k3"] for n, r in eng16["res"].items()
                             if "Paged" in n},
        "max_abs_err_16b": max(r["again"]["hold"]["err"] for n, r in eng16["res"].items()
                               if "Paged" in n),
        "af2_16b_chunk": {k: eng16["res"]["16b AF2 PagedFlamingoEngine bf16 pool"]["again"]
                          ["graph"][k] for k in ("launches", "graph_ms", "plain_ms", "bound_ms",
                                                 "bound_by")},
        "launches_phase17": {"17b GRPO-1.5B rollout on PagedEngine, g = 6":
                             grpo17["k3"]["rollout_launches"]},
        "rollout_chunk_17b": grpo17["k3"],
        "ptxas": [r for r in k3_ptxas if r["kernel"].endswith(",128>")],
    })
    af1 = af1_16["res"]["16c AF1 PagedFlamingoEngine bf16 pool"]
    g64 = af1["again"]["graph"]
    kernels.append({
        "name": "paged_attention_hd64",
        "route": "cuda",
        "source": "audio_flamingo_tpu_torch/csrc/paged_attention.cu",
        "replaces": "audio_flamingo_tpu/ops/pallas/paged_attention.py:116",
        "launches": af1["run"]["k3"],
        "max_abs_err": max([r["err"] for r in hd64_16.values()]
                           + [r["again"]["hold"]["err"] for r in af1_16["res"].values()]),
        "ms": g64["graph_ms"],
        "plain_ms": g64["plain_ms"],
        "bound_ms": g64["bound_ms"],
        "bound_by": g64["bound_by"],
        "library_ms": None,
        "timed_launches": g64["launches"],
        "launches_phase16": {n: r["run"]["k3"] for n, r in af1_16["res"].items()},
        "shapes_16a": {f"[4,32,{k[2]},64] q {k[0]} pool {k[1]}": {
            n: r[n] for n in ("err", "ratio", "ms", "graph_ms", "plain_ms", "bound_ms",
                              "bound_by")} for k, r in hd64_16.items()},
        "ptxas": [r for r in k3_ptxas if r["kernel"].endswith(",64>")],
    })
    rep7, run7 = stage2["replay"], stage2["run"]
    kernels.append({
        "name": "flash_attention_bwd",
        "route": "cuda",
        "path_route": FLASH_ROUTES["bfloat16"],
        "routes": FLASH_ROUTES,
        "source": "audio_flamingo_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "audio_flamingo_tpu/ops/pallas/flash_attention.py:431",
        "launches": run7["k7"] // stage2["steps"],
        "max_abs_err": max([r["err"] for r in k7_res.values()] + [rep7["err"]]),
        "ms": run7["k7_ms"] / stage2["steps"],
        "plain_ms": rep7["plain_ms"],
        "bound_ms": rep7["bound_ms"],
        "bound_by": rep7["bound_by"],
        "library_ms": rep7["library_ms"],
        "launches_phase17": {"17a QLoRA-7B train step": qlora17["rows"]["K7"]["count"],
                             "17b GRPO-1.5B update": grpo17["rows"]["K7"]["count"]},
        "path_phase17": {"17a QLoRA-7B train step": qlora17["rows"]["K7"],
                         "17b GRPO-1.5B update": grpo17["rows"]["K7"]},
        "ptxas": [r for r in flash_ptxas if r["kernel"].startswith("flash_bwd")],
    })
    rep8, clip8 = a8_clip["replay"], a8_clip["warm"]
    kernels.append({
        "name": "flash_attention_a8",
        "route": "cuda",
        "source": "audio_flamingo_tpu_torch/csrc/flash_attention_a8.cu",
        "replaces": "audio_flamingo_tpu/ops/pallas/flash_attention_a8.py:133",
        "launches": clip8["k8"],
        "max_abs_err": max([r["err"] for r in k8_res.values()] + [rep8["err"]]),
        "ms": clip8["k8_ms"],
        "plain_ms": rep8["plain_ms"],
        "bound_ms": rep8["bound_ms"],
        "bound_by": rep8["bound_by"],
        "library_ms": None,
        "ptxas": [r for r in k8_ptxas if r["kernel"].startswith("fa8_kernel")],
    })
    pre8 = a8_clip["prelude"]
    kernels.append({
        "name": "flash_attention_a8_prelude",
        "route": "cuda",
        "source": "audio_flamingo_tpu_torch/csrc/flash_attention_a8.cu",
        "replaces": "audio_flamingo_tpu/ops/pallas/flash_attention_a8.py:133",
        "launches": clip8["pre"],
        "max_abs_err": max([r["prelude"]["err"] for r in k8_res.values()] + [pre8["err"]]),
        "ms": clip8["pre_ms"],
        "plain_ms": pre8["plain_ms"],
        "bound_ms": pre8["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "ptxas": [r for r in k8_ptxas if not r["kernel"].startswith("fa8_kernel")],
    })
    warm10 = a8_10min["warm"]
    for name, key, kind, n, line in (("enc_ln_qkv", "K9 ln_qkv", "ln_qkv", 3840, 103),
                                     ("enc_out_ln", "K9 out_ln", "out_ln", 1280, 151),
                                     ("enc_mlp", "K9 mlp", "mlp", 5120, 218)):
        launches = warm10[key][0]
        per = k9_res[(name, 30_000, "bfloat16")]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "audio_flamingo_tpu_torch/csrc/enc_fused.cu",
            "replaces": f"audio_flamingo_tpu/ops/pallas/enc_fused.py:{line}",
            "launches": launches,
            "max_abs_err": max(r["err"] for (k, _, _), r in k9_res.items() if k == name),
            "ms": warm10[key][2],
            "plain_ms": launches * per["plain_ms"],
            "bound_ms": launches * k9_bound_ms(kind, 30_000, 1280, n, 2)[0],
            "bound_by": per["bound_by"],
            "library_ms": None,
            "ptxas": (mlp_ptxas if name == "enc_mlp" else
                      [r for r in k9_ptxas if r["kernel"].startswith(name[4:])]),
        })
    k4_path = int8_clip["path"]
    kernels.append({
        "name": "w8a16_matmul",
        "route": "cuda",
        "source": "audio_flamingo_tpu_torch/csrc/w8a16_matmul.cu",
        "replaces": "audio_flamingo_tpu/ops/pallas/quant_matmul.py:44",
        "launches": int8_clip["warm"]["k4"],
        "max_abs_err": max([r["err"] for r in k4_res["cases"].values()] + [k4_path["err"],
                            engines13["k4_round"]["err"]]),
        "ms": int8_clip["warm"]["k4_ms"],
        "plain_ms": k4_path["plain_ms"],
        "bound_ms": k4_path["bound_ms"],
        "bound_by": k4_path["bound_by"],
        "library_ms": k4_path["library_ms"],
        "launches_phase12": {"12d int8 beam at K = 4, f32 (warm-up step and replays)":
                             f32_12["k4_beam_launches"],
                             **{f"12d int4 BatchEngine at 4 rows (the int8 head), {dn}":
                                r["counts"]["K4"] for dn, r in f32_12["w4"].items()}},
        "max_abs_err_m4": max(r["worst"][0] for r in f32_12["k4"].values()),
        "max_abs_err_13c": {n: engines13["k4_round"][n] for n in ("launches", "rows", "err",
                                                                 "ratio")},
        "round_13c": {
            **{f"[{k[3]},{k[0]}]x[{k[0]},{'|'.join(map(str, k[1]))}]->{k[2]}":
               {n: r[n] for n in ("count", "ms", "graph_ms", "plain_ms", "library_ms",
                                  "bound_ms", "bound_by")}
               for k, r in engines13["k4_round"]["timing"].items()},
            **{n: engines13["k4_round"]["round_" + n]
               for n in ("graph_ms", "plain_ms", "library_ms", "bound_ms")}},
        "launches_phase13": {**{f"13c BatchEngine {n}": r["k4"]
                                for n, r in engines13["slot"].items()},
                             **{f"13c PagedEngine a = 1.0, {p} pool": r["counts"]["k4"]
                                for p, r in engines13["paged"].items()}},
        "m4_bf16": {f"[4,{k[0]}]x[{k[0]},{'|'.join(map(str, k[1]))}]->{k[2]}":
                    {n: r[n] for n in ("ms", "graph_ms", "plain_ms", "library_ms", "bound_ms",
                                       "bound_by")}
                    for k, r in f32_12["k4"]["bfloat16"]["timing"].items()},
        "launches_phase15": {"15a AF2 int8 3B, api.generate 30 s clip (32 tokens, the step "
                             "replayed)": af2_15["k4_launches"],
                             "15b AF2 fused-w4 3B (the int8 head)": w4_15["k4_launches"]},
        "max_abs_err_15a": af2_15["worst"][0],
        "af2_3b_15a": shape_rows(af2_15["timing"], "K4"),
        "launches_phase16": {n: r["run"]["k4"] for n, r in eng16["res"].items()},
        "launches_phase17": {"17a adapted int8 7B decode step (LoRA deltas beside)":
                             qlora17["k4"]["count"]},
        "adapted_step_17a": qlora17["k4"],
        "ptxas": k4_ptxas,
    })
    for name, p in paged.items():
        r, f = p["run"], p["full"]
        third = ("" if f is None else
                 f"; over the third run's {f['launches']} launches K3 "
                 f"{f['ms'] / f['steps']:.3f} ms per step against a bound of "
                 f"{f['bound_ms'] / f['steps']:.5f} ms and a plain "
                 f"{f['plain_ms'] / f['steps']:.3f} ms")
        log(f"paged engine, {name} pool: {p['tps']:.1f} tok/s, TTFT median "
            f"{statistics.median(r['ttft']):.3f} s max {r['ttft'][-1]:.3f} s, K3 "
            f"{r['k3_ms'] / r['steps']:.3f} ms per decode step{third}; pool "
            f"{p['pool_bytes'] / 1e6:.1f} MB, peak {r['peak']:.2f} GiB")
    slot, paged_s = slot12["res"]["slot"], slot12["res"]["paged"]
    log(f"12: the beam step (bf16 7B, K {BEAM_K}) {beam12['graph_ms']:.3f} ms in the graph, "
        f"{beam12['eager_ms']:.3f} ms eager, bound {beam12['bound_ms']:.3f} ms; the lane beside "
        f"2 paged requests {lane12['wall_lane']:.3f} s ({lane12['wall_plain']:.3f} s without); "
        f"mixed workload BatchEngine {slot['tps']:.1f} tok/s, PagedEngine {paged_s['tps']:.1f} "
        f"tok/s, {slot12['same']} of 6 requests with the same ids")
    log("kernel line: flash_attention_fwd per warm 30 s generate: ms = the 60 launches' device "
        "time inside generate #2 (CUDA events around each launch); plain_ms, library_ms = the "
        "plain version and SDPA timed on each launch's captured inputs, summed; bound_ms = "
        "summed per-launch bounds. log_mel per warm 10-minute generate: ms = its 2 launches' "
        "device time inside it; plain_ms and bound_ms at [20, 480000]; library_ms null: no "
        "single PyTorch call computes this function. w4a16_matmul, w4_suffix_a, w4_suffix_b "
        "per warm int4 30 s generate (32 tokens): launches = the count of that run (the "
        "replays of the captured decode step count the launches captured in it); ms = their "
        "device time inside it (the decode steps times one replay's kernel time by "
        "torch.profiler, 7b); bound_ms = summed per-launch bounds; w4a16_matmul plain_ms and "
        "library_ms (torch._weight_int4pack_mm on the same codes) timed on the captured "
        "inputs of the eager step's launches (the step the graph replays), summed; the "
        "suffixes' plain_ms = the plain version timed on those launches' inputs (median of "
        "3), summed; their library_ms null: no single PyTorch "
        "call computes a fused suffix. paged_attention: over every K3 launch of the third "
        "bf16-pool mixed-workload run: launches = their count, ms = their device time in the "
        "path, plain_ms = the plain version timed on each launch's captured inputs, summed, "
        "bound_ms = summed per-launch bounds (keys below each row's length); path_graph_ms = "
        "the same launches replayed in one CUDA graph (their device time without the host's "
        "gaps); max_abs_err = the largest |o/l - plain| of phase 8a and the "
        "replays; library_ms null: " + PAGED_NO_LIBRARY + " flash_attention_fwd and _bwd: "
        "path_route = the route of the path's bf16 launches (routes: by dtype), "
        "ptxas = nvcc's report for each of the source's kernels. flash_attention_bwd per AF3 "
        "stage-2 train step (batch 4, bucket 1024): launches = the first run's K7 count over "
        "its steps; ms = their device time in the path per step; plain_ms, library_ms (SDPA's "
        "backward on a retained graph) and bound_ms summed over the 60 launches of one more "
        "step, each replayed on its captured inputs; max_abs_err = the largest |d - plain| "
        "of phase 9a and those replays. flash_attention_a8 (K8) per warm a8 30 s generate "
        "(10c): launches and ms = its 60 launches' count and device time inside it; plain_ms "
        "and bound_ms = the plain version timed on each launch's captured prelude outputs, "
        "and the per-launch bounds (int8 QK^T at 1979 TOPS + bf16 P.V at 989 TFLOP/s, or "
        "bytes), summed; max_abs_err = the largest |o - plain| of 10a and those replays; "
        "library_ms null: " + K8_NO_LIBRARY + ". flash_attention_a8_prelude (K8's CUDA "
        "prelude, three kernels a call) per warm a8 30 s generate (10c): launches and ms = "
        "its 60 calls' count and device time inside it; plain_ms = the torch prelude timed "
        "on each call's captured inputs, summed; bound_ms = the per-call byte bounds (q, k "
        "read once, codes and rowc written once), summed; max_abs_err = the largest "
        "|k code - torch's| or |rowc - torch's| of 10a and those replays; library_ms null: "
        "no single PyTorch call computes the prelude. enc_ln_qkv, enc_out_ln, enc_mlp (K9) per "
        "warm a8 10-minute generate on the fused layout (10d): launches and ms = each "
        "kernel's 32 launches' count and device time inside it; plain_ms and bound_ms = 32 x "
        "the plain version's time and the bound (int8 ops at 1979 TOPS, or bytes) at the "
        "path's shape [30000, 1280] bf16 (10b); max_abs_err = the largest |y - plain| of 10b "
        "(x2 for enc_out_ln); library_ms null: no single PyTorch call computes a fused "
        "stage (10b times each against its composed torch form). w8a16_matmul (K4) per warm "
        "int8-LM 30 s generate (11d, 32 tokens): launches and ms = its launches' count and "
        "device time inside it (the prefill's by CUDA events, the decode steps' as the steps "
        "times one replay's K4 time by torch.profiler); plain_ms, library_ms (torch._weight_int8pack_mm on the same "
        "codes, laid out [N, K]) and bound_ms = each launch shape's plain time, library time "
        "(one captured launch each; a grouped launch: its products' summed) and bound, times "
        "that shape's launches, summed; max_abs_err = the largest |y - plain| of 11a and of "
        "the prefill's and one decode step's launches, replayed. ptxas (w4a16_matmul, "
        "enc_mlp, paged_attention, enc_ln_qkv, enc_out_ln): nvcc's report for the kernels of "
        "the redesigned routes; their device times per shape are 7a's, 8a's and 10b's log "
        "lines. ptxas (flash_attention_a8, its prelude, w8a16_matmul): the same "
        "for K8's body, the prelude's three kernels and K4's layout-0 kernels; 10a and 11a "
        "log their times per shape. launches_phase12 (flash_attention_fwd, "
        "w4a16_matmul, w4_suffix_a/b, w8a16_matmul): each kernel's launches on phase 12's "
        "paths, each counted from 0 just before the path and read just after (K2: two "
        "api.generate(num_beams=4) calls and the BatchEngine run of 12c; K5, K6, K4: the int4 "
        "LM on BatchEngine at 4 rows, 12d, and the int8 LM's beam at K = 4 in f32, 12d, its "
        "warm-up step's launches and the replays'); max_abs_err_m4: the largest |y - plain| "
        "of those launches at m = 4, re-run on their captured inputs; m4_bf16: the bf16 "
        "2 + 2-layer model's (7B layer shapes) launches at m = 4 timed with the wrapper (ms), "
        "as device time (graph_ms / device_ms), the plain version and the bound. "
        "launches_phase13 (flash_attention_fwd, paged_attention, w8a16_matmul): each "
        "kernel's launches on phase 13's paths, counted from 0 just before each path and read "
        "just after (K2: one speculative api.generate's encoder and two prefills, 13b; K3: every verify "
        "launch of the PagedEngine runs at a = 1.0, 13c; K4: the int8 target's and draft's "
        "launches of each 13c run); w8a16_matmul max_abs_err_13c: one 13c BatchEngine "
        "round's K4 launches (the 0.5B draft's at m = 8, the 7B verify's at m = 40) re-run "
        "against the plain version; paged_attention max_abs_err_verify: the largest "
        "|o/l - plain| of 13a at g' = 35 and 64; verify_13a: 13a's times at 8a's mixed rows "
        "(ms with the wrapper, graph_ms device time of one call, five_g7_ms five g = 7 calls' "
        "device time, bound_ms, with_scratch_ms the bound with the scores scratch written and "
        "read); verify_13c_chunk: one 13c chunk's 168 verify launches, path_ms in the path "
        "(CUDA events), graph_ms replayed in one graph, plain_ms and bound_ms summed. "
        "w8a16_matmul round_13c: that round's K4 launches by shape ([m,K]x[K,N]->out), count "
        "= its launches, one launch of each timed alone (ms with the wrapper, graph_ms device "
        "time of one call in a CUDA graph, its own launch included), plain_ms, library_ms "
        "(torch._weight_int8pack_mm; a grouped launch: its products' calls summed), bound_ms; "
        "the round's sums weight each shape by its count. launches_phase14 "
        "(flash_attention_fwd): K2's launches in one 14b run, counted from 0 just before it "
        "and read just after (the encoder's 32 and the prefill's 28; no other kernel ran). "
        "launches_phase15 (w8a16_matmul, w4a16_matmul): each kernel's launches in one warm "
        "AudioFlamingo2.generate of phase 15 (AF2Config(), the 30 s clip, 32 greedy tokens), "
        "counted from 0 just before it and read just after (a run that replays the captured "
        "step; the capture's warm-up step counts its own); af2_3b_15a / af2_3b_15b: one eager "
        "decode step's K4 (int8 3B) and K5 (fused-w4 3B) launches by shape, each re-run "
        "against the plain version (err, ratio; max_abs_err_15a / _15b the largest) and one "
        "launch of each shape timed alone: ms with the wrapper, graph_ms device time of one "
        "call in a CUDA graph, plain_ms, library_ms (torch._weight_int8pack_mm / "
        "torch._weight_int4pack_mm on the same codes; a grouped K4 launch: its products' "
        "calls summed), bound_ms, count = the launches of that shape in the step. "
        "launches_phase16 (paged_attention, paged_attention_hd64, w8a16_matmul): each kernel's "
        "launches inside the decode chunks of phase 16's measured runs (16b AF2 on "
        "FlamingoEngine and PagedFlamingoEngine, 16c AF1 on PagedFlamingoEngine), counted from "
        "0 at each run's start; paged_attention max_abs_err_16b and af2_16b_chunk: every K3 "
        "launch of 16b's second paged runs held to the plain version, and their first "
        "chunk's launches replayed in one CUDA graph (graph_ms), the plain version timed on "
        "each (plain_ms) and their bounds, summed. paged_attention_hd64 (K3 at OPT's head dim "
        "64, g 1, AF1's paged engine on a bf16 pool, 16c): launches = the measured run's "
        "count; ms, plain_ms, bound_ms = the second run's first chunk's timed_launches "
        "replayed in one CUDA graph (device time), the plain version timed on each, their "
        "bounds, summed; max_abs_err = the largest |o/l - plain| of 16a and of every launch "
        "of 16c's second runs (both pools); shapes_16a: each hd-64 shape alone at the "
        "engine's rows (ms with the wrapper, graph_ms one call in a CUDA graph). "
        "launches_phase17 (flash_attention_fwd, flash_attention_bwd, paged_attention, "
        "w8a16_matmul): each kernel's launches on phase 17's paths, counted from 0 just before "
        "each and read just after (K2, K7: one QLoRA-7B train step, 17a, and one GRPO-1.5B "
        "update, 17b; K3: one timed GRPO rollout on PagedEngine at g = 6; K4: one decode step "
        "of the adapted int8 7B); path_phase17: those steps' K2 and K7 launches, count, ms "
        "their device time in the step (CUDA events), bound_ms summed per launch, plain_ms "
        "and library_ms (SDPA, SDPA's backward): 17a every launch of one more step re-run "
        "against its plain version and timed on its own inputs (err, ratio), 17b timed on "
        "one launch of each shape times its count; "
        "rollout_chunk_17b: the first rollout chunk's K3 launches held to the plain version, "
        "path_ms by events, graph_ms replayed in one CUDA graph, bound_ms summed, plain_ms "
        "one step's launches timed alone times the chunk's steps; adapted_step_17a: one "
        "decode step's 113 K4 launches, ms their device time in a profiled replay of the "
        "captured step, plain_ms, library_ms and bound_ms per shape times its count, err and "
        "ratio of every launch of the step re-run against the plain version. "
        "launches_phase18 (flash_attention_fwd, log_mel): each kernel's launches on phase "
        "18's paths, counted from 0 just before each and read just after (K2: the demo's two "
        "turns, 18c; each eval route on the bf16 7B, 18d; the warm 15-minute generate, 18e; "
        "K1: that generate); shapes_18e / shape_18e: the first encoder and prefill K2 launch "
        "of the first 15-minute generate and K1 on the clip's 30 windows, held to the plain "
        "version (err, ratio) and timed (ms with the wrapper, K1 also as device time), "
        "beside the plain version, SDPA (K2) and the bound.")
    log(f"card (again, for the record): {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    log("done")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
