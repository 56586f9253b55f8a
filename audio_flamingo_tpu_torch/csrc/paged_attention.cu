// Paged-attention decode (one query token per row, or the S tokens of a speculative verify
// folded into the group axis) for Hopper (sm_90a), plain C interface bound with ctypes.
//
// Replaces the Pallas TPU kernel audio_flamingo_tpu/ops/pallas/paged_attention.py
// (`paged_attention`, kernel `_paged_kernel`): GQA decode attention for one layer with
// K/V read through a block table from the layer-stacked page pool, f32 or bf16 queries,
// pools in the query's dtype, bf16, or int8 with f32 per-token scales. It returns the
// UNNORMALIZED online-softmax triple (o [B, nkv, g, hd], m, l [B, nkv, g], all f32); the
// caller folds the current token in (`merge_current_token`) and normalizes. A speculative
// verify (runtime/paged_cache.paged_verify_step, as the JAX one) folds its S = k + 1 fresh
// queries into the group axis: g' = S g query rows a KV head (35 at k = 4 on Qwen2.5-7B),
// every one attending the same past (`lengths[b]` keys); the block's own triangle is merged
// outside the kernel (`merge_block_tokens`).
//
// Head dims: every kernel is a template over hd (kD), built at 64 (AF1's OPT: 32 KV heads of
// 64, g = 1, q scaled before the product so scale = 1) and 128 (the Qwen2 LMs); the C entry
// dispatches on hd and refuses any other. At 64 the V pass's mappings are remapped so that
// every thread works and none writes past hd: on the tensor cores the 8 warps are 4 column
// groups of 16 x 2 key halves (warp w: columns 16 (w % 4) .., keys 32 (w / 4) .. of each
// 64-key step; the upper half's accumulators join the lower's through shared memory before
// the write); on the CUDA cores a thread is (column pair, phase) over 32 pairs x 8 phases
// (kT = 1: every 8th key, the 8 phases added in order; kT = 8: one head tile a thread). An
// int8 row of 64 values is staged unpadded (rows 64 bytes apart). At g = 1 (OPT's decode)
// a head tile of 8 query rows holds 1: the score mma's n = 8 columns carry 1 live query and
// 3 of every 4 p-forming threads idle; the bound is bytes either way.
//
// Layout: q [B, nkv, g, hd] contiguous; pools [L, NB, BS, nkv, hd] contiguous, the layer
// chosen inside the kernel by a pointer offset (the stacked pool is never sliced or
// copied); scales [L, NB, BS, nkv]; block_tables [B, MP] int32 (-1 = unmapped) and
// lengths [B] int32.
//
// Semantics, value for value with the JAX kernel: row b walks its pages j < ceil(len/BS)
// (at most MP) in order (entries at or past that count are never read; -1 reads page 0);
// keys at or past len score NEG_INF = -0.7 * FLT_MAX; m starts at NEG_INF and o, l at 0,
// so a row with len = 0 returns o = 0, l = 0, m = NEG_INF. Scores are f32 dot products
// (FMAs, no TF32) times `scale`, times the key's scale for int8 pools. For each page, m_new =
// max(m, page max), p = exp(s - m_new) against that running max, l = l exp(m - m_new) +
// sum p (unrounded), and P.V takes p (times the value's scale for int8) rounded to q's
// dtype, as the JAX kernel's `pv.astype(q_ref.dtype)`.
//
// Design (two launches a call; the wrapper counts them as one launch of K3). Decode
// attention at g = 7 does about 7 flops a byte: the bound is bytes, and at the engine's
// rows a call is short enough that latency (the bytes each SM keeps in flight, dependent
// loads, the launches' tails) and instructions are what the design works on.
//   1. score_kernel, a block per (page, kv head, row), 256 threads: the page's K rows of
//      the head come through a 3-slot cp.async ring of 64-key steps (at BS = 128 both
//      halves of the page are in flight at once and the first is scored while the second
//      lands). bf16 q over a bf16 pool: warps 0-3 each score 16 keys on the tensor cores
//      (mma.sync m16n8k16, K rows by ldmatrix, q as B fragments held in registers, f32
//      accumulators); other pairs: thread (key, quarter) dots its key with every query
//      head over a quarter of the head dim on the CUDA cores (q in f32 in shared memory),
//      the quarters meeting by shuffles. Every score goes to the f32 scratch [B, nkv, MP,
//      ceil(BS/64), 64, g] (NEG_INF past len or past BS), and the page's max per head to
//      [B, nkv, MP, g]. K is read once.
//   2. attend_kernel, a block per (part, kv head, row), 256 threads, a part being
//      `pages_per_part` consecutive table entries: it takes the prefix maxima of the page
//      maxima (a warp scan), so p is rounded against exactly the running max the sequential walk holds
//      after each page, and streams its pages' V rows with their scores (and int8 scales)
//      through a 3-slot cp.async ring of 64-key steps (K is not read again). Thread (key,
//      head quarter) forms p; P.V runs bf16 over bf16 on the tensor cores (warp w: output
//      columns 16 w .. 16 w + 15 x 8 heads, V^T by ldmatrix.trans against p^T in bf16,
//      which is p rounded to q's dtype exactly), other pairs on the CUDA cores (thread
//      (column pair, key phase), f32 accumulators for 2 columns x 8 heads over every 4th
//      key, the 4 phases added in order). A part's triple is (o, m, l) over its pages.
//      With one live part the block writes the output; otherwise each part writes its
//      triple to the scratch and the last part of the (row, kv head) to finish (an
//      integer ticket per pair, reset by that block, as K4's split tiles do) merges all
//      parts IN PART ORDER: m = max m_s, o = sum_s o_s exp(m_s - m), l likewise, each
//      part's weight computed once. No float atomics, so a replay is bit-identical
//      whichever block comes last. A row with len = 0 gets its empty triple from its
//      part 0 block; parts past a row's pages return at once.
// Groups: the kernels are templates over kT head tiles of 8 query rows. g <= 8 takes
// kT = 1, the decode kernels as they were; 8 < g <= 64 (kMaxG) takes kT = 8, the same two
// launches reading each live page's K and V once for all g rows: the score pass stages q
// (bf16, in shared memory) and runs one mma per head tile on the same K fragments, the V
// pass one mma per head tile on the same V^T fragments; on the CUDA cores the score pass
// loops over head tiles of 8 (part[8] in registers) and the V pass gives thread (column
// pair, tile group) the tiles ph and ph + 4 over all 64 keys of a step (no key phases),
// so no accumulator array outgrows its registers. At g' = 35 a call does about 35 flops a
// byte of bf16 K and V: still the bytes' side of the ridge. The score stage of kT = 8
// holds K rows only (the V pass's stage also holds the step's scores [64][64]). kT = 8
// launched at g = 7 took 1.4-2.5x kT = 1's device time on 8a's mixed rows (its V-pass
// stage holds 64 score columns, so fewer blocks fit an SM; scripts/torch_k3_k9_times.py
// --tiles, NVIDIA H100 80GB HBM3 at 700 W), so g <= 8 keeps the one-tile kernels.
// Shared memory a block: bf16 pool on the tensor cores, score_kernel 3 x 19,712 + 4,352 =
// 63,488 bytes and attend_kernel 3 x 19,712 + 2,048 + 32 (pages_per_part + 1) + 256,
// about 62 KB (3 blocks an SM); int8 pool 3 x 14,592 + .. (3-4 an SM); f32 pool 3 x
// 39,168 + .. (1 an SM); 256 threads each. The wrapper's parts (ops/kernels/
// paged_attention.kernel_parts) give a full table (B nkv MP entries) about as many blocks
// an SM as attend_kernel's occupancy on the card (af_paged_attention_occupancy): at
// B = 4, nkv 4, MP 32, bf16, 2 pages a part (16 parts), which measured faster than 8 or
// 32.
//
// Bound on the H100 at the engine's mixed shape (B = 4, nkv 4, g 7, hd 128, BS 128, bf16
// pool; rows of 548, 548, 3848, 3848 tokens): the live keys' K and V, 18.1 MB, 5.40 us at
// 3.35 TB/s; this design also writes and reads the scores (1.0 MB each way) and the
// parts' triples. Measured (scripts/torch_k3_k9_times.py, NVIDIA H100 80GB HBM3 at
// 700 W): 0.019 ms of device time there, 28 % of the bound (the previous three-launch
// design: 0.049 ms); the int8 and f32 pools, on the CUDA cores, 0.036 / 0.041 ms.
// Measured and not kept: launching pass 2 early beside pass 1 (programmatic dependent
// launch; -0.7 us for bf16, +1.6-1.9 us for the CUDA-core pairs). Left: one launch when
// parts = 1, a persistent grid, and a CUDA graph around the serving step (the engine
// launches 28 calls a step from the host).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

#include "flash_mma.cuh"   // cp_async16, cp_async4, cp_async_commit, cp_async_wait

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHDMin = 64;    // the head dims the kernels are built for: OPT's
constexpr int kHDMax = 128;   // and Qwen2's
constexpr int kMaxG = 64;     // query rows per KV head (decode heads, or verify tokens x heads)
constexpr int kTile = 8;      // query rows a head tile
constexpr int kC = 64;        // keys a ring step
constexpr int kStages = 3;    // ring slots
constexpr int kPad = 64;      // row padding: a row stride of 64 mod 128 bytes keeps the
                              // 16-byte reads of (key, quarter) threads off each other's banks
constexpr float kNegInf = -0.7f * FLT_MAX;
constexpr size_t kSmemLimit = 232448;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// p as P.V consumes it: rounded to the query dtype (exact for f32)
template <typename TQ> __device__ __forceinline__ float round_q(float p);
template <> __device__ __forceinline__ float round_q<float>(float p) { return p; }
template <> __device__ __forceinline__ float round_q<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16(p));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// 16 bytes of K -> floats
__device__ __forceinline__ void unpack16(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, float* f, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void unpack16(const uint4& u, float* f, int8_t) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = (float)c[i];
}

// two neighbouring V values -> floats
__device__ __forceinline__ float2 unpack2(const unsigned char* p, float) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 unpack2(const unsigned char* p, __nv_bfloat16) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 unpack2(const unsigned char* p, int8_t) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2((float)c.x, (float)c.y);
}

// bf16 queries over a bf16 pool take both products on the tensor cores (mma.sync
// m16n8k16, f32 accumulators); every other pair takes them on the CUDA cores.
template <typename TQ, typename TKV>
constexpr bool kMma = std::is_same<TQ, __nv_bfloat16>::value &&
                      std::is_same<TKV, __nv_bfloat16>::value;
constexpr int kPT = kC + 8;   // p^T row stride (bf16): its B fragments hit 32 banks

// A staged row: the head's hd values, then 16 bytes (ldmatrix: rows 16 mod 128 bytes
// apart) or enough to put rows 64 mod 128 bytes apart (the CUDA cores' interleaved 16-byte
// reads): 64 bytes, none for an int8 row of 64 values.
template <typename TQ, typename TKV, int kD> __host__ __device__ constexpr int row_bytes() {
  return kD * (int)sizeof(TKV) +
         (kMma<TQ, TKV> ? 16 : (kD * (int)sizeof(TKV)) % 128 == kPad ? 0 : kPad);
}

// One ring slot: 64 rows of K (pass 1) or V (pass 2), then (pass 2) the step's scores
// [64][8 kT], then the step's int8 scales [64]. kT head tiles of 8 query rows.
template <typename TQ, typename TKV, int kT, int kD> __host__ __device__ constexpr int stage_bytes() {
  return kC * row_bytes<TQ, TKV, kD>() + kC * kTile * kT * 4 + kC * 4;
}
template <typename TQ, typename TKV, int kT, int kD> __host__ __device__ constexpr int stage_scores() {
  return kC * row_bytes<TQ, TKV, kD>();
}
template <typename TQ, typename TKV, int kT, int kD> __host__ __device__ constexpr int stage_scales() {
  return kC * row_bytes<TQ, TKV, kD>() + kC * kTile * kT * 4;
}
// The score pass's slot: kT = 1 keeps the V pass's layout (the decode kernel as it was);
// kT = 8 holds K rows and scales only.
template <typename TQ, typename TKV, int kT, int kD> __host__ __device__ constexpr int kstage_bytes() {
  return kT == 1 ? stage_bytes<TQ, TKV, kT, kD>() : kC * row_bytes<TQ, TKV, kD>() + kC * 4;
}
template <typename TQ, typename TKV, int kT, int kD> __host__ __device__ constexpr int kstage_scales() {
  return kT == 1 ? stage_scales<TQ, TKV, kT, kD>() : kC * row_bytes<TQ, TKV, kD>();
}
// the staged bf16 q row (kT > 1): its B fragments hit 32 banks
template <int kD> __host__ __device__ constexpr int q_row() { return kD + 8; }

// q as the score pass holds it: f32 rows (CUDA cores), bf16 rows of q_row (tensor cores,
// kT > 1), nothing (tensor cores, kT = 1: registers); then the warps' page maxima.
template <typename TQ, typename TKV, int kT, int kD> __host__ __device__ constexpr size_t q_smem() {
  return kMma<TQ, TKV> ? (kT == 1 ? (size_t)kTile * kD * 4 : (size_t)kTile * kT * q_row<kD>() * 2)
                       : (size_t)kTile * kT * kD * 4;
}
template <typename TQ, typename TKV, int kT, int kD> size_t score_smem() {
  return (size_t)kStages * kstage_bytes<TQ, TKV, kT, kD>() + q_smem<TQ, TKV, kT, kD>() +
         (size_t)kWarps * kTile * kT * 4;
}
template <typename TQ, typename TKV, int kT, int kD> size_t attend_smem(int pages_per_part) {
  constexpr int kG = kTile * kT;
  return (size_t)kStages * stage_bytes<TQ, TKV, kT, kD>() + kC * kG * 4 +
         (size_t)(pages_per_part + 1) * kG * 4 + kWarps * kG * 4;
}

// One layer's operands as the kernels read them.
template <typename TQ, typename TKV>
struct Layer {
  const TQ* q;
  const TKV* k;         // the layer's [NB, BS, nkv, hd] pool (a pointer offset)
  const TKV* v;
  const float* ks;      // [NB, BS, nkv] or null
  const float* vs;
  const int* tables;    // [B, MP]
  const int* lengths;   // [B]
  int nkv, g, BS, MP, nc;   // nc: ring steps a page, ceil(BS / 64)
  float scale;
};

// The f32 scratch (float offsets), as ops/kernels/paged_attention.plan lays it out.
struct Scratch {
  float* scores;   // [B, nkv, MP, nc, 64, g]
  float* pmax;     // [B, nkv, MP, g], rounded up to a multiple of 4 floats
  float* o_part;   // [B, nkv, parts, g, hd]
  float* m_part;   // [B, nkv, parts, g]
  float* l_part;
};

__device__ __forceinline__ int row_pages(int len, int BS, int MP) {
  return len > 0 ? min((len + BS - 1) / BS, MP) : 0;
}

// Step c (keys c * 64 ..) of page `page` of head kvh: its 64 rows of `pool` by 16-byte
// cp.async copies (rows past BS zero-filled) and, with scales, the rows' int8 scales at
// byte `scales_at` of the slot (past BS: 0). All threads take part; the caller commits.
template <typename TQ, typename TKV, bool kQuant, int kD>
__device__ __forceinline__ void stage_rows(unsigned char* slot, int scales_at, const TKV* pool,
                                           const float* scales, int page, int c, int BS,
                                           int nkv, int kvh) {
  constexpr int kRow = row_bytes<TQ, TKV, kD>();
  constexpr int kCh = kD * (int)sizeof(TKV) / 16;
  const size_t row0 = (size_t)page * BS;
  for (int i = threadIdx.x; i < kC * kCh; i += kThreads) {
    const int t = i / kCh, ch = i % kCh;
    const int kt = c * kC + t;
    const bool in = kt < BS;
    const size_t src = ((row0 + (in ? kt : 0)) * nkv + kvh) * kD;
    cp_async16(slot + t * kRow + 16 * ch, reinterpret_cast<const uint4*>(pool + src) + ch, in);
  }
  if (kQuant && threadIdx.x < kC) {
    const int kt = c * kC + threadIdx.x;
    float* dst = reinterpret_cast<float*>(slot + scales_at) + threadIdx.x;
    if (kt < BS)
      cp_async4(dst, scales + (row0 + kt) * nkv + kvh, true);
    else
      *dst = 0.f;
  }
}

// Pass 1: the scores of one page of one (row, kv head) and the page's max per query row.
template <typename TQ, typename TKV, bool kQuant, int kT, int kD>
__global__ void __launch_bounds__(kThreads)
score_kernel(Layer<TQ, TKV> a, Scratch sc) {
  constexpr int kRow = row_bytes<TQ, TKV, kD>();
  constexpr int kE = 16 / (int)sizeof(TKV);                 // values in 16 bytes
  constexpr int kN = kD * (int)sizeof(TKV) / 16 / 4;       // 16-byte reads a quarter
  constexpr int kG = kTile * kT;                            // query rows the block can hold
  constexpr int kSlot = kstage_bytes<TQ, TKV, kT, kD>();
  constexpr int kQRow = q_row<kD>();
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + kStages * kSlot);                  // q_smem
  float* red = reinterpret_cast<float*>(smem + kStages * kSlot + q_smem<TQ, TKV, kT, kD>());
  __nv_bfloat16* qsb = reinterpret_cast<__nv_bfloat16*>(qs);   // [kG][kQRow] (kT > 1)
  const int j = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = a.lengths[b];
  const int entry = a.tables[(size_t)b * a.MP + j];   // read beside the length
  if (j >= row_pages(len, a.BS, a.MP)) return;
  const int g = a.g, nc = a.nc;
  const int nt = (g + kTile - 1) / kTile;             // head tiles in use
  const int page = max(entry, 0);
  const size_t bk = (size_t)b * a.nkv + kvh;

  auto fetch = [&](int c) {
    stage_rows<TQ, TKV, kQuant, kD>(smem + (c % kStages) * kSlot, kstage_scales<TQ, TKV, kT, kD>(), a.k,
                                a.ks, page, c, a.BS, a.nkv, kvh);
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nc) fetch(i);
    cp_async_commit();
  }
  const TQ* qb = a.q + bk * g * kD;
  // tensor cores, kT = 1: q as the B fragments of S = K q^T, 8 k-steps of 16 dims (head =
  // lane / 4, zero past g), in registers; kT > 1: q in bf16 rows in shared memory, each
  // head tile's fragments read there; CUDA cores: q in f32 in shared memory
  uint32_t qf[kD / 16][2];
  if constexpr (kMma<TQ, TKV> && kT == 1) {
    const int gq = lane >> 2, tq = lane & 3;
    const uint32_t* qrow = reinterpret_cast<const uint32_t*>(qb + min(gq, g - 1) * kD);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      qf[kk][0] = gq < g ? qrow[8 * kk + tq] : 0u;
      qf[kk][1] = gq < g ? qrow[8 * kk + tq + 4] : 0u;
    }
  } else if constexpr (kMma<TQ, TKV>) {
    const uint32_t* q32 = reinterpret_cast<const uint32_t*>(qb);
    for (int i = tid; i < kG * kD / 2; i += kThreads) {
      const int h = i / (kD / 2);
      reinterpret_cast<uint32_t*>(qsb + h * kQRow)[i % (kD / 2)] = h < g ? q32[i] : 0u;
    }
  } else {
    for (int i = tid; i < kG * kD; i += kThreads)
      qs[i] = i < g * kD ? to_f32(qb[i]) : 0.f;
  }

  const int t = tid >> 2, qd = tid & 3;
  float pm = kNegInf;   // thread gi < g: the page's running max of query row gi
  for (int c = 0; c < nc; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // step c has landed for every thread; step c - 1's slot is free
    if (c + kStages - 1 < nc) fetch(c + kStages - 1);
    cp_async_commit();
    const unsigned char* slot = smem + (c % kStages) * kSlot;
    if constexpr (kMma<TQ, TKV>) {
      // warp w < 4 scores keys 16 w .. 16 w + 15 of the step: C [16 keys x 8 rows] a tile
      if (warp < kC / 16) {
        const int gq = lane >> 2, tq = lane & 3;
        float acc[kT][4];
#pragma unroll
        for (int tt = 0; tt < kT; ++tt) acc[tt][0] = acc[tt][1] = acc[tt][2] = acc[tt][3] = 0.f;
        const unsigned char* arow = slot + (16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8) * kRow
                                    + (lane >> 4) * 16;
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
          uint32_t af[4];
          ldmatrix_x4(af, arow + 32 * kk);
          if constexpr (kT == 1) {
            mma_bf16(acc[0], af, qf[kk][0], qf[kk][1]);
          } else {
#pragma unroll
            for (int tt = 0; tt < kT; ++tt) {   // the same K fragments for every head tile
              if (tt < nt) {
                const uint32_t* qrow =
                    reinterpret_cast<const uint32_t*>(qsb + (kTile * tt + gq) * kQRow) + 8 * kk + tq;
                mma_bf16(acc[tt], af, qrow[0], qrow[4]);
              }
            }
          }
        }
#pragma unroll
        for (int tt = 0; tt < kT; ++tt) {
          if (tt < nt) {
            float mx[2] = {kNegInf, kNegInf};
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int tk = 16 * warp + gq + 8 * half;
              const int kt = c * kC + tk;
              const bool live = kt < a.BS && j * a.BS + kt < len;
              float* out = sc.scores + (((bk * a.MP + j) * nc + c) * kC + tk) * g;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int h = kTile * tt + 2 * tq + e;
                const float s = live ? acc[tt][2 * half + e] * a.scale : kNegInf;
                if (h < g) out[h] = s;
                mx[e] = fmaxf(mx[e], s);
              }
            }
#pragma unroll
            for (int e = 0; e < 2; ++e) {   // over the warp's 16 keys
              mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 4));
              mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 8));
              mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 16));
              if (lane < 4) red[warp * kG + kTile * tt + 2 * tq + e] = mx[e];
            }
          }
        }
      }
      __syncthreads();
      if (tid < g) {
#pragma unroll
        for (int w = 0; w < kC / 16; ++w) pm = fmaxf(pm, red[w * kG + tid]);
      }
      continue;
    }
    const int kt = c * kC + t;
    const bool live = kt < a.BS && j * a.BS + kt < len;
    const float ksc = kQuant ? reinterpret_cast<const float*>(slot + kstage_scales<TQ, TKV, kT, kD>())[t]
                             : 1.f;
    float* out = sc.scores + (((bk * a.MP + j) * nc + c) * kC + t) * g;
    // a head tile of 8 query rows at a time: 8 partial dots in registers
#pragma unroll 1
    for (int tt = 0; tt < kT; ++tt) {
      if (tt >= nt) break;
      const int h0 = kTile * tt;
      float part[kTile];
#pragma unroll
      for (int gi = 0; gi < kTile; ++gi) part[gi] = 0.f;
      if (kt < a.BS) {
        const unsigned char* row = slot + t * kRow;
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          const int ch = qd + 4 * i;   // interleaved 16-byte chunks of the row
          float kf[kE];
          unpack16(*reinterpret_cast<const uint4*>(row + 16 * ch), kf, TKV());
#pragma unroll
          for (int gi = 0; gi < kTile; ++gi) {
            if (h0 + gi < g) {
#pragma unroll
              for (int e = 0; e < kE; e += 4) {
                const float4 qv =
                    *reinterpret_cast<const float4*>(qs + (h0 + gi) * kD + ch * kE + e);
                part[gi] = fmaf(qv.x, kf[e], part[gi]);
                part[gi] = fmaf(qv.y, kf[e + 1], part[gi]);
                part[gi] = fmaf(qv.z, kf[e + 2], part[gi]);
                part[gi] = fmaf(qv.w, kf[e + 3], part[gi]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int gi = 0; gi < kTile; ++gi) {
        if (h0 + gi < g) {   // the quarters meet: (q0 + q1) + (q2 + q3) in every lane of the quad
          float s = part[gi] + __shfl_xor_sync(0xffffffffu, part[gi], 1);
          s += __shfl_xor_sync(0xffffffffu, s, 2);
          s *= a.scale;
          if (kQuant) s *= ksc;
          part[gi] = live ? s : kNegInf;
          if ((gi & 3) == qd) out[h0 + gi] = part[gi];
        }
      }
      // the page max per row: over the warp's 8 keys, then (below) over the 8 warps
#pragma unroll
      for (int gi = 0; gi < kTile; ++gi) {
        if (h0 + gi < g) {
          float mx = part[gi];
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
          if (lane == 0) red[warp * kG + h0 + gi] = mx;
        }
      }
    }
    __syncthreads();
    if (tid < g) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) pm = fmaxf(pm, red[w * kG + tid]);
    }
  }
  if (tid < g) sc.pmax[(bk * a.MP + j) * g + tid] = pm;
}

// Pass 2: the online softmax over one part's pages from the scores and V, then the
// part's triple (or the output), and the merge of the parts by the last one to finish.
template <typename TQ, typename TKV, bool kQuant, int kT, int kD>
__global__ void __launch_bounds__(kThreads)
attend_kernel(Layer<TQ, TKV> a, Scratch sc, int pages_per_part, int* __restrict__ tickets,
              float* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out) {
  constexpr int kRow = row_bytes<TQ, TKV, kD>();
  constexpr int kG = kTile * kT;
  constexpr int kSlot = stage_bytes<TQ, TKV, kT, kD>();
  // P.V on the tensor cores: warp w owns output columns 16 (w % kColWarps) .. + 15 over
  // key half w / kColWarps of each step (at hd 64 two warps share a column group, each
  // taking 32 of the 64 keys, and the upper half's sums join the lower's at the end). On
  // the CUDA cores: thread (column pair cp, phase or tile group ph), kPairs pairs and
  // kPhases phases (4 at hd 128, 8 at 64).
  constexpr int kColWarps = kD / 16;
  constexpr int kKeySplit = kWarps / kColWarps;
  constexpr int kPairs = kD / 2;
  constexpr int kPhases = kThreads / kPairs;
  static_assert(kKeySplit * kColWarps == kWarps && kPhases * kPairs == kThreads &&
                (kT == 1 || kT % kPhases == 0), "the P.V mappings cover the block");
  // accumulators: tensor cores [head tile][column half][2]; CUDA cores, kT = 1: [row][2]
  // over every kPhases-th key; kT > 1: [tiles ph, ph + kPhases, ..][row][2] over every key
  constexpr int kAcc = kMma<TQ, TKV> ? kT : (kT == 1 ? 1 : kT / kPhases);
  extern __shared__ __align__(128) unsigned char smem[];
  float* pr = reinterpret_cast<float*>(smem + kStages * kSlot);   // [64][kG]
  float* pm = pr + kC * kG;                                   // [pages_per_part + 1][kG]
  float* lred = pm + (pages_per_part + 1) * kG;               // [8 warps][kG]
  const int part = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, parts = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = a.g, nc = a.nc;
  const int nt = (g + kTile - 1) / kTile;
  const size_t bk = (size_t)b * a.nkv + kvh;
  const int n_pages = row_pages(a.lengths[b], a.BS, a.MP);
  const int live_parts = (n_pages + pages_per_part - 1) / pages_per_part;
  if (n_pages == 0) {   // no key: o = 0, m = NEG_INF, l = 0
    if (part == 0) {
      for (int i = tid; i < g * kD; i += kThreads) o[bk * g * kD + i] = 0.f;
      if (tid < g) {
        m_out[bk * g + tid] = kNegInf;
        l_out[bk * g + tid] = 0.f;
      }
    }
    return;
  }
  if (part >= live_parts) return;
  const int j0 = part * pages_per_part;
  const int np = min(j0 + pages_per_part, n_pages) - j0;
  const int* table = a.tables + (size_t)b * a.MP;

  auto fetch = [&](int q) {   // ring step q: page j0 + q / nc, keys (q % nc) * 64 ..
    unsigned char* slot = smem + (q % kStages) * kSlot;
    stage_rows<TQ, TKV, kQuant, kD>(slot, stage_scales<TQ, TKV, kT, kD>(), a.v, a.vs,
                                max(table[j0 + q / nc], 0), q % nc, a.BS, a.nkv, kvh);
    const float* src = sc.scores + ((bk * a.MP + j0 + q / nc) * nc + q % nc) * kC * g;
    for (int i = tid; i < kC * g / 4; i += kThreads)
      cp_async16(slot + stage_scores<TQ, TKV, kT, kD>() + 16 * i, src + 4 * i, true);
  };
  const int n = np * nc;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) fetch(i);
    cp_async_commit();
  }

  // the running max after each page: pm[0] = max of the maxima before the part,
  // pm[jj + 1] = max(pm[jj], page j0 + jj's max) (one warp a row, a scan over lanes)
  for (int gi = warp; gi < g; gi += kWarps) {
    const float* src = sc.pmax + bk * a.MP * g + gi;
    float mx = kNegInf;
    for (int j = lane; j < j0; j += 32) mx = fmaxf(mx, src[(size_t)j * g]);
    mx = warp_max(mx);
    if (lane == 0) pm[gi] = mx;
    for (int base = 0; base < np; base += 32) {
      const int jj = base + lane;
      float v = jj < np ? src[(size_t)(j0 + jj) * g] : kNegInf;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v = fmaxf(v, u);
      }
      v = fmaxf(v, mx);
      if (jj < np) pm[(jj + 1) * kG + gi] = v;
      mx = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  for (int i = tid; i < kC * kG; i += kThreads) pr[i] = 0.f;   // rows past g stay 0
  // tensor cores: p^T in bf16 [kG rows][kPT] in pr's place
  __nv_bfloat16* pT = reinterpret_cast<__nv_bfloat16*>(pr);

  const int t = tid >> 2, hq = tid & 3;          // p: key t, rows hq + 4 h
  const int cp = tid % kPairs, ph = tid / kPairs;   // P.V: columns 2 cp, 2 cp + 1; key
                                                    // phase or tile group ph
  float lp[2 * kT];
#pragma unroll
  for (int h = 0; h < 2 * kT; ++h) lp[h] = 0.f;
  float acc[kAcc][kTile][2];
#pragma unroll
  for (int u = 0; u < kAcc; ++u)
#pragma unroll
    for (int gi = 0; gi < kTile; ++gi) acc[u][gi][0] = acc[u][gi][1] = 0.f;

  for (int q = 0; q < n; ++q) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // step q has landed; step q - 1's slot and p are free
    if (q + kStages - 1 < n) fetch(q + kStages - 1);
    cp_async_commit();
    const unsigned char* slot = smem + (q % kStages) * kSlot;
    const int jj = q / nc;
    const bool first = q % nc == 0;   // a page starts: rescale by exp(m_prev - m_new)
    const float* s_in = reinterpret_cast<const float*>(slot + stage_scores<TQ, TKV, kT, kD>());
    const float vsc =
        kQuant ? reinterpret_cast<const float*>(slot + stage_scales<TQ, TKV, kT, kD>())[t] : 1.f;
#pragma unroll
    for (int h = 0; h < 2 * kT; ++h) {
      const int gi = hq + 4 * h;
      if (gi < g) {
        const float m_new = pm[(jj + 1) * kG + gi];
        if (first) lp[h] *= expf(pm[jj * kG + gi] - m_new);
        const float p = expf(s_in[t * g + gi] - m_new);
        lp[h] += p;
        if constexpr (kMma<TQ, TKV>)
          pT[gi * kPT + t] = __float2bfloat16(p);
        else
          pr[t * kG + gi] = round_q<TQ>(kQuant ? p * vsc : p);
      }
    }
    __syncthreads();
    if constexpr (kMma<TQ, TKV>) {
      // warp w: output columns 16 w .. 16 w + 15 x 8 rows a head tile, C = V^T p over the
      // step's 64 keys (4 k-steps; A by ldmatrix.trans from the V rows, shared by every
      // head tile, B from p^T)
      const int gq = lane >> 2, tq = lane & 3;
      if (first) {
#pragma unroll
        for (int tt = 0; tt < kT; ++tt) {
          if (tt < nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int h = kTile * tt + 2 * tq + e;
              const float alpha = h < g ? expf(pm[jj * kG + h] - pm[(jj + 1) * kG + h]) : 1.f;
              acc[tt][0][e] *= alpha;
              acc[tt][1][e] *= alpha;
            }
          }
        }
      }
      const unsigned char* vrow = slot + ((lane & 7) + ((lane >> 4) & 1) * 8) * kRow
                                  + (16 * (warp % kColWarps) + ((lane >> 3) & 1) * 8) * 2;
      constexpr int kSteps = kC / 16 / kKeySplit;   // k-steps of 16 keys a warp takes
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        const int kk = (warp / kColWarps) * kSteps + ks;
        uint32_t af[4];
        ldmatrix_x4_trans(af, vrow + 16 * kk * kRow);
#pragma unroll
        for (int tt = 0; tt < kT; ++tt) {
          if (tt < nt) {
            const __nv_bfloat16* pb = pT + (kTile * tt + gq) * kPT + 16 * kk + 2 * tq;
            float c4[4] = {acc[tt][0][0], acc[tt][0][1], acc[tt][1][0], acc[tt][1][1]};
            mma_bf16(c4, af, *reinterpret_cast<const uint32_t*>(pb),
                     *reinterpret_cast<const uint32_t*>(pb + 8));
            acc[tt][0][0] = c4[0];
            acc[tt][0][1] = c4[1];
            acc[tt][1][0] = c4[2];
            acc[tt][1][1] = c4[3];
          }
        }
      }
      continue;
    }
    const unsigned char* vcol = slot + cp * 2 * (int)sizeof(TKV);
    if constexpr (kT == 1) {
      if (first) {
#pragma unroll
        for (int gi = 0; gi < kTile; ++gi) {
          if (gi < g) {
            const float alpha = expf(pm[jj * kG + gi] - pm[(jj + 1) * kG + gi]);
            acc[0][gi][0] *= alpha;
            acc[0][gi][1] *= alpha;
          }
        }
      }
#pragma unroll 4
      for (int i = 0; i < kC / kPhases; ++i) {
        const int tk = ph + kPhases * i;
        const float2 v = unpack2(vcol + tk * kRow, TKV());
        const float4 p0 = *reinterpret_cast<const float4*>(pr + tk * kG);
        const float4 p1 = *reinterpret_cast<const float4*>(pr + tk * kG + 4);
        const float pv[kTile] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int gi = 0; gi < kTile; ++gi) {
          acc[0][gi][0] = fmaf(pv[gi], v.x, acc[0][gi][0]);
          acc[0][gi][1] = fmaf(pv[gi], v.y, acc[0][gi][1]);
        }
      }
    } else {
      // thread (column pair, group ph): head tiles ph, ph + kPhases, .., every key in order
      if (first) {
#pragma unroll
        for (int u = 0; u < kAcc; ++u) {
          const int h0 = kTile * (ph + kPhases * u);
#pragma unroll
          for (int gi = 0; gi < kTile; ++gi) {
            if (h0 + gi < g) {
              const float alpha = expf(pm[jj * kG + h0 + gi] - pm[(jj + 1) * kG + h0 + gi]);
              acc[u][gi][0] *= alpha;
              acc[u][gi][1] *= alpha;
            }
          }
        }
      }
#pragma unroll 2
      for (int tk = 0; tk < kC; ++tk) {
        const float2 v = unpack2(vcol + tk * kRow, TKV());
#pragma unroll
        for (int u = 0; u < kAcc; ++u) {
          const int tile = ph + kPhases * u;
          if (tile < nt) {
            const float4 p0 = *reinterpret_cast<const float4*>(pr + tk * kG + kTile * tile);
            const float4 p1 = *reinterpret_cast<const float4*>(pr + tk * kG + kTile * tile + 4);
            const float pv[kTile] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
            for (int gi = 0; gi < kTile; ++gi) {
              acc[u][gi][0] = fmaf(pv[gi], v.x, acc[u][gi][0]);
              acc[u][gi][1] = fmaf(pv[gi], v.y, acc[u][gi][1]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every step consumed: the ring's slots take the phases' sums

  // the key phases' accumulators (CUDA cores, kT = 1) or the upper key half's (tensor
  // cores, hd 64), then l: the threads' partial sums over the warp's keys (shuffles), then
  // over the warps in order
  float* xc = reinterpret_cast<float*>(smem);   // [kPhases][8][hd] or [4 warps][kT][32][4]
  if constexpr (!kMma<TQ, TKV> && kT == 1) {
#pragma unroll
    for (int gi = 0; gi < kTile; ++gi)
      if (gi < g)
        *reinterpret_cast<float2*>(xc + (ph * kTile + gi) * kD + 2 * cp) =
            make_float2(acc[0][gi][0], acc[0][gi][1]);
  }
  if constexpr (kMma<TQ, TKV> && kKeySplit > 1) {
    if (warp >= kColWarps) {
#pragma unroll
      for (int tt = 0; tt < kT; ++tt)
        if (tt < nt)
          *reinterpret_cast<float4*>(xc + (((warp - kColWarps) * kT + tt) * 32 + lane) * 4) =
              make_float4(acc[tt][0][0], acc[tt][0][1], acc[tt][1][0], acc[tt][1][1]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2 * kT; ++h) {
    float s = lp[h];
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    if (lane < 4 && hq + 4 * h < g) lred[warp * kG + hq + 4 * h] = s;
  }
  __syncthreads();
  const bool single = live_parts == 1;
  float* o_dst = single ? o + bk * g * kD : sc.o_part + (bk * parts + part) * g * kD;
  if constexpr (kMma<TQ, TKV>) {
    // warps of the lower key half write their columns (never past hd), the upper half's
    // sums added first
    const int gq = lane >> 2, tq = lane & 3;
    if (warp < kColWarps) {
#pragma unroll
      for (int tt = 0; tt < kT; ++tt) {
        if (tt < nt) {
          if constexpr (kKeySplit > 1) {
            const float4 u = *reinterpret_cast<const float4*>(xc + ((warp * kT + tt) * 32 + lane) * 4);
            acc[tt][0][0] += u.x;
            acc[tt][0][1] += u.y;
            acc[tt][1][0] += u.z;
            acc[tt][1][1] += u.w;
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int h = kTile * tt + 2 * tq + e;
            if (h < g) {
              o_dst[h * kD + 16 * warp + gq] = acc[tt][0][e];
              o_dst[h * kD + 16 * warp + gq + 8] = acc[tt][1][e];
            }
          }
        }
      }
    }
  } else if constexpr (kT == 1) {
    for (int i = tid; i < g * kD; i += kThreads) {
      const int gi = i / kD, col = i % kD;
      float x = xc[gi * kD + col];
#pragma unroll
      for (int p = 1; p < kPhases; ++p) x += xc[(p * kTile + gi) * kD + col];   // in order
      o_dst[i] = x;
    }
  } else {
#pragma unroll
    for (int u = 0; u < kAcc; ++u) {
      const int h0 = kTile * (ph + kPhases * u);
#pragma unroll
      for (int gi = 0; gi < kTile; ++gi)
        if (h0 + gi < g)
          *reinterpret_cast<float2*>(o_dst + (h0 + gi) * kD + 2 * cp) =
              make_float2(acc[u][gi][0], acc[u][gi][1]);
    }
  }
  if (tid < g) {
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) l += lred[w * kG + tid];
    const float m = pm[np * kG + tid];
    if (single) {
      m_out[bk * g + tid] = m;
      l_out[bk * g + tid] = l;
    } else {
      sc.m_part[(bk * parts + part) * g + tid] = m;
      sc.l_part[(bk * parts + part) * g + tid] = l;
    }
  }
  if (single) return;

  // the ticket: the last part of this (row, kv head) to get here merges all of them
  __shared__ int last;
  __threadfence();   // this part's triple is visible before it is counted
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(tickets + bk, 1) == live_parts - 1;
    if (last) tickets[bk] = 0;   // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // each part's weight exp(m_s - m) once per row (a warp a row, a lane a part; in the
  // ring's slots, free now), l over the parts in order, then o's columns by 16 bytes, every
  // part's load in flight at once
  float* wgt = reinterpret_cast<float*>(smem);   // [live_parts][kG]
  float* lsv = wgt + live_parts * kG;             // [live_parts][kG]
  for (int gi = warp; gi < g; gi += kWarps) {
    const float* mp = sc.m_part + bk * parts * g + gi;
    float mx = kNegInf;
    for (int s = lane; s < live_parts; s += 32) mx = fmaxf(mx, __ldcg(mp + s * g));
    mx = warp_max(mx);
    for (int s = lane; s < live_parts; s += 32) {
      wgt[s * kG + gi] = expf(__ldcg(mp + s * g) - mx);
      lsv[s * kG + gi] = __ldcg(sc.l_part + (bk * parts + s) * g + gi);
    }
    __syncwarp();
    if (lane == 0) {
      float acc_l = 0.f;
      for (int s = 0; s < live_parts; ++s) acc_l = fmaf(lsv[s * kG + gi], wgt[s * kG + gi], acc_l);
      m_out[bk * g + gi] = mx;
      l_out[bk * g + gi] = acc_l;
    }
  }
  __syncthreads();
  const float4* op = reinterpret_cast<const float4*>(sc.o_part + bk * parts * g * kD);
  float4* o4 = reinterpret_cast<float4*>(o + bk * g * kD);
  for (int i = tid; i < g * kD / 4; i += kThreads) {
    const int gi = 4 * i / kD;
    float4 acc_o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 16
    for (int s = 0; s < live_parts; ++s) {
      const float4 v = __ldcg(op + (size_t)s * g * kD / 4 + i);
      const float w = wgt[s * kG + gi];
      acc_o.x = fmaf(v.x, w, acc_o.x);
      acc_o.y = fmaf(v.y, w, acc_o.y);
      acc_o.z = fmaf(v.z, w, acc_o.z);
      acc_o.w = fmaf(v.w, w, acc_o.w);
    }
    o4[i] = acc_o;
  }
}

template <typename K> cudaError_t raise_smem_limit(K kernel) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(kSmemLimit - attr.sharedSizeBytes));
}

// The shared-memory limit of a pair's two kernels, raised once per device to the card's
// maximum (so that a launch captured in a CUDA graph makes no attribute call).
template <typename TQ, typename TKV, bool kQuant, int kT, int kD>
cudaError_t configure() {
  static bool configured[64] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = raise_smem_limit(score_kernel<TQ, TKV, kQuant, kT, kD>);
    if (err == cudaSuccess) err = raise_smem_limit(attend_kernel<TQ, TKV, kQuant, kT, kD>);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  return cudaSuccess;
}

// attend_kernel's blocks an SM for the pair and head tiles, at MP table entries a part (its
// most shared memory).
template <typename TQ, typename TKV, bool kQuant, int kT, int kD>
int attend_occupancy(int MP, int* blocks) {
  const cudaError_t err = configure<TQ, TKV, kQuant, kT, kD>();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, attend_kernel<TQ, TKV, kQuant, kT, kD>, kThreads, attend_smem<TQ, TKV, kT, kD>(MP));
}

template <typename TQ, typename TKV, bool kQuant, int kT, int kD>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
           const void* v_scale, const void* tables, const void* lengths, void* o, void* m,
           void* l, float* scratch, long long scratch_floats, int* tickets, int B, int nkv,
           int g, int NB, int BS, int MP, int layer, int parts, float scale,
           cudaStream_t stream) {
  const int nc = (BS + kC - 1) / kC;
  const int per_part = (MP + parts - 1) / parts;
  const size_t smem1 = score_smem<TQ, TKV, kT, kD>(), smem2 = attend_smem<TQ, TKV, kT, kD>(per_part);
  if (smem1 + 16 > kSmemLimit || smem2 + 16 > kSmemLimit) return (int)cudaErrorInvalidValue;
  static_assert(kT != 1 || kThreads / (kD / 2) * kTile * kD * 4 <=
                               kStages * stage_bytes<TQ, TKV, kT, kD>(),
                "the phases' sums fit in the ring");
  static_assert(!kMma<TQ, TKV> || kD == kHDMax ||
                    kWarps * kT * 32 * 4 * 4 <= kStages * stage_bytes<TQ, TKV, kT, kD>(),
                "the upper key half's sums fit in the ring");
  if ((long long)parts * kTile * kT * 8 > (long long)kStages * stage_bytes<TQ, TKV, kT, kD>())
    return (int)cudaErrorInvalidValue;   // the merge's weights and l's live in the ring
  const long long bkg = (long long)B * nkv * g;
  const long long pmax_floats = (bkg * MP + 3) / 4 * 4;   // the parts' o stay 16-byte aligned
  const long long need = bkg * MP * nc * kC + pmax_floats + bkg * parts * (kD + 2);
  if (scratch_floats < need) return (int)cudaErrorInvalidValue;
  cudaError_t err = configure<TQ, TKV, kQuant, kT, kD>();
  if (err != cudaSuccess) return (int)err;
  const size_t layer_scales = (size_t)layer * NB * BS * nkv;
  Layer<TQ, TKV> a;
  a.q = static_cast<const TQ*>(q);
  a.k = static_cast<const TKV*>(k_pool) + layer_scales * kD;
  a.v = static_cast<const TKV*>(v_pool) + layer_scales * kD;
  a.ks = kQuant ? static_cast<const float*>(k_scale) + layer_scales : nullptr;
  a.vs = kQuant ? static_cast<const float*>(v_scale) + layer_scales : nullptr;
  a.tables = static_cast<const int*>(tables);
  a.lengths = static_cast<const int*>(lengths);
  a.nkv = nkv;
  a.g = g;
  a.BS = BS;
  a.MP = MP;
  a.nc = nc;
  a.scale = scale;
  Scratch sc;
  sc.scores = scratch;
  sc.pmax = sc.scores + bkg * MP * nc * kC;
  sc.o_part = sc.pmax + pmax_floats;
  sc.m_part = sc.o_part + bkg * parts * kD;
  sc.l_part = sc.m_part + bkg * parts;
  score_kernel<TQ, TKV, kQuant, kT, kD><<<dim3(MP, nkv, B), kThreads, smem1, stream>>>(a, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attend_kernel<TQ, TKV, kQuant, kT, kD><<<dim3(parts, nkv, B), kThreads, smem2, stream>>>(
      a, sc, per_part, tickets, static_cast<float*>(o), static_cast<float*>(m),
      static_cast<float*>(l));
  return (int)cudaGetLastError();
}

// g <= 8 query rows a KV head: one head tile (the decode kernels); up to kMaxG: eight.
template <typename TQ, typename TKV, bool kQuant, int kD>
int launch_rows(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
                const void* v_scale, const void* tables, const void* lengths, void* o, void* m,
                void* l, float* scratch, long long scratch_floats, int* tickets, int B,
                int nkv, int g, int NB, int BS, int MP, int layer, int parts, float scale,
                cudaStream_t stream) {
  if (g <= kTile)
    return launch<TQ, TKV, kQuant, 1, kD>(q, k_pool, v_pool, k_scale, v_scale, tables, lengths, o,
                                      m, l, scratch, scratch_floats, tickets, B, nkv, g, NB,
                                      BS, MP, layer, parts, scale, stream);
  return launch<TQ, TKV, kQuant, kMaxG / kTile, kD>(q, k_pool, v_pool, k_scale, v_scale, tables,
                                                lengths, o, m, l, scratch, scratch_floats,
                                                tickets, B, nkv, g, NB, BS, MP, layer, parts,
                                                scale, stream);
}

template <typename TQ, typename TKV, bool kQuant, int kD>
int occupancy_rows(int g, int MP, int* blocks) {
  return g <= kTile ? attend_occupancy<TQ, TKV, kQuant, 1, kD>(MP, blocks)
                    : attend_occupancy<TQ, TKV, kQuant, kMaxG / kTile, kD>(MP, blocks);
}

// The (q dtype, pool dtype) pairs at one head dim.
template <int kD>
int launch_pair(int q_dtype, int kv_dtype, const void* q, const void* k_pool,
                const void* v_pool, const void* k_scale, const void* v_scale,
                const void* tables, const void* lengths, void* o, void* m, void* l,
                float* sf, long long scratch_floats, int* tk, int B, int nkv, int g, int NB,
                int BS, int MP, int layer, int parts, float scale, cudaStream_t s) {
#define AF_PAGED_ARGS q, k_pool, v_pool, k_scale, v_scale, tables, lengths, o, m, l, sf, \
                      scratch_floats, tk, B, nkv, g, NB, BS, MP, layer, parts, scale, s
  if (q_dtype == 0 && kv_dtype == 0) return launch_rows<float, float, false, kD>(AF_PAGED_ARGS);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_rows<float, __nv_bfloat16, false, kD>(AF_PAGED_ARGS);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_rows<__nv_bfloat16, __nv_bfloat16, false, kD>(AF_PAGED_ARGS);
  if (q_dtype == 0 && kv_dtype == 2) return launch_rows<float, int8_t, true, kD>(AF_PAGED_ARGS);
  if (q_dtype == 1 && kv_dtype == 2)
    return launch_rows<__nv_bfloat16, int8_t, true, kD>(AF_PAGED_ARGS);
#undef AF_PAGED_ARGS
  return (int)cudaErrorInvalidValue;
}

template <int kD>
int occupancy_pair(int q_dtype, int kv_dtype, int g, int MP, int* blocks) {
  if (q_dtype == 0 && kv_dtype == 0) return occupancy_rows<float, float, false, kD>(g, MP, blocks);
  if (q_dtype == 0 && kv_dtype == 1)
    return occupancy_rows<float, __nv_bfloat16, false, kD>(g, MP, blocks);
  if (q_dtype == 1 && kv_dtype == 1)
    return occupancy_rows<__nv_bfloat16, __nv_bfloat16, false, kD>(g, MP, blocks);
  if (q_dtype == 0 && kv_dtype == 2) return occupancy_rows<float, int8_t, true, kD>(g, MP, blocks);
  if (q_dtype == 1 && kv_dtype == 2)
    return occupancy_rows<__nv_bfloat16, int8_t, true, kD>(g, MP, blocks);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q_dtype: 0 = f32, 1 = bf16; kv_dtype: 0 = f32, 1 = bf16, 2 = int8 with f32 scales (a
// bf16 pool may serve f32 queries). g: query rows a KV head, 1 .. 64 (a verify's tokens x
// heads); hd: 64 or 128, anything else is refused. The pools hold L layers of NB pages;
// `layer` selects one inside the kernels. parts (1 .. MP) splits each row's MP table
// entries over that many blocks of ceil(MP / parts) entries. scratch: scratch_floats f32,
// at least B nkv g MP ceil(BS / 64) 64 + round_up(B nkv g MP, 4) + B nkv g parts (hd + 2)
// (16-byte aligned); tickets: B nkv int32, zero, left zero. Two launches.
extern "C" int af_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                  const void* k_scale, const void* v_scale,
                                  const void* tables, const void* lengths, void* o, void* m,
                                  void* l, void* scratch, void* tickets, int q_dtype,
                                  int kv_dtype, int B, int nkv, int g, int hd, int NB, int BS,
                                  int MP, int layer, int parts, long long scratch_floats,
                                  float scale, void* stream) {
  if (B <= 0 || nkv <= 0 || g <= 0 || g > kMaxG || (hd != kHDMin && hd != kHDMax) ||
      NB <= 0 || BS <= 0 || MP <= 0 || layer < 0 || parts < 1 || parts > MP ||
      scratch == nullptr || tickets == nullptr || (B > 65535) || (nkv > 65535) || (MP > 65535))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sf = static_cast<float*>(scratch);
  int* tk = static_cast<int*>(tickets);
  return (hd == kHDMin ? launch_pair<kHDMin> : launch_pair<kHDMax>)(
      q_dtype, kv_dtype, q, k_pool, v_pool, k_scale, v_scale, tables, lengths, o, m, l, sf,
      scratch_floats, tk, B, nkv, g, NB, BS, MP, layer, parts, scale, s);
}

// blocks: how many attend_kernel blocks of the (q_dtype, kv_dtype) pair at g query rows a
// KV head and head dim hd an SM of the current device holds (its threads, registers and
// shared memory at MP entries a part, the most a part can have): the occupancy the
// wrapper chooses its parts by (ops/kernels/paged_attention.kernel_parts). Returns a
// cudaError_t.
extern "C" int af_paged_attention_occupancy(int q_dtype, int kv_dtype, int g, int hd, int MP,
                                            int* blocks) {
  if (MP <= 0 || g <= 0 || g > kMaxG || (hd != kHDMin && hd != kHDMax) || blocks == nullptr)
    return (int)cudaErrorInvalidValue;
  return hd == kHDMin ? occupancy_pair<kHDMin>(q_dtype, kv_dtype, g, MP, blocks)
                      : occupancy_pair<kHDMax>(q_dtype, kv_dtype, g, MP, blocks);
}
