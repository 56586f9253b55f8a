// Int8-QK flash attention (K8) for Hopper (sm_90a), with its prelude; plain C interface
// bound with ctypes.
//
// Replaces the Pallas TPU kernel audio_flamingo_tpu/ops/pallas/flash_attention_a8.py
// (`flash_attention_a8` :133, body `_a8_kernel` :45) and the XLA prelude JAX runs before
// it (:139-189). Two entry points:
//
// af_fa8_prelude (three launches): reads q [B, Tq, H, D] and k, v [B, Tk, Hkv, D] (f32 or
//   bf16) in place through their strides and writes int8 q [B*H, tq_pad, D] (one scale
//   per row, qs = max(amax, 1e-6) / 127), int8 k [B*Hkv, tk_pad, D] (the per-KV-head mean
//   over the valid keys removed, one scale per KV head, padded keys 0), rowc = (qs * ks)
//   * scale per row, and, for f32 v only, a bf16 copy of v in its own layout. Every
//   division is a true division, every rounding half to even, codes clipped to +-127.
//   The K mean is a fixed-order sum: 256-key partial column sums (launch 1), added in
//   key order by every block that needs them (launch 2, which also takes the absmax of
//   k - mean per 256 keys); launch 3 quantizes q and k. No float atomics.
//
// af_flash_attention_a8 (the body):
//   s = int32(q_i8 . k_i8^T) * rowc[row]; keys >= kv_len and, under causal masking, keys
//   > row + q_offset masked; online softmax whose running max m advances once per
//   bk-key tile (JAX's tile); p = exp(s - m) rounded to bf16 for P.V with f32
//   accumulation, l summing the unrounded p; o = acc / max(l, 1e-30) in q's dtype. A row
//   with no visible key gives o = 0. v is bf16 and read in place through its strides.
//
// Design of the body: one block of 4 warps per 64-row q tile of one head; each warp owns
// 16 rows and keeps Q's int8 fragments in registers; 2-3 blocks share an SM. The grid
// runs the H / Hkv q heads of one KV head side by side (blockIdx.x), then the KV heads,
// then the q tiles heaviest first, so that the heads of a GQA group read their K and V
// from L2. K and V stream through one cp.async job queue kept 3 chunks (64 keys each)
// ahead in a 4-slot ring: sweep 1's jobs are K chunks, sweep 2's K and V chunks; one
// barrier a chunk. Sweep 1 takes each row's tile maximum on the exact int32 scores (|s|
// <= 127^2 D < 2^24): float(s) * rowc rounds monotonically in s, so the float maximum is
// float(max s) * rowc for rowc >= 0 and float(min s) * rowc for rowc < 0 (one XOR per
// score picks the side), bit-equal to the maximum of the rounded scores, with no
// conversion or product per score. Sweep 2 recomputes the scores, forms p and runs P.V.
// QK^T is mma.sync m16n8k32 s8.s8.s32 (exact); P.V is mma.sync m16n8k16 bf16 with f32
// accumulation, P packed from the score registers and V's fragments from
// ldmatrix.trans. A warp skips chunks past its rows' causal limit and masks only chunks
// that cross it. No float atomics: replays are bit-identical.
// Departures from the design first planned, on measurements (PERF.md, K8 rows): a body
// that kept the whole bk tile of K in shared memory for both sweeps (128 rows, 8 warps,
// one block per SM, the next chunk's scores overlapped with this chunk's P.V) was slower
// than this one at all five shapes of chip_smoke.py phase 10a: one block per SM left the
// tensor cores waiting on each chunk's score-exp-P.V chain. Unpadded, swizzled rings with
// 3-4 blocks per SM won at some shapes and lost at others, so the padded rings stay. int8
// wgmma was not brought up; mma.sync keeps the exact int32 scores.
//
// Bound on the H100 at the main-path shapes: int8 QK^T ops at 1979 TOPS plus bf16 P.V
// FLOPs at 989 TFLOP/s, 2 B H D per visible pair each: encoder [1,1500,20,64]
// non-causal 8.7 us ([20,1500,20,64]: 0.175 ms); LM [1,1024,28,128] causal 5.7 us,
// [1,16384,28,128] causal 1.46 ms. The prelude is bytes: q, k read once, codes and rowc
// written once (f32 v: v read and its bf16 copy written). What is left: QK^T computed
// twice (sweep 1 only for the maxima), K read from L2 twice, mma.sync with 16 rows a
// warp (each B fragment feeds one MMA), a block barrier a chunk; wgmma with a producer
// warp and mbarriers is the next step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"   // mma_bf16, ldmatrix_x4_trans, cp_async16, load_tile_async, ...

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;     // query rows per block (BLOCK_ROWS in the wrapper)
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 64;              // keys per chunk
constexpr int kAhead = 3;              // chunks in flight ahead of the one consumed
constexpr int kStages = kAhead + 1;    // ring slots (RING_STAGES)

template <int D> constexpr int kKStride = D + 16;   // bytes per K row in shared memory
template <int D> constexpr int kVBytes = kStages * kKeys * kLd<D> * 2;
template <int D> constexpr int kSmem = kVBytes<D> + kStages * kKeys * kKStride<D>;

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int quad_max_i(int x) {
  x = max(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return max(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

template <typename T> __device__ __forceinline__ void store2(T* p, float a, float b);
template <> __device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a,
                                                                  float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 64 int8 K rows (contiguous, D bytes each) into shared memory (row stride D + 16)
template <int D>
__device__ __forceinline__ void load_k_chunk(int8_t* dst, const int8_t* src, int tid) {
  constexpr int C = D / 16;   // 16-byte chunks per row
  static_assert(kKeys * C % kThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int j = 0; j < kKeys * C / kThreads; ++j) {
    const int i = tid + j * kThreads;
    const int r = i / C, c = i % C;
    cp_async16(dst + r * kKStride<D> + 16 * c, src + (int64_t)r * D + 16 * c, true);
  }
}

// int32 scores of this warp's 16 rows against 64 keys in shared memory:
// s[j] holds keys 8 j + 2 tig (+1) for rows gq (s[j][0..1]) and gq + 8 (s[j][2..3])
template <int D>
__device__ __forceinline__ void scores(int (&s)[8][4], const int8_t* sk,
                                       const uint32_t (&qf)[D / 32][4], int gq, int tig) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0;
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      const int8_t* kr = sk + (8 * j + gq) * kKStride<D> + 32 * kk + 4 * tig;
      mma_s8(s[j], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
             *reinterpret_cast<const uint32_t*>(kr + 16));
    }
  }
}

// grid (H / Hkv, B * Hkv, ceil(Tq / kRows)); dynamic shared memory kSmem<D>
template <typename TO, int D>
__global__ void __launch_bounds__(kThreads, 2)
fa8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, const float* __restrict__ rowc,
           TO* __restrict__ o, int H, int Hkv, int Tq, int tq_pad, int tk_pad, int kv_len,
           int bk, int causal, int q_offset, int64_t sob, int64_t sot, int64_t soh,
           int64_t svb, int64_t svt, int64_t svh) {
  constexpr int NT = D / 8;     // 8-wide output column tiles
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* sv = reinterpret_cast<__nv_bfloat16*>(smem);
  int8_t* sk = reinterpret_cast<int8_t*>(smem + kVBytes<D>);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tig = lane & 3;
  const int bkv = blockIdx.y, b = bkv / Hkv, kvh = bkv % Hkv;
  const int h = kvh * (H / Hkv) + blockIdx.x;
  const int bh = b * H + h;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;   // heaviest causal tiles first
  const int wr0 = q0 + warp * 16;                        // this warp's first row
  const int ra = wr0 + gq, rb = ra + 8;                  // this thread's rows (padded index)

  uint32_t qf[D / 32][4];
  {
    const int8_t* pa = q + ((int64_t)bh * tq_pad + ra) * D + 4 * tig;
    const int8_t* pb = pa + 8 * D;
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(pa + 32 * kk);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(pb + 32 * kk);
      qf[kk][2] = *reinterpret_cast<const uint32_t*>(pa + 32 * kk + 16);
      qf[kk][3] = *reinterpret_cast<const uint32_t*>(pb + 32 * kk + 16);
    }
  }
  const float ca = rowc[(int64_t)bh * tq_pad + ra];
  const float cb = rowc[(int64_t)bh * tq_pad + rb];
  // the tile maximum of float(s) * c is float(max s) * c for c >= 0, float(min s) * c
  // for c < 0: scores XOR -1 (= -s - 1) turn the minimum into a maximum
  const int xa = ca < 0.f ? -1 : 0, xb = cb < 0.f ? -1 : 0;
  // last visible key of each row; keys <= wfull are visible to all 16 rows of the warp,
  // keys past wlast to none; kv_end is the block's causal frontier
  const int lim_a = causal ? min(kv_len - 1, ra + q_offset) : kv_len - 1;
  const int lim_b = causal ? min(kv_len - 1, rb + q_offset) : kv_len - 1;
  const int wfull = causal ? min(kv_len - 1, wr0 + q_offset) : kv_len - 1;
  const int wlast = causal ? min(kv_len - 1, wr0 + 15 + q_offset) : kv_len - 1;
  int kv_end = kv_len;
  if (causal) {
    const long long lim = (long long)q0 + kRows + q_offset;
    if (lim < kv_end) kv_end = lim > 0 ? (int)lim : 0;
  }
  const int8_t* kb = k + (int64_t)bkv * tk_pad * D;
  const __nv_bfloat16* vb = v + b * svb + kvh * svh;

  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int s[8][4];
  for (int t0 = 0; t0 < kv_end; t0 += bk) {
    const int nch = (min(t0 + bk, kv_end) - t0 + kKeys - 1) / kKeys;
    __syncthreads();   // the previous tile's K and V are consumed
    // job j < nch: K chunk j (sweep 1); nch <= j < 2 nch: K and V chunk j - nch (sweep
    // 2); job j's chunks take ring slot j % kStages
    auto fetch = [&](int j) {
      if (j < 2 * nch) {
        const int c = j < nch ? j : j - nch;
        load_k_chunk<D>(sk + (j % kStages) * kKeys * kKStride<D>,
                        kb + (int64_t)(t0 + c * kKeys) * D, tid);
        if (j >= nch)
          load_tile_async<D, kThreads>(sv + (j % kStages) * kKeys * kLd<D>, vb, svt,
                                       t0 + c * kKeys, kv_len, tid);
      }
      cp_async_commit();
    };
    auto k_at = [&](int j) { return sk + (j % kStages) * kKeys * kKStride<D>; };
#pragma unroll
    for (int j = 0; j < kAhead; ++j) fetch(j);

    // sweep 1: each row's tile maximum on the int32 scores
    int ta = INT_MIN, tb = INT_MIN;
    for (int c = 0; c < nch; ++c) {
      cp_async_wait<kAhead - 1>();
      __syncthreads();   // job c has landed for every thread
      fetch(c + kAhead);
      const int c0 = t0 + c * kKeys;
      if (c0 > wlast) continue;
      scores<D>(s, k_at(c), qf, gq, tig);
      if (c0 + kKeys - 1 <= wfull) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            ta = max(ta, s[j][e] ^ xa);
            tb = max(tb, s[j][2 + e] ^ xb);
          }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = c0 + 8 * j + 2 * tig + e;
            if (key <= lim_a) ta = max(ta, s[j][e] ^ xa);
            if (key <= lim_b) tb = max(tb, s[j][2 + e] ^ xb);
          }
      }
    }
    ta = quad_max_i(ta);
    tb = quad_max_i(tb);
    const float mx_a = ta == INT_MIN ? -INFINITY : __fmul_rn((float)(ta ^ xa), ca);
    const float mx_b = tb == INT_MIN ? -INFINITY : __fmul_rn((float)(tb ^ xb), cb);
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    // no visible key yet: p = 0 and alpha = 0 instead of NaN
    const float mu_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float mu_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float al_a = expf(m_a - mu_a), al_b = expf(m_b - mu_b);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= al_a;
      acc[n][1] *= al_a;
      acc[n][2] *= al_b;
      acc[n][3] *= al_b;
    }

    // sweep 2: the scores again, p against the tile's max, l, P.V
    float rs_a = 0.f, rs_b = 0.f;
    for (int c = 0; c < nch; ++c) {
      cp_async_wait<kAhead - 1>();
      __syncthreads();   // K and V chunk c have landed; the slot refilled below is free
      fetch(nch + c + kAhead);
      const int c0 = t0 + c * kKeys;
      if (c0 > wlast) continue;
      scores<D>(s, k_at(nch + c), qf, gq, tig);
      const bool full = c0 + kKeys - 1 <= wfull;
      // p as the bf16 A fragments of P.V (16 keys a k-step), l summing the unrounded p
      uint32_t pa[kKeys / 16][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = c0 + 8 * j + 2 * tig + e;
          p[e] = full || key <= lim_a
                     ? expf(__fsub_rn(__fmul_rn((float)s[j][e], ca), mu_a)) : 0.f;
          p[2 + e] = full || key <= lim_b
                         ? expf(__fsub_rn(__fmul_rn((float)s[j][2 + e], cb), mu_b)) : 0.f;
          rs_a += p[e];
          rs_b += p[2 + e];
        }
        pa[j >> 1][2 * (j & 1)] = pack_bf16(p[0], p[1]);
        pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(p[2], p[3]);
      }
      const __nv_bfloat16* svc = sv + ((nch + c) % kStages) * kKeys * kLd<D>;
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        const int mi = lane >> 3;
        const __nv_bfloat16* vrow = svc + (16 * kk + (mi & 1) * 8 + (lane & 7)) * kLd<D>
                                    + 8 * (mi >> 1);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, vrow + 16 * np);
          mma_bf16(acc[2 * np], pa[kk], r[0], r[1]);
          mma_bf16(acc[2 * np + 1], pa[kk], r[2], r[3]);
        }
      }
    }
    rs_a = quad_sum(rs_a);
    rs_b = quad_sum(rs_b);
    l_a = __fadd_rn(__fmul_rn(l_a, al_a), rs_a);
    l_b = __fadd_rn(__fmul_rn(l_b, al_b), rs_b);
    m_a = mn_a;
    m_b = mn_b;
  }
  cp_async_wait<0>();

  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  TO* oa = o + b * sob + (int64_t)ra * sot + h * soh + 2 * tig;
  TO* ob = o + b * sob + (int64_t)rb * sot + h * soh + 2 * tig;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (ra < Tq) store2<TO>(oa + 8 * n, acc[n][0] / den_a, acc[n][1] / den_a);
    if (rb < Tq) store2<TO>(ob + 8 * n, acc[n][2] / den_b, acc[n][3] / den_b);
  }
}

template <typename TO, int D>
int launch(const void* q, const void* k, const void* v, const void* rowc, void* o, int B,
           int H, int Hkv, int Tq, int tq_pad, int tk_pad, int kv_len, int bk, int causal,
           int q_offset, int64_t sob, int64_t sot, int64_t soh, int64_t svb, int64_t svt,
           int64_t svh, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fa8_kernel<TO, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem<D>);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H / Hkv, B * Hkv, (Tq + kRows - 1) / kRows);
  fa8_kernel<TO, D><<<grid, kThreads, kSmem<D>, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(rowc),
      static_cast<TO*>(o), H, Hkv, Tq, tq_pad, tk_pad, kv_len, bk, causal, q_offset, sob,
      sot, soh, svb, svt, svh);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- the prelude

constexpr int kPreThreads = 256;
constexpr int kPreKeys = 256;      // keys per partial-sum block (PRELUDE_KEYS in the wrapper)
constexpr int kCodeRows = 64;      // k rows per code block (CODE_ROWS)
constexpr int kQRows = kPreThreads / 32;   // q rows per code block, a warp each (Q_ROWS)

struct PreArgs {
  const void* q;
  const void* k;
  const void* v;
  int8_t* q_i8;
  int8_t* k_i8;
  __nv_bfloat16* v16;    // null unless v is f32
  float* rowc;
  float* qs;
  float* ks;
  float* ksum;           // [B*Hkv, nchunk, D] partial column sums of k
  float* kmax;           // [B*Hkv, nchunk] partial max |k - mean|
  float* kmean;          // [B*Hkv, D]
  int B, Tq, H, Hkv, Tk, tq_pad, tk_pad, nchunk, q_blocks;
  int64_t sqb, sqt, sqh, skb, skt, skh, svb, svt, svh;
  float scale;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ int8_t to_code(float x, float s) {
  return (int8_t)(int)fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f);
}

// launch 1, grid (nchunk, B*Hkv): column sums of k over keys [256 j, 256 j + 256), each
// thread's keys in order, then the thread lanes in order
template <typename T, int D>
__global__ void __launch_bounds__(kPreThreads) fa8_ksum_kernel(PreArgs a) {
  constexpr int kLanes = kPreThreads / D;
  __shared__ float red[kPreThreads];
  const int bkv = blockIdx.y, b = bkv / a.Hkv, kvh = bkv % a.Hkv;
  const int d = threadIdx.x % D, r = threadIdx.x / D;
  const int t1 = min((int)(blockIdx.x + 1) * kPreKeys, a.Tk);
  const T* kp = static_cast<const T*>(a.k) + b * a.skb + kvh * a.skh + d;
  float s = 0.f;
  for (int t = blockIdx.x * kPreKeys + r; t < t1; t += kLanes) s += ld(kp + t * a.skt);
  red[threadIdx.x] = s;
  __syncthreads();
  if (r == 0) {
    float acc = red[d];
#pragma unroll
    for (int i = 1; i < kLanes; ++i) acc += red[i * D + d];
    a.ksum[((int64_t)bkv * a.nchunk + blockIdx.x) * D + d] = acc;
  }
}

// launch 2, grid (nchunk, B*Hkv): mean = (the partial sums added in key order) / Tk, and
// the max of |k - mean| over the block's 256 keys (block 0 keeps the mean)
template <typename T, int D>
__global__ void __launch_bounds__(kPreThreads) fa8_kmax_kernel(PreArgs a) {
  constexpr int kLanes = kPreThreads / D;
  __shared__ float red[kPreThreads];
  const int bkv = blockIdx.y, b = bkv / a.Hkv, kvh = bkv % a.Hkv;
  const int d = threadIdx.x % D, r = threadIdx.x / D;
  const float* ps = a.ksum + (int64_t)bkv * a.nchunk * D + d;
  float mean = 0.f;
  for (int j = 0; j < a.nchunk; ++j) mean += ps[(int64_t)j * D];
  mean = __fdiv_rn(mean, (float)a.Tk);
  if (blockIdx.x == 0 && r == 0) a.kmean[(int64_t)bkv * D + d] = mean;
  const int t1 = min((int)(blockIdx.x + 1) * kPreKeys, a.Tk);
  const T* kp = static_cast<const T*>(a.k) + b * a.skb + kvh * a.skh + d;
  float mx = 0.f;
  for (int t = blockIdx.x * kPreKeys + r; t < t1; t += kLanes)
    mx = fmaxf(mx, fabsf(__fsub_rn(ld(kp + t * a.skt), mean)));
  red[threadIdx.x] = mx;
  __syncthreads();
  for (int w = kPreThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] = fmaxf(red[threadIdx.x], red[threadIdx.x + w]);
    __syncthreads();
  }
  if (threadIdx.x == 0) a.kmax[(int64_t)bkv * a.nchunk + blockIdx.x] = red[0];
}

// ks of KV head bkv = max(max |k - mean|, 1e-6) / 127 (every lane of the warp gets it)
__device__ __forceinline__ float kv_scale(const PreArgs& a, int bkv, int lane) {
  float mx = 0.f;
  for (int j = lane; j < a.nchunk; j += 32) mx = fmaxf(mx, a.kmax[(int64_t)bkv * a.nchunk + j]);
  return __fdiv_rn(fmaxf(warp_max(mx), 1e-6f), 127.f);
}

// launch 3, grid (q_blocks + k_blocks): blocks [0, q_blocks) quantize 8 q rows (a warp a
// row of the output [B*H, tq_pad]), the rest 64 k rows of one KV head (and copy v to bf16
// where v is f32)
template <typename T, int D>
__global__ void __launch_bounds__(kPreThreads) fa8_codes_kernel(PreArgs a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = a.H / a.Hkv;
  if ((int)blockIdx.x < a.q_blocks) {
    const int64_t row = (int64_t)blockIdx.x * kQRows + warp;
    if (row >= (int64_t)a.B * a.H * a.tq_pad) return;
    const int bh = (int)(row / a.tq_pad), t = (int)(row % a.tq_pad);
    const int b = bh / a.H, h = bh % a.H;
    float x[D / 32];
    float amax = 0.f;
    const T* qp = static_cast<const T*>(a.q) + b * a.sqb + (int64_t)t * a.sqt + h * a.sqh;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      x[i] = t < a.Tq ? ld(qp + lane + 32 * i) : 0.f;
      amax = fmaxf(amax, fabsf(x[i]));
    }
    const float qs = __fdiv_rn(fmaxf(warp_max(amax), 1e-6f), 127.f);
#pragma unroll
    for (int i = 0; i < D / 32; ++i) a.q_i8[row * D + lane + 32 * i] = to_code(x[i], qs);
    const float ks = kv_scale(a, b * a.Hkv + h / group, lane);
    if (lane == 0) {
      a.qs[row] = qs;
      a.rowc[row] = __fmul_rn(__fmul_rn(qs, ks), a.scale);
    }
    return;
  }
  __shared__ float s_ks;
  const int per_head = a.tk_pad / kCodeRows;
  const int kb = blockIdx.x - a.q_blocks;
  const int bkv = kb / per_head, row0 = (kb % per_head) * kCodeRows;
  const int b = bkv / a.Hkv, kvh = bkv % a.Hkv;
  if (warp == 0) {
    const float ks = kv_scale(a, bkv, lane);
    if (lane == 0) {
      s_ks = ks;
      if (row0 == 0) a.ks[bkv] = ks;
    }
  }
  __syncthreads();
  const float ks = s_ks;
  const T* kp = static_cast<const T*>(a.k) + b * a.skb + kvh * a.skh;
  const T* vp = static_cast<const T*>(a.v) + b * a.svb + kvh * a.svh;
  const float* mean = a.kmean + (int64_t)bkv * D;
  for (int i = threadIdx.x; i < kCodeRows * D; i += kPreThreads) {
    const int r = i / D, d = i % D, t = row0 + r;
    int8_t c = 0;
    if (t < a.Tk) {
      c = to_code(__fsub_rn(ld(kp + t * a.skt + d), mean[d]), ks);
      if (a.v16 != nullptr)
        a.v16[(((int64_t)b * a.Tk + t) * a.Hkv + kvh) * D + d] =
            __float2bfloat16(ld(vp + t * a.svt + d));
    }
    a.k_i8[((int64_t)bkv * a.tk_pad + t) * D + d] = c;
  }
}

template <typename T, int D>
int prelude(const PreArgs& a, cudaStream_t stream) {
  const dim3 grid(a.nchunk, a.B * a.Hkv);
  fa8_ksum_kernel<T, D><<<grid, kPreThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fa8_kmax_kernel<T, D><<<grid, kPreThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int k_blocks = a.B * a.Hkv * (a.tk_pad / kCodeRows);
  fa8_codes_kernel<T, D><<<a.q_blocks + k_blocks, kPreThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The prelude. q [B, Tq, H, D], k and v [B, Tk, Hkv, D] (dtype 0 = f32, 1 = bf16; the
// last dim contiguous, the others through the strides sq*, sk*, sv* in elements). Writes
// q_i8 [B*H, tq_pad, D], k_i8 [B*Hkv, tk_pad, D], rowc and qs [B*H, tq_pad], ks [B*Hkv]
// and, when v16 is not null (f32 v), v as bf16 [B, Tk, Hkv, D]; scratch ksum [B*Hkv,
// nchunk, D], kmax [B*Hkv, nchunk], kmean [B*Hkv, D] f32 with nchunk = ceil(Tk / 256).
// Returns a cudaError_t (0 on success); cudaErrorInvalidValue for a geometry it does not
// take.
extern "C" int af_fa8_prelude(const void* q, const void* k, const void* v, void* q_i8,
                              void* k_i8, void* v16, void* rowc, void* qs, void* ks,
                              void* ksum, void* kmax, void* kmean, int dtype, int B, int Tq,
                              int H, int Hkv, int D, int Tk, int tq_pad, int tk_pad,
                              int nchunk, int64_t sqb, int64_t sqt, int64_t sqh, int64_t skb,
                              int64_t skt, int64_t skh, int64_t svb, int64_t svt,
                              int64_t svh, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Tq <= 0 || Tq > tq_pad || Tk <= 0 ||
      Tk > tk_pad || tk_pad % kCodeRows != 0 || nchunk != (Tk + kPreKeys - 1) / kPreKeys ||
      B * Hkv > 65535 || (dtype != 0 && dtype != 1) || (dtype == 1 && v16 != nullptr))
    return (int)cudaErrorInvalidValue;
  const int64_t q_rows = (int64_t)B * H * tq_pad;
  PreArgs a{q, k, v, static_cast<int8_t*>(q_i8), static_cast<int8_t*>(k_i8),
            static_cast<__nv_bfloat16*>(v16), static_cast<float*>(rowc),
            static_cast<float*>(qs), static_cast<float*>(ks), static_cast<float*>(ksum),
            static_cast<float*>(kmax), static_cast<float*>(kmean), B, Tq, H, Hkv, Tk,
            tq_pad, tk_pad, nchunk, (int)((q_rows + kQRows - 1) / kQRows), sqb, sqt, sqh,
            skb, skt, skh, svb, svt, svh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return prelude<float, 64>(a, s);
  if (dtype == 0 && D == 128) return prelude<float, 128>(a, s);
  if (dtype == 1 && D == 64) return prelude<__nv_bfloat16, 64>(a, s);
  if (dtype == 1 && D == 128) return prelude<__nv_bfloat16, 128>(a, s);
  return (int)cudaErrorInvalidValue;
}

// The body. q_i8 [B*H, tq_pad, D], k_i8 [B*Hkv, tk_pad, D] int8, rowc [B*H, tq_pad] f32
// (contiguous); v bf16 through its strides (element (b, t, kvh) at b svb + t svt + kvh svh,
// rows 16-byte aligned; keys at or past kv_len are not read); o [B, Tq, H, D] through the
// caller's strides. out_dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on
// success); cudaErrorInvalidValue for a dtype, head dim or geometry the kernel does not
// take (a bk tile whose K does not fit in shared memory among them).
extern "C" int af_flash_attention_a8(const void* q, const void* k, const void* v,
                                     const void* rowc, void* o, int out_dtype, int B, int H,
                                     int Hkv, int D, int Tq, int tq_pad, int tk_pad,
                                     int kv_len, int bk, int causal, int q_offset,
                                     int64_t sob, int64_t sot, int64_t soh, int64_t svb,
                                     int64_t svt, int64_t svh, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || B * Hkv > 65535 || Tq <= 0 ||
      Tq > tq_pad || tq_pad % kRows != 0 || (Tq + kRows - 1) / kRows > 65535 ||
      kv_len <= 0 || kv_len > tk_pad || bk <= 0 || bk % kKeys != 0 || tk_pad % bk != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0 || svb % 8 != 0 || svt % 8 != 0 ||
      svh % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AF_FA8_ARGS q, k, v, rowc, o, B, H, Hkv, Tq, tq_pad, tk_pad, kv_len, bk, causal, \
                    q_offset, sob, sot, soh, svb, svt, svh, s
  if (out_dtype == 0 && D == 64) return launch<float, 64>(AF_FA8_ARGS);
  if (out_dtype == 0 && D == 128) return launch<float, 128>(AF_FA8_ARGS);
  if (out_dtype == 1 && D == 64) return launch<__nv_bfloat16, 64>(AF_FA8_ARGS);
  if (out_dtype == 1 && D == 128) return launch<__nv_bfloat16, 128>(AF_FA8_ARGS);
#undef AF_FA8_ARGS
  return (int)cudaErrorInvalidValue;
}
