// Flash-attention forward (K2) for Hopper (sm_90a), plain C interface bound with ctypes.
//
// Replaces the Pallas TPU kernel audio_flamingo_tpu/ops/pallas/flash_attention.py
// (`_flash_forward` :258, kernel `_flash_kernel`): tiled online-softmax attention, GQA by
// head index, causal masking with a q offset, keys past Tk masked in the kernel, f32
// softmax statistics and accumulator, output `o` in the input dtype plus the per-row
// log-sum-exp in f32 laid out [B, Tq, H].
//
// Layout: q [B, Tq, H, D], k/v [B, Tk, Hkv, D], o like q, all read and written through
// the caller's strides (the last dim must be contiguous), so no transposed copies.
//
// Numerics (both routes, as flash_attention_reference): s = (q . k) in f32, times scale
// after the sum; the running max m advances once per 64-key tile (KV_TILE); p = exp(s - m)
// in f32; the row sum l adds the unrounded p while P.V takes p rounded to the input dtype
// (the JAX kernel's p.astype(q.dtype) at block_k = 64; exact in f32); o = acc / l. A row
// that sees no key gives o = 0 and lse = -inf (the port's convention).
//
// Two routes, chosen by dtype:
// - bf16: `flash_fwd_mma_kernel`, on the tensor cores. One block of 4 warps per (64 q
//   rows, q head, batch); each warp owns 16 rows. The Q tile stays in shared memory and
//   its A-fragments are read by ldmatrix at each k-step (held in registers they would take
//   32 a thread at D = 128, beside O's 64 and the scores' 32). K and V tiles of 64 keys go
//   through a 2-stage ring in shared memory filled by 16-byte cp.async copies, so tile
//   t + 1 loads while tile t computes (rows padded by 16 bytes: ldmatrix without bank
//   conflicts; 85 KB at D = 128 with a 16 KB scratch, dynamic shared memory). S = Q K^T by
//   mma.sync m16n8k16 bf16 with f32 accumulation (K's B-fragments by ldmatrix); O += P V
//   with P converted in registers from the S accumulators, which are already in the
//   A-fragment layout, and V's fragments by ldmatrix.trans; O stays in f32 registers. Row
//   max and row sum reduce over the 4 lanes that share a row. Only tiles that cross the
//   causal frontier, Tk or Tq are masked; tiles past the block's frontier are skipped; the
//   heaviest causal q tiles are scheduled first. The epilogue stages o / l in shared
//   memory for coalesced 16-byte stores.
// - f32: `flash_fwd_kernel`, on the CUDA cores (f32 FMAs, tiles staged in shared memory
//   as f32). TF32 tensor cores would round q, k and p to 10 mantissa bits and break the
//   2e-5 f32 agreement with the CPU that the f32 card-vs-CPU checks rest on.
//
// Rounding in bf16. P.V takes p rounded to bf16, so a p that lies near a bf16 rounding
// edge rounds the other way when its score moves by an f32 ulp, and moves o by one bf16
// step of p v / l: past the bf16 tolerance (one bf16 step of o) where p carries much of a
// row. The plain version's scores come from an f32 product that adds d = 0 .. D - 1 one
// fmaf at a time (bit for bit on the H100), which no tensor-core sum reproduces: even
// exact scores break the tolerance on peaked rows (measured). So:
// - the tensor-core scores (within 1.2 x 2^-18 (|s| + 1) of the plain ones, measured at
//   score deviations 1-8) give p = exp(s - m) by one ex2.approx, with the plain version's
//   roundings of s * scale and s - m (__fmul_rn / __fsub_rn: never contracted to an fma);
// - two kinds of score are recomputed by that sequential f32 sum from the tiles in shared
//   memory, two at a time per lane, and their p by expf (torch's exp, bit for bit): those
//   that could set the running max, so that m is the plain version's bit for bit, and
//   those whose p carries 1/128 or more of the row sum so far and lies within the error
//   bound of a rounding edge. At the main-path shapes on random inputs that is about
//   0.3 % and 0.05 % of the scores, yet it takes 39-56 % of the kernel's time there
//   (scripts/torch_flash_rounding.py switches it off to measure): a lane's 64- or 128-long
//   dependent fmaf chain holds its block at the next barrier. Where the plain version's
//   order is no longer the reference, this can go.
// Both facts this rests on were measured, not documented: that cuBLAS's f32 product sums
// in that order, and err_bound below. `af_flash_scores` gives both sums of every pair, so
// that a check on the card can hold them before it holds the output to its tolerance.
//
// Bound on the H100 at the main-path shapes: bf16 tensor-core FLOPs, 4 B H D per visible
// (row, key) pair at 989 TFLOP/s. Encoder [1,1500,20,64] 11.6 us ([20,1500,20,64]: 0.233
// ms); LM prefill [1,1024,28,128] causal 7.6 us, [1,16384,28,128] causal 1.946 ms. The
// design keeps the [Tq, Tk] scores out of device memory and feeds the tensor cores from
// a prefetched ring; mma.sync reaches about two thirds of the tensor cores' peak at best,
// and exp, the row statistics and the exact scores share the warps' issue slots with it.
// Left for later: wgmma (a warpgroup's 64-row product from shared memory) with a TMA-fed
// ring and warp specialisation (a producer warp, two consumer warpgroups ping-ponging
// softmax and products).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

// ---------------------------------------------------------------- f32: CUDA cores

constexpr int kBQ = 64;       // q rows per block
constexpr int kBK = 64;       // keys per K/V tile
constexpr int kThreads = 256;
constexpr int kPS = kBK + 4;  // P row stride (floats): 16-byte aligned rows

template <int D>
constexpr size_t smem_floats() {
  // Q and K rows padded by 4 floats (keeps 16-byte alignment, spreads banks), V unpadded.
  return (size_t)kBQ * (D + 4) + (size_t)kBK * (D + 4) + (size_t)kBK * D + (size_t)kBQ * kPS;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int Tq, int Tk, int H, int group,
                 int64_t sqb, int64_t sqt, int64_t sqh,
                 int64_t skb, int64_t skt, int64_t skh,
                 int64_t svb, int64_t svt, int64_t svh,
                 int64_t sob, int64_t sot, int64_t soh,
                 float scale, int causal, int q_offset) {
  static_assert(D % 64 == 0, "head dim must be a multiple of 64");
  constexpr int QS = D + 4;   // Q/K row stride in floats
  constexpr int NC = D / 64;  // float4 output groups per row per thread

  extern __shared__ __align__(16) float smem[];
  float* sq = smem;              // [kBQ][QS]
  float* sk = sq + kBQ * QS;     // [kBK][QS]
  float* sv = sk + kBK * QS;     // [kBK][D]
  float* sp = sv + kBK * D;      // [kBQ][kPS]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;

  const float* qb = q + b * sqb + h * sqh;
  const float* kb = k + b * skb + hk * skh;
  const float* vb = v + b * svb + hk * svh;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int t = q0 + r;
    sq[r * QS + c] = t < Tq ? qb[t * sqt + c] : 0.f;
  }

  // keys this block can see: all of [0, Tk), or under causal masking up to the
  // last row's frontier q0 + kBQ - 1 + q_offset
  int kv_end = Tk;
  if (causal) {
    const long long lim = (long long)q0 + kBQ + q_offset;
    if (lim < kv_end) kv_end = lim > 0 ? (int)lim : 0;
  }

  float m[4], l[4];
  float4 acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // previous tile's K, V and P are no longer read
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const int t = k0 + r;
      const bool in = t < Tk;
      sk[r * QS + c] = in ? kb[t * skt + c] : 0.f;
      sv[r * D + c] = in ? vb[t * svt + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;

#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&sq[(ty + 16 * i) * QS + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&sk[(tx + 16 * j) * QS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < Tk && (!causal || (long long)col <= (long long)row + q_offset);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // no visible key yet: keep p = 0 instead of exp(-inf - -inf) = NaN
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_use);
        s[i][j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[i][c].x *= alpha;
        acc[i][c].y *= alpha;
        acc[i][c].z *= alpha;
        acc[i][c].w *= alpha;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) sp[(ty + 16 * i) * kPS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    // masked keys have p = 0 and zeroed V rows, so the whole tile is summed
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&sp[(ty + 16 * i) * kPS + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(&sv[(j + jj) * D + 4 * tx + 64 * c]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y : jj == 2 ? pv[i].z : pv[i].w;
            acc[i][c].x = fmaf(p, vv.x, acc[i][c].x);
            acc[i][c].y = fmaf(p, vv.y, acc[i][c].y);
            acc[i][c].z = fmaf(p, vv.z, acc[i][c].z);
            acc[i][c].w = fmaf(p, vv.w, acc[i][c].w);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tq) continue;
    const bool any = l[i] > 0.f;
    float* orow = o + b * sob + row * sot + h * soh;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = 4 * tx + 64 * c;
      orow[d + 0] = any ? acc[i][c].x / l[i] : 0.f;
      orow[d + 1] = any ? acc[i][c].y / l[i] : 0.f;
      orow[d + 2] = any ? acc[i][c].z / l[i] : 0.f;
      orow[d + 3] = any ? acc[i][c].w / l[i] : 0.f;
    }
    if (tx == 0) lse[((int64_t)b * Tq + row) * H + h] = any ? m[i] + logf(l[i]) : -INFINITY;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse,
               int B, int Tq, int Tk, int H, int Hkv,
               int64_t sqb, int64_t sqt, int64_t sqh,
               int64_t skb, int64_t skt, int64_t skh,
               int64_t svb, int64_t svt, int64_t svh,
               int64_t sob, int64_t sot, int64_t soh,
               float scale, int causal, int q_offset, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Tq, Tk, H, H / Hkv,
      sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh,
      scale, causal, q_offset);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- bf16: tensor cores

constexpr int kMmaRows = 64;      // q rows per block: 4 warps x 16
constexpr int kMmaKeys = 64;      // keys per K/V tile (KV_TILE): the running max's step
constexpr int kMmaThreads = 128;

// Bound on |s - s_plain| (after the scale) of a tensor-core score against the plain
// version's f32 score, per unit of |s| + 1. Measured on an H100 at score deviations 1-8,
// D = 64 and 128: at most 1.2 x 2^-18 (|s| + 1); this allows 3x that.
__device__ __forceinline__ float err_bound(float s) { return (fabsf(s) + 1.f) * (1.f / 65536.f); }

// Built with -DAF_FLASH_RECOMPUTE=0, the bf16 route skips the recomputed scores below:
// faster, and outside its tolerance on peaked rows (scripts/torch_flash_rounding.py times it)
#ifndef AF_FLASH_RECOMPUTE
#define AF_FLASH_RECOMPUTE 1
#endif

// e^y by one ex2.approx.ftz: relative error 2^-22 plus the rounding of y log2(e)
__device__ __forceinline__ float fast_exp(float y) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(y * 1.4426950408889634f));
  return r;
}

// The plain version's f32 scores (before the scale) of two (q row, key) pairs: the bf16
// inputs widened exactly and summed by one fmaf per element in order d = 0 .. D - 1, as
// the f32 matrix product that forms the plain version's scores does (the same bits on the
// H100). The two chains interleave to hide the FMA latency.
template <int D>
__device__ __forceinline__ void exact_dot2(const __nv_bfloat16* q1, const __nv_bfloat16* k1,
                                           const __nv_bfloat16* q2, const __nv_bfloat16* k2,
                                           float& x1, float& x2) {
  float a1 = 0.f, a2 = 0.f;
#pragma unroll 1
  for (int c = 0; c < D; c += 8) {
    const uint4 u[4] = {*reinterpret_cast<const uint4*>(q1 + c),
                        *reinterpret_cast<const uint4*>(k1 + c),
                        *reinterpret_cast<const uint4*>(q2 + c),
                        *reinterpret_cast<const uint4*>(k2 + c)};
    const uint32_t w[4][4] = {{u[0].x, u[0].y, u[0].z, u[0].w}, {u[1].x, u[1].y, u[1].z, u[1].w},
                              {u[2].x, u[2].y, u[2].z, u[2].w}, {u[3].x, u[3].y, u[3].z, u[3].w}};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // element 2 i in the low half of word i, 2 i + 1 high
      a1 = fmaf(__uint_as_float(w[0][i] << 16), __uint_as_float(w[1][i] << 16), a1);
      a2 = fmaf(__uint_as_float(w[2][i] << 16), __uint_as_float(w[3][i] << 16), a2);
      a1 = fmaf(__uint_as_float(w[0][i] & 0xffff0000u), __uint_as_float(w[1][i] & 0xffff0000u),
                a1);
      a2 = fmaf(__uint_as_float(w[2][i] & 0xffff0000u), __uint_as_float(w[3][i] & 0xffff0000u),
                a2);
    }
  }
  x1 = a1;
  x2 = a2;
}

// For each element i = 4 j + e in `mask` of a warp's score tile s[8][4] (key 8 j + 2 t +
// (e & 1) of the K tile, row g + 8 (e >> 1) of the warp's 16 Q rows `qw`, lane = 4 g + t):
// its exact score times `scale` (with `p`: its p = expf(score - mu) against its row's mu)
// into out[i * kMmaThreads], two at a time, each lane its own elements. `out` is the
// thread's column of a shared [32][kMmaThreads] scratch, so that the registers s[j][e] are
// only ever indexed by constants and this rarely taken code stays small.
template <int D>
__device__ __forceinline__ void exact_scores(uint32_t mask, const __nv_bfloat16* qw,
                                             const __nv_bfloat16* ktile, int lane, float scale,
                                             bool p, float mu_a, float mu_b, float* out) {
  const int g = lane >> 2, t = lane & 3;
  while (mask) {
    const int i1 = __ffs(mask) - 1;
    mask &= mask - 1;
    const int i2 = mask ? __ffs(mask) - 1 : i1;
    mask &= mask - 1;
    float x[2];
    exact_dot2<D>(qw + (g + 4 * (i1 & 2)) * kLd<D>,
                  ktile + (8 * (i1 >> 2) + 2 * t + (i1 & 1)) * kLd<D>,
                  qw + (g + 4 * (i2 & 2)) * kLd<D>,
                  ktile + (8 * (i2 >> 2) + 2 * t + (i2 & 1)) * kLd<D>, x[0], x[1]);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = u ? i2 : i1;
      const float s = __fmul_rn(x[u], scale);
      out[i * kMmaThreads] = p ? expf(__fsub_rn(s, (i & 2) ? mu_b : mu_a)) : s;
    }
  }
}

// A warp's 16 x 64 tile of tensor-core scores (before the scale): s[j] holds keys 8 j + 2 t
// (+1) of rows g (s[j][0..1]) and g + 8 (s[j][2..3]) of the warp's Q rows `qw` against the
// K tile, one f32 accumulator over the k-steps kk = 0 .. D / 16 - 1
template <int D>
__device__ __forceinline__ void tile_scores(float (&s)[8][4], const __nv_bfloat16* qw,
                                            const __nv_bfloat16* ktile, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t qa[4];
    load_a<D>(qa, qw, 0, kk, lane);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t r[4];
      load_b_rows<D>(r, ktile, 16 * np, kk, lane);
      mma_bf16(s[2 * np], qa, r[0], r[1]);
      mma_bf16(s[2 * np + 1], qa, r[2], r[3]);
    }
  }
}

template <int D>
constexpr size_t mma_smem_bytes() {
  // Q, the K and V rings of 2 stages, then the exact scores' [32][kMmaThreads] f32 scratch
  return (size_t)(kMmaRows + 4 * kMmaKeys) * kLd<D> * sizeof(__nv_bfloat16) +
         (size_t)32 * kMmaThreads * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, int Tq, int Tk, int H, int group,
                     int64_t sqb, int64_t sqt, int64_t sqh,
                     int64_t skb, int64_t skt, int64_t skh,
                     int64_t svb, int64_t svt, int64_t svh,
                     int64_t sob, int64_t sot, int64_t soh,
                     float scale, int causal, int q_offset) {
  constexpr int LD = kLd<D>;
  constexpr int ND = D / 8;    // 8-column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [64][LD]
  __nv_bfloat16* sk = sq + kMmaRows * LD;                             // [2][64][LD]
  __nv_bfloat16* sv = sk + 2 * kMmaKeys * LD;                         // [2][64][LD]
  float* scr = reinterpret_cast<float*>(sv + 2 * kMmaKeys * LD) + threadIdx.x;   // column

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  // grid (H, q tiles, B): heads vary fastest and the heaviest causal q tiles go first
  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kMmaRows;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int ra = q0 + warp * 16 + g, rb = ra + 8;   // this thread's two rows

  const __nv_bfloat16* qb = q + b * sqb + h * sqh;
  const __nv_bfloat16* kb = k + b * skb + hk * skh;
  const __nv_bfloat16* vb = v + b * svb + hk * svh;

  int kv_end = Tk;
  if (causal) {
    const long long lim = (long long)q0 + kMmaRows + q_offset;
    if (lim < kv_end) kv_end = lim > 0 ? (int)lim : 0;
  }
  const int n_tiles = (kv_end + kMmaKeys - 1) / kMmaKeys;

  load_tile_async<D, kMmaThreads>(sq, qb, sqt, q0, Tq, tid);
  cp_async_commit();
  if (n_tiles > 0) {
    load_tile_async<D, kMmaThreads>(sk, kb, skt, 0, Tk, tid);
    load_tile_async<D, kMmaThreads>(sv, vb, svt, 0, Tk, tid);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  const __nv_bfloat16* sqw = sq + warp * 16 * LD;   // this warp's 16 rows of Q

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // running max (the plain version's, bit for bit) and row sum of rows ra and rb
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kMmaKeys;
    const int st = it & 1;
    if (it + 1 < n_tiles) {   // the next tile into the other stage, freed by the last sync
      load_tile_async<D, kMmaThreads>(sk + (st ^ 1) * kMmaKeys * LD, kb, skt, k0 + kMmaKeys,
                                      Tk, tid);
      load_tile_async<D, kMmaThreads>(sv + (st ^ 1) * kMmaKeys * LD, vb, svt, k0 + kMmaKeys,
                                      Tk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* skt_ = sk + st * kMmaKeys * LD;
    const __nv_bfloat16* svt_ = sv + st * kMmaKeys * LD;

    // s[j]: keys k0 + 8 j + 2 t4 (+1) of rows ra (s[j][0..1]) and rb (s[j][2..3])
    float s[8][4];
    tile_scores<D>(s, sqw, skt_, lane);

    // rows past Tq are masked too: their zero scores would all tie for the max
    const bool masked = k0 + kMmaKeys > Tk || q0 + kMmaRows > Tq ||
                        (causal && (long long)k0 + kMmaKeys - 1 > (long long)q0 + q_offset);
    float lx_a = -INFINITY, lx_b = -INFINITY;   // this lane's maxima of rows a and b
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[j][e], scale);   // never contracted: the plain version's rounding
        if (masked) {
          const int key = k0 + 8 * j + 2 * t4 + (e & 1);
          const int row = e < 2 ? ra : rb;
          if (key >= Tk || row >= Tq ||
              (causal && (long long)key > (long long)row + q_offset))
            x = -INFINITY;
        }
        s[j][e] = x;
        if (e < 2) lx_a = fmaxf(lx_a, x);
        else lx_b = fmaxf(lx_b, x);
      }
    float mx_a = quad_max(lx_a), mx_b = quad_max(lx_b);

    // The scores that could set the running max, made exact: within the error bound of
    // the old max or of the tile's largest score.
    // (-FLT_MAX at the least: a masked score is never one)
    const float lim_a =
        fmaxf(fmaxf(m_a - err_bound(m_a), mx_a - 2.f * err_bound(mx_a)), -FLT_MAX);
    const float lim_b =
        fmaxf(fmaxf(m_b - err_bound(m_b), mx_b - 2.f * err_bound(mx_b)), -FLT_MAX);
    uint32_t exact = 0;
    if (mx_a >= m_a - err_bound(m_a))   // else the row's max cannot move in this tile
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (s[j][0] >= lim_a) exact |= 1u << (4 * j);
        if (s[j][1] >= lim_a) exact |= 2u << (4 * j);
      }
    if (mx_b >= m_b - err_bound(m_b))
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (s[j][2] >= lim_b) exact |= 4u << (4 * j);
        if (s[j][3] >= lim_b) exact |= 8u << (4 * j);
      }
    if (__any_sync(0xffffffffu, exact)) {   // else the row maxima stand
      if (AF_FLASH_RECOMPUTE && exact) {
        exact_scores<D>(exact, sqw, skt_, lane, scale, false, 0.f, 0.f, scr);
        lx_a = lx_b = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (exact >> (4 * j + e) & 1) s[j][e] = scr[(4 * j + e) * kMmaThreads];
            if (e < 2) lx_a = fmaxf(lx_a, s[j][e]);
            else lx_b = fmaxf(lx_b, s[j][e]);
          }
      }
      mx_a = quad_max(lx_a);
      mx_b = quad_max(lx_b);
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    // no visible key yet: p = 0 and alpha = 0 instead of NaN
    const float mu_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float mu_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float al_a = expf(__fsub_rn(m_a, mu_a)), al_b = expf(__fsub_rn(m_b, mu_b));
    m_a = mn_a;
    m_b = mn_b;
    // p by ex2.approx: within 4e-7 of expf for the p that count (s within 5 of m), far
    // inside the margin below; the p that could round otherwise are redone with expf
    float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = fast_exp(__fsub_rn(s[j][0], mu_a));
      s[j][1] = fast_exp(__fsub_rn(s[j][1], mu_a));
      s[j][2] = fast_exp(__fsub_rn(s[j][2], mu_b));
      s[j][3] = fast_exp(__fsub_rn(s[j][3], mu_b));
      rs_a += s[j][0] + s[j][1];
      rs_b += s[j][2] + s[j][3];
    }

    // A p that carries at least 1/128 of its row's weight (against the row sum of the
    // earlier tiles and this lane's share of this one, a lower bound of the final sum,
    // known without a reduction) and lies within the error bound of a bf16 rounding
    // edge (the low 16 bits of its f32 word near 0x8000): its score made exact and p
    // redone with expf, so it rounds as the plain version's does. Such a p is at least
    // 1/128 of the row max's, so |s| <= |m| + 5 bounds its error, and the margin w is
    // err_bound(|m| + 5) in f32 ulps of p (2^24 a relative unit):
    // |low - 0x8000| < w  <=>  (word + w - 0x8000) mod 2^16 < 2 w.
    const float th_a = (l_a * al_a + rs_a) * (1.f / 128.f);
    const float th_b = (l_b * al_b + rs_b) * (1.f / 128.f);
    const int w_a = (int)fminf(err_bound(fabsf(mu_a) + 5.f) * 16777216.f, 32767.f);
    const int w_b = (int)fminf(err_bound(fabsf(mu_b) + 5.f) * 16777216.f, 32767.f);
    uint32_t fix = 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {   // rows a and b; skipped where even the tile's max p is small
      const float th = r ? th_b : th_a;
      const int w = r ? w_b : w_a;
      if (fast_exp(__fsub_rn(r ? mx_b : mx_a, r ? mu_b : mu_a)) > th)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float pe = s[j][e];
            if (pe > th &&
                (int)((__float_as_uint(pe) + (uint32_t)(w - 0x8000)) & 0xffffu) < 2 * w)
              fix |= 1u << (4 * j + e);
          }
    }
    if (AF_FLASH_RECOMPUTE && fix) {
      exact_scores<D>(fix, sqw, skt_, lane, scale, true, mu_a, mu_b, scr);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (fix >> (4 * j + e) & 1) {
            const float pn = scr[(4 * j + e) * kMmaThreads];
            if (e < 2) rs_a += pn - s[j][e];
            else rs_b += pn - s[j][e];
            s[j][e] = pn;
          }
    }
    l_a = l_a * al_a + quad_sum(rs_a);
    l_b = l_b * al_b + quad_sum(rs_b);
    if (al_a != 1.f || al_b != 1.f)   // alpha is exactly 1 where the running max held
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][0] *= al_a;
        acc[n][1] *= al_a;
        acc[n][2] *= al_b;
        acc[n][3] *= al_b;
      }
    // masked keys have p = 0 and zero-filled V rows, so the whole tile is summed
#pragma unroll
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
      uint32_t a[4];
      pack_a(a, s[2 * kk], s[2 * kk + 1]);
      mma_a_x<D>(acc, a, svt_, 16 * kk, lane);
    }
    __syncthreads();   // this stage is free for the load issued in iteration it + 1
  }
  cp_async_wait<0>();

  const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
  const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
  // the Q tile is no longer read: each warp stages its own 16 rows of o there
  store_rows<D>(acc, inv_a, inv_b, sq + warp * 16 * LD, o + b * sob + h * soh, sot,
                q0 + warp * 16, Tq, lane);
  if (t4 == 0) {
    if (ra < Tq)
      lse[((int64_t)b * Tq + ra) * H + h] = l_a > 0.f ? m_a + logf(l_a) : -INFINITY;
    if (rb < Tq)
      lse[((int64_t)b * Tq + rb) * H + h] = l_b > 0.f ? m_b + logf(l_b) : -INFINITY;
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                int B, int Tq, int Tk, int H, int Hkv,
                int64_t sqb, int64_t sqt, int64_t sqh,
                int64_t skb, int64_t skt, int64_t skh,
                int64_t svb, int64_t svt, int64_t svh,
                int64_t sob, int64_t sot, int64_t soh,
                float scale, int causal, int q_offset, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, (Tq + kMmaRows - 1) / kMmaRows, B);
  flash_fwd_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, Tq, Tk, H,
      H / Hkv, sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh, scale, causal,
      q_offset);
  return (int)cudaGetLastError();
}

// Not on any path: the two bf16 score sums the route above forms, for every (q row, key)
// pair before the scale, so that a check on the card can hold the two facts the route rests
// on: the plain version's f32 scores equal the sequential sum (exact_scores), and the
// tensor-core ones (tile_scores) lie within err_bound of them. One block of 4 warps per
// (64 keys, 64 q rows, batch x head); s_mma and s_seq are [B, H, Tq, Tk] f32.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_scores_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    float* __restrict__ s_mma, float* __restrict__ s_seq, int Tq, int Tk,
                    int H, int group, int64_t sqb, int64_t sqt, int64_t sqh,
                    int64_t skb, int64_t skt, int64_t skh) {
  constexpr int LD = kLd<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [64][LD]
  __nv_bfloat16* sk = sq + kMmaRows * LD;                             // [64][LD]
  float* scr = reinterpret_cast<float*>(sk + kMmaKeys * LD) + threadIdx.x;   // column
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * kMmaKeys, q0 = blockIdx.y * kMmaRows;
  const int b = blockIdx.z / H, h = blockIdx.z % H;
  load_tile_async<D, kMmaThreads>(sq, q + b * sqb + h * sqh, sqt, q0, Tq, tid);
  load_tile_async<D, kMmaThreads>(sk, k + b * skb + h / group * skh, skt, k0, Tk, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const __nv_bfloat16* sqw = sq + warp * 16 * LD;
  float s[8][4];
  tile_scores<D>(s, sqw, sk, lane);
  exact_scores<D>(0xffffffffu, sqw, sk, lane, 1.f, false, 0.f, 0.f, scr);
  const int64_t base = ((int64_t)b * H + h) * Tq;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q0 + warp * 16 + g + 8 * (e >> 1);
      const int key = k0 + 8 * j + 2 * t4 + (e & 1);
      if (row < Tq && key < Tk) {
        s_mma[(base + row) * Tk + key] = s[j][e];
        s_seq[(base + row) * Tk + key] = scr[(4 * j + e) * kMmaThreads];
      }
    }
}

template <int D>
int launch_scores(const void* q, const void* k, void* s_mma, void* s_seq, int B, int Tq,
                  int Tk, int H, int Hkv, int64_t sqb, int64_t sqt, int64_t sqh,
                  int64_t skb, int64_t skt, int64_t skh, cudaStream_t stream) {
  const size_t smem = (size_t)(kMmaRows + kMmaKeys) * kLd<D> * sizeof(__nv_bfloat16) +
                      (size_t)32 * kMmaThreads * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_scores_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tk + kMmaKeys - 1) / kMmaKeys, (Tq + kMmaRows - 1) / kMmaRows, B * H);
  flash_scores_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<float*>(s_mma), static_cast<float*>(s_seq), Tq, Tk, H, H / Hkv,
      sqb, sqt, sqh, skb, skt, skh);
  return (int)cudaGetLastError();
}

// cp.async moves 16 bytes: every row of q, k, v and o must start 16-byte aligned
bool rows_aligned(const void* p, int64_t sb, int64_t st, int64_t sh) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 8 == 0 && st % 8 == 0 && sh % 8 == 0;
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores). Returns a cudaError_t (0
// on success); cudaErrorInvalidValue for a dtype, head dim, shape or (bf16) row alignment
// the kernels do not take.
extern "C" int af_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int dtype,
    int B, int Tq, int Tk, int H, int Hkv, int D,
    int64_t sqb, int64_t sqt, int64_t sqh,
    int64_t skb, int64_t skt, int64_t skh,
    int64_t svb, int64_t svt, int64_t svh,
    int64_t sob, int64_t sot, int64_t soh,
    float scale, int causal, int q_offset, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk < 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define AF_FLASH_ARGS q, k, v, o, l, B, Tq, Tk, H, Hkv, sqb, sqt, sqh, skb, skt, skh, \
                      svb, svt, svh, sob, sot, soh, scale, causal, q_offset, s
  if (dtype == 0 && D == 64) return launch_f32<64>(AF_FLASH_ARGS);
  if (dtype == 0 && D == 128) return launch_f32<128>(AF_FLASH_ARGS);
  if (dtype == 1) {
    if (!rows_aligned(q, sqb, sqt, sqh) || !rows_aligned(k, skb, skt, skh) ||
        !rows_aligned(v, svb, svt, svh) || !rows_aligned(o, sob, sot, soh) ||
        (Tq + kMmaRows - 1) / kMmaRows > 65535 || B > 65535)
      return (int)cudaErrorInvalidValue;
    if (D == 64) return launch_bf16<64>(AF_FLASH_ARGS);
    if (D == 128) return launch_bf16<128>(AF_FLASH_ARGS);
  }
#undef AF_FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}

// The bf16 route's two score sums (flash_scores_kernel) of q [B, Tq, H, D] and k [B, Tk,
// Hkv, D] into s_mma and s_seq, [B, H, Tq, Tk] f32 each. Returns a cudaError_t;
// cudaErrorInvalidValue for a head dim, shape or row alignment it does not take.
extern "C" int af_flash_scores(const void* q, const void* k, void* s_mma, void* s_seq,
                               int B, int Tq, int Tk, int H, int Hkv, int D,
                               int64_t sqb, int64_t sqt, int64_t sqh,
                               int64_t skb, int64_t skt, int64_t skh, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      (long long)B * H > 65535 || (Tq + kMmaRows - 1) / kMmaRows > 65535 ||
      !rows_aligned(q, sqb, sqt, sqh) || !rows_aligned(k, skb, skt, skh))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_scores<64>(q, k, s_mma, s_seq, B, Tq, Tk, H, Hkv, sqb, sqt, sqh, skb, skt,
                             skh, s);
  if (D == 128)
    return launch_scores<128>(q, k, s_mma, s_seq, B, Tq, Tk, H, Hkv, sqb, sqt, sqh, skb, skt,
                              skh, s);
  return (int)cudaErrorInvalidValue;
}
