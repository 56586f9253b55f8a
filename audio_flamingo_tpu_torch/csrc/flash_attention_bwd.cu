// Flash-attention backward (K7) for Hopper (sm_90a), plain C interface bound with ctypes.
//
// Replaces the Pallas TPU kernels of audio_flamingo_tpu/ops/pallas/flash_attention.py
// (`_flash_backward` :431, kernels `_flash_bwd_dkv_kernel` and `_flash_bwd_dq_kernel`):
// the FlashAttention-2 backward that rebuilds p = exp(s * scale - lse) tile by tile from
// the forward's per-row log-sum-exp, so no [Tq, Tk] tensor reaches device memory.
//
// Numerics, as the JAX kernels: scores and p in f32; pc = p rounded to the input dtype
// feeds dV = pc^T dO; ds = p (dp - delta) rounded to the input dtype feeds dK = ds^T Q
// * scale and dQ = ds K * scale; every product accumulates in f32 and each output is
// cast to the input dtype once, at the end. delta = sum(dO * O) - g_lse per row (f32)
// comes from the caller (the LSE cotangent is a shift of delta). Keys at or past Tk and
// causal pairs past the frontier (key > row + q_offset) get p = 0, and so does every key
// of a row whose lse is -inf (a row with no visible key): exp(s - lse) is never formed
// for it, and its gradient is zero.
//
// Layout: q/o/dO/dQ [B, Tq, H, D], k/v/dK/dV [B, Tk, Hkv, D] through the caller's
// strides (last dim contiguous); lse and delta [B, Tq, H] f32, contiguous.
//
// Two kernels in each route, with no float atomics: each output element is summed by one
// thread in a fixed order, so a replay is bit-identical.
// - dK/dV: one block per (64-key tile, KV head, batch). It loops over the KV head's
//   `group` query heads and, for each, over the 64-row q tiles from the first that reaches
//   the causal frontier. The GQA sum over query heads is this loop.
// - dQ: one block per (64-row q tile, q head, batch), looping over the key tiles up to
//   the causal frontier, as the forward does.
// Both recompute S and dP (FlashAttention-2's split): seven products instead of five.
// Merging them would need float atomics on dQ or a dQ buffer per key tile.
//
// bf16 route, on the tensor cores (`flash_bwd_dkv_mma_kernel`, `flash_bwd_dq_mma_kernel`):
// blocks of 4 warps, each warp owning 16 keys (dK/dV) or 16 q rows (dQ); every product is
// mma.sync m16n8k16 bf16 with f32 accumulation, and each tile is taken 32 columns at a
// time to bound the live registers.
// - dK/dV computes the transposed products S^T = K Q^T and dP^T = V dO^T, so P^T (rounded
//   to bf16) and dS^T = P^T (dP^T - delta) (rounded to bf16) come out of the accumulators
//   already in the A-fragment layout of dV += P^T dO and dK += dS^T Q. Q's and dO's
//   B-fragments come by ldmatrix (not transposed for S^T and dP^T, transposed for dK and
//   dV); K's and V's A-fragments are read from shared memory at each use, since the dK and
//   dV accumulators alone take 128 registers a thread at D = 128. Q, dO, lse and delta
//   come through a 2-stage cp.async ring, so the next (head, q tile) loads while this one
//   computes.
// - dQ keeps its Q and dO A-fragments in registers, and K and V come through the same
//   kind of ring; dQ += dS K takes K's B-fragments by ldmatrix.trans.
// - p = exp2f((s scale - lse) log2(e)): within 2e-6 relative of exp in f32 (ex2.approx and
//   one rounding of the product). With the tensor-core score sums this rounds an
//   occasional pc or ds to the neighbouring bf16 value; unlike the forward's, the
//   backward's bf16 tolerance (2^-7 of the largest gradient as its floor) absorbs such a
//   step, so no score is recomputed here.
// - Order: heads vary fastest in the grid; the dK/dV kernel takes the first key tiles
//   (the most q tiles under causal masking) first, the dQ kernel the last q tiles. At the
//   LM's stage-2 shape ([4,1024,28,128] causal over 4 KV heads) the dK/dV grid is 4 x 4 x
//   16 = 256 blocks, one wave at two blocks per SM on 132 SMs: the launch lasts as long as
//   its heaviest block (key tile 0: 7 heads x 16 q tiles) while the mean block does 7 x
//   8.5, so about half of that wave's capacity idles. Splitting the heavy key tiles over
//   q ranges would need a second pass to add their parts.
// f32 route, on the CUDA cores (`flash_bwd_dkv_kernel`, `flash_bwd_dq_kernel`): f32 FMAs,
// tiles staged in shared memory as f32, 256 threads as a 16 x 16 grid (the f32 forward's
// layout); TF32 would break the f32 agreement with the CPU, as in the forward.
//
// Bound on the H100 at AF3 stage 2's shapes: bf16 tensor-core FLOPs. Five products of
// 2 B H Tq Tk D each (S, dP, dV, dK, dQ; the recomputed S and dP are not counted).
// Encoder [4,1500,20,64] non-causal: 5 x 2.30e10 = 1.15e11 FLOP = 0.116 ms at 989
// TFLOP/s; LM [4,1024,28,128] causal GQA: about half of 5 x 3.01e10 = 7.5e10 FLOP = 0.076
// ms. Left for later: wgmma with a TMA-fed Q/dO ring and warp specialisation, and
// balancing the causal triangle over the grid.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

constexpr int kBQ = 64;       // q rows per tile
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 256;
constexpr int kPS = kBK + 4;  // P / dS row stride (floats): 16-byte aligned rows

struct Strides {
  int64_t b, t, h;
};

// rows [t0, t0 + 64) of one head of x into a [64][D + 4] f32 tile, zero past n
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int64_t stride_t,
                                          int t0, int n) {
  constexpr int QS = D + 4;
  for (int idx = threadIdx.x; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int t = t0 + r;
    dst[r * QS + c] = t < n ? src[t * stride_t + c] : 0.f;
  }
}

// acc[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d] over two [64][D + 4] tiles
template <int D>
__device__ __forceinline__ void tile_dot(const float* a, const float* b, int ty, int tx,
                                         float acc[4][4]) {
  constexpr int QS = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(&a[(ty + 16 * i) * QS + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(&b[(tx + 16 * j) * QS + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = acc[i][j];
        x = fmaf(av[i].x, bv[j].x, x);
        x = fmaf(av[i].y, bv[j].y, x);
        x = fmaf(av[i].z, bv[j].z, x);
        x = fmaf(av[i].w, bv[j].w, x);
        acc[i][j] = x;
      }
  }
}

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& x) {
  acc.x = fmaf(w, x.x, acc.x);
  acc.y = fmaf(w, x.y, acc.y);
  acc.z = fmaf(w, x.z, acc.z);
  acc.w = fmaf(w, x.w, acc.w);
}

// lse as the p formula uses it: +inf for a row past Tq or with no visible key, so
// exp(s - lse) = 0 and exp(s + inf) is never formed
__device__ __forceinline__ float row_lse(const float* lse, int64_t idx, bool in) {
  if (!in) return INFINITY;
  const float x = lse[idx];
  return x == -INFINITY ? INFINITY : x;
}

template <int D>
constexpr size_t dkv_smem_floats() {
  // K, V, Q, dO tiles, then P, dS, lse, delta
  return 4 * (size_t)kBQ * (D + 4) + 2 * (size_t)kBQ * kPS + 2 * (size_t)kBQ;
}

template <int D>
constexpr size_t dq_smem_floats() {
  // Q, dO, K, V tiles, then dS
  return 4 * (size_t)kBQ * (D + 4) + (size_t)kBQ * kPS;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv,
                     int Tq, int Tk, int H, int group,
                     Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
                     float scale, int causal, int q_offset) {
  static_assert(D % 64 == 0, "head dim must be a multiple of 64");
  constexpr int QS = D + 4;
  constexpr int NC = D / 64;

  extern __shared__ __align__(16) float smem[];
  float* s_k = smem;                 // [kBK][QS]
  float* s_v = s_k + kBK * QS;       // [kBK][QS]
  float* s_q = s_v + kBK * QS;       // [kBQ][QS]
  float* s_do = s_q + kBQ * QS;      // [kBQ][QS]
  float* s_p = s_do + kBQ * QS;      // [kBQ][kPS]
  float* s_ds = s_p + kBQ * kPS;     // [kBQ][kPS]
  float* s_lse = s_ds + kBQ * kPS;   // [kBQ]
  float* s_delta = s_lse + kBQ;      // [kBQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = blockIdx.x * kBK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;

  load_tile<D>(s_k, k + b * sk.b + hk * sk.h, sk.t, k0, Tk);
  load_tile<D>(s_v, v + b * sv.b + hk * sv.h, sv.t, k0, Tk);

  float4 acc_dk[4][NC], acc_dv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc_dk[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
      acc_dv[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

  // the first q tile with a row that sees key k0: q0 + kBQ - 1 + q_offset >= k0
  int q_begin = 0;
  if (causal) {
    const long long lo = (long long)k0 - q_offset - (kBQ - 1);
    if (lo > 0) q_begin = (int)((lo + kBQ - 1) / kBQ) * kBQ;
  }

  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    const float* qb = q + b * sq.b + h * sq.h;
    const float* dob = dout + b * sdo.b + h * sdo.h;
    for (int q0 = q_begin; q0 < Tq; q0 += kBQ) {
      __syncthreads();  // the previous tile's Q, dO, P and dS are no longer read
      load_tile<D>(s_q, qb, sq.t, q0, Tq);
      load_tile<D>(s_do, dob, sdo.t, q0, Tq);
      if (tid < kBQ) {
        const int t = q0 + tid;
        const int64_t idx = ((int64_t)b * Tq + t) * H + h;
        s_lse[tid] = row_lse(lse, idx, t < Tq);
        s_delta[tid] = t < Tq ? delta[idx] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      tile_dot<D>(s_q, s_k, ty, tx, s);
      tile_dot<D>(s_do, s_v, ty, tx, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const long long row = (long long)q0 + r;
        const float l = s_lse[r];
        const float dl = s_delta[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = k0 + tx + 16 * j;
          const bool ok = col < Tk && (!causal || (long long)col <= row + q_offset);
          const float p = ok ? expf(s[i][j] * scale - l) : 0.f;
          s_p[r * kPS + tx + 16 * j] = p;
          s_ds[r * kPS + tx + 16 * j] = p * (dp[i][j] - dl);
        }
      }
      __syncthreads();

      // dV[key] += sum_r pc[r][key] dO[r];  dK[key] += sum_r ds[r][key] Q[r]
#pragma unroll 2
      for (int r = 0; r < kBQ; ++r) {
        float pr[4], dsr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pr[i] = s_p[r * kPS + ty + 16 * i];
          dsr[i] = s_ds[r * kPS + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 dov = *reinterpret_cast<const float4*>(&s_do[r * QS + 4 * tx + 64 * c]);
          const float4 qv = *reinterpret_cast<const float4*>(&s_q[r * QS + 4 * tx + 64 * c]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            fma4(acc_dv[i][c], pr[i], dov);
            fma4(acc_dk[i][c], dsr[i], qv);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Tk) continue;
    float* dkrow = dk + b * sdk.b + key * sdk.t + hk * sdk.h;
    float* dvrow = dv + b * sdv.b + key * sdv.t + hk * sdv.h;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = 4 * tx + 64 * c;
      dkrow[d + 0] = acc_dk[i][c].x * scale;
      dkrow[d + 1] = acc_dk[i][c].y * scale;
      dkrow[d + 2] = acc_dk[i][c].z * scale;
      dkrow[d + 3] = acc_dk[i][c].w * scale;
      dvrow[d + 0] = acc_dv[i][c].x;
      dvrow[d + 1] = acc_dv[i][c].y;
      dvrow[d + 2] = acc_dv[i][c].z;
      dvrow[d + 3] = acc_dv[i][c].w;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int Tq, int Tk, int H, int group,
                    Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq,
                    float scale, int causal, int q_offset) {
  static_assert(D % 64 == 0, "head dim must be a multiple of 64");
  constexpr int QS = D + 4;
  constexpr int NC = D / 64;

  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                 // [kBQ][QS]
  float* s_do = s_q + kBQ * QS;      // [kBQ][QS]
  float* s_k = s_do + kBQ * QS;      // [kBK][QS]
  float* s_v = s_k + kBK * QS;       // [kBK][QS]
  float* s_ds = s_v + kBK * QS;      // [kBQ][kPS]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;

  load_tile<D>(s_q, q + b * sq.b + h * sq.h, sq.t, q0, Tq);
  load_tile<D>(s_do, dout + b * sdo.b + h * sdo.h, sdo.t, q0, Tq);
  float l[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    const int64_t idx = ((int64_t)b * Tq + t) * H + h;
    l[i] = row_lse(lse, idx, t < Tq);
    dl[i] = t < Tq ? delta[idx] : 0.f;
  }
  const float* kb = k + b * sk.b + hk * sk.h;
  const float* vb = v + b * sv.b + hk * sv.h;

  // keys this block can see: all of [0, Tk), or under causal masking up to the last
  // row's frontier q0 + kBQ - 1 + q_offset
  int kv_end = Tk;
  if (causal) {
    const long long lim = (long long)q0 + kBQ + q_offset;
    if (lim < kv_end) kv_end = lim > 0 ? (int)lim : 0;
  }

  float4 acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and dS are no longer read
    load_tile<D>(s_k, kb, sk.t, k0, Tk);
    load_tile<D>(s_v, vb, sv.t, k0, Tk);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<D>(s_q, s_k, ty, tx, s);
    tile_dot<D>(s_do, s_v, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const long long row = (long long)q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < Tk && (!causal || (long long)col <= row + q_offset);
        const float p = ok ? expf(s[i][j] * scale - l[i]) : 0.f;
        s_ds[r * kPS + tx + 16 * j] = p * (dp[i][j] - dl[i]);
      }
    }
    __syncthreads();

    // dQ[row] += sum_key ds[row][key] K[key]
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dsv[i] = *reinterpret_cast<const float4*>(&s_ds[(ty + 16 * i) * kPS + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 kv = *reinterpret_cast<const float4*>(&s_k[(j + jj) * QS + 4 * tx + 64 * c]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float w = jj == 0 ? dsv[i].x : jj == 1 ? dsv[i].y : jj == 2 ? dsv[i].z : dsv[i].w;
            fma4(acc[i][c], w, kv);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tq) continue;
    float* dqrow = dq + b * sdq.b + row * sdq.t + h * sdq.h;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = 4 * tx + 64 * c;
      dqrow[d + 0] = acc[i][c].x * scale;
      dqrow[d + 1] = acc[i][c].y * scale;
      dqrow[d + 2] = acc[i][c].z * scale;
      dqrow[d + 3] = acc[i][c].w * scale;
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dq, void* dk, void* dv,
               int B, int Tq, int Tk, int H, int Hkv,
               Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq, Strides sdk,
               Strides sdv, float scale, int causal, int q_offset, cudaStream_t stream) {
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  const int group = H / Hkv;
  if (Tk > 0) {
    const size_t smem = dkv_smem_floats<D>() * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Tk + kBK - 1) / kBK, Hkv, B);
    flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv),
        Tq, Tk, H, group, sq, sk, sv, sdo, sdk, sdv, scale, causal, q_offset);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = dq_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<float*>(dq), Tq, Tk, H, group,
      sq, sk, sv, sdo, sdq, scale, causal, q_offset);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- bf16: tensor cores

constexpr int kMmaTile = 64;      // keys per dK/dV block, q rows per dQ block, loop step
constexpr int kMmaThreads = 128;  // 4 warps x 16 keys or rows
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// lse as the p formula uses it: +inf for a row with no visible key, so exp(s - lse) = 0
__device__ __forceinline__ float lse_or_inf(float x) { return x == -INFINITY ? INFINITY : x; }

template <int D>
constexpr size_t dkv_mma_smem_bytes() {
  // K, V, then 2 stages of Q and dO tiles, then 2 stages of lse and delta rows
  return (size_t)6 * kMmaTile * kLd<D> * sizeof(bf16) + (size_t)4 * kMmaTile * sizeof(float);
}

template <int D>
constexpr size_t dq_mma_smem_bytes() {
  // Q, dO, then 2 stages of K and V tiles
  return (size_t)6 * kMmaTile * kLd<D> * sizeof(bf16);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         int Tq, int Tk, int H, int group,
                         Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
                         Strides sdv, float scale, int causal, int q_offset) {
  constexpr int LD = kLd<D>;
  constexpr int KD = D / 16;   // k-steps over D
  constexpr int ND = D / 8;    // 8-column tiles of dK and dV
  constexpr int NT = kMmaTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_k = reinterpret_cast<bf16*>(smem_raw);   // [64][LD]
  bf16* s_v = s_k + NT * LD;                        // [64][LD]
  bf16* s_q = s_v + NT * LD;                        // [2][64][LD]
  bf16* s_do = s_q + 2 * NT * LD;                   // [2][64][LD]
  float* s_l = reinterpret_cast<float*>(s_do + 2 * NT * LD);   // [2][64]
  float* s_dl = s_l + 2 * NT;                                   // [2][64]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t4 = lane & 3;
  // grid (Hkv, key tiles, B): heads vary fastest, the first (heaviest) key tiles go first
  const int hk = blockIdx.x;
  const int k0 = blockIdx.y * NT;
  const int b = blockIdx.z;
  const int kw = warp * 16;                         // this warp's keys within the tile
  const int key_a = k0 + kw + (lane >> 2), key_b = key_a + 8;

  // the first q tile with a row that sees key k0: q0 + 63 + q_offset >= k0
  int q_begin = 0;
  if (causal) {
    const long long lo = (long long)k0 - q_offset - (NT - 1);
    if (lo > 0) q_begin = (int)min((long long)Tq, (lo + NT - 1) / NT * NT);
  }
  const int n_qt = (Tq - q_begin + NT - 1) / NT;
  const int n_it = group * n_qt;

  load_tile_async<D, kMmaThreads>(s_k, k + b * sk.b + hk * sk.h, sk.t, k0, Tk, tid);
  load_tile_async<D, kMmaThreads>(s_v, v + b * sv.b + hk * sv.h, sv.t, k0, Tk, tid);
  cp_async_commit();
  // iteration i: query head hk * group + i / n_qt, q tile q_begin + 64 (i % n_qt)
  auto load_rows = [&](int i, int st) {
    const int h = hk * group + i / n_qt;
    const int q0 = q_begin + (i % n_qt) * NT;
    load_tile_async<D, kMmaThreads>(s_q + st * NT * LD, q + b * sq.b + h * sq.h, sq.t, q0,
                                    Tq, tid);
    load_tile_async<D, kMmaThreads>(s_do + st * NT * LD, dout + b * sdo.b + h * sdo.h,
                                    sdo.t, q0, Tq, tid);
    if (tid < NT) {
      const int t = q0 + tid;
      const bool in = t < Tq;
      const int64_t idx = ((int64_t)b * Tq + (in ? t : 0)) * H + h;
      cp_async4(s_l + st * NT + tid, lse + idx, in);
      cp_async4(s_dl + st * NT + tid, delta + idx, in);
    }
  };
  if (n_it > 0) load_rows(0, 0);
  cp_async_commit();

  float acc_dk[ND][4], acc_dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) load_rows(it + 1, st ^ 1);   // into the stage freed by the last sync
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = q_begin + (it % n_qt) * NT;
    const bf16* tq = s_q + st * NT * LD;
    const bf16* tdo = s_do + st * NT * LD;
    const float* tl = s_l + st * NT;
    const float* tdl = s_dl + st * NT;
    const bool masked = k0 + NT > Tk || q0 + NT > Tq ||
                        (causal && (long long)k0 + NT - 1 > (long long)q0 + q_offset);
#pragma unroll 1
    for (int r0 = 0; r0 < NT; r0 += 32) {   // 32 q rows of the tile at a time
      // sT[j]: this warp's keys key_a (sT[j][0..1]) and key_b (sT[j][2..3]) against q
      // rows q0 + r0 + 8 j + 2 t4 (+1)
      float sT[4][4], dpT[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[4];
        load_a<D>(a, s_k, kw, kk, lane);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4];
          load_b_rows<D>(r, tq, r0 + 16 * np, kk, lane);
          mma_bf16(sT[2 * np], a, r[0], r[1]);
          mma_bf16(sT[2 * np + 1], a, r[2], r[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rr = r0 + 8 * j + 2 * t4;
        const float2 lj = *reinterpret_cast<const float2*>(tl + rr);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float l = lse_or_inf(e & 1 ? lj.y : lj.x);
          float p = exp2f((sT[j][e] * scale - l) * kLog2e);
          if (masked) {
            const int key = e < 2 ? key_a : key_b;
            const int row = q0 + rr + (e & 1);
            if (key >= Tk || row >= Tq || (causal && (long long)key > (long long)row + q_offset))
              p = 0.f;
          }
          sT[j][e] = p;
        }
      }
      // dV += P^T dO over these 32 rows
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t a[4];
        pack_a(a, sT[2 * kk], sT[2 * kk + 1]);
        mma_a_x<D>(acc_dv, a, tdo, r0 + 16 * kk, lane);
      }
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[4];
        load_a<D>(a, s_v, kw, kk, lane);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4];
          load_b_rows<D>(r, tdo, r0 + 16 * np, kk, lane);
          mma_bf16(dpT[2 * np], a, r[0], r[1]);
          mma_bf16(dpT[2 * np + 1], a, r[2], r[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 dj = *reinterpret_cast<const float2*>(tdl + r0 + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) dpT[j][e] = sT[j][e] * (dpT[j][e] - (e & 1 ? dj.y : dj.x));
      }
      // dK += dS^T Q over these 32 rows
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t a[4];
        pack_a(a, dpT[2 * kk], dpT[2 * kk + 1]);
        mma_a_x<D>(acc_dk, a, tq, r0 + 16 * kk, lane);
      }
    }
    __syncthreads();   // this stage is free for the load issued in iteration it + 1
  }
  cp_async_wait<0>();
  __syncthreads();     // every copy into K and V has landed before they are overwritten

  // each warp stages its own 16 keys in the K and V tiles it alone reads
  store_rows<D>(acc_dk, scale, scale, s_k + kw * LD, dk + b * sdk.b + hk * sdk.h, sdk.t,
                k0 + kw, Tk, lane);
  store_rows<D>(acc_dv, 1.f, 1.f, s_v + kw * LD, dv + b * sdv.b + hk * sdv.h, sdv.t, k0 + kw,
                Tk, lane);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int Tq, int Tk, int H, int group,
                        Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq,
                        float scale, int causal, int q_offset) {
  constexpr int LD = kLd<D>;
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  constexpr int NT = kMmaTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);   // [64][LD]
  bf16* s_do = s_q + NT * LD;                       // [64][LD]
  bf16* s_k = s_do + NT * LD;                       // [2][64][LD]
  bf16* s_v = s_k + 2 * NT * LD;                    // [2][64][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t4 = lane & 3;
  // grid (H, q tiles, B): heads vary fastest, the heaviest causal q tiles go first
  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * NT;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int ra = q0 + warp * 16 + (lane >> 2), rb = ra + 8;   // this thread's two rows

  const bf16* kb = k + b * sk.b + hk * sk.h;
  const bf16* vb = v + b * sv.b + hk * sv.h;
  int kv_end = Tk;
  if (causal) {
    const long long lim = (long long)q0 + NT + q_offset;
    if (lim < kv_end) kv_end = lim > 0 ? (int)lim : 0;
  }
  const int n_tiles = (kv_end + NT - 1) / NT;

  load_tile_async<D, kMmaThreads>(s_q, q + b * sq.b + h * sq.h, sq.t, q0, Tq, tid);
  load_tile_async<D, kMmaThreads>(s_do, dout + b * sdo.b + h * sdo.h, sdo.t, q0, Tq, tid);
  cp_async_commit();
  if (n_tiles > 0) {
    load_tile_async<D, kMmaThreads>(s_k, kb, sk.t, 0, Tk, tid);
    load_tile_async<D, kMmaThreads>(s_v, vb, sv.t, 0, Tk, tid);
  }
  cp_async_commit();
  // rows past Tq get lse = +inf: p = 0
  const float l_a = ra < Tq ? lse_or_inf(lse[((int64_t)b * Tq + ra) * H + h]) : INFINITY;
  const float l_b = rb < Tq ? lse_or_inf(lse[((int64_t)b * Tq + rb) * H + h]) : INFINITY;
  const float d_a = ra < Tq ? delta[((int64_t)b * Tq + ra) * H + h] : 0.f;
  const float d_b = rb < Tq ? delta[((int64_t)b * Tq + rb) * H + h] : 0.f;
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[KD][4], dof[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    load_a<D>(qf[kk], s_q, warp * 16, kk, lane);
    load_a<D>(dof[kk], s_do, warp * 16, kk, lane);
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * NT;
    const int st = it & 1;
    if (it + 1 < n_tiles) {
      load_tile_async<D, kMmaThreads>(s_k + (st ^ 1) * NT * LD, kb, sk.t, k0 + NT, Tk, tid);
      load_tile_async<D, kMmaThreads>(s_v + (st ^ 1) * NT * LD, vb, sv.t, k0 + NT, Tk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* tk = s_k + st * NT * LD;
    const bf16* tv = s_v + st * NT * LD;
    const bool masked = k0 + NT > Tk ||
                        (causal && (long long)k0 + NT - 1 > (long long)q0 + q_offset);
#pragma unroll 1
    for (int c0 = 0; c0 < NT; c0 += 32) {   // 32 keys of the tile at a time
      // s[j]: rows ra (s[j][0..1]) and rb (s[j][2..3]) against keys k0 + c0 + 8 j + 2 t4 (+1)
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4];
          load_b_rows<D>(r, tk, c0 + 16 * np, kk, lane);
          mma_bf16(s[2 * np], qf[kk], r[0], r[1]);
          mma_bf16(s[2 * np + 1], qf[kk], r[2], r[3]);
          load_b_rows<D>(r, tv, c0 + 16 * np, kk, lane);
          mma_bf16(dp[2 * np], dof[kk], r[0], r[1]);
          mma_bf16(dp[2 * np + 1], dof[kk], r[2], r[3]);
        }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f((s[j][e] * scale - (e < 2 ? l_a : l_b)) * kLog2e);
          if (masked) {
            const int key = k0 + c0 + 8 * j + 2 * t4 + (e & 1);
            const int row = e < 2 ? ra : rb;
            if (key >= Tk || (causal && (long long)key > (long long)row + q_offset)) p = 0.f;
          }
          s[j][e] = p * (dp[j][e] - (e < 2 ? d_a : d_b));
        }
      // dQ += dS K over these 32 keys
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t a[4];
        pack_a(a, s[2 * kk], s[2 * kk + 1]);
        mma_a_x<D>(acc, a, tk, c0 + 16 * kk, lane);
      }
    }
    __syncthreads();   // this stage is free for the load issued in iteration it + 1
  }
  cp_async_wait<0>();

  // the Q tile is no longer read: each warp stages its own 16 rows of dQ there
  store_rows<D>(acc, scale, scale, s_q + warp * 16 * LD, dq + b * sdq.b + h * sdq.h, sdq.t,
                q0 + warp * 16, Tq, lane);
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dq, void* dk, void* dv,
                int B, int Tq, int Tk, int H, int Hkv,
                Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq, Strides sdk,
                Strides sdv, float scale, int causal, int q_offset, cudaStream_t stream) {
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  const int group = H / Hkv;
  if (Tk > 0) {
    const size_t smem = dkv_mma_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_mma_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(Hkv, (Tk + kMmaTile - 1) / kMmaTile, B);
    flash_bwd_dkv_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
        Tq, Tk, H, group, sq, sk, sv, sdo, sdk, sdv, scale, causal, q_offset);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = dq_mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, (Tq + kMmaTile - 1) / kMmaTile, B);
  flash_bwd_dq_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dq), Tq, Tk, H, group,
      sq, sk, sv, sdo, sdq, scale, causal, q_offset);
  return (int)cudaGetLastError();
}

// cp.async moves 16 bytes: every row of a bf16 operand must start 16-byte aligned
bool rows_aligned(const void* p, Strides s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 && s.t % 8 == 0 &&
         s.h % 8 == 0;
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores). Returns a cudaError_t (0
// on success); cudaErrorInvalidValue for a dtype, head dim, shape or (bf16) row alignment
// the kernels do not take.
// Strides: (batch, time, head) in elements for q, k, v, dO, dQ, dK, dV in that order.
extern "C" int af_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, void* dk, void* dv, int dtype,
    int B, int Tq, int Tk, int H, int Hkv, int D,
    int64_t sqb, int64_t sqt, int64_t sqh,
    int64_t skb, int64_t skt, int64_t skh,
    int64_t svb, int64_t svt, int64_t svh,
    int64_t sdob, int64_t sdot, int64_t sdoh,
    int64_t sdqb, int64_t sdqt, int64_t sdqh,
    int64_t sdkb, int64_t sdkt, int64_t sdkh,
    int64_t sdvb, int64_t sdvt, int64_t sdvh,
    float scale, int causal, int q_offset, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk < 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const Strides sq{sqb, sqt, sqh}, sk{skb, skt, skh}, sv{svb, svt, svh},
      sdo{sdob, sdot, sdoh}, sdq{sdqb, sdqt, sdqh}, sdk{sdkb, sdkt, sdkh},
      sdv{sdvb, sdvt, sdvh};
#define AF_FLASH_BWD_ARGS q, k, v, dout, l, dl, dq, dk, dv, B, Tq, Tk, H, Hkv, sq, sk, sv, \
                          sdo, sdq, sdk, sdv, scale, causal, q_offset, s
  if (dtype == 0 && D == 64) return launch_f32<64>(AF_FLASH_BWD_ARGS);
  if (dtype == 0 && D == 128) return launch_f32<128>(AF_FLASH_BWD_ARGS);
  if (dtype == 1) {
    if (!rows_aligned(q, sq) || !rows_aligned(k, sk) || !rows_aligned(v, sv) ||
        !rows_aligned(dout, sdo) || !rows_aligned(dq, sdq) || !rows_aligned(dk, sdk) ||
        !rows_aligned(dv, sdv) || (Tq + kMmaTile - 1) / kMmaTile > 65535 ||
        (Tk + kMmaTile - 1) / kMmaTile > 65535 || B > 65535)
      return (int)cudaErrorInvalidValue;
    if (D == 64) return launch_bf16<64>(AF_FLASH_BWD_ARGS);
    if (D == 128) return launch_bf16<128>(AF_FLASH_BWD_ARGS);
  }
#undef AF_FLASH_BWD_ARGS
  return (int)cudaErrorInvalidValue;
}
