// Flash-attention backward (K7) for Hopper (sm_90a), plain C interface bound with ctypes.
//
// Replaces the Pallas TPU kernels of audio_flamingo_tpu/ops/pallas/flash_attention.py
// (`_flash_backward`, kernels `_flash_bwd_dkv_kernel` and `_flash_bwd_dq_kernel`): the
// FlashAttention-2 backward that rebuilds p = exp(s * scale - lse) tile by tile from the
// forward's per-row log-sum-exp, so no [Tq, Tk] tensor reaches device memory.
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
// Design: two kernels, f32 FMAs on CUDA cores, tiles staged in shared memory as f32,
// 256 threads as a 16 x 16 grid (the forward kernel's layout).
// - dK/dV: one block per (64-key tile, KV head, batch). It keeps its K and V tiles in
//   shared memory and loops over the KV head's `group` query heads and over the 64-row
//   q tiles itself, from the first tile that reaches the causal frontier; thread
//   (ty, tx) owns keys ty + 16 i (i < 4) and dims 4 tx + 64 c of dK and dV in registers.
//   The GQA sum over query heads is this loop, in a fixed order: no float atomics, so
//   a replay is bit-identical.
// - dQ: one block per (64-row q tile, q head, batch), looping over the key tiles up to
//   the causal frontier, as the forward does; thread (ty, tx) owns rows ty + 16 i and
//   dims 4 tx + 64 c of dQ.
// Both recompute S = Q K^T and dP = dO V^T (4 x 4 register tiles fed by 128-bit shared
// loads along D) and reduce nothing across blocks.
//
// Bound on the H100 at AF3 stage 2's shapes: bf16 tensor-core FLOPs. Five products of
// 2 B H Tq Tk D each (S twice, dP twice, dV, dK, dQ: the dK/dV and dQ kernels each
// recompute S and dP, as FA2 does, counted once here). Encoder [4,1500,20,64] non-causal:
// 5 x 2.30e10 = 1.15e11 FLOP = 0.116 ms at 989 TFLOP/s; LM [4,1024,28,128] causal GQA:
// about half of 5 x 3.01e10 = 7.5e10 FLOP = 0.076 ms. Left undone: every product runs on
// the f32 CUDA cores (67 TFLOP/s peak) and each recomputes S and dP; the next steps are
// bf16 mma.sync/wgmma tiles with a TMA-fed Q/dO ring, and, for the LM's causal shape,
// balancing the triangular work over the grid.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // q rows per tile
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 256;
constexpr int kPS = kBK + 4;  // P / dS row stride (floats): 16-byte aligned rows

struct Strides {
  int64_t b, t, h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// x as a product in the input dtype consumes it (exact for f32)
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows [t0, t0 + 64) of one head of x into a [64][D + 4] f32 tile, zero past n
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int64_t stride_t,
                                          int t0, int n) {
  constexpr int QS = D + 4;
  for (int idx = threadIdx.x; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int t = t0 + r;
    dst[r * QS + c] = t < n ? to_f32(src[t * stride_t + c]) : 0.f;
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv,
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

  load_tile<T, D>(s_k, k + b * sk.b + hk * sk.h, sk.t, k0, Tk);
  load_tile<T, D>(s_v, v + b * sv.b + hk * sv.h, sv.t, k0, Tk);

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
    const T* qb = q + b * sq.b + h * sq.h;
    const T* dob = dout + b * sdo.b + h * sdo.h;
    for (int q0 = q_begin; q0 < Tq; q0 += kBQ) {
      __syncthreads();  // the previous tile's Q, dO, P and dS are no longer read
      load_tile<T, D>(s_q, qb, sq.t, q0, Tq);
      load_tile<T, D>(s_do, dob, sdo.t, q0, Tq);
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
          s_p[r * kPS + tx + 16 * j] = round_to<T>(p);
          s_ds[r * kPS + tx + 16 * j] = round_to<T>(p * (dp[i][j] - dl));
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
    T* dkrow = dk + b * sdk.b + key * sdk.t + hk * sdk.h;
    T* dvrow = dv + b * sdv.b + key * sdv.t + hk * sdv.h;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = 4 * tx + 64 * c;
      dkrow[d + 0] = from_f32<T>(acc_dk[i][c].x * scale);
      dkrow[d + 1] = from_f32<T>(acc_dk[i][c].y * scale);
      dkrow[d + 2] = from_f32<T>(acc_dk[i][c].z * scale);
      dkrow[d + 3] = from_f32<T>(acc_dk[i][c].w * scale);
      dvrow[d + 0] = from_f32<T>(acc_dv[i][c].x);
      dvrow[d + 1] = from_f32<T>(acc_dv[i][c].y);
      dvrow[d + 2] = from_f32<T>(acc_dv[i][c].z);
      dvrow[d + 3] = from_f32<T>(acc_dv[i][c].w);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int Tq, int Tk, int H, int group,
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

  load_tile<T, D>(s_q, q + b * sq.b + h * sq.h, sq.t, q0, Tq);
  load_tile<T, D>(s_do, dout + b * sdo.b + h * sdo.h, sdo.t, q0, Tq);
  float l[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    const int64_t idx = ((int64_t)b * Tq + t) * H + h;
    l[i] = row_lse(lse, idx, t < Tq);
    dl[i] = t < Tq ? delta[idx] : 0.f;
  }
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;

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
    load_tile<T, D>(s_k, kb, sk.t, k0, Tk);
    load_tile<T, D>(s_v, vb, sv.t, k0, Tk);
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
        s_ds[r * kPS + tx + 16 * j] = round_to<T>(p * (dp[i][j] - dl[i]));
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
    T* dqrow = dq + b * sdq.b + row * sdq.t + h * sdq.h;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = 4 * tx + 64 * c;
      dqrow[d + 0] = from_f32<T>(acc[i][c].x * scale);
      dqrow[d + 1] = from_f32<T>(acc[i][c].y * scale);
      dqrow[d + 2] = from_f32<T>(acc[i][c].z * scale);
      dqrow[d + 3] = from_f32<T>(acc[i][c].w * scale);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* dq, void* dk, void* dv,
           int B, int Tq, int Tk, int H, int Hkv,
           Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq, Strides sdk,
           Strides sdv, float scale, int causal, int q_offset, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int group = H / Hkv;
  if (Tk > 0) {
    const size_t smem = dkv_smem_floats<D>() * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Tk + kBK - 1) / kBK, Hkv, B);
    flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        Tq, Tk, H, group, sq, sk, sv, sdo, sdk, sdv, scale, causal, q_offset);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = dq_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), Tq, Tk, H, group,
      sq, sk, sv, sdo, sdq, scale, causal, q_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success);
// cudaErrorInvalidValue for a dtype, head dim or shape the kernels do not take.
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
  if (dtype == 0 && D == 64) return launch<float, 64>(AF_FLASH_BWD_ARGS);
  if (dtype == 0 && D == 128) return launch<float, 128>(AF_FLASH_BWD_ARGS);
  if (dtype == 1 && D == 64) return launch<__nv_bfloat16, 64>(AF_FLASH_BWD_ARGS);
  if (dtype == 1 && D == 128) return launch<__nv_bfloat16, 128>(AF_FLASH_BWD_ARGS);
#undef AF_FLASH_BWD_ARGS
  return (int)cudaErrorInvalidValue;
}
