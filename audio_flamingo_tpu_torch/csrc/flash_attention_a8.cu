// Int8-QK flash attention (K8) for Hopper (sm_90a), plain C interface bound with ctypes.
//
// Replaces the Pallas TPU kernel audio_flamingo_tpu/ops/pallas/flash_attention_a8.py
// (`flash_attention_a8`, body `_a8_kernel`). The prelude (padding, K mean removal, the
// int8 quantization of q per row and of k per KV head, V in bf16, rowc = qs * ks * scale)
// runs in torch ops before this kernel, as JAX runs it in XLA
// (ops/kernels/flash_attention_a8.py). This kernel is the body:
//
//   s = int32(q_i8 . k_i8^T) * rowc[row]; keys >= kv_len and, under causal masking, keys
//   > row + q_offset masked; online softmax whose running max m advances once per
//   bk-key tile (JAX's tile); p = exp(s - m) rounded to bf16 for P.V with f32
//   accumulation, l summing the unrounded p; o = acc / max(l, 1e-30) in q's dtype.
//
// Layout: q_i8 [B*H, tq_pad, D], k_i8 [B*Hkv, tk_pad, D], v [B*Hkv, tk_pad, D] bf16, rowc
// [B*H, tq_pad] f32 (all contiguous); o [B, Tq, H, D] through the caller's strides.
//
// Design: one block of 4 warps per (64-row q tile, batch x head); each warp owns 16 rows.
// The heaviest causal tiles are scheduled first. Q's int8 fragments stay in registers.
// K and V go through shared memory 64 keys at a time. QK^T is mma.sync m16n8k32 s8.s8.s32
// (exact int32); P.V is mma.sync m16n8k16 bf16 with f32 accumulation, P taken straight
// from the score registers and V's fragments from ldmatrix.trans. To reproduce the
// running max of JAX's bk tiles exactly, each bk tile is swept twice: the first sweep
// takes the tile's row maxima, the second recomputes the same int32 scores and forms p.
// Key chunks past the block's causal frontier or past kv_len are skipped, as JAX skips
// them. No float atomics: a replay is bit-identical. A row with no visible key gives
// o = 0.
//
// Bound on the H100 at the main-path shapes: int8 QK^T ops at 1979 TOPS plus bf16 P.V
// FLOPs at 989 TFLOP/s, 2 B H D per visible pair each: encoder [1,1500,20,64]
// non-causal 8.7 us ([20,1500,20,64]: 0.175 ms); LM [1,1024,28,128] causal 5.7 us,
// [1,16384,28,128] causal 1.46 ms. The second sweep over QK^T adds a third of the
// tensor work, and the simple single-stage loads leave the tensor cores waiting on
// shared memory; wgmma with a TMA ring is the step after this one.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"   // mma_bf16, ldmatrix_x4_trans, pack_bf16, quad_max, quad_sum

namespace {

constexpr int kRows = 64;      // query rows per block: 4 warps x 16
constexpr int kKeys = 64;      // keys per shared-memory chunk
constexpr int kThreads = 128;

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T> __device__ __forceinline__ void store2(T* p, float a, float b);
template <> __device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a,
                                                                  float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// one 64-key chunk of int8 K rows [c0, c0 + 64) into shared memory (row stride D + 16)
template <int D>
__device__ __forceinline__ void load_k(int8_t* sk, const int8_t* kb, int c0, int tid) {
  constexpr int V = D / 16;   // 16-byte vectors per row
  for (int i = tid; i < kKeys * V; i += kThreads) {
    const int r = i / V, c = i % V;
    *reinterpret_cast<int4*>(sk + r * (D + 16) + 16 * c) =
        *reinterpret_cast<const int4*>(kb + (int64_t)(c0 + r) * D + 16 * c);
  }
}

template <int D>
__device__ __forceinline__ void load_v(__nv_bfloat16* sv, const __nv_bfloat16* vb, int c0,
                                       int tid) {
  constexpr int V = D / 8;    // 8 bf16 per 16-byte vector
  for (int i = tid; i < kKeys * V; i += kThreads) {
    const int r = i / V, c = i % V;
    *reinterpret_cast<int4*>(sv + r * (D + 8) + 8 * c) =
        *reinterpret_cast<const int4*>(vb + (int64_t)(c0 + r) * D + 8 * c);
  }
}

// int32 scores of this warp's 16 rows against the 64 keys in shared memory:
// s[j] holds keys 8 j + 2 tig (+1) for rows gq (s[j][0..1]) and gq + 8 (s[j][2..3])
template <int D>
__device__ __forceinline__ void scores(int (&s)[8][4], const int8_t* sk,
                                       const uint32_t (&qf)[D / 32][4], int gq, int tig) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0;
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      const int8_t* kr = sk + (8 * j + gq) * (D + 16) + 32 * kk + 4 * tig;
      mma_s8(s[j], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
             *reinterpret_cast<const uint32_t*>(kr + 16));
    }
  }
}

template <typename TO, int D>
__global__ void __launch_bounds__(kThreads)
fa8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, const float* __restrict__ rowc,
           TO* __restrict__ o, int H, int group, int Tq, int tq_pad, int tk_pad,
           int kv_len, int bk, int causal, int q_offset,
           int64_t sob, int64_t sot, int64_t soh) {
  constexpr int NT = D / 8;     // 8-wide output column tiles
  __shared__ __align__(16) int8_t sk[kKeys * (D + 16)];
  __shared__ __align__(16) __nv_bfloat16 sv[kKeys * (D + 8)];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tig = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;   // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = b * (H / group) + h / group;
  const int ra = q0 + warp * 16 + gq, rb = ra + 8;      // this thread's rows (padded index)

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
  // last visible key of each row, and of the block (its causal frontier)
  const int lim_a = causal ? min(kv_len - 1, ra + q_offset) : kv_len - 1;
  const int lim_b = causal ? min(kv_len - 1, rb + q_offset) : kv_len - 1;
  int kv_end = kv_len;
  if (causal) {
    const long long lim = (long long)q0 + kRows + q_offset;
    if (lim < kv_end) kv_end = lim > 0 ? (int)lim : 0;
  }
  const int8_t* kb = k + (int64_t)kvh * tk_pad * D;
  const __nv_bfloat16* vb = v + (int64_t)kvh * tk_pad * D;

  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int s[8][4];
  for (int t0 = 0; t0 < kv_end; t0 += bk) {
    const int t_end = min(t0 + bk, kv_end);
    // sweep 1: the tile's row maxima
    float mx_a = -INFINITY, mx_b = -INFINITY;
    for (int c0 = t0; c0 < t_end; c0 += kKeys) {
      __syncthreads();
      load_k<D>(sk, kb, c0, tid);
      __syncthreads();
      scores<D>(s, sk, qf, gq, tig);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = c0 + 8 * j + 2 * tig + e;
          if (key <= lim_a) mx_a = fmaxf(mx_a, (float)s[j][e] * ca);
          if (key <= lim_b) mx_b = fmaxf(mx_b, (float)s[j][2 + e] * cb);
        }
    }
    mx_a = quad_max(mx_a);
    mx_b = quad_max(mx_b);
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
    // sweep 2: p against the tile's max, l, and P.V
    float rs_a = 0.f, rs_b = 0.f;
    for (int c0 = t0; c0 < t_end; c0 += kKeys) {
      __syncthreads();
      load_k<D>(sk, kb, c0, tid);
      load_v<D>(sv, vb, c0, tid);
      __syncthreads();
      scores<D>(s, sk, qf, gq, tig);
      float p[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = c0 + 8 * j + 2 * tig + e;
          p[j][e] = key <= lim_a ? expf(__fsub_rn((float)s[j][e] * ca, mu_a)) : 0.f;
          p[j][2 + e] = key <= lim_b ? expf(__fsub_rn((float)s[j][2 + e] * cb, mu_b)) : 0.f;
          rs_a += p[j][e];
          rs_b += p[j][2 + e];
        }
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                               pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                               pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                               pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
        const int mi = lane >> 3;
        const __nv_bfloat16* vrow = sv + (16 * kk + (mi & 1) * 8 + (lane & 7)) * (D + 8)
                                    + 8 * (mi >> 1);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, vrow + 16 * np);
          mma_bf16(acc[2 * np], a, r[0], r[1]);
          mma_bf16(acc[2 * np + 1], a, r[2], r[3]);
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
           int q_offset, int64_t sob, int64_t sot, int64_t soh, cudaStream_t stream) {
  const dim3 grid((Tq + kRows - 1) / kRows, B * H);
  fa8_kernel<TO, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(rowc),
      static_cast<TO*>(o), H, H / Hkv, Tq, tq_pad, tk_pad, kv_len, bk, causal, q_offset,
      sob, sot, soh);
  return (int)cudaGetLastError();
}

}  // namespace

// out_dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success);
// cudaErrorInvalidValue for a dtype, head dim or geometry the kernel does not take.
extern "C" int af_flash_attention_a8(const void* q, const void* k, const void* v,
                                     const void* rowc, void* o, int out_dtype, int B, int H,
                                     int Hkv, int D, int Tq, int tq_pad, int tk_pad,
                                     int kv_len, int bk, int causal, int q_offset,
                                     int64_t sob, int64_t sot, int64_t soh, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || B * H > 65535 || Tq <= 0 ||
      Tq > tq_pad || tq_pad % kRows != 0 || kv_len <= 0 || kv_len > tk_pad ||
      bk % kKeys != 0 || tk_pad % bk != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AF_FA8_ARGS q, k, v, rowc, o, B, H, Hkv, Tq, tq_pad, tk_pad, kv_len, bk, causal, \
                    q_offset, sob, sot, soh, s
  if (out_dtype == 0 && D == 64) return launch<float, 64>(AF_FA8_ARGS);
  if (out_dtype == 0 && D == 128) return launch<float, 128>(AF_FA8_ARGS);
  if (out_dtype == 1 && D == 64) return launch<__nv_bfloat16, 64>(AF_FA8_ARGS);
  if (out_dtype == 1 && D == 128) return launch<__nv_bfloat16, 128>(AF_FA8_ARGS);
#undef AF_FA8_ARGS
  return (int)cudaErrorInvalidValue;
}
