// Flash-attention forward for Hopper (sm_90a), plain C interface bound with ctypes.
//
// Replaces the Pallas TPU kernel audio_flamingo_tpu/ops/pallas/flash_attention.py
// (`_flash_forward`, kernel `_flash_kernel`): tiled online-softmax attention, GQA by
// head index, causal masking with a q offset, keys past Tk masked in the kernel, f32
// softmax statistics and accumulator, output `o` in the input dtype plus the per-row
// log-sum-exp in f32 laid out [B, Tq, H].
//
// Layout: q [B, Tq, H, D], k/v [B, Tk, Hkv, D], o like q, all read and written through
// the caller's strides (the last dim must be contiguous), so no transposed copies.
//
// Design: one thread block per (64-row q tile, q head, batch) and a loop inside the block
// over 64-key K/V tiles staged in shared memory as f32. 256 threads as a 16 x 16 grid;
// thread (ty, tx) owns rows ty + 16 i (i < 4) of the tile. For S = Q K^T it computes keys
// tx + 16 j (j < 4), a 4 x 4 register tile fed by 128-bit shared loads along D; for
// O += P V it owns dims 4 tx + 64 c .. + 3. Row max and row sum reduce across the 16
// lanes of a row with warp shuffles. In bf16, P is rounded to bf16 before P.V and l sums
// the unrounded P, as in the JAX kernel. A row that sees no key gives o = 0 and
// lse = -inf (the port's convention; see flash_attention_reference).
//
// Bound on the H100 at the main-path shapes: bf16 tensor-core FLOPs. Encoder
// [1,1500,20,64] non-causal: 4*T^2*D*H = 1.15e10 FLOP = 11.6 us at 989 TFLOP/s; LM
// prefill [1,1024,28,128] causal: ~7.5e9 FLOP = 7.6 us. This kernel runs both dots on
// the f32 CUDA cores (67 TFLOP/s peak) and so leaves most of that on the table: the
// next step is mma.sync/wgmma on bf16 tiles with a TMA-fed K/V ring.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // q rows per block
constexpr int kBK = 64;       // keys per K/V tile
constexpr int kThreads = 256;
constexpr int kPS = kBK + 4;  // P row stride (floats): 16-byte aligned rows

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// p as P.V consumes it: rounded to the input dtype, as the JAX kernel's
// p.astype(q.dtype) (exact for f32); the row sum l adds the unrounded p.
template <typename T> __device__ __forceinline__ float round_p(float p);
template <> __device__ __forceinline__ float round_p<float>(float p) { return p; }
template <> __device__ __forceinline__ float round_p<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16(p));
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_floats() {
  // Q and K rows padded by 4 floats (keeps 16-byte alignment, spreads banks), V unpadded.
  return (size_t)kBQ * (D + 4) + (size_t)kBK * (D + 4) + (size_t)kBK * D + (size_t)kBQ * kPS;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse,
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

  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + hk * skh;
  const T* vb = v + b * svb + hk * svh;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int t = q0 + r;
    sq[r * QS + c] = t < Tq ? to_f32(qb[t * sqt + c]) : 0.f;
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
      sk[r * QS + c] = in ? to_f32(kb[t * skt + c]) : 0.f;
      sv[r * D + c] = in ? to_f32(vb[t * svt + c]) : 0.f;
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
      for (int j = 0; j < 4; ++j) sp[(ty + 16 * i) * kPS + tx + 16 * j] = round_p<T>(s[i][j]);
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
    T* orow = o + b * sob + row * sot + h * soh;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = 4 * tx + 64 * c;
      orow[d + 0] = from_f32<T>(any ? acc[i][c].x / l[i] : 0.f);
      orow[d + 1] = from_f32<T>(any ? acc[i][c].y / l[i] : 0.f);
      orow[d + 2] = from_f32<T>(any ? acc[i][c].z / l[i] : 0.f);
      orow[d + 3] = from_f32<T>(any ? acc[i][c].w / l[i] : 0.f);
    }
    if (tx == 0) lse[((int64_t)b * Tq + row) * H + h] = any ? m[i] + logf(l[i]) : -INFINITY;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Tq, int Tk, int H, int Hkv,
           int64_t sqb, int64_t sqt, int64_t sqh,
           int64_t skb, int64_t skt, int64_t skh,
           int64_t svb, int64_t svt, int64_t svh,
           int64_t sob, int64_t sot, int64_t soh,
           float scale, int causal, int q_offset, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, Tq, Tk, H, H / Hkv,
      sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh,
      scale, causal, q_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success);
// cudaErrorInvalidValue for a dtype, head dim or shape the kernel does not take.
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
  if (dtype == 0 && D == 64) return launch<float, 64>(AF_FLASH_ARGS);
  if (dtype == 0 && D == 128) return launch<float, 128>(AF_FLASH_ARGS);
  if (dtype == 1 && D == 64) return launch<__nv_bfloat16, 64>(AF_FLASH_ARGS);
  if (dtype == 1 && D == 128) return launch<__nv_bfloat16, 128>(AF_FLASH_ARGS);
#undef AF_FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}
