// The w4a16 product's body, shared by the w4a16 matmul (K5, csrc/w4a16_matmul.cu) and the
// fused w4 decode suffixes (K6, csrc/w4_suffix.cu): the ring geometry, the exact code
// conversions, and what one ring stage of 32 packed rows x 128 columns does to a block's
// accumulators on either route. csrc/w4a16_matmul.cu's header states the design.
//
// Layout of a stage: kRows packed rows of codes at kWStride bytes (the block's kBN columns
// + 16 bytes of padding: the 8 rows of an ldmatrix phase hit 8 bank groups). Beside it,
// the block's rows of x for the same K entries, each row kXStride<T> bytes: kRows low
// entries (packed rows p), then kRows high entries (packed rows p + K/2), then 16 bytes of
// padding. K5 stages the x rows in the ring beside the codes; K6 keeps the x of a whole
// K range resident in shared memory, one such block of rows per stage-sized chunk.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_mma.cuh"   // mma_bf16, ldmatrix_x4(_trans), cp_async16, cp_async_commit/wait

namespace {

constexpr int kThreads = 128;            // 4 warps; one column per thread on the CUDA cores
constexpr int kMaxGroup = 512;           // MAX_GROUP in the wrapper
constexpr int kBN = 128;                 // columns per block (BLOCK_N in the wrapper)
constexpr int kRows = 32;                // packed rows per ring stage (STAGE_ROWS)
constexpr int kStages = 4;
constexpr int kWStride = 144;            // bytes per ring row of codes (128 + 16)
constexpr int kStageW = kRows * kWStride;

// bytes per row of x: kRows low and kRows high entries, + 16
template <typename T> constexpr int kXStride = 2 * kRows * (int)sizeof(T) + 16;
template <typename T, int BM> constexpr int kStage = kStageW + BM * kXStride<T>;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The signed nibble at bit `shift` of w as an exact f32: (n ^ 8) in the mantissa of 2^23
// is 2^23 + n + 8.
__device__ __forceinline__ float nibble_f32(uint32_t w, int shift) {
  return __uint_as_float(((w >> shift) & 0xFu) ^ 0x4B000008u) - 8388616.0f;
}

// The signed nibbles at bits 0-3 and 16-19 of w as a bf16 pair (low half first): each
// (n ^ 8) in the mantissa of 128.0 is 128 + n + 8; minus 136.0 leaves n exactly.
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t w) {
  uint32_t v = (w & 0x000F000Fu) ^ 0x43084308u;
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v), __float2bfloat162_rn(136.f));
  return *reinterpret_cast<uint32_t*>(&r);
}

// ---------------------------------------------------------------- bf16: tensor cores
//
// The product is taken as y^T = W^T x^T with mma.sync m16n8k16: W^T is the A operand (16
// output columns per tile), x^T the B operand (8 rows of x per tile). Warp w owns the
// block's columns 32 w .. 32 w + 31 as two 16-column tiles mt; this thread's output
// columns are col_m[mt] (tile row g) and col_m[mt] + 1 (row g + 8), col_m[mt] = col_base +
// 32 w + 16 mt + 2 g; its rows of x are 8 j + 2 t and 8 j + 2 t + 1 (accumulators e = h
// and e = 2 + h for the two columns).

template <int NT>
__device__ __forceinline__ void mma_columns(int (&col_m)[2], int col_base) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) col_m[mt] = col_base + warp * 32 + mt * 16 + 2 * (lane >> 2);
}

// The group scales of this thread's columns: row gi of the low half and ng + gi of the
// high half of gscale (row stride ld), 0 past the n valid columns.
__device__ __forceinline__ void mma_scales(float2 (&s_lo)[2], float2 (&s_hi)[2],
                                           const float* gscale, int gi, int ng, int ld, int n,
                                           const int (&col_m)[2]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const bool in = col_m[mt] < n;
    const float* lo = gscale + (size_t)gi * ld + col_m[mt];
    const float* hi = gscale + (size_t)(ng + gi) * ld + col_m[mt];
    s_lo[mt] = in ? __ldg(reinterpret_cast<const float2*>(lo)) : make_float2(0.f, 0.f);
    s_hi[mt] = in ? __ldg(reinterpret_cast<const float2*>(hi)) : make_float2(0.f, 0.f);
  }
}

// One stage: wst the codes, xst the 8 NT rows of x for the same K entries (kXStride<bf16>
// apart). The low and high codes feed two MMAs into the group's sums glo, ghi.
template <int NT>
__device__ __forceinline__ void mma_stage(float (&glo)[2][NT][4], float (&ghi)[2][NT][4],
                                          const uint8_t* wst, const uint8_t* xst) {
  constexpr int kXS = kXStride<__nv_bfloat16>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int ks = 0; ks < kRows / 16; ++ks) {
    // matrices: packed rows 16 ks + 0..7 | 8..15 of columns warp*32 + 0..15 | 16..31
    uint32_t d[4];
    ldmatrix_x4_trans(d, wst + (ks * 16 + (q & 1) * 8 + r8) * kWStride + warp * 32 +
                             (q >> 1) * 16);
    uint32_t alo[2][4], ahi[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const uint32_t e = d[2 * mt], o = d[2 * mt + 1];
      alo[mt][0] = nibbles_bf16x2(e);       ahi[mt][0] = nibbles_bf16x2(e >> 4);
      alo[mt][1] = nibbles_bf16x2(e >> 8);  ahi[mt][1] = nibbles_bf16x2(e >> 12);
      alo[mt][2] = nibbles_bf16x2(o);       ahi[mt][2] = nibbles_bf16x2(o >> 4);
      alo[mt][3] = nibbles_bf16x2(o >> 8);  ahi[mt][3] = nibbles_bf16x2(o >> 12);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      // x rows 8 j + 0..7; matrices: low k 0..7 | 8..15, high k 0..7 | 8..15
      uint32_t b[4];
      ldmatrix_x4(b, xst + (j * 8 + r8) * kXS + (q >> 1) * kRows * 2 + ks * 32 + (q & 1) * 16);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(glo[mt][j], alo[mt], b[0], b[1]);
        mma_bf16(ghi[mt][j], ahi[mt], b[2], b[3]);
      }
    }
  }
}

// The end of a group: its sums times their columns' scales join the accumulator.
template <int NT>
__device__ __forceinline__ void mma_fold(float (&acc)[2][NT][4], float (&glo)[2][NT][4],
                                         float (&ghi)[2][NT][4], const float2 (&s_lo)[2],
                                         const float2 (&s_hi)[2]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sl = e < 2 ? s_lo[mt].x : s_lo[mt].y;
        const float sh = e < 2 ? s_hi[mt].x : s_hi[mt].y;
        acc[mt][j][e] += glo[mt][j][e] * sl + ghi[mt][j][e] * sh;
        glo[mt][j][e] = ghi[mt][j][e] = 0.f;
      }
}

// ---------------------------------------------------------------- f32: CUDA cores
//
// One thread per column; a code becomes f32 through the mantissa of 2^23; x is read as
// float4 broadcasts, BM rows, the group's partial sums in registers, in row order.

// One stage: wst this thread's column of the codes (stage base + threadIdx.x), xst the BM
// rows of x (kXStride<float> bytes apart).
template <int BM>
__device__ __forceinline__ void fma_stage(float (&plo)[BM], float (&phi)[BM],
                                          const uint8_t* wst, const float* xst) {
  constexpr int kXf = kXStride<float> / 4;   // x row stride in floats
#pragma unroll
  for (int r4 = 0; r4 < kRows; r4 += 4) {
    float lo[4], hi[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint32_t b = wst[(r4 + u) * kWStride];
      lo[u] = nibble_f32(b, 0);
      hi[u] = nibble_f32(b, 4);
    }
#pragma unroll
    for (int i = 0; i < BM; ++i) {
      const float4 xl = *reinterpret_cast<const float4*>(xst + i * kXf + r4);
      const float4 xh = *reinterpret_cast<const float4*>(xst + i * kXf + kRows + r4);
      plo[i] = fmaf(xl.w, lo[3], fmaf(xl.z, lo[2], fmaf(xl.y, lo[1], fmaf(xl.x, lo[0], plo[i]))));
      phi[i] = fmaf(xh.w, hi[3], fmaf(xh.z, hi[2], fmaf(xh.y, hi[1], fmaf(xh.x, hi[0], phi[i]))));
    }
  }
}

template <int BM>
__device__ __forceinline__ void fma_fold(float (&acc)[BM], float (&plo)[BM], float (&phi)[BM],
                                         float s_lo, float s_hi) {
#pragma unroll
  for (int i = 0; i < BM; ++i) {
    acc[i] += plo[i] * s_lo + phi[i] * s_hi;
    plo[i] = phi[i] = 0.f;
  }
}

}  // namespace
