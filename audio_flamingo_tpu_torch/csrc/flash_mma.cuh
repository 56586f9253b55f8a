// Building blocks of the bf16 tensor-core attention kernels (K2 and K7 in bf16, K8's P.V),
// for Hopper (sm_90a): warp-level mma.sync, ldmatrix, and cp.async copies into shared
// memory. Everything here has internal linkage, so each source that includes it keeps its
// own copy and the sources still link into one library.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16 inputs and .f32 accumulators), for
// lane = 4 g + t (g = lane / 4, t = lane % 4):
//   A (16 x 16, row major)  a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..],
//                           a3 = A[g+8][2t+8..]
//   B (16 x 8, "col")       b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   C (16 x 8, f32)         c0, c1 = C[g][2t], C[g][2t+1]; c2, c3 = C[g+8][2t], C[g+8][2t+1]
// So the accumulators of two neighbouring 8-column tiles of C, converted to bf16 pairs,
// are already the A fragment of the next product over those 16 columns (pack_a below).
//
// Tiles live in shared memory as rows of D bf16 padded to D + 8 elements (kLd): 16 bytes
// of padding move each row 4 banks on, so the 8 row addresses of one ldmatrix phase hit
// distinct banks, and every row stays 16-byte aligned for cp.async.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

template <int D> constexpr int kLd = D + 8;   // shared-memory row stride of a tile, elements

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 b16 matrices; lanes 8 i .. 8 i + 7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16 bytes global -> shared, bypassing L1; zero-filled (nothing read) when !in
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(src), "r"(in ? 16 : 0));
}

// 4 bytes global -> shared (a strided f32 column), zero-filled when !in
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(addr), "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are still in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment over 16 columns from the f32 accumulators of its two 8-column tiles
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows [r0, r0 + 64) of one head of a [.., T, .., D] bf16 tensor (row stride `stride`
// elements, 16-byte aligned) into a [64][kLd<D>] tile by cp.async; rows at or past n are
// zero-filled. All NT threads of the block take part; the caller commits the group.
template <int D, int NT>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                int64_t stride, int r0, int n, int tid) {
  constexpr int C = D / 8;   // 16-byte chunks per row
  static_assert(64 * C % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int j = 0; j < 64 * C / NT; ++j) {
    const int i = tid + j * NT;
    const int r = i / C, c = i % C;
    const int t = r0 + r;
    const bool in = t < n;
    cp_async16(dst + r * kLd<D> + 8 * c, in ? src + (int64_t)t * stride + 8 * c : src, in);
  }
}

// A fragments of one warp's 16 rows [row0, row0 + 16) of a tile, k-step kk (columns
// 16 kk .. 16 kk + 15), by ldmatrix (not transposed)
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int row0,
                                       int kk, int lane) {
  ldmatrix_x4(a, tile + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd<D> + 16 * kk
                     + (lane >> 4) * 8);
}

// B fragments of C = A X^T for X's rows [n0, n0 + 16) (two 8-column tiles of C) at k-step
// kk: r[0], r[1] for rows n0 .. n0 + 7, r[2], r[3] for n0 + 8 .. n0 + 15
template <int D>
__device__ __forceinline__ void load_b_rows(uint32_t (&r)[4], const __nv_bfloat16* tile, int n0,
                                            int kk, int lane) {
  ldmatrix_x4(r, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * kLd<D> + 16 * kk
                     + ((lane >> 3) & 1) * 8);
}

// B fragments of C = A X for X's rows [k0, k0 + 16) (the k-step) and columns
// [c0, c0 + 16): r[0], r[1] for columns c0 .. c0 + 7, r[2], r[3] for c0 + 8 .. c0 + 15
template <int D>
__device__ __forceinline__ void load_b_trans(uint32_t (&r)[4], const __nv_bfloat16* tile,
                                             int k0, int c0, int lane) {
  ldmatrix_x4_trans(r, tile + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kLd<D> + c0
                           + (lane >> 4) * 8);
}

// acc[D/8][4] += A (16 x 16) X[k0 .. k0 + 16, :] over all D columns of X
template <int D>
__device__ __forceinline__ void mma_a_x(float (&acc)[D / 8][4], const uint32_t (&a)[4],
                                        const __nv_bfloat16* tile, int k0, int lane) {
#pragma unroll
  for (int np = 0; np < D / 16; ++np) {
    uint32_t r[4];
    load_b_trans<D>(r, tile, k0, 16 * np, lane);
    mma_bf16(acc[2 * np], a, r[0], r[1]);
    mma_bf16(acc[2 * np + 1], a, r[2], r[3]);
  }
}

// One warp's 16 x D f32 accumulator rows, row a (= g) times mul_a and row b (= g + 8)
// times mul_b, as bf16 through the warp's own 16 rows of a shared tile (`stage`, row
// stride kLd<D>), then out with 16-byte stores: row r goes to dst + (row0 + r) * stride
// when row0 + r < n.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], float mul_a,
                                           float mul_b, __nv_bfloat16* stage,
                                           __nv_bfloat16* dst, int64_t stride, int row0, int n,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    *reinterpret_cast<__nv_bfloat162*>(stage + g * kLd<D> + 8 * c + 2 * t) =
        __floats2bfloat162_rn(acc[c][0] * mul_a, acc[c][1] * mul_a);
    *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8) * kLd<D> + 8 * c + 2 * t) =
        __floats2bfloat162_rn(acc[c][2] * mul_b, acc[c][3] * mul_b);
  }
  __syncwarp();
  constexpr int C = D / 8;
#pragma unroll
  for (int j = 0; j < C / 2; ++j) {   // 16 rows x C chunks over 32 lanes
    const int i = lane + 32 * j;
    const int r = i / C, c = i % C;
    if (row0 + r < n)
      *reinterpret_cast<int4*>(dst + (int64_t)(row0 + r) * stride + 8 * c) =
          *reinterpret_cast<const int4*>(stage + r * kLd<D> + 8 * c);
  }
}

}  // namespace
