// Fused w4 decode-layer suffixes (K6) for Hopper (sm_90a), plain C interface (ctypes).
//
// Replaces the Pallas TPU kernels audio_flamingo_tpu/ops/pallas/quant4_block.py
// `w4_suffix_a` (:225) and `w4_suffix_b` (:288), which split a decode layer's matmuls
// around its attention:
//   A: act, h = silu(gate) * up, h  where  h = attn @ W_o + h_res (f32),
//      hn = rms(h) * ln2 (f32, rounded to the dtype as the next input), gate|up = hn @ W_gu
//   B: h2, qkv = h2, hn2 @ W_qkv(next layer)  where  h2 = act @ W_down + h (f32),
//      hn2 = rms(h2) * ln1(next layer)
// with rms(h) = h * rsqrt(mean(h^2) + eps) in f32 and the weight applied in f32 after it
// (the kernel's own norm, not the model's rms_norm, which rounds before the weight).
// Outputs are rounded to the input dtype (f32 or bf16); the caller adds the qkv bias.
//
// Bound on the H100: bytes, the weights streamed once. 7B, m <= 8: A reads W_o
// [1792, 3584] 6.82 MB and W_gu [1792, 37888] 72.14 MB (codes + f32 scales) = 23.6 us at
// 3.35 TB/s; B reads W_down [9472, 3584] 36.07 MB and W_qkv [1792, 4608] 8.77 MB = 13.4 us.
// The work between the products is tiny (a norm over one row of 3584); what costs is
// the dependency: the second product needs the norm, the norm needs every column of the
// first product, and at m = 1 the first product is only 7-36 MB.
//
// Design: each suffix is ONE launch of a persistent grid that the card holds at once
// (occupancy x SMs, from cudaOccupancyMaxActiveBlocksPerMultiprocessor, launched with
// cudaLaunchAttributeCooperative, which refuses a grid that cannot be co-resident and
// which CUDA-graph capture takes).
//   - Work items: each product is cut into (column tile of 128, K split of whole groups)
//     items, numbered split-major; block b takes items b, b + B, ... of each product, so
//     the blocks at work at one time cover whole rows of the weights, as K5's grid does.
//     ops/kernels/w4_suffix.plan picks the splits from the grid: the fewest ring stages on
//     the critical path (the longest block's items, each with a fixed cost, plus the
//     splits' sum), which at the 7B shapes is one item or two per block. For gate|up an
//     item is a pair: gate tile j and up tile j over the same K range, so the last split
//     of the pair can write silu(gate) * up.
//   - An item is K5's loop (csrc/w4_mma.cuh: the bf16 mma.sync stage, the f32 FMA
//     stage): the codes stream through a 4-stage cp.async ring, three stages in flight;
//     x of its K range sits in shared memory (product 1: copied by cp.async with the first
//     stage; product 2: hn formed there from h in f32, the norm and its weight, rounded
//     as the plain version rounds it, so hn never goes through HBM). Its partial sums go
//     to its split's slot.
//   - Product 1's splits are added between two grid barriers by all blocks: unit (row,
//     tile) u of m x tiles, strided over the blocks, a column per thread: the splits in
//     split order plus the residual give h (written as the dtype and in f32) and the
//     unit's sum of h^2 (slots [m, tiles]). Before the first barrier each block starts
//     the first three stages of its product-2 item: the weights do not depend on h.
//     After the second each block adds a row's slots in tile order to rsqrt(mean + eps).
//   - Product 2 ends per tile: the last split to finish (an integer ticket per tile,
//     left zero) adds the splits in order and writes silu(gate) * up (A) or qkv (B).
//   - The barrier: an arrival counter and a generation word in a per-device buffer,
//     release/acquire at gpu scope, the counter left zero; a spin that traps after a bound,
//     so a fault ends with an error and not a hang.
// No float atomics: every sum across blocks is taken in a fixed order, so replays agree
// bit for bit and the result does not depend on the grid's size.
//
// What bounds it now: the weight stream reaches about 2.1 TB/s (the rate of K5's grid on
// these 128-byte row segments), and product 1 is a chain of latencies (its loads, the
// barrier, the splits' sum, the barrier) during which HBM is mostly idle: started early,
// product 2's loads queue in front of that chain and lengthen it by as much as they save
// (measured: prefetching the rest of an item into L2 made A 35 % slower).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "w4_mma.cuh"   // ring geometry, code conversions, one stage of either route

namespace {

constexpr int kXRows = 640;             // packed rows of x a block holds (X_ROWS), or one group
constexpr int kMaxRows = 8;             // MAX_ROWS in the wrapper
constexpr int kControl = 4096;          // ints of the per-device control buffer (CONTROL_INTS):
                                        // 2 barrier words, then a ticket per tile of product 2
constexpr unsigned kSpinLimit = 1u << 25;   // ~3 s of polling before a barrier traps
// One product of a suffix as the blocks walk it. Item i of tiles x splits is split
// s = i / tiles of tile t = i % tiles; a tile covers kBN columns of each of its `segs`
// segments (gate|up: 2, seg_off = f columns apart).
struct Phase {
  const int8_t* w_p;     // the layer's codes [kp, ld]
  const float* gscale;   // its scales [2 kp / group, ld]
  float* partials;       // [splits, m, ld] f32
  int* tickets;          // [tiles], zero, left zero (product 2 only)
  int kp, ld, n, seg_off, segs, group, ng, per, splits, tiles, items;
};

template <typename T>
struct Args {
  Phase ph[2];
  const T* x;            // phase 1's input [m, 2 kp of phase 1]
  const T* res;          // the residual [m, d]
  const void* norm_w;    // [d], f32 when norm_f32, else T
  T* h_out;              // [m, d]
  T* out;                // act [m, f] (gated) or qkv [m, n_qkv]
  float* hf;             // [m, d] h in f32
  float* slots;          // [m, tiles of phase 1] each tile's sum of h^2 per row
  unsigned* bar;         // [2] arrivals, generation
  int m, d, norm_f32;
  float eps;
};

// One work item: split s of tile t; nch stages a segment, from packed row p0.
struct Item {
  int s, t, nch, p0;
};

__device__ __forceinline__ Item item_of(const Phase& P, int i) {
  Item it;
  it.s = i / P.tiles;
  it.t = i - it.s * P.tiles;
  const int g0 = it.s * P.per, g1 = min(P.ng, g0 + P.per);
  it.nch = (g1 - g0) * (P.group / kRows);
  it.p0 = g0 * P.group;
  return it;
}

// Stage j of item `it` (segment j / nch, packed rows p0 + 32 (j % nch) ..) into st:
// thread t copies 16 bytes of packed rows t/8 and t/8 + 16 at byte (t % 8) * 16 of the
// tile's columns; columns past the segment's n read nothing.
__device__ __forceinline__ void issue(uint8_t* st, const Item& it, int j, const Phase& P) {
  const int t = threadIdx.x, ch = t & 7;
  const int seg = j / it.nch, c = j - seg * it.nch;
  const int col = it.t * kBN + ch * 16;
  const bool in = col < P.n;
  const size_t row = (size_t)it.p0 + (size_t)c * kRows + (t >> 3);
  const int8_t* src = P.w_p + row * P.ld + seg * P.seg_off + col;
#pragma unroll
  for (int r = 0; r < kRows * 8 / kThreads; ++r)
    cp_async16(st + ((t >> 3) + r * (kThreads / 8)) * kWStride + ch * 16,
               in ? src + (size_t)r * (kThreads / 8) * P.ld : P.w_p, in);
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" :: "l"(p), "r"(v) : "memory");
}

// Every block of the grid arrives before any leaves; what a block wrote before is visible
// to every block after. bar[0] counts arrivals (left zero), bar[1] is the generation.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned gen = ld_acquire(bar + 1);   // cannot move before every block arrives
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      bar[0] = 0u;
      st_release(bar + 1, gen + 1);
    } else {
      unsigned spins = 0;
      while (ld_acquire(bar + 1) == gen) {
        __nanosleep(100);
        if (++spins > kSpinLimit) __trap();   // a grid that is not co-resident: fail, not hang
      }
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
}

// x of an item's K range into xbuf: per stage-sized chunk cc of the range, BM rows of
// kXStride<T> bytes (kRows low entries, kRows high entries); only rows < m are written
// (the rest were zeroed once).
// Product 1: x is the call's input, copied by cp.async in the caller's current commit
// group (it lands with the item's first stage).
template <typename T, int BM>
__device__ __forceinline__ void copy_x(uint8_t* xbuf, const Args<T>& a, const Phase& P,
                                       const Item& it) {
  constexpr int kE = 16 / (int)sizeof(T);   // entries a 16-byte copy
  constexpr int kQ = 2 * kRows / kE;        // copies per row of a chunk
  const int total = it.nch * a.m * kQ;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    const int q = idx % kQ, r = (idx / kQ) % a.m, cc = idx / (kQ * a.m);
    const int kk = (q >= kQ / 2 ? P.kp : 0) + it.p0 + cc * kRows + (q % (kQ / 2)) * kE;
    cp_async16(xbuf + (cc * BM + r) * kXStride<T> + q * 16,
               a.x + (size_t)r * 2 * P.kp + kk, true);
  }
}

// Product 2: hn = (h * inv) * w, rounded to T. A thread takes 4 entries of the range
// at a time: their weights once, then h of every row (all loads in flight together).
template <typename T, int BM>
__device__ __forceinline__ void build_hn(uint8_t* xbuf, const Args<T>& a, const Phase& P,
                                         const Item& it, const float* inv) {
  constexpr int kQ = 2 * kRows / 4;   // 4-entry groups per row of a chunk
  const int total = it.nch * kQ;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    const int q = idx % kQ, cc = idx / kQ;
    const int kk = (q >= kQ / 2 ? P.kp : 0) + it.p0 + cc * kRows + (q % (kQ / 2)) * 4;
    const float4 w = a.norm_f32 ? load4(static_cast<const float*>(a.norm_w) + kk)
                                : load4(static_cast<const T*>(a.norm_w) + kk);
    float4 h[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r)
      if (r < a.m) h[r] = __ldcg(reinterpret_cast<const float4*>(a.hf + (size_t)r * a.d + kk));
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r >= a.m) break;
      const float s = inv[r];
      store4(reinterpret_cast<T*>(xbuf + (cc * BM + r) * kXStride<T>) + q * 4,
             make_float4((h[r].x * s) * w.x, (h[r].y * s) * w.y, (h[r].z * s) * w.z,
                         (h[r].w * s) * w.w));
    }
  }
}

// sums[j][r] = the partial sums p[(s m + r) ld + j part_off] over the splits s in split
// order, for rows r < m and parts j; loads issued 32 at a time before any is added.
template <int kParts>
__device__ __forceinline__ void split_sums(float (&sums)[kParts][kMaxRows], const float* p,
                                           int part_off, size_t ld, int splits, int m, bool in) {
  constexpr int kBatch = 32 / kParts;
#pragma unroll
  for (int j = 0; j < kParts; ++j)
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) sums[j][r] = 0.f;
  const int total = splits * m;   // q = s m + r, so per row the order is the splits' order
  for (int q0 = 0; q0 < total; q0 += kBatch) {
    float v[kParts][kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
#pragma unroll
      for (int j = 0; j < kParts; ++j)
        v[j][u] = in && q0 + u < total ? __ldcg(p + (size_t)(q0 + u) * ld + j * part_off) : 0.f;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (q0 + u >= total) break;
      const int r = (q0 + u) % m;
#pragma unroll
      for (int rr = 0; rr < kMaxRows; ++rr)
        if (rr == r)
#pragma unroll
          for (int j = 0; j < kParts; ++j) sums[j][rr] += v[j][u];
    }
  }
}

// Between the two barriers: unit u = (row r, tile t) of product 1, units strided over
// the blocks, a column per thread: h = the splits' partial sums in split order plus the
// residual, written as T and as f32, and the unit's sum of h^2 into slots[r][t]. Every
// block takes at most a few units, so the split sums are one round of loads.
template <typename T>
__device__ __forceinline__ void reduce_h(const Args<T>& a, float (&red)[kThreads / 32]) {
  const Phase& P = a.ph[0];
  const int units = a.m * P.tiles;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int r = u / P.tiles, t = u - r * P.tiles;
    const int col = t * kBN + threadIdx.x;
    const bool in = col < a.d;
    float sums[1][kMaxRows];
    const float res = in ? to_f32(a.res[(size_t)r * a.d + col]) : 0.f;
    split_sums<1>(sums, P.partials + (size_t)r * P.ld + col, 0, (size_t)a.m * P.ld, P.splits,
                  1, in);
    float sq = 0.f;
    if (in) {
      const float h = sums[0][0] + res;
      a.h_out[(size_t)r * a.d + col] = from_f32<T>(h);
      a.hf[(size_t)r * a.d + col] = h;
      sq = h * h;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = sq;
    __syncthreads();
    if (threadIdx.x == 0) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) v += red[w];
      a.slots[u] = v;   // slots[r][t]
    }
    __syncthreads();
  }
}

// The last split of phase 2's tile t: the splits in order; silu(gate) * up or qkv.
template <typename T, bool kGated>
__device__ __forceinline__ void finish_out(const Args<T>& a, int t) {
  const Phase& P = a.ph[1];
  const int col = t * kBN + threadIdx.x, m = a.m;
  const bool in = col < P.n;
  float sums[kGated ? 2 : 1][kMaxRows];
  split_sums<kGated ? 2 : 1>(sums, P.partials + col, P.seg_off, P.ld, P.splits, m, in);
  if (!in) return;
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (r >= m) break;
    const float g = sums[0][r];
    a.out[(size_t)r * P.n + col] =
        from_f32<T>(kGated ? g / (1.f + expf(-g)) * sums[kGated ? 1 : 0][r] : g);
  }
}

// After the second barrier: the slot array staged in shared memory, then each row's
// tiles' sums of squares in tile order -> inv[r] = rsqrt(mean + eps).
template <typename T>
__device__ __forceinline__ void norm_scale(const Args<T>& a, float* slots, float* inv) {
  const int n_slots = a.ph[0].tiles * a.m;
  for (int i = threadIdx.x; i < n_slots; i += kThreads) slots[i] = __ldcg(a.slots + i);
  __syncthreads();
  if (threadIdx.x < a.m) {
    float ss = 0.f;
    for (int t = 0; t < a.ph[0].tiles; ++t) ss += slots[threadIdx.x * a.ph[0].tiles + t];
    inv[threadIdx.x] = rsqrtf(ss / (float)a.d + a.eps);
  }
}


// One work item of product ph: x of its K range into xbuf, its stages through the ring
// (the first `ready` of them already issued into slots 0..), each segment's sums into
// its split's partial sums, then its ticket; the tile's last split finishes the tile.
template <typename T, int BM, bool kGated>
__device__ __forceinline__ void run_item(const Args<T>& a, int ph, int i, int ready,
                                         uint8_t* smem, uint8_t* xbuf, const float* inv,
                                         int& last) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  constexpr int NT = kMma ? BM / 8 : 1;
  const Phase& P = a.ph[ph];
  const Item it = item_of(P, i);
  const int total = P.segs * it.nch, per_group = P.group / kRows;
  if (ph == 0) copy_x<T, BM>(xbuf, a, P, it);   // lands with the first stage's group
  for (int j = ready; j < kStages - 1; ++j) {
    if (j < total) issue(smem + j * kStageW, it, j, P);
    cp_async_commit();
  }
  if (ph == 1) build_hn<T, BM>(xbuf, a, P, it, inv);   // visible after the loop's first barrier

  // accumulators: bf16 as K5's w4_mma_kernel, f32 as its w4_fma_kernel
  float acc[2][NT][4], glo[2][NT][4], ghi[2][NT][4];
  float facc[BM], plo[BM], phi[BM];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = glo[mt][j][e] = ghi[mt][j][e] = 0.f;
#pragma unroll
  for (int i = 0; i < BM; ++i) facc[i] = plo[i] = phi[i] = 0.f;
  float2 s_lo[2], s_hi[2];
  float fs_lo = 0.f, fs_hi = 0.f;
  int col_m[2];
  if constexpr (kMma) mma_columns<NT>(col_m, it.t * kBN);
  const int col = it.t * kBN + threadIdx.x;

  int seg = 0, c = 0;
  for (int j = 0; j < total; ++j) {
    if (c % per_group == 0) {   // the group's scales, needed at its end
      const int gi = it.s * P.per + c / per_group;
      const float* gs = P.gscale + seg * P.seg_off;
      if constexpr (kMma) {
        mma_scales(s_lo, s_hi, gs, gi, P.ng, P.ld, P.n, col_m);
      } else if (col < P.n) {
        fs_lo = __ldg(gs + (size_t)gi * P.ld + col);
        fs_hi = __ldg(gs + (size_t)(P.ng + gi) * P.ld + col);
      }
    }
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage j has landed for every thread; stage j - 1 is consumed
    if (j + kStages - 1 < total) issue(smem + ((j + kStages - 1) % kStages) * kStageW, it,
                                       j + kStages - 1, P);
    cp_async_commit();
    const uint8_t* st = smem + (j % kStages) * kStageW;
    const uint8_t* xst = xbuf + c * BM * kXStride<T>;
    if constexpr (kMma) {
      mma_stage<NT>(glo, ghi, st, xst);
      if ((c + 1) % per_group == 0) mma_fold<NT>(acc, glo, ghi, s_lo, s_hi);
    } else {
      fma_stage<BM>(plo, phi, st + threadIdx.x, reinterpret_cast<const float*>(xst));
      if ((c + 1) % per_group == 0) fma_fold<BM>(facc, plo, phi, fs_lo, fs_hi);
    }
    if (++c < it.nch) continue;
    // the segment's partial sums into its split's slot
    float* dst = P.partials + (size_t)it.s * a.m * P.ld + seg * P.seg_off;
    if constexpr (kMma) {
      const int t4 = threadIdx.x & 3;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int jj = 0; jj < NT; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = jj * 8 + 2 * t4 + h;
            if (col_m[mt] < P.n && row < a.m)
              *reinterpret_cast<float2*>(dst + (size_t)row * P.ld + col_m[mt]) =
                  make_float2(acc[mt][jj][h], acc[mt][jj][2 + h]);
          }
#pragma unroll
        for (int jj = 0; jj < NT; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][jj][e] = 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < BM; ++i) {
        if (col < P.n && i < a.m) dst[(size_t)i * P.ld + col] = facc[i];
        facc[i] = 0.f;
      }
    }
    c = 0;
    ++seg;
  }
  if (ph == 0) {   // product 1's splits are added between the barriers
    __syncthreads();
    return;
  }
  // the item is done: is it its tile's last split? (the block's partial sums are
  // published by the barrier and thread 0's fence before its ticket)
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    int* tk = P.tickets + it.t;
    last = atomicAdd(tk, 1) == P.splits - 1;
    if (last) *tk = 0;   // ready for the next launch
  }
  __syncthreads();
  if (last) {
    __threadfence();
    finish_out<T, kGated>(a, it.t);
  }
}

// grid: the blocks the card holds at once; dynamic shared memory smem_bytes<T, BM>(group).
template <typename T, int BM, bool kGated>
__global__ void __launch_bounds__(kThreads)
w4_suffix_kernel(const __grid_constant__ Args<T> a) {
  static_assert(!std::is_same<T, __nv_bfloat16>::value || BM == 8, "bf16 takes 8 rows a block");
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* xbuf = smem + kStages * kStageW;
  __shared__ float red[kThreads / 32];
  __shared__ float inv[kMaxRows];
  __shared__ int last;
  {   // rows past m of x stay zero: copy_x and build_hn write rows < m only
    const int group = a.ph[0].group > a.ph[1].group ? a.ph[0].group : a.ph[1].group;
    const int n16 = (group > kXRows ? group : kXRows) / kRows * BM * kXStride<T> / 16;
    for (int i = threadIdx.x; i < n16; i += kThreads)
      reinterpret_cast<uint4*>(xbuf)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int i = blockIdx.x; i < a.ph[0].items; i += gridDim.x)
    run_item<T, BM, kGated>(a, 0, i, 0, smem, xbuf, inv, last);
  // Every stage of product 1 is consumed: start this block's first stages of product 2
  // (its weights do not depend on h), then wait for the grid.
  int ready = 0;
  if (blockIdx.x < a.ph[1].items) {
    const Item it = item_of(a.ph[1], blockIdx.x);
    const int total = a.ph[1].segs * it.nch;
    for (; ready < kStages - 1; ++ready) {
      if (ready < total) issue(smem + ready * kStageW, it, ready, a.ph[1]);
      cp_async_commit();
    }
  }
  grid_barrier(a.bar);   // every split of product 1 is written
  reduce_h<T>(a, red);
  grid_barrier(a.bar);   // h and the slots are complete
  // the slots staged in the ring slot the prefetch leaves free
  norm_scale(a, reinterpret_cast<float*>(smem + (kStages - 1) * kStageW), inv);
  __syncthreads();
  for (int i = blockIdx.x; i < a.ph[1].items; i += gridDim.x) {
    run_item<T, BM, kGated>(a, 1, i, i == blockIdx.x ? ready : 0, smem, xbuf, inv, last);
  }
}

template <typename T, int BM>
size_t smem_bytes(int group) {
  const int x_chunks = (group > kXRows ? group : kXRows) / kRows;
  return (size_t)kStages * kStageW + (size_t)x_chunks * BM * kXStride<T>;
}

int device_sms(int dev) {
  static int sms[64] = {};
  if (dev < 0 || dev >= 64) return 0;
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

// The blocks the card holds at once for this kernel: its occupancy times the SM count
// (set once per device and shared-memory size; the attribute is set with it).
template <typename T, int BM, bool kGated>
cudaError_t grid_blocks(size_t smem, int* blocks) {
  static int cached[64] = {};
  static size_t cached_smem[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cached[dev] == 0 || cached_smem[dev] != smem) {
    auto kernel = w4_suffix_kernel<T, BM, kGated>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached[dev] = per_sm * device_sms(dev);
    cached_smem[dev] = smem;
  }
  *blocks = cached[dev];
  return cudaSuccess;
}

template <typename T, int BM, bool kGated>
cudaError_t launch(const Args<T>& a, int group, cudaStream_t st) {
  const size_t smem = smem_bytes<T, BM>(group);
  int blocks = 0;
  cudaError_t err = grid_blocks<T, BM, kGated>(smem, &blocks);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, w4_suffix_kernel<T, BM, kGated>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// rows of x per block: bf16 8 (one mma.sync n-tile); f32 1, 2, 4 or 8 (rows_per_block)
int block_rows(int dtype, int m) {
  return dtype == 1 ? 8 : m <= 1 ? 1 : m <= 2 ? 2 : m <= 4 ? 4 : 8;
}

template <bool kGated>
cudaError_t dispatch(int dtype, int m, const void* args, int group, cudaStream_t st) {
  using B16 = __nv_bfloat16;
  if (dtype == 1) return launch<B16, 8, kGated>(*static_cast<const Args<B16>*>(args), group, st);
  const Args<float>& a = *static_cast<const Args<float>*>(args);
  switch (block_rows(dtype, m)) {
    case 1: return launch<float, 1, kGated>(a, group, st);
    case 2: return launch<float, 2, kGated>(a, group, st);
    case 4: return launch<float, 4, kGated>(a, group, st);
    default: return launch<float, 8, kGated>(a, group, st);
  }
}

template <bool kGated>
cudaError_t blocks_for(int dtype, int m, int group, int* blocks) {
  using B16 = __nv_bfloat16;
  if (dtype == 1) return grid_blocks<B16, 8, kGated>(smem_bytes<B16, 8>(group), blocks);
  switch (block_rows(dtype, m)) {
    case 1: return grid_blocks<float, 1, kGated>(smem_bytes<float, 1>(group), blocks);
    case 2: return grid_blocks<float, 2, kGated>(smem_bytes<float, 2>(group), blocks);
    case 4: return grid_blocks<float, 4, kGated>(smem_bytes<float, 4>(group), blocks);
    default: return grid_blocks<float, 8, kGated>(smem_bytes<float, 8>(group), blocks);
  }
}

// A phase over one layer's product: kp packed rows, `segs` segments of n columns each
// (seg_off apart in rows of ld), `per` groups a split. Returns false for what the kernel
// does not take (N a multiple of 16, groups in whole stages, x of a split in xbuf).
bool make_phase(Phase& P, const void* w_p, const void* gscale, int kp, int ld, int n,
                int segs, int seg_off, int group, int per) {
  if (kp <= 0 || n <= 0 || n % 16 != 0 || ld % 16 != 0 || seg_off % 16 != 0 || group <= 0 ||
      group > kMaxGroup || group % kRows != 0 || kp % group != 0 || per <= 0 ||
      per * group > (group > kXRows ? group : kXRows))
    return false;
  if (reinterpret_cast<uintptr_t>(w_p) % 16 != 0 || reinterpret_cast<uintptr_t>(gscale) % 8 != 0)
    return false;
  P.w_p = static_cast<const int8_t*>(w_p);
  P.gscale = static_cast<const float*>(gscale);
  P.kp = kp;
  P.ld = ld;
  P.n = n;
  P.segs = segs;
  P.seg_off = seg_off;
  P.group = group;
  P.ng = kp / group;
  P.per = per < P.ng ? per : P.ng;
  P.splits = (P.ng + P.per - 1) / P.per;
  P.tiles = (n + kBN - 1) / kBN;
  P.items = P.tiles * P.splits;
  return true;
}

// The scratch (f32, ops/kernels/w4_suffix.scratch_floats lays it out the same way):
// phase 1's partials, phase 2's, h in f32 [m, d], the slots [m, tiles of phase 1]; the
// control ints: 2 barrier words, phase 2's tickets.
template <typename T>
bool place(Args<T>& a, void* scratch, void* control) {
  float* f = static_cast<float*>(scratch);
  int* c = static_cast<int*>(control);
  if (f == nullptr || c == nullptr || a.ph[1].tiles + 2 > kControl) return false;
  a.ph[0].partials = f;
  f += (size_t)a.ph[0].splits * a.m * a.ph[0].ld;
  a.ph[1].partials = f;
  f += (size_t)a.ph[1].splits * a.m * a.ph[1].ld;
  a.hf = f;
  f += (size_t)a.m * a.d;
  a.slots = f;
  a.bar = reinterpret_cast<unsigned*>(c);
  a.ph[0].tickets = nullptr;   // product 1's splits are added between the barriers
  a.ph[1].tickets = c + 2;
  return true;
}

template <typename T, bool kGated>
int run(const void* x, const void* res, const void* norm_w, int norm_dtype, const void* w1,
        const void* s1, const void* w2, const void* s2, void* h_out, void* out, void* scratch,
        void* control, int m, int k1, int d, int n2, int group1, int group2, int per1,
        int per2, float eps, cudaStream_t st) {
  Args<T> a = {};
  // phase 2's columns: gate|up is [d/2, 2 n2] read as two segments of n2; qkv [d/2, n2]
  if (!make_phase(a.ph[0], w1, s1, k1 / 2, d, d, 1, 0, group1, per1) ||
      !make_phase(a.ph[1], w2, s2, d / 2, kGated ? 2 * n2 : n2, n2, kGated ? 2 : 1,
                  kGated ? n2 : 0, group2, per2))
    return (int)cudaErrorInvalidValue;
  a.x = static_cast<const T*>(x);
  a.res = static_cast<const T*>(res);
  a.norm_w = norm_w;
  a.norm_f32 = norm_dtype == 0;
  a.h_out = static_cast<T*>(h_out);
  a.out = static_cast<T*>(out);
  a.m = m;
  a.d = d;
  a.eps = eps;
  if (!place(a, scratch, control)) return (int)cudaErrorInvalidValue;
  const int group = group2 > group1 ? group2 : group1;
  if ((size_t)a.ph[0].tiles * m * sizeof(float) > (size_t)kStageW)   // staged in a ring slot
    return (int)cudaErrorInvalidValue;
  return (int)dispatch<kGated>(std::is_same<T, float>::value ? 0 : 1, m, &a, group, st);
}

bool bad_dims(int dtype, int norm_dtype, int m, int k1, int d, int n2) {
  return (dtype != 0 && dtype != 1) || (norm_dtype != 0 && norm_dtype != dtype) || m <= 0 ||
         m > kMaxRows || k1 <= 0 || k1 % 2 != 0 || d <= 0 || d % 32 != 0 || n2 <= 0;
}

}  // namespace

// Blocks of the persistent grid on this device for a suffix call (gated: A, else B) of m
// rows in the dtype (0 = f32, 1 = bf16) with the larger of its two group sizes: the
// number the wrapper's plan spreads the work items over.
extern "C" int af_w4_suffix_blocks(int dtype, int m, int group, int gated, int* blocks) {
  if ((dtype != 0 && dtype != 1) || m <= 0 || m > kMaxRows || group <= 0 ||
      group > kMaxGroup || blocks == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)(gated ? blocks_for<true>(dtype, m, group, blocks)
                     : blocks_for<false>(dtype, m, group, blocks));
}

// Suffix A, one launch. attn [m, k_o], h_res [m, d] in the dtype (0 = f32, 1 = bf16);
// ln2_w [d] in f32 (norm_dtype 0) or the dtype; one layer's W_o / s_o (k_o/2 x d packed,
// f32 scales) and W_gu / s_gu (d/2 x 2f); outputs act [m, f], h_out [m, d]; per_o, per_g
// the groups a split of each product; scratch (f32) and control (ints, zero and left zero)
// as place() lays them out. Returns a cudaError_t (0 on success).
extern "C" int af_w4_suffix_a(const void* attn, const void* h_res, const void* ln2_w,
                              const void* w_o, const void* s_o, const void* w_gu,
                              const void* s_gu, void* act, void* h_out, void* scratch,
                              void* control, int dtype, int norm_dtype, int m, int k_o, int d,
                              int f, int group_o, int group_g, int per_o, int per_g, float eps,
                              void* stream) {
  if (bad_dims(dtype, norm_dtype, m, k_o, d, f)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? run<float, true>(attn, h_res, ln2_w, norm_dtype, w_o, s_o, w_gu, s_gu, h_out,
                                act, scratch, control, m, k_o, d, f, group_o, group_g, per_o,
                                per_g, eps, st)
             : run<__nv_bfloat16, true>(attn, h_res, ln2_w, norm_dtype, w_o, s_o, w_gu, s_gu,
                                        h_out, act, scratch, control, m, k_o, d, f, group_o,
                                        group_g, per_o, per_g, eps, st);
}

// Suffix B, one launch. act [m, f], h [m, d] in the dtype; ln1_next [d]; layer i's
// W_down / s_down (f/2 x d) and the next layer's W_qkv / s_qkv (d/2 x n_qkv); outputs
// h_out [m, d] and qkv [m, n_qkv]; the rest as suffix A.
extern "C" int af_w4_suffix_b(const void* act, const void* h, const void* ln1_next,
                              const void* w_down, const void* s_down, const void* w_qkv,
                              const void* s_qkv, void* h_out, void* qkv, void* scratch,
                              void* control, int dtype, int norm_dtype, int m, int f, int d,
                              int n_qkv, int group_d, int group_q, int per_d, int per_q,
                              float eps, void* stream) {
  if (bad_dims(dtype, norm_dtype, m, f, d, n_qkv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? run<float, false>(act, h, ln1_next, norm_dtype, w_down, s_down, w_qkv, s_qkv,
                                 h_out, qkv, scratch, control, m, f, d, n_qkv, group_d,
                                 group_q, per_d, per_q, eps, st)
             : run<__nv_bfloat16, false>(act, h, ln1_next, norm_dtype, w_down, s_down, w_qkv,
                                         s_qkv, h_out, qkv, scratch, control, m, f, d, n_qkv,
                                         group_d, group_q, per_d, per_q, eps, st);
}
