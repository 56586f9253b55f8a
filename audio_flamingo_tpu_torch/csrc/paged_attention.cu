// Paged-attention decode (one query token per row) for Hopper (sm_90a), plain C interface
// bound with ctypes.
//
// Replaces the Pallas TPU kernel audio_flamingo_tpu/ops/pallas/paged_attention.py
// (`paged_attention`, kernel `_paged_kernel`): GQA decode attention for one layer with
// K/V read through a block table from the layer-stacked page pool, f32 or bf16 queries,
// pools in the query's dtype, bf16, or int8 with f32 per-token scales. It returns the
// UNNORMALIZED online-softmax triple (o [B, nkv, g, hd], m, l [B, nkv, g], all f32); the
// caller folds the current token in (`merge_current_token`) and normalizes.
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
// Design: a block per (kv head, row, part), 256 threads, so the g query heads of a KV
// head share every page it loads. The row's table entries are split into parts of
// ceil(MP / parts) pages (the wrapper picks parts so that the grid gives every SM about
// two blocks), in three launches:
//   1. page_max_kernel: each part scores its pages and writes every page's max per head;
//   2. paged_attention_kernel: each part starts from the running max of the pages before
//      it (the max of pass 1's maxima) and runs the online softmax over its own pages, so
//      p is rounded against exactly the running max the sequential walk would hold;
//      it writes the part's (o, m, l);
//   3. merge_parts_kernel: o = sum o_s exp(m_s - m), l likewise, m = max m_s.
// With one part (a grid already large enough) only launch 2 runs, straight into the
// output. In launches 1 and 2 a page's K (and V) rows of the head are staged in shared
// memory (rows padded by 16 bytes) by 16-byte cp.async copies, all in flight before one
// wait. Thread (sub, half) of 2 x 128 dots key sub with every query head over half of
// the head dim (q broadcast from shared memory, no shuffles) and the halves are added;
// one warp per query head takes the page max, p and l; for P.V thread (sub, half) owns
// output column sub over every other key, with the f32 accumulators of all g heads in
// registers, and the two halves are added at the end.
//
// Bound on the H100 at the engine's mixed shape (B = 4, nkv 4, g 7, hd 128, BS 128, bf16
// pool; rows of 548, 548, 3848, 3848 tokens): the mapped pages' bytes, 72 pages x 262 KB
// = 18.9 MB per launch, 5.6 us at 3.35 TB/s; the operations are 4 B nkv g hd len = 38
// MFLOP, negligible. The split reads K twice (1.5x the bound's bytes) and each block
// still waits for a page before it computes on it. Left for a later PR: double buffering
// of the next page (cp.async or TMA), a score pass without the re-read (keep pass 1's
// scores), and tensor-core products for long rows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHD = 128;    // head dim the kernel takes (4 dims per lane)
constexpr int kMaxG = 8;    // query heads per KV head
constexpr float kNegInf = -0.7f * FLT_MAX;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

// p as P.V consumes it: rounded to the query dtype (exact for f32)
template <typename TQ> __device__ __forceinline__ float round_q(float p);
template <> __device__ __forceinline__ float round_q<float>(float p) { return p; }
template <> __device__ __forceinline__ float round_q<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16(p));
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// 16 bytes of K or V -> floats
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

// one staged row of K or V: the head's hd values plus 16 bytes of padding, so that the
// 16-byte reads of 8 consecutive keys fall in different banks
template <typename TKV>
__host__ __device__ constexpr int row_bytes() { return kHD * (int)sizeof(TKV) + 16; }

template <typename TKV>
size_t smem_bytes(int BS) {
  return 2 * (size_t)BS * row_bytes<TKV>()              // K and V rows of the page
         + (2 * (size_t)kMaxG * BS + 2 * (size_t)BS     // scores / p, p rounded; scales
            + 2 * (size_t)kMaxG * kHD                   // q in f32; the halves' exchange
            + 3 * kMaxG) * sizeof(float);               // m, l, alpha
}

// The shared-memory carve-up of one block.
template <typename TKV>
struct Smem {
  unsigned char* ks;   // [BS] rows of row_bytes
  unsigned char* vs;
  float* sc;           // [kMaxG][BS] scores
  float* pr;           // [kMaxG][BS] p as P.V consumes it
  float* ksc;          // [BS] int8 scales
  float* vsc;
  float* qs;           // [kMaxG][kHD] q in f32
  float* xc;           // [kMaxG][kHD] the halves' exchange
  float* st_m;         // [kMaxG] running max, sum, last rescale
  float* st_l;
  float* st_a;
  __device__ Smem(unsigned char* base, int BS) {
    ks = base;
    vs = ks + (size_t)BS * row_bytes<TKV>();
    sc = reinterpret_cast<float*>(vs + (size_t)BS * row_bytes<TKV>());
    pr = sc + kMaxG * BS;
    ksc = pr + kMaxG * BS;
    vsc = ksc + BS;
    qs = vsc + BS;
    xc = qs + kMaxG * kHD;
    st_m = xc + kMaxG * kHD;
    st_l = st_m + kMaxG;
    st_a = st_l + kMaxG;
  }
};

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
  int nkv, g, BS, MP;
  float scale;
};

template <typename TQ, typename TKV>
__device__ __forceinline__ void load_q(const Smem<TKV>& S, const Layer<TQ, TKV>& a, int b,
                                       int kvh) {
  const TQ* qb = a.q + ((size_t)b * a.nkv + kvh) * a.g * kHD;
  for (int i = threadIdx.x; i < a.g * kHD; i += kThreads) S.qs[i] = to_f32(qb[i]);
}

// Page j of row b into shared memory: K rows (and V rows with kV) of head kvh by 16-byte
// cp.async copies, all in flight before one wait, and the int8 scales.
template <typename TQ, typename TKV, bool kQuant, bool kV>
__device__ __forceinline__ void stage_page(const Smem<TKV>& S, const Layer<TQ, TKV>& a, int b,
                                           int kvh, int j) {
  constexpr int kRow = row_bytes<TKV>();
  constexpr int kChunks = kHD * (int)sizeof(TKV) / 16;
  int page = a.tables[(size_t)b * a.MP + j];
  if (page < 0) page = 0;
  const size_t row0 = (size_t)page * a.BS;
  for (int i = threadIdx.x; i < a.BS * kChunks; i += kThreads) {
    const int t = i / kChunks, c = i % kChunks;
    const size_t src = ((row0 + t) * a.nkv + kvh) * kHD;
    cp_async16(S.ks + (size_t)t * kRow + 16 * c, reinterpret_cast<const uint4*>(a.k + src) + c);
    if (kV)
      cp_async16(S.vs + (size_t)t * kRow + 16 * c, reinterpret_cast<const uint4*>(a.v + src) + c);
  }
  if (kQuant) {
    for (int t = threadIdx.x; t < a.BS; t += kThreads) {
      S.ksc[t] = a.ks[(row0 + t) * a.nkv + kvh];
      if (kV) S.vsc[t] = a.vs[(row0 + t) * a.nkv + kvh];
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// The staged page's scores into S.sc: thread (sub, half) of 2 x 128 dots key sub with
// every query head over half of the head dim (q broadcast from shared memory); the
// halves meet through S.pr. Keys at or past len score kNegInf.
template <typename TQ, typename TKV, bool kQuant>
__device__ __forceinline__ void score_page(const Smem<TKV>& S, const Layer<TQ, TKV>& a, int j,
                                           int len) {
  constexpr int kRow = row_bytes<TKV>();
  constexpr int kE = 16 / (int)sizeof(TKV);
  constexpr int kChunks = kHD * (int)sizeof(TKV) / 16;
  const int sub = threadIdx.x & (kHD - 1);
  const int half = threadIdx.x / kHD;
  for (int t0 = 0; t0 < a.BS; t0 += kHD) {
    const int t = t0 + sub;
    float part[kMaxG];
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) part[gi] = 0.f;
    if (t < a.BS) {
      const unsigned char* row = S.ks + (size_t)t * kRow + half * (kRow - 16) / 2;
#pragma unroll
      for (int c = 0; c < kChunks / 2; ++c) {
        float kf[kE];
        unpack16(*reinterpret_cast<const uint4*>(row + 16 * c), kf, TKV());
        const int d0 = half * (kHD / 2) + c * kE;
#pragma unroll
        for (int gi = 0; gi < kMaxG; ++gi) {
          if (gi < a.g) {
#pragma unroll
            for (int e = 0; e < kE; e += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(S.qs + gi * kHD + d0 + e);
              part[gi] = fmaf(qv.x, kf[e], part[gi]);
              part[gi] = fmaf(qv.y, kf[e + 1], part[gi]);
              part[gi] = fmaf(qv.z, kf[e + 2], part[gi]);
              part[gi] = fmaf(qv.w, kf[e + 3], part[gi]);
            }
          }
        }
      }
      if (half == 1) {
#pragma unroll
        for (int gi = 0; gi < kMaxG; ++gi)
          if (gi < a.g) S.pr[gi * a.BS + t] = part[gi];
      }
    }
    __syncthreads();
    if (t < a.BS && half == 0) {
      const bool live = j * a.BS + t < len;
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi) {
        if (gi < a.g) {
          float s = (part[gi] + S.pr[gi * a.BS + t]) * a.scale;
          if (kQuant) s *= S.ksc[t];
          S.sc[gi * a.BS + t] = live ? s : kNegInf;
        }
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float page_max(const float* sc_row, int BS) {
  float mx = kNegInf;
  for (int t = threadIdx.x & 31; t < BS; t += 32) mx = fmaxf(mx, sc_row[t]);
  return warp_max(mx);
}

__device__ __forceinline__ int row_pages(int len, int BS, int MP) {
  return len > 0 ? min((len + BS - 1) / BS, MP) : 0;
}

// Pass 1 of a split launch: the score max of every page of the block's range, so that
// each part of pass 2 can start from the running max of the pages before it.
template <typename TQ, typename TKV, bool kQuant>
__global__ void __launch_bounds__(kThreads)
page_max_kernel(Layer<TQ, TKV> a, int pages_per_part, float* __restrict__ pmax) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<TKV> S(smem, a.BS);
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int len = a.lengths[b];
  const int j0 = blockIdx.z * pages_per_part;
  const int j1 = min(j0 + pages_per_part, row_pages(len, a.BS, a.MP));
  if (j0 >= j1) return;
  load_q(S, a, b, kvh);
  for (int j = j0; j < j1; ++j) {
    stage_page<TQ, TKV, kQuant, false>(S, a, b, kvh, j);
    score_page<TQ, TKV, kQuant>(S, a, j, len);
    for (int gi = threadIdx.x >> 5; gi < a.g; gi += kWarps) {
      const float mx = page_max(S.sc + gi * a.BS, a.BS);
      if ((threadIdx.x & 31) == 0) pmax[(((size_t)b * a.nkv + kvh) * a.g + gi) * a.MP + j] = mx;
    }
    __syncthreads();   // the next page overwrites the staged rows and scores
  }
}

// Pass 2 (or the only pass): the online softmax over the block's pages, starting from
// the running max of the pages before them (read from pass 1's maxima), written as the
// part's (o, m, l) at [B, nkv, parts, g(, hd)]; with one part that is the output.
template <typename TQ, typename TKV, bool kQuant>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(Layer<TQ, TKV> a, int pages_per_part, const float* __restrict__ pmax,
                       float* __restrict__ o, float* __restrict__ m_out,
                       float* __restrict__ l_out) {
  constexpr int kRow = row_bytes<TKV>();
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<TKV> S(smem, a.BS);
  const int kvh = blockIdx.x, b = blockIdx.y, part = blockIdx.z, parts = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = a.lengths[b];
  const int n_pages = row_pages(len, a.BS, a.MP);
  const int j0 = min(part * pages_per_part, n_pages);
  const int j1 = min(j0 + pages_per_part, n_pages);

  load_q(S, a, b, kvh);
  if (tid < a.g) {
    // a part with no page contributes nothing (m = kNegInf, o = l = 0)
    float m0 = kNegInf;
    if (j0 < j1)
      for (int j = 0; j < j0; ++j)
        m0 = fmaxf(m0, pmax[(((size_t)b * a.nkv + kvh) * a.g + tid) * a.MP + j]);
    S.st_m[tid] = m0;
    S.st_l[tid] = 0.f;
  }
  const int sub = tid & (kHD - 1);
  const int half = tid / kHD;
  float acc[kMaxG];
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) acc[gi] = 0.f;

  for (int j = j0; j < j1; ++j) {
    stage_page<TQ, TKV, kQuant, true>(S, a, b, kvh, j);
    score_page<TQ, TKV, kQuant>(S, a, j, len);

    // online softmax over the page: one warp per query head
    for (int gi = warp; gi < a.g; gi += kWarps) {
      const float mx = page_max(S.sc + gi * a.BS, a.BS);
      const float m_prev = S.st_m[gi];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < a.BS; t += 32) {
        const float p = expf(S.sc[gi * a.BS + t] - m_new);
        sum += p;
        S.pr[gi * a.BS + t] = round_q<TQ>(kQuant ? p * S.vsc[t] : p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        S.st_a[gi] = alpha;
        S.st_l[gi] = S.st_l[gi] * alpha + sum;
        S.st_m[gi] = m_new;
      }
    }
    __syncthreads();

    // P.V: column sub over keys half, half + 2, ...
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi)
      if (gi < a.g) acc[gi] *= S.st_a[gi];
    for (int t = half; t < a.BS; t += 2) {
      const float v = to_f32(reinterpret_cast<const TKV*>(S.vs + (size_t)t * kRow)[sub]);
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi)
        if (gi < a.g) acc[gi] = fmaf(S.pr[gi * a.BS + t], v, acc[gi]);
    }
    __syncthreads();   // the next page overwrites the staged rows and p
  }

  // add the two halves' accumulators and write the part's triple
  if (half == 1) {
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi)
      if (gi < a.g) S.xc[gi * kHD + sub] = acc[gi];
  }
  __syncthreads();
  const size_t ob = (((size_t)b * a.nkv + kvh) * parts + part) * a.g;
  if (half == 0) {
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi)
      if (gi < a.g) o[(ob + gi) * kHD + sub] = acc[gi] + S.xc[gi * kHD + sub];
  }
  if (tid < a.g) {
    m_out[ob + tid] = j0 < j1 ? S.st_m[tid] : kNegInf;
    l_out[ob + tid] = S.st_l[tid];
  }
}

// Pass 3 of a split launch: the parts' triples into one, o = sum_s o_s exp(m_s - m),
// l = sum_s l_s exp(m_s - m), m = max_s m_s (a row with no page keeps 0, kNegInf, 0).
__global__ void __launch_bounds__(kHD)
merge_parts_kernel(const float* __restrict__ o_part, const float* __restrict__ m_part,
                   const float* __restrict__ l_part, float* __restrict__ o,
                   float* __restrict__ m_out, float* __restrict__ l_out, int nkv, int g,
                   int parts) {
  const int kvh = blockIdx.x, b = blockIdx.y, col = threadIdx.x;
  const size_t bk = (size_t)b * nkv + kvh;
  for (int gi = 0; gi < g; ++gi) {
    float mx = kNegInf;
    for (int s = 0; s < parts; ++s) mx = fmaxf(mx, m_part[(bk * parts + s) * g + gi]);
    float acc = 0.f, l = 0.f;
    for (int s = 0; s < parts; ++s) {
      const size_t ps = (bk * parts + s) * g + gi;
      const float w = expf(m_part[ps] - mx);
      acc = fmaf(o_part[ps * kHD + col], w, acc);
      l = fmaf(l_part[ps], w, l);
    }
    o[(bk * g + gi) * kHD + col] = acc;
    if (col == 0) {
      m_out[bk * g + gi] = mx;
      l_out[bk * g + gi] = l;
    }
  }
}

template <typename TQ, typename TKV, bool kQuant>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
           const void* v_scale, const void* tables, const void* lengths, void* o, void* m,
           void* l, float* scratch, int B, int nkv, int g, int NB, int BS, int MP, int layer,
           int parts, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<TKV>(BS);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto attend = paged_attention_kernel<TQ, TKV, kQuant>;
  auto maxima = page_max_kernel<TQ, TKV, kQuant>;
  // the shared-memory limit is set once per device and size (so that a launch captured
  // in a CUDA graph makes no attribute call)
  static int configured[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (configured[dev] < (int)smem) {
    err = cudaFuncSetAttribute(attend, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(maxima, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = (int)smem;
  }
  const size_t layer_scales = (size_t)layer * NB * BS * nkv;
  Layer<TQ, TKV> a;
  a.q = static_cast<const TQ*>(q);
  a.k = static_cast<const TKV*>(k_pool) + layer_scales * kHD;
  a.v = static_cast<const TKV*>(v_pool) + layer_scales * kHD;
  a.ks = kQuant ? static_cast<const float*>(k_scale) + layer_scales : nullptr;
  a.vs = kQuant ? static_cast<const float*>(v_scale) + layer_scales : nullptr;
  a.tables = static_cast<const int*>(tables);
  a.lengths = static_cast<const int*>(lengths);
  a.nkv = nkv;
  a.g = g;
  a.BS = BS;
  a.MP = MP;
  a.scale = scale;
  float* of = static_cast<float*>(o);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  const int per_part = (MP + parts - 1) / parts;
  if (parts <= 1) {
    attend<<<dim3(nkv, B, 1), kThreads, smem, stream>>>(a, MP, nullptr, of, mf, lf);
    return (int)cudaGetLastError();
  }
  // scratch: page maxima [B, nkv, g, MP], then the parts' o, m, l
  float* pmax = scratch;
  float* o_part = pmax + (size_t)B * nkv * g * MP;
  float* m_part = o_part + (size_t)B * nkv * parts * g * kHD;
  float* l_part = m_part + (size_t)B * nkv * parts * g;
  maxima<<<dim3(nkv, B, parts), kThreads, smem, stream>>>(a, per_part, pmax);
  attend<<<dim3(nkv, B, parts), kThreads, smem, stream>>>(a, per_part, pmax, o_part, m_part,
                                                          l_part);
  merge_parts_kernel<<<dim3(nkv, B), kHD, 0, stream>>>(o_part, m_part, l_part, of, mf, lf, nkv,
                                                       g, parts);
  return (int)cudaGetLastError();
}

}  // namespace

// q_dtype: 0 = f32, 1 = bf16; kv_dtype: 0 = f32, 1 = bf16, 2 = int8 with f32 scales (a
// bf16 pool may serve f32 queries). The pools hold L layers of NB pages; `layer` selects
// one inside the kernels. parts > 1 splits each row's MP table entries over that many
// blocks (three launches); scratch then holds B nkv g (MP + parts (hd + 2)) floats.
extern "C" int af_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                  const void* k_scale, const void* v_scale,
                                  const void* tables, const void* lengths, void* o, void* m,
                                  void* l, void* scratch, int q_dtype, int kv_dtype, int B,
                                  int nkv, int g, int hd, int NB, int BS, int MP, int layer,
                                  int parts, float scale, void* stream) {
  if (B <= 0 || nkv <= 0 || g <= 0 || g > kMaxG || hd != kHD || NB <= 0 || BS <= 0 ||
      MP <= 0 || layer < 0 || parts < 1 || parts > MP || (parts > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sf = static_cast<float*>(scratch);
#define AF_PAGED_ARGS q, k_pool, v_pool, k_scale, v_scale, tables, lengths, o, m, l, sf, B, nkv, \
                      g, NB, BS, MP, layer, parts, scale, s
  if (q_dtype == 0 && kv_dtype == 0) return launch<float, float, false>(AF_PAGED_ARGS);
  if (q_dtype == 0 && kv_dtype == 1) return launch<float, __nv_bfloat16, false>(AF_PAGED_ARGS);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(AF_PAGED_ARGS);
  if (q_dtype == 0 && kv_dtype == 2) return launch<float, int8_t, true>(AF_PAGED_ARGS);
  if (q_dtype == 1 && kv_dtype == 2) return launch<__nv_bfloat16, int8_t, true>(AF_PAGED_ARGS);
#undef AF_PAGED_ARGS
  return (int)cudaErrorInvalidValue;
}
