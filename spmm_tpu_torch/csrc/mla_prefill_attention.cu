// Latent-attention (MLA) prefill in the expanded form: the fused attention
// of the latent MoE model's prefill (models/latent_moe.py, ops/mla_prefill.py).
//
// It replaces no TPU kernel: the JAX package has no latent-attention model.
// For every query token of a segment (row, start, count, offset) and every
// head h, over the row's keys t <= start + own index:
//
//   s[t] = q_nope[h] . k_nope[t, h] + q_pe[h] . k_pe[t]   (scale folded in q)
//   o[h] = sum_t softmax_t(s[t]) v[t, h]
//
//   q      [N, 16, 128 + 64]           bf16: [q_nope | rope(q_pe)] * scale
//   kvb    [slots, lmax, 16, 128 + 128] bf16: W_kvb c of the group's rows,
//                                       [k_nope | v] a key and head
//   cache  [rows, T, 512 + 64]         bf16: the layer's cache; k_pe is its
//                                       columns 512:576, one for all heads
//   out    [N, 16 * 128]               bf16, the layout W_o reads
//
// Scores and the online softmax are fp32; the probabilities enter the value
// product in bf16, and the sums are fp32.
//
// Bound: the products.  A (query, key) pair costs 16 * (192 + 128)
// multiply-adds and the pairs of a turn (256 queries over 2k-7.7k keys a
// row) reuse each key 256 times, far past the card's ridge, so the design is
// that of a flash attention on wgmma:
//
//   - A work item (``ops.mla_prefill.plan``) is 128 queries of one segment
//     and head; one block of two warpgroups takes it, each warpgroup 64
//     query rows.  The plan orders the items longest first and keeps a
//     (row, head)'s query tiles side by side, so that they read the same key
//     tiles at about the same time (one read from device memory, the other
//     from L2).
//   - Key tiles of 128 keys: k_nope, k_pe and v, five 64-column slabs of
//     16 KB, stream through a two-stage ring with 16-byte cp.async from
//     all 256 threads (keys past the item's last zero-filled), so tile t + 1
//     lands while tile t computes.  Q's three slabs stay resident.  Every
//     slab is a run of 128-byte rows in the 128-byte swizzle that wgmma
//     reads without bank conflicts: chunk c of row r at r * 128 +
//     ((c ^ (r % 8)) * 16); 8 threads write one row, so the copies are
//     conflict-free and each warp reads 128 contiguous bytes of a key.
//   - S = Q K^T: 12 wgmma m64n128k16 a warpgroup (depth 192: nope slabs 0-1,
//     rope slab 2), both operands K-major in shared memory.  O += P V: 8
//     wgmma m64n128k16 with P from registers (the S accumulator's layout is
//     the A fragment's) and V read transposed (MN-major) from its two
//     slabs.
//   - Tiles wholly past the diagonal are not loaded (the plan's tile count,
//     ceil((start + last query + 1) / 128)); the causal mask is applied only
//     on the tiles that cross a warpgroup's diagonal.
//   - The output is normalised and stored straight into [N, 16 * 128].
//
// Shared memory: Q 48 KB + 2 stages of 80 KB, one block an SM.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (spmm_tpu_torch/ops/_build.py); plain C interface,
//        bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int HEADS = 16;
constexpr int NOPE = 128, ROPE = 64, VDIM = 128, LATENT = 512;
constexpr int QK = NOPE + ROPE;               // q's width a head
constexpr int KVB = NOPE + VDIM;              // the expansion's width a head
constexpr int CACHE_W = LATENT + ROPE;        // the cache's width a key
constexpr int BLOCK_Q = 128;                  // query rows a block
constexpr int BLOCK_K = 128;                  // keys a tile
constexpr int THREADS = 256;                  // two warpgroups
constexpr int STAGES = 2;
constexpr int SLAB = BLOCK_K * 128;           // bytes of a 64-column slab
constexpr int Q_BYTES = 3 * BLOCK_Q * 128;    // nope 0-63, nope 64-127, rope
constexpr int STAGE_BYTES = 5 * SLAB;         // + v 0-63, v 64-127
constexpr int SMEM = Q_BYTES + STAGES * STAGE_BYTES + 1024;  // + alignment
constexpr int ITEM = 8;                       // ints a work item

static_assert(BLOCK_Q == BLOCK_K, "Q's slabs share the key slabs' shape");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of row r in a slab (128-byte swizzle)
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// shared-memory writes of the generic proxy made visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma's matrix descriptor: 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lead,
                                               uint32_t stride) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lead >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((stride >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of d across a wgmma fence or wait
__device__ __forceinline__ void hold(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC64 \
  ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
#define REG64                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "    \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "    \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d[64 x 128] (+)= A[64 x 16] B[128 x 16]^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REG64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC64
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 128] += A[64 x 16] (registers) B[16 x 128], B MN-major in shared
// memory (read transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REG64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// items [n, 8] int32: (slot, cache row, head, first query, queries, start,
// offset of the segment's first token, key tiles)
__global__ void __launch_bounds__(THREADS, 1)
mla_prefill_attention_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ kvb,
                             const bf16* __restrict__ cache,
                             const int* __restrict__ items,
                             bf16* __restrict__ out, int lmax,
                             long long cache_row_stride, float scale_log2) {
  extern __shared__ unsigned char raw[];
  const uint32_t base = (smem_u32(raw) + 1023) & ~1023u;
  const uint32_t q_smem = base;
  const uint32_t kv_smem = base + Q_BYTES;

  const int* it = items + (long long)blockIdx.x * ITEM;
  const int slot = it[0], row = it[1], head = it[2], q0 = it[3], nq = it[4];
  const int start = it[5], off = it[6], tiles = it[7];
  const int keys = start + q0 + nq;            // keys the item attends

  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / 128, warp = (tid % 128) / 32;

  // this thread's piece of each copy: 16-byte chunk `chunk` of row
  // tid / 8 + 32 i of a slab
  const int chunk = tid % 8, row0 = tid / 8;
  {
    const bf16* qh = q + ((long long)(off + q0) * HEADS + head) * QK;
#pragma unroll
    for (int i = 0; i < 12; ++i) {             // 3 slabs x 128 rows x 8
      const int slab = i / 4, r = row0 + 32 * (i % 4);
      const bool live = r < nq;
      const bf16* src = qh + (long long)(live ? r : 0) * HEADS * QK +
                        slab * 64 + chunk * 8;
      cp_async16(q_smem + slab * SLAB + swizzled(r, chunk), src,
                 live ? 16 : 0);
    }
  }
  const bf16* kv_head = kvb + ((long long)slot * lmax * HEADS + head) * KVB;
  const bf16* pe = cache + (long long)row * cache_row_stride + LATENT;
  auto load_tile = [&](int t) {
    const uint32_t stage = kv_smem + (t % STAGES) * STAGE_BYTES;
#pragma unroll
    for (int i = 0; i < 20; ++i) {             // 5 slabs x 128 rows x 8
      const int slab = i / 4, r = row0 + 32 * (i % 4);
      const int key = t * BLOCK_K + r;
      const bool live = key < keys;
      const long long k = live ? key : 0;
      // slabs: k_nope 0-63, k_nope 64-127, k_pe, v 0-63, v 64-127
      const bf16* src =
          slab == 2 ? pe + k * CACHE_W + chunk * 8
                    : kv_head + k * (HEADS * KVB) +
                          (slab < 2 ? slab * 64 : NOPE + (slab - 3) * 64) +
                          chunk * 8;
      cp_async16(stage + slab * SLAB + swizzled(r, chunk), src,
                 live ? 16 : 0);
    }
  };
  load_tile(0);
  cp_commit();

  // this thread's two rows of the warpgroup's 64, as query indices of the
  // segment: the accumulators' rows lane / 4 and lane / 4 + 8 of its warp
  const int r_lo = wg * 64 + warp * 16 + lane / 4;
  const int limit_lo = start + q0 + r_lo, limit_hi = limit_lo + 8;
  const int col = 2 * (lane % 4);              // first of its two columns

  float o[64], s[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = s[i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  const uint32_t q_wg = q_smem + wg * 64 * 128;   // this warpgroup's rows
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) load_tile(t + 1);
    cp_commit();
    cp_wait<1>();
    fence_async_shared();
    __syncthreads();
    const uint32_t stage = kv_smem + (t % STAGES) * STAGE_BYTES;

    // S = Q K^T over 192: slabs 0, 1, 2 of Q against those of the tile
    hold(s);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < QK / 16; ++k) {
      const uint32_t at = (k / 4) * SLAB + (k % 4) * 32;   // 16 columns on
      wgmma_ss(s, descriptor(q_wg + at, 16, 1024),
               descriptor(stage + at, 16, 1024), k > 0);
    }
    wgmma_commit();
    wgmma_wait();
    hold(s);

    // the causal mask, on tiles that cross this warpgroup's diagonal
    const int k0 = t * BLOCK_K;
    if (k0 + BLOCK_K - 1 > start + q0 + wg * 64) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int key = k0 + 8 * j + col;
        if (key > limit_lo) s[4 * j] = -INFINITY;
        if (key + 1 > limit_lo) s[4 * j + 1] = -INFINITY;
        if (key > limit_hi) s[4 * j + 2] = -INFINITY;
        if (key + 1 > limit_hi) s[4 * j + 3] = -INFINITY;
      }
    }

    // online softmax, in log2 units; a row's 4 threads share its max
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j], s[4 * j + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, x));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, x));
    }
    const float new_lo = fmaxf(m_lo, mx_lo * scale_log2);
    const float new_hi = fmaxf(m_hi, mx_hi * scale_log2);
    // a row with no live key yet keeps 0 as its max (no inf - inf)
    const float use_lo = new_lo == -INFINITY ? 0.f : new_lo;
    const float use_hi = new_hi == -INFINITY ? 0.f : new_hi;
    const float a_lo = ex2(m_lo - use_lo), a_hi = ex2(m_hi - use_hi);
    m_lo = new_lo;
    m_hi = new_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
    uint32_t p[32];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float p0 = ex2(fmaf(s[4 * j], scale_log2, -use_lo));
      const float p1 = ex2(fmaf(s[4 * j + 1], scale_log2, -use_lo));
      const float p2 = ex2(fmaf(s[4 * j + 2], scale_log2, -use_hi));
      const float p3 = ex2(fmaf(s[4 * j + 3], scale_log2, -use_hi));
      sum_lo += p0 + p1;
      sum_hi += p2 + p3;
      p[2 * j] = pack_bf16(p0, p1);
      p[2 * j + 1] = pack_bf16(p2, p3);
    }
    l_lo = l_lo * a_lo + sum_lo;
    l_hi = l_hi * a_hi + sum_hi;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      o[4 * j] *= a_lo;
      o[4 * j + 1] *= a_lo;
      o[4 * j + 2] *= a_hi;
      o[4 * j + 3] *= a_hi;
    }

    // O += P V: keys 16 k .. 16 k + 15 a step; the A fragment of step k is
    // the S accumulator's 8-column blocks 2 k and 2 k + 1
    hold(o);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BLOCK_K / 16; ++k)
      wgmma_rs(o, p + 4 * k,
               descriptor(stage + 3 * SLAB + k * 16 * 128, SLAB, 1024));
    wgmma_commit();
    wgmma_wait();
    hold(o);
    __syncthreads();   // the stage is free for tile t + 2
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, x);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, x);
  }
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  bf16* dst = out + ((long long)(off + q0 + r_lo) * HEADS + head) * VDIM + col;
  const long long row8 = 8LL * HEADS * VDIM;   // 8 rows further
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (r_lo < nq)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(o[4 * j] * inv_lo, o[4 * j + 1] * inv_lo);
    if (r_lo + 8 < nq)
      *reinterpret_cast<__nv_bfloat162*>(dst + row8 + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv_hi,
                                o[4 * j + 3] * inv_hi);
  }
}

}  // namespace

extern "C" {

// heads, nope, rope, v, latent, query rows a block, keys a tile, ints an item
void mla_prefill_dims(int* dims) {
  const int d[8] = {HEADS, NOPE, ROPE, VDIM, LATENT, BLOCK_Q, BLOCK_K, ITEM};
  for (int i = 0; i < 8; ++i) dims[i] = d[i];
}

// Raise the kernel's shared-memory limit; launches nothing.
int mla_prefill_prepare() {
  return (int)cudaFuncSetAttribute(mla_prefill_attention_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   SMEM);
}

// q [N, 16, 192], kvb [slots, lmax, 16, 256], cache [rows] x [T, 576] rows
// cache_row_stride elements apart, out [N, 2048], all bf16; items
// [n_items, 8] int32 (ops/mla_prefill.py plan).
int mla_prefill_launch(const void* q, const void* kvb, const void* cache,
                       const void* items, void* out, int n_items, int lmax,
                       long long cache_row_stride, float scale_log2,
                       void* stream) {
  if (n_items == 0) return 0;
  mla_prefill_attention_kernel<<<n_items, THREADS, SMEM,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kvb),
      static_cast<const bf16*>(cache), static_cast<const int*>(items),
      static_cast<bf16*>(out), lmax, cache_row_stride, scale_log2);
  return (int)cudaGetLastError();
}

}  // extern "C"
