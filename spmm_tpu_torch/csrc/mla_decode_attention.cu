// Latent-attention (MLA) decode: kernel 3 of the port.
//
// It replaces no TPU kernel: the JAX package has no latent-attention
// model.  It was added for the decoder-only latent MoE model
// (models/latent_moe.py), whose decode step attends, in the absorbed form,
// from 16 heads to one shared latent cache:
//
//   s[h, t]  = (q[h, :] . cache[t, :]) * scale        over 512 + 64 dims
//   o[h, :]  = sum_t softmax_t(s[h, t]) * cache[t, :512]
//
// with q = [W_uk^T q_nope | rope(q_pe)] per head, cache[t] = [c | rope(k_pe)]
// a token, and per-row lengths (each row of the batch at its own position).
//
// Bound: the cache's bytes.  A row reads len * 576 * 2 bytes and does
// 16 * (576 + 512) multiply-adds a key: about 30 FLOPs a byte, above what
// the CUDA cores give (67 TFLOP/s fp32 against 3.35 TB/s) but far below
// the tensor cores' ridge, so the products run on mma.sync (bf16 in, fp32
// sums), with the 16 heads as the 16 rows of the m16n8k16 tile: the cache
// is read once a row for all heads.
//
// Design: one block of 4 warps a (row, split of SPLIT keys), the splits
// combined by a second kernel (flash decoding), so that 128 rows of uneven
// lengths fill the SMs.  The grid is fixed by the cache's capacity, so a
// CUDA graph replays it at any lengths; blocks past a row's length return
// at once.  A block streams tiles of BN keys through a two-stage cp.async
// ring (keys past the length zero-filled); per tile: each warp computes the
// scores of 8 keys for all heads (phase 1), the block runs the online
// softmax (phase 2), each warp accumulates 128 of the 512 output dims from
// the tile's latent rows (phase 3, ldmatrix.trans for V).  Shared rows are
// padded by 16 bytes, so ldmatrix reads no bank twice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HEADS = 16;
constexpr int DC = 512;                 // latent
constexpr int DR = 64;                  // shared rotated key
constexpr int D = DC + DR;              // cache values a token
constexpr int BN = 32;                  // keys a tile
constexpr int SPLIT = 512;              // keys a block
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 2;
constexpr int ROW = D + 8;              // padded shared row, bf16 elements
constexpr int PROW = BN + 8;
constexpr int DIMS_PER_WARP = DC / WARPS;   // 128
constexpr int NT = DIMS_PER_WARP / 8;       // 16 n-tiles a warp
constexpr int CHUNKS = D * 2 / 16;          // 16-byte chunks a row: 72

struct Smem {
  __nv_bfloat16 q[HEADS * ROW];
  __nv_bfloat16 k[STAGES][BN * ROW];
  __nv_bfloat16 p[HEADS * PROW];
  float s[HEADS * BN];
  float m[HEADS];
  float l[HEADS];
  float alpha[HEADS];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3,
                                        const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3,
                                          const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// keys [t0, t0 + BN) of one row into a stage; keys at or past `len` zeroed
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* row_base,
                                          int t0, int len) {
  for (int c = threadIdx.x; c < BN * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    const int t = t0 + r;
    const bool live = t < len;
    const __nv_bfloat16* src = row_base + (size_t)(live ? t : 0) * D + col;
    cp_async16(dst + r * ROW + col, src, live ? 16 : 0);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
mla_decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ cache,
                            const int* __restrict__ lens,
                            float* __restrict__ part_o,
                            float* __restrict__ part_ml, long long row_stride,
                            int max_splits, float scale_log2) {
  extern __shared__ __align__(16) unsigned char raw[];
  Smem& sm = *reinterpret_cast<Smem*>(raw);
  const int split = blockIdx.x, b = blockIdx.y;
  const int len = lens[b];
  const int start = split * SPLIT;
  if (start >= len) return;
  const int stop = min(len, start + SPLIT);
  const int n_tiles = (stop - start + BN - 1) / BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const __nv_bfloat16* row_base = cache + (size_t)b * row_stride;

  const __nv_bfloat16* qb = q + (size_t)b * HEADS * D;
  for (int c = threadIdx.x; c < HEADS * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    cp_async16(sm.q + r * ROW + col, qb + r * D + col, 16);
  }
  if (threadIdx.x < HEADS) {
    sm.m[threadIdx.x] = -INFINITY;
    sm.l[threadIdx.x] = 0.f;
  }
  load_tile(sm.k[0], row_base, start, len);
  cp_commit();

  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  const int g = lane / 4, c4 = lane % 4;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = start + tile * BN;
    if (tile + 1 < n_tiles) {
      load_tile(sm.k[(tile + 1) % STAGES], row_base, t0 + BN, len);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = sm.k[tile % STAGES];

    // phase 1: scores of keys [8 warp, 8 warp + 8) for all heads
    {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const int n0 = warp * 8;
#pragma unroll 3
      for (int kk = 0; kk < D / 32; ++kk) {
        uint32_t a[4], a2[4], b0, b1, b2, b3;
        ldsm_x4(b0, b1, b2, b3,
                kt + (n0 + (lane % 8)) * ROW + kk * 32 + (lane / 8) * 8);
        ldsm_x4(a[0], a[1], a[2], a[3],
                sm.q + (lane % 16) * ROW + kk * 32 + (lane / 16) * 8);
        ldsm_x4(a2[0], a2[1], a2[2], a2[3],
                sm.q + (lane % 16) * ROW + kk * 32 + 16 + (lane / 16) * 8);
        mma16816(acc, a, b0, b1);
        mma16816(acc, a2, b2, b3);
      }
      const int key = n0 + 2 * c4;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = g + (e / 2) * 8, j = key + (e % 2);
        sm.s[h * BN + j] = (t0 + j < len) ? acc[e] * scale_log2 : -INFINITY;
      }
    }
    __syncthreads();

    // phase 2: online softmax, 8 threads a head, 4 keys a thread
    {
      const int h = threadIdx.x / 8, j0 = (threadIdx.x % 8) * 4;
      const float m_old = sm.m[h];
      float v[4], mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = sm.s[h * BN + j0 + e];
        mx = fmaxf(mx, v[e]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(v[e] - m_new);
        sum += p;
        sm.p[h * PROW + j0 + e] = __float2bfloat16(p);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (threadIdx.x % 8 == 0) {
        const float alpha = exp2f(m_old - m_new);
        sm.alpha[h] = alpha;
        sm.l[h] = sm.l[h] * alpha + sum;
        sm.m[h] = m_new;
      }
    }
    __syncthreads();

    // phase 3: o[:, 128 warp + ...] = alpha o + p . latent rows
    {
      const float al0 = sm.alpha[g], al1 = sm.alpha[g + 8];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        o[j][0] *= al0;
        o[j][1] *= al0;
        o[j][2] *= al1;
        o[j][3] *= al1;
      }
      const int d0 = warp * DIMS_PER_WARP;
#pragma unroll
      for (int ks = 0; ks < BN / 16; ++ks) {
        uint32_t a[4];
        ldsm_x4(a[0], a[1], a[2], a[3],
                sm.p + (lane % 16) * PROW + ks * 16 + (lane / 16) * 8);
#pragma unroll
        for (int j2 = 0; j2 < NT / 2; ++j2) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4_t(b0, b1, b2, b3,
                    kt + (ks * 16 + (lane % 16)) * ROW + d0 + j2 * 16 +
                        (lane / 16) * 8);
          mma16816(o[2 * j2], a, b0, b1);
          mma16816(o[2 * j2 + 1], a, b2, b3);
        }
      }
    }
    __syncthreads();
  }

  const size_t part = (size_t)b * max_splits + split;
  float* po = part_o + part * HEADS * DC;
  const int d0 = warp * DIMS_PER_WARP;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int d = d0 + j * 8 + 2 * c4;
    *reinterpret_cast<float2*>(po + g * DC + d) = make_float2(o[j][0], o[j][1]);
    *reinterpret_cast<float2*>(po + (g + 8) * DC + d) =
        make_float2(o[j][2], o[j][3]);
  }
  if (threadIdx.x < HEADS) {
    part_ml[part * HEADS * 2 + threadIdx.x * 2] = sm.m[threadIdx.x];
    part_ml[part * HEADS * 2 + threadIdx.x * 2 + 1] = sm.l[threadIdx.x];
  }
}

// one block a (row, head): the row's splits merged by their maxima
__global__ void __launch_bounds__(DC / 4)
mla_decode_combine_kernel(const float* __restrict__ part_o,
                          const float* __restrict__ part_ml,
                          const int* __restrict__ lens,
                          __nv_bfloat16* __restrict__ out, int max_splits) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int n_splits = (lens[b] + SPLIT - 1) / SPLIT;
  const size_t base = (size_t)b * max_splits;
  float mx = -INFINITY;
  for (int s = 0; s < n_splits; ++s)
    mx = fmaxf(mx, part_ml[((base + s) * HEADS + h) * 2]);
  float acc[4] = {0.f, 0.f, 0.f, 0.f}, total = 0.f;
  const int d = threadIdx.x * 4;
  for (int s = 0; s < n_splits; ++s) {
    const size_t p = (base + s) * HEADS + h;
    const float w = exp2f(part_ml[p * 2] - mx);
    total += w * part_ml[p * 2 + 1];
    const float4 v = *reinterpret_cast<const float4*>(part_o + p * DC + d);
    acc[0] += w * v.x;
    acc[1] += w * v.y;
    acc[2] += w * v.z;
    acc[3] += w * v.w;
  }
  const float inv = 1.f / total;
  __nv_bfloat16* dst = out + ((size_t)b * HEADS + h) * DC + d;
#pragma unroll
  for (int e = 0; e < 4; ++e) dst[e] = __float2bfloat16(acc[e] * inv);
}

}  // namespace

extern "C" {

int mla_split() { return SPLIT; }
int mla_heads() { return HEADS; }
int mla_latent() { return DC; }
int mla_rope() { return DR; }

// Raise the attention kernel's shared-memory limit; launches nothing.
int mla_prepare() {
  cudaError_t err = cudaFuncSetAttribute(
      mla_decode_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem));
  return (int)err;
}

// q [B, 16, 576] bf16; cache rows [B] x [T, 576] bf16, row_stride elements
// apart; lens [B] int32 in [1, T]; part_o [B, max_splits, 16, 512] and
// part_ml [B, max_splits, 16, 2] fp32 scratch; out [B, 16, 512] bf16.
int mla_launch(const void* q, const void* cache, const void* lens,
               void* part_o, void* part_ml, void* out, int batch,
               long long row_stride, int max_splits, float scale_log2,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(max_splits, batch);
  mla_decode_attention_kernel<<<grid, THREADS, sizeof(Smem), s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(cache), static_cast<const int*>(lens),
      static_cast<float*>(part_o), static_cast<float*>(part_ml), row_stride,
      max_splits, scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mla_decode_combine_kernel<<<dim3(batch, HEADS), DC / 4, 0, s>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<const int*>(lens), static_cast<__nv_bfloat16*>(out),
      max_splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
