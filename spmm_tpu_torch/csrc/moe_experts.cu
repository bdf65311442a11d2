// Routed experts of the latent MoE model (ops/moe.py, models/latent_moe.py):
// the router, the grouped expert products and the sum of each token's
// pairs.  Kernels of the port's own; the JAX package has no such layer.
//
//   moe_route_kernel    the router's logits x W_g^T in fp32 (x and W_g
//                       read as fp32), over splits of the reduction;
//   moe_topk_kernel     s = sigmoid(the splits' sum), the top k of s +
//                       bias, weights s[chosen] / (sum + 1e-20) * scale;
//   moe_product_kernel  the grouped products over pairs sorted by expert
//                       into blocks of BM slots (ops/moe.py `_align`):
//                       GATED, act[slot] = silu(gate_e x) * up_e x, x the
//                       slot's token row; else pairs[pair] = w[pair] *
//                       down_e act[slot];
//   moe_combine_kernel  out[n] = sum_j pairs[n k + j] in fp32.
//
// The product is a weight-stationary grouped GEMM: a block holds one
// expert's BM slots and BN output columns, reads the expert's weight rows
// for them once, and runs the products on mma.sync (bf16 in, fp32 sums).
// Both operands are K-contiguous (x or act rows, and W[e] rows), so
// ldmatrix feeds the m16n8k16 tile from row-major shared tiles without a
// transpose; the gated launch reads gate rows n and up rows I + n into one
// stage, so a thread holds both of its outputs' sums for the epilogue.
// Tiles stream through a cp.async ring of STAGES (slots past the pairs
// zero-filled).  Shared rows are padded by 16 bytes: ldmatrix reads no
// bank twice.
//
// Two tilings.  At decode (128 tokens, 768 pairs over 64 experts, about 12
// slots an expert) the launch is bound by the weights' bytes: BM 16, BN 64,
// a 64-deep stage, four warps side by side over the columns.  At the turn's
// prefill (32,768 tokens, about 3,000 slots an expert) by the products:
// BM 128, a 64-deep stage, eight warps of 32 x 32 (gated, twice) or 32 x 64.
// The grid is fixed by the pairs' count, so a CUDA graph replays it; blocks
// of no expert (-1, past the used slots) return at once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

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

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
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

// ---- the router ----

constexpr int ROUTE_THREADS = 256;
constexpr int ROUTE_K = 64;             // reduction a stage
constexpr int MAX_EXPERTS = 64;

// The logits' partial sums over one split of the reduction, into
// part [splits, n, 64] fp32: TOK tokens a block; thread (expert tid % 64,
// group tid / 64) sums TOK / 4 tokens' logits.  A decode step's 128
// tokens split the reduction 16 ways, so that 256 blocks share the work.
template <int TOK>
__global__ void __launch_bounds__(ROUTE_THREADS)
moe_route_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gate,
                 float* __restrict__ part, int n, int h, int e, int chunk) {
  constexpr int TPT = TOK / 4;
  __shared__ float xs[TOK][ROUTE_K];
  __shared__ float ws[MAX_EXPERTS][ROUTE_K + 1];
  const int tid = threadIdx.x, ex = tid % MAX_EXPERTS, grp = tid / MAX_EXPERTS;
  const long long t0 = (long long)blockIdx.x * TOK;
  const int lo = blockIdx.y * chunk;
  float acc[TPT];
#pragma unroll
  for (int i = 0; i < TPT; ++i) acc[i] = 0.f;
  for (int k0 = lo; k0 < lo + chunk; k0 += ROUTE_K) {
    for (int j = tid; j < TOK * ROUTE_K; j += ROUTE_THREADS) {
      const int t = j / ROUTE_K, kk = j % ROUTE_K;
      xs[t][kk] =
          t0 + t < n ? __bfloat162float(x[(t0 + t) * h + k0 + kk]) : 0.f;
    }
    for (int j = tid; j < MAX_EXPERTS * ROUTE_K; j += ROUTE_THREADS) {
      const int r = j / ROUTE_K, kk = j % ROUTE_K;
      ws[r][kk] =
          r < e ? __bfloat162float(gate[(long long)r * h + k0 + kk]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < ROUTE_K; ++kk) {
      const float wv = ws[ex][kk];
#pragma unroll
      for (int i = 0; i < TPT; ++i)
        acc[i] = fmaf(xs[grp * TPT + i][kk], wv, acc[i]);
    }
    __syncthreads();
  }
  float* out = part + (long long)blockIdx.y * n * MAX_EXPERTS;
#pragma unroll
  for (int i = 0; i < TPT; ++i) {
    const long long t = t0 + grp * TPT + i;
    if (t < n) out[t * MAX_EXPERTS + ex] = acc[i];
  }
}

// One warp a token: the logits summed over the splits in order, s =
// sigmoid; then k rounds of a warp argmax of s + bias (the lower expert
// on a tie), in descending order of the biased score; the weights
// s[chosen] / (sum + 1e-20) * scale.
__global__ void moe_topk_kernel(const float* __restrict__ part,
                                const float* __restrict__ bias,
                                long long* __restrict__ idx,
                                float* __restrict__ w_out, int n, int e,
                                int k, int splits, float scale) {
  const long long t = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (t >= n) return;
  float l0 = 0.f, l1 = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    const float* row = part + ((long long)sp * n + t) * MAX_EXPERTS;
    l0 += row[lane];
    l1 += row[lane + 32];
  }
  const float s0 = 1.f / (1.f + expf(-l0)), s1 = 1.f / (1.f + expf(-l1));
  float b0 = lane < e ? s0 + bias[lane] : -INFINITY;
  float b1 = lane + 32 < e ? s1 + bias[lane + 32] : -INFINITY;
  float sum = 0.f, mine_s = 0.f;
  int mine = 0;
  for (int j = 0; j < k; ++j) {
    float v = b0;
    int i = lane;
    if (b1 > b0) {
      v = b1;
      i = lane + 32;
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, i, off);
      if (ov > v || (ov == v && oi < i)) {
        v = ov;
        i = oi;
      }
    }
    const float s = __shfl_sync(0xffffffffu, i < 32 ? s0 : s1, i % 32);
    sum += s;
    if (lane == j) {
      mine = i;
      mine_s = s;
    }
    if (i == lane) b0 = -INFINITY;
    if (i == lane + 32) b1 = -INFINITY;
  }
  if (lane < k) {
    idx[t * k + lane] = mine;
    w_out[t * k + lane] = mine_s / (sum + 1e-20f) * scale;
  }
}

// ---- the grouped products ----

template <bool GATED, int BM, int BN, int BK, int WM, int WN, int STAGES>
struct Tiling {
  static constexpr int BLOCK_M = BM, BLOCK_N = BN;
  static constexpr int THREADS = WM * WN * 32;
  static constexpr int TM = BM / WM, TN = BN / WN;
  static constexpr int MT = TM / 16, NT = TN / 8;
  static constexpr int LDS = BK + 8;               // padded row, elements
  static constexpr int CHUNKS = BK / 8;            // 16-byte chunks a row
  static constexpr int WROWS = GATED ? 2 * BN : BN;
  static constexpr int STAGE = (BM + WROWS) * LDS;  // elements a stage
  static constexpr int SMEM = STAGES * STAGE * 2;   // bytes
  static_assert(TM % 16 == 0 && TN % 16 == 0, "warp tile");
};

// a [rows, kdim] (x: the slot's token row, pair / topk; act: the slot's
// own), W[e] [rows of n_out (twice, gate then up, when GATED), kdim];
// slot_pair [slots]: the slot's pair, n_pairs where empty; block_expert
// [slots / BM]: the block's expert, -1 past the used blocks.
template <bool GATED, int BM, int BN, int BK, int WM, int WN, int STAGES>
__global__ void __launch_bounds__(WM* WN * 32)
moe_product_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                   bf16* __restrict__ out,
                   const long long* __restrict__ slot_pair,
                   const long long* __restrict__ block_expert,
                   const float* __restrict__ weight, long long n_pairs,
                   int n_out, int kdim, int topk, long long lda,
                   long long stride_we, long long ldo) {
  using T = Tiling<GATED, BM, BN, BK, WM, WN, STAGES>;
  const long long e = block_expert[blockIdx.x];
  if (e < 0) return;
  extern __shared__ __align__(16) unsigned char raw[];
  bf16* smem = reinterpret_cast<bf16*>(raw);
  __shared__ long long a_row[BM];     // row of `a`, -1 for an empty slot
  __shared__ long long pair_of[BM];   // the slot's pair, -1 if empty
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / WN, wn = warp % WN;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  for (int r = tid; r < BM; r += T::THREADS) {
    const long long p = slot_pair[m0 + r];
    const bool live = p < n_pairs;
    pair_of[r] = live ? p : -1;
    a_row[r] = GATED ? (live ? p / topk : -1) : m0 + r;
  }
  __syncthreads();
  const bf16* we = w + e * stride_we;
  const int n_k = kdim / BK;

  auto load = [&](int stage, int kt) {
    bf16* sa = smem + stage * T::STAGE;
    bf16* sb = sa + BM * T::LDS;
    const int k0 = kt * BK;
    for (int c = tid; c < BM * T::CHUNKS; c += T::THREADS) {
      const int r = c / T::CHUNKS, col = (c % T::CHUNKS) * 8;
      const long long row = a_row[r];
      cp_async16(sa + r * T::LDS + col,
                 a + (row < 0 ? 0 : row * lda) + k0 + col, row < 0 ? 0 : 16);
    }
    for (int c = tid; c < T::WROWS * T::CHUNKS; c += T::THREADS) {
      const int r = c / T::CHUNKS, col = (c % T::CHUNKS) * 8;
      const int n = (GATED && r >= BN) ? n_out + n0 + r - BN : n0 + r;
      cp_async16(sb + r * T::LDS + col, we + (long long)n * kdim + k0 + col,
                 16);
    }
  };

  float acc[T::MT][T::NT][4];
  float acc_up[GATED ? T::MT : 1][GATED ? T::NT : 1][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[i][j][c] = 0.f;
        if (GATED) acc_up[GATED ? i : 0][GATED ? j : 0][c] = 0.f;
      }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k) load(s, s);
    cp_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < n_k) load(next % STAGES, next);
    cp_commit();
    const bf16* sa = smem + (kt % STAGES) * T::STAGE;
    const bf16* sb = sa + BM * T::LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[T::MT][4];
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
        ldsm_x4(af[i], sa + (wm * T::TM + i * 16 + lane % 16) * T::LDS + kk +
                           (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < T::NT / 2; ++j) {
        const int row = wn * T::TN + j * 16 + lane % 8 + (lane / 16) * 8;
        const int col = kk + ((lane / 8) % 2) * 8;
        uint32_t bfr[4];
        ldsm_x4(bfr, sb + row * T::LDS + col);
#pragma unroll
        for (int i = 0; i < T::MT; ++i) {
          mma16816(acc[i][2 * j], af[i], bfr[0], bfr[1]);
          mma16816(acc[i][2 * j + 1], af[i], bfr[2], bfr[3]);
        }
        if (GATED) {
          ldsm_x4(bfr, sb + (BN + row) * T::LDS + col);
#pragma unroll
          for (int i = 0; i < T::MT; ++i) {
            mma16816(acc_up[GATED ? i : 0][GATED ? 2 * j : 0], af[i], bfr[0],
                     bfr[1]);
            mma16816(acc_up[GATED ? i : 0][GATED ? 2 * j + 1 : 0], af[i],
                     bfr[2], bfr[3]);
          }
        }
      }
    }
  }
  cp_wait<0>();

  // thread (lane / 4, 2 (lane % 4)) of each 16 x 8 tile holds rows r, r + 8
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * T::TM + i * 16 + lane / 4 + half * 8;
        const int n = n0 + wn * T::TN + j * 8 + (lane % 4) * 2;
        float v0 = acc[i][j][2 * half], v1 = acc[i][j][2 * half + 1];
        long long dst;
        if (GATED) {
          const float u0 = acc_up[GATED ? i : 0][GATED ? j : 0][2 * half];
          const float u1 = acc_up[GATED ? i : 0][GATED ? j : 0][2 * half + 1];
          v0 = v0 / (1.f + expf(-v0)) * u0;
          v1 = v1 / (1.f + expf(-v1)) * u1;
          dst = m0 + r;
        } else {
          dst = pair_of[r];
          if (dst < 0) continue;
          const float wt = weight[dst];
          v0 *= wt;
          v1 *= wt;
        }
        *reinterpret_cast<__nv_bfloat162*>(out + dst * ldo + n) =
            __floats2bfloat162_rn(v0, v1);
      }
}

// ---- the pairs' sum ----

// one thread a token's 8 columns: out = sum over its k pairs, in order
__global__ void moe_combine_kernel(const bf16* __restrict__ pairs,
                                   float* __restrict__ out, long long n, int k,
                                   int h) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int per_row = h / 8;
  if (i >= n * per_row) return;
  const long long t = i / per_row;
  const int c = (int)(i % per_row) * 8;
  float s[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) s[q] = 0.f;
  for (int j = 0; j < k; ++j) {
    const uint4 v =
        *reinterpret_cast<const uint4*>(pairs + (t * k + j) * h + c);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(p[q]);
      s[2 * q] += f.x;
      s[2 * q + 1] += f.y;
    }
  }
  float4* o = reinterpret_cast<float4*>(out + t * h + c);
  o[0] = make_float4(s[0], s[1], s[2], s[3]);
  o[1] = make_float4(s[4], s[5], s[6], s[7]);
}

// The tilings (gated, BM, BN, BK, warps M x N, stages): decode BM 16, BN
// 64, BK 64, warps 1 x 4, 4 stages; prefill BM 128, BN 64 (gated) or 128,
// BK 64, warps 4 x 2, 3 stages (110.6 KB, two blocks an SM)
#define DECODE_UP_TILING true, 16, 64, 64, 1, 4, 4
#define DECODE_DOWN_TILING false, 16, 64, 64, 1, 4, 4
#define PREFILL_UP_TILING true, 128, 64, 64, 4, 2, 3
#define PREFILL_DOWN_TILING false, 128, 128, 64, 4, 2, 3
typedef Tiling<DECODE_UP_TILING> DecodeUp;
typedef Tiling<DECODE_DOWN_TILING> DecodeDown;
typedef Tiling<PREFILL_UP_TILING> PrefillUp;
typedef Tiling<PREFILL_DOWN_TILING> PrefillDown;
#define DECODE_UP moe_product_kernel<DECODE_UP_TILING>
#define DECODE_DOWN moe_product_kernel<DECODE_DOWN_TILING>
#define PREFILL_UP moe_product_kernel<PREFILL_UP_TILING>
#define PREFILL_DOWN moe_product_kernel<PREFILL_DOWN_TILING>
static_assert(DecodeUp::BLOCK_M == DecodeDown::BLOCK_M &&
                  PrefillUp::BLOCK_M == PrefillDown::BLOCK_M,
              "a tiling's two launches share the slots' layout");

template <typename K>
cudaError_t raise_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" {

// slots a block of each tiling (0 decode, 1 prefill), and the output
// columns a block of the gated and of the down launch
int moe_block_m(int tiling) {
  return tiling ? PrefillUp::BLOCK_M : DecodeUp::BLOCK_M;
}
int moe_block_n(int tiling, int gated) {
  if (tiling) return gated ? PrefillUp::BLOCK_N : PrefillDown::BLOCK_N;
  return gated ? DecodeUp::BLOCK_N : DecodeDown::BLOCK_N;
}
int moe_max_experts() { return MAX_EXPERTS; }

// Raise the products' shared-memory limits; launches nothing.
int moe_prepare() {
  cudaError_t err;
  if ((err = raise_smem(DECODE_UP, DecodeUp::SMEM)) != cudaSuccess ||
      (err = raise_smem(DECODE_DOWN, DecodeDown::SMEM)) != cudaSuccess ||
      (err = raise_smem(PREFILL_UP, PrefillUp::SMEM)) != cudaSuccess ||
      (err = raise_smem(PREFILL_DOWN, PrefillDown::SMEM)) != cudaSuccess)
    return (int)err;
  return 0;
}

// x [n, h] bf16, gate [e, h] bf16, bias [e] fp32;
// part [splits, n, 64] fp32 scratch (route_splits(n, h)); idx [n, k]
// int64, w [n, k] fp32.
int moe_route_splits(int n, int h) {
  return n <= 1024 && h % (16 * ROUTE_K) == 0 ? 16 : 1;
}

int moe_route(const void* x, const void* gate, const void* bias, void* part,
              void* idx, void* w, int n, int h, int e, int k, float scale,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* gp = static_cast<const bf16*>(gate);
  float* pp = static_cast<float*>(part);
  const int splits = moe_route_splits(n, h), chunk = h / splits;
  if (n <= 1024)
    moe_route_kernel<8><<<dim3((n + 7) / 8, splits), ROUTE_THREADS, 0, s>>>(
        xp, gp, pp, n, h, e, chunk);
  else
    moe_route_kernel<32><<<dim3((n + 31) / 32, splits), ROUTE_THREADS, 0,
                            s>>>(xp, gp, pp, n, h, e, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moe_topk_kernel<<<(unsigned)(((long long)n * 32 + 255) / 256), 256, 0, s>>>(
      pp, static_cast<const float*>(bias), static_cast<long long*>(idx),
      static_cast<float*>(w), n, e, k, splits, scale);
  return (int)cudaGetLastError();
}

// The gated and the down product, then the pairs' sum.  x [n, h] bf16;
// gate_up [e, 2 inter, h], down [e, h, inter] bf16; slot_pair [blocks *
// BM], block_expert [blocks] int64; weight [n k] fp32; act [blocks * BM,
// inter], pairs [n k, h] bf16 scratch; out [n, h] fp32.
int moe_experts(int tiling, const void* x, const void* gate_up,
                const void* down, const void* slot_pair,
                const void* block_expert, const void* weight, void* act,
                void* pairs, void* out, int blocks, int n, int k, int h,
                int inter, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_pairs = (long long)n * k;
  const long long* sp = static_cast<const long long*>(slot_pair);
  const long long* be = static_cast<const long long*>(block_expert);
  const float* wt = static_cast<const float*>(weight);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* gu = static_cast<const bf16*>(gate_up);
  const bf16* dn = static_cast<const bf16*>(down);
  bf16* ap = static_cast<bf16*>(act);
  bf16* pp = static_cast<bf16*>(pairs);
  const dim3 up_grid(blocks, inter / moe_block_n(tiling, 1));
  const dim3 down_grid(blocks, h / moe_block_n(tiling, 0));
  if (tiling == 0) {
    DECODE_UP<<<up_grid, DecodeUp::THREADS, DecodeUp::SMEM, s>>>(
        xp, gu, ap, sp, be, wt, n_pairs, inter, h, k, h,
        2LL * inter * h, inter);
  } else {
    PREFILL_UP<<<up_grid, PrefillUp::THREADS, PrefillUp::SMEM, s>>>(
        xp, gu, ap, sp, be, wt, n_pairs, inter, h, k, h,
        2LL * inter * h, inter);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (tiling == 0) {
    DECODE_DOWN<<<down_grid, DecodeDown::THREADS, DecodeDown::SMEM, s>>>(
        ap, dn, pp, sp, be, wt, n_pairs, h, inter, k, inter,
        (long long)h * inter, h);
  } else {
    PREFILL_DOWN<<<down_grid, PrefillDown::THREADS, PrefillDown::SMEM, s>>>(
        ap, dn, pp, sp, be, wt, n_pairs, h, inter, k, inter,
        (long long)h * inter, h);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long chunks = (long long)n * (h / 8);
  moe_combine_kernel<<<(unsigned)((chunks + 255) / 256), 256, 0, s>>>(
      pp, static_cast<float*>(out), n, k, h);
  return (int)cudaGetLastError();
}

}  // extern "C"
