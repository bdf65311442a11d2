// Fused multi-head attention for Hopper (sm_90a): kernel 2 of the port.
//
// Replaces the Pallas TPU kernel spmm_tpu/ops/pallas_attention.py `_mha_kernel`
// (wrapper `pallas_mha`), which every attention of the SMILES->PV path runs:
// the 6 text layers once per batch, then per property step the 6 property
// self-attentions and the 6 fusion layers' causal self- and cross-attention.
// It computes what that kernel computes:
//
//   out[b,h,i] = softmax_j(q[b,h,i] . k[b,h,j] * scale + mask[b,i,j]) . v[b,h]
//
//   scores and softmax in fp32 (an exact two-pass exp(s - max) / sum, as
//   jax.nn.softmax); probabilities rounded to v's dtype (bf16 for bf16
//   inputs) before the V product, which accumulates in fp32; the output is
//   stored in q's dtype.  Every key of every row is computed: masks are
//   -10000, not -inf, so a row whose keys are all masked comes out uniform
//   over its (shifted) scores, as in JAX.
//
// Layout.  q [B,h,Lq,D], k/v [B,h,Lk,D] and out [B,h,Lq,D] are strided: the
// wrapper passes their B/h/L strides in elements, D is contiguous.  That
// takes split_heads views ([B,L,h,D] transposed) without a copy, and lets the
// wrapper allocate out as [B,Lq,h,D] so that merge_heads is a view.  The
// head-uniform mask (`additive_mask[:, 0]` of the JAX wrapper) is fp32 with
// strides (b, query row, key); a padding mask [B,1,1,Lk] has a query-row
// stride of 0, a causal mask [B,1,Lq,Lk] a real one.  A null mask adds 0.
// q, k, v and out must be 16-byte aligned, rows and all.
//
// What bounds it on an H100.  At the path's largest launch (B=128, h=12,
// Lq=54, Lk=100, D=64, fp32) the function moves q, k, v and out once,
// 121 MB, 36 us at 3.35 TB/s; its 2.1 GFLOP take 32 us at the 67 TFLOP/s
// fp32 rate.  Bytes and fp32 FMAs bound it together, so the design has to
// overlap the two and keep the FMA units fed.  No tensor cores: the fp32 path
// must stay fp32 (parity bar 2e-5, TF32 keeps 3 digits).
//
//   - Persistent blocks.  The grid is what fits the card at once (the
//     occupancy of this launch's shared memory and registers); each block
//     walks work items, an item being 16 * TM query rows of one (b, h)
//     slice: 32 where Lq <= 32, else 64 (TM is a template argument).
//   - Shared memory sized to the launch's Lk, and small enough for several
//     blocks per SM: the item's K, V and Q rows are copied in with 16-byte
//     cp.async (rows are strided in device memory, so no bulk copy fits
//     them), and the fp32 scores then overwrite K and Q.  At 54x100 that is
//     72 KB, three blocks (24 warps) per SM, so one block's copies overlap
//     the others' compute.  Double-buffering inside a block instead (the
//     next item's rows copied while the current one computes) took 208 KB,
//     one block of 8 warps per SM, and was slower: with so few warps
//     every phase's latency shows (PERF.md).
//   - Register micro-tiles, as in an SGEMM.  For the scores each thread owns
//     TM query rows x TN keys (TN * 16 >= Lk, a template argument): per 4
//     values of d it reads TM float4 of Q and TN float4 of K and does
//     4 * TM * TN FMAs.  For P.V each thread owns TM rows x D/16 columns:
//     per 4 keys it reads TM float4 of P and 4 rows of V and does
//     4 * TM * D/16 FMAs.  Each
//     sum runs in the plain version's order (d ascending for scores, j
//     ascending for P.V), and the softmax is the exact two passes of one warp
//     per row (a warp's 8 rows side by side, so that their shuffles and
//     exponentials overlap), so the numbers are those of the earlier
//     one-block-per-(b, h) design.
//   - The mask: a padding mask's one row is copied in with the item; a mask
//     with a row per query is read where the scores are written.
//
// Past 256 keys (kMaxKeys; fmha_max_keys() tells the wrapper) the item's
// scores no longer fit beside all of its K and V, and a second kernel,
// fused_mha_long_kernel, takes over.  It replaces the same Pallas kernel,
// which holds an item's whole score block in VMEM, and it does the same for
// the 32 (or 16) query rows of an item: their fp32 scores over every live
// key stay resident in shared memory (64 KB at Lk 512), while K and then V
// stream through in tiles of kLongTileKeys = 64 keys.  It runs on the
// fine-tune eval (a batch padded with one molecule past 256 tokens, B=64,
// 512x512) and the reaction encoder (a source past 256 tokens, B=16,
// 288x288), both fp32.  What bounds it: at B=64 512x512 the 4.8 GFLOP (two
// FMAs per (query, key, d)) take 0.76 ms at 67 TFLOP/s, the 0.15 GB moved
// 0.04 ms, so fp32 FMAs; at the reaction encoder's 288x288, where 15 of 16
// rows are short sources padded to 288, the work the data needs is small
// and the bytes of q, out and the attended K/V rows bound it, so what
// counts there is the per-item cost of the rows that attend few keys.
// What the design does about it:
//
//   - q.k once.  The scores of an item are computed once, tile by tile, and
//     written to shared memory; the exact two-pass softmax (max, then the
//     sum of exp(s - max), one warp per row, lanes over keys as in
//     fused_mha_kernel) then runs over the resident rows and rounds
//     exp(s - max) / sum to v's dtype at the plain version's point.  So
//     the FMAs are the two units the work needs, not the three of a
//     streaming two-pass softmax, and an online softmax (which would round
//     unnormalized probabilities in bf16) is not needed.  Sums run in the
//     plain orders: d ascending for a score, keys ascending for P.V.
//   - Two tiles in flight.  K tiles, then V tiles, go through a ring of two
//     stages with 16-byte cp.async, one commit group per tile and
//     wait_group<1>, so tile t+1 lands while tile t computes; the first two
//     V tiles land during the softmax, and the next item's Q and first K
//     tile during this item's last two tiles, so the pipeline does not
//     drain between items.  The padding scan of the next item (below)
//     reads its mask row during this item's last tile and shares its
//     barriers, so a short row waits on no extra round trip.
//   - Warps per SM over depth inside one block: 32-row items (16 where Lq
//     <= 16 or where 32 rows do not fit), the scores 128 * Lk bytes (64 KB
//     at Lk 512), two 17 KB stages and 8.7 KB of Q: 110.6 KB, two blocks
//     (16 warps) per SM at Lk 512 in fp32.  The kernel takes every Lk for
//     which an item's resident scores fit two blocks per SM (half the SM's
//     shared memory less the per-block reserve): 32-row items to 512 keys
//     and 16-row items to 1,152 in fp32 at D=64 (bf16: 704 and 1,408), so
//     at least twice the 512-row position table.  Past that a third
//     kernel, fused_mha_stream_kernel (two passes over streamed 128-key
//     tiles, one tile in flight; it computes q.k twice), takes any Lk.  The
//     switch is on Lk alone; fmha_occupancy() reports which launch a shape
//     gets.
//   - Micro-tiles: a warp is 4 row groups x 8 key (or column) groups, a
//     thread 2 rows x 4 keys of the scores (keys 8 apart, so that the 8
//     groups' 16-byte K reads hit distinct banks) and 2 rows x D/16
//     columns of P.V: 6 16-byte reads for 32 FMAs in both products.  Score
//     rows are padded by 8 floats, so the 4 row groups' reads and writes
//     of S fall in distinct banks.  P.V cannot take more: 32 rows x D
//     outputs over 256 threads, each a sum over keys in order, is 8 a
//     thread.  On an H100 the two products run at about 40% of the fp32
//     rate at 512x512, and their shared-memory reads take about a third of
//     their time (PERF.md; 4 x 4 score tiles over 128-key K tiles gained
//     under 3% there, and spilled).
//   - The padding-mask skip of the streaming kernel: the tiles past the
//     last key whose mask lies within kSkipGap of the row's largest are
//     neither loaded nor computed.  Each of their keys would add exp(s + m
//     - max) with m at least 1000 below the mask of the key that sets max,
//     which is 0 in fp32 (expf is 0 below -104) unless two scaled scores
//     differ by more than 896.  A fully masked row keeps every tile (all
//     its masks are equal).  With resident scores this also bounds the
//     scores written, so a short row costs one K and one V tile.
//
// Left for later work: padding waste (an item computes 16 * TM query rows
// and 16 * TN keys, so 54 x 100 does 26% more FMAs than it needs, Lq = 16
// twice); the bf16 path on tensor cores (mma.sync / wgmma), as both long
// kernels run bf16 on CUDA cores; and for the long kernel, score tiles of
// 8 x 8 a thread as in an SGEMM, and a P.V split over keys, which would
// change its order of summation.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (spmm_tpu_torch/ops/_build.py); plain C interface,
//        bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxKeys = 256;           // Lk <= 256: fused_mha_kernel
constexpr int kLongTileKeys = 64;       // keys per K/V tile of fused_mha_long_kernel
constexpr int kStreamTileKeys = 128;    // keys per tile of fused_mha_stream_kernel
constexpr float kSkipGap = 1000.f;      // masks this far below the row's max add 0

// probabilities take v's dtype before the V product
template <typename T> __device__ __forceinline__ float round_prob(float p);
template <> __device__ __forceinline__ float round_prob<float>(float p) { return p; }
template <> __device__ __forceinline__ float round_prob<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16(p));
}

// x / y for the softmax's normalization, from r = 1 / y: the product x r,
// corrected by one FMA of its remainder, which is x / y rounded to nearest
// for the normal values the softmax divides (a sum >= 1); a few instructions
// where the IEEE division takes a dozen.
__device__ __forceinline__ float divide(float x, float y, float r) {
  const float q = x * r;
  return fmaf(fmaf(-q, y, x), r, q);
}

// N consecutive values (N = 2 or 4) from shared memory, widened to fp32
__device__ __forceinline__ void load_f(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load_f(const float* p, float (&o)[2]) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  o[0] = v.x; o[1] = v.y;
}
__device__ __forceinline__ void load_f(const __nv_bfloat16* p, float (&o)[4]) {
  const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(v[0]), b = __bfloat1622float2(v[1]);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}
__device__ __forceinline__ void load_f(const __nv_bfloat16* p, float (&o)[2]) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  o[0] = a.x; o[1] = a.y;
}
__device__ __forceinline__ void store_f(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store_f(float* p, const float (&o)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(o[0], o[1]);
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, const float (&o)[4]) {
  __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(p);
  v[0] = __floats2bfloat162_rn(o[0], o[1]);
  v[1] = __floats2bfloat162_rn(o[2], o[3]);
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, const float (&o)[2]) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(o[0], o[1]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

struct Args {
  int H, Lq, Lk, n_items, row_blocks;
  // element strides: q, k, v, out as (b, h, l); mask as (b, query row, key)
  long long qs[3], ks[3], vs[3], os[3], ms[3];
  float scale;
};

// Shared memory, in order: K [Lk][D+pad] and Q [16*TM][D+pad] in T, which
// the scores S / P [16*TM][16*TN] fp32 overwrite once the products are done; V
// [Lk4][D+pad] in T; the mask row [16*TN] fp32 that a padding mask gives
// every query row.  Rows of K, Q and V are padded by 16 bytes so that the
// micro-tiles' 16-byte reads of 8 consecutive rows hit distinct banks.
template <typename T, int D, int TN, int TM>
struct Layout {
  static constexpr int kRow = D + 16 / (int)sizeof(T);
  static constexpr int kKeys = 16 * TN;
  static constexpr int kRows = 16 * TM;                // query rows of an item
  __host__ __device__ static size_t kq_bytes(int lk) {
    const size_t kq = (size_t)(lk + kRows) * kRow * sizeof(T);
    const size_t s = sizeof(float) * kRows * kKeys;
    return kq > s ? kq : s;                          // both multiples of 16
  }
  static size_t bytes(int lk) {
    return kq_bytes(lk) + (size_t)((lk + 3) & ~3) * kRow * sizeof(T) +
           sizeof(float) * kKeys;
  }
};

// grid: persistent, kThreads threads; thread (tr, tc) = (tid / 16, tid % 16)
// owns query rows tr + 16 r (r < TM) of an item, keys tc + 16 n (n < TN) of
// the scores and columns tc * D/16 ... of the output.
template <typename T, int D, int TN, int TM>
__global__ void __launch_bounds__(kThreads, TN <= 8 ? 3 : 1)
fused_mha_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ mask,
                 T* __restrict__ out, const Args a) {
  using Lay = Layout<T, D, TN, TM>;
  constexpr int ROW = Lay::kRow;
  constexpr int KEYS = Lay::kKeys;
  constexpr int ROWS = Lay::kRows;
  constexpr int CPT = D / 16;                          // output columns per thread
  constexpr int PIECES = D * (int)sizeof(T) / 16;      // 16-byte pieces per row
  constexpr int PER_PIECE = 16 / (int)sizeof(T);
  extern __shared__ float4 smem4[];
  const int Lk = a.Lk, Lk4 = (Lk + 3) & ~3;
  unsigned char* base = reinterpret_cast<unsigned char*>(smem4);
  T* kb = reinterpret_cast<T*>(base);
  T* qb = kb + (size_t)Lk * ROW;
  float* s_p = reinterpret_cast<float*>(base);                      // [ROWS][KEYS]
  T* vb = reinterpret_cast<T*>(base + Lay::kq_bytes(Lk));
  float* mrow = reinterpret_cast<float*>(vb + (size_t)Lk4 * ROW);   // [KEYS]
  const bool shared_mask_row = a.ms[1] == 0;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int tr = tid >> 4, tc = tid & 15;

  // V rows Lk..Lk4-1 are zeros (P is zero there too), so the P.V loop runs
  // over whole groups of 4 keys
  for (int x = tid; x < (Lk4 - Lk) * D; x += kThreads)
    vb[(size_t)(Lk + x / D) * ROW + x % D] = T(0.f);

  struct Item { int b, h, row0, rows; };
  auto item = [&](int it) {
    const int slice = it / a.row_blocks;
    const int row0 = (it - slice * a.row_blocks) * ROWS;
    return Item{slice / a.H, slice % a.H, row0, min(ROWS, a.Lq - row0)};
  };
  // copies the item's K, V and Q rows and its shared mask row
  auto load = [&](int it) {
    const Item w = item(it);
    const T* kg = k + w.b * a.ks[0] + w.h * a.ks[1];
    const T* vg = v + w.b * a.vs[0] + w.h * a.vs[1];
    const T* qg = q + w.b * a.qs[0] + w.h * a.qs[1] + w.row0 * a.qs[2];
    for (int x = tid; x < Lk * PIECES; x += kThreads) {
      const int j = x / PIECES, e = (x - j * PIECES) * PER_PIECE;
      cp_async16(kb + j * ROW + e, kg + j * a.ks[2] + e);
      cp_async16(vb + j * ROW + e, vg + j * a.vs[2] + e);
    }
    for (int x = tid; x < w.rows * PIECES; x += kThreads) {
      const int i = x / PIECES, e = (x - i * PIECES) * PER_PIECE;
      cp_async16(qb + i * ROW + e, qg + i * a.qs[2] + e);
    }
    if (mask != nullptr && shared_mask_row)
      for (int j = tid; j < Lk; j += kThreads)
        cp_async4(mrow + j, mask + w.b * a.ms[0] + j * a.ms[2]);
    cp_async_commit();
  };

  int it = blockIdx.x;
  if (it < a.n_items) load(it);
  for (; it < a.n_items; it += gridDim.x) {
    const Item w = item(it);
    cp_async_wait<0>();
    __syncthreads();

    // ---- scores: TM rows x TN keys per thread, d ascending (keys past Lk
    // repeat row Lk-1, rows past the item's repeat garbage: never read) ----
    float acc[TM][TN];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int n = 0; n < TN; ++n) acc[r][n] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float qv[TM][4];
#pragma unroll
      for (int r = 0; r < TM; ++r) load_f(qb + (tr + 16 * r) * ROW + d, qv[r]);
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        float kv[4];
        load_f(kb + min(tc + 16 * n, Lk - 1) * ROW + d, kv);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int r = 0; r < TM; ++r) acc[r][n] = fmaf(qv[r][e], kv[e], acc[r][n]);
      }
    }
    __syncthreads();                     // K and Q are read: S overwrites them
    {
      const float* mg = mask == nullptr || shared_mask_row
                            ? nullptr : mask + w.b * a.ms[0] + w.row0 * a.ms[1];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int n = 0; n < TN; ++n) {
          const int i = tr + 16 * r, j = tc + 16 * n;
          float m = 0.f;
          if (mask != nullptr)
            m = shared_mask_row ? mrow[j]
                : (i < w.rows && j < Lk) ? mg[i * a.ms[1] + j * a.ms[2]] : 0.f;
          s_p[i * KEYS + j] = acc[r][n] * a.scale + m;
        }
    }
    __syncthreads();

    // ---- exact two-pass softmax in fp32, one warp per row: the warp's 8
    // rows go side by side, so that their reductions overlap ----
    {
      constexpr int NT = (KEYS + 31) / 32;               // keys per lane
      constexpr int RPW = ROWS / kWarps;                 // rows per warp
      float sv[RPW][NT], mx[RPW], sum[RPW];
#pragma unroll
      for (int u = 0; u < RPW; ++u) {
        const int i = warp + kWarps * u;
        mx[u] = -INFINITY;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int j = lane + 32 * t;
          sv[u][t] = (i < w.rows && j < Lk) ? s_p[i * KEYS + j] : -INFINITY;
          mx[u] = fmaxf(mx[u], sv[u][t]);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < RPW; ++u)
          mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], o));
#pragma unroll
      for (int u = 0; u < RPW; ++u) {
        sum[u] = 0.f;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const float e = lane + 32 * t < Lk && warp + kWarps * u < w.rows
                              ? expf(sv[u][t] - mx[u]) : 0.f;
          sv[u][t] = e;
          sum[u] += e;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < RPW; ++u) sum[u] += __shfl_xor_sync(0xffffffffu, sum[u], o);
#pragma unroll
      for (int u = 0; u < RPW; ++u) {
        const int i = warp + kWarps * u;
        if (i >= w.rows) break;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int j = lane + 32 * t;
          if (j < Lk4) s_p[i * KEYS + j] = j < Lk ? round_prob<T>(sv[u][t] / sum[u]) : 0.f;
        }
      }
    }
    __syncthreads();

    // ---- out rows = P . V, TM rows x D/16 columns per thread, j ascending ----
    {
      float o[TM][CPT];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) o[r][c] = 0.f;
      for (int j = 0; j < Lk4; j += 4) {
        float p[TM][4];
#pragma unroll
        for (int r = 0; r < TM; ++r) load_f(s_p + (tr + 16 * r) * KEYS + j, p[r]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float vv[CPT];
          load_f(vb + (j + jj) * ROW + tc * CPT, vv);
#pragma unroll
          for (int r = 0; r < TM; ++r)
#pragma unroll
            for (int c = 0; c < CPT; ++c) o[r][c] = fmaf(p[r][jj], vv[c], o[r][c]);
        }
      }
      T* ob = out + w.b * a.os[0] + w.h * a.os[1];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int i = tr + 16 * r;
        if (i < w.rows) store_f(ob + (w.row0 + i) * a.os[2] + tc * CPT, o[r]);
      }
    }
    __syncthreads();                     // all of shared memory is free
    if (it + (int)gridDim.x < a.n_items) load(it + gridDim.x);
  }
}

// Shared memory of fused_mha_long_kernel, in order: the item's fp32 scores,
// then probabilities, S / P [16*TM][score_stride(Lk)] (rows padded by 8
// floats: the 4 row groups of a warp fall in distinct banks); the item's Q
// rows [16*TM][D+pad] in T; the ring of two tile stages [2][kLongTileKeys]
// [D+pad] in T, each holding a K tile or a V tile; the two stages' mask
// tiles [2][kLongTileKeys] fp32 that a padding mask gives every query row;
// the warps' mask maxima [kWarps] fp32 and the item's last live key (an int).
template <typename T, int D, int TM>
struct LongLayout {
  static constexpr int kRow = D + 16 / (int)sizeof(T);
  static constexpr int kRows = 16 * TM;
  static constexpr size_t kStage = (size_t)kLongTileKeys * kRow * sizeof(T);
  static constexpr size_t kQ = (size_t)kRows * kRow * sizeof(T);
  __host__ __device__ static int score_stride(int lk) {
    return (lk + kLongTileKeys - 1) / kLongTileKeys * kLongTileKeys + 8;
  }
  __host__ __device__ static size_t s_bytes(int lk) {
    return sizeof(float) * kRows * score_stride(lk);
  }
  static size_t bytes(int lk) {
    return s_bytes(lk) + kQ + 2 * kStage +
           sizeof(float) * (2 * kLongTileKeys + kWarps) + sizeof(int);
  }
};

// Lk past kMaxKeys while an item's scores fit two blocks per SM (the source
// note).  An item is 16 * TM query rows of one (b, h) slice; its loads are
// K tiles 0 .. n_live-1, then V tiles 0 .. n_live-1, load l in stage l % 2.
// Warp w, lane (rg, cg) = (lane / 8, lane % 8): rows (w / 2) * 4 * TM + rg +
// 4 r (r < TM); of a tile's scores the keys (w % 2) * 32 + cg + 8 n (n < 4);
// of P.V the columns (w % 2) * D/2 + cg * D/16 ... + D/16 - 1.
template <typename T, int D, int TM>
__global__ void __launch_bounds__(kThreads, 2)
fused_mha_long_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ mask,
                      T* __restrict__ out, const Args a) {
  using Lay = LongLayout<T, D, TM>;
  constexpr int ROW = Lay::kRow;
  constexpr int ROWS = Lay::kRows;
  constexpr int KT = kLongTileKeys;
  constexpr int CPT = D / 16;                          // output columns per thread
  constexpr int PIECES = D * (int)sizeof(T) / 16;
  constexpr int PER_PIECE = 16 / (int)sizeof(T);
  constexpr int SCAN = 6;                              // mask keys per thread
  extern __shared__ float4 smem4[];
  const int Lk = a.Lk;
  const int SKS = Lay::score_stride(Lk);
  unsigned char* base = reinterpret_cast<unsigned char*>(smem4);
  float* s_p = reinterpret_cast<float*>(base);                    // [ROWS][SKS]
  T* qb = reinterpret_cast<T*>(base + Lay::s_bytes(Lk));
  T* ring = reinterpret_cast<T*>(base + Lay::s_bytes(Lk) + Lay::kQ);
  float* mtile = reinterpret_cast<float*>(base + Lay::s_bytes(Lk) + Lay::kQ +
                                          2 * Lay::kStage);       // [2][KT]
  float* warp_max = mtile + 2 * KT;                               // [kWarps]
  int& last_live = *reinterpret_cast<int*>(warp_max + kWarps);
  const bool shared_mask_row = a.ms[1] == 0;
  // under a padding mask only the tiles up to the last live key are loaded
  // (the source note says why the rest add 0); a thread scans SCAN keys
  const bool skip = mask != nullptr && shared_mask_row && Lk <= kThreads * SCAN;
  const int n_tiles = (Lk + KT - 1) / KT;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int rg = lane >> 3, cg = lane & 7;
  const int row_t = (warp >> 1) * 4 * TM + rg;        // the thread's rows: row_t + 4 r
  const int half = warp & 1;                          // its key half / column half
  const int col_t = half * (D / 2) + cg * CPT;

  struct Item { int b, h, row0, rows, n_live; };
  auto item_at = [&](int it) {
    const int slice = it / a.row_blocks;
    const int row0 = (it - slice * a.row_blocks) * ROWS;
    return Item{slice / a.H, slice % a.H, row0, min(ROWS, a.Lq - row0), n_tiles};
  };

  // The padding scan of item w, in three parts around two barriers:
  // scan_load reads the thread's keys of its mask row, scan_publish (before
  // a barrier) the warps' largest masks, scan_last (after it) each thread's
  // last key within kSkipGap of the row's largest; after the next barrier
  // last_live / KT + 1 is the item's live tiles.
  auto scan_load = [&](const Item& w, float (&mv)[SCAN]) {
    const float* mg = mask + w.b * a.ms[0];
#pragma unroll
    for (int x = 0; x < SCAN; ++x) {
      const int j = tid + kThreads * x;
      mv[x] = j < Lk ? mg[j * a.ms[2]] : -INFINITY;
    }
  };
  auto scan_publish = [&](const float (&mv)[SCAN]) {
    float mm = mv[0];
#pragma unroll
    for (int x = 1; x < SCAN; ++x) mm = fmaxf(mm, mv[x]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, off));
    if (lane == 0) warp_max[warp] = mm;
    if (tid == 0) last_live = 0;
  };
  auto scan_last = [&](const float (&mv)[SCAN]) {
    float mm = warp_max[0];
    for (int x = 1; x < kWarps; ++x) mm = fmaxf(mm, warp_max[x]);
    int mine = 0;
#pragma unroll
    for (int x = 0; x < SCAN; ++x)
      if (mv[x] >= mm - kSkipGap) mine = tid + kThreads * x;
    atomicMax(&last_live, mine);
  };

  // load l of item w into stage l % 2 (the stage is free): K tile l with its
  // mask tile (and Q with tile 0) while l < n_live, else V tile l - n_live,
  // whose rows past Lk up to a multiple of 4 are zeros, as P is there.
  // Load 0 is always K tile 0, so it is issued before n_live is known.
  auto issue = [&](const Item& w, int l) {
    const int st = l & 1;
    T* dst = ring + (size_t)st * KT * ROW;
    const bool is_k = l < w.n_live;
    const int j0 = (is_k ? l : l - w.n_live) * KT, nk = min(KT, Lk - j0);
    const T* src = is_k ? k + w.b * a.ks[0] + w.h * a.ks[1] + j0 * a.ks[2]
                        : v + w.b * a.vs[0] + w.h * a.vs[1] + j0 * a.vs[2];
    const long long rs = is_k ? a.ks[2] : a.vs[2];
    for (int x = tid; x < nk * PIECES; x += kThreads) {
      const int j = x / PIECES, e = (x - j * PIECES) * PER_PIECE;
      cp_async16(dst + j * ROW + e, src + j * rs + e);
    }
    if (is_k) {
      if (mask != nullptr && shared_mask_row)
        for (int j = tid; j < nk; j += kThreads)
          cp_async4(mtile + st * KT + j, mask + w.b * a.ms[0] + (j0 + j) * a.ms[2]);
      if (l == 0) {
        const T* qg = q + w.b * a.qs[0] + w.h * a.qs[1] + w.row0 * a.qs[2];
        for (int x = tid; x < w.rows * PIECES; x += kThreads) {
          const int i = x / PIECES, e = (x - i * PIECES) * PER_PIECE;
          cp_async16(qb + i * ROW + e, qg + i * a.qs[2] + e);
        }
      }
    } else {
      const int nk4 = (nk + 3) & ~3;
      for (int x = tid; x < (nk4 - nk) * D; x += kThreads)
        dst[(nk + x / D) * ROW + x % D] = T(0.f);
    }
  };

  // ---- K tile t: its scores, d ascending, into S (keys past Lk and rows
  // past the item's are computed from stale rows and never read) ----
  auto scores = [&](const Item& w, int t, const T* kt, const float* mt) {
    float acc[TM][4];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[r][n] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float qv[TM][4];
#pragma unroll
      for (int r = 0; r < TM; ++r) load_f(qb + (row_t + 4 * r) * ROW + d, qv[r]);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float kv[4];
        load_f(kt + (half * 32 + cg + 8 * n) * ROW + d, kv);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int r = 0; r < TM; ++r) acc[r][n] = fmaf(qv[r][e], kv[e], acc[r][n]);
      }
    }
    const int j0 = t * KT;
    const float* mq = mask == nullptr || shared_mask_row
                          ? nullptr : mask + w.b * a.ms[0] + w.row0 * a.ms[1];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int i = row_t + 4 * r, jt = half * 32 + cg + 8 * n, j = j0 + jt;
        float m = 0.f;
        if (mask != nullptr)
          m = shared_mask_row ? mt[jt]
              : (i < w.rows && j < Lk) ? mq[i * a.ms[1] + j * a.ms[2]] : 0.f;
        s_p[i * SKS + j] = acc[r][n] * a.scale + m;
      }
  };

  // ---- the exact two-pass softmax over the first L keys of each row, one
  // warp per row: max, sum of exp(s - max), then exp(s - max) / sum (by
  // divide) in v's dtype; keys L .. L4-1 get probability 0.  A warp's rows go side by
  // side, so that their loads, exponentials and shuffles overlap; rows past
  // the item's hold stale scores, and their probabilities are never stored.
  auto softmax = [&](int L) {
    constexpr int RPW = ROWS / kWarps;
    const int L4 = (L + 3) & ~3;
    float* row[RPW];
    float mx[RPW], sum[RPW];
#pragma unroll
    for (int u = 0; u < RPW; ++u) {
      row[u] = s_p + (warp + kWarps * u) * SKS;
      mx[u] = -INFINITY;
      sum[u] = 0.f;
    }
#pragma unroll 2
    for (int j = lane; j < L; j += 32)
#pragma unroll
      for (int u = 0; u < RPW; ++u) mx[u] = fmaxf(mx[u], row[u][j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < RPW; ++u)
        mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], off));
#pragma unroll 2
    for (int j = lane; j < L; j += 32)
#pragma unroll
      for (int u = 0; u < RPW; ++u) {
        const float e = expf(row[u][j] - mx[u]);
        row[u][j] = e;
        sum[u] += e;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < RPW; ++u) sum[u] += __shfl_xor_sync(0xffffffffu, sum[u], off);
    float rcp[RPW];
#pragma unroll
    for (int u = 0; u < RPW; ++u) rcp[u] = 1.f / sum[u];
#pragma unroll 2
    for (int j = lane; j < L4; j += 32)
#pragma unroll
      for (int u = 0; u < RPW; ++u)
        row[u][j] = j < L ? round_prob<T>(divide(row[u][j], sum[u], rcp[u])) : 0.f;
  };

  // ---- V tile t: o += P . V over its keys below L, ascending ----
  auto pv = [&](int t, const T* vt, float (&o)[TM][CPT], int L) {
    const int j0 = t * KT;
    const int nk4 = (min(KT, L - j0) + 3) & ~3;
#pragma unroll 2
    for (int j = 0; j < nk4; j += 4) {
      float p[TM][4];
#pragma unroll
      for (int r = 0; r < TM; ++r) load_f(s_p + (row_t + 4 * r) * SKS + j0 + j, p[r]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[CPT];
        load_f(vt + (j + jj) * ROW + col_t, vv);
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int c = 0; c < CPT; ++c) o[r][c] = fmaf(p[r][jj], vv[c], o[r][c]);
      }
    }
  };

  int it = blockIdx.x;
  if (it >= a.n_items) return;
  Item cur = item_at(it);
  issue(cur, 0);
  cp_async_commit();
  cp_async_commit();          // load 1 waits for n_live: an empty group holds its place
  float mv[SCAN];
  if (skip) {
    scan_load(cur, mv);
    scan_publish(mv);
    __syncthreads();
    scan_last(mv);
  }
  for (;;) {
    const int next_it = it + gridDim.x;
    const bool has_next = next_it < a.n_items;
    Item nxt = has_next ? item_at(next_it) : cur;
    float o[TM][CPT];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) o[r][c] = 0.f;
    int N = 2, L = 0;                         // set at step 0, once the scan is in
    for (int l = 0; l < N; ++l) {
      if (l == cur.n_live) softmax(L);        // every score is written
      cp_async_wait<1>();                     // load l has landed
      __syncthreads();
      if (l == 0) {
        if (skip) cur.n_live = last_live / KT + 1;
        N = 2 * cur.n_live;
        L = min(cur.n_live * KT, Lk);         // the keys computed
        issue(cur, 1);
        cp_async_commit();
      }
      // the next item's scan reads its mask row during this item's last step
      const bool scan = skip && has_next && l == N - 1;
      if (scan) scan_load(nxt, mv);
      const T* tile = ring + (size_t)(l & 1) * KT * ROW;
      if (l < cur.n_live) scores(cur, l, tile, mtile + (l & 1) * KT);
      else pv(l - cur.n_live, tile, o, L);
      if (scan) scan_publish(mv);
      __syncthreads();                        // stage l % 2 is free
      if (scan) scan_last(mv);
      // two loads ahead: this item's, then the next item's load 0 (its Q
      // too: this item's scores are done by its load N - 2), and in place of
      // its load 1 an empty group
      if (l + 2 < N) issue(cur, l + 2);
      else if (has_next && l + 2 == N) issue(nxt, 0);
      cp_async_commit();
    }
    T* ob = out + cur.b * a.os[0] + cur.h * a.os[1];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int i = row_t + 4 * r;
      if (i < cur.rows) store_f(ob + (cur.row0 + i) * a.os[2] + col_t, o[r]);
    }
    if (!has_next) break;
    it = next_it;
    cur = nxt;
  }
  cp_async_wait<0>();
}

// Shared memory of the streaming kernel, in order: the K tile
// [kStreamTileKeys][D+pad] in T, which the tile's fp32 scores S / P
// [16*TM][kStreamTileKeys] overwrite once the products are done; the V tile
// [kStreamTileKeys][D+pad] in T; the item's Q rows [16*TM][D+pad] in T,
// kept over both passes; the tile's mask row [kStreamTileKeys] fp32 that a
// padding mask gives every query row; the warps' mask maxima [kWarps] fp32
// and the item's last live key (an int).  All of it is dynamic: the launch
// opts in to the whole of shared memory, and so do the other kernels'.
template <typename T, int D, int TM>
struct StreamLayout {
  static constexpr int kRow = D + 16 / (int)sizeof(T);
  static constexpr int kRows = 16 * TM;
  static constexpr size_t kTile = (size_t)kStreamTileKeys * kRow * sizeof(T);
  static constexpr size_t kScores = sizeof(float) * kRows * kStreamTileKeys;
  static constexpr size_t kKS = kTile > kScores ? kTile : kScores;
  static constexpr size_t kQ = (size_t)kRows * kRow * sizeof(T);
  static size_t bytes(int) {
    return kKS + kTile + kQ + sizeof(float) * (kStreamTileKeys + kWarps) + sizeof(int);
  }
};

// Any Lk (dispatch_long sends it the Lk past fused_mha_long_kernel's
// range): K and V streamed in 128-key tiles, one in flight, and the exact
// two-pass softmax over them: pass 0 walks the K tiles for each row's max
// and sum (the sum rescaled when a tile raises the max), pass 1 walks the K
// and V tiles again, recomputes the scores and multiplies V by exp(s - max)
// / sum rounded to v's dtype.  Threads own rows and keys of a tile as in
// fused_mha_kernel; each warp keeps the running max and sum of its rows
// over the tiles in registers, each thread its output micro-tile.
template <typename T, int D, int TM>
__global__ void __launch_bounds__(kThreads, 2)
fused_mha_stream_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ mask,
                        T* __restrict__ out, const Args a) {
  using Lay = StreamLayout<T, D, TM>;
  constexpr int ROW = Lay::kRow;
  constexpr int KEYS = kStreamTileKeys;
  constexpr int ROWS = Lay::kRows;
  constexpr int TN = KEYS / 16;                        // keys per thread
  constexpr int NT = KEYS / 32;                        // keys per lane
  constexpr int RPW = ROWS / kWarps;                   // rows per warp
  constexpr int CPT = D / 16;
  constexpr int PIECES = D * (int)sizeof(T) / 16;
  constexpr int PER_PIECE = 16 / (int)sizeof(T);
  extern __shared__ float4 smem4[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem4);
  T* kb = reinterpret_cast<T*>(base);
  float* s_p = reinterpret_cast<float*>(base);                      // [ROWS][KEYS]
  T* vb = reinterpret_cast<T*>(base + Lay::kKS);
  T* qb = reinterpret_cast<T*>(base + Lay::kKS + Lay::kTile);
  float* mrow = reinterpret_cast<float*>(base + Lay::kKS + Lay::kTile + Lay::kQ);
  float* warp_max = mrow + KEYS;                                    // [kWarps]
  int& last_live = *reinterpret_cast<int*>(warp_max + kWarps);
  const bool shared_mask_row = a.ms[1] == 0;
  const int Lk = a.Lk;
  const int n_tiles = (Lk + KEYS - 1) / KEYS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int tr = tid >> 4, tc = tid & 15;

  for (int it = blockIdx.x; it < a.n_items; it += gridDim.x) {
    const int slice = it / a.row_blocks;
    const int b = slice / a.H, h = slice % a.H;
    const int row0 = (it - slice * a.row_blocks) * ROWS;
    const int rows = min(ROWS, a.Lq - row0);
    const T* kg = k + b * a.ks[0] + h * a.ks[1];
    const T* vg = v + b * a.vs[0] + h * a.vs[1];
    const T* qg = q + b * a.qs[0] + h * a.qs[1] + row0 * a.qs[2];
    const float* mg = mask == nullptr ? nullptr
        : mask + b * a.ms[0] + (shared_mask_row ? 0 : row0 * a.ms[1]);
    // (the last tile of the previous item ended on a barrier: Q is free)
    for (int x = tid; x < rows * PIECES; x += kThreads) {
      const int i = x / PIECES, e = (x - i * PIECES) * PER_PIECE;
      cp_async16(qb + i * ROW + e, qg + i * a.qs[2] + e);
    }
    cp_async_commit();

    // a padding mask's row: the tiles up to its last key within kSkipGap of
    // the row's largest mask (the source note says why the rest add 0)
    int n_live = n_tiles;
    if (mg != nullptr && shared_mask_row) {
      float mm = -INFINITY;
      for (int j = tid; j < Lk; j += kThreads) mm = fmaxf(mm, mg[j * a.ms[2]]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, off));
      if (lane == 0) warp_max[warp] = mm;
      if (tid == 0) last_live = 0;
      __syncthreads();
      mm = warp_max[0];
      for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, warp_max[w]);
      int mine = 0;
      for (int j = tid; j < Lk; j += kThreads)
        if (mg[j * a.ms[2]] >= mm - kSkipGap) mine = j;
      atomicMax(&last_live, mine);
      __syncthreads();
      n_live = last_live / KEYS + 1;
    }

    float mx[RPW], sum[RPW], o[TM][CPT];
#pragma unroll
    for (int u = 0; u < RPW; ++u) { mx[u] = -INFINITY; sum[u] = 0.f; }
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) o[r][c] = 0.f;

    // pass 0: each row's max and sum over the tiles; pass 1: P . V
    for (int pass = 0; pass < 2; ++pass) {
      for (int t = 0; t < n_live; ++t) {
        const int j0 = t * KEYS;
        const int nk = min(KEYS, Lk - j0), nk4 = (nk + 3) & ~3;
        for (int x = tid; x < nk * PIECES; x += kThreads) {
          const int j = x / PIECES, e = (x - j * PIECES) * PER_PIECE;
          cp_async16(kb + j * ROW + e, kg + (j0 + j) * a.ks[2] + e);
          if (pass == 1) cp_async16(vb + j * ROW + e, vg + (j0 + j) * a.vs[2] + e);
        }
        if (pass == 1)           // V rows nk..nk4-1 are zeros, as P is there
          for (int x = tid; x < (nk4 - nk) * D; x += kThreads)
            vb[(nk + x / D) * ROW + x % D] = T(0.f);
        if (mg != nullptr && shared_mask_row)
          for (int j = tid; j < nk; j += kThreads)
            cp_async4(mrow + j, mg + (j0 + j) * a.ms[2]);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();

        // ---- the tile's scores, d ascending (keys past nk repeat row nk-1) ----
        float acc[TM][TN];
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int n = 0; n < TN; ++n) acc[r][n] = 0.f;
#pragma unroll 2
        for (int d = 0; d < D; d += 4) {
          float qv[TM][4];
#pragma unroll
          for (int r = 0; r < TM; ++r) load_f(qb + (tr + 16 * r) * ROW + d, qv[r]);
#pragma unroll
          for (int n = 0; n < TN; ++n) {
            float kv[4];
            load_f(kb + min(tc + 16 * n, nk - 1) * ROW + d, kv);
#pragma unroll
            for (int e = 0; e < 4; ++e)
#pragma unroll
              for (int r = 0; r < TM; ++r) acc[r][n] = fmaf(qv[r][e], kv[e], acc[r][n]);
          }
        }
        __syncthreads();                 // K is read: S overwrites it
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int n = 0; n < TN; ++n) {
            const int i = tr + 16 * r, j = tc + 16 * n;
            float m = 0.f;
            if (mg != nullptr)
              m = shared_mask_row ? mrow[j]
                  : (i < rows && j < nk) ? mg[i * a.ms[1] + (j0 + j) * a.ms[2]] : 0.f;
            s_p[i * KEYS + j] = acc[r][n] * a.scale + m;
          }
        __syncthreads();

        if (pass == 0) {
          // ---- one warp per row: the tile's max, then the running sum
          // rescaled to the new max ----
          float sv[RPW][NT], tmax[RPW], part[RPW];
#pragma unroll
          for (int u = 0; u < RPW; ++u) {
            const int i = warp + kWarps * u;
            tmax[u] = -INFINITY;
#pragma unroll
            for (int tt = 0; tt < NT; ++tt) {
              const int j = lane + 32 * tt;
              sv[u][tt] = (i < rows && j < nk) ? s_p[i * KEYS + j] : -INFINITY;
              tmax[u] = fmaxf(tmax[u], sv[u][tt]);
            }
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
#pragma unroll
            for (int u = 0; u < RPW; ++u)
              tmax[u] = fmaxf(tmax[u], __shfl_xor_sync(0xffffffffu, tmax[u], off));
#pragma unroll
          for (int u = 0; u < RPW; ++u) {
            tmax[u] = fmaxf(mx[u], tmax[u]);
            part[u] = 0.f;
#pragma unroll
            for (int tt = 0; tt < NT; ++tt)
              if (lane + 32 * tt < nk && warp + kWarps * u < rows)
                part[u] += expf(sv[u][tt] - tmax[u]);
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
#pragma unroll
            for (int u = 0; u < RPW; ++u)
              part[u] += __shfl_xor_sync(0xffffffffu, part[u], off);
#pragma unroll
          for (int u = 0; u < RPW; ++u)
            if (warp + kWarps * u < rows) {
              sum[u] = sum[u] * expf(mx[u] - tmax[u]) + part[u];
              mx[u] = tmax[u];
            }
        } else {
          // ---- probabilities exp(s - max) / sum in v's dtype, then
          // o += P . V over the tile, keys ascending ----
#pragma unroll
          for (int u = 0; u < RPW; ++u) {
            const int i = warp + kWarps * u;
            if (i >= rows) break;
#pragma unroll
            for (int tt = 0; tt < NT; ++tt) {
              const int j = lane + 32 * tt;
              if (j < nk4)
                s_p[i * KEYS + j] =
                    j < nk ? round_prob<T>(expf(s_p[i * KEYS + j] - mx[u]) / sum[u]) : 0.f;
            }
          }
          __syncthreads();
          for (int j = 0; j < nk4; j += 4) {
            float p[TM][4];
#pragma unroll
            for (int r = 0; r < TM; ++r) load_f(s_p + (tr + 16 * r) * KEYS + j, p[r]);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              float vv[CPT];
              load_f(vb + (j + jj) * ROW + tc * CPT, vv);
#pragma unroll
              for (int r = 0; r < TM; ++r)
#pragma unroll
                for (int c = 0; c < CPT; ++c) o[r][c] = fmaf(p[r][jj], vv[c], o[r][c]);
            }
          }
        }
        __syncthreads();                 // S and V are read: the next tile loads
      }
    }
    T* ob = out + b * a.os[0] + h * a.os[1];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int i = tr + 16 * r;
      if (i < rows) store_f(ob + (row0 + i) * a.os[2] + tc * CPT, o[r]);
    }
  }
}

// The kernel, its shared memory and its item rows, for each route.
template <typename T, int D, int TN, int TM>
struct Short {
  using Elem = T;
  static constexpr int kRows = 16 * TM;
  static auto kernel() { return fused_mha_kernel<T, D, TN, TM>; }
  static size_t bytes(int lk) { return Layout<T, D, TN, TM>::bytes(lk); }
};
template <typename T, int D, int TM>
struct Long {
  using Elem = T;
  static constexpr int kRows = 16 * TM;
  static auto kernel() { return fused_mha_long_kernel<T, D, TM>; }
  static size_t bytes(int lk) { return LongLayout<T, D, TM>::bytes(lk); }
};
template <typename T, int D, int TM>
struct Stream {
  using Elem = T;
  static constexpr int kRows = 16 * TM;
  static auto kernel() { return fused_mha_stream_kernel<T, D, TM>; }
  static size_t bytes(int lk) { return StreamLayout<T, D, TM>::bytes(lk); }
};

// With `info` set, nothing is launched: info[0] gets the blocks per SM and
// info[1] the dynamic shared-memory bytes of the launch.
template <typename P>
int launch(const void* q, const void* k, const void* v, const float* mask,
           void* out, int B, Args a, cudaStream_t stream, int* info) {
  using T = typename P::Elem;
  auto kernel = P::kernel();
  static bool configured[64] = {};
  static int optin[64] = {}, sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {          // once per device: no capture sets it again
    err = cudaDeviceGetAttribute(&optin[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin[dev]);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  a.row_blocks = (a.Lq + P::kRows - 1) / P::kRows;
  a.n_items = B * a.H * a.row_blocks;
  const size_t smem = P::bytes(a.Lk);
  if (smem > (size_t)optin[dev]) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (info != nullptr) {
    info[0] = per_sm;
    info[1] = (int)smem;
    return (int)cudaSuccess;
  }
  const int grid = min(a.n_items, max(per_sm, 1) * sms[dev]);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), a);
  return (int)cudaGetLastError();
}

// items of 32 query rows where Lq <= 32, else of 64
template <typename T, int D, int TN>
int dispatch_rows(const void* q, const void* k, const void* v,
                  const float* mask, void* out, int B, const Args& a,
                  cudaStream_t st, int* info) {
  if (a.Lq <= 32) return launch<Short<T, D, TN, 2>>(q, k, v, mask, out, B, a, st, info);
  return launch<Short<T, D, TN, 4>>(q, k, v, mask, out, B, a, st, info);
}

// The shared memory a block may take where two blocks share an SM: half of
// the SM's, less the per-block reserve (115,712 bytes on an H100).
int two_block_budget(int* bytes) {
  static int budget[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (budget[dev] == 0) {
    int per_sm = 0, reserved = 0;
    err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
    if (err != cudaSuccess) return (int)err;
    budget[dev] = per_sm / 2 - reserved;
  }
  *bytes = budget[dev];
  return (int)cudaSuccess;
}

// Past kMaxKeys: fused_mha_long_kernel with 32-row items where they fit two
// blocks per SM (and Lq > 16), else with 16-row items where those fit, else
// fused_mha_stream_kernel (items of 32 query rows where Lq <= 32, else 64).
template <typename T, int D>
int dispatch_long(const void* q, const void* k, const void* v,
                  const float* mask, void* out, int B, const Args& a,
                  cudaStream_t st, int* info) {
  int budget = 0;
  const int err = two_block_budget(&budget);
  if (err != (int)cudaSuccess) return err;
  if (a.Lq > 16 && LongLayout<T, D, 2>::bytes(a.Lk) <= (size_t)budget)
    return launch<Long<T, D, 2>>(q, k, v, mask, out, B, a, st, info);
  if (LongLayout<T, D, 1>::bytes(a.Lk) <= (size_t)budget)
    return launch<Long<T, D, 1>>(q, k, v, mask, out, B, a, st, info);
  if (a.Lq <= 32) return launch<Stream<T, D, 2>>(q, k, v, mask, out, B, a, st, info);
  return launch<Stream<T, D, 4>>(q, k, v, mask, out, B, a, st, info);
}

template <typename T, int D>
int dispatch_keys(const void* q, const void* k, const void* v,
                  const float* mask, void* out, int B, const Args& a,
                  cudaStream_t st, int* info) {
  const int tn = (a.Lk + 15) / 16;
  if (a.Lk > kMaxKeys) return dispatch_long<T, D>(q, k, v, mask, out, B, a, st, info);
  if (tn <= 1) return dispatch_rows<T, D, 1>(q, k, v, mask, out, B, a, st, info);
  if (tn <= 2) return dispatch_rows<T, D, 2>(q, k, v, mask, out, B, a, st, info);
  if (tn <= 4) return dispatch_rows<T, D, 4>(q, k, v, mask, out, B, a, st, info);
  if (tn <= 7) return dispatch_rows<T, D, 7>(q, k, v, mask, out, B, a, st, info);
  if (tn <= 8) return dispatch_rows<T, D, 8>(q, k, v, mask, out, B, a, st, info);
  return dispatch_rows<T, D, 16>(q, k, v, mask, out, B, a, st, info);
}

int dispatch(int dtype, int D, const void* q, const void* k, const void* v,
             const float* mask, void* out, int B, const Args& a,
             cudaStream_t st, int* info) {
  if (dtype == 0) {
    switch (D) {
      case 32: return dispatch_keys<float, 32>(q, k, v, mask, out, B, a, st, info);
      case 64: return dispatch_keys<float, 64>(q, k, v, mask, out, B, a, st, info);
    }
  } else {
    switch (D) {
      case 32: return dispatch_keys<__nv_bfloat16, 32>(q, k, v, mask, out, B, a, st, info);
      case 64: return dispatch_keys<__nv_bfloat16, 64>(q, k, v, mask, out, B, a, st, info);
    }
  }
  return (int)cudaErrorInvalidValue;
}

bool aligned(const void* p, const long long* strides, int esize) {
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (int i = 0; i < 3; ++i)
    if (strides[i] * esize % 16 != 0) return false;
  return true;
}

}  // namespace

extern "C" {

// Largest key length of fused_mha_kernel; longer keys go to
// fused_mha_long_kernel, or past its range to fused_mha_stream_kernel.
int fmha_max_keys() { return kMaxKeys; }

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike); D is 32 or 64.
// strides: 15 element strides, (b, h, l) of q, k, v and out, then (b, query
// row, key) of the mask; mask may be null.  q, k, v and out, with their
// strides, must be 16-byte aligned.  Returns the CUDA error code of the
// launch (0 = launched).
int fmha_launch(int dtype, int D, const void* q, const void* k, const void* v,
                const float* mask, void* out, int B, int H, int Lq, int Lk,
                const long long* strides, float scale, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int esize = dtype == 0 ? 4 : 2;
  if (!aligned(q, strides, esize) || !aligned(k, strides + 3, esize) ||
      !aligned(v, strides + 6, esize) || !aligned(out, strides + 9, esize))
    return (int)cudaErrorMisalignedAddress;
  Args a;
  a.H = H;
  a.Lq = Lq;
  a.Lk = Lk;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
    a.ms[i] = strides[12 + i];
  }
  a.scale = scale;
  return dispatch(dtype, D, q, k, v, mask, out, B, a,
                  static_cast<cudaStream_t>(stream), nullptr);
}

// Occupancy of the launch fmha_launch makes for this dtype, D, Lq and Lk:
// info[0] = blocks per SM, info[1] = dynamic shared-memory bytes.  Launches
// nothing; returns a CUDA error code.
int fmha_occupancy(int dtype, int D, int Lq, int Lk, int* info) {
  if (Lq < 1 || Lk < 1 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.H = 1;
  a.Lq = Lq;
  a.Lk = Lk;
  return dispatch(dtype, D, nullptr, nullptr, nullptr, nullptr, nullptr, 1, a,
                  nullptr, info);
}

}  // extern "C"
