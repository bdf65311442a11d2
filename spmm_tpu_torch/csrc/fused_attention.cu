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
//     kernel, fused_mha_stream_kernel (below), takes any Lk.  The switch is
//     on Lk alone; fmha_occupancy() reports which launch a shape gets.
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
// Past the long kernel's reach (1,153 keys in fp32, 1,409 in bf16, at D=64)
// fused_mha_stream_kernel takes any Lk.  It replaces the same Pallas kernel,
// which holds the whole (b, h) block in VMEM at any Lk.  What bounds it:
// at B=8, h=12, 40 x 1300 causal the FMAs of the keys the mask lets through
// take 0.01 ms at 67 TFLOP/s and the bytes of the attended K/V rows about
// as long, so a kernel near its bound must spread one (b, h) slice's few
// query rows over many SMs, hide its loads and do each product once.  What
// the design does about it (the numbers are the launch's, launch_stream):
//
//   - Keys split over a thread-block cluster.  A work item is 16 or 32
//     query rows of one (b, h) slice (32 only where they pad Lq no more
//     than 16-row items do: Lq = 33 or 40 take 16-row items, 25% and 17%
//     padding).  A cluster of C CTAs (cudaLaunchKernelEx with a cluster
//     dimension, C <= 8) takes an item, CTA `rank` a contiguous run of its
//     live 64-key tiles, the runs even to one tile.  C is the least that
//     keeps every run resident in two CTAs' share of an SM, raised while
//     the launch has fewer than two CTAs per SM (B=8, h=12, Lq=40: 288
//     items, C=2); a launch of many items (Lq ~ Lk) splits only as far as
//     residency needs.
//   - q.k once, scores resident.  Each CTA writes its run's fp32 scores (d
//     ascending in fp32) to its shared memory and takes each row's max; the
//     cluster exchanges the maxima through distributed shared memory
//     (cluster.sync, map_shared_rank) and every CTA merges them in rank
//     order; each CTA sums exp(s - M) against the global M, the sums are
//     exchanged and added in rank order; each CTA writes P = exp(s - M) / S
//     rounded to v's dtype (the plain version's rounding point) and forms
//     its partial P.V (fp32).  The C partial outputs are added through
//     DSMEM in rank order, each CTA a share of the elements, and stored
//     once: deterministic.  A split-K with an online softmax would round
//     unnormalised probabilities in bf16; one without it needs a second q.k
//     pass or a trip through device memory.  Past what the cluster holds
//     resident (a run longer than R tiles), a CTA walks its run in chunks
//     of R tiles twice, as the earlier streaming kernel did: scores for the
//     max and a running sum (rescaled when a chunk raises the max), then,
//     after the exchange, scores again, P and P.V.  No Lk is refused.
//   - Loads hidden.  K, V and the K tile's mask tile go through a ring of
//     kStreamStages stages with 16-byte cp.async (a mask with a row per
//     query staged as a [rows][64] tile beside its K tile, 16-byte pieces
//     where its keys are contiguous and aligned), one commit group a load,
//     so load l + 1 lands while load l computes; the V tiles start landing
//     during the exchange.  Two CTAs of 4 warps share an SM.
//   - bf16 on tensor cores: q.k and P.V are mma.sync.m16n8k16 (bf16 in, fp32
//     accumulate); Q's A fragments are loaded once an item, P is rounded to
//     bf16 before it is packed.  fp32 stays exact fp32 FMAs on register
//     micro-tiles (2 * TM rows x 4 keys a thread for the scores, 2 * TM rows
//     x D/16 columns for P.V, as the long kernel's): TF32 keeps 3 digits.
//   - The padding-row skip, for every mask: only the tiles up to the item's
//     last live key (over its rows; kSkipGap, as above) are split, loaded
//     and computed, so causal rows and short rows pay for the keys they
//     attend.  The scan is one pass (each thread keeps its largest mask and
//     its last key within kSkipGap of it, which can only overstate the
//     live tiles) with 16-byte loads, shared by the cluster's CTAs (a
//     padding row by keys, per-query rows a warp a row) and merged through
//     DSMEM.  A CTA with no tile contributes max -inf and sum 0, which the
//     merge takes without a NaN (every row has a live key elsewhere); a
//     fully masked row keeps every tile and comes out uniform.
//
// Left for later work: padding waste in the first two kernels (an item
// computes 16 * TM query rows and 16 * TN keys, so 54 x 100 does 26% more
// FMAs than it needs, Lq = 16 twice); the bf16 path on tensor cores in the
// short and long kernels, which run bf16 on CUDA cores; for the long
// kernel, score tiles of 8 x 8 a thread as in an SGEMM, and a P.V split
// over keys, which would change its order of summation; for the streaming
// kernel, TMA for the K/V tiles, wgmma over 64-row tiles, and live ranges
// per row (an item's rows share its last live key, so under a causal mask
// its first rows compute keys their mask hides).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (spmm_tpu_torch/ops/_build.py); plain C interface,
//        bound with ctypes.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxKeys = 256;           // Lk <= 256: fused_mha_kernel
constexpr int kLongTileKeys = 64;       // keys per K/V tile of fused_mha_long_kernel
constexpr int kStreamThreads = 128;     // fused_mha_stream_kernel: threads of a CTA,
constexpr int kStreamWarps = kStreamThreads / 32;
constexpr int kStreamTileKeys = 64;     // keys per K/V tile,
constexpr int kStreamStages = 2;        // stages of its ring,
constexpr int kMaxCluster = 8;          // CTAs of a cluster at most (the portable limit)
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
  int clusters, res_tiles;          // the streaming kernel: C and R (launch_stream)
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

// Shared memory of the streaming kernel, in order: the ring of kStreamStages
// stages, each a K or V tile [kStreamTileKeys][D+pad] in T and, for a K
// tile, its mask tile, [16*TM][kStreamTileKeys+8] fp32 for a mask with a row
// per query (rows padded by 8 floats, so that a warp's reads fall in
// distinct banks) or its first row for a padding mask; the item's Q rows
// [16*TM][D+pad] in T, kept to the end; the rows' maxima and sums that the
// cluster exchanges [2][16*TM] fp32; the mask scan's largest masks
// [kStreamWarps + 1] fp32 and last live keys [kStreamWarps + 1] int (the
// warps', then the CTA's, which the cluster reads); then the resident scores, then
// probabilities, S / P [16*TM][score_stride(R)] fp32 of R tiles, which hold
// the CTA's partial output [16*TM][D] fp32 at the end.
template <typename T, int D, int TM>
struct StreamLayout {
  static constexpr int kRow = D + 16 / (int)sizeof(T);
  static constexpr int kRows = 16 * TM;
  static constexpr int kMaskRow = kStreamTileKeys + 8;
  static constexpr size_t kTile = (size_t)kStreamTileKeys * kRow * sizeof(T);
  static constexpr size_t kStage = kTile + sizeof(float) * kRows * kMaskRow;
  static constexpr size_t kQ = (size_t)kRows * kRow * sizeof(T);
  static constexpr size_t kSmall = sizeof(float) * (2 * kRows + 2 * kStreamWarps + 4);
  static constexpr size_t kFixed = kStreamStages * kStage + kQ + kSmall;
  __host__ __device__ static int score_stride(int r) { return r * kStreamTileKeys + 8; }
  static size_t bytes(int r) { return kFixed + sizeof(float) * kRows * score_stride(r); }
};

// bf16 m16n8k16 on the tensor cores, fp32 accumulate: d += a . b
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// two bf16 in one register, the first in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ unsigned pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  const __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Any Lk (dispatch_long sends it the Lk past fused_mha_long_kernel's
// range).  A work item is 16 * TM query rows of one (b, h) slice; a cluster
// of C CTAs takes it, CTA `rank` the contiguous run of its live key tiles
// [t0, t0 + n) (the source note).  Its loads, load l in stage l % S:
//   n <= R (resident): K tiles t0.., then V tiles t0..;
//   n > R: K tiles t0.. (pass 0), then per chunk of R tiles its K tiles
//   again and its V tiles (pass 1).
// f32: warp w, lane (rg, cg) = (lane / 8, lane % 8) owns the rows
// (w / 2) * 8 * TM + rg + 4 r (r < 2 TM); of a tile's scores the keys
// (w % 2) * 32 + cg + 8 n (n < 4); of P.V the columns (w % 2) * D/2 +
// cg * D/16 ... + D/16 - 1.  bf16: warp w computes with mma.sync the scores
// of keys 16 w .. 16 w + 15 and the P.V columns w * D/4 .. + D/4 - 1, every
// row of the item.  The softmax runs one warp per row (rows w + 4 u).
template <typename T, int D, int TM>
__global__ void __launch_bounds__(kStreamThreads, 2)
fused_mha_stream_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ mask,
                        T* __restrict__ out, const Args a) {
  using Lay = StreamLayout<T, D, TM>;
  constexpr int ROW = Lay::kRow;
  constexpr int ROWS = Lay::kRows;
  constexpr int MKS = Lay::kMaskRow;
  constexpr int KT = kStreamTileKeys;
  constexpr int NS = kStreamStages;
  constexpr int NTH = kStreamThreads;
  constexpr int PIECES = D * (int)sizeof(T) / 16;
  constexpr int PER_PIECE = 16 / (int)sizeof(T);
  constexpr int RPW = ROWS / kStreamWarps;             // softmax rows per warp
  constexpr bool kTensorCores = sizeof(T) == 2;
  constexpr int CPT = D / 16;                          // f32: output columns per thread
  constexpr int TR = 2 * TM;                           // f32: rows per thread
  constexpr int KS = D / 16;                           // bf16: k-steps of q.k
  constexpr int NBV = D / 32;                          // bf16: 8-column blocks of P.V per warp
  extern __shared__ float4 smem4[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem4);
  T* qb = reinterpret_cast<T*>(base + NS * Lay::kStage);
  float* red_max = reinterpret_cast<float*>(base + NS * Lay::kStage + Lay::kQ);
  float* red_sum = red_max + ROWS;
  float* warp_max = red_sum + ROWS;                      // [kStreamWarps + 1]
  int* warp_last = reinterpret_cast<int*>(warp_max + kStreamWarps + 1);   // [.. + 1]
  float* s_p = reinterpret_cast<float*>(base + Lay::kFixed);        // [ROWS][SKS]

  cg::cluster_group cluster = cg::this_cluster();
  const int C = a.clusters;
  const int rank = (int)cluster.block_rank();
  const int R = a.res_tiles;
  const int SKS = Lay::score_stride(R);
  const int Lk = a.Lk;
  const int it = blockIdx.x / C;
  const int slice = it / a.row_blocks;
  const int b = slice / a.H, h = slice % a.H;
  const int row0 = (it - slice * a.row_blocks) * ROWS;
  const int rows = min(ROWS, a.Lq - row0);
  const bool shared_mask_row = a.ms[1] == 0;
  const float* mg = mask == nullptr ? nullptr
      : mask + b * a.ms[0] + (shared_mask_row ? 0 : row0 * a.ms[1]);
  // mask rows with contiguous keys, 16-byte aligned: read 4 keys at a time
  const bool mask16 = a.ms[2] == 1 && a.ms[0] % 4 == 0 && a.ms[1] % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  const T* kg = k + b * a.ks[0] + h * a.ks[1];
  const T* vg = v + b * a.vs[0] + h * a.vs[1];
  const T* qg = q + b * a.qs[0] + h * a.qs[1] + row0 * a.qs[2];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int rg = lane >> 3, cg8 = lane & 7;            // f32 micro-tiles
  const int row_t = (warp >> 1) * 8 * TM + rg;
  const int half = warp & 1;
  const int col_t = half * (D / 2) + cg8 * CPT;
  const int g = lane >> 2, tg = lane & 3;              // bf16 fragments

  // the item's Q rows land with the first tile's group
  for (int x = tid; x < rows * PIECES; x += NTH) {
    const int i = x / PIECES, e = (x - i * PIECES) * PER_PIECE;
    cp_async16(qb + i * ROW + e, qg + i * a.qs[2] + e);
  }

  // the item's live tiles: those up to the last key within kSkipGap of its
  // row's largest mask, over the item's rows (the source note says why the
  // rest add 0).  One pass: a thread keeps (m, J), the largest mask it has
  // seen and its last key within kSkipGap of it, keys ascending; J can only
  // overstate the last live key, which costs a tile and changes no sum.
  // The cluster's CTAs share the scan: a padding mask's one row by keys, a
  // mask with a row per query by rows (a warp a row); then every CTA merges
  // the CTAs' results in rank order through DSMEM.
  const int n_tiles = (Lk + KT - 1) / KT;
  int n_live = n_tiles;
  if (mg != nullptr) {
    const int groups = (Lk + 3) / 4;
    float m = -INFINITY;
    int J = -1;
    auto see = [&](const float* mr, int q4) {    // keys 4 q4 .. 4 q4 + 3
      const int j0 = 4 * q4;
      float x[4];
      if (mask16 && j0 + 4 <= Lk) {
        const float4 y = *reinterpret_cast<const float4*>(mr + j0);
        x[0] = y.x; x[1] = y.y; x[2] = y.z; x[3] = y.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = j0 + e < Lk ? mr[(j0 + e) * a.ms[2]] : -INFINITY;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        m = fmaxf(m, x[e]);
        if (x[e] >= m - kSkipGap) J = j0 + e;
      }
    };
    // merges the (m, J) of a warp's lanes: J from the lanes whose m is within
    // kSkipGap of the warp's
    auto warp_merge = [&]() {
      float mm = m;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, off));
      int jj = m >= mm - kSkipGap ? J : -1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        jj = max(jj, __shfl_xor_sync(0xffffffffu, jj, off));
      m = mm;
      J = jj;
    };
    if (shared_mask_row) {
#pragma unroll 4
      for (int q4 = rank * NTH + tid; q4 < groups; q4 += C * NTH) see(mg, q4);
      warp_merge();
    } else {
      int rows_j = -1;
      for (int i = rank * kStreamWarps + warp; i < rows; i += C * kStreamWarps) {
        m = -INFINITY;
        J = -1;
#pragma unroll 4
        for (int q4 = lane; q4 < groups; q4 += 32) see(mg + i * a.ms[1], q4);
        warp_merge();
        rows_j = max(rows_j, J);
      }
      m = 0.f;                            // each row's J is final: merge by max
      J = rows_j;
    }
    if (lane == 0) {
      warp_max[warp] = m;
      warp_last[warp] = J;
    }
    __syncthreads();
    if (tid == 0) {
      float mm = warp_max[0];
      for (int w = 1; w < kStreamWarps; ++w) mm = fmaxf(mm, warp_max[w]);
      int jj = -1;
      for (int w = 0; w < kStreamWarps; ++w)
        if (warp_max[w] >= mm - kSkipGap) jj = max(jj, warp_last[w]);
      warp_max[kStreamWarps] = mm;
      warp_last[kStreamWarps] = jj;
    }
    cluster.sync();
    float mm = -INFINITY;
    for (int c = 0; c < C; ++c)
      mm = fmaxf(mm, cluster.map_shared_rank(warp_max, c)[kStreamWarps]);
    int jj = 0;
    for (int c = 0; c < C; ++c)
      if (cluster.map_shared_rank(warp_max, c)[kStreamWarps] >= mm - kSkipGap)
        jj = max(jj, cluster.map_shared_rank(warp_last, c)[kStreamWarps]);
    n_live = jj / KT + 1;
  }
  // this CTA's live tiles [t0, t0 + n): the cluster splits them evenly, in
  // rank order; a CTA may get none
  const int t0 = rank * n_live / C;
  const int n = (rank + 1) * n_live / C - t0;
  const bool resident = n <= R;
  const int N = resident ? 2 * n : 3 * n;               // loads
  const int L = n == 0 ? 0 : min(n * KT, Lk - t0 * KT);  // keys of the range

  struct Load { bool is_k; int tile, slot; };           // slot: S column block
  auto load_at = [&](int l) {
    if (l < n) return Load{true, t0 + l, resident ? l : l % R};
    const int u = l - n;
    if (resident) return Load{false, t0 + u, u};
    const int c = u / (2 * R), w = u - c * 2 * R, nc = min(R, n - c * R);
    return w < nc ? Load{true, t0 + c * R + w, w}
                  : Load{false, t0 + c * R + w - nc, w - nc};
  };
  auto stage = [&](int l) { return base + (size_t)(l % NS) * Lay::kStage; };
  // load l into its stage (free): a K tile with its mask tile, or a V tile
  // whose rows past Lk are zeros, as P is there
  auto issue = [&](int l) {
    if (l >= N) return;
    const Load ld = load_at(l);
    T* dst = reinterpret_cast<T*>(stage(l));
    float* mt = reinterpret_cast<float*>(stage(l) + Lay::kTile);
    const int j0 = ld.tile * KT, nk = min(KT, Lk - j0);
    const T* src = ld.is_k ? kg + j0 * a.ks[2] : vg + j0 * a.vs[2];
    const long long rs = ld.is_k ? a.ks[2] : a.vs[2];
    for (int x = tid; x < nk * PIECES; x += NTH) {
      const int j = x / PIECES, e = (x - j * PIECES) * PER_PIECE;
      cp_async16(dst + j * ROW + e, src + j * rs + e);
    }
    if (!ld.is_k) {
      for (int x = tid; x < (KT - nk) * D; x += NTH)
        dst[(nk + x / D) * ROW + x % D] = T(0.f);
    } else if (mg != nullptr && shared_mask_row) {
      for (int j = tid; j < nk; j += NTH) cp_async4(mt + j, mg + (j0 + j) * a.ms[2]);
    } else if (mask16) {
      for (int x = tid; x < rows * (KT / 4); x += NTH) {
        const int i = x / (KT / 4), j = 4 * (x - i * (KT / 4));
        const float* src_m = mg + i * a.ms[1] + j0 + j;
        if (j + 4 <= nk) cp_async16(mt + i * MKS + j, src_m);
        else
          for (int e = j; e < nk; ++e) cp_async4(mt + i * MKS + e, src_m + e - j);
      }
    } else if (mg != nullptr) {
      for (int x = tid; x < rows * nk; x += NTH) {
        const int i = x / nk, j = x - i * nk;
        cp_async4(mt + i * MKS + j, mg + i * a.ms[1] + (j0 + j) * a.ms[2]);
      }
    }
  };

  // bf16: the item's Q as mma A fragments, loaded once
  unsigned qa[kTensorCores ? TM : 1][kTensorCores ? KS : 1][4];
  auto load_q = [&]() {
    if constexpr (kTensorCores) {
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          const T* p = qb + (16 * m + g) * ROW + 16 * s + 2 * tg;
          qa[m][s][0] = *reinterpret_cast<const unsigned*>(p);
          qa[m][s][1] = *reinterpret_cast<const unsigned*>(p + 8 * ROW);
          qa[m][s][2] = *reinterpret_cast<const unsigned*>(p + 8);
          qa[m][s][3] = *reinterpret_cast<const unsigned*>(p + 8 * ROW + 8);
        }
    }
  };

  // ---- K tile of load l: its scores, d ascending (f32), into S at the
  // load's slot (keys past Lk and rows past the item's are computed from
  // stale rows and never read) ----
  auto scores = [&](int l) {
    const Load ld = load_at(l);
    const T* kt = reinterpret_cast<const T*>(stage(l));
    const float* mt = reinterpret_cast<const float*>(stage(l) + Lay::kTile);
    float* sp = s_p + ld.slot * KT;
    if constexpr (!kTensorCores) {
      float acc[TR][4];
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        float qv[TR][4];
#pragma unroll
        for (int r = 0; r < TR; ++r) load_f(qb + (row_t + 4 * r) * ROW + d, qv[r]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float kv[4];
          load_f(kt + (half * 32 + cg8 + 8 * c) * ROW + d, kv);
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int r = 0; r < TR; ++r) acc[r][c] = fmaf(qv[r][e], kv[e], acc[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = row_t + 4 * r, j = half * 32 + cg8 + 8 * c;
          const float m = mg == nullptr ? 0.f : shared_mask_row ? mt[j] : mt[i * MKS + j];
          sp[i * SKS + j] = acc[r][c] * a.scale + m;
        }
    } else {
      float acc[TM][2][4];
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[m][nb][c] = 0.f;
#pragma unroll
      for (int s = 0; s < KS; ++s)
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          const T* p = kt + (16 * warp + 8 * nb + g) * ROW + 16 * s + 2 * tg;
          const unsigned bk[2] = {*reinterpret_cast<const unsigned*>(p),
                                  *reinterpret_cast<const unsigned*>(p + 8)};
#pragma unroll
          for (int m = 0; m < TM; ++m) mma_bf16(acc[m][nb], qa[m][s], bk);
        }
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int i = 16 * m + g + 8 * hr, j = 16 * warp + 8 * nb + 2 * tg;
            float m0 = 0.f, m1 = 0.f;
            if (mg != nullptr) {
              const float* mr = shared_mask_row ? mt : mt + i * MKS;
              m0 = mr[j];
              m1 = mr[j + 1];
            }
            *reinterpret_cast<float2*>(sp + i * SKS + j) =
                make_float2(acc[m][nb][2 * hr] * a.scale + m0,
                            acc[m][nb][2 * hr + 1] * a.scale + m1);
          }
    }
  };

  // ---- V tile of load l: o += P . V over its keys (f32: ascending) ----
  float of[kTensorCores ? 1 : TR][kTensorCores ? 1 : CPT];
  float ot[kTensorCores ? TM : 1][kTensorCores ? NBV : 1][4];
#pragma unroll
  for (int r = 0; r < (kTensorCores ? 1 : TR); ++r)
#pragma unroll
    for (int c = 0; c < (kTensorCores ? 1 : CPT); ++c) of[r][c] = 0.f;
#pragma unroll
  for (int m = 0; m < (kTensorCores ? TM : 1); ++m)
#pragma unroll
    for (int nb = 0; nb < (kTensorCores ? NBV : 1); ++nb)
#pragma unroll
      for (int c = 0; c < 4; ++c) ot[m][nb][c] = 0.f;
  auto pv = [&](int l) {
    const Load ld = load_at(l);
    const T* vt = reinterpret_cast<const T*>(stage(l));
    const float* sp = s_p + ld.slot * KT;
    const int nk = min(KT, Lk - ld.tile * KT);
    if constexpr (!kTensorCores) {
      const int nk4 = (nk + 3) & ~3;
#pragma unroll 2
      for (int j = 0; j < nk4; j += 4) {
        float p[TR][4];
#pragma unroll
        for (int r = 0; r < TR; ++r) load_f(sp + (row_t + 4 * r) * SKS + j, p[r]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float vv[CPT];
          load_f(vt + (j + jj) * ROW + col_t, vv);
#pragma unroll
          for (int r = 0; r < TR; ++r)
#pragma unroll
            for (int c = 0; c < CPT; ++c) of[r][c] = fmaf(p[r][jj], vv[c], of[r][c]);
        }
      }
    } else {
      const int steps = (nk + 15) / 16;
      for (int s = 0; s < steps; ++s) {
        unsigned pa[TM][4];
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          const float* p = sp + (16 * m + g) * SKS + 16 * s + 2 * tg;
          const float2 p0 = *reinterpret_cast<const float2*>(p);
          const float2 p1 = *reinterpret_cast<const float2*>(p + 8 * SKS);
          const float2 p2 = *reinterpret_cast<const float2*>(p + 8);
          const float2 p3 = *reinterpret_cast<const float2*>(p + 8 * SKS + 8);
          pa[m][0] = pack_bf16(p0.x, p0.y);
          pa[m][1] = pack_bf16(p1.x, p1.y);
          pa[m][2] = pack_bf16(p2.x, p2.y);
          pa[m][3] = pack_bf16(p3.x, p3.y);
        }
#pragma unroll
        for (int nb = 0; nb < NBV; ++nb) {
          const T* p = vt + (16 * s + 2 * tg) * ROW + warp * (D / 4) + 8 * nb + g;
          const unsigned bv[2] = {pack_bf16(p[0], p[ROW]),
                                  pack_bf16(p[8 * ROW], p[9 * ROW])};
#pragma unroll
          for (int m = 0; m < TM; ++m) mma_bf16(ot[m][nb], pa[m], bv);
        }
      }
    }
  };

  // ---- the warp's rows (w + 4 u): softmax state, lanes over keys ----
  float mx[RPW], sum[RPW];
#pragma unroll
  for (int u = 0; u < RPW; ++u) { mx[u] = -INFINITY; sum[u] = 0.f; }
  auto row_ptr = [&](int u) { return s_p + (warp + kStreamWarps * u) * SKS; };
  auto warp_max_all = [&](float (&x)[RPW]) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < RPW; ++u) x[u] = fmaxf(x[u], __shfl_xor_sync(0xffffffffu, x[u], off));
  };
  auto warp_sum_all = [&](float (&x)[RPW]) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < RPW; ++u) x[u] += __shfl_xor_sync(0xffffffffu, x[u], off);
  };
  // n > R: fold the chunk's first nkeys scores into (mx, sum), the sum
  // rescaled when the chunk raises the max
  auto chunk_update = [&](int nkeys) {
    float cm[RPW], part[RPW];
#pragma unroll
    for (int u = 0; u < RPW; ++u) cm[u] = mx[u];
#pragma unroll 2
    for (int j = lane; j < nkeys; j += 32)
#pragma unroll
      for (int u = 0; u < RPW; ++u) cm[u] = fmaxf(cm[u], row_ptr(u)[j]);
    warp_max_all(cm);
#pragma unroll
    for (int u = 0; u < RPW; ++u) part[u] = 0.f;
#pragma unroll 2
    for (int j = lane; j < nkeys; j += 32)
#pragma unroll
      for (int u = 0; u < RPW; ++u) part[u] += expf(row_ptr(u)[j] - cm[u]);
    warp_sum_all(part);
#pragma unroll
    for (int u = 0; u < RPW; ++u) {
      sum[u] = (mx[u] == -INFINITY ? 0.f : sum[u] * expf(mx[u] - cm[u])) + part[u];
      mx[u] = cm[u];
    }
  };
  // the rows' global max, then sum: this CTA's values through shared memory,
  // every rank's read back (DSMEM) and merged in rank order
  auto exchange = [&](float* slot, const float (&mine)[RPW], float (&all)[RPW], bool is_max) {
    if (lane == 0)
#pragma unroll
      for (int u = 0; u < RPW; ++u) slot[warp + kStreamWarps * u] = mine[u];
    cluster.sync();
#pragma unroll
    for (int u = 0; u < RPW; ++u) all[u] = is_max ? -INFINITY : 0.f;
    for (int c = 0; c < C; ++c) {
      const float* theirs = cluster.map_shared_rank(slot, c);
#pragma unroll
      for (int u = 0; u < RPW; ++u) {
        const float x = theirs[warp + kStreamWarps * u];
        all[u] = is_max ? fmaxf(all[u], x) : all[u] + x;
      }
    }
  };
  // probabilities exp(s - M) / S in v's dtype over the first nkeys of the
  // first nslots * KT columns (from the scores, or from exp(s - M) with
  // `from_exp`), 0 past nkeys
  float M[RPW], S[RPW], rcp[RPW];
  auto probabilities = [&](int nkeys, int ncols, bool from_exp) {
#pragma unroll 2
    for (int j = lane; j < ncols; j += 32)
#pragma unroll
      for (int u = 0; u < RPW; ++u) {
        float* r = row_ptr(u);
        const float e = j < nkeys ? (from_exp ? r[j] : expf(r[j] - M[u])) : 0.f;
        r[j] = j < nkeys ? round_prob<T>(divide(e, S[u], rcp[u])) : 0.f;
      }
  };

  // ---- pass 0: every K tile of the range ----
  for (int l = 0; l < NS; ++l) {
    issue(l);
    cp_async_commit();
  }
  auto release = [&](int l) {                 // stage l % NS is free
    __syncthreads();
    issue(l + NS);
    cp_async_commit();
  };
  for (int l = 0; l < n; ++l) {
    if (!resident && l > 0 && l % R == 0) chunk_update(R * KT);
    cp_async_wait<NS - 1>();                  // load l has landed
    __syncthreads();
    if (l == 0) load_q();
    scores(l);
    release(l);
  }
  // ---- the cluster's softmax statistics ----
  if (resident) {
#pragma unroll 2
    for (int j = lane; j < L; j += 32)
#pragma unroll
      for (int u = 0; u < RPW; ++u) mx[u] = fmaxf(mx[u], row_ptr(u)[j]);
    warp_max_all(mx);
  } else {
    chunk_update(L - (n - 1) / R * R * KT);
  }
  exchange(red_max, mx, M, true);
  if (resident) {
#pragma unroll 2
    for (int j = lane; j < L; j += 32)
#pragma unroll
      for (int u = 0; u < RPW; ++u) {
        const float e = expf(row_ptr(u)[j] - M[u]);
        row_ptr(u)[j] = e;
        sum[u] += e;
      }
    warp_sum_all(sum);
  } else {
#pragma unroll
    for (int u = 0; u < RPW; ++u) sum[u] = sum[u] == 0.f ? 0.f : sum[u] * expf(mx[u] - M[u]);
  }
  exchange(red_sum, sum, S, false);
#pragma unroll
  for (int u = 0; u < RPW; ++u) rcp[u] = 1.f / S[u];
  if (resident) probabilities(L, n * KT, true);

  // ---- pass 1: P . V (n > R: each chunk's scores again, then its P) ----
  for (int l = n; l < N; ++l) {
    const Load ld = load_at(l);
    if (!resident && !ld.is_k && ld.slot == 0) {
      const int first = ld.tile, nc = min(R, t0 + n - first);
      probabilities(min(nc * KT, Lk - first * KT), nc * KT, false);
    }
    cp_async_wait<NS - 1>();
    __syncthreads();
    if (ld.is_k) scores(l);
    else pv(l);
    release(l);
  }

  // ---- the partial outputs, added over the cluster in rank order ----
  float* part = s_p;                                                // [ROWS][D]
  if constexpr (!kTensorCores) {
#pragma unroll
    for (int r = 0; r < TR; ++r) store_f(part + (row_t + 4 * r) * D + col_t, of[r]);
  } else {
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int nb = 0; nb < NBV; ++nb)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<float2*>(part + (16 * m + g + 8 * hr) * D + warp * (D / 4) +
                                     8 * nb + 2 * tg) =
              make_float2(ot[m][nb][2 * hr], ot[m][nb][2 * hr + 1]);
  }
  cluster.sync();
  T* ob = out + b * a.os[0] + h * a.os[1] + row0 * a.os[2];
  for (int x = rank * NTH + tid; x < ROWS * D / 4; x += C * NTH) {
    const int i = x / (D / 4), c4 = 4 * (x - i * (D / 4));
    if (i >= rows) continue;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c = 0; c < C; ++c) {
      const float4 y = reinterpret_cast<const float4*>(cluster.map_shared_rank(part, c))[x];
      acc[0] += y.x; acc[1] += y.y; acc[2] += y.z; acc[3] += y.w;
    }
    store_f(ob + i * a.os[2] + c4, acc);
  }
  cluster.sync();                    // no CTA leaves while its part is read
  cp_async_wait<0>();
}

// The kernel, its shared memory and its item rows, for the two routes that
// launch a plain grid (kRoute as fmha_occupancy reports it).
template <typename T, int D, int TN, int TM>
struct Short {
  using Elem = T;
  static constexpr int kRows = 16 * TM;
  static constexpr int kRoute = 0;
  static auto kernel() { return fused_mha_kernel<T, D, TN, TM>; }
  static size_t bytes(int lk) { return Layout<T, D, TN, TM>::bytes(lk); }
};
template <typename T, int D, int TM>
struct Long {
  using Elem = T;
  static constexpr int kRows = 16 * TM;
  static constexpr int kRoute = 1;
  static auto kernel() { return fused_mha_long_kernel<T, D, TM>; }
  static size_t bytes(int lk) { return LongLayout<T, D, TM>::bytes(lk); }
};

// Once per device and kernel (no capture sets it again): the kernel may take
// the whole of the opt-in shared memory.  Gives the opt-in bytes and the SMs.
// Tag is one type per kernel (kernels of one signature share a pointer type).
template <typename Tag, typename K>
int configure(K kernel, int* optin, int* sms) {
  static bool configured[64] = {};
  static int optin_of[64] = {}, sms_of[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaDeviceGetAttribute(&optin_of[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin_of[dev]);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  *optin = optin_of[dev];
  *sms = sms_of[dev];
  return (int)cudaSuccess;
}

// With `info` set, nothing is launched: info[0] gets the blocks per SM,
// info[1] the dynamic shared-memory bytes of the launch, info[2] its route
// (0 short, 1 long, 2 streaming) and info[3] its cluster size.
template <typename P>
int launch(const void* q, const void* k, const void* v, const float* mask,
           void* out, int B, Args a, cudaStream_t stream, int* info) {
  using T = typename P::Elem;
  auto kernel = P::kernel();
  int optin = 0, sms = 0;
  int err0 = configure<P>(kernel, &optin, &sms);
  if (err0 != (int)cudaSuccess) return err0;
  a.row_blocks = (a.Lq + P::kRows - 1) / P::kRows;
  a.n_items = B * a.H * a.row_blocks;
  const size_t smem = P::bytes(a.Lk);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (info != nullptr) {
    info[0] = per_sm;
    info[1] = (int)smem;
    info[2] = P::kRoute;
    info[3] = 1;
    return (int)cudaSuccess;
  }
  const int grid = min(a.n_items, max(per_sm, 1) * sms);
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

// The streaming kernel with items of 16 * TM rows, as a grid of clusters of
// C CTAs (the source note): C the least that keeps every CTA's range of key
// tiles resident within two CTAs' share of an SM, raised (to kMaxCluster, and
// no further than one tile a CTA) while the launch has fewer than two CTAs
// per SM; each CTA's scores hold R = ceil(tiles / C) tiles, or the most that
// fit, past which it walks its range in chunks.
template <typename T, int D, int TM>
int launch_stream(const void* q, const void* k, const void* v, const float* mask,
                  void* out, int B, Args a, cudaStream_t stream, int* info) {
  using Lay = StreamLayout<T, D, TM>;
  auto kernel = fused_mha_stream_kernel<T, D, TM>;
  int optin = 0, sms = 0, budget = 0;
  int err0 = configure<Lay>(kernel, &optin, &sms);
  if (err0 == (int)cudaSuccess) err0 = two_block_budget(&budget);
  if (err0 != (int)cudaSuccess) return err0;
  a.row_blocks = (a.Lq + Lay::kRows - 1) / Lay::kRows;
  a.n_items = B * a.H * a.row_blocks;
  const int n_tiles = (a.Lk + kStreamTileKeys - 1) / kStreamTileKeys;
  const long long room = ((long long)budget - (long long)Lay::kFixed) /
                         ((long long)sizeof(float) * Lay::kRows) - 8;
  const int r_max = max(1, (int)(room / kStreamTileKeys));
  int C = min(kMaxCluster, (n_tiles + r_max - 1) / r_max);
  while (C < kMaxCluster && C < n_tiles && (long long)a.n_items * C < 2LL * sms) ++C;
  a.clusters = C;
  a.res_tiles = min(r_max, (n_tiles + C - 1) / C);
  const size_t smem = Lay::bytes(a.res_tiles);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  if ((long long)a.n_items * C > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_items * C);
  cfg.blockDim = dim3(kStreamThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (info != nullptr) {
    int clusters = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    info[0] = clusters * C / sms;
    info[1] = (int)smem;
    info[2] = 2;
    info[3] = C;
    return (int)cudaSuccess;
  }
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// items of 32 query rows where they pad Lq no more than 16-row items do,
// else of 16
template <typename T, int D>
int dispatch_stream(const void* q, const void* k, const void* v,
                    const float* mask, void* out, int B, const Args& a,
                    cudaStream_t st, int* info) {
  if ((a.Lq + 31) / 32 * 32 == (a.Lq + 15) / 16 * 16)
    return launch_stream<T, D, 2>(q, k, v, mask, out, B, a, st, info);
  return launch_stream<T, D, 1>(q, k, v, mask, out, B, a, st, info);
}

// Past kMaxKeys: fused_mha_long_kernel with 32-row items where they fit two
// blocks per SM (and Lq > 16), else with 16-row items where those fit, else
// fused_mha_stream_kernel.
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
  return dispatch_stream<T, D>(q, k, v, mask, out, B, a, st, info);
}

// route -1: the route of dispatch_keys; 2: the streaming kernel at any Lk
template <typename T, int D>
int dispatch_keys(const void* q, const void* k, const void* v,
                  const float* mask, void* out, int B, const Args& a,
                  cudaStream_t st, int* info, int route) {
  if (route == 2) return dispatch_stream<T, D>(q, k, v, mask, out, B, a, st, info);
  if (route != -1) return (int)cudaErrorInvalidValue;
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
             cudaStream_t st, int* info, int route) {
  if (dtype == 0) {
    switch (D) {
      case 32: return dispatch_keys<float, 32>(q, k, v, mask, out, B, a, st, info, route);
      case 64: return dispatch_keys<float, 64>(q, k, v, mask, out, B, a, st, info, route);
    }
  } else {
    switch (D) {
      case 32:
        return dispatch_keys<__nv_bfloat16, 32>(q, k, v, mask, out, B, a, st, info, route);
      case 64:
        return dispatch_keys<__nv_bfloat16, 64>(q, k, v, mask, out, B, a, st, info, route);
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

// fmha_launch on a route: -1 the wrapper's own (dispatch_keys), 2 the
// streaming kernel at any Lk.  Only the card's tests and chip_smoke.py call
// it (the streaming kernel timed beside the long kernel at its shapes).
int fmha_launch_route(int route, int dtype, int D, const void* q, const void* k,
                      const void* v, const float* mask, void* out, int B, int H,
                      int Lq, int Lk, const long long* strides, float scale,
                      void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int esize = dtype == 0 ? 4 : 2;
  if (!aligned(q, strides, esize) || !aligned(k, strides + 3, esize) ||
      !aligned(v, strides + 6, esize) || !aligned(out, strides + 9, esize))
    return (int)cudaErrorMisalignedAddress;
  Args a{};
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
                  static_cast<cudaStream_t>(stream), nullptr, route);
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike); D is 32 or 64.
// strides: 15 element strides, (b, h, l) of q, k, v and out, then (b, query
// row, key) of the mask; mask may be null.  q, k, v and out, with their
// strides, must be 16-byte aligned.  Returns the CUDA error code of the
// launch (0 = launched).
int fmha_launch(int dtype, int D, const void* q, const void* k, const void* v,
                const float* mask, void* out, int B, int H, int Lq, int Lk,
                const long long* strides, float scale, void* stream) {
  return fmha_launch_route(-1, dtype, D, q, k, v, mask, out, B, H, Lq, Lk, strides,
                           scale, stream);
}

// The launch fmha_launch_route makes on `route` for this dtype, D, B, H, Lq
// and Lk: info[0] = blocks per SM (for a cluster launch, the clusters the
// card holds at once times their size, over its SMs), info[1] = dynamic
// shared-memory bytes, info[2] = the route (0 fused_mha_kernel, 1
// fused_mha_long_kernel, 2 fused_mha_stream_kernel), info[3] = the cluster
// size.  Launches nothing; returns a CUDA error code.
int fmha_occupancy(int route, int dtype, int D, int B, int H, int Lq, int Lk,
                   int* info) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.H = H;
  a.Lq = Lq;
  a.Lk = Lk;
  return dispatch(dtype, D, nullptr, nullptr, nullptr, nullptr, nullptr, B, a,
                  nullptr, info, route);
}

}  // extern "C"
