// Fused beam-decode attention step for Hopper (sm_90a), one layer per launch.
//
// Replaces the Pallas TPU kernel spmm_tpu/ops/decode_attention.py `_kernel`
// (wrapper `beam_decode_attention`), called once per decoder layer per token
// step of the PV->SMILES k-beam search.  It computes what that kernel
// computes, not its block structure (the TPU kernel's lane folding, 8-row
// append window and double-buffered VMEM slabs are Mosaic rules):
//
//   attend: for every molecule m, head h and query beam b
//     ctx[m,h,b] = softmax([q.K_prefix/sqrt(D) + mask ; q.k_new[b]/sqrt(D)])
//                  . [V_prefix ; v_new[b]]
//     one joint fp32 softmax over the prefix t < pos of ALL k cache lanes
//     (the additive mask selects each beam's ancestor lane) plus the dense
//     self term, taken exactly: the max, then exp and sum.  Probabilities are
//     normalised in fp32 and, for bf16 and fp8 caches, rounded to bf16 before
//     the V product (as the XLA formulation casts them to the cache dtype);
//     V accumulates in fp32.
//   append: k_new / v_new are written into the cache at `pos`, in place.
//     JAX aliases the cache buffer (input_output_aliases); here the caller's
//     tensor is simply updated.  Each block owns one (m, h) slice and writes
//     row `pos` after its reads of rows t < pos, so nothing races.
//
// Layout (one for this kernel and its plain version):
//   cache [2(kv), L, m, h, k(lane), T, D] contiguous, dtype f32 | bf16 | e4m3
//   q, k_new, v_new, ctx [m, h, k, D]: f32 for an f32 cache, else bf16
//   mask [m, k(beam), k(lane), T] fp32 additive (0 or -10000; t >= pos
//   must be masked, and is never read here)
//
// What bounds it on an H100.  Device-memory bytes: the kernel reads the K
// and V rows that some beam attends, at most 2*m*h*k*pos*D*sizeof(cache)
// bytes per launch, against about 4*m*h*k*k*pos*D flops.  At the serving
// shape (m=128, h=12, k=2, D=64, bf16, pos=103) that is at most 81.8 MB,
// 24 us at 3.35 TB/s, where the flops need 2.4 us at the 67 TFLOP/s fp32
// rate.  Two query rows per (m, h) are far too few for wgmma, so the design
// is about bytes in flight and about the length of each block's chain of
// dependent steps (a block's work is small; its latency sets the pace):
//
//   - Skip dead rows.  A (lane, t) row that no beam of the block attends
//     (every beam's mask <= -10000 there) has probability exactly 0.0 in
//     fp32 (exp(-10000 + s - max) underflows), so it is neither copied nor
//     used, for K and V alike.  The block copies its mask prefix into shared
//     memory, turns it into one 32-bit live mask per (lane, 32-row tile) with
//     a warp ballot, and lists the tiles with a live row.  The decoder's
//     beams share one lane per position until they diverge, so this halves
//     the bytes of a shared prefix.
//   - TMA bulk copies into a ring.  A lane's rows are contiguous in the
//     cache, so a tile is 32 consecutive rows of one lane, and each run of
//     live rows in it is one cp.async.bulk, completing on the slot's "full"
//     mbarrier.  Warp 0 is the producer: each of its lanes that starts a run
//     issues that run's copy, so a tile's copies go out in one step.  The
//     ring has kStages slots; K tiles come first, then V tiles, so the first
//     V tiles load while the last scores and the softmax run.  Each warp
//     releases a slot on its "empty" mbarrier, so no block-wide barrier
//     stands between tiles.  Shared memory for the ring does not grow with T.
//   - Compute from shared memory with every thread busy.  A row is read by
//     LPR threads, each with one 16-byte (8-byte for fp8) load of CE values;
//     one pass over a K row serves all k query beams (the q slices live in
//     registers) and the partial dot products meet by shuffles.  D is a
//     template argument, so the passes over a tile unroll and overlap.  For
//     P.V each thread keeps k x CE fp32 sums for its column chunk over the
//     rows it reads; they meet by shuffles and one shared-memory sum at the
//     end.  Loads that depend on nothing (mask, q, k_new, v_new) are all in
//     flight at the start.
//
// Scores (k*k*pos fp32) stay in shared memory, so that grows with T: about
// 77 KB at k=8, T=300.  Left for later work: splitting one (m, h) across a
// thread-block cluster for small batches (at m=16 a block's chain of steps,
// about 20 us, sets the kernel's time), a softmax spread over all warps
// (with k=2 two of the four warps run it), and CUDA graphs around the decode
// step (the host, not this kernel, bounds serving).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (spmm_tpu_torch/ops/_build.py); plain C interface,
//        bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMaskValue = -10000.0f;
constexpr int kMaxBeams = 8;        // k <= 8
constexpr int kMaxHeadDim = 128;    // D <= 128, D % 32 == 0
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 32;       // a tile: 32 consecutive rows of one lane
constexpr int kStages = 6;          // tiles in the shared-memory ring

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> struct Store;
template <> struct Store<float> {
  __device__ static float from(float x) { return x; }
};
template <> struct Store<__nv_bfloat16> {
  __device__ static __nv_bfloat16 from(float x) { return __float2bfloat16(x); }
};
template <> struct Store<__nv_fp8_e4m3> {
  // round to nearest even, out-of-range to NaN: the conversion PyTorch's
  // .to(torch.float8_e4m3fn) performs (no saturation)
  __device__ static __nv_fp8_e4m3 from(float x) {
    __nv_fp8_e4m3 r;
    r.__x = __nv_cvt_float_to_fp8(x, __NV_NOSAT, __NV_E4M3);
    return r;
  }
};

// probabilities take the dtype V is multiplied in: fp32 for an fp32 cache,
// bf16 (rounded, then widened back) for bf16 and fp8 caches
template <typename C> __device__ __forceinline__ float round_prob(float p) {
  return __bfloat162float(__float2bfloat16(p));
}
template <> __device__ __forceinline__ float round_prob<float>(float p) { return p; }

// values one thread takes from a cache row at once: 16 bytes of fp32 or
// bf16, 8 bytes of fp8
template <typename C> struct Chunk { static constexpr int n = 8; };
template <> struct Chunk<float> { static constexpr int n = 4; };

__device__ __forceinline__ void load_chunk(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 b;
    *reinterpret_cast<uint32_t*>(&b) = w[i];
    const float2 f = __bfloat1622float2(b);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load_chunk(const __nv_fp8_e4m3* p, float* out) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const uint32_t w[2] = {v.x, v.y};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_fp8x2_e4m3 b;
    b.__x = static_cast<__nv_fp8x2_storage_t>(w[i >> 1] >> (16 * (i & 1)));
    const float2 f = static_cast<float2>(b);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(smem)), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// spins until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}
// TMA 1-D bulk copy global -> shared, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// dynamic shared memory, in order: the ring [kStages][kTileRows * D] of C |
// scores s [k][n] fp32, n = k*pos ordered (lane, t) | live masks [k][ntl]
// uint32 | live tile list [k*ntl] int, ntl = ceil(pos / kTileRows)
size_t smem_bytes(int k, int pos, int D, size_t esize) {
  const size_t ntl = (pos + kTileRows - 1) / kTileRows;
  return kStages * kTileRows * D * esize + sizeof(float) * k * k * pos +
         2 * sizeof(uint32_t) * k * ntl;
}

// grid: m*h blocks (one per molecule-head), kThreads threads.  KB >= k is
// the register size of the per-beam arrays; at KB = 2 the registers are
// held to 64 so that 8 blocks fit an SM.
//
// Thread layout over a tile: LPR threads per row (a power of two >= D/CE),
// thread c of a row owning column chunk c; RPP rows per pass, PASSES passes
// cover the tile's 32 rows.  Warp 0 is also the producer: it fills ring
// slot i % kStages with tile i (0..nl-1 the live K tiles, nl..2nl-1 the same
// tiles of V) by TMA bulk copies, one per run of live rows, completing on
// full[slot]; each warp releases a slot on empty[slot] when done with it.
template <typename C, typename Q, int KB, int D>
__global__ void __launch_bounds__(kThreads, KB == 2 ? 8 : 1)
beam_decode_attention_kernel(const Q* __restrict__ q, const Q* __restrict__ k_new,
                             const Q* __restrict__ v_new, C* __restrict__ cache,
                             const float* __restrict__ mask, Q* __restrict__ ctx,
                             int L, int m, int h, int k, int T, int pos,
                             int layer, float scale) {
  constexpr int CE = Chunk<C>::n;
  constexpr int LPR = D / CE <= 4 ? 4 : D / CE <= 8 ? 8 : D / CE <= 16 ? 16 : 32;
  constexpr int RPP = kThreads / LPR;
  constexpr int PASSES = kTileRows / RPP;
  constexpr int ROW_BYTES = D * (int)sizeof(C);
  constexpr int TILE_BYTES = kTileRows * ROW_BYTES;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t full[kStages], empty[kStages];
  __shared__ float s_self[kMaxBeams];
  __shared__ float p_self[kMaxBeams];
  __shared__ int n_live_tiles;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int mh = blockIdx.x;
  const int mi = mh / h;
  const int n = k * pos;
  const int ntl = (pos + kTileRows - 1) / kTileRows;
  unsigned char* ring = smem;
  float* s = reinterpret_cast<float*>(smem + kStages * TILE_BYTES);   // [k][n]
  uint32_t* live = reinterpret_cast<uint32_t*>(s + (size_t)k * n);     // [k][ntl]
  int* tiles = reinterpret_cast<int*>(live + k * ntl);   // (lane << 16) | tile

  const size_t slab = (size_t)k * T * D;                    // one (m, h) slice
  const size_t kv_stride = (size_t)L * m * h * slab;
  C* k_cache = cache + ((size_t)layer * m * h + mh) * slab;
  C* v_cache = k_cache + kv_stride;
  const size_t qoff = (size_t)mh * k * D;
  const float* mrow = mask + (size_t)mi * k * k * T;        // [k][k][T]

  // ---- loads that depend on nothing, all in flight at once ----
  // the mask prefix into s, ordered (beam, lane, t) like the scores
  for (int i = tid; i < k * n; i += kThreads) {
    const int b = i / n, r = i - b * n, l = r / pos;
    cp_async4(s + i, mrow + ((size_t)b * k + l) * T + (r - l * pos));
  }
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // self scores: each beam against its own new key, one warp per beam
  for (int b = warp; b < k; b += kWarps) {
    float d = 0.f;
#pragma unroll
    for (int e = 0; e < (D + 31) / 32; ++e)
      if (lane + 32 * e < D)
        d += to_f32(q[qoff + b * D + lane + 32 * e]) *
             to_f32(k_new[qoff + b * D + lane + 32 * e]);
    d = warp_sum(d);
    if (lane == 0) s_self[b] = d * scale;
  }
  // this thread's column chunk of the queries, and its first new K/V
  // element for the epilogue
  const int g = tid / LPR, c = tid - g * LPR;
  const bool has_cols = c * CE < D;
  float qr[KB][CE];
#pragma unroll
  for (int b = 0; b < KB; ++b)
#pragma unroll
    for (int e = 0; e < CE; ++e)
      qr[b][e] = (b < k && has_cols) ? to_f32(q[qoff + b * D + c * CE + e]) : 0.f;
  const float kn0 = tid < k * D ? to_f32(k_new[qoff + tid]) : 0.f;
  const float vn0 = tid < k * D ? to_f32(v_new[qoff + tid]) : 0.f;
  cp_async_commit_wait_all();
  __syncthreads();

  // ---- live masks: bit r of live[l][j] = some beam attends (l, 32j + r);
  // the scores of a row that no beam attends are -inf ----
  for (int w = warp; w < k * ntl; w += kWarps) {
    const int l = w / ntl, t = (w - l * ntl) * kTileRows + lane;
    bool on = false;
    if (t < pos) {
      for (int b = 0; b < k; ++b) on |= s[(size_t)b * n + l * pos + t] > kMaskValue;
      if (!on)
        for (int b = 0; b < k; ++b) s[(size_t)b * n + l * pos + t] = -INFINITY;
    }
    const uint32_t bits = __ballot_sync(0xffffffffu, on);
    if (lane == 0) live[w] = bits;
  }
  __syncthreads();
  // the tiles with a live row, in (lane, tile) order
  if (warp == 0) {
    int count = 0;
    for (int w0 = 0; w0 < k * ntl; w0 += 32) {
      const int w = w0 + lane;
      const bool on = w < k * ntl && live[w] != 0u;
      const uint32_t bal = __ballot_sync(0xffffffffu, on);
      if (on) {
        const int l = w / ntl;
        tiles[count + __popc(bal & ((1u << lane) - 1u))] = (l << 16) | (w - l * ntl);
      }
      count += __popc(bal);
    }
    if (lane == 0) n_live_tiles = count;
  }
  __syncthreads();
  const int nl = n_live_tiles;

  // producer (warp 0): tile i into slot i % kStages, once every warp has
  // released the slot's previous tile; each lane that starts a run of live
  // rows copies the run
  auto produce = [&](int i) {
    if (warp != 0 || i >= 2 * nl) return;
    const int slot = i % kStages, use = i / kStages;
    const int kv = i >= nl;
    const int tl = tiles[i - kv * nl];
    const int l = tl >> 16, j = tl & 0xffff;
    const uint32_t bits = live[l * ntl + j];
    if (lane == 0) {
      if (use > 0) mbar_wait(&empty[slot], (use - 1) & 1);
      mbar_expect_tx(&full[slot], __popc(bits) * ROW_BYTES);
    }
    __syncwarp();
    if ((bits >> lane & 1u) && (lane == 0 || !(bits >> (lane - 1) & 1u))) {
      const uint32_t rest = ~(bits >> lane);
      const int len = rest ? __ffs(rest) - 1 : 32 - lane;
      const unsigned char* src = reinterpret_cast<const unsigned char*>(
          (kv ? v_cache : k_cache) + ((size_t)l * T + j * kTileRows + lane) * D);
      bulk_copy(ring + slot * TILE_BYTES + lane * ROW_BYTES, src, len * ROW_BYTES,
                &full[slot]);
    }
  };
  // consumers: wait for tile i, then release it after `body`
  auto consume = [&](int i, auto body) {
    produce(i + kStages - 1);
    const int slot = i % kStages;
    mbar_wait(&full[slot], (i / kStages) & 1);
    const int kv = i >= nl;
    const int tl = tiles[i - kv * nl];
    const int l = tl >> 16, j = tl & 0xffff;
    body(ring + slot * TILE_BYTES, l, j, live[l * ntl + j]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  };
  for (int i = 0; i < kStages - 1; ++i) produce(i);

  // ---- scores over the live K tiles ----
  for (int i = 0; i < nl; ++i) {
    consume(i, [&](const unsigned char* tile, int l, int j, uint32_t bits) {
      float d[PASSES][KB];
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        float kv[CE];
        if (has_cols) {
          load_chunk(reinterpret_cast<const C*>(tile + (g + p * RPP) * ROW_BYTES) + c * CE, kv);
        } else {
#pragma unroll
          for (int e = 0; e < CE; ++e) kv[e] = 0.f;
        }
#pragma unroll
        for (int b = 0; b < KB; ++b) {
          d[p][b] = 0.f;
#pragma unroll
          for (int e = 0; e < CE; ++e) d[p][b] = fmaf(qr[b][e], kv[e], d[p][b]);
        }
      }
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1)
#pragma unroll
        for (int p = 0; p < PASSES; ++p)
#pragma unroll
          for (int b = 0; b < KB; ++b) d[p][b] += __shfl_xor_sync(0xffffffffu, d[p][b], o);
      if (c == 0) {
#pragma unroll
        for (int p = 0; p < PASSES; ++p) {
          const int r = g + p * RPP;
          if (bits >> r & 1u) {                    // dead rows keep -inf
            float* sr = s + l * pos + j * kTileRows + r;   // holds the mask
#pragma unroll
            for (int b = 0; b < KB; ++b)
              if (b < k) sr[(size_t)b * n] = d[p][b] * scale + sr[(size_t)b * n];
          }
        }
      }
    });
  }
  __syncthreads();

  // ---- softmax per beam over [prefix ; self], fp32, exact ----
  for (int b = warp; b < k; b += kWarps) {
    float* sb = s + (size_t)b * n;
    float mx = s_self[b];
    for (int i = lane; i < n; i += 32) mx = fmaxf(mx, sb[i]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float e = expf(sb[i] - mx);                     // -inf -> 0
      sb[i] = e;
      sum += e;
    }
    const float e_self = expf(s_self[b] - mx);
    const float den = warp_sum(sum) + e_self;
    for (int i = lane; i < n; i += 32) sb[i] = round_prob<C>(sb[i] / den);
    if (lane == 0) p_self[b] = round_prob<C>(e_self / den);
  }
  __syncthreads();

  // ---- P . V over the live V tiles, fp32 sums per (beam, column) ----
  float acc[KB][CE];
#pragma unroll
  for (int b = 0; b < KB; ++b)
#pragma unroll
    for (int e = 0; e < CE; ++e) acc[b][e] = 0.f;
  for (int i = nl; i < 2 * nl; ++i) {
    consume(i, [&](const unsigned char* tile, int l, int j, uint32_t bits) {
      if (!has_cols) return;
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        const int r = g + p * RPP;
        if (!(bits >> r & 1u)) continue;           // not copied: garbage
        float vv[CE];
        load_chunk(reinterpret_cast<const C*>(tile + r * ROW_BYTES) + c * CE, vv);
        const float* pr = s + l * pos + j * kTileRows + r;
#pragma unroll
        for (int b = 0; b < KB; ++b) {
          if (b < k) {
            const float pb = pr[(size_t)b * n];
#pragma unroll
            for (int e = 0; e < CE; ++e) acc[b][e] = fmaf(pb, vv[e], acc[b][e]);
          }
        }
      }
    });
  }
  // rows of one warp meet by shuffles, the warps in shared memory (the
  // ring is free: every copy has landed and been read)
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
    for (int b = 0; b < KB; ++b)
#pragma unroll
      for (int e = 0; e < CE; ++e) acc[b][e] += __shfl_xor_sync(0xffffffffu, acc[b][e], o);
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);                // [kWarps][k][D]
  if (lane < LPR && has_cols) {
#pragma unroll
    for (int b = 0; b < KB; ++b)
      if (b < k)
#pragma unroll
        for (int e = 0; e < CE; ++e) red[((size_t)warp * k + b) * D + c * CE + e] = acc[b][e];
  }
  __syncthreads();
  for (int o = tid; o < k * D; o += kThreads) {
    const int b = o / D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += red[(size_t)w * k * D + o];
    a += p_self[b] * (o == tid ? vn0 : to_f32(v_new[qoff + o]));
    ctx[qoff + o] = Store<Q>::from(a);
  }

  // ---- append: lane l of the cache receives beam l's new K/V at pos ----
  for (int o = tid; o < k * D; o += kThreads) {
    const int l = o / D, d = o - l * D;
    const size_t at = ((size_t)l * T + pos) * D + d;
    k_cache[at] = Store<C>::from(o == tid ? kn0 : to_f32(k_new[qoff + o]));
    v_cache[at] = Store<C>::from(o == tid ? vn0 : to_f32(v_new[qoff + o]));
  }
}

// Raises a kernel's dynamic shared-memory limit to what the device allows,
// once per device (``allowed`` is the kernel's own record), so that no
// later launch, nor a CUDA graph capture of one, sets it again.
constexpr int kMaxDevices = 64;
cudaError_t allow_smem(const void* kernel, int* allowed, size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (allowed[dev] == 0) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    const int dynamic = optin - (int)attr.sharedSizeBytes;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic);
    if (err != cudaSuccess) return err;
    allowed[dev] = dynamic;
  }
  return smem <= (size_t)allowed[dev] ? cudaSuccess : cudaErrorInvalidValue;
}

// With `info` set, nothing is launched: info[0] gets the blocks per SM and
// info[1] the dynamic shared-memory bytes of the launch.
template <typename C, typename Q, int KB, int D>
int launch_d(const void* q, const void* k_new, const void* v_new, void* cache,
             const float* mask, void* ctx, int L, int m, int h, int k, int T,
             int pos, int layer, cudaStream_t stream, int* info) {
  static int allowed[kMaxDevices] = {};
  const void* kernel =
      reinterpret_cast<const void*>(beam_decode_attention_kernel<C, Q, KB, D>);
  const size_t smem = smem_bytes(k, pos, D, sizeof(C));
  cudaError_t err = allow_smem(kernel, allowed, smem);
  if (err != cudaSuccess) return (int)err;
  if (info != nullptr) {
    info[1] = (int)smem;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], kernel,
                                                              kThreads, smem);
  }
  beam_decode_attention_kernel<C, Q, KB, D><<<m * h, kThreads, smem, stream>>>(
      static_cast<const Q*>(q), static_cast<const Q*>(k_new),
      static_cast<const Q*>(v_new), static_cast<C*>(cache), mask,
      static_cast<Q*>(ctx), L, m, h, k, T, pos, layer, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename C, typename Q, int KB>
int launch_kb(const void* q, const void* k_new, const void* v_new, void* cache,
              const float* mask, void* ctx, int L, int m, int h, int k, int T,
              int D, int pos, int layer, cudaStream_t stream, int* info) {
  switch (D) {
    case 32: return launch_d<C, Q, KB, 32>(q, k_new, v_new, cache, mask, ctx, L, m, h, k, T, pos, layer, stream, info);
    case 64: return launch_d<C, Q, KB, 64>(q, k_new, v_new, cache, mask, ctx, L, m, h, k, T, pos, layer, stream, info);
    case 96: return launch_d<C, Q, KB, 96>(q, k_new, v_new, cache, mask, ctx, L, m, h, k, T, pos, layer, stream, info);
    case 128: return launch_d<C, Q, KB, 128>(q, k_new, v_new, cache, mask, ctx, L, m, h, k, T, pos, layer, stream, info);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename C, typename Q>
int launch(const void* q, const void* k_new, const void* v_new, void* cache,
           const float* mask, void* ctx, int L, int m, int h, int k, int T,
           int D, int pos, int layer, cudaStream_t stream, int* info) {
  if (k <= 2)
    return launch_kb<C, Q, 2>(q, k_new, v_new, cache, mask, ctx, L, m, h, k, T,
                              D, pos, layer, stream, info);
  return launch_kb<C, Q, kMaxBeams>(q, k_new, v_new, cache, mask, ctx, L, m, h,
                                    k, T, D, pos, layer, stream, info);
}

int run(int cache_dtype, const void* q, const void* k_new, const void* v_new,
        void* cache, const float* mask, void* ctx, int L, int m, int h, int k,
        int T, int D, int pos, int layer, void* stream, int* info) {
  if (k < 1 || k > kMaxBeams || D % 32 != 0 || D > kMaxHeadDim ||
      pos < 0 || pos >= T || layer < 0 || layer >= L)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(cache) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cache_dtype) {
    case 0:
      return launch<float, float>(q, k_new, v_new, cache, mask, ctx, L, m, h, k,
                                  T, D, pos, layer, st, info);
    case 1:
      return launch<__nv_bfloat16, __nv_bfloat16>(q, k_new, v_new, cache, mask,
                                                  ctx, L, m, h, k, T, D, pos,
                                                  layer, st, info);
    case 2:
      return launch<__nv_fp8_e4m3, __nv_bfloat16>(q, k_new, v_new, cache, mask,
                                                  ctx, L, m, h, k, T, D, pos,
                                                  layer, st, info);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Largest k and head_dim the kernel takes (the wrapper checks both).
int bda_max_beams() { return kMaxBeams; }
int bda_max_head_dim() { return kMaxHeadDim; }

// cache_dtype: 0 = float32, 1 = bfloat16, 2 = float8_e4m3fn.  Returns the
// CUDA error code of the launch (0 = launched).  The cache must be 16-byte
// aligned (its rows are copied in 16-byte pieces).
int bda_launch(int cache_dtype, const void* q, const void* k_new,
               const void* v_new, void* cache, const float* mask, void* ctx,
               int L, int m, int h, int k, int T, int D, int pos, int layer,
               void* stream) {
  return run(cache_dtype, q, k_new, v_new, cache, mask, ctx, L, m, h, k, T, D,
             pos, layer, stream, nullptr);
}

// Occupancy of the launch bda_launch makes for this cache dtype, k, D and
// pos: info[0] = blocks per SM, info[1] = dynamic shared-memory bytes.
// Launches nothing; returns a CUDA error code.
int bda_occupancy(int cache_dtype, int k, int D, int pos, int* info) {
  return run(cache_dtype, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
             1, 1, 1, k, pos + 1, D, pos, 0, nullptr, info);
}

}  // extern "C"
