// Decoder-step cross-attention for Hopper (sm_90a): one launch per fusion
// layer per token step of the beam and greedy decodes.
//
// It replaces no Pallas kernel: the JAX package leaves the step's
// cross-attention to XLA (spmm_tpu/inference/decoding.py:324-331, the plain
// attention over the precomputed encoder K/V).  On the card that plain route
// upcast the bf16 encoder K to fp32, ran an fp32 batched GEMV for the k
// queries of each (molecule, head), applied scale, mask and softmax as
// separate elementwise kernels and multiplied the probabilities by V on
// tensor-core tiles that pad k queries to 16.  This kernel computes the same
// thing at the same precision in one pass:
//
//   for every molecule i, head h and beam query b
//     ctx[i,b,h] = softmax(q[i,b,h] . K[i,h]^T / sqrt(D) + (1 - mask[i]) * -10000)
//                  . V[i,h]
//   dot products accumulated in fp32; scale, mask and softmax in fp32, taken
//   exactly (the max, then exp and sum); the probabilities rounded to V's
//   dtype before the product (as probs.to(v.dtype) does); the product
//   accumulated in fp32 and ctx rounded to V's dtype.
//
// Layout:
//   q, ctx  [m*k, h*D]: the query projection's own rows (beam b of molecule
//           i is row i*k + b) and the layout the output dense reads, so no
//           reshape or transpose copy stands on either side
//   K, V    [m, h, Le, D] contiguous: one fusion layer of the cross K/V
//   mask    [m, Le] binary (float32, int32, int64 or bool), read as it is:
//           no additive mask is built per step
//
// What bounds it on an H100: the bytes of the encoder K and V.  A work item
// (molecule, head) reads 2*Le*D elements and does about 4*k*Le*D flops on
// them.  At cell A's shape (m=512, k=2, h=12, Le=54, D=64, bf16) a launch
// reads 85 MB, 25 us at 3.35 TB/s: about one FMA a byte, where the card
// offers ~295 operations a byte, and 85 MB does not stay in the 50 MB L2
// from one step to the next.  So the design is about reading each item
// once, with enough bytes in flight:
//
//   - A work item is one (molecule, head), every query of the molecule in
//     it: the k beams share one read of K and V.  A block of 128 threads
//     takes one item at a time; it needs little shared memory (k*Le
//     scores, Le mask terms, a 4-warp reduction), so several run on an SM.
//     The launch holds as many blocks as fit the SMs at once, and each
//     walks the items (A's 6,144 are about 8 a block).
//   - Registers, not shared memory, take the rows: LPR threads read a row,
//     each one 16-byte load, and a tile is kPasses such passes (all of an
//     item at Le <= 64 in bf16).  A tile's registers are reloaded as soon
//     as it is used: with the item's next tile, or with the first tile of
//     the block's next item, whose K rows are then in flight through this
//     item's softmax and P.V, and its V rows through this item's sums and
//     the next one's scores.  No block waits on memory between items.
//   - The partial dot products of a row meet by shuffles; the scores and
//     probabilities stay in shared memory (a warp a query for the softmax),
//     the sums of P.V in registers until one shared-memory reduction over
//     the warps.  Nothing but ctx is written to device memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (spmm_tpu_torch/ops/_build.py); plain C interface,
//        bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr float kMaskValue = -10000.0f;
constexpr int kMaxBeams = 8;        // k <= 8
constexpr int kMaxKeys = 512;       // Le <= 512
constexpr int kMaxHeadDim = 128;    // D <= 128, D % 32 == 0
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPasses = 4;          // passes of a tile (16-byte loads a thread)

// values in a 16-byte load
template <typename T> struct Chunk { static constexpr int n = 8; };
template <> struct Chunk<float> { static constexpr int n = 4; };

__device__ __forceinline__ void unpack(const uint4& v, float* out, float) {
  out[0] = __uint_as_float(v.x); out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z); out[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float* out, __nv_bfloat16) {
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

// a probability in the dtype V is multiplied in (rounded, widened back)
__device__ __forceinline__ float round_to(float p, float) { return p; }
__device__ __forceinline__ float round_to(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(p));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// mask codes: 0 float32, 1 int32, 2 int64, 3 bool; the value as .float()
// makes it
__device__ __forceinline__ float mask_at(const void* mask, int code, size_t i) {
  switch (code) {
    case 0: return static_cast<const float*>(mask)[i];
    case 1: return (float)static_cast<const int32_t*>(mask)[i];
    case 2: return (float)static_cast<const long long*>(mask)[i];
    default: return (float)static_cast<const unsigned char*>(mask)[i];
  }
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

template <int D, typename T> struct Geometry {
  static constexpr int CE = Chunk<T>::n;
  // threads a row (a power of two, >= D / CE), rows a pass, rows a tile
  static constexpr int LPR = D / CE <= 4 ? 4 : D / CE <= 8 ? 8 : D / CE <= 16 ? 16 : 32;
  static constexpr int RPP = kThreads / LPR;
  static constexpr int TILE = kPasses * RPP;
};

// dynamic shared memory, floats: scores / probabilities [k][Le] | additive
// mask [Le] | the warps' P.V sums [kWarps][k][D]
size_t smem_bytes(int k, int Le, int D) {
  return sizeof(float) * ((size_t)k * Le + Le + (size_t)kWarps * k * D);
}

// rows t*TILE + p*RPP + g of K or V into registers (zeros past Le or past
// the row's D columns)
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* base, int t, int Le, int g,
                                          int c, uint4* regs) {
  using G = Geometry<D, T>;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int r = t * G::TILE + p * G::RPP + g;
    if (r < Le && c * G::CE < D)
      regs[p] = __ldg(reinterpret_cast<const uint4*>(base + (size_t)r * D) + c);
    else
      regs[p] = make_uint4(0u, 0u, 0u, 0u);
  }
}

// grid: at most as many blocks as fit the SMs at once, each walking the
// work items (molecule, head) item = blockIdx.x, + gridDim.x, ...; kThreads
// threads.  KB >= k is the register size of the per-query arrays.  Thread
// (g, c) = (tid / LPR, tid % LPR) reads column chunk c of rows g, g + RPP,
// ... of each tile.  The registers of a tile are reloaded as soon as it has
// been used: with the next tile of the item, or after the item's last K
// (V) tile with the first K (V) tile of the block's next item, so that the
// next item's rows are in flight while this one's softmax, P.V and sums run.
template <typename T, int KB, int D>
__global__ void __launch_bounds__(kThreads)
decode_cross_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                              const T* __restrict__ vc,
                              const void* __restrict__ mask, int mask_code,
                              T* __restrict__ ctx, int n_items, int h, int k,
                              int Le, float scale) {
  using G = Geometry<D, T>;
  constexpr int CE = G::CE, LPR = G::LPR;
  extern __shared__ __align__(16) float smem[];
  float* s = smem;                                   // [k][Le]
  float* madd = s + (size_t)k * Le;                  // [Le]
  float* red = madd + Le;                            // [kWarps][k][D]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = tid / LPR, c = tid - g * LPR;
  const bool has_cols = c * CE < D;
  const int n_tiles = (Le + G::TILE - 1) / G::TILE;
  const size_t slab = (size_t)Le * D;                // one item's K (or V)

  uint4 kt[kPasses], vt[kPasses];
  if ((int)blockIdx.x < n_items) {
    load_tile<T, D>(kc + blockIdx.x * slab, 0, Le, g, c, kt);
    load_tile<T, D>(vc + blockIdx.x * slab, 0, Le, g, c, vt);
  }
  for (int item = blockIdx.x; item < n_items; item += (int)gridDim.x) {
    const int i = item / h, head = item - i * h;     // item = i * h + head
    const T* kbase = kc + item * slab;
    const T* vbase = vc + item * slab;
    const int next = item + (int)gridDim.x;

    // ---- the queries' column chunks and the mask row as additive terms
    // (the previous item's last reads of madd were before two barriers) ----
    float qr[KB][CE];
#pragma unroll
    for (int b = 0; b < KB; ++b) {
      if (b < k && has_cols) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
            q + ((size_t)(i * k + b) * h + head) * D) + c);
        unpack(raw, qr[b], T());
      } else {
#pragma unroll
        for (int e = 0; e < CE; ++e) qr[b][e] = 0.f;
      }
    }
    for (int r = tid; r < Le; r += kThreads)
      madd[r] = (1.f - mask_at(mask, mask_code, (size_t)i * Le + r)) * kMaskValue;
    __syncthreads();

    // ---- scores: s[b][r] = q_b . K_r * scale + madd[r] ----
    for (int t = 0; t < n_tiles; ++t) {
      uint4 cur[kPasses];
#pragma unroll
      for (int p = 0; p < kPasses; ++p) cur[p] = kt[p];
      if (t + 1 < n_tiles)
        load_tile<T, D>(kbase, t + 1, Le, g, c, kt);
      else if (next < n_items)
        load_tile<T, D>(kc + next * slab, 0, Le, g, c, kt);
      float d[kPasses][KB];
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        float kv[CE];
        unpack(cur[p], kv, T());
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
        for (int p = 0; p < kPasses; ++p)
#pragma unroll
          for (int b = 0; b < KB; ++b) d[p][b] += __shfl_xor_sync(0xffffffffu, d[p][b], o);
      if (c == 0) {
#pragma unroll
        for (int p = 0; p < kPasses; ++p) {
          const int r = t * G::TILE + p * G::RPP + g;
          if (r < Le)
#pragma unroll
            for (int b = 0; b < KB; ++b)
              if (b < k) s[(size_t)b * Le + r] = d[p][b] * scale + madd[r];
        }
      }
    }
    __syncthreads();

    // ---- softmax per query, fp32, exact; probabilities in V's dtype ----
    for (int b = warp; b < k; b += kWarps) {
      float* sb = s + (size_t)b * Le;
      float mx = -INFINITY;
      for (int r = lane; r < Le; r += 32) mx = fmaxf(mx, sb[r]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int r = lane; r < Le; r += 32) {
        const float e = expf(sb[r] - mx);
        sb[r] = e;
        sum += e;
      }
      const float den = warp_sum(sum);
      for (int r = lane; r < Le; r += 32) sb[r] = round_to(sb[r] / den, T());
    }
    __syncthreads();

    // ---- P . V: fp32 sums per (query, column) over this thread's rows ----
    float acc[KB][CE];
#pragma unroll
    for (int b = 0; b < KB; ++b)
#pragma unroll
      for (int e = 0; e < CE; ++e) acc[b][e] = 0.f;
    for (int t = 0; t < n_tiles; ++t) {
      uint4 cur[kPasses];
#pragma unroll
      for (int p = 0; p < kPasses; ++p) cur[p] = vt[p];
      if (t + 1 < n_tiles)
        load_tile<T, D>(vbase, t + 1, Le, g, c, vt);
      else if (next < n_items)
        load_tile<T, D>(vc + next * slab, 0, Le, g, c, vt);
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        const int r = t * G::TILE + p * G::RPP + g;
        if (r >= Le) continue;
        float vv[CE];
        unpack(cur[p], vv, T());
#pragma unroll
        for (int b = 0; b < KB; ++b) {
          if (b < k) {
            const float pb = s[(size_t)b * Le + r];
#pragma unroll
            for (int e = 0; e < CE; ++e) acc[b][e] = fmaf(pb, vv[e], acc[b][e]);
          }
        }
      }
    }
    // the rows of one warp meet by shuffles, the warps in shared memory
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
      for (int b = 0; b < KB; ++b)
#pragma unroll
        for (int e = 0; e < CE; ++e) acc[b][e] += __shfl_xor_sync(0xffffffffu, acc[b][e], o);
    if (lane < LPR && has_cols) {
#pragma unroll
      for (int b = 0; b < KB; ++b)
        if (b < k)
#pragma unroll
          for (int e = 0; e < CE; ++e) red[((size_t)warp * k + b) * D + c * CE + e] = acc[b][e];
    }
    __syncthreads();
    for (int o = tid; o < k * D; o += kThreads) {
      const int b = o / D, col = o - b * D;
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += red[(size_t)w * k * D + o];
      store(ctx + ((size_t)(i * k + b) * h + head) * D + col, a);
    }
    // red is written again only after the next item's first two barriers
  }
}

// Blocks of a launch: the work items, or as many blocks of `kernel` as fit
// the device's SMs at once if fewer (asked once per device; the occupancy
// query is a host call, so a CUDA graph capture of a launch is safe).
constexpr int kMaxDevices = 64;
cudaError_t grid_size(const void* kernel, size_t smem, int n_items,
                      int* cached, int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    cached[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *grid = n_items < cached[dev] ? n_items : cached[dev];
  return cudaSuccess;
}

// With `info` set, nothing is launched: info[0] gets the blocks per SM and
// info[1] the dynamic shared-memory bytes of the launch.
template <typename T, int KB, int D>
int launch_d(const void* q, const void* kc, const void* vc, const void* mask,
             int mask_code, void* ctx, int m, int h, int k, int Le,
             cudaStream_t stream, int* info) {
  const void* kernel =
      reinterpret_cast<const void*>(decode_cross_attention_kernel<T, KB, D>);
  const size_t smem = smem_bytes(k, Le, D);
  // blocks that fit at once, by the shared memory of the largest launch
  // (k = 8, Le = kMaxKeys): a smaller launch fits as many or more.  The
  // occupancy query asks too, so that a launch captured after it asks
  // nothing.
  static int fits[kMaxDevices] = {};
  int grid = 0;
  cudaError_t err = grid_size(kernel, smem_bytes(kMaxBeams, kMaxKeys, D),
                              m * h, fits, &grid);
  if (err != cudaSuccess) return (int)err;
  if (info != nullptr) {
    info[1] = (int)smem;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], kernel,
                                                              kThreads, smem);
  }
  decode_cross_attention_kernel<T, KB, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), mask, mask_code, static_cast<T*>(ctx), m * h,
      h, k, Le, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// D = 64 (every published width) takes the register arrays at k exactly;
// other head sizes at the largest k
template <typename T>
int launch(const void* q, const void* kc, const void* vc, const void* mask,
           int mask_code, void* ctx, int m, int h, int k, int Le, int D,
           cudaStream_t stream, int* info) {
#define DCA_ARGS q, kc, vc, mask, mask_code, ctx, m, h, k, Le, stream, info
  if (D == 64) {
    switch (k) {
      case 1: return launch_d<T, 1, 64>(DCA_ARGS);
      case 2: return launch_d<T, 2, 64>(DCA_ARGS);
      case 3: return launch_d<T, 3, 64>(DCA_ARGS);
      case 4: return launch_d<T, 4, 64>(DCA_ARGS);
      case 5: return launch_d<T, 5, 64>(DCA_ARGS);
      case 6: return launch_d<T, 6, 64>(DCA_ARGS);
      case 7: return launch_d<T, 7, 64>(DCA_ARGS);
      default: return launch_d<T, 8, 64>(DCA_ARGS);
    }
  }
  switch (D) {
    case 32: return launch_d<T, kMaxBeams, 32>(DCA_ARGS);
    case 96: return launch_d<T, kMaxBeams, 96>(DCA_ARGS);
    case 128: return launch_d<T, kMaxBeams, 128>(DCA_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DCA_ARGS
}

int run(int dtype, const void* q, const void* kc, const void* vc,
        const void* mask, int mask_code, void* ctx, int m, int h, int k,
        int Le, int D, void* stream, int* info) {
  if (m < 1 || h < 1 || k < 1 || k > kMaxBeams || Le < 1 || Le > kMaxKeys ||
      D % 32 != 0 || D > kMaxHeadDim || mask_code < 0 || mask_code > 3)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, kc, vc, static_cast<const void*>(ctx)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, kc, vc, mask, mask_code, ctx, m, h, k, Le, D, st,
                           info);
    case 1:
      return launch<__nv_bfloat16>(q, kc, vc, mask, mask_code, ctx, m, h, k, Le,
                                   D, st, info);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Largest k, Le and head_dim the kernel takes (the wrapper checks them).
int dca_max_beams() { return kMaxBeams; }
int dca_max_keys() { return kMaxKeys; }
int dca_max_head_dim() { return kMaxHeadDim; }

// dtype: 0 = float32, 1 = bfloat16 (q, K, V and ctx alike); mask_code: 0 =
// float32, 1 = int32, 2 = int64, 3 = bool.  Returns the CUDA error code of
// the launch (0 = launched).  q, K, V and ctx must be 16-byte aligned.
int dca_launch(int dtype, const void* q, const void* k, const void* v,
               const void* mask, int mask_code, void* ctx, int m, int h,
               int beams, int Le, int D, void* stream) {
  return run(dtype, q, k, v, mask, mask_code, ctx, m, h, beams, Le, D, stream,
             nullptr);
}

// Occupancy of the launch dca_launch makes for this dtype, k, Le and D:
// info[0] = blocks per SM, info[1] = dynamic shared-memory bytes.  Launches
// nothing (it loads the kernel); returns a CUDA error code.
int dca_occupancy(int dtype, int beams, int Le, int D, int* info) {
  return run(dtype, nullptr, nullptr, nullptr, nullptr, 0, nullptr, 1, 1,
             beams, Le, D, nullptr, info);
}

}  // extern "C"
