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
//     self term.  Probabilities are normalised in fp32 and, for bf16 and
//     fp8 caches, rounded to bf16 before the V product (as the XLA
//     formulation casts them to the cache dtype); V accumulates in fp32.
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
// Bound.  The kernel is bound by device-memory bytes: it reads the K and V
// prefix once, 2*m*h*k*pos*D*sizeof(cache) bytes per launch, against about
// 4*m*h*k*k*pos*D flops.  At m=128, h=12, k=2, D=64 in bf16 that is
// 786,432 B x pos: 81.8 MB at pos=104, about 24 us at 3.35 TB/s, where the
// flops need about 2.4 us at the 67 TFLOP/s fp32 rate.  What the design does
// about it: each cache row is read from device memory once per launch (one
// block serves all k query beams of its (m, h), so a row feeds k dot
// products), rows t >= pos are never read, and a (lane, t) row that no beam
// of the block attends (every beam's mask <= -10000 there) is skipped for
// both K and V — its probability is exactly 0.0 in fp32 either way, since
// exp(-10000 + s - max) underflows, so skipping keeps the plain version's
// result.  Scores live in shared memory (k * k * pos floats).  wgmma, TMA and
// splitting T across blocks are left for later work.
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
constexpr int kMaxBeams = 8;       // k <= 8
constexpr int kMaxPerLane = 4;     // D <= 128, D % 32 == 0
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

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

// grid: m*h blocks (one per molecule-head), kThreads threads.
// dynamic shared memory: k*n floats (scores, then probabilities) + n flags,
// n = k*pos prefix keys ordered (lane, t).
template <typename C, typename Q>
__global__ void __launch_bounds__(kThreads)
beam_decode_attention_kernel(const Q* __restrict__ q, const Q* __restrict__ k_new,
                             const Q* __restrict__ v_new, C* __restrict__ cache,
                             const float* __restrict__ mask, Q* __restrict__ ctx,
                             int L, int m, int h, int k, int T, int D, int pos,
                             int layer, float scale) {
  extern __shared__ float smem[];
  __shared__ float s_self[kMaxBeams];
  __shared__ float p_self[kMaxBeams];

  const int mh = blockIdx.x;
  const int mi = mh / h;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int n = k * pos;
  const int per_lane = D >> 5;
  float* s = smem;                                          // [k][n]
  unsigned char* live = reinterpret_cast<unsigned char*>(smem + (size_t)k * n);

  const size_t slab = (size_t)k * T * D;                    // one (m, h) slice
  const size_t kv_stride = (size_t)L * m * h * slab;
  C* k_cache = cache + ((size_t)layer * m * h + mh) * slab;
  C* v_cache = k_cache + kv_stride;
  const size_t qoff = (size_t)mh * k * D;
  const float* mrow = mask + (size_t)mi * k * k * T;        // [k][k][T]

  // this lane's slice of every query beam, in registers
  float qr[kMaxBeams][kMaxPerLane];
#pragma unroll
  for (int b = 0; b < kMaxBeams; ++b)
#pragma unroll
    for (int e = 0; e < kMaxPerLane; ++e)
      qr[b][e] = (b < k && e < per_lane) ? to_f32(q[qoff + b * D + lane + 32 * e]) : 0.f;

  // ---- scores: one warp per prefix row (lane l, position t) ----
  for (int r = warp; r < n; r += n_warps) {
    const int l = r / pos, t = r - l * pos;
    const float mk = lane < k ? mrow[((size_t)lane * k + l) * T + t] : kMaskValue;
    if (!__any_sync(0xffffffffu, mk > kMaskValue)) {        // no beam attends
      if (lane < k) s[lane * n + r] = -INFINITY;
      if (lane == 0) live[r] = 0;
      continue;
    }
    const C* row = k_cache + ((size_t)l * T + t) * D;
    float kv[kMaxPerLane];
#pragma unroll
    for (int e = 0; e < kMaxPerLane; ++e)
      kv[e] = e < per_lane ? to_f32(row[lane + 32 * e]) : 0.f;
#pragma unroll
    for (int b = 0; b < kMaxBeams; ++b) {
      if (b >= k) break;
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < kMaxPerLane; ++e) d += qr[b][e] * kv[e];
      d = warp_sum(d);
      const float mb = __shfl_sync(0xffffffffu, mk, b);
      if (lane == 0) s[b * n + r] = d * scale + mb;
    }
    if (lane == 0) live[r] = 1;
  }
  // self scores: each beam against its own new key
  if (warp == 0) {
#pragma unroll
    for (int b = 0; b < kMaxBeams; ++b) {
      if (b >= k) break;
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < kMaxPerLane; ++e)
        if (e < per_lane) d += qr[b][e] * to_f32(k_new[qoff + b * D + lane + 32 * e]);
      d = warp_sum(d);
      if (lane == 0) s_self[b] = d * scale;
    }
  }
  __syncthreads();

  // ---- softmax per beam over [prefix ; self], fp32 ----
  for (int b = warp; b < k; b += n_warps) {
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

  // ---- ctx = P . V_prefix + p_self * v_new, fp32 accumulation ----
  for (int o = threadIdx.x; o < k * D; o += blockDim.x) {
    const int b = o / D, d = o - b * D;
    const float* pb = s + (size_t)b * n;
    float acc = 0.f;
    for (int r = 0; r < n; ++r) {
      if (!live[r]) continue;
      const int l = r / pos, t = r - l * pos;
      acc += pb[r] * to_f32(v_cache[((size_t)l * T + t) * D + d]);
    }
    acc += p_self[b] * to_f32(v_new[qoff + o]);
    ctx[qoff + o] = Store<Q>::from(acc);
  }

  // ---- append: lane l of the cache receives beam l's new K/V at pos ----
  for (int o = threadIdx.x; o < k * D; o += blockDim.x) {
    const int l = o / D, d = o - l * D;
    const size_t at = ((size_t)l * T + pos) * D + d;
    k_cache[at] = Store<C>::from(to_f32(k_new[qoff + o]));
    v_cache[at] = Store<C>::from(to_f32(v_new[qoff + o]));
  }
}

template <typename C, typename Q>
int launch(const void* q, const void* k_new, const void* v_new, void* cache,
           const float* mask, void* ctx, int L, int m, int h, int k, int T,
           int D, int pos, int layer, cudaStream_t stream) {
  const size_t n = (size_t)k * pos;
  const size_t smem = n * k * sizeof(float) + n;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        beam_decode_attention_kernel<C, Q>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  beam_decode_attention_kernel<C, Q><<<m * h, kThreads, smem, stream>>>(
      static_cast<const Q*>(q), static_cast<const Q*>(k_new),
      static_cast<const Q*>(v_new), static_cast<C*>(cache), mask,
      static_cast<Q*>(ctx), L, m, h, k, T, D, pos, layer, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest k and head_dim the kernel takes (the wrapper checks both).
int bda_max_beams() { return kMaxBeams; }
int bda_max_head_dim() { return 32 * kMaxPerLane; }

// cache_dtype: 0 = float32, 1 = bfloat16, 2 = float8_e4m3fn.  Returns the
// CUDA error code of the launch (0 = launched).
int bda_launch(int cache_dtype, const void* q, const void* k_new,
               const void* v_new, void* cache, const float* mask, void* ctx,
               int L, int m, int h, int k, int T, int D, int pos, int layer,
               void* stream) {
  if (k < 1 || k > kMaxBeams || D % 32 != 0 || D > 32 * kMaxPerLane ||
      pos < 0 || pos >= T || layer < 0 || layer >= L)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cache_dtype) {
    case 0:
      return launch<float, float>(q, k_new, v_new, cache, mask, ctx, L, m, h, k,
                                  T, D, pos, layer, st);
    case 1:
      return launch<__nv_bfloat16, __nv_bfloat16>(q, k_new, v_new, cache, mask,
                                                  ctx, L, m, h, k, T, D, pos,
                                                  layer, st);
    case 2:
      return launch<__nv_fp8_e4m3, __nv_bfloat16>(q, k_new, v_new, cache, mask,
                                                  ctx, L, m, h, k, T, D, pos,
                                                  layer, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
