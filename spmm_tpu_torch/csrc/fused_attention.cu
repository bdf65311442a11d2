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
//
// Bound.  At the path's largest launch (B=128, h=12, Lq=54, Lk=100, D=64,
// fp32) the function moves q, k, v and out once, 121 MB, which takes 36 us
// at 3.35 TB/s; its 2.1 GFLOP take 32 us at the 67 TFLOP/s fp32 rate.  So
// bytes bound it, with operations close behind.  What the design does about
// it: one block per (b, h) reads that slice of K and V from device memory
// once into shared memory, converted to fp32, and serves every query row of
// the slice from there.  No tensor cores: the fp32 path must stay fp32
// (parity bar 2e-5), so the products are fp32 FMAs, and what limits them is
// shared-memory traffic.  So each warp takes kRows = 4 query rows at once,
// like a small register-tiled GEMM: in the score loop one broadcast float4
// of q (the 4 rows at one d) and one conflict-free word of transposed K per
// key feed 4 FMAs, and in the P.V loop one broadcast float4 of P and one
// word of V feed 4.  K is stored transposed, [D][Lk|1]: lane j reads key j,
// and the odd row stride keeps the transposing writes conflict-free too.
// Scores, softmax and output stay in registers; P goes through a per-warp
// [Lk][4] tile.  Every sum runs in the plain version's order, d then j, so
// the tiling changes no bit of the result.  wgmma for bf16, and splitting
// the rows of a (b, h) across blocks, are left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (spmm_tpu_torch/ops/_build.py); plain C interface,
//        bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 4;                              // query rows per warp pass
constexpr int kMaxKeysPerLane = 8;
constexpr int kMaxKeys = 32 * kMaxKeysPerLane;       // Lk <= 256

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// probabilities take v's dtype before the V product
template <typename T> __device__ __forceinline__ float round_prob(float p);
template <> __device__ __forceinline__ float round_prob<float>(float p) { return p; }
template <> __device__ __forceinline__ float round_prob<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16(p));
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

struct Args {
  int H, Lq, Lk;
  // element strides: q, k, v, out as (b, h, l); mask as (b, query row, key)
  long long qs[3], ks[3], vs[3], os[3], ms[3];
  float scale;
};

// dynamic shared memory, in floats: K^T [D][Lk|1] | V [Lk][D] |
// Q [kWarps][D][kRows] | P [kWarps][Lk][kRows]
size_t smem_bytes(int lk, int d) {
  return sizeof(float) * ((size_t)d * (lk | 1) + (size_t)lk * d +
                          (size_t)kWarps * kRows * (d + lk));
}

// grid: B*h blocks, one per (b, h); kThreads threads, one warp per kRows
// query rows at a time.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fused_mha_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ mask,
                 T* __restrict__ out, const Args a) {
  extern __shared__ float4 smem4[];
  constexpr int PER_LANE = D / 32;           // output columns per lane
  const int Lk = a.Lk;
  const int LkP = Lk | 1;                    // odd: conflict-free transpose
  float* kt_s = reinterpret_cast<float*>(smem4);
  float* v_s = kt_s + (size_t)D * LkP;
  float* q_s = v_s + (size_t)Lk * D;
  float* p_s = q_s + kWarps * kRows * D;

  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x - b * a.H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // ---- stage this (b, h) slice of K (transposed) and V, as fp32 ----
  const T* kb = k + b * a.ks[0] + h * a.ks[1];
  const T* vb = v + b * a.vs[0] + h * a.vs[1];
  for (int idx = threadIdx.x; idx < Lk * D; idx += kThreads) {
    const int j = idx / D, d = idx - j * D;
    kt_s[d * LkP + j] = to_f32(kb[j * a.ks[2] + d]);
    v_s[idx] = to_f32(vb[j * a.vs[2] + d]);
  }
  __syncthreads();

  float* q_w = q_s + warp * kRows * D;       // [D][kRows]
  float* p_w = p_s + warp * kRows * Lk;      // [Lk][kRows]
  const T* qb = q + b * a.qs[0] + h * a.qs[1];
  T* ob = out + b * a.os[0] + h * a.os[1];
  const int n_groups = (a.Lq + kRows - 1) / kRows;
  for (int g = warp; g < n_groups; g += kWarps) {
    const int i0 = g * kRows;
    // the group's query rows as [D][kRows]; rows past Lq are zeros
    for (int idx = lane; idx < kRows * D; idx += 32) {
      const int r = idx / D, d = idx - r * D;
      q_w[d * kRows + r] =
          i0 + r < a.Lq ? to_f32(qb[(i0 + r) * a.qs[2] + d]) : 0.f;
    }
    __syncwarp();

    // ---- scores: lane owns keys lane, lane + 32, ... of all kRows rows ----
    float s[kRows][kMaxKeysPerLane];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int t = 0; t < kMaxKeysPerLane; ++t) s[r][t] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qd = reinterpret_cast<const float4*>(q_w)[d];
      const float* kr = kt_s + d * LkP + lane;
#pragma unroll
      for (int t = 0; t < kMaxKeysPerLane; ++t) {
        if (32 * t < Lk) {
          // keys past Lk read in-bounds garbage, dropped below
          const float kv = kr[32 * t];
          s[0][t] = fmaf(qd.x, kv, s[0][t]);
          s[1][t] = fmaf(qd.y, kv, s[1][t]);
          s[2][t] = fmaf(qd.z, kv, s[2][t]);
          s[3][t] = fmaf(qd.w, kv, s[3][t]);
        }
      }
    }

    // ---- exact two-pass softmax in fp32, row by row ----
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      const float* mr = (mask == nullptr || i >= a.Lq)
                            ? nullptr : mask + b * a.ms[0] + i * a.ms[1];
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < kMaxKeysPerLane; ++t) {
        const int j = lane + 32 * t;
        if (j < Lk) {
          s[r][t] = s[r][t] * a.scale + (mr == nullptr ? 0.f : mr[j * a.ms[2]]);
          mx = fmaxf(mx, s[r][t]);
        }
      }
      mx = warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < kMaxKeysPerLane; ++t) {
        const float e = lane + 32 * t < Lk ? expf(s[r][t] - mx) : 0.f;
        s[r][t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
#pragma unroll
      for (int t = 0; t < kMaxKeysPerLane; ++t) {
        const int j = lane + 32 * t;
        if (j < Lk) p_w[j * kRows + r] = round_prob<T>(s[r][t] / sum);
      }
    }
    __syncwarp();

    // ---- out rows = P . V, fp32 accumulation; lane owns d = lane + 32 e ----
    float o[kRows][PER_LANE];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int e = 0; e < PER_LANE; ++e) o[r][e] = 0.f;
    for (int j = 0; j < Lk; ++j) {
      const float4 pj = reinterpret_cast<const float4*>(p_w)[j];
      const float* vr = v_s + j * D + lane;
#pragma unroll
      for (int e = 0; e < PER_LANE; ++e) {
        const float vv = vr[32 * e];
        o[0][e] = fmaf(pj.x, vv, o[0][e]);
        o[1][e] = fmaf(pj.y, vv, o[1][e]);
        o[2][e] = fmaf(pj.z, vv, o[2][e]);
        o[3][e] = fmaf(pj.w, vv, o[3][e]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (i0 + r < a.Lq) {
        T* orow = ob + (i0 + r) * a.os[2];
#pragma unroll
        for (int e = 0; e < PER_LANE; ++e) store(orow + lane + 32 * e, o[r][e]);
      }
    }
    __syncwarp();                            // q_w and p_w are rewritten next
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const float* mask,
           void* out, int B, const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.Lk, D);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_mha_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fused_mha_kernel<T, D><<<B * a.H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v,
             const float* mask, void* out, int B, const Args& a,
             cudaStream_t st) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, mask, out, B, a, st);
    case 64: return launch<T, 64>(q, k, v, mask, out, B, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Largest key length the kernel takes (the wrapper checks it).
int fmha_max_keys() { return kMaxKeys; }

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike); D is 32 or 64.
// strides: 15 element strides, (b, h, l) of q, k, v and out, then (b, query
// row, key) of the mask; mask may be null.  Returns the CUDA error code of
// the launch (0 = launched).
int fmha_launch(int dtype, int D, const void* q, const void* k, const void* v,
                const float* mask, void* out, int B, int H, int Lq, int Lk,
                const long long* strides, float scale, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || Lk > kMaxKeys)
    return (int)cudaErrorInvalidValue;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(D, q, k, v, mask, out, B, a, st);
    case 1: return dispatch<__nv_bfloat16>(D, q, k, v, mask, out, B, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
