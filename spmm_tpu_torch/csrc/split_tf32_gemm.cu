// fp32 linear layers on the tensor cores: y = x W^T + b from three TF32
// products (ops/split_gemm.py; the BERT layers' fp32 linears at inference,
// models/bert.py Linear).
//
// It replaces no TPU kernel: the JAX package leaves its fp32 products to
// XLA.  It was added because cuBLAS's fp32 products run on the SIMT units
// (67 TFLOP/s on an H100) and took 85% of a SMILES->PV batch, while TF32
// alone (495 TFLOP/s) loses the fp32 digits that the property decode
// needs.  The split (Ootomo & Yokota, IJHPCA 2022) recovers them:
//
//   x = x_hi + x_lo,  W = W_hi + W_lo,  each part rounded to TF32 (nearest,
//   ties away from zero: cvt.rna)
//   y = x_hi W_hi^T + 2^-11 (x_hi W'_lo^T + x'_lo W_hi^T) + b
//
// where x'_lo = rna((x - x_hi) 2^11) and W'_lo likewise: the low parts are
// scaled up by 2^11 so that they do not fall into fp32's subnormals.  The
// x_lo W_lo term lies below fp32's rounding and is left out.  The two
// correction products sum in their own accumulator, added to the main one
// only in the epilogue, so that the tensor cores' accumulation of the large
// products does not cost the digits the split recovers.  The tensor cores'
// own fp32 accumulation loses bits over a long K (over K = 768 in one block
// the main products read 3.7x cuBLAS SGEMM's error against fp64), so the
// main products are promoted into an fp32 register sum after every depth
// tile of 32.
//
//   x     [M, K] fp32, rows ldx elements apart (K-major)
//   parts [2 N, K] fp32: W_hi (rows 0..N-1) above W'_lo (rows N..2N-1),
//         made once a weight by ops/split_gemm.py (K-major)
//   bias  [N] fp32 or none;  y [M, N] fp32, contiguous
//
// Bound: the products.  At the BERT layers' widths (K, N of 768 and 3,072,
// M up to 6,912) a tile of 128 x 96 outputs reads 128 + 2 x 96 fp32 a
// depth for 3 x 128 x 96 multiply-adds, far past the card's ridge, so the
// design is a tensor-core GEMM on wgmma:
//
//   - A block computes a 128 x 96 tile of y over its share of K: two
//     consumer warpgroups of 64 rows each and one producer warp (288
//     threads).  The producer keeps a ring of 5 stages full with TMA (x's
//     128 x 32 tile, W_hi's and W'_lo's 96 x 32 tiles, 128-byte swizzle),
//     signalling each stage's arrival on an mbarrier; the consumers release
//     a stage on another once its products are done.
//   - 96 columns, not 128: a consumer thread holds three accumulators (the
//     promoted sum, the tensor cores' one of the tile, the corrections) of
//     its 64 x 96 share, 3 x 48 registers, beside its A fragments, in the
//     168 registers ptxas gives a thread of this block.  At 64 x 128
//     (3 x 64) ptxas spilled 452 bytes and serialised the wgmmas, and the
//     kernel ran at cuBLAS SGEMM's speed; at 64 x 96 it spills 200 bytes
//     and the wgmmas stay asynchronous (PERF.md, kernel 5).
//   - x is split in registers: a consumer reads its A fragments of a depth
//     of 8 from the stage (conflict-free under the swizzle), rounds x_hi
//     and x'_lo with cvt.rna, and issues wgmma m64n96k8 .tf32 with A from
//     registers and B (the weight's parts) from shared memory.
//   - Split-K by thread-block cluster: where the tiles alone would leave
//     SMs idle or a last wave nearly empty, a cluster of S blocks (1, 2, 4
//     or 8) splits K; each block writes its partial tile to its shared
//     memory and the blocks sum the S partials through distributed shared
//     memory, each a 128 / S-row slice, in rank order (deterministic, no
//     workspace, no atomics, so a CUDA graph replays it).  The host picks S
//     from M, N and K and the card's cluster occupancy (stg_plan).
//   - The epilogue adds the scaled correction, the bias, and writes fp32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (spmm_tpu_torch/ops/_build.py); plain C interface,
//        bound with ctypes.  cuTensorMapEncodeTiled is taken from the
//        driver library already loaded in the process (dlopen, dlsym).

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 96;             // a block's tile of y
constexpr int BK = 32;                       // fp32 a row of a stage: 128 B
constexpr int CONSUMERS = 2;                 // warpgroups of 64 rows
constexpr int THREADS = 128 * CONSUMERS + 32;  // and the producer warp
constexpr int STAGES = 5;
constexpr int X_BYTES = BM * BK * 4;         // 16 KB
constexpr int W_BYTES = BN * BK * 4;         // 12 KB a part
constexpr int ACC = BN / 2;                  // accumulator registers
constexpr float LO_SCALE = 2048.f;           // 2^11
constexpr int PART_STRIDE = BN + 4;          // floats a row of a partial tile

static_assert(X_BYTES % 1024 == 0 && W_BYTES % 1024 == 0,
              "every tile starts on the swizzle's 1024-byte period");

constexpr int STAGE = X_BYTES + 2 * W_BYTES;   // x, W_hi, W'_lo
// the ring, its full and empty mbarriers, room to align to 1024 bytes
constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
static_assert(BM * PART_STRIDE * 4 <= STAGES * STAGE,
              "a partial tile fits the ring");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the phase of the given parity has completed; a wait that
// never ends (a fault) traps after about 2^28 tries instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// a 128-row, 32-column box of a 2-D fp32 tensor map at (column, row)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// wgmma's matrix descriptor: K-major, 128-byte swizzle, 8-row groups 1024
// bytes apart
__device__ __forceinline__ uint64_t descriptor(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
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

// keep the compiler from moving accesses of registers that an in-flight
// wgmma reads or writes across its issue or its wait
__device__ __forceinline__ void hold(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void hold(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[s][j])::"memory");
}

#define ACC8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC48 ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40)
#define REG48                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "    \
  "%41, %42, %43, %44, %45, %46, %47}"

static_assert(ACC == 48, "the wgmma below writes 48 registers a thread");

// d[64 x 96] (+)= A[64 x 8] (TF32 in registers) B[96 x 8]^T (TF32, K-major
// in shared memory); accumulate 0: d = A B^T
__device__ __forceinline__ void wgmma_tf32(float (&d)[ACC], const uint32_t* a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 " REG48
      ", {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : ACC48
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float ld_shared(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// the 16 bytes at this CTA's shared address ``addr`` in CTA ``rank`` of
// the cluster
__device__ __forceinline__ float4 ld_peer(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// grid (S, N / BN, ceil(M / BM)), clusters of (S, 1, 1): block (s, n, m)
// computes rows m * BM.., columns n * BN.. over its share s of K
__global__ void __launch_bounds__(THREADS, 1)
split_tf32_gemm_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_w,
                       const float* __restrict__ bias, float* __restrict__ y,
                       int M, int N, int K) {
  extern __shared__ unsigned char raw[];
  const uint32_t base = (smem_u32(raw) + 1023) & ~1023u;
  unsigned char* base_ptr = raw + (base - smem_u32(raw));
  const uint32_t full = base + STAGES * STAGE;   // STAGES mbarriers
  const uint32_t empty = full + STAGES * 8;         // STAGES mbarriers

  const int splits = gridDim.x, split = blockIdx.x;
  const int n0 = blockIdx.y * BN, m0 = blockIdx.z * BM;
  const int kt = K / BK;
  const int k_first = split * kt / splits;
  const int tiles = (split + 1) * kt / splits - k_first;

  const int tid = threadIdx.x, wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * 4);      // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- the producer warp: one thread keeps the ring full ----
    if (tid == CONSUMERS * 128) {
      for (int i = 0; i < tiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + 8 * s, ((i / STAGES) - 1) & 1);
        const uint32_t bar = full + 8 * s, stage = base + s * STAGE;
        const int k = (k_first + i) * BK;
        mbar_expect_tx(bar, STAGE);
        tma_load(stage, &map_x, bar, k, m0);
        tma_load(stage + X_BYTES, &map_w, bar, k, n0);
        tma_load(stage + X_BYTES + W_BYTES, &map_w, bar, k, N + n0);
      }
    }
    return;
  }

  // ---- the consumers: 64 rows each ----
  const int lane = tid % 32, warp = (tid % 128) / 32;
  const int g = lane / 4, t = lane % 4;
  // this thread's A rows in the tile: r and r + 8, r % 8 == g
  const int r = wg * 64 + warp * 16 + g;

  // sum: the main products, promoted from the tensor cores' accumulator
  // (acc, one depth tile of 32) with fp32 adds each tile; cor: the two
  // correction products, scaled by 2^11, over the block's whole depth
  float sum[ACC], acc[ACC], cor[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) sum[i] = acc[i] = cor[i] = 0.f;
  uint32_t hi[4][4], lo[4][4];

  for (int i = 0; i < tiles; ++i) {
    const int s = i % STAGES;
    mbar_wait(full + 8 * s, (i / STAGES) & 1);
    const uint32_t stage = base + s * STAGE;
    // A fragment of depth step q: (r, t), (r + 8, t), (r, t + 4),
    // (r + 8, t + 4) of columns 8q..8q+7; element (row, c) of the swizzled
    // stage at row * 128 + ((c / 4) ^ (row % 8)) * 16 + (c % 4) * 4
    const uint32_t a_row = stage + r * 128 + t * 4;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int chunk = 2 * q + (j >> 1);
        const float v =
            ld_shared(a_row + (j & 1) * 8 * 128 + ((chunk ^ g) << 4));
        hi[q][j] = to_tf32(v);
        lo[q][j] = to_tf32((v - __uint_as_float(hi[q][j])) * LO_SCALE);
      }
    }
    hold(acc);
    hold(cor);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint64_t b_hi = descriptor(stage + X_BYTES + 32 * q);
      wgmma_tf32(acc, hi[q], b_hi, q > 0);
      wgmma_tf32(cor, hi[q], descriptor(stage + X_BYTES + W_BYTES + 32 * q),
                 1);
      wgmma_tf32(cor, lo[q], b_hi, 1);
    }
    wgmma_commit();
    wgmma_wait();
    hold(acc);
    hold(cor);
    hold(hi);
    hold(lo);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
#pragma unroll
    for (int e = 0; e < ACC; ++e) sum[e] += acc[e];
  }

#pragma unroll
  for (int i = 0; i < ACC; ++i) sum[i] = fmaf(cor[i], 1.f / LO_SCALE, sum[i]);

  // accumulator element 4j + e: row r (e < 2) or r + 8, column 8j + 2t +
  // (e % 2) of the tile
  if (splits == 1) {
    const int row = m0 + r;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      float2 b = make_float2(0.f, 0.f);
      if (bias != nullptr) b = *reinterpret_cast<const float2*>(bias + col);
      if (row < M)
        *reinterpret_cast<float2*>(y + (long long)row * N + col) =
            make_float2(sum[4 * j] + b.x, sum[4 * j + 1] + b.y);
      if (row + 8 < M)
        *reinterpret_cast<float2*>(y + (long long)(row + 8) * N + col) =
            make_float2(sum[4 * j + 2] + b.x, sum[4 * j + 3] + b.y);
    }
    return;
  }

  // ---- split-K: partial tiles summed through distributed shared memory ----
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
  float* part = reinterpret_cast<float*>(base_ptr);   // the ring, now free
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * t;
    *reinterpret_cast<float2*>(part + r * PART_STRIDE + col) =
        make_float2(sum[4 * j], sum[4 * j + 1]);
    *reinterpret_cast<float2*>(part + (r + 8) * PART_STRIDE + col) =
        make_float2(sum[4 * j + 2], sum[4 * j + 3]);
  }
  cluster_sync();
  const uint32_t rank = cluster_rank();
  const int rows = BM / splits;
  for (int e = tid; e < rows * (BN / 4); e += CONSUMERS * 128) {
    const int row = rank * rows + e / (BN / 4), c = 4 * (e % (BN / 4));
    const uint32_t addr = base + (row * PART_STRIDE + c) * 4;
    float4 out = ld_peer(addr, 0);
    for (int p = 1; p < splits; ++p) {
      const float4 v = ld_peer(addr, p);
      out.x += v.x;
      out.y += v.y;
      out.z += v.z;
      out.w += v.w;
    }
    if (bias != nullptr) {
      const float4 b = *reinterpret_cast<const float4*>(bias + n0 + c);
      out.x += b.x;
      out.y += b.y;
      out.z += b.z;
      out.w += b.w;
    }
    if (m0 + row < M)
      *reinterpret_cast<float4*>(y + (long long)(m0 + row) * N + n0 + c) =
          out;
  }
  cluster_sync();   // no block leaves while a peer reads its partial
}

// ---- host ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(
          dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

constexpr int ERR_DRIVER = 10000;   // + the driver's CUresult

// rows x cols fp32, rows row_bytes apart, read in boxes of box_rows x 32
int make_map(CUtensorMap* map, const void* ptr, long long rows,
             long long cols, long long row_bytes, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_DRIVER;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {BK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_DRIVER + (int)r;
}

constexpr int MAX_DEVICES = 64;
// clusters of S blocks that fit the card at once, by device and log2 S
int capacity[MAX_DEVICES][4];

int prepare_kernel(int dev) {
  auto kernel = split_tf32_gemm_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  for (int l = 0; l < 4; ++l) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1 << l;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(1 << l, 1, 1);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = SMEM;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    capacity[dev][l] = n;
  }
  return 0;
}

int current_device(int* dev) {
  const cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  if (*dev < 0 || *dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (capacity[*dev][0] == 0) {
    const int e = prepare_kernel(*dev);
    if (e != 0) return e;
    if (capacity[*dev][0] == 0) return (int)cudaErrorInvalidConfiguration;
  }
  return 0;
}

// A block's fixed cost in depth tiles (the ring's fill, the epilogue) and
// what a split adds (the partial tiles' exchange and the cluster's
// barriers), measured on an H100.
constexpr int BLOCK_COST = 2, SPLIT_COST = 4;

// The split of K: the S of {1, 2, 4, 8}, at least 3 depth tiles a block,
// that minimises the waves times a block's depth tiles and fixed costs.
int choose_splits(int dev, int M, int N, int K) {
  const long long tiles = (long long)((M + BM - 1) / BM) * (N / BN);
  const int kt = K / BK;
  int best = 1;
  long long best_cost = -1;
  for (int l = 0; l < 4; ++l) {
    const int s = 1 << l;
    if (s > 1 && kt < 3 * s) break;
    const long long slots = (long long)capacity[dev][l] * s;
    if (slots == 0) break;
    const long long waves = (tiles * s + slots - 1) / slots;
    const long long cost =
        waves * ((kt + s - 1) / s + BLOCK_COST + (s > 1 ? SPLIT_COST : 0));
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = s;
    }
  }
  return best;
}

// one launch at a given split of K (1, 2, 4 or 8)
int launch(const void* x, long long ldx, const void* parts, const void* bias,
           void* y, int M, int N, int K, int s, void* stream) {
  CUtensorMap map_x, map_w;
  int err = make_map(&map_x, x, M, K, ldx * 4, BM);
  if (err == 0)
    err = make_map(&map_w, parts, 2LL * N, K, (long long)K * 4, BN);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = s;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(s, N / BN, (M + BM - 1) / BM);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, split_tf32_gemm_kernel, map_x, map_w,
      static_cast<const float*>(bias), static_cast<float*>(y), M, N, K);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch's split of K and its blocks on the current device:
// out = {S, blocks, clusters that fit the card at once}.
int stg_plan(int M, int N, int K, int* out) {
  int dev = 0;
  const int err = current_device(&dev);
  if (err != 0) return err;
  const int s = choose_splits(dev, M, N, K);
  int l = 0;
  while ((1 << l) < s) ++l;
  out[0] = s;
  out[1] = s * (N / BN) * ((M + BM - 1) / BM);
  out[2] = capacity[dev][l];
  return 0;
}

// y [M, N] = x [M, K] (rows ldx apart) W^T (+ bias) with W given as its
// parts [2 N, K] (W_hi over W'_lo), from three TF32 products.  N a
// multiple of 96, K of 32, x and the parts 16-byte aligned with ldx a
// multiple of 4.  Launches on ``stream`` of the current device; returns a CUDA error (or 10000 + a driver error), 0 on success.
int stg_launch(const void* x, long long ldx, const void* parts,
               const void* bias, void* y, int M, int N, int K, void* stream) {
  if (M <= 0) return 0;
  if (N % BN || K % BK || ldx % 4 || ldx < K)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  const int err = current_device(&dev);
  if (err != 0) return err;
  return launch(x, ldx, parts, bias, y, M, N, K, choose_splits(dev, M, N, K),
                stream);
}

}  // extern "C"
