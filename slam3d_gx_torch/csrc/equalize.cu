// Histogram equalization kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (slam3d_gx_torch/kernels/equalize.py).
//
// K1 slam_hist256 replaces the TPU kernel _hist_kernel
//    (slam3d_gx_tpu/ops/pallas_kernels.py, launched by
//    _histogram256_pallas): 256-bin histogram of a uint8 image.
//    Bound: bytes. A 640x480 frame is 307,200 B read once, ~0.09 us at
//    3.35 TB/s; at that size the launch latency dominates. Design: each
//    block keeps 256 int32 bins in shared memory, walks a grid-stride
//    loop with 16-byte loads (16 pixels a load), counts with shared
//    atomics, then adds each non-zero bin once to the global (256,)
//    int32 output, which the caller zeroes. The TPU's per-lane partial
//    histograms and -1 padding are not needed: the ragged tail is a
//    byte loop.
//
// K2 slam_lut256 replaces the TPU kernel _lut_kernel (launched by
//    _apply_lut256_pallas): out[p] = lut[x[p]]. Bound: bytes, 307,200 B
//    read plus 307,200 B written, ~0.18 us. Design: the 256-entry LUT
//    is staged in shared memory as bytes and each pixel is one indexed
//    shared read; 16-byte loads and stores; the float -> uint8 cast of
//    the reference (imageproc.py:146) is fused into the store. The TPU's
//    telescoped compare+FMA form existed only to avoid a gather, which
//    is cheap here.
//
// slam_equalize256 replaces both TPU kernels at once, and the 256-element
//    CDF and LUT arithmetic that ran between them as some 25 tiny device
//    operations: the whole of equalize_hist (ops/imageproc.py) in ONE
//    launch. out = lut[x], lut from x's own histogram as cv::equalizeHist
//    builds it. Bound: bytes, the image read once and written once
//    (2 x 307,200 B at 480x640, ~0.18 us at 3.35 TB/s). At that size the
//    time is a launch's fixed cost, one barrier across blocks and what a
//    few SMs' load/store units get through, so the design spends one
//    launch and keeps every intermediate on the chip:
//    - one thread-block cluster (8 blocks of 1,024 threads on
//      neighbouring SMs) is the whole grid. Up to kRegVecs 16-byte
//      vectors a thread stay in registers between counting and lookup,
//      so the image is read once (480x640 is 19,200 vectors for 8,192
//      threads). The loads are started first and fly while the count
//      table is zeroed;
//    - counting: shared atomics into a table laid out [bin][lane], one
//      column per lane of a warp. Lanes of one warp never share an
//      address or a bank, whatever the image holds, so a frame that
//      sits on a few gray levels (or a mostly-zero membership image)
//      costs the same as a random one. (Per-warp tables would still
//      serialise the 32 lanes of a warp on such a frame.) Four threads a
//      bin then sum the 32 columns;
//    - across blocks: every block pushes its 256 counts into every
//      peer's shared memory with 16-byte stores through distributed
//      shared memory (map_shared_rank), then one cluster.sync(), then
//      sums the rows it received. Stores, because a remote load stalls
//      its thread for the round trip and remote atomics are served an
//      element at a time by the receiving SM. No scratch in device
//      memory, no memset, no global atomics, nothing to leave clean for
//      the next launch. A block may write to a peer only once the peer
//      runs: every block arrives at the cluster barrier first of all
//      and waits on it just before it pushes, when all have long
//      arrived. After the cluster.sync() no block touches another's
//      memory, so none needs to wait before it returns. A cluster
//      barrier at which blocks really wait is the dearest single step,
//      so the design has one (a reduce-scatter with two measured
//      slower);
//    - CDF and LUT, redundantly in every block: each of 8 warps scans
//      the 256 bins in registers (8 bins a lane, one shuffle scan), finds
//      the first non-empty bin by a warp minimum, and computes its 32
//      LUT entries with exactly the plain version's two float32
//      operations (one IEEE division, one product, neither fused:
//      __fdiv_rn, __fmul_rn), rintf (half to even), clamp. The LUT lives
//      in shared memory as bytes;
//    - lookup from the registers, 16-byte stores.
//    An image of more than 8 * 1,024 * kRegVecs * 16 = 524,288 pixels
//    takes a grid-stride loop in the same cluster and reads the image a
//    second time for the lookup (from L2). A cluster drains memory with
//    its few SMs only, so from some size on two full-width launches are
//    faster; PERF.md section 6 gives the measured crossover.
//    The ragged tail and 16-byte-misaligned views take byte loops.
//    The entry takes the cluster's size (8, or 16 outside the portable
//    range) so that the two can be measured against each other.
//
// slam_empty launches a kernel that does nothing with the same grid,
// block and cluster shape: the floor any such launch pays on a card.
//
// All launch on the caller's stream, allocate nothing and return
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 4;

__global__ void hist256_kernel(const uint8_t* __restrict__ x, long long n,
                               long long n_vec, int* __restrict__ out) {
  __shared__ int bins[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) bins[i] = 0;
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  for (long long i = first; i < n_vec; i += stride) {
    const uint4 v = xv[i];
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      atomicAdd(&bins[w[k] & 0xffu], 1);
      atomicAdd(&bins[(w[k] >> 8) & 0xffu], 1);
      atomicAdd(&bins[(w[k] >> 16) & 0xffu], 1);
      atomicAdd(&bins[w[k] >> 24], 1);
    }
  }
  for (long long i = n_vec * 16 + first; i < n; i += stride) {
    atomicAdd(&bins[x[i]], 1);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    const int c = bins[i];
    if (c != 0) atomicAdd(&out[i], c);
  }
}

__global__ void lut256_kernel(const uint8_t* __restrict__ x,
                              const float* __restrict__ lut,
                              uint8_t* __restrict__ out, long long n,
                              long long n_vec) {
  __shared__ uint8_t table[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    table[i] = (uint8_t)(int)lut[i];
  }
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(out);
  for (long long i = first; i < n_vec; i += stride) {
    const uint4 v = xv[i];
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
    unsigned r[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      r[k] = (unsigned)table[w[k] & 0xffu]
             | ((unsigned)table[(w[k] >> 8) & 0xffu] << 8)
             | ((unsigned)table[(w[k] >> 16) & 0xffu] << 16)
             | ((unsigned)table[w[k] >> 24] << 24);
    }
    ov[i] = make_uint4(r[0], r[1], r[2], r[3]);
  }
  for (long long i = n_vec * 16 + first; i < n; i += stride) {
    out[i] = table[x[i]];
  }
}

// 16-byte vector loads need 16-byte aligned pointers; a view with an
// odd offset takes the byte loop for all of its pixels.
long long vec_count(long long n, const void* a, const void* b) {
  const bool aligned = ((uintptr_t)a % 16 == 0) && ((uintptr_t)b % 16 == 0);
  return aligned ? n / 16 : 0;
}

int grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return (int)blocks;
}

// ---- the fused kernel ------------------------------------------------------

constexpr int kEqThreads = 1024;
constexpr int kRegVecs = 4;
constexpr unsigned kFull = 0xffffffffu;

// `col` points at this lane's column of the [256][32] count table.
__device__ __forceinline__ void count16(int* col, const uint4 v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    atomicAdd(&col[(w[k] & 0xffu) << 5], 1);
    atomicAdd(&col[((w[k] >> 8) & 0xffu) << 5], 1);
    atomicAdd(&col[((w[k] >> 16) & 0xffu) << 5], 1);
    atomicAdd(&col[(w[k] >> 24) << 5], 1);
  }
}

__device__ __forceinline__ uint4 map16(const uint8_t* table, const uint4 v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  unsigned r[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    r[k] = (unsigned)table[w[k] & 0xffu]
           | ((unsigned)table[(w[k] >> 8) & 0xffu] << 8)
           | ((unsigned)table[(w[k] >> 16) & 0xffu] << 16)
           | ((unsigned)table[w[k] >> 24] << 24);
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// Shared memory of one block, in ints: the count table, one row of
// counts per block of the cluster, the image's histogram, the byte LUT.
__host__ __device__ constexpr int equalize_smem_ints(int blocks) {
  return 256 * 32 + blocks * 256 + 256 + 256 / 4;
}

__global__ void __launch_bounds__(kEqThreads)
equalize256_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                   long long n, long long n_vec) {
  extern __shared__ __align__(16) int smem[];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.barrier_arrive();  // barrier 1: this block runs

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int blocks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  int* tab = smem;                 // [bin][lane]: this block's counts
  int* all = tab + 256 * 32;       // [block][bin]: every block's counts
  int* hist = all + blocks * 256;  // the image's histogram
  uint8_t* table = reinterpret_cast<uint8_t*>(hist + 256);
  const long long threads = (long long)blocks * kEqThreads;
  // warps are dealt to the blocks in turn, so that the last, partial
  // round of vectors spreads over all blocks
  const long long gtid = ((long long)warp * blocks + rank) * 32 + lane;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(out);
  const bool in_regs = n_vec <= threads * kRegVecs;

  // the loads fly while the table is zeroed
  uint4 v[kRegVecs];
  if (in_regs) {
#pragma unroll
    for (int k = 0; k < kRegVecs; ++k) {
      const long long i = k * threads + gtid;
      if (i < n_vec) v[k] = xv[i];
    }
  }
  for (int i = tid; i < 256 * 32 / 4; i += kEqThreads) {
    reinterpret_cast<int4*>(tab)[i] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();

  // 1. count, each lane in its own column
  int* col = tab + lane;
  if (in_regs) {
#pragma unroll
    for (int k = 0; k < kRegVecs; ++k) {
      if (k * threads + gtid < n_vec) count16(col, v[k]);
    }
  } else {
    for (long long i = gtid; i < n_vec; i += threads) count16(col, xv[i]);
  }
  for (long long i = n_vec * 16 + gtid; i < n; i += threads) {
    atomicAdd(&col[(int)x[i] << 5], 1);
  }
  __syncthreads();

  // four threads a bin sum eight columns each, rotated by the bin so
  // that the lanes of a warp read 32 different banks
  {
    const int bin = tid >> 2;
    const int quarter = tid & 3;
    int s = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s += tab[bin * 32 + ((quarter * 8 + (bin & 7) + j) & 31)];
    }
    s += __shfl_xor_sync(kFull, s, 1);
    s += __shfl_xor_sync(kFull, s, 2);
    if (quarter == 0) all[rank * 256 + bin] = s;
  }
  __syncthreads();

  // 2. this block's 256 counts go to every block, 16 bytes a store
  cluster.barrier_wait();
  for (int t = tid; t < blocks * 64; t += kEqThreads) {
    const int peer = t >> 6;
    const int at = rank * 64 + (t & 63);
    if (peer != rank) {
      reinterpret_cast<int4*>(cluster.map_shared_rank(all, peer))[at] =
          reinterpret_cast<const int4*>(all)[at];
    }
  }
  cluster.sync();  // barrier 2: every block holds every block's counts
  if (tid < 256) {
    int h = 0;
    for (int r = 0; r < blocks; ++r) h += all[r * 256 + tid];
    hist[tid] = h;
  }
  __syncthreads();

  // 3. CDF and LUT. Each of the first 8 warps scans all 256 bins in
  // registers (lane l holds bins 8l .. 8l+7) and writes the LUT of its
  // own 32 values.
  if (tid < 256) {
    const int4 a = reinterpret_cast<const int4*>(hist)[2 * lane];
    const int4 b = reinterpret_cast<const int4*>(hist)[2 * lane + 1];
    const int h[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    int c[8];
    int run = 0, j0 = 8, hj0 = 0;
#pragma unroll
    for (int j = 7; j >= 0; --j) {
      if (h[j] > 0) {
        j0 = j;
        hj0 = h[j];
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      run += h[j];
      c[j] = run;
    }
    int incl = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += t;
    }
    const int before = incl - run;
    int i0 = __reduce_min_sync(kFull, j0 < 8 ? 8 * lane + j0 : 256);
    if (i0 == 256) i0 = 0;  // an empty image
    const int h0 = __shfl_sync(kFull, hj0, i0 >> 3);
    // the CDF at value tid sits in lane (tid >> 3) & 31, element tid & 7
    int cdf = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int got = __shfl_sync(kFull, c[j] + before, (warp << 2) + (lane >> 3));
      if ((lane & 7) == j) cdf = got;
    }
    // the plain version's arithmetic: one float32 division, one float32
    // product, round half to even, clamp. Nothing precedes the first
    // non-empty bin, so the CDF there is its count.
    const int total = (int)n;
    const float scale = __fdiv_rn(255.0f, __int2float_rn(max(total - h0, 1)));
    const float rel = __int2float_rn(cdf - h0);
    int lut = (int)fminf(fmaxf(rintf(__fmul_rn(rel, scale)), 0.0f), 255.0f);
    if (tid <= i0) lut = 0;
    if (h0 == total) lut = tid;  // a constant image: the identity
    table[tid] = (uint8_t)lut;
  }
  __syncthreads();

  // 4. lookup
  if (in_regs) {
#pragma unroll
    for (int k = 0; k < kRegVecs; ++k) {
      const long long i = k * threads + gtid;
      if (i < n_vec) ov[i] = map16(table, v[k]);
    }
  } else {
    for (long long i = gtid; i < n_vec; i += threads) ov[i] = map16(table, xv[i]);
  }
  for (long long i = n_vec * 16 + gtid; i < n; i += threads) {
    out[i] = table[x[i]];
  }
}

__global__ void __launch_bounds__(kEqThreads) empty_kernel(int) {}

template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), int cluster_blocks, int smem_bytes,
                   cudaStream_t stream, Args... args) {
  if (cluster_blocks > 8) {
    // outside the portable range: more than 8 blocks a cluster, and with
    // 16 rows of counts more than 48 KB of shared memory
    cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster_blocks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster_blocks);
  config.blockDim = dim3(kEqThreads);
  config.dynamicSmemBytes = smem_bytes;
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&config, kernel, args...);
  return (int)(rc != cudaSuccess ? rc : cudaGetLastError());
}

}  // namespace

// The image must hold fewer than 2^31 pixels (int32 counts); cluster_blocks
// is 8 or 16 (the rows of counts divide among 1,024 threads as 64 a block).
extern "C" int slam_equalize256(const void* x, void* out, long long n,
                                int cluster_blocks, void* stream) {
  const int smem_bytes = equalize_smem_ints(cluster_blocks) * (int)sizeof(int);
  return launch_cluster(equalize256_kernel, cluster_blocks, smem_bytes,
                        (cudaStream_t)stream, (const uint8_t*)x, (uint8_t*)out, n,
                        vec_count(n, x, out));
}

extern "C" int slam_empty(int cluster_blocks, void* stream) {
  return launch_cluster(empty_kernel, cluster_blocks, 0, (cudaStream_t)stream, 0);
}

extern "C" int slam_hist256(const void* x, long long n, void* out,
                            void* stream) {
  const long long n_vec = vec_count(n, x, x);
  const int grid = grid_for(n_vec > 0 ? n_vec : n);
  hist256_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, n, n_vec, (int*)out);
  return (int)cudaGetLastError();
}

extern "C" int slam_lut256(const void* x, const void* lut, void* out,
                           long long n, void* stream) {
  const long long n_vec = vec_count(n, x, out);
  const int grid = grid_for(n_vec > 0 ? n_vec : n);
  lut256_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, (const float*)lut, (uint8_t*)out, n, n_vec);
  return (int)cudaGetLastError();
}
