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
// Both launch on the caller's stream, allocate nothing and return
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

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
