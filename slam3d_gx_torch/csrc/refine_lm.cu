// The Levenberg-Marquardt polish of the PnP solve for Hopper (sm_90a), with
// a plain C interface loaded through ctypes (slam3d_gx_torch/kernels/refine_lm.py).
//
// slam_refine_lm replaces no TPU kernel: the JAX package runs this polish
//    (slam3d_gx_tpu/ops/pnp.py refine_pnp) as a jitted loop that XLA fuses.
//    Eagerly, PyTorch runs each of its iterations as some 640 small
//    operations (vmap(jacfwd) through Rodrigues' formula, a batched
//    J^T J, solve_ex, a second residual pass): ~6,400 a call at 10
//    iterations, ~2,900 of them device launches, and the host's issuing
//    of them was most of a frame's multiPnP. This kernel is the whole
//    polish in one launch.
//
//    The work, per problem: `iters` + 1 passes over N correspondences,
//    each a reprojection, its 2x6 Jacobian and 28 sums (the 21 entries of
//    J^T J on and above the diagonal, J^T r, r^T r), and a 6x6 solve
//    between passes. N is at most a few thousand, so the call is bound by
//    latency (block-wide reductions, barriers, a serial solve), not by
//    bytes or operations: 512 points are 12 KB read once.
//
//    Design:
//    - One block of 256 threads per problem (the leading batch G); the
//      threads stride over the N correspondences. A thread keeps its
//      first kRegPoints points in registers, read once; points past
//      kThreads * kRegPoints are read again from L2 on every pass.
//    - A pass at the trial point x + dx computes e_new and the J^T J and
//      J^T r of x + dx together. When the step is accepted these are the
//      next iteration's, which the plain version would compute again from
//      the same x; when it is refused the block keeps those of x. So an
//      iteration is one pass, and the sums depend on x alone.
//    - Sums: a thread's own points in index order, then a shuffle tree
//      in each warp, then warp 0 adds the 8 warps' sums in warp order.
//      The order is fixed, so a problem gives the same bits on every run.
//    - Warp 0 holds the state (x, lam, e; the accepted sums in shared
//      memory), and its lane 0 solves the damped 6x6 system by LU with
//      partial pivoting (the first largest pivot, as LAPACK's getrf),
//      rows swapped by selects, so that every index stays constant and
//      the system stays in registers. Lanes 0-3 of warp 0 then build the
//      rotation and its three derivatives at the trial point into shared
//      memory, which every thread reads on the next pass.
//    - Exactly `iters` iterations, no early exit; nothing allocated, no
//      synchronisation with the host.
//
//    Arithmetic: the plain version's objective and steps, in float32.
//    The residual is sqrt(w) * (projection - pixel) with the projection
//    divided by z where |z| > 1e-9 (else by 1e-9), and non-finite residuals
//    count as 0. The Jacobian is the forward derivative of that function
//    through Rodrigues' formula (theta = sqrt(theta2 + 1e-16), the series
//    below theta2 = 1e-8), term by term in the order of PyTorch's
//    forward-mode formulas (jacfwd): (sin theta)' = theta' cos theta,
//    (p / q)' = (p' - q' (p / q)) / q, (a K)' = K' a + a' K, and so on.
//    Every product and sum is an explicit round-to-nearest intrinsic and
//    every division and root IEEE, so nvcc contracts nothing into FMA,
//    and a division by a constant is a product with its rounded
//    reciprocal, as PyTorch divides by a scalar on the card. The sums
//    and the LU take another order than cuBLAS's bmm and the batched LU
//    behind solve_ex, so the two differ in last bits, and after a few
//    accepted steps by what those bits move in the iterate.
//
// The launch is on the caller's stream, allocates nothing and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRegPoints = 4;  // points a thread keeps in registers
constexpr int kH = 21;         // entries of J^T J on and above the diagonal
constexpr int kSums = kH + 6 + 1;  // J^T J, J^T r, r^T r
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// index of J^T J's entry (j, k), j <= k, among the 21 kept
__host__ __device__ constexpr int hidx(int j, int k) { return j * 6 - j * (j - 1) / 2 + (k - j); }

// The rotation at the trial point and its derivatives along the three
// axis-angle components: R and dR/dv_k, row-major.
struct Pose {
  float m[4][9];  // m[0] = R, m[1 + k] = dR/dv_k
  float t[3];
};

// Matrix `which` of Pose for the axis-angle v: lie.rodrigues,
// I + a K + b K K, and its forward derivative along v_{which - 1}.
__device__ __forceinline__ void rotation(const float v[3], int which, float out[9]) {
  const float inv6 = 1.0f / 6.0f, inv24 = 1.0f / 24.0f;  // PyTorch's scalar divisions
  const float theta2 = add(add(mul(v[0], v[0]), mul(v[1], v[1])), mul(v[2], v[2]));
  const float theta = __fsqrt_rn(add(theta2, 1e-16f));
  const bool big = theta2 > 1e-8f;
  const float s = sinf(theta), c = cosf(theta);
  const float a = big ? dvd(s, theta) : sub(1.0f, mul(theta2, inv6));
  const float b = big ? dvd(sub(1.0f, c), theta2) : sub(0.5f, mul(theta2, inv24));
  const float K[9] = {0.0f, -v[2], v[1], v[2], 0.0f, -v[0], -v[1], v[0], 0.0f};
  float KK[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      KK[i * 3 + j] = add(add(mul(K[i * 3], K[j]), mul(K[i * 3 + 1], K[3 + j])),
                          mul(K[i * 3 + 2], K[6 + j]));
  if (which == 0) {
#pragma unroll
    for (int i = 0; i < 9; ++i)
      out[i] = add(add(i % 4 == 0 ? 1.0f : 0.0f, mul(a, K[i])), mul(b, KK[i]));
    return;
  }
  const int k = which - 1;
  const float dt2 = mul(2.0f, k == 0 ? v[0] : (k == 1 ? v[1] : v[2]));  // (v . v)' along v_k
  const float dth = dvd(dt2, mul(2.0f, theta));
  const float da = big ? dvd(sub(mul(dth, c), mul(dth, a)), theta) : -mul(dt2, inv6);
  // (1 - cos theta)' = -(theta' * -sin theta)
  const float db = big ? dvd(sub(-mul(dth, -s), mul(dt2, b)), theta2) : -mul(dt2, inv24);
  float dK[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) dK[i] = 0.0f;
  // hat(e_k)
  if (k == 0) { dK[5] = -1.0f; dK[7] = 1.0f; }
  if (k == 1) { dK[2] = 1.0f; dK[6] = -1.0f; }
  if (k == 2) { dK[1] = -1.0f; dK[3] = 1.0f; }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      // (K K)' = K' K + K K'
      const float l = add(add(mul(dK[i * 3], K[j]), mul(dK[i * 3 + 1], K[3 + j])),
                          mul(dK[i * 3 + 2], K[6 + j]));
      const float r = add(add(mul(K[i * 3], dK[j]), mul(K[i * 3 + 1], dK[3 + j])),
                          mul(K[i * 3 + 2], dK[6 + j]));
      const int e = i * 3 + j;
      out[e] = add(add(mul(dK[e], a), mul(da, K[e])), add(mul(add(l, r), b), mul(db, KK[e])));
    }
}

struct Camera {
  float fx, fy, cx, cy;
};

// One correspondence's residuals and Jacobian rows at the pose P, added
// to the thread's sums s: J^T J (hidx), then J^T r, then r^T r.
__device__ __forceinline__ void accumulate(const Pose& P, const Camera& cam, float ox, float oy,
                                           float oz, float ix, float iy, float sw,
                                           float s[kSums]) {
  const float* R = P.m[0];
  const float px = add(add(add(mul(ox, R[0]), mul(oy, R[1])), mul(oz, R[2])), P.t[0]);
  const float py = add(add(add(mul(ox, R[3]), mul(oy, R[4])), mul(oz, R[5])), P.t[1]);
  const float pz = add(add(add(mul(ox, R[6]), mul(oy, R[7])), mul(oz, R[8])), P.t[2]);
  const bool zok = fabsf(pz) > 1e-9f;
  const float sz = zok ? pz : 1e-9f;
  const float qu = dvd(mul(px, cam.fx), sz);
  const float qv = dvd(mul(py, cam.fy), sz);
  float ru = mul(sub(add(qu, cam.cx), ix), sw);
  float rv = mul(sub(add(qv, cam.cy), iy), sw);
  const bool fu = isfinite(ru), fv = isfinite(rv);
  ru = fu ? ru : 0.0f;
  rv = fv ? rv : 0.0f;
  float ju[6], jv[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    float dpx, dpy, dpz;
    if (k < 3) {
      const float* D = P.m[1 + k];
      dpx = add(add(mul(ox, D[0]), mul(oy, D[1])), mul(oz, D[2]));
      dpy = add(add(mul(ox, D[3]), mul(oy, D[4])), mul(oz, D[5]));
      dpz = add(add(mul(ox, D[6]), mul(oy, D[7])), mul(oz, D[8]));
    } else {
      dpx = k == 3 ? 1.0f : 0.0f;
      dpy = k == 4 ? 1.0f : 0.0f;
      dpz = k == 5 ? 1.0f : 0.0f;
    }
    const float dsz = zok ? dpz : 0.0f;
    const float du = dvd(sub(mul(dpx, cam.fx), mul(dsz, qu)), sz);
    const float dv = dvd(sub(mul(dpy, cam.fy), mul(dsz, qv)), sz);
    ju[k] = fu ? mul(du, sw) : 0.0f;
    jv[k] = fv ? mul(dv, sw) : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) {
#pragma unroll
    for (int k = j; k < 6; ++k) {
      float& h = s[hidx(j, k)];
      h = add(add(h, mul(ju[j], ju[k])), mul(jv[j], jv[k]));
    }
    s[kH + j] = add(add(s[kH + j], mul(ju[j], ru)), mul(jv[j], rv));
  }
  s[kSums - 1] = add(add(s[kSums - 1], mul(ru, ru)), mul(rv, rv));
}

// Solves (H + lam (diag(H) + 1e-9) I) dx = -g by LU with partial pivoting:
// the first row of largest magnitude in the column, as getrf picks it.
__device__ __forceinline__ void damped_solve(const float* sums, float lam, float dx[6]) {
  float A[6][6], b[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) A[i][j] = sums[i <= j ? hidx(i, j) : hidx(j, i)];
    A[i][i] = add(A[i][i], mul(lam, add(A[i][i], 1e-9f)));
    b[i] = -sums[kH + i];
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float best = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float m = fabsf(A[i][k]);
      if (m > best) {
        best = m;
        p = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (p == i) {  // swap rows k and i by selects: the indices stay constant
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const float t = A[k][j];
          A[k][j] = A[i][j];
          A[i][j] = t;
        }
        const float t = b[k];
        b[k] = b[i];
        b[i] = t;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float l = dvd(A[i][k], A[k][k]);
#pragma unroll
      for (int j = k + 1; j < 6; ++j) A[i][j] = sub(A[i][j], mul(l, A[k][j]));
      b[i] = sub(b[i], mul(l, b[k]));
    }
  }
#pragma unroll
  for (int k = 5; k >= 0; --k) {
    dx[k] = dvd(b[k], A[k][k]);
#pragma unroll
    for (int i = 0; i < k; ++i) b[i] = sub(b[i], mul(A[i][k], dx[k]));
  }
}

__global__ void __launch_bounds__(kThreads)
refine_lm_kernel(const float* __restrict__ rvec, const float* __restrict__ tvec,
                 const float* __restrict__ obj, const float* __restrict__ img,
                 const float* __restrict__ w, float* __restrict__ out, int N, int iters,
                 Camera cam) {
  __shared__ Pose pose;
  __shared__ float trial[6];              // x + dx, the point of the coming pass
  __shared__ float warp_sums[kWarps][kSums];
  __shared__ float sums_x[kSums];         // the sums at x, the accepted point

  const int g = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  obj += (size_t)g * N * 3;
  img += (size_t)g * N * 2;
  w += (size_t)g * N;

  float o[kRegPoints][3], im[kRegPoints][2], sw[kRegPoints];
#pragma unroll
  for (int r = 0; r < kRegPoints; ++r) {
    const int i = tid + r * kThreads;
    const bool in = i < N;
    o[r][0] = in ? obj[i * 3] : 0.0f;
    o[r][1] = in ? obj[i * 3 + 1] : 0.0f;
    o[r][2] = in ? obj[i * 3 + 2] : 0.0f;
    im[r][0] = in ? img[i * 2] : 0.0f;
    im[r][1] = in ? img[i * 2 + 1] : 0.0f;
    sw[r] = in ? __fsqrt_rn(w[i]) : 0.0f;
  }

  // warp 0's state, the same in each of its lanes: x, lam, e
  float x[6], lam = 1e-3f, e = 0.0f;
  if (tid < 6) trial[tid] = tid < 3 ? rvec[g * 3 + tid] : tvec[g * 3 + tid - 3];

  for (int it = 0; it <= iters; ++it) {
    // the pose at the trial point: lanes 0-3 of warp 0 build one matrix each
    if (warp == 0) {
      __syncwarp();
      const float v[3] = {trial[0], trial[1], trial[2]};
      float m[9];
      if (lane < 4) {
        rotation(v, lane, m);
#pragma unroll
        for (int i = 0; i < 9; ++i) pose.m[lane][i] = m[i];
      } else if (lane < 7) {
        pose.t[lane - 4] = trial[lane - 1];
      }
    }
    __syncthreads();

    float s[kSums];
#pragma unroll
    for (int j = 0; j < kSums; ++j) s[j] = 0.0f;
#pragma unroll
    for (int r = 0; r < kRegPoints; ++r)
      if (tid + r * kThreads < N)
        accumulate(pose, cam, o[r][0], o[r][1], o[r][2], im[r][0], im[r][1], sw[r], s);
    for (int i = tid + kRegPoints * kThreads; i < N; i += kThreads)
      accumulate(pose, cam, obj[i * 3], obj[i * 3 + 1], obj[i * 3 + 2], img[i * 2],
                 img[i * 2 + 1], __fsqrt_rn(w[i]), s);
#pragma unroll
    for (int j = 0; j < kSums; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s[j] = add(s[j], __shfl_down_sync(kFull, s[j], off));
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kSums; ++j) warp_sums[warp][j] = s[j];
    }
    __syncthreads();
    if (warp != 0) continue;  // the next pass's __syncthreads waits for warp 0

    // lane j < kSums: sum j at the trial point, over the warps in order
    float t = 0.0f;
    if (lane < kSums) {
      t = warp_sums[0][lane];
#pragma unroll
      for (int k = 1; k < kWarps; ++k) t = add(t, warp_sums[k][lane]);
    }
    const float e_new = __shfl_sync(kFull, t, kSums - 1);
    // the start's sums are taken; a trial's only when its objective is lower
    const bool take = it == 0 || e_new < e;
    if (it > 0) lam = take ? mul(lam, 0.5f) : mul(lam, 4.0f);
    if (take) {
      e = e_new;
#pragma unroll
      for (int j = 0; j < 6; ++j) x[j] = trial[j];
      if (lane < kSums) sums_x[lane] = t;
    }
    __syncwarp();
    if (lane == 0) {
      if (it < iters) {
        float dx[6];
        damped_solve(sums_x, lam, dx);
#pragma unroll
        for (int j = 0; j < 6; ++j) trial[j] = add(x[j], dx[j]);
      } else {
#pragma unroll
        for (int j = 0; j < 6; ++j) out[g * 6 + j] = x[j];
      }
    }
  }
}

}  // namespace

// rvec, tvec: (G, 3); obj: (G, N, 3); img: (G, N, 2); w: (G, N); out: (G, 6),
// the polished (rvec, tvec) of each problem. All float32, contiguous, on
// the current device. G >= 1, N >= 0, iters >= 1.
extern "C" int slam_refine_lm(const void* rvec, const void* tvec, const void* obj,
                              const void* img, const void* w, void* out, int G, int N,
                              int iters, float fx, float fy, float cx, float cy, void* stream) {
  if (G < 1 || N < 0 || iters < 1) return (int)cudaErrorInvalidValue;
  refine_lm_kernel<<<G, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)rvec, (const float*)tvec, (const float*)obj, (const float*)img,
      (const float*)w, (float*)out, N, iters, Camera{fx, fy, cx, cy});
  return (int)cudaGetLastError();
}
