// Minimum distance from each feature row to each centroid group (kernel K3).
//
//   out[n, g] = min over k with kmask[g, k] of dist(x[n], c[g, k])
//   cosine: 1 - x . c            (rows already L2-normalised by the caller)
//   l2:     sqrt(max(|x|^2 + |c|^2 - 2 x . c, 0))
//   a group with no valid centroid gives +inf.
//
// Replaces ood_in_object_detection_tpu/ops/pallas/distance.py:
// min_group_distances_pallas (_cosl2_kernel), which forms the (128, G*K)
// dot tile on the MXU and min-reduces it over K in VMEM so that the (N, G*K)
// matrix never reaches HBM.
//
// What bounds it on an H100: 2 * N * G * K * D flops against N * D + G * K * D
// floats read; for the eval path (N = batch * 300, D = 512, G = 3 * nc, K = 1)
// that is a few hundred MFLOP, far below the card's rates, so launch and
// read latency dominate. Design: grid (row tiles, groups); a block stages
// its group's K centroids (and their squared norms) in shared memory; each
// warp owns rows, takes every dot product as a lane-strided sum plus a warp
// shuffle reduction, and keeps the running minimum over K in a register.
// Only the (N, G) minima are written.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerBlock = 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <bool kL2>
__global__ void min_group_kernel(const float* __restrict__ x, const float* __restrict__ cents,
                                 const uint8_t* __restrict__ kmask, int N, int G, int K, int D,
                                 float* __restrict__ out) {
  extern __shared__ float smem[];
  float* sc = smem;              // K * D centroids of this group
  float* cnorm = smem + K * D;   // K squared norms (l2 only)
  const int g = blockIdx.y;
  const float* cg = cents + static_cast<size_t>(g) * K * D;
  for (int i = threadIdx.x; i < K * D; i += blockDim.x) sc[i] = cg[i];
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  if (kL2) {
    for (int kk = warp; kk < K; kk += nwarps) {
      float s = 0.0f;
      for (int d = lane; d < D; d += 32) s = fmaf(sc[kk * D + d], sc[kk * D + d], s);
      s = warp_sum(s);
      if (lane == 0) cnorm[kk] = s;
    }
    __syncthreads();
  }
  const uint8_t* gm = kmask + static_cast<size_t>(g) * K;
  const int row0 = blockIdx.x * kRowsPerBlock;
  for (int r = warp; r < kRowsPerBlock; r += nwarps) {
    const int n = row0 + r;
    if (n >= N) break;  // uniform over the warp
    const float* xr = x + static_cast<size_t>(n) * D;
    float xx = 0.0f;
    if (kL2) {
      for (int d = lane; d < D; d += 32) xx = fmaf(xr[d], xr[d], xx);
      xx = warp_sum(xx);
    }
    float best = INFINITY;
    for (int kk = 0; kk < K; ++kk) {
      if (!gm[kk]) continue;
      float dot = 0.0f;
      for (int d = lane; d < D; d += 32) dot = fmaf(xr[d], sc[kk * D + d], dot);
      dot = warp_sum(dot);
      const float dist = kL2 ? sqrtf(fmaxf(xx + cnorm[kk] - 2.0f * dot, 0.0f)) : 1.0f - dot;
      best = fminf(best, dist);
    }
    if (lane == 0) out[static_cast<size_t>(n) * G + g] = best;
  }
}

}  // namespace

extern "C" int min_group_distance_launch(const float* x, const float* cents,
                                         const uint8_t* kmask, int N, int G, int K, int D,
                                         int metric_l2, float* out, void* stream) {
  if (N <= 0 || G <= 0) return 0;
  const size_t smem = (static_cast<size_t>(K) * D + K) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kRowsPerBlock - 1) / kRowsPerBlock, G);
  cudaError_t err;
  if (metric_l2) {
    err = cudaFuncSetAttribute(min_group_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    min_group_kernel<true><<<grid, kThreads, smem, s>>>(x, cents, kmask, N, G, K, D, out);
  } else {
    err = cudaFuncSetAttribute(min_group_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    min_group_kernel<false><<<grid, kThreads, smem, s>>>(x, cents, kmask, N, G, K, D, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* min_group_distance_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
