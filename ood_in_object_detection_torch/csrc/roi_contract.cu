// Separable RoI / exact-position contraction over one level map (kernel K2).
//
//   out[b, n, c] = sum_h sum_w wy[b, n, h] * wx[b, n, w] * f[b, h, w, c]
//
// Replaces ood_in_object_detection_tpu/ops/pallas/roi.py:
// roi_matmul_level_two_stage (_two_stage_kernel), which forms the same sum
// as three MXU dots so that the (N2, H*W) weight matrix Q = outer(wy, wx)
// never exists in memory. Rows are 1x1 RoIAlign bilinear hats (non-zero over
// ceil(span) + 2 cells per axis) and one-hot exact-position taps (one cell).
//
// What bounds it on an H100: the dense product is 2 * N2 * H * W * C flops
// (P3 of yolov8l at 640 px, batch 8: 2 * 4800 * 6400 * 256 = 16 GFLOP), but
// almost all of Q is zero. This kernel never forms Q: one block per row
// stages the row's two axis-weight vectors in shared memory, finds their
// non-zero support with warp ballots, and sums only over the support
// rectangle. The work per row is then span_h * span_w * C multiply-adds,
// and the feature reads are the bound: threads walk the channel axis, so
// every read of a cell's C features is coalesced (NHWC layout).
//
// The products wy[h] * wx[w] are rounded to f32 before the multiply-add,
// as in the plain version's Q, so only the summation order differs.
//
// bf16 maps (the --bf16 path) take the contract of ops/pallas/roi.py:
// roi_matmul_level_pallas, store and expand variants (_q_dot_kernel,
// _q_dot_kernel_expand) and of the JAX package's XLA branch
// (ops/roi_align.py:307-311): Q = wy * wx is formed in f32 and rounded to
// bf16, each term bf16(Q) * f is exact in f32, and the sum is f32. The
// one-hot exact-tap rows stay exact (bf16(1 * 1) = 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kThreads = 128;

// Q's entry as the map type rounds it, and a map value, both in f32
__device__ __forceinline__ float q_as(float q, const float*) { return q; }
__device__ __forceinline__ float q_as(float q, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(q));
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// first and last index of a non-zero entry of v[0..n), by warp ballots
__device__ __forceinline__ void support(const float* v, int n, int lane, int* lo, int* hi) {
  int l = INT_MAX, h = -1;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const unsigned m = __ballot_sync(0xffffffffu, i < n && v[i] != 0.0f);
    if (m) {
      l = min(l, base + __ffs(m) - 1);
      h = max(h, base + 31 - __clz(m));
    }
  }
  *lo = l;
  *hi = h;
}

template <typename T>
__global__ void roi_contract_kernel(const T* __restrict__ fmap,
                                    const float* __restrict__ wx,
                                    const float* __restrict__ wy, int H, int W, int C,
                                    int n2, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* sx = smem;      // W
  float* sy = smem + W;  // H
  __shared__ int span[4];
  const size_t row = blockIdx.x;  // b * n2 + n
  const int b = static_cast<int>(row / n2);
  const float* rx = wx + row * W;
  const float* ry = wy + row * H;
  for (int i = threadIdx.x; i < W; i += blockDim.x) sx[i] = rx[i];
  for (int i = threadIdx.x; i < H; i += blockDim.x) sy[i] = ry[i];
  __syncthreads();
  if (threadIdx.x < 32) {
    int wlo, whi, hlo, hhi;
    support(sx, W, threadIdx.x, &wlo, &whi);
    support(sy, H, threadIdx.x, &hlo, &hhi);
    if (threadIdx.x == 0) {
      span[0] = wlo;
      span[1] = whi;
      span[2] = hlo;
      span[3] = hhi;
    }
  }
  __syncthreads();
  const int wlo = span[0], whi = span[1], hlo = span[2], hhi = span[3];
  const T* fb = fmap + static_cast<size_t>(b) * H * W * C;
  float* o = out + row * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc = 0.0f;
    for (int h = hlo; h <= hhi; ++h) {
      const float y = sy[h];
      const T* fr = fb + static_cast<size_t>(h) * W * C + c;
      for (int w = wlo; w <= whi; ++w) {
        acc = fmaf(q_as(__fmul_rn(y, sx[w]), fr), to_f32(fr[static_cast<size_t>(w) * C]), acc);
      }
    }
    o[c] = acc;
  }
}

}  // namespace

// fmap is float (bf16 == 0) or __nv_bfloat16 (bf16 != 0); wx, wy, out are f32
extern "C" int roi_contract_launch(const void* fmap, const float* wx, const float* wy,
                                   int batch, int H, int W, int C, int n2, int bf16,
                                   float* out, void* stream) {
  if (batch <= 0 || n2 <= 0 || C <= 0) return 0;
  const size_t rows = static_cast<size_t>(batch) * n2;
  if (rows > static_cast<size_t>(INT_MAX)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(W + H) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    roi_contract_kernel<<<static_cast<unsigned>(rows), kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(fmap), wx, wy, H, W, C, n2, out);
  } else {
    roi_contract_kernel<<<static_cast<unsigned>(rows), kThreads, smem, s>>>(
        static_cast<const float*>(fmap), wx, wy, H, W, C, n2, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* roi_contract_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
