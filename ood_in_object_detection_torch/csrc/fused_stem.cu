// Fused inference stem (kernel K4): the first two k3/s2 Conv+BN+SiLU blocks
// of a YOLOv8 backbone in one kernel, the conv1 map never leaving the SM.
//
//   h1  = silu(conv1(x) * inv1 + shift1)        (B, C1, H/2, W/2), rounded to T
//   out = silu(conv2(h1) * inv2 + shift2)       (B, C2, H/4, W/4) in T
//
// Replaces ood_in_object_detection_tpu/ops/pallas/stem.py:pallas_stem
// (_stem_kernel), which runs the same two convs as MXU matmuls over a
// space-to-depth image in a union-tap layout. This kernel computes the
// function, not that layout: one block per (image, 8x8 output tile) stages
// the 35x35x3 image patch the tile needs, computes the 17x17xC1 conv1 tile
// into shared memory, and contracts it with the folded conv2 weights for
// all C2 output channels, so conv1 is computed once per tile.
//
// Numerics are pallas_stem's: BN is folded into the weights in f32 by the
// wrapper (ops/stem.py:k4_weights), which also rounds the folded weights to
// T; products and sums are f32 (a bf16 x bf16 product is exact in f32), bias
// and SiLU in f32, the conv1 tile rounded to T (stem.py:151). conv2's zero
// padding is zeros in h1 (conv1 cells at row or column -1 or past H/2, W/2
// are 0, not silu(shift1)); the image's own padding is zeros.
//
// What bounds it on an H100: yolov8l at 640 px, batch 8, does 33 GFLOP
// (conv2 30.2, conv1 2.8) against ~145 MB of f32 traffic, so the work is
// compute-bound at either precision. This is a CUDA-core version with
// register tiling: in conv2 each thread holds 4 pixels x 8 output channels
// (32 accumulators) and per tap reads 4 h1 values from shared memory and
// its 8 weights as two float4 loads that every lane of a half-warp shares;
// in conv1 each thread reads a cell's 27 image values once for 4 channels.
// The conv1 halo (17^2 cells for 8^2 outputs) costs 13 % extra conv1 work.
// wgmma and TMA are a later version's work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 8;                // output pixels per tile side
constexpr int kH1 = 2 * kTile + 1;      // conv1 cells per tile side (17)
constexpr int kCells = kH1 * kH1;       // conv1 cells per tile (289)
constexpr int kImg = 4 * kTile + 3;     // image cells per tile side (35)
constexpr int kPx = 4;                  // output pixels per thread (along x)
constexpr int kCo = 8;                  // output channels per thread
constexpr int kPixelGroups = kTile * kTile / kPx;  // 16
constexpr int kMaxC2 = 160;
constexpr int kMaxThreads = kPixelGroups * kMaxC2 / kCo;  // 320

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// block = 2 * C2 threads (16 pixel groups x C2/8 channel groups)
template <typename T>
__global__ void __launch_bounds__(kMaxThreads) fused_stem_kernel(
    const T* __restrict__ x,       // (B, 3, H, W)
    const float* __restrict__ w1,  // (27, C1) folded, row (ci, dy, dx)
    const float* __restrict__ b1,  // (C1)
    const float* __restrict__ w2,  // (C1, 9, C2) folded
    const float* __restrict__ b2,  // (C2)
    int H, int W, int C1, int C2, int tiles_x, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sw1 = reinterpret_cast<float*>(smem_raw);  // [27][C1]
  float* sb1 = sw1 + 27 * C1;                        // [C1]
  float* img = sb1 + C1;                             // [3][35][35]
  T* h1 = reinterpret_cast<T*>(img + 3 * kImg * kImg);  // [C1][17][17]

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;
  const int oy0 = (blockIdx.x / tiles_x) * kTile, ox0 = (blockIdx.x % tiles_x) * kTile;
  const int b = blockIdx.y;
  const int iy0 = 4 * oy0 - 3, ix0 = 4 * ox0 - 3;  // image origin of the patch
  const int ry0 = 2 * oy0 - 1, rx0 = 2 * ox0 - 1;  // conv1 origin of the tile

  const T* xb = x + static_cast<size_t>(b) * 3 * H * W;
  for (int i = tid; i < 3 * kImg * kImg; i += nthreads) {
    const int c = i / (kImg * kImg), r = (i / kImg) % kImg, q = i % kImg;
    const int gy = iy0 + r, gx = ix0 + q;
    img[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                 ? to_f32(xb[(static_cast<size_t>(c) * H + gy) * W + gx])
                 : 0.0f;
  }
  for (int i = tid; i < 27 * C1; i += nthreads) sw1[i] = w1[i];
  for (int i = tid; i < C1; i += nthreads) sb1[i] = b1[i];
  __syncthreads();

  // conv1 + BN + SiLU on the 17x17 tile, 4 channels per item; cells outside
  // the conv1 map are conv2's zero padding
  const float4* sw1v = reinterpret_cast<const float4*>(sw1);
  const int g1 = C1 / 4;
  for (int i = tid; i < g1 * kCells; i += nthreads) {
    const int g = i / kCells, cell = i % kCells, r = cell / kH1, q = cell % kH1;
    const int gy = ry0 + r, gx = rx0 + q;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (gy >= 0 && gy < H2 && gx >= 0 && gx < W2) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int ci = 0; ci < 3; ++ci)
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float xv = img[(ci * kImg + 2 * r + dy) * kImg + 2 * q + dx];
            const float4 wv = sw1v[((ci * 3 + dy) * 3 + dx) * g1 + g];
            acc[0] = fmaf(xv, wv.x, acc[0]);
            acc[1] = fmaf(xv, wv.y, acc[1]);
            acc[2] = fmaf(xv, wv.z, acc[2]);
            acc[3] = fmaf(xv, wv.w, acc[3]);
          }
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = silu(acc[k] + sb1[4 * g + k]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) h1[(4 * g + k) * kCells + cell] = from_f32<T>(v[k]);
  }
  __syncthreads();

  // conv2 + BN + SiLU: thread = (4 pixels along x, 8 channels)
  const int pg = tid % kPixelGroups, cg = tid / kPixelGroups;
  const int py = pg / (kTile / kPx), px0 = (pg % (kTile / kPx)) * kPx;
  float acc[kPx][kCo];
#pragma unroll
  for (int k = 0; k < kPx; ++k)
#pragma unroll
    for (int j = 0; j < kCo; ++j) acc[k][j] = 0.0f;
  const float* wg = w2 + cg * kCo;
  for (int c = 0; c < C1; ++c) {
    const T* hc = h1 + c * kCells + (2 * py) * kH1 + 2 * px0;
    const float* wc = wg + static_cast<size_t>(c) * 9 * C2;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float4* wv = reinterpret_cast<const float4*>(wc + (dy * 3 + dx) * C2);
        const float4 a = __ldg(wv), e = __ldg(wv + 1);
        const float wr[kCo] = {a.x, a.y, a.z, a.w, e.x, e.y, e.z, e.w};
#pragma unroll
        for (int k = 0; k < kPx; ++k) {
          const float hv = to_f32(hc[dy * kH1 + dx + 2 * k]);
#pragma unroll
          for (int j = 0; j < kCo; ++j) acc[k][j] = fmaf(hv, wr[j], acc[k][j]);
        }
      }
  }
  const int oy = oy0 + py;
  if (oy >= H4) return;
#pragma unroll
  for (int j = 0; j < kCo; ++j) {
    const int co = cg * kCo + j;
    const float bias = b2[co];
    T* orow = out + ((static_cast<size_t>(b) * C2 + co) * H4 + oy) * W4;
#pragma unroll
    for (int k = 0; k < kPx; ++k) {
      const int ox = ox0 + px0 + k;
      if (ox < W4) orow[ox] = from_f32<T>(silu(acc[k][j] + bias));
    }
  }
}

template <typename T>
int launch(const void* x, const float* w1, const float* b1, const float* w2, const float* b2,
           int batch, int H, int W, int C1, int C2, void* out, cudaStream_t s) {
  const int tiles_y = (H / 4 + kTile - 1) / kTile, tiles_x = (W / 4 + kTile - 1) / kTile;
  const size_t smem = (28 * static_cast<size_t>(C1) + 3 * kImg * kImg) * sizeof(float) +
                      static_cast<size_t>(C1) * kCells * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(fused_stem_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(tiles_y * tiles_x), static_cast<unsigned>(batch));
  const int threads = kPixelGroups * C2 / kCo;
  fused_stem_kernel<T><<<grid, threads, smem, s>>>(static_cast<const T*>(x), w1, b1, w2, b2, H,
                                                   W, C1, C2, tiles_x, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x and out are float (bf16 == 0) or __nv_bfloat16 (bf16 != 0) tensors
extern "C" int fused_stem_launch(const void* x, const float* w1, const float* b1,
                                 const float* w2, const float* b2, int batch, int H, int W,
                                 int C1, int C2, int bf16, void* out, void* stream) {
  if (batch <= 0 || H <= 0 || W <= 0) return 0;
  if (H % 4 || W % 4 || C1 <= 0 || C1 % 8 || C1 > 128 || C2 <= 0 || C2 % kCo || C2 > kMaxC2 ||
      batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, w1, b1, w2, b2, batch, H, W, C1, C2, out, s)
              : launch<float>(x, w1, b1, w2, b2, batch, H, W, C1, C2, out, s);
}

extern "C" const char* fused_stem_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
