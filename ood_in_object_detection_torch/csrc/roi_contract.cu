// Separable RoI / exact-position contraction over one level map (kernel K2).
//
//   out[b, n, c] = sum_h sum_w q(wy[b, n, h] * wx[b, n, w]) * f[b, h, w, c]
//
// q is the identity for f32 maps and the rounding to bf16 for bf16 maps; the
// product wy * wx is rounded to f32 first, each term q * f is exact in f32,
// and the sums are f32.
//
// Replaces ood_in_object_detection_tpu/ops/pallas/roi.py:
// roi_matmul_level_two_stage (_two_stage_kernel, f32 maps), which forms the
// same sum as three MXU dots so that the (N2, H*W) weight matrix Q =
// outer(wy, wx) never exists in memory, and roi_matmul_level_pallas, store
// and expand variants (_q_dot_kernel, _q_dot_kernel_expand, bf16 maps), and
// the JAX package's XLA branch (ops/roi_align.py:307-311): Q = wy * wx
// formed in f32 and rounded to bf16, f32 sums. Rows are 1x1 RoIAlign
// bilinear hats (non-zero over ceil(span) + 2 cells per axis) and one-hot
// exact-position taps (one cell, bf16(1 * 1) = 1, so they stay exact). A
// row whose result this level does not supply is all zeros.
//
// What bounds it on an H100: bytes. Almost all of Q is zero, so the work is
// the support rectangle of each row: span_h * span_w cells of C features,
// one multiply-add per feature, read once per row through L2, plus wx, wy
// and out. That is a stream of cells with no reuse inside a row, so tensor
// cores have nothing to do; what costs is load instructions and latency.
//
// Design:
// - A block of 8 warps serves 4 consecutive rows. Warp r < 4 stages row r's
//   wx and wy in shared memory and finds their non-zero support with warp
//   ballots. A row of at most 16 cells (an exact tap is 1; a row of another
//   level, 0) is then summed by that warp alone, with no block barrier.
// - The block's 8 warps take each larger row in turn and stride over the
//   cells of its support rectangle; their partial sums meet in shared
//   memory and are added in warp order, so the result does not depend on
//   scheduling (no atomics).
// - q(wy[h] * wx[w]) is computed once per cell by the warp (one instruction
//   for all lanes), not once per channel.
// - A lane loads 8 consecutive bf16 channels (16 bytes) or 4 f32 channels
//   per instruction, and holds up to 4 such vectors, so one pass covers
//   C = 512 in bf16 and f32. Where C, or the map's base address, does not
//   allow 16-byte loads the wrapper asks for the scalar path: one channel
//   per load.
// - A warp issues 8 loads (8 cells of one vector, ..., 2 cells of four)
//   before their multiply-adds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;            // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 4;             // rows per block, one scanning warp each
constexpr int kSoloCells = 16;       // a row this small is summed by its scanning warp alone
constexpr int kMaxCells = 1 << 20;   // H * W: the float row/column split is exact below it

// Q's entry as the map type rounds it, in f32
__device__ __forceinline__ float q_as(float q, const float*) { return q; }
__device__ __forceinline__ float q_as(float q, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(q));
}

// V consecutive channels of one cell as f32: the vector types and their loads
template <typename T, int V> struct Vec;
template <> struct Vec<float, 1> {
  using type = float;
  static __device__ __forceinline__ type load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void fma(float q, type v, float* acc) {
    acc[0] = fmaf(q, v, acc[0]);
  }
};
template <> struct Vec<__nv_bfloat16, 1> {
  using type = __nv_bfloat16;
  static __device__ __forceinline__ type load(const __nv_bfloat16* p) { return __ldg(p); }
  static __device__ __forceinline__ void fma(float q, type v, float* acc) {
    acc[0] = fmaf(q, __bfloat162float(v), acc[0]);
  }
};
template <> struct Vec<float, 4> {
  using type = float4;
  static __device__ __forceinline__ type load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void fma(float q, type v, float* acc) {
    acc[0] = fmaf(q, v.x, acc[0]);
    acc[1] = fmaf(q, v.y, acc[1]);
    acc[2] = fmaf(q, v.z, acc[2]);
    acc[3] = fmaf(q, v.w, acc[3]);
  }
};
template <> struct Vec<__nv_bfloat16, 8> {
  using type = uint4;
  static __device__ __forceinline__ type load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  // a bf16 is the high half of its f32
  static __device__ __forceinline__ void fma2(float q, unsigned u, float* acc) {
    acc[0] = fmaf(q, __uint_as_float(u << 16), acc[0]);
    acc[1] = fmaf(q, __uint_as_float(u & 0xffff0000u), acc[1]);
  }
  static __device__ __forceinline__ void fma(float q, type v, float* acc) {
    fma2(q, v.x, acc);
    fma2(q, v.y, acc + 2);
    fma2(q, v.z, acc + 4);
    fma2(q, v.w, acc + 6);
  }
};

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

// Sum q(wy[h] wx[w]) f[h, w, c..] over cells k0, k0 + stride, ... < ncell
// of a row's support rectangle (k = i sw + j -> h = hlo + i, w = wlo + j)
// into acc: NV vectors of V channels per lane, lane's vector v at channel
// c + 32 V v; U cells' loads are issued before their multiply-adds.
template <typename T, int V, int NV, int U>
__device__ __forceinline__ void accumulate(const T* __restrict__ fc, const float* sx,
                                           const float* sy, int W, int C, int c, int hlo,
                                           int wlo, int sw, int ncell, int k0, int stride,
                                           float (&acc)[NV][V]) {
  using VT = Vec<T, V>;
  const float inv_sw = 1.0f / static_cast<float>(sw);
  for (; k0 < ncell; k0 += stride * U) {
    float q[U];
    typename VT::type val[U][NV];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * stride;
      q[u] = 0.0f;
      if (k < ncell) {
        // (k + 0.5) / sw lies >= 0.5 / sw from an integer: exact for k < 2^20
        const int i = static_cast<int>((static_cast<float>(k) + 0.5f) * inv_sw);
        const int h = hlo + i, w = wlo + (k - i * sw);
        q[u] = q_as(__fmul_rn(sy[h], sx[w]), fc);
        const T* cell = fc + (static_cast<size_t>(h) * W + w) * C;
#pragma unroll
        for (int v = 0; v < NV; ++v)
          if (c + 32 * V * v < C) val[u][v] = VT::load(cell + 32 * V * v);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (k0 + u * stride < ncell) {
#pragma unroll
        for (int v = 0; v < NV; ++v)
          if (c + 32 * V * v < C) VT::fma(q[u], val[u][v], acc[v]);
      }
  }
}

// V channels per lane: 8 (bf16) or 4 (f32) for 16-byte loads, 1 for the
// scalar path; NV such vectors per lane, so a pass covers 32 V NV channels
// (wider maps loop over passes).
template <typename T, int V, int NV>
__global__ void __launch_bounds__(kThreads) roi_contract_kernel(
    const T* __restrict__ fmap, const float* __restrict__ wx, const float* __restrict__ wy,
    int H, int W, int C, int n2, int rows, float* __restrict__ out) {
  constexpr int kPass = 32 * V * NV;       // channels per pass
  constexpr int kU = NV >= 4 ? 2 : 8 / NV;  // cells in flight per warp: 8 loads
  extern __shared__ float smem[];
  float* sxy = smem;                       // [kRows][W + H]: wx then wy of each row
  float* red = smem + kRows * (W + H);     // [kWarps][kPass] partial sums
  __shared__ int span[kRows][4];           // wlo, hlo, sw, sh; sw = 0: nothing to do

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kRows;

  // warp r < kRows: stage row r's axis weights, find their support, and
  // finish the row alone if it is small (an exact tap is one cell, a row of
  // another level none: its output is zeros)
  if (warp < kRows) {
    const int row = row0 + warp;
    float* sx = sxy + warp * (W + H);
    float* sy = sx + W;
    int wlo = INT_MAX, whi = -1, hlo = INT_MAX, hhi = -1;
    if (row < rows) {
      const float* rx = wx + static_cast<size_t>(row) * W;
      const float* ry = wy + static_cast<size_t>(row) * H;
      for (int i = lane; i < W; i += 32) sx[i] = __ldg(rx + i);
      for (int i = lane; i < H; i += 32) sy[i] = __ldg(ry + i);
      __syncwarp();
      support(sx, W, lane, &wlo, &whi);
      support(sy, H, lane, &hlo, &hhi);
    }
    const int sw = max(whi - wlo + 1, 0), sh = max(hhi - hlo + 1, 0);
    const bool solo = row < rows && sw * sh <= kSoloCells;
    if (solo) {
      const T* fb = fmap + static_cast<size_t>(row / n2) * H * W * C;
      float* o = out + static_cast<size_t>(row) * C;
      for (int c0 = 0; c0 < C; c0 += kPass) {
        const int c = c0 + lane * V;
        float acc[NV][V] = {};
        accumulate<T, V, NV, kU>(fb + c, sx, sy, W, C, c, hlo, wlo, sw, sw * sh, 0, 1, acc);
#pragma unroll
        for (int v = 0; v < NV; ++v)
#pragma unroll
          for (int e = 0; e < V; ++e)
            if (c + 32 * V * v + e < C) o[c + 32 * V * v + e] = acc[v][e];
      }
    }
    if (lane == 0) {
      span[warp][0] = wlo;
      span[warp][1] = hlo;
      span[warp][2] = solo ? 0 : sw;
      span[warp][3] = sh;
    }
  }
  __syncthreads();

  // the block's 8 warps on each larger row in turn; partial sums added in
  // warp order
  for (int r = 0; r < kRows && row0 + r < rows; ++r) {
    const int wlo = span[r][0], hlo = span[r][1], sw = span[r][2], sh = span[r][3];
    if (sw == 0) continue;  // done alone above
    const int row = row0 + r;
    float* o = out + static_cast<size_t>(row) * C;
    const float* sx = sxy + r * (W + H);
    const float* sy = sx + W;
    const T* fb = fmap + static_cast<size_t>(row / n2) * H * W * C;
    for (int c0 = 0; c0 < C; c0 += kPass) {
      const int c = c0 + lane * V;
      float acc[NV][V] = {};
      accumulate<T, V, NV, kU>(fb + c, sx, sy, W, C, c, hlo, wlo, sw, sw * sh, warp, kWarps,
                               acc);
      float* rw = red + warp * kPass + lane * V;
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int e = 0; e < V; ++e) rw[32 * V * v + e] = acc[v][e];
      __syncthreads();
      for (int t = threadIdx.x; t < kPass && c0 + t < C; t += kThreads) {
        // t = 32 V v + V lane' + e is channel c0 + t of the pass
        float sum = red[t];
#pragma unroll
        for (int k = 1; k < kWarps; ++k) sum += red[k * kPass + t];
        o[c0 + t] = sum;
      }
      __syncthreads();
    }
  }
}

template <typename T, int V, int NV>
int launch(const void* fmap, const float* wx, const float* wy, int H, int W, int C, int n2,
           int rows, float* out, cudaStream_t s) {
  const size_t smem =
      (static_cast<size_t>(kRows) * (W + H) + static_cast<size_t>(kWarps) * 32 * V * NV) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        roi_contract_kernel<T, V, NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>((rows + kRows - 1) / kRows);
  roi_contract_kernel<T, V, NV><<<blocks, kThreads, smem, s>>>(
      static_cast<const T*>(fmap), wx, wy, H, W, C, n2, rows, out);
  return static_cast<int>(cudaGetLastError());
}

// NV = the vectors per lane that cover C in one pass, at most 4
template <typename T, int V>
int launch_nv(const void* fmap, const float* wx, const float* wy, int H, int W, int C, int n2,
              int rows, float* out, cudaStream_t s) {
  const int nv = (C + 32 * V - 1) / (32 * V);
  if (nv <= 1) return launch<T, V, 1>(fmap, wx, wy, H, W, C, n2, rows, out, s);
  if (nv <= 2) return launch<T, V, 2>(fmap, wx, wy, H, W, C, n2, rows, out, s);
  return launch<T, V, 4>(fmap, wx, wy, H, W, C, n2, rows, out, s);
}

}  // namespace

// fmap is float (bf16 == 0) or __nv_bfloat16 (bf16 != 0); wx, wy, out are
// f32. vec != 0 takes the 16-byte path: the caller has checked that fmap is
// 16-byte aligned and C a multiple of 8 (bf16) or 4 (f32).
extern "C" int roi_contract_launch(const void* fmap, const float* wx, const float* wy,
                                   int batch, int H, int W, int C, int n2, int bf16, int vec,
                                   float* out, void* stream) {
  if (batch <= 0 || n2 <= 0 || C <= 0) return 0;
  const size_t rows = static_cast<size_t>(batch) * n2;
  if (rows > static_cast<size_t>(INT_MAX) || H <= 0 || W <= 0 ||
      static_cast<long long>(H) * W > kMaxCells)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && (reinterpret_cast<uintptr_t>(fmap) % 16 || C % (bf16 ? 8 : 4)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int r = static_cast<int>(rows);
  if (bf16) {
    return vec ? launch_nv<__nv_bfloat16, 8>(fmap, wx, wy, H, W, C, n2, r, out, s)
               : launch_nv<__nv_bfloat16, 1>(fmap, wx, wy, H, W, C, n2, r, out, s);
  }
  return vec ? launch_nv<float, 4>(fmap, wx, wy, H, W, C, n2, r, out, s)
             : launch_nv<float, 1>(fmap, wx, wy, H, W, C, n2, r, out, s);
}

extern "C" const char* roi_contract_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
