// Shift-add of the stem probe ladder, on (N, R, W, C) bf16 row windows:
//
//   out[n, y, x, :cout] = bf16(z[n, y + 2, x, :cout] + zx[n, y + 2, x, :cout])
//
// zx being z moved `shift` pixels along the window's flattened (row, column)
// order with column 0 zeroed. Replaces scripts/bench_stem_parts2.py:109
// (shift_bench): its `concat` and `f32_roll` modes move one pixel, its
// `bitcast_roll` mode two (pltpu.bitcast packs two bf16 rows into one int32
// row, so a roll by 1 moves two pixels; at column 1 it reads the last pixel
// of the row above). The add is rounded once, as the bf16 add in the TPU
// kernel: f32 sum (exact for two bf16 values), round to nearest even.
//
// What bounds it on an H100: bytes. A thread handles a 16-byte group (8
// channels) of one output pixel: it reads that group of the pixel and of
// its shifted neighbour (the neighbour is read again by the next thread
// along the row, from L1/L2, not from HBM) and writes one group.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  __nv_bfloat162 va, vb;
  memcpy(&va, &a, 4);
  memcpy(&vb, &b, 4);
  const float2 fa = __bfloat1622float2(va), fb = __bfloat1622float2(vb);
  const __nv_bfloat162 r = __floats2bfloat162_rn(__fadd_rn(fa.x, fb.x), __fadd_rn(fa.y, fb.y));
  uint32_t out;
  memcpy(&out, &r, 4);
  return out;
}

__global__ void shift_add_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                                 unsigned total, int r, int w, int gin, int gout, int shift) {
  const unsigned out_pixels_per_tile = static_cast<unsigned>(r - 2) * w;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const unsigned pix = i / gout, g = i - pix * gout;
    const unsigned n = pix / out_pixels_per_tile, rem = pix - n * out_pixels_per_tile;
    const unsigned x = rem % w;
    const size_t flat = static_cast<size_t>(n) * r * w + 2u * w + rem;  // row y + 2, column x
    const uint4 a = __ldg(src + flat * gin + g);
    // column 0 adds +0 (as the TPU kernel's where(col == 0, 0, zx) does)
    const uint4 b = x == 0 ? make_uint4(0, 0, 0, 0) : __ldg(src + (flat - shift) * gin + g);
    dst[i] = make_uint4(add2(a.x, b.x), add2(a.y, b.y), add2(a.z, b.z), add2(a.w, b.w));
  }
}

}  // namespace

extern "C" int stem_parts_shift_launch(const void* z, void* out, int n, int r, int w, int c,
                                       int shift, int cout, void* stream) {
  if (n <= 0 || w <= 0) return 0;
  if (r < 3 || c % 8 || cout % 8 || cout <= 0 || cout > c || (shift != 1 && shift != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned long long total = 1ull * n * (r - 2) * w * (cout / 8);
  if (total >= (1ull << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  shift_add_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(z), static_cast<uint4*>(out), static_cast<unsigned>(total), r, w,
      c / 8, cout / 8, shift);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* stem_parts_shift_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
