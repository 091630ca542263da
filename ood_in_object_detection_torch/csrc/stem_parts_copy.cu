// Window copy of the stem probe ladder: out = z[:, row0:row0 + rows, :, :cout]
// of a (B, Hin, W, Cin) bf16 tensor, into a dense (B, rows, W, cout) one.
//
// Replaces the IO kernels of the stem ladders, each a pallas_call that only
// moves a window: scripts/bench_stem_parts.py:49 (k_io) and
// bench_stem_parts4.py:87 (modes io, reshape_io), bench_stem_parts2.py:47
// (element_io) and :73 (tiled_io on pre-tiled windows),
// bench_stem_parts3.py:53 (blocked4d), :78 (blocked2d) and :103 (dense128,
// whose rows group 4 pixels into 192 channels and keep the first 128). Their
// TPU tile knobs (th, rows, dimension semantics, Element against blocked
// specs) have no meaning here: one launch computes each function.
//
// What bounds it on an H100: bytes only (no arithmetic). Each thread moves
// 16-byte groups (8 bf16): the 32 kept channels of a pixel are 4 such
// groups, contiguous in both tensors, so neighbouring threads read and
// write neighbouring 16-byte words and every warp touches whole 32-byte
// sectors. The 16 dropped channels of each 96-byte pixel are never read.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// one iteration per 16-byte group of the output; gin, gout: groups per pixel
__global__ void window_copy_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                                   unsigned total, unsigned pixels_per_image, int hin, int wp,
                                   int row0, int gin, int gout) {
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const unsigned pix = i / gout, g = i - pix * gout;
    const unsigned img = pix / pixels_per_image;
    const size_t spix = (static_cast<size_t>(img) * hin + row0) * wp + (pix - img * pixels_per_image);
    dst[i] = __ldg(src + spix * gin + g);
  }
}

}  // namespace

extern "C" int stem_parts_copy_launch(const void* z, void* out, int batch, int hin, int wp,
                                      int cin, int row0, int rows, int cout, void* stream) {
  if (batch <= 0 || rows <= 0 || wp <= 0) return 0;
  if (cin % 8 || cout % 8 || cout <= 0 || cout > cin || row0 < 0 || row0 + rows > hin)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned long long total = 1ull * batch * rows * wp * (cout / 8);
  if (total >= (1ull << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  window_copy_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(z), static_cast<uint4*>(out), static_cast<unsigned>(total),
      static_cast<unsigned>(rows) * wp, hin, wp, row0, cin / 8, cout / 8);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* stem_parts_copy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
