// Greedy-NMS keep mask over score-sorted, class-offset boxes (kernel K1).
//
// Replaces ood_in_object_detection_tpu/ops/pallas/nms.py:greedy_keep_pallas
// (_keep_kernel), which keeps the whole (k, k) IoU matrix in VMEM and
// iterates alive = valid & ~any(iou > thr & row < col & alive) to its
// fixpoint. That fixpoint is greedy NMS in score order, which is what this
// file computes directly:
//
//   1. nms_mask_kernel: the upper-triangular suppression bitmask
//      mask[b, i, w] bit j  <=>  col = 64 w + j > i  and  iou(i, col) > thr,
//      in 64-bit words, one thread per row, 64 rows per block, grid
//      (row blocks, images). The mask lives in a scratch buffer the wrapper
//      allocates (k = 1024: 128 KB per image).
//   2. nms_sweep_kernel: one warp per image walks the boxes in score order;
//      a box is kept if it is valid and no kept box suppressed it, and then
//      ORs its mask row into the removed set held in shared memory.
//
// What bounds it on an H100: phase 1 is k^2 IoUs per image (1 M at k = 1024,
// compute-bound, spread over k/64 * B blocks); phase 2 is a serial chain of k
// dependent steps per image on one warp, bound by shared-memory latency. The
// design keeps phase 1 parallel and phase 2 short by reading only the mask
// words at and after the current row.
//
// The IoU uses the operation order of ops/boxes.py box_iou (union + 1e-7)
// with explicit round-to-nearest intrinsics, so no multiply-add is fused and
// the keep mask equals the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWordBits = 64;

__device__ __forceinline__ float box_area(const float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f), fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

__device__ __forceinline__ float box_iou(const float4 a, const float4 b) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(box_area(a), box_area(b)), inter);
  return __fdiv_rn(inter, __fadd_rn(uni, 1e-7f));
}

__global__ void nms_mask_kernel(const float4* __restrict__ boxes, int k, int nw,
                                float thr, unsigned long long* __restrict__ mask) {
  __shared__ float4 cols[kWordBits];
  const int b = blockIdx.y;
  const int rb = blockIdx.x;
  const int row = rb * kWordBits + threadIdx.x;
  const float4* bb = boxes + (size_t)b * k;
  const float4 mine = row < k ? bb[row] : make_float4(0.f, 0.f, 0.f, 0.f);
  unsigned long long* out = mask + ((size_t)b * k + row) * nw;
  for (int w = 0; w < nw; ++w) {
    // words left of the diagonal block hold only columns <= row: all zero
    const bool upper = w >= rb;  // uniform over the block
    __syncthreads();
    const int col = w * kWordBits + threadIdx.x;
    if (upper && col < k) cols[threadIdx.x] = bb[col];
    __syncthreads();
    unsigned long long bits = 0ull;
    if (upper) {
      const int n = min(kWordBits, k - w * kWordBits);
      for (int j = 0; j < n; ++j) {
        if (w * kWordBits + j > row && box_iou(mine, cols[j]) > thr) bits |= 1ull << j;
      }
    }
    if (row < k) out[w] = bits;
  }
}

__global__ void nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                                 const uint8_t* __restrict__ valid, int k, int nw,
                                 uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* removed = smem;                              // nw words
  uint8_t* sval = reinterpret_cast<uint8_t*>(smem + nw);           // k bytes
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const uint8_t* v = valid + (size_t)b * k;
  for (int w = lane; w < nw; w += 32) removed[w] = 0ull;
  for (int i = lane; i < k; i += 32) sval[i] = v[i];
  __syncwarp();
  const unsigned long long* m = mask + (size_t)b * k * nw;
  uint8_t* kp = keep + (size_t)b * k;
  for (int i = 0; i < k; ++i) {
    // every lane reads the same words, so `alive` is uniform over the warp
    const bool alive = sval[i] && !((removed[i >> 6] >> (i & 63)) & 1ull);
    if (lane == 0) kp[i] = alive ? 1 : 0;
    if (alive) {
      const unsigned long long* row = m + (size_t)i * nw;
      for (int w = (i >> 6) + lane; w < nw; w += 32) removed[w] |= row[w];
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int nms_keep_launch(const float* boxes, const uint8_t* valid, float thr,
                               int batch, int k, unsigned long long* mask, uint8_t* keep,
                               void* stream) {
  if (batch <= 0 || k <= 0) return 0;
  const int nw = (k + kWordBits - 1) / kWordBits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3(nw, batch), kWordBits, 0, s>>>(
      reinterpret_cast<const float4*>(boxes), k, nw, thr, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = nw * sizeof(unsigned long long) + k;
  nms_sweep_kernel<<<batch, 32, smem, s>>>(mask, valid, k, nw, keep);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nms_keep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
