// Greedy-NMS keep mask over score-sorted, class-offset boxes (kernel K1).
//
// Replaces ood_in_object_detection_tpu/ops/pallas/nms.py:greedy_keep_pallas
// (_keep_kernel), which keeps the whole (k, k) IoU matrix in VMEM and
// iterates alive = valid & ~any(iou > thr & row < col & alive) to its
// fixpoint. That fixpoint is greedy NMS in score order, which is what this
// file computes directly, in two launches:
//
//   1. nms_mask_kernel: the upper-triangular suppression bitmask
//      mask[b, i, w] bit j  <=>  col = 64 w + j > i  and  iou(i, col) > thr,
//      in 64-bit words. One block of 64 threads per (row block, column
//      block at or right of it, image): nw (nw + 1) / 2 x B blocks, one
//      thread per row's word. A word is only ever read for a valid row, and
//      only its valid columns' bits matter (an invalid box is never kept),
//      so a block with no valid row or no valid column writes zeros without
//      an IoU, and invalid rows and columns are skipped inside a block. The
//      main path's valid boxes are a prefix (confidence-sorted), so the work
//      is the triangle of the valid prefix, found on the device.
//   2. nms_sweep_kernel: one block per image walks the boxes in blocks of
//      64. It copies the next block's 64 diagonal words into shared memory
//      with cp.async while it resolves the current one: one thread settles
//      the 64 boxes of the block in registers from its diagonal words (a
//      box is kept if it is valid and no kept box suppressed it), then all
//      threads OR the kept rows' words right of the diagonal, read from
//      global memory (L2), into the removed set, 8 rows of one word per
//      thread. The serial chain is nw blocks of 64 register steps, not k
//      dependent loads from memory; the sweep stops after the last block
//      that holds a valid box. Shared memory holds the removed set and the
//      valid bits, 16 nw bytes, so any k launches (staging whole 64-row
//      blocks of the mask instead was slower at every k measured and capped
//      k at 14,272).
//
// What bounds it on an H100: phase 1 is at most k^2 / 2 IoUs per image,
// ~13 flops each (0.5 M at k = 1024: nothing for the card, so its time is
// launch and latency); phase 2 is the serial chain, nw steps of a 64-step
// register loop, two barriers and one OR pass each.
//
// The IoU uses the operation order of ops/boxes.py box_iou (union + 1e-7)
// with explicit round-to-nearest intrinsics, so no multiply-add is fused and
// the keep mask equals the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWordBits = 64;
constexpr int kSweepThreads = 128;  // the OR pass: 16 words x 8 parts of 8 rows

__device__ __forceinline__ float box_area(const float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f), fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

// iou(a, b) > thr. Where the boxes do not overlap (inter == 0) the IoU is 0,
// or NaN for a box with an infinite side, and neither exceeds a threshold
// >= 0: the division is skipped there, with the same answer.
__device__ __forceinline__ bool iou_above(const float4 a, const float4 b, float thr) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  if (inter == 0.0f && thr >= 0.0f) return false;
  const float uni = __fsub_rn(__fadd_rn(box_area(a), box_area(b)), inter);
  return __fdiv_rn(inter, __fadd_rn(uni, 1e-7f)) > thr;
}

// grid (nw (nw + 1) / 2, B), block 64: x enumerates the upper-triangular
// (row block, column block) pairs row by row
__global__ void __launch_bounds__(kWordBits) nms_mask_kernel(
    const float4* __restrict__ boxes, const uint8_t* __restrict__ valid, int k, int nw,
    float thr, unsigned long long* __restrict__ mask) {
  __shared__ float4 cols[kWordBits];
  __shared__ bool col_ok[kWordBits];
  // row block rb starts at pair rb nw - rb (rb - 1) / 2: invert that in
  // closed form (k of tens of thousands has hundreds of row blocks), then
  // settle the rounding of the square root
  const long long t = blockIdx.x, n2 = 2 * static_cast<long long>(nw) + 1;
  int rb = static_cast<int>((n2 - sqrt(static_cast<double>(n2 * n2 - 8 * t))) * 0.5);
  auto start = [nw](long long r) { return r * nw - r * (r - 1) / 2; };
  while (rb > 0 && start(rb) > t) --rb;
  while (rb + 1 < nw && start(rb + 1) <= t) ++rb;
  const int cb = rb + static_cast<int>(t - start(rb));
  const int b = blockIdx.y;
  const int row = rb * kWordBits + threadIdx.x, col = cb * kWordBits + threadIdx.x;
  const float4* bb = boxes + static_cast<size_t>(b) * k;
  const uint8_t* vb = valid + static_cast<size_t>(b) * k;
  const bool row_ok = row < k && vb[row];
  const bool c_ok = col < k && vb[col];
  const bool rows_any = __syncthreads_or(row_ok);
  const bool cols_any = __syncthreads_or(c_ok);
  unsigned long long bits = 0ull;
  if (rows_any && cols_any) {  // uniform over the block
    cols[threadIdx.x] = c_ok ? bb[col] : make_float4(0.f, 0.f, 0.f, 0.f);
    col_ok[threadIdx.x] = c_ok;
    __syncthreads();
    if (row_ok) {
      const float4 mine = bb[row];
      // every column's test, independent of each other (the unrolled loop
      // keeps several in flight); the flags pick the bits
#pragma unroll 8
      for (int j = 0; j < kWordBits; ++j) {
        const bool hit = iou_above(mine, cols[j], thr);
        bits |= static_cast<unsigned long long>(hit && col_ok[j] && cb * kWordBits + j > row) << j;
      }
    }
  }
  if (row < k) mask[(static_cast<size_t>(b) * k + row) * nw + cb] = bits;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the diagonal words of rows 64 i .. of image b (word i of each row) into stage
__device__ __forceinline__ void load_diagonal(const unsigned long long* m, int k, int nw, int i,
                                              unsigned long long* stage) {
  const int r = threadIdx.x;
  if (r < kWordBits && i * kWordBits + r < k)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(stage + r)),
                 "l"(m + static_cast<size_t>(i * kWordBits + r) * nw + i));
  asm volatile("cp.async.commit_group;\n");
}

// grid B, block kSweepThreads; dynamic shared memory: two stages of the 64
// diagonal words, then the removed set and the valid bits (nw words each)
__global__ void __launch_bounds__(kSweepThreads) nms_sweep_kernel(
    const unsigned long long* __restrict__ mask, const uint8_t* __restrict__ valid, int k,
    int nw, uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* stages = smem;                         // [2][64]
  unsigned long long* removed = smem + 2 * kWordBits;        // [nw]
  unsigned long long* vbits = removed + nw;                  // [nw]
  __shared__ int n_blocks;
  __shared__ unsigned long long kept_s;
  const int b = blockIdx.x, tid = threadIdx.x;
  const uint8_t* v = valid + static_cast<size_t>(b) * k;
  const unsigned long long* m = mask + static_cast<size_t>(b) * k * nw;
  uint8_t* kp = keep + static_cast<size_t>(b) * k;

  if (tid == 0) n_blocks = 0;
  __syncthreads();
  for (int w = tid; w < nw; w += kSweepThreads) {
    unsigned long long bits = 0ull;
    const int n = min(kWordBits, k - w * kWordBits);
    for (int j = 0; j < n; ++j)
      bits |= static_cast<unsigned long long>(v[w * kWordBits + j] != 0) << j;
    vbits[w] = bits;
    removed[w] = 0ull;
    if (bits) atomicMax(&n_blocks, w + 1);
  }
  __syncthreads();
  // blocks up to the last valid box: the words of later blocks only hold
  // boxes that are not valid, so they are neither read nor updated
  const int nb = n_blocks;

  if (nb > 0) load_diagonal(m, k, nw, 0, stages);
  for (int i = 0; i < nb; ++i) {
    const unsigned long long* diag = stages + (i & 1) * kWordBits;
    if (i + 1 < nb) {
      load_diagonal(m, k, nw, i + 1, stages + ((i + 1) & 1) * kWordBits);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // block i's diagonal landed; removed[i] is final
    if (tid == 0) {
      // the diagonal: box r of the block is kept if valid and not removed;
      // its word then removes the later boxes of the block it overlaps. The
      // words are read whether or not the box is kept, so the loads leave
      // the chain, which is a test and an OR per box.
      const unsigned long long vb = vbits[i];
      unsigned long long rem = removed[i], kept = 0ull;
#pragma unroll
      for (int r = 0; r < kWordBits; ++r) {
        const unsigned long long d = diag[r];
        if (vb & ~rem & (1ull << r)) {
          kept |= 1ull << r;
          rem |= d;
        }
      }
      kept_s = kept;
    }
    __syncthreads();
    const unsigned long long kept = kept_s;
    if (tid < kWordBits && i * kWordBits + tid < k) kp[i * kWordBits + tid] = (kept >> tid) & 1ull;
    // the kept rows' words right of the diagonal, ORed into removed: thread
    // (part, word) ORs 8 rows of one word, the 8 parts meet by atomicOr
    const int part = tid / 16, rows0 = part * (kWordBits / 8);
    for (int w = i + 1 + tid % 16; w < nb; w += 16) {
      unsigned long long acc = 0ull;
#pragma unroll
      for (int e = 0; e < kWordBits / 8; ++e) {
        const int r = rows0 + e;
        if ((kept >> r) & 1ull) acc |= __ldg(m + static_cast<size_t>(i * kWordBits + r) * nw + w);
      }
      if (acc) atomicOr(&removed[w], acc);
    }
    __syncthreads();  // removed is updated and this stage may be refilled
  }
  for (int j = nb * kWordBits + tid; j < k; j += kSweepThreads) kp[j] = 0;
}

}  // namespace

extern "C" int nms_keep_launch(const float* boxes, const uint8_t* valid, float thr,
                               int batch, int k, unsigned long long* mask, uint8_t* keep,
                               void* stream) {
  if (batch <= 0 || k <= 0) return 0;
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int nw = (k + kWordBits - 1) / kWordBits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3(nw * (nw + 1) / 2, batch), kWordBits, 0, s>>>(
      reinterpret_cast<const float4*>(boxes), valid, k, nw, thr, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = (2 * kWordBits + 2 * static_cast<size_t>(nw)) * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_sweep_kernel<<<batch, kSweepThreads, smem, s>>>(mask, valid, k, nw, keep);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nms_keep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
