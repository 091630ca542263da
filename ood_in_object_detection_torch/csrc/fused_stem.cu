// Fused inference stem (kernel K4): the first two k3/s2 Conv+BN+SiLU blocks
// of a YOLOv8 backbone in one kernel, the conv1 map never leaving the SM.
//
//   h1  = silu(conv1(x) * inv1 + shift1)        (B, C1, H/2, W/2), rounded to T
//   out = silu(conv2(h1) * inv2 + shift2)       (B, C2, H/4, W/4) in T
//
// Replaces ood_in_object_detection_tpu/ops/pallas/stem.py:pallas_stem
// (_stem_kernel), which runs the same two convs as MXU matmuls over a
// space-to-depth image in a union-tap layout. This kernel computes the
// function, not that layout: per (image, 8x8 output tile) it stages the
// 35x35x3 image patch the tile needs, computes the 17x17xC1 conv1 tile into
// shared memory, and contracts it with the folded conv2 weights for the
// output channels, so conv1 is computed once per tile.
//
// Numerics are pallas_stem's: BN is folded into the weights in f32 by the
// wrapper (ops/stem.py:k4_weights), which also rounds the folded weights to
// T; products and sums are f32 (a bf16 x bf16 product is exact in f32), bias
// and SiLU in f32, the conv1 tile rounded to T (stem.py:151). conv2's zero
// padding is zeros in h1 (conv1 cells at row or column -1 or past H/2, W/2
// are 0, not silu(shift1)); the image's own padding is zeros. That is what
// bf16 tensor-core products with f32 accumulators compute.
//
// What bounds it on an H100: operations. yolov8l at 640 px, batch 8, does
// 33 GFLOP (conv2 30.2, conv1 2.8) against ~40 MB of bf16 traffic: 0.033 ms
// at the 989 TFLOP/s of bf16 tensor cores, 0.49 ms at f32's 67 TFLOP/s.
//
// bf16 (fused_stem_bf16_kernel): both convolutions on tensor cores,
// mma.sync.m16n8k16 bf16 -> f32, as implicit GEMMs.
// - conv2: M = the tile's 64 pixels, N = C2, K = 9 C1 (576 at yolov8l). A
//   comes from the conv1 tile with ldmatrix, each lane giving its own row
//   address. The tile is stored cell-major, even and odd columns apart, so
//   the 8 rows of an ldmatrix (8 pixels of a row, stride-2 cells) are 8
//   consecutive slots; a slot's pitch is 2 C1 + 16 bytes, an odd multiple of
//   16, so those rows fall on 8 different bank groups.
// - B, the folded conv2 weight in bf16, is resident in shared memory
//   (147 KB at yolov8l) in mma fragment order, so each lane reads one 8-byte
//   word per n-tile and k-step. The block is persistent: it loads B once and
//   walks a stride of tiles; where C2's weights do not fit (C1 80, C2 160;
//   C1 96, C2 192 in three slices of 64), C2 is cut into slices, one per
//   block.
// - 16 warps in two groups of 8 that split K (taps 0-4 and 4-8). In a group
//   a warp owns 2 m-tiles x up to 5 n-tiles (40 accumulators) and loads the
//   next k-step's fragments before the current products. That keeps the
//   shared-memory traffic of 8 warps (each tile reads A 4 times and B twice:
//   ~590 KB at yolov8l, the bound of this design at 128 B per cycle) with
//   twice the warps to hide latency. The groups' sums meet in shared memory:
//   each thread finishes one of its two m-tiles and hands the other to its
//   peer in the other group, so both groups share the epilogue.
// - conv1: M = the 289 conv1 cells, N = C1 (padded to 16), K = 27 padded to
//   32; A is built in registers from the staged image patch. SiLU uses the
//   fast exponential and division: a few f32 ulp, below the bf16 rounding.
// - The next tile's image patch is copied with cp.async (8-byte groups,
//   zeros outside the image) while conv2 runs; issued before conv1 instead,
//   it measured slower than no prefetch. The output tile goes through
//   shared memory, so each channel's 8-pixel row segment is one 16-byte
//   store.
//
// f32 (fused_stem_f32_kernel): TF32 is off by contract, so CUDA cores.
// One block of C2 threads per (image, 8x8 output tile); two blocks fit on
// an SM at yolov8l's widths (~102 KB of shared memory each), so one block's
// patch copy, conv1 and epilogue overlap the other's conv2. At C1 96, C2
// 192 (yolo11x, yolo12x) a block takes ~150 KB and runs alone on its SM.
// - conv2 is a register-tiled implicit GEMM: M = the tile's 64 pixels,
//   N = C2, K = 9 C1. A thread holds 8 pixels (one column of the tile) x 8
//   output channels, 64 accumulators. The conv1 tile is stored cell-major
//   ([cell][C1 + 4] f32, even and odd columns apart, as in the bf16
//   kernel), so 4 channels of one cell are one 16-byte load; the 8 lanes
//   that differ in pixel column read 8 consecutive cells, whose 16-byte
//   words fall in 8 different bank groups (the pitch is C1 + 4 floats).
//   Per 4 channels of a tap a thread issues 8 A and 8 B 16-byte loads for
//   256 FMAs.
// - B, the folded conv2 weight, is streamed through shared memory in
//   chunks of one tap row (3 taps) x 8 channels x C2 with a cp.async double
//   buffer (ops/stem.py:k4_pack_f32 lays each chunk out contiguously), so
//   every block reads w2 once per tile at full width and the loads stay out
//   of the FMA chain. The chunk buffers reuse the shared memory of the image
//   patch and conv1's weights, which are dead once the conv1 tile is built.
// - conv1: one item = (4 channels, conv1 cell), channels fastest, so a
//   thread keeps the same 4 channels' 27 x 4 weights in registers over its
//   items and issues one shared-memory load (an image value the lanes of one
//   cell share) per 4 FMAs; the result is one 16-byte store. The patch is
//   copied with 16-byte cp.async groups, zeros outside the image. SiLU uses
//   the fast exponential and division (a few f32 ulp; the contract's
//   tolerance is 2e-5 of the map's scale). The conv1 halo (17^2 cells for
//   8^2 outputs) costs 13 % extra conv1 work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kTile = 8;                // output pixels per tile side
constexpr int kH1 = 2 * kTile + 1;      // conv1 cells per tile side (17)
constexpr int kCells = kH1 * kH1;       // conv1 cells per tile (289)
constexpr int kImg = 4 * kTile + 3;     // image cells per tile side (35)
// the widest stem K4 takes (yolo11x, yolo12x): C1 96, C2 192, multiples of 8
constexpr int kMaxC1 = 96;
constexpr int kMaxC2 = 192;

// ---- bf16: both convolutions on tensor cores ------------------------------
//
// Operands, packed by ops/stem.py:k4_pack_bf16 (C1p = C1 rounded up to 16;
// g = lane / 4, t = lane % 4 as in the mma.sync fragment tables):
//   w1p  bf16 [C1p/8][2][32][4]: k-step ks, n-tile nt, lane -> the B fragment
//        {W1[k][n], W1[k+1][n], W1[k+8][n], W1[k+9][n]}, k = 16 ks + 2t,
//        n = 8 nt + g, W1 (32, C1p) the folded conv1 weight, rows (ci, dy, dx)
//        with rows 27..31 and columns C1.. zero
//   b1p  f32 [C1p] (zero past C1)
//   w2p  bf16 [C2/8][9][C1p/16][32][4]: the same fragments of W2[tap] (C1p, C2),
//        the folded conv2 weight of tap 3 dy + dx, rows C1.. zero
//   b2   f32 [C2]

constexpr int kGroup = 8;                 // conv2: two groups of 8 warps split K
constexpr int kWarps16 = 2 * kGroup;
constexpr int kThreads16 = 32 * kWarps16;
constexpr int kNq = kGroup / 2;           // warps of a group per m-tile pair, striding the n-tiles
constexpr int kSlotRow = 2 * kTile + 2;   // h1 slots per tile row: even cells, then odd
constexpr int kSlots = kH1 * kSlotRow;    // 306
constexpr int kPatchW = 4 * kTile + 8;    // image columns staged per row (40, 8-byte aligned)
constexpr int kPatchPlane = kImg * kPatchW;
constexpr int kPatchElems = 3 * kPatchPlane;   // bf16 per patch buffer
constexpr int kStagePitch = kTile * kTile + 8;  // bf16 per channel of the output stage
constexpr int kM1Tiles = (kCells + 15) / 16;    // 19 conv1 m-tiles
// The register tiles of the two specializations of the kernel (template
// parameters kNt, kNt1): conv2 n-tiles per warp and conv1 n-tiles (C1p / 8).
// Every stem up to C1 80 runs the first, the one of yolov8l (C1 64, C2 128)
// included; C1 88 and 96 (yolo11x, yolo12x) the second, whose C2 is cut
// into more slices (the launcher's search) so that a warp's share of a
// slice fits 3 n-tiles.
constexpr int kNtNarrow = (20 + kNq - 1) / kNq, kNt1Narrow = 10;  // C1p <= 80, C2 / 8 <= 20
constexpr int kNtWide = 3, kNt1Wide = kMaxC1 / 8;                  // C1p 96

// SiLU in f32 through the fast exponential and division (a few ulp of f32,
// far below the bf16 rounding that follows)
__device__ __forceinline__ float silu_fast(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mma16816(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 8 bytes from global, zeros where src_bytes == 0
__device__ __forceinline__ void cp_async8(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo at the lower address
  return *reinterpret_cast<const unsigned*>(&v);
}

struct Stem16Args {
  const __nv_bfloat16* x;   // (B, 3, H, W)
  const __nv_bfloat16* w1;  // w1p
  const float* b1;          // b1p
  const __nv_bfloat16* w2;  // w2p
  const float* b2;          // b2
  __nv_bfloat16* out;       // (B, C2, H/4, W/4)
  int H, W, C1p, C2, nsplit, tiles_x, tiles_per_image, tiles;
};

// conv2 partial sums the two groups exchange: each thread hands its peer
// one m-tile's kNt n-tiles x 4
__host__ __device__ constexpr int red_floats(int nt) { return 2 * nt * 4 * 32 * kGroup; }

// Shared memory of one block, in bytes: the block's slice of w2p, w1p, the
// biases, two image patches and the conv1 tile (the exchanged partial sums
// and the output stage, side by side, reuse it)
__host__ __device__ inline size_t stem16_h1_bytes(int c1p, int nb, int nt) {
  const size_t h1 = static_cast<size_t>(kSlots) * (2 * c1p + 16);
  const size_t red_stage =
      static_cast<size_t>(red_floats(nt)) * 4 + static_cast<size_t>(nb) * kStagePitch * 2;
  return h1 > red_stage ? h1 : red_stage;
}
__host__ __device__ inline size_t stem16_smem_bytes(int c1p, int nb, int nt) {
  return static_cast<size_t>(nb) * 9 * c1p * 2 + static_cast<size_t>(c1p) * 64 +
         static_cast<size_t>(c1p) * 4 + static_cast<size_t>(nb) * 4 +
         2 * static_cast<size_t>(kPatchElems) * 2 + stem16_h1_bytes(c1p, nb, nt);
}

// Stage the 35x35x3 image patch of an output tile (image rows 4 oy0 - 3 ..,
// columns 4 ox0 - 4 .. + 39: the 35 needed ones start at column 1), zeros
// outside the image. W is a multiple of 4, so an 8-byte group is in or out.
__device__ __forceinline__ void load_patch(const Stem16Args& a, int tile, __nv_bfloat16* dst) {
  const int b = tile / a.tiles_per_image, rem = tile % a.tiles_per_image;
  const int oy0 = (rem / a.tiles_x) * kTile, ox0 = (rem % a.tiles_x) * kTile;
  const int iy0 = 4 * oy0 - 3, cx0 = 4 * ox0 - 4;
  const unsigned base = smem_addr(dst);
  constexpr int kCols4 = kPatchW / 4;  // 10 groups of 4 columns per row
  for (int i = threadIdx.x; i < 3 * kImg * kCols4; i += kThreads16) {
    const int c = i / (kImg * kCols4), r = (i / kCols4) % kImg, j = i % kCols4;
    const int gy = iy0 + r, gx = cx0 + 4 * j;
    const bool in = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
    const __nv_bfloat16* src =
        in ? a.x + ((static_cast<size_t>(b) * 3 + c) * a.H + gy) * a.W + gx : a.x;
    cp_async8(base + ((c * kImg + r) * kPatchW + 4 * j) * 2, src, in ? 8 : 0);
  }
}

// Persistent: block = (slice of C2, a stride of tiles). Per 8x8 output tile:
//   conv1: M = 289 conv1 cells (19 m-tiles), N = C1p, K = 32 (27 taps, zero
//          padded); A built in registers from the staged image patch
//   conv2: M = 64 pixels, N = the block's C2 slice, K = 9 C1p; A read from
//          the conv1 tile with ldmatrix, one row address per lane, so the
//          stride-2 gather costs nothing
template <int kNt, int kNt1>
__global__ void __launch_bounds__(kThreads16, 1) fused_stem_bf16_kernel(Stem16Args a) {
  constexpr int kRedFloats = red_floats(kNt);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c1p = a.C1p, ks2 = c1p / 16, nt1 = c1p / 8;
  const int nb = a.C2 / a.nsplit, ntb = nb / 8;
  const int split = blockIdx.x % a.nsplit;
  const int n0 = split * nb;
  const int p1 = 2 * c1p + 16;  // h1 slot pitch in bytes: an odd multiple of 16

  unsigned char* p = smem_raw;
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(p);
  p += static_cast<size_t>(nb) * 9 * c1p * 2;
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(p);
  p += static_cast<size_t>(c1p) * 64;
  float* b1s = reinterpret_cast<float*>(p);
  p += c1p * 4;
  float* b2s = reinterpret_cast<float*>(p);
  p += nb * 4;  // nb is a multiple of 8: 16-byte alignment kept
  __nv_bfloat16* patch = reinterpret_cast<__nv_bfloat16*>(p);
  p += 2 * kPatchElems * 2;
  unsigned char* h1 = p;  // [kSlots][p1 bytes]; later the partial sums, then the stage
  float* red = reinterpret_cast<float*>(p);                         // [kRedFloats]
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(p + kRedFloats * 4);  // [nb][pitch]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  {  // resident operands: this block's slice of w2p, w1p, biases
    const char* src = reinterpret_cast<const char*>(a.w2 + static_cast<size_t>(n0) * 9 * c1p);
    const int n16 = nb * 9 * c1p * 2 / 16;
    for (int i = tid; i < n16; i += kThreads16) cp_async16(smem_addr(w2s) + 16 * i, src + 16 * i);
    const char* src1 = reinterpret_cast<const char*>(a.w1);
    for (int i = tid; i < c1p * 4; i += kThreads16)
      cp_async16(smem_addr(w1s) + 16 * i, src1 + 16 * i);
    for (int i = tid; i < c1p; i += kThreads16) b1s[i] = a.b1[i];
    for (int i = tid; i < nb; i += kThreads16) b2s[i] = a.b2[n0 + i];
  }
  const int G = gridDim.x / a.nsplit;
  int tile = blockIdx.x / a.nsplit;
  if (tile < a.tiles) load_patch(a, tile, patch);
  cp_async_commit();

  // conv1 A: the patch offsets of this lane's 8 k values (-1: zero padding)
  int koff[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = 16 * (j / 4) + 2 * t + (j & 1) + 8 * ((j >> 1) & 1);
    koff[j] = k < 27 ? (k / 9) * kPatchPlane + ((k % 9) / 3) * kPatchW + k % 3 : -1;
  }
  // conv2: this warp's k-steps (group 0 the first half, group 1 the rest),
  // m-tiles (2 mp, 2 mp + 1) and n-tiles (nq + kNq j); the ldmatrix row of
  // this lane in each m-tile, as an h1 slot
  const int group = warp / kGroup, gw = warp % kGroup, gt = tid % (32 * kGroup);
  const int mp = gw & 1, nq = gw >> 1;
  const int nt_count = ntb > nq ? (ntb - nq + kNq - 1) / kNq : 0;
  int slot_base[2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int m = (2 * mp + mi) * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
    slot_base[mi] = 2 * (m / kTile) * kSlotRow + m % kTile;
  }
  const int kofs_bytes = (lane >> 4) * 16;
  const int nk = 9 * ks2;
  const int k_begin = group ? nk / 2 : 0, k_end = group ? nk : nk / 2;
  const uint2* w2f = reinterpret_cast<const uint2*>(w2s);
  const uint2* w1f = reinterpret_cast<const uint2*>(w1s);

  for (int it = 0; tile < a.tiles; tile += G, ++it) {
    const __nv_bfloat16* pt = patch + (it & 1) * kPatchElems;
    cp_async_wait_all();
    __syncthreads();  // the patch (and, first time, the operands) landed; the stage is free

    const int b = tile / a.tiles_per_image, rem = tile % a.tiles_per_image;
    const int oy0 = (rem / a.tiles_x) * kTile, ox0 = (rem % a.tiles_x) * kTile;
    const int H2 = a.H / 2, W2 = a.W / 2, H4 = a.H / 4, W4 = a.W / 4;
    const int ry0 = 2 * oy0 - 1, rx0 = 2 * ox0 - 1;

    // conv1 + BN + SiLU -> h1 (bf16), zero outside the conv1 map
    const unsigned short* pu = reinterpret_cast<const unsigned short*>(pt);
    for (int mt = warp; mt < kM1Tiles; mt += kWarps16) {
      unsigned afr[2][4];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {  // rows g and g + 8 of the m-tile
        const int m = min(mt * 16 + g + 8 * hr, kCells - 1);
        const int base = 2 * (m / kH1) * kPatchW + 2 * (m % kH1) + 1;
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          const unsigned lo = koff[j] >= 0 ? pu[base + koff[j]] : 0u;
          const unsigned hi = koff[j + 1] >= 0 ? pu[base + koff[j + 1]] : 0u;
          // j / 4 = k-step; (j / 2) & 1 selects k or k + 8: registers {0, 2} of row g
          afr[j / 4][((j >> 1) & 1) * 2 + hr] = lo | (hi << 16);
        }
      }
      float acc1[kNt1][4];
#pragma unroll
      for (int n = 0; n < kNt1; ++n) acc1[n][0] = acc1[n][1] = acc1[n][2] = acc1[n][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int n = 0; n < kNt1; ++n)
          if (n < nt1) {
            const uint2 bb = w1f[(n * 2 + ks) * 32 + lane];
            mma16816(acc1[n], afr[ks], bb.x, bb.y);
          }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = mt * 16 + g + 8 * hr;
        if (m >= kCells) continue;
        const int r = m / kH1, q = m % kH1;
        const float in = ry0 + r >= 0 && ry0 + r < H2 && rx0 + q >= 0 && rx0 + q < W2;
        unsigned char* dst = h1 + (r * kSlotRow + (q & 1) * (kTile + 1) + (q >> 1)) * p1;
#pragma unroll
        for (int n = 0; n < kNt1; ++n)
          if (n < nt1) {
            const int ch = n * 8 + 2 * t;
            const float v0 = in * silu_fast(acc1[n][2 * hr] + b1s[ch]);
            const float v1 = in * silu_fast(acc1[n][2 * hr + 1] + b1s[ch + 1]);
            *reinterpret_cast<unsigned*>(dst + ch * 2) = pack_bf16(v0, v1);
          }
      }
    }
    __syncthreads();  // h1 complete
    // the next tile's patch, into the other buffer, while conv2 runs
    if (tile + G < a.tiles) load_patch(a, tile + G, patch + ((it + 1) & 1) * kPatchElems);
    cp_async_commit();

    // conv2: 9 taps x C1p/16 k-steps; the next step's fragments are loaded
    // before this step's products
    float acc[2][kNt][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.0f;
    const unsigned h1a = smem_addr(h1);
    // k-step kk = tap C1p/16 + ks; B of n-tile nq + kNq j at
    // w2f[((nq + kNq j) 9 C1p/16 + kk) 32 + lane]
    const uint2* wb = w2f + nq * nk * 32 + lane;
    auto load = [&](int kk, int tap, int ks, unsigned (&af)[2][4], uint2 (&bf)[kNt]) {
      const int dy = tap / 3, dx = tap - 3 * dy;
      const int toff = dy * kSlotRow + (dx & 1) * (kTile + 1) + (dx >> 1);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], h1a + (slot_base[mi] + toff) * p1 + ks * 32 + kofs_bytes);
#pragma unroll
      for (int j = 0; j < kNt; ++j)
        if (j < nt_count) bf[j] = wb[(kNq * j * nk + kk) * 32];
    };
    auto mma_all = [&](const unsigned (&af)[2][4], const uint2 (&bf)[kNt]) {
#pragma unroll
      for (int j = 0; j < kNt; ++j)
        if (j < nt_count) {
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma16816(acc[mi][j], af[mi], bf[j].x, bf[j].y);
        }
    };
    unsigned a0[2][4], a1[2][4];
    uint2 bq0[kNt], bq1[kNt];
    int tap = k_begin / ks2, ks = k_begin - tap * ks2;  // the next k-step to load
    auto next = [&]() {
      if (++ks == ks2) {
        ks = 0;
        ++tap;
      }
    };
    load(k_begin, tap, ks, a0, bq0);
    next();
    for (int kk = k_begin; kk < k_end; kk += 2) {
      if (kk + 1 < k_end) {
        load(kk + 1, tap, ks, a1, bq1);
        next();
      }
      mma_all(a0, bq0);
      if (kk + 1 < k_end) {
        if (kk + 2 < k_end) {
          load(kk + 2, tap, ks, a0, bq0);
          next();
        }
        mma_all(a1, bq1);
      }
    }
    // The two groups' sums meet in shared memory (where h1 was): the thread
    // of group g finishes m-tile 2 mp + g of its fragments and hands the
    // other m-tile to the thread with the same place in the other group.
    // Then bias + SiLU -> stage[n][pixel] (bf16).
    __syncthreads();  // every warp is done with h1
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[((group * kNt + j) * 4 + e) * 32 * kGroup + gt] =
            group ? acc[0][j][e] : acc[1][j][e];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kNt; ++j)
      if (j < nt_count) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float sum = (group ? acc[1][j][e] : acc[0][j][e]) +
                            red[(((1 - group) * kNt + j) * 4 + e) * 32 * kGroup + gt];
          const int m = (2 * mp + group) * 16 + g + 8 * (e >> 1);
          const int n = (nq + kNq * j) * 8 + 2 * t + (e & 1);
          stage[n * kStagePitch + m] = __float2bfloat16_rn(silu_fast(sum + b2s[n]));
        }
      }
    __syncthreads();

    // NCHW store: one 16-byte row segment (8 pixels) per channel and row
    const bool wide = ox0 + kTile <= W4 && W4 % 8 == 0;
    for (int i = tid; i < nb * kTile; i += kThreads16) {
      const int n = i / kTile, py = i % kTile, oy = oy0 + py;
      if (oy >= H4) continue;
      __nv_bfloat16* orow = a.out + ((static_cast<size_t>(b) * a.C2 + n0 + n) * H4 + oy) * W4 + ox0;
      const __nv_bfloat16* srow = stage + n * kStagePitch + py * kTile;
      if (wide) {
        *reinterpret_cast<uint4*>(orow) = *reinterpret_cast<const uint4*>(srow);
      } else {
        for (int px = 0; px < kTile && ox0 + px < W4; ++px) orow[px] = srow[px];
      }
    }
  }
}

template <int kNt, int kNt1>
int launch_bf16(const void* x, const void* w1, const float* b1, const void* w2, const float* b2,
                int batch, int H, int W, int C1, int C2, void* out, cudaStream_t s) {
  const int c1p = (C1 + 15) / 16 * 16;
  if (c1p > 8 * kNt1) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w1) % 16 ||
      reinterpret_cast<uintptr_t>(w2) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the fewest slices of C2 whose weights fit in shared memory and whose
  // n-tiles fit a warp's register tile (kNt n-tiles of every kNq-th)
  auto fits = [&](int ns) {
    const int ntb = C2 / 8 / ns;
    return (C2 / 8) % ns == 0 && (ntb + kNq - 1) / kNq <= kNt &&
           stem16_smem_bytes(c1p, C2 / ns, kNt) <= static_cast<size_t>(smem_max);
  };
  int nsplit = 1;
  while (nsplit <= C2 / 8 && !fits(nsplit)) ++nsplit;
  if (nsplit > C2 / 8) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = stem16_smem_bytes(c1p, C2 / nsplit, kNt);
  err = cudaFuncSetAttribute(fused_stem_bf16_kernel<kNt, kNt1>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  Stem16Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w1 = static_cast<const __nv_bfloat16*>(w1);
  a.b1 = b1;
  a.w2 = static_cast<const __nv_bfloat16*>(w2);
  a.b2 = b2;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.H = H;
  a.W = W;
  a.C1p = c1p;
  a.C2 = C2;
  a.nsplit = nsplit;
  a.tiles_x = (W / 4 + kTile - 1) / kTile;
  a.tiles_per_image = ((H / 4 + kTile - 1) / kTile) * a.tiles_x;
  a.tiles = a.tiles_per_image * batch;
  const int per_split = std::max(1, std::min(a.tiles, sms / nsplit));
  fused_stem_bf16_kernel<kNt, kNt1><<<per_split * nsplit, kThreads16, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---- f32: CUDA cores, register-tiled --------------------------------------
//
// Operands, packed by ops/stem.py:k4_pack_f32 (BN folded, f32):
//   w1   [27][C1]                 row (ci, dy, dx)
//   b1   [C1]
//   w2p  [C1/8][3 dy][3 dx][8][C2]  W2[(dy, dx)][c][n], c = 8 c8 + the 4th index:
//        chunk (c8, dy), 24 rows of C2, is contiguous
//   b2   [C2]

constexpr int kPx32 = kTile;           // output pixels per thread: one column of the tile
constexpr int kCo32 = 8;               // output channels per thread
constexpr int kKc32 = 8;               // conv1 channels per B chunk
constexpr int kChunkRows = 3 * kKc32;  // B rows per chunk: one tap row (3 taps) x 8 channels

__device__ __forceinline__ void cp_async16_zfill(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Shared memory of one f32 block, in floats: the conv1 tile, then the
// image patch and w1 (conv1) or the two B chunks (conv2) in one region,
// then the biases
__host__ __device__ inline int stem32_union_floats(int c1, int c2) {
  const int conv1 = 3 * kPatchPlane + 27 * c1;
  const int conv2 = 2 * kChunkRows * c2;
  return conv1 > conv2 ? conv1 : conv2;
}
__host__ __device__ inline size_t stem32_smem_bytes(int c1, int c2) {
  return (static_cast<size_t>(kCells) * (c1 + 4) + stem32_union_floats(c1, c2) + c1 + c2) *
         sizeof(float);
}

// block = C2 threads, one (image, 8x8 output tile); thread t: pixel column
// g = t % 8, output channels 8 (t / 8) .. + 7. Two specializations that
// differ in their launch bounds alone: C2 <= 160 (two blocks an SM, the
// stem of every model up to C2 160) and C2 <= 192 (yolo11x, yolo12x: 192
// threads, one block an SM, ~150 KB of shared memory)
template <int kMaxThreads, int kMinBlocks>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks) fused_stem_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2p, const float* __restrict__ b2, int H, int W, int C1, int C2,
    int tiles_x, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pitch = C1 + 4;  // floats per conv1 cell
  float* h1 = reinterpret_cast<float*>(smem_raw);  // [289 slots][pitch]
  float* region = h1 + kCells * pitch;
  float* patch = region;                           // [3][35][40] (conv1)
  float* sw1 = patch + 3 * kPatchPlane;            // [27][C1]    (conv1)
  float* bst = region;                             // [2][24][C2] (conv2)
  float* sb1 = region + stem32_union_floats(C1, C2);
  float* sb2 = sb1 + C1;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;
  const int oy0 = (blockIdx.x / tiles_x) * kTile, ox0 = (blockIdx.x % tiles_x) * kTile;
  const int b = blockIdx.y;
  const int ry0 = 2 * oy0 - 1, rx0 = 2 * ox0 - 1;  // conv1 origin of the tile

  {  // image rows 4 oy0 - 3 .., columns 4 ox0 - 4 .. + 39 (the 35 needed start
     // at column 1); W is a multiple of 4, so a 16-byte group is in or out
    const int iy0 = 4 * oy0 - 3, cx0 = 4 * ox0 - 4;
    const float* xb = x + static_cast<size_t>(b) * 3 * H * W;
    constexpr int kCols4 = kPatchW / 4;
    for (int i = tid; i < 3 * kImg * kCols4; i += nthreads) {
      const int c = i / (kImg * kCols4), r = (i / kCols4) % kImg, j = i % kCols4;
      const int gy = iy0 + r, gx = cx0 + 4 * j;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const float* src = in ? xb + (static_cast<size_t>(c) * H + gy) * W + gx : x;
      cp_async16_zfill(smem_addr(patch + (c * kImg + r) * kPatchW + 4 * j), src, in ? 16 : 0);
    }
    for (int i = tid; i < 27 * C1 / 4; i += nthreads)
      cp_async16_zfill(smem_addr(sw1 + 4 * i), w1 + 4 * i, 16);
    cp_async_commit();
    for (int i = tid; i < C1; i += nthreads) sb1[i] = b1[i];
    for (int i = tid; i < C2; i += nthreads) sb2[i] = b2[i];
    cp_async_wait_all();
    __syncthreads();
  }

  // conv1 + BN + SiLU -> h1, one (4 channels, cell) per item, items
  // channel-fastest: a thread's items share their 4 channels whenever the
  // block's thread count is a multiple of C1 / 4 (always at the YOLOv8
  // widths), so it holds their 27 x 4 weights in registers and reads one
  // image value per tap, which the lanes on the same cell share. Cells
  // outside the conv1 map are conv2's zero padding.
  {
    const int nq4 = C1 / 4;
    int wq = -1;
    float4 wr[27];
    for (int i = tid; i < nq4 * kCells; i += nthreads) {
      const int cell = i / nq4, q4 = i - cell * nq4, r = cell / kH1, q = cell - r * kH1;
      if (q4 != wq) {
#pragma unroll
        for (int k = 0; k < 27; ++k)
          wr[k] = *reinterpret_cast<const float4*>(sw1 + k * C1 + 4 * q4);
        wq = q4;
      }
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (ry0 + r >= 0 && ry0 + r < H2 && rx0 + q >= 0 && rx0 + q < W2) {
        // the cell's 27 image values, all loaded before the products
        const float* px = patch + 2 * r * kPatchW + 2 * q + 1;
        float xv[27];
#pragma unroll
        for (int k = 0; k < 27; ++k)
          xv[k] = px[((k / 9) * kImg + (k % 9) / 3) * kPatchW + k % 3];
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
        for (int k = 0; k < 27; ++k) {
          a0 = fmaf(xv[k], wr[k].x, a0);
          a1 = fmaf(xv[k], wr[k].y, a1);
          a2 = fmaf(xv[k], wr[k].z, a2);
          a3 = fmaf(xv[k], wr[k].w, a3);
        }
        const float* bb = sb1 + 4 * q4;
        v = make_float4(silu_fast(a0 + bb[0]), silu_fast(a1 + bb[1]), silu_fast(a2 + bb[2]),
                        silu_fast(a3 + bb[3]));
      }
      *reinterpret_cast<float4*>(h1 + (r * kH1 + (q & 1) * (kTile + 1) + (q >> 1)) * pitch +
                                 4 * q4) = v;
    }
  }
  __syncthreads();  // h1 complete; the patch and w1 are dead

  // conv2 + BN + SiLU: K in chunks (c8, dy) of 3 taps x 8 channels
  const int g = tid % kPx32, n0 = (tid / kPx32) * kCo32;
  const int chunk_floats = kChunkRows * C2;
  const int nq = (C1 / kKc32) * 3;
  auto load_chunk = [&](int q) {
    const float* src = w2p + static_cast<size_t>(q) * chunk_floats;
    float* dst = bst + (q & 1) * chunk_floats;
    for (int i = tid; i < chunk_floats / 4; i += nthreads)
      cp_async16_zfill(smem_addr(dst + 4 * i), src + 4 * i, 16);
    cp_async_commit();
  };
  float acc[kPx32][kCo32];
#pragma unroll
  for (int p = 0; p < kPx32; ++p)
#pragma unroll
    for (int j = 0; j < kCo32; ++j) acc[p][j] = 0.0f;
  load_chunk(0);
  for (int q = 0; q < nq; ++q) {
    if (q + 1 < nq) {
      load_chunk(q + 1);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();  // chunk q landed
    const float* bs = bst + (q & 1) * chunk_floats + n0;
    const int c8 = q / 3, dy = q - 3 * c8;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      // pixel (p, g) reads conv1 cell (2 p + dy, 2 g + dx): slot
      // (2 p + dy) 17 + (dx & 1) 9 + g + (dx >> 1)
      const float* ap = h1 + (dy * kH1 + (dx & 1) * (kTile + 1) + (dx >> 1) + g) * pitch + 8 * c8;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float4 a[kPx32];
#pragma unroll
        for (int p = 0; p < kPx32; ++p)
          a[p] = *reinterpret_cast<const float4*>(ap + 2 * p * kH1 * pitch + 4 * half);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* brow = bs + (dx * kKc32 + 4 * half + kk) * C2;
          const float4 ba = *reinterpret_cast<const float4*>(brow);
          const float4 bb = *reinterpret_cast<const float4*>(brow + 4);
          const float bv[kCo32] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
#pragma unroll
          for (int p = 0; p < kPx32; ++p) {
            const float av = kk == 0 ? a[p].x : kk == 1 ? a[p].y : kk == 2 ? a[p].z : a[p].w;
#pragma unroll
            for (int j = 0; j < kCo32; ++j) acc[p][j] = fmaf(av, bv[j], acc[p][j]);
          }
        }
      }
    }
    __syncthreads();  // every thread is done with chunk q's buffer
  }

  const int ox = ox0 + g;
  if (ox >= W4) return;
#pragma unroll
  for (int j = 0; j < kCo32; ++j) {
    const int co = n0 + j;
    const float bias = sb2[co];
    float* ocol = out + (static_cast<size_t>(b) * C2 + co) * H4 * W4 + ox;
#pragma unroll
    for (int p = 0; p < kPx32; ++p)
      if (oy0 + p < H4) ocol[static_cast<size_t>(oy0 + p) * W4] = silu_fast(acc[p][j] + bias);
  }
}

template <int kMaxThreads, int kMinBlocks>
int launch_f32(const void* x, const float* w1, const float* b1, const float* w2p, const float* b2,
               int batch, int H, int W, int C1, int C2, void* out, cudaStream_t s) {
  if (C2 > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w1) % 16 ||
      reinterpret_cast<uintptr_t>(w2p) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int tiles_y = (H / 4 + kTile - 1) / kTile, tiles_x = (W / 4 + kTile - 1) / kTile;
  const size_t smem = stem32_smem_bytes(C1, C2);
  cudaError_t err = cudaFuncSetAttribute(fused_stem_f32_kernel<kMaxThreads, kMinBlocks>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(tiles_y * tiles_x), static_cast<unsigned>(batch));
  fused_stem_f32_kernel<kMaxThreads, kMinBlocks><<<grid, C2, smem, s>>>(
      static_cast<const float*>(x), w1, b1, w2p, b2, H, W, C1, C2, tiles_x,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 (bf16 == 0): x, out float; w1, b1, w2, b2 the operands of
// ops/stem.py:k4_pack_f32. bf16 (bf16 != 0): x, out __nv_bfloat16; w1, b1,
// w2, b2 the packed operands of ops/stem.py:k4_pack_bf16 (see above).
extern "C" int fused_stem_launch(const void* x, const void* w1, const float* b1,
                                 const void* w2, const float* b2, int batch, int H, int W,
                                 int C1, int C2, int bf16, void* out, void* stream) {
  if (batch <= 0 || H <= 0 || W <= 0) return 0;
  if (H % 4 || W % 4 || C1 <= 0 || C1 % 8 || C1 > kMaxC1 || C2 <= 0 || C2 % 8 || C2 > kMaxC2 ||
      batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w1f = static_cast<const float*>(w1);
  const float* w2f = static_cast<const float*>(w2);
  if (bf16)
    return (C1 + 15) / 16 * 16 <= 8 * kNt1Narrow
               ? launch_bf16<kNtNarrow, kNt1Narrow>(x, w1, b1, w2, b2, batch, H, W, C1, C2, out, s)
               : launch_bf16<kNtWide, kNt1Wide>(x, w1, b1, w2, b2, batch, H, W, C1, C2, out, s);
  return C2 <= 160 ? launch_f32<160, 2>(x, w1f, b1, w2f, b2, batch, H, W, C1, C2, out, s)
                   : launch_f32<kMaxC2, 1>(x, w1f, b1, w2f, b2, batch, H, W, C1, C2, out, s);
}

extern "C" const char* fused_stem_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

