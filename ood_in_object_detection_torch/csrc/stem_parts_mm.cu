// GEMM rungs of the stem probe ladder: one or two bf16 products on the
// space-to-depth stem layout, f32 sums, SiLU in f32, bf16 out.
//
// Replaces the GEMM kernel bodies of scripts/bench_stem_parts.py:49
// (k_mm, k_mm_shift, k_mm_concat, k_mm_accum; z has H + 2 rows) and of
// bench_stem_parts4.py:87 make(mode) (mm_pad, mm_concat, full_noshift,
// full; z has H rows under a 2-row halo that is zero above the first row
// tile, i.e. z under two zero rows). Output row y reads rows y + 2 ("base"),
// y + 1 ("prev") and y ("prev2") of that padded z. The first operand is
// built per pixel from 8-channel chunks of those rows (' = shifted one
// pixel along the row, column 0 zero; zx is base' in `full`, base
// elsewhere):
//
//   mm, halo_mm_pad       base                                   K 48
//   mm_shift              bf16(base + base')                     K 48
//   mm_accum              [base, base', prev2, prev2']           K 192 (w48 four times)
//   *concat, full*        [base, zx, prev[32:48], zx'[32:48]]    K 128
//
// The Pallas kernels' union operand is [base, zx, prev[36:48], zx'[36:48],
// 0 x 8]; its 12-channel pieces start at byte 72 of a pixel, which no
// 16-byte shared-memory read can reach, so the kernel takes channels 32:48
// of both taps and the weight packer (ops/stem_parts.py:pack_gemm_weight)
// sets w1's rows for channels 32:36 of those taps to zero: K stays 128 and
// only the f32 order of the sum changes. h1 = bf16(silu(A w1)); the P1
// modes then compute silu(h1 w64); mm_pad and mm_concat of ladder 4 output
// h1[:, :32]; full* build v = [h1, h1, h1_prev[32:64], h1_prev[32:64]] (K
// 192) from the h1 of rows y and y - 1 and compute silu(v w2), the two
// copies of h1 times w2's two halves as separate k-steps into one sum.
//
// What bounds it on an H100 (halo_full at z (128, 160, 160, 48)): bytes,
// 525 MB over 3.35 TB/s = 0.157 ms; beside it SiLU, 96 values a pixel at
// one MUFU operation each (tanh.approx), 0.075 ms at 16 an SM a clock and
// 1.98 GHz; and the tensor cores, 94 GFLOP over 989 TFLOP/s = 0.095 ms
// (the 32-pixel strip at the right edge runs a full 64-row product, +20 %).
// The three floors are of one size, so the design keeps all three busy at
// once and does nothing else per row:
//
// - Persistent blocks, one an SM, of kWG warpgroups; no producer warp:
//   each warpgroup's thread 0 issues its own TMA, a few instructions a row.
//   The block copies its mode's weights into shared memory once (one bulk
//   copy, already in the wgmma B layout: the packer lays them out). Each
//   warpgroup then walks work items (image, 64-pixel column strip, row
//   tile of `rows` rows, 40 from ops/stem_parts.py), strided by the grid's
//   warpgroup count, strip slowest so that every warpgroup gets a mix of
//   wide and narrow strips. kWG, kStages and the row tile were chosen on
//   the card (PERF.md §6).
// - TMA row ring. Thread 0 of each warpgroup keeps kStages z rows in
//   flight: a row is one 4D box of 48 channels x 65 pixels starting at
//   column x0 - 1 (6240 contiguous bytes), completed on the stage's
//   mbarrier. TMA's zero fill gives column -1 (the shift), the two zero
//   rows above row 0 of the halo modes and the ragged right edge, with no
//   branch. The 96-byte pixel pitch puts rows 0 and 4 of an ldmatrix on
//   the same banks (2-way); splitting a row into two 24-channel boxes
//   (48-byte pitch, no conflict) was slower on the card: twice the TMA
//   rows, of half the bytes. A stage is refilled once the warpgroup's first
//   product has consumed its reads (one bar.sync), and the stream runs on
//   across items. Releasing through per-stage "empty" mbarriers with no
//   warpgroup barrier, and storing per warp, was slower on the card: the
//   warps drift apart and the refill waits on the slowest one.
// - The first operand in registers: ldmatrix.x4 per 16 channels, each lane
//   giving its own row address, so the one-pixel shift is one pixel down
//   in the box and prev / prev2 are earlier stages; mm_shift adds in
//   registers. wgmma.mma_async m64n64k16 (m64n32k16 for the 32-column
//   products) with A from registers and B from shared memory.
// - h1 stays in registers: the m64n64 f32 accumulator is already laid out
//   as the next product's A fragments (as FlashAttention-3 feeds P to PV),
//   so SiLU and a bf16 pack make the second product's operand; the full
//   modes keep the row above's h1[32:64] in 8 registers.
// - SiLU as h + h tanh(h), h = v / 2: one MUFU operation a value.
// - Output: bf16 into a 64-byte-swizzled staging row (conflict-free), one
//   TMA store a row (columns past W are clipped by TMA), two staging rows
//   so that a store overlaps the next row.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from cudaGetDriverEntryPoint
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

using bf16 = __nv_bfloat16;

// cycle probes per phase of a row (stem_parts_mm_probe), built in only
// with -DSTEM_PARTS_MM_PROBE=1 (scripts/profile_stem_gemm.py)
#ifndef STEM_PARTS_MM_PROBE
#define STEM_PARTS_MM_PROBE 0
#endif
constexpr bool kProbe = STEM_PARTS_MM_PROBE != 0;

constexpr int kStrip = 64;    // pixels of a work item's column strip: the wgmma M
constexpr int kWG = 4;        // warpgroups per block
constexpr int kStages = 4;    // z rows in each warpgroup's ring
constexpr int kBoxX = kStrip + 1;  // pixels of a row's TMA box: x0 - 1 .. x0 + 63
constexpr int kCin = 48, kCout = 32;  // channels of a z pixel (the box's width) and of the output
constexpr int kBoxBytes = kCin * kBoxX * 2;
constexpr int kStage = (kBoxBytes + 127) / 128 * 128;  // a ring stage: one box
constexpr int kOut = kStrip * kCout * 2;              // one output row of a strip
constexpr int kB1 = 128 * 64 * 2, kB2 = 192 * 32 * 2; // the largest weight images
constexpr int kRegion = (2 * kOut + kStages * kStage + 1023) / 1024 * 1024;  // per warpgroup
constexpr int kBars = kB1 + kB2 + kWG * kRegion;
constexpr int kSmem = kBars + (kWG * kStages + 1) * 8 + 1024;  // + room to align the base
// the weight images (ops/stem_parts.py:pack_gemm_weight): per 16-row k-step,
// per 8 columns, per 8-row half, an 8 x 8 core matrix with k contiguous
constexpr int kLBO = 128, kSBO = 256;

enum Mode { MM = 0, MM_SHIFT, MM_CONCAT, MM_ACCUM, HALO_MM_PAD, HALO_MM_CONCAT,
            HALO_FULL_NOSHIFT, HALO_FULL, kModes };

// KS1: the first product's k-steps; N1 its columns; SECOND: 0 none, 1
// silu(h1 w64), 2 silu(v w2); PAD: zero rows above z; LO: the lowest tap
// row (dr) the mode reads; EXTRA: h1 rows computed above each tile
template <int M> struct Plan {
  static constexpr bool kHalo = M >= HALO_MM_PAD;
  static constexpr bool kFull = M == HALO_FULL_NOSHIFT || M == HALO_FULL;
  static constexpr int KS1 = (M == MM || M == MM_SHIFT || M == HALO_MM_PAD) ? 3
                             : (M == MM_ACCUM ? 12 : 8);
  static constexpr int N1 = (M == HALO_MM_PAD || M == HALO_MM_CONCAT) ? 32 : 64;
  static constexpr int SECOND = kHalo ? (kFull ? 2 : 0) : 1;
  static constexpr int KS2 = SECOND == 2 ? 12 : 4;
  static constexpr int PAD = kHalo ? 2 : 0;
  static constexpr int LO = KS1 == 3 ? 2 : (M == MM_ACCUM ? 0 : 1);
  static constexpr int EXTRA = kFull ? 1 : 0;
  static constexpr int B1STEPS = M == MM_ACCUM ? 3 : KS1;  // k-steps of the w1 / w48 image read
  static constexpr int B1BYTES = B1STEPS * 16 * 64 * 2;
  static constexpr int B2BYTES = (SECOND == 2 ? kB2 : (SECOND ? 64 * 32 * 2 : 0));
};

// an 8-channel chunk of the first operand: padded-z row y + dr, pixel x - sh, channels ch..ch+7
struct Chunk { int dr, sh, ch; };

template <int M> __device__ __forceinline__ constexpr Chunk chunk(int c) {
  if (M == MM || M == MM_SHIFT || M == HALO_MM_PAD) return {2, 0, 8 * c};
  if (M == MM_ACCUM) return {c < 12 ? 2 : 0, (c / 6) & 1, 8 * (c % 6)};
  const int sh = M == HALO_FULL ? 1 : 0;
  if (c < 6) return {2, 0, 8 * c};
  if (c < 12) return {2, sh, 8 * (c - 6)};
  if (c < 14) return {1, 0, 32 + 8 * (c - 12)};
  return {1, sh, 32 + 8 * (c - 14)};
}

// ---- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// wait for the phase of `parity` to complete; a wait past 4 s traps (the
// launch fails and the wrapper raises) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const uint64_t t0 = globaltimer();
  while (!mbar_try(bar, parity))
    if (globaltimer() - t0 > 4000000000ull) __trap();
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the 128 threads of warpgroup `wg` (named barrier 1 + wg)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kLBO >> 4) << 16) | (static_cast<uint64_t>(kSBO >> 4) << 32);
}

template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// d (64 x 64, f32) (+)= a (64 x 16, bf16 fragments in registers) . B (16 x 64 at desc)
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// d (64 x 32, f32) (+)= a (64 x 16) . B (16 x 32 at desc)
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_n(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc,
                                        int accumulate) {
  if constexpr (N == 64) wgmma_n64(d, a, desc, accumulate);
  else wgmma_n32(d, a, desc, accumulate);
}

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

// silu(v) = h + h tanh(h), h = v / 2: one MUFU operation
__device__ __forceinline__ float silu(float v) {
  const float h = 0.5f * v;
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(h));
  return fmaf(h, t, h);
}

__device__ __forceinline__ uint32_t silu_pack(float lo, float hi) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(silu(lo), silu(hi));
  uint32_t out;
  memcpy(&out, &r, 4);
  return out;
}

// ---- cycle probes (STEM_PARTS_MM_PROBE builds) --------------------------------

// thread 0 of each warpgroup sums clock64() deltas per phase of a row step:
// waiting for its rows, building the operand, the first product, the ring's
// release, SiLU and the second product, the output row; then the row steps
constexpr int kPhases = 6;
__device__ unsigned long long g_probe[kPhases + 1];

struct Probe {
  long long last = 0;
  unsigned long long sum[kPhases + 1] = {};
  __device__ __forceinline__ void mark(bool on, int phase) {
    if constexpr (kProbe) {
      if (!on) return;
      const long long now = clock64();
      if (phase >= 0) sum[phase] += now - last;
      last = now;
    }
  }
  __device__ __forceinline__ void flush(bool on) {
    if constexpr (kProbe) {
      if (on)
        for (int k = 0; k <= kPhases; ++k) atomicAdd(&g_probe[k], sum[k]);
    }
  }
};

// ---- the schedule ------------------------------------------------------------

// work item i: strip slowest, then image, then row tile
struct Item { int b, x0, y0, y1; };

__device__ __forceinline__ Item item_at(int i, int batch, int hout, int rows, int tiles) {
  const int per_strip = batch * tiles, s = i / per_strip, r = i - s * per_strip;
  const int b = r / tiles, t = r - b * tiles;
  return {b, s * kStrip, t * rows, min(t * rows + rows, hout)};
}

// thread 0 of a warpgroup: the ring's loads, in stream order over the
// warpgroup's items (padded rows y0 - EXTRA + LO .. y1 + 1 of each)
template <int M> struct Producer {
  int item, r, rend, b, x0, issued;

  __device__ __forceinline__ void start(int i, int items, int batch, int hout, int rows,
                                        int tiles) {
    item = i;
    if (item >= items) return;
    const Item it = item_at(item, batch, hout, rows, tiles);
    b = it.b;
    x0 = it.x0;
    r = it.y0 - Plan<M>::EXTRA + Plan<M>::LO;
    rend = it.y1 + 1;
  }

  // the next row of the stream into its stage (free: its last row was released)
  __device__ __forceinline__ void issue(const CUtensorMap* zmap, uint32_t ring, uint32_t full,
                                        int items, int stride, int batch, int hout, int rows,
                                        int tiles) {
    if (item >= items) return;
    const int st = issued % kStages;
    const uint32_t dst = ring + st * kStage, bar = full + 8 * st;
    mbar_expect_tx(bar, kBoxBytes);
    tma_load(dst, zmap, bar, 0, x0 - 1, r - Plan<M>::PAD, b);
    ++issued;
    if (++r > rend) start(item + stride, items, batch, hout, rows, tiles);
  }
};

template <int M>
__global__ void __launch_bounds__(128 * kWG, 1) stem_parts_mm_kernel(
    const __grid_constant__ CUtensorMap zmap, const __grid_constant__ CUtensorMap omap,
    const bf16* __restrict__ w1, const bf16* __restrict__ w2, int batch, int hout, int rows,
    int tiles, int items) {
  using P = Plan<M>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the output rows' swizzle needs 512-byte alignment
  unsigned char* sm = smem_raw + (base - raw);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const uint32_t sb1 = base, sb2 = base + kB1;
  const uint32_t region = kB1 + kB2 + wg * kRegion;  // offset of this warpgroup's buffers
  const uint32_t ring = base + region + 2 * kOut;
  const uint32_t full = base + kBars + wg * kStages * 8;  // the ring's barriers
  const uint32_t wbar = base + kBars + kWG * kStages * 8;
  const int q0 = blockIdx.x * kWG + wg, stride = gridDim.x * kWG;

  if (threadIdx.x == 0) {
    for (int k = 0; k < kWG * kStages + 1; ++k) mbar_init(base + kBars + 8 * k, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // the weights, once per block
    mbar_expect_tx(wbar, P::B1BYTES + P::B2BYTES);
    bulk_load(sb1, w1, P::B1BYTES, wbar);
    if (P::SECOND) bulk_load(sb2, w2, P::B2BYTES, wbar);
  }
  if (q0 >= items) return;

  Producer<M> prod;
  if (tid == 0) {
    prod.issued = 0;
    prod.start(q0, items, batch, hout, rows, tiles);
    for (int k = 0; k < kStages; ++k)
      prod.issue(&zmap, ring, full, items, stride, batch, hout, rows, tiles);
  }
  mbar_wait(wbar, 0);
  __syncwarp();

  // this lane's ldmatrix row: pixel p of the strip, box column p + 1 - shift
  const int p = 16 * warp + (lane & 15), hi = lane >> 4;
  // its accumulator rows (g, g + 8 of its warp's 16) and column pair 2t
  const int g = lane >> 2, t = lane & 3;
  const int orow0 = 16 * warp + g, orow1 = orow0 + 8;
  uint32_t hprev[2][4] = {};  // full modes: h1[32:64] of the row above (k-steps 2, 3)
  uint32_t item_base = 0;     // stream index of the current item's first row
  int sbuf = 0;
  Probe probe;
  const bool probing = tid == 0;
  probe.mark(probing, -1);

  for (int it = q0; it < items; it += stride) {
    const Item I = item_at(it, batch, hout, rows, tiles);
    const int hfirst = I.y0 - P::EXTRA, steps = I.y1 - hfirst;
    for (int i = 0; i < steps; ++i) {
      const int hy = hfirst + i;
      // the stage holding tap row dr, waited for (a completed phase passes at once)
      uint32_t row_at[3] = {0, 0, 0};
#pragma unroll
      for (int dr = P::LO; dr <= 2; ++dr) {
        const uint32_t q = item_base + i + dr - P::LO;
        mbar_wait(full + 8 * (q % kStages), (q / kStages) & 1);
        row_at[dr] = ring + (q % kStages) * kStage;
      }
      __syncwarp();  // the waits exit lane by lane; ldmatrix and wgmma need the warp converged
      probe.mark(probing, 0);
      probe.sum[kPhases] += kProbe;
      // a chunk's ldmatrix address for this lane (dr, sh, ch fold to constants)
      auto at = [&](const Chunk c) {
        const uint32_t row = c.dr == 2 ? row_at[2] : (c.dr == 1 ? row_at[1] : row_at[0]);
        return row + (p + 1 - c.sh) * (2 * kCin) + c.ch * 2;
      };
      // the first operand, 16 channels a k-step, from the staged rows
      uint32_t a[P::KS1][4];
#pragma unroll
      for (int ks = 0; ks < P::KS1; ++ks) {
        const uint32_t ad = hi ? at(chunk<M>(2 * ks + 1)) : at(chunk<M>(2 * ks));
        ldsm_x4(a[ks], ad);
        if (M == MM_SHIFT) {  // + the pixel to the left, one bf16 rounding
          uint32_t s[4];
          ldsm_x4(s, ad - 2 * kCin);
#pragma unroll
          for (int r = 0; r < 4; ++r) a[ks][r] = add2(a[ks][r], s[r]);
        }
      }
      probe.mark(probing, 1);
      float acc[P::N1 / 2];
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < P::KS1; ++ks)
        wgmma_n<P::N1>(acc, a[ks], b_desc(sb1 + (ks % P::B1STEPS) * (16 * 64 * 2)), ks > 0);
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
      probe.mark(probing, 2);

      // the first product has consumed every lane's fragments, so the oldest
      // row's reads are done: refill its stage (the last step of an item
      // frees its remaining rows). A release right after ldmatrix let TMA
      // overwrite a row that some reads had not yet performed. The store
      // two rows back has read its staging row.
      if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      wg_sync(wg);
      if (tid == 0) {
        const int release = i == steps - 1 ? 3 - P::LO : 1;
        for (int k = 0; k < release; ++k)
          prod.issue(&zmap, ring, full, items, stride, batch, hout, rows, tiles);
      }
      __syncwarp();
      probe.mark(probing, 3);

      float acc2[16];
      if constexpr (P::SECOND == 0) {
#pragma unroll
        for (int k = 0; k < 16; ++k) acc2[k] = acc[k];
      } else {
        // h1 = bf16(silu(acc)): the accumulator's layout is the A fragments'
        uint32_t h[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) h[kk][r] = silu_pack(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
        if (P::EXTRA && hy < I.y0) {  // the row above the tile: its h1 only
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            hprev[0][r] = h[2][r];
            hprev[1][r] = h[3][r];
          }
          probe.mark(probing, 4);
          continue;
        }
        fence_regs(acc2);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < P::KS2; ++ks) {
          const uint64_t d = b_desc(sb2 + ks * (16 * 32 * 2));
          if (P::SECOND == 1 || ks < 8) wgmma_n32(acc2, h[ks % 4], d, ks > 0);
          else wgmma_n32(acc2, hprev[(ks - 8) % 2], d, 1);
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(acc2);
        if (P::SECOND == 2) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            hprev[0][r] = h[2][r];
            hprev[1][r] = h[3][r];
          }
        }
      }
      probe.mark(probing, 4);
      // bf16(silu(acc2)) into the 64-byte-swizzled staging row, then one TMA
      // store of the row (columns past W are clipped)
      const uint32_t so = region + sbuf * kOut;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t o0 = orow0 * 64 + ((j ^ ((orow0 >> 1) & 3)) << 4) + 4 * t;
        const uint32_t o1 = orow1 * 64 + ((j ^ ((orow1 >> 1) & 3)) << 4) + 4 * t;
        *reinterpret_cast<uint32_t*>(sm + so + o0) = silu_pack(acc2[4 * j], acc2[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(sm + so + o1) = silu_pack(acc2[4 * j + 2], acc2[4 * j + 3]);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      wg_sync(wg);
      if (tid == 0) {
        tma_store(&omap, base + so, 0, I.x0, hy, I.b);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
      sbuf ^= 1;
      probe.mark(probing, 5);
    }
    item_base += steps + 2 - P::LO;
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  probe.flush(probing);
}

// ---- host ---------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point lookup: nothing links -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (B, rows, W, C) bf16 tensor as a 4D map, box (cbox, xbox, 1, 1)
bool tensor_map(CUtensorMap* map, const void* ptr, int batch, int nrows, int w, int c, int cbox,
                int xbox, CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(nrows), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(c) * 2, static_cast<cuuint64_t>(w) * c * 2,
                                 static_cast<cuuint64_t>(nrows) * w * c * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cbox), static_cast<cuuint32_t>(xbox), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int M>
int launch(const void* z, const void* w1, const void* w2, int batch, int hin, int w, int rows,
           void* out, cudaStream_t s) {
  using P = Plan<M>;
  const int hout = hin + P::PAD - 2;
  if (hout <= 0 || (P::SECOND && w2 == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (hout + rows - 1) / rows, strips = (w + kStrip - 1) / kStrip;
  const long long items = 1ll * batch * tiles * strips;
  if (items >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap zmap, omap;
  if (!tensor_map(&zmap, z, batch, hin, w, kCin, kCin, kBoxX, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !tensor_map(&omap, out, batch, hout, w, kCout, kCout, kStrip, CU_TENSOR_MAP_SWIZZLE_64B))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(stem_parts_mm_kernel<M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  const long long want = (items + kWG - 1) / kWG;
  const unsigned blocks = static_cast<unsigned>(want < sms ? want : sms);
  stem_parts_mm_kernel<M><<<blocks, 128 * kWG, kSmem, s>>>(
      zmap, omap, static_cast<const bf16*>(w1), static_cast<const bf16*>(w2), batch, hout, rows,
      tiles, static_cast<int>(items));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// z (B, Hin, W, 48), out (B, Hout, W, 32), bf16, 16-byte aligned; w1 and w2
// are the packed weight images of ops/stem_parts.py:pack_gemm_weight (w1:
// w48's or w1's, w2: w64's, w2's or null); mode indexes
// ops/stem_parts.py:GEMM_MODES; rows is the row tile
extern "C" int stem_parts_mm_launch(const void* z, const void* w1, const void* w2, int mode,
                                    int batch, int hin, int w, int rows, void* out,
                                    void* stream) {
  if (batch <= 0 || w <= 0) return 0;
  if (hin <= 0 || rows <= 0 || mode < 0 || mode >= kModes)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(z) | reinterpret_cast<uintptr_t>(out) |
       reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(w2)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case MM: return launch<MM>(z, w1, w2, batch, hin, w, rows, out, s);
    case MM_SHIFT: return launch<MM_SHIFT>(z, w1, w2, batch, hin, w, rows, out, s);
    case MM_CONCAT: return launch<MM_CONCAT>(z, w1, w2, batch, hin, w, rows, out, s);
    case MM_ACCUM: return launch<MM_ACCUM>(z, w1, w2, batch, hin, w, rows, out, s);
    case HALO_MM_PAD: return launch<HALO_MM_PAD>(z, w1, w2, batch, hin, w, rows, out, s);
    case HALO_MM_CONCAT: return launch<HALO_MM_CONCAT>(z, w1, w2, batch, hin, w, rows, out, s);
    case HALO_FULL_NOSHIFT:
      return launch<HALO_FULL_NOSHIFT>(z, w1, w2, batch, hin, w, rows, out, s);
    default: return launch<HALO_FULL>(z, w1, w2, batch, hin, w, rows, out, s);
  }
}

// STEM_PARTS_MM_PROBE builds: the probes' sums since the last call (cycles
// per phase, then row steps), read and reset; zeros in other builds
extern "C" int stem_parts_mm_probe(unsigned long long* sums) {
  cudaError_t err = cudaMemcpyFromSymbol(sums, g_probe, sizeof(g_probe));
  if (err == cudaSuccess) {
    static const unsigned long long zero[kPhases + 1] = {};
    err = cudaMemcpyToSymbol(g_probe, zero, sizeof(g_probe));
  }
  return static_cast<int>(err);
}

extern "C" const char* stem_parts_mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
