// GEMM rungs of the stem probe ladder: one or two bf16 products on the
// space-to-depth stem layout, f32 sums, SiLU in f32, bf16 out.
//
// Replaces the GEMM kernel bodies of scripts/bench_stem_parts.py:49
// (k_mm, k_mm_shift, k_mm_concat, k_mm_accum; z has H + 2 rows) and of
// bench_stem_parts4.py:87 make(mode) (mm_pad, mm_concat, full_noshift,
// full; z has H rows under a 2-row halo that is zero above the first row
// tile, i.e. z under two zero rows). Output row y reads rows y + 2 ("base"),
// y + 1 ("prev") and y ("prev2") of that padded z. The first operand is
// built per pixel from 4-channel groups of those rows:
//
//   mm, halo_mm_pad       base                                  K 48
//   mm_shift              bf16(base + base shifted one pixel)   K 48
//   mm_accum              [base, base', prev2, prev2']          K 192 (w48 four times)
//   *concat, full*        [base, zx, prev[36:48], zx'[36:48], 0 x 8]   K 128
//
// (' = shifted one pixel along the row, column 0 zero; zx is base' in
// `full` and base itself elsewhere, as the Pallas kernels build it). h1 =
// bf16(silu(A w1)); the P1 modes then compute silu(h1 w64); mm_pad and
// mm_concat of ladder 4 output h1[:, :32]; full* build v = [h1, h1,
// h1_prev[32:64], h1_prev[32:64]] (K 192) from the h1 of rows y and y - 1
// and compute silu(v w2).
//
// Design: tensor cores through bf16 WMMA 16x16x16 fragments with f32
// accumulators. A warp owns 16 pixels of a row (a column strip) and walks
// down a row tile; the block's 4 warps share the weights, staged once in
// shared memory. Per row the warp writes the operand into its own shared
// tile from registers (8-byte loads of z, zero where a tap falls outside z
// or left of column 0; the next row's loads are issued before this row's
// products, so they are in flight meanwhile), multiplies, applies SiLU
// from an f32 staging tile, keeps the bf16 h1 in shared memory for the
// second product, and stores 16 pixels x 32 channels as 16-byte words.
// Every shared tile's row pitch is padded by 16 bytes: unpadded pitches of
// 128 or 256 bytes put the 8 rows of each ldmatrix on the same banks. In
// the full modes the warp keeps the h1 of the row above in a second
// buffer, so h1 is computed once per row (plus the row above the tile).
//
// What bounds it on an H100: bytes. The full stem does 28.7 kFLOP per
// output pixel against 96 bytes read and 64 written: 179 FLOP per byte,
// under the 295 where bf16 tensor cores would bind. This version stays far
// from that bound: in the full modes a block holds 95 KB of shared memory,
// so an SM runs 8 warps, each a serial chain of operand build, products
// and SiLU per row. Register-resident h1 (mma.sync fragments), wgmma, TMA
// and a persistent schedule are a later version's work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <cstring>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kM = 16;      // pixels per warp tile
constexpr int kWarps = 4;   // warps per block
constexpr int kCin = 48, kCout = 32;

enum Mode { MM = 0, MM_SHIFT, MM_CONCAT, MM_ACCUM, HALO_MM_PAD, HALO_MM_CONCAT,
            HALO_FULL_NOSHIFT, HALO_FULL, kModes };

// K1: first operand width; N1: first product's columns; SECOND: 0 none,
// 1 silu(h1 w64) (K2 64), 2 silu(v w2) (K2 192); PAD: zero rows above z;
// the first product's B operand row k is w1 row k % W1ROWS, of W1LD columns.
template <int M> struct Plan {
  static constexpr bool kHalo = M >= HALO_MM_PAD;
  static constexpr int K1 = (M == MM || M == MM_SHIFT || M == HALO_MM_PAD) ? 48
                            : (M == MM_ACCUM ? 192 : 128);
  static constexpr int N1 = (M == HALO_MM_PAD || M == HALO_MM_CONCAT) ? kCout : 64;
  static constexpr int SECOND = kHalo ? (N1 == 64 ? 2 : 0) : 1;
  static constexpr int PAD = kHalo ? 2 : 0;
  static constexpr int W1ROWS = (M == MM || M == MM_SHIFT || M == MM_ACCUM) ? 48 : 128;
  static constexpr int W1LD = 64;
  static constexpr int K2 = SECOND == 2 ? 192 : 64;
  static constexpr int KA = (SECOND == 2 && K2 > K1) ? K2 : K1;  // operand tile width
  static constexpr int NH = SECOND == 2 ? 2 : 1;                 // h1 buffers
  // row pitches, padded by 16 bytes so that the 8 rows an ldmatrix reads
  // fall on different banks
  static constexpr int LDA = KA + 8, LDB1 = N1 + 8, LDB2 = kCout + 8, LDC = N1 + 4,
                       LDH = N1 + 8;
  // 4-byte groups of the first operand each lane loads per row
  static constexpr int kGroups = K1 / 4, kPerLane = kM * kGroups / 32;
  // shared memory, bytes: weights, then per warp A, C (f32) and H tiles
  static constexpr int kB1 = K1 * LDB1 * 2;
  static constexpr int kB = kB1 + (SECOND ? K2 * LDB2 * 2 : 0);
  static constexpr int kA = kM * LDA * 2, kC = kM * LDC * 4, kH = NH * kM * LDH * 2;
  static constexpr int kWarp = kA + kC + kH;
  static constexpr int kTotal = kB + kWarps * kWarp;
};

struct Tap { int dr, sh, ch; };  // padded-z row y + dr, pixel x - sh, channel ch; dr < 0: zero

// the first operand's 4-channel group u
template <int M> __device__ __forceinline__ Tap first_tap(int u) {
  if (M == MM || M == MM_SHIFT || M == HALO_MM_PAD) return {2, 0, 4 * u};
  if (M == MM_ACCUM) {
    const int piece = u / 12;
    return {piece < 2 ? 2 : 0, piece & 1, 4 * (u % 12)};
  }
  const int sh = M == HALO_FULL ? 1 : 0;
  if (u < 12) return {2, 0, 4 * u};
  if (u < 24) return {2, sh, 4 * (u - 12)};
  if (u < 27) return {1, 0, 36 + 4 * (u - 24)};
  if (u < 30) return {1, sh, 36 + 4 * (u - 27)};
  return {-1, 0, 0};
}

__device__ __forceinline__ uint2 load4(const bf16* zb, int hin, int w, int zr, int xs, int ch) {
  if (zr < 0 || zr >= hin || xs < 0) return make_uint2(0u, 0u);
  return __ldg(reinterpret_cast<const uint2*>(zb + (static_cast<size_t>(zr) * w + xs) * kCin + ch));
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

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// the z values of the first operand of output row y, pixels x0 .. x0 + 15,
// held in registers: loaded while the previous row is multiplied
template <int M> struct Operand {
  uint2 v[Plan<M>::kPerLane];
  uint2 left[M == MM_SHIFT ? Plan<M>::kPerLane : 1];  // mm_shift: the pixel to the left

  __device__ __forceinline__ void fetch(const bf16* zb, int hin, int w, int x0, int y, int lane) {
    using P = Plan<M>;
#pragma unroll
    for (int i = 0; i < P::kPerLane; ++i) {
      const int q = lane + 32 * i, p = q / P::kGroups, u = q - p * P::kGroups, x = x0 + p;
      const Tap tap = first_tap<M>(u);
      const int zr = y + tap.dr - P::PAD;
      const bool in = x < w && tap.dr >= 0;
      v[i] = in ? load4(zb, hin, w, zr, x - tap.sh, tap.ch) : make_uint2(0u, 0u);
      if (M == MM_SHIFT)  // zero at column 0
        left[i] = in ? load4(zb, hin, w, zr, x - 1, tap.ch) : make_uint2(0u, 0u);
    }
  }

  // A (16 x K1, row pitch LDA) in shared memory
  __device__ __forceinline__ void commit(bf16* sa, int lane) const {
    using P = Plan<M>;
#pragma unroll
    for (int i = 0; i < P::kPerLane; ++i) {
      const int q = lane + 32 * i, p = q / P::kGroups, u = q - p * P::kGroups;
      const uint2 a = M == MM_SHIFT ? make_uint2(add2(v[i].x, left[i].x), add2(v[i].y, left[i].y))
                                    : v[i];
      *reinterpret_cast<uint2*>(sa + p * P::LDA + 4 * u) = a;
    }
  }
};

// c (16 x N, f32, pitch ldc) = a (16 x K, pitch lda) . b (K x N, pitch ldb), in shared memory
template <int K, int N>
__device__ __forceinline__ void warp_gemm(const bf16* a, int lda, const bf16* b, int ldb,
                                          float* c, int ldc) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[N / 16];
#pragma unroll
  for (int n = 0; n < N / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
#pragma unroll
  for (int k = 0; k < K / 16; ++k) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a + k * 16, lda);
#pragma unroll
    for (int n = 0; n < N / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, b + k * 16 * ldb + n * 16, ldb);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < N / 16; ++n)
    wmma::store_matrix_sync(c + n * 16, acc[n], ldc, wmma::mem_row_major);
  __syncwarp();
}

// h (16 x N bf16, pitch ldh) = bf16(silu(c)), c of pitch ldc
template <int N>
__device__ __forceinline__ void epilogue(const float* c, int ldc, bf16* h, int ldh, int lane) {
#pragma unroll 4
  for (int e = lane; e < kM * N; e += 32) {
    const int p = e / N, n = e % N;
    h[p * ldh + n] = __float2bfloat16_rn(silu(c[p * ldc + n]));
  }
  __syncwarp();
}

// 16 pixels x 32 channels from tile (pitch ldt) to out row `row` (B*Hout index)
__device__ __forceinline__ void store_out(const bf16* tile, int ldt, bf16* out, size_t row, int x0,
                                          int w, int lane) {
  for (int q = lane; q < kM * (kCout / 8); q += 32) {
    const int p = q / (kCout / 8), g = q % (kCout / 8), x = x0 + p;
    if (x < w)
      *reinterpret_cast<uint4*>(out + (row * w + x) * kCout + 8 * g) =
          *reinterpret_cast<const uint4*>(tile + p * ldt + 8 * g);
  }
}

template <int M>
__global__ void __launch_bounds__(32 * kWarps) stem_parts_mm_kernel(
    const bf16* __restrict__ z, const bf16* __restrict__ w1, const bf16* __restrict__ w2, int hin,
    int w, int hout, int rows, int tiles, int strips, int items, bf16* __restrict__ out) {
  using P = Plan<M>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sb1 = reinterpret_cast<bf16*>(smem);
  bf16* sb2 = reinterpret_cast<bf16*>(smem + P::kB1);
  for (int i = threadIdx.x; i < P::K1 * P::N1; i += blockDim.x) {
    const int k = i / P::N1, n = i - k * P::N1;
    sb1[k * P::LDB1 + n] = w1[(k % P::W1ROWS) * P::W1LD + n];
  }
  if (P::SECOND)
    for (int i = threadIdx.x; i < P::K2 * kCout; i += blockDim.x)
      sb2[(i / kCout) * P::LDB2 + i % kCout] = w2[i];
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int item = blockIdx.x * kWarps + warp;
  if (item >= items) return;
  const int s = item % strips, t = (item / strips) % tiles, b = item / (strips * tiles);
  unsigned char* mine = smem + P::kB + warp * P::kWarp;
  bf16* sa = reinterpret_cast<bf16*>(mine);
  float* sc = reinterpret_cast<float*>(mine + P::kA);
  bf16* sh = reinterpret_cast<bf16*>(mine + P::kA + P::kC);
  const bf16* zb = z + static_cast<size_t>(b) * hin * w * kCin;
  const int x0 = s * kM, y0 = t * rows, y1 = min(y0 + rows, hout);

  int cur = 0;
  // the full modes start one row above the tile: the h1 their first row reads
  const int ystart = P::SECOND == 2 ? y0 - 1 : y0;
  Operand<M> next;
  next.fetch(zb, hin, w, x0, ystart, lane);
  for (int y = ystart; y < y1; ++y) {
    next.commit(sa, lane);
    __syncwarp();
    if (y + 1 < y1) next.fetch(zb, hin, w, x0, y + 1, lane);  // in flight during the products
    warp_gemm<P::K1, P::N1>(sa, P::LDA, sb1, P::LDB1, sc, P::LDC);
    bf16* h = sh + cur * kM * P::LDH;
    epilogue<P::N1>(sc, P::LDC, h, P::LDH, lane);
    const size_t row = static_cast<size_t>(b) * hout + y;
    if (P::SECOND == 0) {
      store_out(h, P::LDH, out, row, x0, w, lane);
    } else if (y >= y0) {
      const bf16* a2 = h;
      int lda2 = P::LDH;
      if (P::SECOND == 2) {  // v = [h1, h1, h1_prev[32:64], h1_prev[32:64]]
        const bf16* hp = sh + (cur ^ 1) * kM * P::LDH;
        for (int q = lane; q < kM * 24; q += 32) {
          const int p = q / 24, g = q - p * 24;
          const bf16* src = g < 16 ? h + p * P::LDH + 8 * (g & 7)
                                   : hp + p * P::LDH + 32 + 8 * (g & 3);
          *reinterpret_cast<uint4*>(sa + p * P::LDA + 8 * g) =
              *reinterpret_cast<const uint4*>(src);
        }
        __syncwarp();
        a2 = sa;
        lda2 = P::LDA;
      }
      warp_gemm<P::K2, kCout>(a2, lda2, sb2, P::LDB2, sc, P::LDC);
      epilogue<kCout>(sc, P::LDC, sa, P::LDA, lane);  // the operand tile is free again
      store_out(sa, P::LDA, out, row, x0, w, lane);
    }
    __syncwarp();
    if (P::SECOND == 2) cur ^= 1;
  }
}

template <int M>
int launch(const void* z, const void* w1, const void* w2, int batch, int hin, int w, int rows,
           void* out, cudaStream_t s) {
  using P = Plan<M>;
  const int hout = hin + P::PAD - 2;
  if (hout <= 0 || (P::SECOND && w2 == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (hout + rows - 1) / rows, strips = (w + kM - 1) / kM;
  const long long items = 1ll * batch * tiles * strips;
  if (items >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(stem_parts_mm_kernel<M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, P::kTotal);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((items + kWarps - 1) / kWarps);
  stem_parts_mm_kernel<M><<<blocks, 32 * kWarps, P::kTotal, s>>>(
      static_cast<const bf16*>(z), static_cast<const bf16*>(w1), static_cast<const bf16*>(w2), hin,
      w, hout, rows, tiles, strips, static_cast<int>(items), static_cast<bf16*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// z (B, Hin, W, 48), out (B, Hout, W, 32), bf16; w1 is w48 (48, 64) or w1
// (128, 64), w2 is w64 (64, 32), w2 (192, 32) or null; mode indexes
// ops/stem_parts.py:GEMM_MODES
extern "C" int stem_parts_mm_launch(const void* z, const void* w1, const void* w2, int mode,
                                    int batch, int hin, int w, int rows, void* out,
                                    void* stream) {
  if (batch <= 0 || w <= 0) return 0;
  if (hin <= 0 || rows <= 0 || mode < 0 || mode >= kModes)
    return static_cast<int>(cudaErrorInvalidValue);
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

extern "C" const char* stem_parts_mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
