// Minimum distance from each feature row to each centroid group (kernel K3).
//
//   out[n, g] = min over k with kmask[g, k] of dist(x[n], c[g, k])
//   cosine: 1 - x . c            (rows already L2-normalised by the caller)
//   l2:     sqrt(max(|x|^2 + |c|^2 - 2 x . c, 0))
//   a group with no valid centroid gives +inf.
//
// Replaces ood_in_object_detection_tpu/ops/pallas/distance.py:
// min_group_distances_pallas (_cosl2_kernel), which forms the (128, G*K)
// dot tile on the MXU and min-reduces it over K in VMEM so that the (N, G*K)
// matrix never reaches HBM.
//
// What bounds it on an H100: 2 N V D flops (V valid centroids) against
// N D + G K D floats read and N G written. On the eval path (N = batch *
// 300, D = 512, G = 3 nc, K = 1) that is ~0.1 GFLOP on ~5 MB: bytes and
// latency; a bank of K 200 is ~20 GFLOP, 0.3 ms at the f32 rate: operations.
//
// Design: one product of a tile of rows against the block's centroids,
// min-reduced over K before anything leaves the chip. The columns of the
// product are the flat (group, k) centroids; a block owns a tile of BM rows
// and a run of GR groups (GR K <= BN, so one run covers all G at K 1) or,
// for K > BN, one group. It compacts the run's valid centroids (kmask) into
// slices of at most BN columns, so masked centroids and empty groups cost
// no products and an all-empty run loads no centroid. For each slice it
// streams D in chunks through a ring of cp.async stages (x rows and the
// slice's centroid rows, 16-byte copies with zero fill past D) and
// accumulates TM x TN dot products a thread in f32 registers on the
// CUDA cores. Rows and columns interleave across threads so that the float2
// reads from shared memory are conflict-free; the narrow tile also splits
// each chunk's D values among KSPLIT thread groups, for warps enough to
// hide latency, and adds their partial dots in group order. For l2 the
// same staged chunks give |x|^2 and |c|^2. The epilogue turns the dots of
// 8 columns of a row into distances and folds each run of one group into a
// running minimum in shared memory (a float atomic min); after the last
// slice only the (N, G) minima are written. Shared memory is set by the
// tile, not by K D, so any K launches; a K larger than one slice loops in
// the block, carrying the minimum. Blocks of one row tile are adjacent in
// the grid, so their rows come from L2 after the first reads them from HBM.
// The dynamic shared memory attribute is set once a process.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSeg = 8;  // dist-tile columns one thread folds in the epilogue

// BM x BN tile, TM x TN a thread, WC column threads a warp, KSPLIT thread
// groups that split each chunk's D values; GR_MAX groups a run; CHUNK D
// values a stage, STAGES stages in the cp.async ring
template <int BM_, int BN_, int TM_, int TN_, int WC_, int KSPLIT_, int GR_MAX_, int CHUNK_,
          int STAGES_, int MIN_BLOCKS_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, WC = WC_, KSPLIT = KSPLIT_;
  static constexpr int GR_MAX = GR_MAX_, CHUNK = CHUNK_, STAGES = STAGES_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int RT = BM / TM, CT = BN / TN;  // row threads, column threads of a group
  static constexpr int GROUP = RT * CT, THREADS = GROUP * KSPLIT;
  static constexpr int PITCH = CHUNK + 4;           // 16-byte rows; float2 reads conflict-free
  static constexpr int KG = CHUNK / KSPLIT;         // D values of a chunk a group multiplies
  static_assert((GROUP % 32 == 0 || 32 % GROUP == 0) && CT % WC == 0 && 32 % WC == 0 &&
                THREADS % 32 == 0, "thread layout");
  static_assert(BM + BN <= THREADS, "one thread per staged row for the l2 norms");
  static_assert(STAGES >= 2 && KG % 2 == 0 && CHUNK % 4 == 0, "ring and chunk");
  static constexpr int kStage = (BM + BN) * PITCH;      // floats of one stage
  static constexpr int kDist = BM * (BN + 1);           // one (BM, BN) tile of dots or distances
  static constexpr int kBuf = STAGES * kStage > KSPLIT * kDist ? STAGES * kStage : KSPLIT * kDist;
  // stages / partial dots, running minima [BM][GR_MAX], |x|^2 [BM], |c|^2 [BN], columns [BN]
  static constexpr size_t kSmemBytes = (kBuf + BM * GR_MAX + BM + 2 * BN) * sizeof(float);
};
// K <= 64: 24-row tiles against up to 64 columns, 6 x 8 a thread (an 8 x 8
// or 6 x 8 tile keeps shared-memory reads below the FMA rate; 2 x 4 was
// bound by them); 100 blocks at N 2400, one wave at one block an SM; eight
// groups split each chunk of 64, so a block has 8 warps
using Narrow = Cfg<24, 64, 6, 8, 8, 8, 64, 64, 4, 1>;
// K > 64: one group a block, 128 x 128 tiles, 8 x 8 a thread, three stages
// of 32, one block an SM (its registers)
using Wide = Cfg<128, 128, 8, 8, 2, 1, 1, 32, 3, 1>;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}

// min into a shared float: non-negative floats order as ints, negative ones
// reversed as unsigned ints (the running minima start at +inf)
__device__ __forceinline__ void atomic_min_float(float* a, float v) {
  if (__float_as_int(v) >= 0)
    atomicMin(reinterpret_cast<int*>(a), __float_as_int(v));
  else
    atomicMax(reinterpret_cast<unsigned*>(a), __float_as_uint(v));
}

struct Args {
  const float* x;
  const float* cents;
  const uint8_t* kmask;
  int N, G, K, D, GR, runs;
  bool vec;  // 16-byte copies: D % 4 == 0 and both bases 16-byte aligned
  float* out;
};

// chunk [k0, k0 + CHUNK) of the tile's rows (clamped to N - 1; those rows
// are never written), zero past D
template <class C>
__device__ __forceinline__ void load_rows(const Args& a, float* xs, int r0, int k0) {
  if (a.vec) {
    constexpr int Q = C::CHUNK / 4;
    for (int e = threadIdx.x; e < C::BM * Q; e += C::THREADS) {
      const int m = e / Q, k = k0 + (e % Q) * 4;
      const float* row = a.x + static_cast<size_t>(min(r0 + m, a.N - 1)) * a.D;
      const int bytes = k < a.D ? 16 : 0;
      cp_async16(xs + m * C::PITCH + (e % Q) * 4, bytes ? row + k : row, bytes);
    }
  } else {
    for (int e = threadIdx.x; e < C::BM * C::CHUNK; e += C::THREADS) {
      const int m = e / C::CHUNK, k = k0 + e % C::CHUNK;
      const float* row = a.x + static_cast<size_t>(min(r0 + m, a.N - 1)) * a.D;
      cp_async4(xs + m * C::PITCH + e % C::CHUNK, k < a.D ? row + k : row, k < a.D ? 4 : 0);
    }
  }
}

// the same chunk of the slice's nv centroid rows
template <class C>
__device__ __forceinline__ void load_cents(const Args& a, float* cs, const int* cols,
                                           size_t colbase, int nv, int k0) {
  if (a.vec) {
    constexpr int Q = C::CHUNK / 4;
    for (int e = threadIdx.x; e < nv * Q; e += C::THREADS) {
      const int n = e / Q, k = k0 + (e % Q) * 4;
      const float* row = a.cents + (colbase + cols[n]) * a.D;
      const int bytes = k < a.D ? 16 : 0;
      cp_async16(cs + n * C::PITCH + (e % Q) * 4, bytes ? row + k : row, bytes);
    }
  } else {
    for (int e = threadIdx.x; e < nv * C::CHUNK; e += C::THREADS) {
      const int n = e / C::CHUNK, k = k0 + e % C::CHUNK;
      const float* row = a.cents + (colbase + cols[n]) * a.D;
      cp_async4(cs + n * C::PITCH + e % C::CHUNK, k < a.D ? row + k : row, k < a.D ? 4 : 0);
    }
  }
}

// One slice: the product of the row tile with the slice's nv <= BN centroid
// columns over all of D; the partial dots go to buf [KSPLIT][BM][BN + 1]. NJ =
// column slots a thread needs (the slice's columns ct + j CT < nv, j < NJ);
// thread group kg multiplies D values [kg KG, kg KG + KG) of every chunk.
template <class C, bool kL2, int NJ>
__device__ __forceinline__ void slice_product(const Args& a, float* buf, float* xnorm,
                                              float* cnorm, const int* cols, size_t colbase,
                                              int nv, int r0, int rt, int ct, int kg) {
  float acc[C::TM][NJ];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  float nrm = 0.0f;  // l2: |row|^2 of staged row threadIdx.x (x rows, then centroids)
  const int chunks = (a.D + C::CHUNK - 1) / C::CHUNK;
  // the ring: chunk c in stage c % STAGES; a group is committed for every
  // chunk slot, empty past the last chunk, so wait_group counts stay fixed
  for (int c = 0; c < C::STAGES - 1; ++c) {
    float* st = buf + c * C::kStage;
    if (c < chunks) {
      load_rows<C>(a, st, r0, c * C::CHUNK);
      load_cents<C>(a, st + C::BM * C::PITCH, cols, colbase, nv, c * C::CHUNK);
    }
    asm volatile("cp.async.commit_group;\n");
  }
  for (int c = 0; c < chunks; ++c) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(C::STAGES - 2) : "memory");
    __syncthreads();  // chunk c landed; every thread is done with chunk c - 1's stage
    {
      const int next = c + C::STAGES - 1;
      float* st = buf + (next % C::STAGES) * C::kStage;
      if (next < chunks) {
        load_rows<C>(a, st, r0, next * C::CHUNK);
        load_cents<C>(a, st + C::BM * C::PITCH, cols, colbase, nv, next * C::CHUNK);
      }
      asm volatile("cp.async.commit_group;\n");
    }
    const float* xs = buf + (c % C::STAGES) * C::kStage;
    const float* cs = xs + C::BM * C::PITCH;
    if (kL2 && threadIdx.x < C::BM + C::BN) {
      const float4* r = reinterpret_cast<const float4*>(xs + threadIdx.x * C::PITCH);
#pragma unroll 4
      for (int q = 0; q < C::CHUNK / 4; ++q) {
        const float4 v = r[q];
        nrm = fmaf(v.x, v.x, nrm);
        nrm = fmaf(v.y, v.y, nrm);
        nrm = fmaf(v.z, v.z, nrm);
        nrm = fmaf(v.w, v.w, nrm);
      }
    }
    const float* xk = xs + kg * C::KG;
    const float* ck = cs + kg * C::KG;
#pragma unroll
    for (int kk = 0; kk < C::KG; kk += 2) {
      float2 xa[C::TM], cb[NJ];
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
        xa[i] = *reinterpret_cast<const float2*>(xk + (rt + i * C::RT) * C::PITCH + kk);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        cb[j] = *reinterpret_cast<const float2*>(ck + (ct + j * C::CT) * C::PITCH + kk);
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc[i][j] = fmaf(xa[i].x, cb[j].x, acc[i][j]);
          acc[i][j] = fmaf(xa[i].y, cb[j].y, acc[i][j]);
        }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();  // every product is done: the stages take the partial dots
  float* part = buf + kg * C::kDist;  // [KSPLIT][BM][BN + 1]
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      part[(rt + i * C::RT) * (C::BN + 1) + ct + j * C::CT] = acc[i][j];
  if (kL2) {
    if (threadIdx.x < C::BM) xnorm[threadIdx.x] = nrm;
    else if (threadIdx.x < C::BM + C::BN) cnorm[threadIdx.x - C::BM] = nrm;
  }
}

// distance of tile entry (m, n): the groups' partial dots summed in group order
template <class C, bool kL2>
__device__ __forceinline__ float tile_dist(const float* buf, const float* xnorm,
                                           const float* cnorm, int m, int n) {
  const int at = m * (C::BN + 1) + n;
  float dot = buf[at];
#pragma unroll
  for (int g = 1; g < C::KSPLIT; ++g) dot += buf[g * C::kDist + at];
  return kL2 ? sqrtf(fmaxf(xnorm[m] + cnorm[n] - 2.0f * dot, 0.0f)) : 1.0f - dot;
}

// grid: runs x row tiles, flat, the runs of one row tile adjacent
template <class C, bool kL2>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS) min_group_kernel(const Args a) {
  extern __shared__ float smem[];
  float* buf = smem;                             // stages, then the partial dots
  float* runmin = buf + C::kBuf;                 // [BM][GR_MAX]
  float* xnorm = runmin + C::BM * C::GR_MAX;     // [BM]
  float* cnorm = xnorm + C::BM;                  // [BN]
  int* cols = reinterpret_cast<int*>(cnorm + C::BN);  // [BN] run-local centroid index g K + k
  __shared__ int s_cursor, s_nv;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int run = blockIdx.x % a.runs, r0 = (blockIdx.x / a.runs) * C::BM;
  const int g0 = run * a.GR, ng = min(a.GR, a.G - g0);
  const int total = ng * a.K;                    // the run's centroids, valid or not
  const size_t colbase = static_cast<size_t>(g0) * a.K;
  // thread (kg, rt, ct): groups of GROUP threads; in a group each run of 32
  // threads (or the group, if smaller) is row threads x WC column threads
  const int kg = tid / C::GROUP, local = tid % C::GROUP, wcols = C::CT / C::WC;
  const int gw = local >> 5, lw = local & 31;
  const int rt = (gw / wcols) * (32 / C::WC) + lw / C::WC;
  const int ct = (gw % wcols) * C::WC + lw % C::WC;

  for (int e = tid; e < C::BM * C::GR_MAX; e += C::THREADS) runmin[e] = INFINITY;
  if (tid == 0) s_cursor = 0;
  for (;;) {
    __syncthreads();  // the last slice's fold is done with cols and the partial dots
    if (warp == 0) {  // compact the next <= BN valid centroids of the run
      int cur = s_cursor, n = 0;
      while (n < C::BN && cur < total) {
        const int r = cur + lane;
        const bool v = r < total && a.kmask[colbase + r];
        const unsigned bal = __ballot_sync(0xffffffffu, v);
        const int before = __popc(bal & ((1u << lane) - 1u));
        const int take = min(__popc(bal), C::BN - n);
        if (v && before < take) cols[n + before] = r;
        n += take;
        if (take < __popc(bal)) {  // full: resume after the last centroid taken
          const unsigned last = __ballot_sync(0xffffffffu, v && before == take - 1);
          cur += __ffs(last);
          break;
        }
        cur += 32;
      }
      if (lane == 0) {
        s_cursor = min(cur, total);
        s_nv = n;
      }
    }
    __syncthreads();
    const int nv = s_nv;
    if (nv == 0) break;
    switch ((nv + C::CT - 1) / C::CT) {  // column slots in use, uniform over the block
#define K3_SLICE(nj)                                                                          \
  case nj:                                                                                    \
    if constexpr (nj <= C::TN)                                                                \
      slice_product<C, kL2, nj>(a, buf, xnorm, cnorm, cols, colbase, nv, r0, rt, ct, kg);        \
    break;
      K3_SLICE(1) K3_SLICE(2) K3_SLICE(3) K3_SLICE(4) K3_SLICE(5) K3_SLICE(6) K3_SLICE(7)
      K3_SLICE(8)
#undef K3_SLICE
    }
    __syncthreads();  // the partial dots and norms are complete
    // fold: a thread takes 8 columns of one row, turns their dots into
    // distances and folds each run of one group into its running minimum
    const int segs = (nv + kSeg - 1) / kSeg;
    for (int item = tid; item < C::BM * segs; item += C::THREADS) {
      const int m = item % C::BM, c0 = (item / C::BM) * kSeg, c1 = min(c0 + kSeg, nv);
      int g = cols[c0] / a.K;
      float best = tile_dist<C, kL2>(buf, xnorm, cnorm, m, c0);
      for (int c = c0 + 1; c < c1; ++c) {
        const int gc = cols[c] / a.K;
        const float d = tile_dist<C, kL2>(buf, xnorm, cnorm, m, c);
        if (gc != g) {
          atomic_min_float(&runmin[m * C::GR_MAX + g], best);
          g = gc;
          best = d;
        } else {
          best = fminf(best, d);
        }
      }
      atomic_min_float(&runmin[m * C::GR_MAX + g], best);
    }
  }
  const int rows = min(C::BM, a.N - r0);
  for (int e = tid; e < rows * ng; e += C::THREADS) {
    const int m = e / ng, g = e % ng;
    a.out[static_cast<size_t>(r0 + m) * a.G + g0 + g] = runmin[m * C::GR_MAX + g];
  }
}

// the dynamic shared memory attribute, set once a process for each kernel
template <class C, bool kL2>
cudaError_t prepare() {
  static const cudaError_t err =
      cudaFuncSetAttribute(min_group_kernel<C, kL2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(C::kSmemBytes));
  return err;
}

template <class C>
int launch(const Args& a, int metric_l2, cudaStream_t s) {
  if (a.GR < 1 || a.GR > C::GR_MAX || (a.GR > 1 && a.GR * a.K > C::BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(a.runs) * ((a.N + C::BM - 1) / C::BM);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = metric_l2 ? prepare<C, true>() : prepare<C, false>();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (metric_l2)
    min_group_kernel<C, true><<<static_cast<unsigned>(blocks), C::THREADS, C::kSmemBytes, s>>>(a);
  else
    min_group_kernel<C, false><<<static_cast<unsigned>(blocks), C::THREADS, C::kSmemBytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// wide: 0 for the Narrow tile (K <= 64), 1 for the Wide one; gr: groups a
// block (ood/distance.py:k3_plan chooses both)
extern "C" int min_group_distance_launch(const float* x, const float* cents,
                                         const uint8_t* kmask, int N, int G, int K, int D,
                                         int metric_l2, int wide, int gr, float* out,
                                         void* stream) {
  if (N <= 0 || G <= 0) return 0;
  if (K <= 0 || D <= 0 || gr <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cents) % 16 == 0;
  const Args a{x, cents, kmask, N, G, K, D, gr, (G + gr - 1) / gr, vec, out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return wide ? launch<Wide>(a, metric_l2, s) : launch<Narrow>(a, metric_l2, s);
}

extern "C" const char* min_group_distance_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
