// Hand-written Hopper (sm_90a) kernels for the blocked squared-L2 matrix.
//
//   pairwise_sq_l2  replaces src/repro/kernels/pairwise_l2.py:_kernel (behind
//                   pairwise_sq_l2, pairwise_l2 and lower_bounds). For q (M, D)
//                   and p (N, D), f32 or bf16, it writes the (M, N) f32 matrix
//                   (|q|^2 + |p|^2) - 2 q.p, clamped at 0 — the expansion form
//                   of the TPU kernel, which clamps after its last K step.
//
// Two routes, chosen by D alone (kWideMinD):
//
// * narrow (D < kWideMinD; the tree's D = 2, where every query meets every
//   node center). Bound on this card: the (M, N) f32 output's bytes. A block
//   owns kNarrowRows rows x kNarrowCols columns and each thread ONE column:
//   it keeps its p row (exactly D values, a template argument) and |p|^2 in
//   registers, and the block stages only its kNarrowRows x D values of q
//   (and |q|^2) in shared memory, read as broadcasts. Eight rows at a time
//   go through shared memory, and each warp writes one row of them with
//   every store one aligned 128-byte line of the output (lanes outside the
//   row's segment masked), whatever N % 4 is. Column tiles fastest, so the
//   blocks in flight write neighbouring segments of the same rows. FMA-free
//   CUDA-core arithmetic in dimension order (__fmul_rn / __fadd_rn /
//   __fsub_rn): the route equals the plain version in ../pairwise_l2.py
//   bitwise.
//
// * wide (D >= kWideMinD). Bound on this card: the product's operations for
//   f32 operands (at the 3xTF32 rate), the output bytes for bf16. Two
//   launches:
//   - a prep pass, one thread per row of [q; p]: |row|^2 in the plain
//     version's order, and the row at a depth padded to whole 128-byte
//     chunks — bf16 copied, f32 split into TF32 hi = rna(a) and
//     lo = rna(a - hi) — into the caller's scratch;
//   - the product: a persistent block per SM walks 128 x 128 output tiles,
//     the row tile fastest (the blocks in flight share p's tiles; q stays in
//     L2). One producer thread fills a ring of stages with TMA (128-byte
//     swizzle, rows past M or N read as zeros), each stage one 128-byte
//     chunk of K of the q and p tiles (hi and lo for f32), completing on an
//     mbarrier. Two consumer warpgroups (rows 0-63, 64-127) run wgmma
//     m64n128 on them: bf16 one k16 product per 32 bytes of K (bf16 x bf16
//     products are exact in f32: only the order of the sums differs from the
//     plain version); f32 three TF32 k8 products lo.hi + hi.lo + hi.hi (the
//     dropped lo.lo and the split's residue leave at most 3 * 2^-22 |a||b|
//     per term), summed per K step in a fresh accumulator and folded into
//     the running sum with a correctly rounded add (the tensor cores' sums
//     truncate: left to run over all of K they drift by tens of ulps). The
//     epilogue max((|q|^2 + |p|^2) - 2 acc, 0) goes through shared memory and
//     leaves as 512-byte row copies on the bulk-copy engine, which drain
//     while the next tile is computed.
//   The norms are the plain version's bit for bit, so the route differs from
//   it in the cross term alone: tests/test_torch_cuda.py and chip_smoke.py
//   hold it to the expansion form's ceiling 8 * 2^-24 * (max |q|^2 +
//   max |p|^2), against the plain version and against an f64 product;
//   tests/test_torch_pairwise_bound.py checks the split's arithmetic on the
//   CPU.
//
// Ragged M, N, D are masked (zero-filled K adds nothing to any sum); output
// offsets are 64-bit. The C entry point launches on the caller's stream,
// allocates nothing and returns the first CUDA error (0 = launched).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// D at which the wide route takes over. Chosen by tools/pairwise_routes.py
// (both routes forced at M = 4,096, N = 65,536, D = 2..15, f32 and bf16, on
// one H100 80GB HBM3 at 700 W; PERF.md §6): the wide route's time is
// flat in D (0.49 ms f32, 0.42 ms bf16) while the narrow route's grows
// from 0.34 ms at D <= 6 to 0.55 ms at D = 15. The narrow route is faster
// up to D = 10 in bf16 and D = 12 in f32, even at 13 in f32, slower from
// 14 in both: from 14 on the tensor cores take over, and below it the
// result stays bitwise equal to the plain version.
constexpr int kWideMinD = 14;
// The narrow kernel is built for D = 1..15 (the measurement above forces
// it past kWideMinD).
constexpr int kNarrowMaxD = 15;

// -- narrow route ---------------------------------------------------------------
constexpr int kNarrowCols = 256;  // one column per thread
constexpr int kNarrowRows = 64;   // rows per block
constexpr int kNarrowBatch = 8;   // rows staged per store pass (one a warp)

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int D>
__global__ void __launch_bounds__(kNarrowCols)
    pairwise_narrow_kernel(const T* __restrict__ q, const T* __restrict__ p,
                           int m, int n, int col_tiles,
                           float* __restrict__ out) {
  __shared__ float qs[kNarrowRows][D];
  __shared__ float qn_s[kNarrowRows];
  __shared__ float rows_s[kNarrowBatch][kNarrowCols];
  const int row0 = (blockIdx.x / col_tiles) * kNarrowRows;
  const int col0 = (blockIdx.x % col_tiles) * kNarrowCols;
  const int col = col0 + threadIdx.x;

  for (int e = threadIdx.x; e < kNarrowRows * D; e += kNarrowCols) {
    const int row = row0 + e / D;
    qs[e / D][e % D] = row < m ? widen(q[(int64_t)row * D + e % D]) : 0.0f;
  }
  float pv[D];
  float pn = 0.0f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    pv[k] = col < n ? widen(p[(int64_t)col * D + k]) : 0.0f;
    pn = k == 0 ? __fmul_rn(pv[k], pv[k])
                : __fadd_rn(pn, __fmul_rn(pv[k], pv[k]));
  }
  __syncthreads();
  if (threadIdx.x < kNarrowRows) {
    float s = __fmul_rn(qs[threadIdx.x][0], qs[threadIdx.x][0]);
#pragma unroll
    for (int k = 1; k < D; ++k)
      s = __fadd_rn(s, __fmul_rn(qs[threadIdx.x][k], qs[threadIdx.x][k]));
    qn_s[threadIdx.x] = s;
  }
  __syncthreads();
  const int rows = min(kNarrowRows, m - row0);
  const int cols = min(kNarrowCols, n - col0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int rb = 0; rb < rows; rb += kNarrowBatch) {
    // compute: one column per thread, kNarrowBatch rows
#pragma unroll
    for (int i = 0; i < kNarrowBatch; ++i) {
      const int r = rb + i;
      float acc = __fmul_rn(qs[r][0], pv[0]);
#pragma unroll
      for (int k = 1; k < D; ++k)
        acc = __fadd_rn(acc, __fmul_rn(qs[r][k], pv[k]));
      const float s = __fadd_rn(qn_s[r], pn);
      rows_s[i][threadIdx.x] = fmaxf(__fsub_rn(s, __fmul_rn(2.0f, acc)), 0.0f);
    }
    __syncthreads();
    // store: warp w writes row rb + w, one aligned 128-byte line of the
    // output per instruction (lanes outside the row's segment masked)
    if (rb + warp < rows) {
      const int64_t base = (int64_t)(row0 + rb + warp) * n + col0;
      for (int64_t f = (base & ~(int64_t)31) + lane; f < base + cols; f += 32)
        if (f >= base) __stcs(out + f, rows_s[warp][f - base]);
    }
    __syncthreads();
  }
}

template <typename T, int D>
cudaError_t launch_narrow_d(const void* q, const void* p, int m, int n,
                            void* out, cudaStream_t s) {
  const int col_tiles = (n + kNarrowCols - 1) / kNarrowCols;
  const int64_t blocks =
      (int64_t)col_tiles * ((m + kNarrowRows - 1) / kNarrowRows);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  pairwise_narrow_kernel<T, D><<<(unsigned)blocks, kNarrowCols, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(p), m, n, col_tiles,
      static_cast<float*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_narrow(const void* q, const void* p, int m, int n, int d,
                          void* out, cudaStream_t s) {
  switch (d) {
#define NARROW_CASE(D) \
  case D:              \
    return launch_narrow_d<T, D>(q, p, m, n, out, s);
    NARROW_CASE(1) NARROW_CASE(2) NARROW_CASE(3) NARROW_CASE(4)
    NARROW_CASE(5) NARROW_CASE(6) NARROW_CASE(7) NARROW_CASE(8)
    NARROW_CASE(9) NARROW_CASE(10) NARROW_CASE(11) NARROW_CASE(12)
    NARROW_CASE(13) NARROW_CASE(14) NARROW_CASE(15)
#undef NARROW_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// -- wide route -------------------------------------------------------------------
constexpr int kWideTile = 128;      // output rows and columns per tile
constexpr int kConsumers = 256;     // two warpgroups: wgmma + epilogue
constexpr int kWideThreads = 384;   // + one producer warpgroup (one thread)
constexpr int kAtom = 128;          // bytes of K per chunk (one swizzle row)
constexpr int kOperandBytes = kWideTile * kAtom;  // 16 KB: one operand chunk
constexpr int kEpiStride = kWideTile + 8;         // floats; conflict-free float2
constexpr int kEpiBytes = kWideTile * kEpiStride * 4;
constexpr int kPrepThreads = 256;
// per consumer warpgroup: |q|^2 of its 64 rows and |p|^2 of the 128 columns
constexpr int kNormBytes = 2 * (64 + kWideTile) * 4;

template <typename T>
struct Wide {
  static constexpr bool kTf32 = sizeof(T) == 4;
  // one stage: q hi, (q lo,) p hi, (p lo), each a 1024-byte aligned
  // 128-row x 128-byte tile as TMA's 128-byte swizzle writes it
  static constexpr int kOperands = kTf32 ? 4 : 2;
  static constexpr int kStage = kOperands * kOperandBytes;
  static constexpr int kStages = kTf32 ? 2 : 4;  // ring depth
  static constexpr int kBOffset = kStage / 2;    // p's tiles within a stage
  static constexpr int kSmem =
      1024 + kStages * kStage + kEpiBytes + kNormBytes + 128;
  static constexpr int kChunk = kAtom / sizeof(T);  // values per chunk
};

// Padded depth of the prepared operands: whole chunks, zero-filled.
template <typename T>
int64_t padded_depth(int d) {
  const int c = Wide<T>::kChunk;
  return ((int64_t)d + c - 1) / c * c;
}

// Scratch of the wide route: the (m + n) norms, then the prepared operands
// [q; p] at padded depth — f32 as TF32 hi and lo planes, bf16 as a copy.
template <typename T>
int64_t scratch_bytes(int m, int n, int d) {
  const int64_t rows = (int64_t)m + n;
  const int64_t norms = (rows * 4 + 1023) / 1024 * 1024;
  return norms + rows * padded_depth<T>(d) * (Wide<T>::kTf32 ? 8 : 2);
}

// Shared-memory matrix descriptor of a K-major, 128-byte-swizzled operand:
// 8-row groups 1024 bytes apart (SBO); LBO unused for this layout.
__device__ __forceinline__ uint64_t smem_desc(const void* ptr) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

#define WG_D_LIST                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "          \
  "%8, %9, %10, %11, %12, %13, %14, %15, "     \
  "%16, %17, %18, %19, %20, %21, %22, %23, "   \
  "%24, %25, %26, %27, %28, %29, %30, %31, "   \
  "%32, %33, %34, %35, %36, %37, %38, %39, "   \
  "%40, %41, %42, %43, %44, %45, %46, %47, "   \
  "%48, %49, %50, %51, %52, %53, %54, %55, "   \
  "%56, %57, %58, %59, %60, %61, %62, %63}, "
#define WG_D_OPS(d)                                                  \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),        \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),    \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),            \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),            \
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),            \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),            \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),            \
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]),            \
      "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),            \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),            \
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),            \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),            \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),            \
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]),            \
      "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),            \
      "+f"(d[62]), "+f"(d[63])

// d (64 x 128 per warpgroup, f32) += a (64 x 16 bf16) . b (128 x 16 bf16)^T
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D_LIST
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D_OPS(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 128 per warpgroup, f32) += a (64 x 8 tf32) . b (128 x 8 tf32)^T
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " WG_D_LIST
      "%64, %65, p, 1, 1;\n}\n"
      : WG_D_OPS(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One TMA tile load (x: column, y: row) into shared memory, completing on
// the barrier's transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// Pre-pass, one thread per row of [q; p]: |row|^2 in the plain version's
// order (dimension order, FMA-free), and the row prepared for the tensor
// cores at padded depth dp — f32 split into hi = rna_tf32(a) and
// lo = rna_tf32(a - hi), bf16 copied. Each 32-column slab of 256 rows is
// staged through shared memory so that loads and stores coalesce.
template <typename T>
__global__ void __launch_bounds__(kPrepThreads)
    pairwise_prep_kernel(const T* __restrict__ q, const T* __restrict__ p,
                         int m, int n, int d, int dp, float* __restrict__ norms,
                         void* __restrict__ ops) {
  __shared__ float slab[kPrepThreads][33];
  const int64_t base = (int64_t)blockIdx.x * kPrepThreads;
  const int64_t rows = (int64_t)m + n;
  const int64_t plane = rows * dp;  // the lo plane follows the hi plane
  float nrm = 0.0f;
  for (int k0 = 0; k0 < dp; k0 += 32) {
#pragma unroll 4
    for (int i = 0; i < 32; ++i) {
      const int e = threadIdx.x + i * kPrepThreads;
      const int64_t g = base + e / 32;
      const int k = k0 + e % 32;
      float v = 0.0f;
      if (g < rows && k < d)
        v = widen(g < m ? q[g * d + k] : p[(g - m) * d + k]);
      slab[e / 32][e % 32] = v;
    }
    __syncthreads();
    const int kc = min(32, d - k0);
    for (int kk = 0; kk < kc; ++kk) {
      const float v = slab[threadIdx.x][kk];
      nrm = __fadd_rn(nrm, __fmul_rn(v, v));
    }
#pragma unroll 4
    for (int i = 0; i < 32; ++i) {
      const int e = threadIdx.x + i * kPrepThreads;
      const int64_t g = base + e / 32;
      if (g >= rows) continue;
      const float v = slab[e / 32][e % 32];
      const int64_t at = g * dp + k0 + e % 32;
      if constexpr (Wide<T>::kTf32) {
        const float hi = tf32_rna(v);
        static_cast<float*>(ops)[at] = hi;
        static_cast<float*>(ops)[plane + at] = tf32_rna(__fsub_rn(v, hi));
      } else {
        static_cast<__nv_bfloat16*>(ops)[at] = __float2bfloat16_rn(v);  // exact
      }
    }
    __syncthreads();
  }
  if (base + threadIdx.x < rows) norms[base + threadIdx.x] = nrm;
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads, 1)
    pairwise_wide_kernel(const __grid_constant__ CUtensorMap tq_hi,
                         const __grid_constant__ CUtensorMap tq_lo,
                         const __grid_constant__ CUtensorMap tp_hi,
                         const __grid_constant__ CUtensorMap tp_lo,
                         const float* __restrict__ norms, int m, int n,
                         int nchunks, int row_tiles, int tiles,
                         float* __restrict__ out) {
  using W = Wide<T>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* tile_s = reinterpret_cast<float*>(smem + W::kStages * W::kStage);
  // full[s] at bars + 8s (the producer's expect_tx + TMA bytes), empty[s]
  // at bars + 64 + 8s (every consumer thread arrives)
  float* norm_s = tile_s + kWideTile * kEpiStride;
  const uint32_t bars = smem_addr(norm_s + kNormBytes / 4);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < W::kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 64 + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer: one thread keeps the ring of stages filled by TMA ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid != kConsumers) return;
    int c = 0;  // chunks issued so far (the ring position)
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int row0 = (t % row_tiles) * kWideTile;
      const int col0 = (t / row_tiles) * kWideTile;
      for (int ch = 0; ch < nchunks; ++ch, ++c) {
        const int s = c % W::kStages;
        mbar_wait(bars + 64 + 8 * s, ((c / W::kStages) & 1) ^ 1);
        const uint32_t full = bars + 8 * s;
        const uint32_t stage = smem_addr(smem + s * W::kStage);
        const int k = ch * W::kChunk;
        mbar_expect_tx(full, W::kStage);
        tma_load(stage, &tq_hi, k, row0, full);
        tma_load(stage + W::kBOffset, &tp_hi, k, col0, full);
        if constexpr (W::kTf32) {
          tma_load(stage + kOperandBytes, &tq_lo, k, row0, full);
          tma_load(stage + W::kBOffset + kOperandBytes, &tp_lo, k, col0, full);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: wgmma, then the epilogue ----
  const int wg = tid / 128;
  const int r = tid % 128;
  const int warp = r / 32;
  const int lane = tid % 32;
  float* qn_s = norm_s + wg * (64 + kWideTile);  // this warpgroup's rows
  float* pn_s = qn_s + 64;
  // the registers the producer gave up: the running sum and two fresh
  // accumulators (f32) per thread
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  float total[64];
  float fresh[64], fresh2[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) fresh[i] = fresh2[i] = 0.0f;
  bool stores_pending = false;
  int c = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int row0 = (t % row_tiles) * kWideTile;
    const int col0 = (t / row_tiles) * kWideTile;
    // the tile's norms, loaded now and staged at the epilogue
    const int qrow = row0 + wg * 64 + r;
    const float my_qn = r < 64 && qrow < m ? norms[qrow] : 0.0f;
    const float my_pn = col0 + r < n ? norms[m + col0 + r] : 0.0f;
#pragma unroll
    for (int i = 0; i < 64; ++i) total[i] = 0.0f;
    for (int ch = 0; ch < nchunks; ++ch, ++c) {
      const int s = c % W::kStages;
      mbar_wait(bars + 8 * s, (c / W::kStages) & 1);
      unsigned char* stage = smem + s * W::kStage;
      const uint64_t a_hi = smem_desc(stage + wg * 64 * kAtom);
      const uint64_t b_hi = smem_desc(stage + W::kBOffset);
      if constexpr (W::kTf32) {
        // 3xTF32: per 8-deep K step a fresh sum on the tensor cores (the
        // two small products first, the large one last), folded into the
        // running sum with a correctly rounded add, so the tensor cores'
        // truncating sums never run over more than one step. Two fresh
        // accumulators alternate: step s + 1 runs while step s is folded.
        const uint64_t a_lo = a_hi + (kOperandBytes >> 4);
        const uint64_t b_lo = b_hi + (kOperandBytes >> 4);
        auto step = [&](float (&acc)[64], int ks) {
          wgmma_tf32(acc, a_lo + 2 * ks, b_hi + 2 * ks, 0);
          wgmma_tf32(acc, a_hi + 2 * ks, b_lo + 2 * ks, 1);
          wgmma_tf32(acc, a_hi + 2 * ks, b_hi + 2 * ks, 1);
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        };
        auto fold = [&](float (&acc)[64]) {
          fence_acc(acc);
#pragma unroll
          for (int i = 0; i < 64; ++i) total[i] = __fadd_rn(total[i], acc[i]);
        };
        fence_acc(fresh);
        fence_acc(fresh2);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        step(fresh, 0);
        step(fresh2, 1);
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fold(fresh);
        fence_acc(fresh);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        step(fresh, 2);
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fold(fresh2);
        fence_acc(fresh2);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        step(fresh2, 3);
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fold(fresh);
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fold(fresh2);
      } else {
        // bf16: exact products, one f32 sum over the chunk
        fence_acc(total);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_bf16(total, a_hi + 2 * ks, b_hi + 2 * ks, 1);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc(total);
      }
      mbar_arrive(bars + 64 + 8 * s);
    }

    // epilogue: this warpgroup's 64 rows of the tile go through shared
    // memory, free once its last bulk copies have read it
    if (stores_pending) {
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      stores_pending = false;
    }
    if (r < 64) qn_s[r] = my_qn;
    pn_s[r] = my_pn;
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tr = warp * 16 + lane / 4 + 8 * h;  // within the warpgroup
      const float qn = qn_s[tr];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int tc = 8 * j + 2 * (lane % 4);
        const float2 pn = *reinterpret_cast<const float2*>(pn_s + tc);
        float2 o;
        o.x = fmaxf(__fsub_rn(__fadd_rn(qn, pn.x),
                              __fmul_rn(2.0f, total[4 * j + 2 * h])), 0.0f);
        o.y = fmaxf(__fsub_rn(__fadd_rn(qn, pn.y),
                              __fmul_rn(2.0f, total[4 * j + 2 * h + 1])),
                    0.0f);
        *reinterpret_cast<float2*>(tile_s + (wg * 64 + tr) * kEpiStride + tc) =
            o;
      }
    }
    // make the rows visible to the bulk-copy engine
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if ((n % 4 == 0) && col0 + kWideTile <= n) {
      // one 512-byte row per thread of the first two warps, drained by the
      // bulk-copy engine while the next tile is computed
      const int tr = wg * 64 + r;
      if (r < 64 && row0 + tr < m) {
        const float* gdst = out + (int64_t)(row0 + tr) * n + col0;
        asm volatile(
            "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::
                "l"(gdst),
            "r"(smem_addr(tile_s + tr * kEpiStride)), "r"(kWideTile * 4)
            : "memory");
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        stores_pending = true;
      }
    } else {
      // ragged tile: neighbouring threads on neighbouring columns
      for (int i = 0; i < 16; ++i) {
        const int tr = wg * 64 + warp * 16 + i;
        if (row0 + tr >= m) break;
        float* dst = out + (int64_t)(row0 + tr) * n + col0;
        const float* srow = tile_s + tr * kEpiStride;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cc = lane + 32 * e;
          if (col0 + cc < n) __stcs(dst + cc, srow[cc]);
        }
      }
    }
  }
  if (stores_pending)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// A 2-D map of `rows` x dp values of the prepared operands: boxes of one
// chunk x 128 rows, 128-byte swizzle, rows past the end read as zeros.
template <typename T>
bool encode_map(CUtensorMap* map, void* base, int rows, int64_t dp) {
  const cuuint64_t dims[2] = {(cuuint64_t)dp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)dp * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)Wide<T>::kChunk, kWideTile};
  const cuuint32_t unit[2] = {1, 1};
  return cuTensorMapEncodeTiled(
             map,
             Wide<T>::kTf32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             2, base, dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
cudaError_t launch_wide(const void* q, const void* p, int m, int n, int d,
                        void* scratch, void* out, cudaStream_t s) {
  using W = Wide<T>;
  const int64_t rows = (int64_t)m + n;
  const int64_t dp = padded_depth<T>(d);
  if (dp == 0 || dp > 0x7fffffff) return cudaErrorInvalidValue;
  float* norms = static_cast<float*>(scratch);
  unsigned char* ops = static_cast<unsigned char*>(scratch) +
                       (rows * 4 + 1023) / 1024 * 1024;
  pairwise_prep_kernel<T>
      <<<(unsigned)((rows + kPrepThreads - 1) / kPrepThreads), kPrepThreads,
         0, s>>>(static_cast<const T*>(q), static_cast<const T*>(p), m, n, d,
                 (int)dp, norms, ops);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int64_t plane = rows * dp * sizeof(T);  // f32: hi plane, lo plane
  const int64_t p_at = (int64_t)m * dp * sizeof(T);
  CUtensorMap maps[4];
  if (!encode_map<T>(&maps[0], ops, m, dp) ||
      !encode_map<T>(&maps[2], ops + p_at, n, dp))
    return cudaErrorInvalidValue;
  maps[1] = maps[0];
  maps[3] = maps[2];
  if (W::kTf32 && (!encode_map<T>(&maps[1], ops + plane, m, dp) ||
                   !encode_map<T>(&maps[3], ops + plane + p_at, n, dp)))
    return cudaErrorInvalidValue;

  auto kernel = pairwise_wide_kernel<T>;
  static bool attr_set = false;  // per instantiation
  if (!attr_set) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W::kSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int row_tiles = (m + kWideTile - 1) / kWideTile;
  const int64_t tiles = (int64_t)row_tiles * ((n + kWideTile - 1) / kWideTile);
  if (tiles > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const int blocks = (int)(tiles < sms ? tiles : sms);  // persistent
  kernel<<<blocks, kWideThreads, W::kSmem, s>>>(
      maps[0], maps[1], maps[2], maps[3], norms, m, n,
      (int)(dp / W::kChunk), row_tiles, (int)tiles, static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// D at which the wide route takes over (the Python wrapper reads it).
int pairwise_sq_l2_wide_min_d() { return kWideMinD; }

// Bytes of scratch a launch needs (0 on the narrow route).
long long pairwise_sq_l2_scratch_bytes(int dtype, int route, int m, int n,
                                       int d) {
  if (route != 1) return 0;
  return dtype == 1 ? scratch_bytes<__nv_bfloat16>(m, n, d)
                    : scratch_bytes<float>(m, n, d);
}

// dtype: 0 = f32, 1 = bf16 (q and p alike). route: 0 = narrow (CUDA cores,
// D < kWideMinD only), 1 = wide (wgmma; two launches, the prep pass into
// `scratch` — pairwise_sq_l2_scratch_bytes of it — then the product).
// out: (m, n) f32.
int pairwise_sq_l2_launch(int dtype, int route, const void* q, const void* p,
                          int m, int n, int d, void* scratch, void* out,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (route == 1) {
    err = dtype == 1
              ? launch_wide<__nv_bfloat16>(q, p, m, n, d, scratch, out, s)
              : launch_wide<float>(q, p, m, n, d, scratch, out, s);
  } else {
    err = dtype == 1 ? launch_narrow<__nv_bfloat16>(q, p, m, n, d, out, s)
                     : launch_narrow<float>(q, p, m, n, d, out, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
