// Hand-written Hopper (sm_90a) kernel for the centered-covariance matvec.
//
//   cov_matvec  replaces src/repro/kernels/cov_matvec.py:_kernel (behind
//               cov_matvec and power_iteration, the PCA step of the paper's
//               §3.2 split). For x (N, D) f32 or bf16 and f32 mean, w (D,)
//               it computes y = (X - mu)^T ((X - mu) w), y (D,) f32.
//
// Bound on this card: one streaming read of x (N * D * itemsize bytes) and
// 4ND operations — a few MB at the sizes the builder meets, so the launch,
// the memory latency and the shared-memory traffic weigh as much as the
// bytes. The design is one launch per call that streams x once from device
// memory through shared memory and keeps every intermediate on chip.
//
// The TPU kernel carries its (1, D) output block across a sequential grid;
// blocks on this card run in no order, so each block writes a partial and
// the LAST block to finish folds them (a __threadfence, then an atomic
// ticket in a counter the wrapper zeroes once per stream; that block resets
// it to 0). There are no float atomics: every sum is taken in one fixed
// order, so y is bitwise the same from run to run. Geometry (all of it a
// function of N and D alone, from ../cov_matvec.py `geometry`, `tile_rows`
// and `row_lanes`):
//
//   CW = min(256, next pow2 >= D) columns, G = 256 / CW row groups; thread
//   t is group g = t / CW, column c = t % CW, and owns columns c, c + CW, ...
//   Block b owns rows [b*R, min(N, (b+1)*R)), walked in tiles of T rows
//   (T a multiple of G, at most 4,096 values). Per tile:
//     load  the tile streams into a ring of three shared-memory stages by
//           cp.async (16 bytes a copy, two tiles ahead of the one being
//           summed); where x is not 16-byte aligned, the tile is read
//           element by element into one stage instead. Both phases read
//           the tile where it landed and compute xc = x - mu on the fly
//           ((mu_k, w_k) as one float2 in shared memory);
//     t     P = row_lanes(D) lanes a row: lane q sums xc_ik * w_k over the
//           columns k = q + P*s, s = 0 .. S-1 (S = ceil(D / P)), from 0;
//           rows wider than 4 start at s = (row mod 32) mod S and wrap
//           around, so a warp's rows read different banks; then a halving
//           tree over the P lanes (xor-shuffles) gives t_i;
//     sums  thread (g, c) adds t_i * xc_ic for the tile's rows i = g (mod
//           G), in order, to its running sum (starting from 0).
//   Group fold: within a warp (GW = 32 / CW groups when CW < 32) a halving
//   tree over the groups by xor-shuffles (offsets 16 .. CW lanes); then a
//   halving tree over the NW = G / GW warp sums (NW <= 8), one thread per
//   column. The block writes partial[b, :].
//   Last block: thread (f, c) sums partial[b, c] for b = f, f + G, ... in
//   order (32 loads in flight), then the same group fold gives y.
//
// Rows wider than 2,048 (kMaxColsPerThread * 256) take the wide route,
// cov_matvec_wide_kernel, chosen by D alone. The geometry above then has
// one row a tile (T = 1), CW = 256, G = 1 and P = 32 lanes a row, and the
// same order of sums holds: block b owns rows [b*R, min(N, (b+1)*R)) and
// walks them eight at a time, one warp a row. Warp v computes t_i of row
// i = base + v by the 32-lane rotated walk above, straight from device
// memory (mu and w through the read-only cache), and an xor tree; then
// thread c adds t_i * (x_ic - mu_c) for the eight rows in order to its
// running sums of columns c, c + 256, ... . Those D sums live in shared
// memory (4 * D bytes: 48 KB at D = 12,032) up to kWideSmemMaxD columns
// and in the block's own partial row in device memory above that, so any
// D runs. The last block sums partial[b, c] over b in order (G = 1: the
// group fold is the identity). Each row is read twice — the dot, then the
// column sums — the second time from L2 (eight rows of 48 KB at 12,032).
//
// Arithmetic: explicitly rounded intrinsics (__fsub_rn / __fmul_rn /
// __fadd_rn, never contracted to FMAs), in exactly the order above. The
// plain version in ../cov_matvec.py repeats that order with whole-tensor
// operations, so kernel and plain version agree bitwise.
//
// The C entry point launches once on the caller's stream, allocates nothing
// (the wrapper passes the (blocks, D) partials and the ticket counter) and
// returns cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;     // threads per block
constexpr int kWarp = 32;
constexpr int kTileValues = 4096; // a tile holds at most this many values
constexpr int kStages = 3;        // tiles in the cp.async ring
constexpr int kStageBytes = kTileValues * 4;  // one tile, raw
constexpr int kRowDotMaxD = 4;    // wider rows start their dot rotated
constexpr int kFoldLoads = 32;    // partials a thread loads at once
constexpr int kMaxColsPerThread = 8;  // D <= 8 * 256 = 2048, else wide
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kWideRows = kThreads / kWarp;  // rows a pass, one a warp
constexpr int kWideSmemMaxD = 56 * 1024;     // column sums in shared memory

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Layout {
  int d, cw, groups, gw, nw, cpt;
  int g, c;  // this thread's group and column

  __device__ explicit Layout(int d_) : d(d_) {
    cw = 1;
    while (cw < d && cw < kThreads) cw <<= 1;
    groups = kThreads / cw;
    gw = cw < kWarp ? kWarp / cw : 1;
    nw = groups / gw;
    cpt = (d + cw - 1) / cw;
    g = threadIdx.x / cw;
    c = threadIdx.x % cw;
  }
};

// The group fold of ../cov_matvec.py `_fold_groups`: acc[j] is this
// thread's sum for column c + j * CW; the result for every column lands in
// out[col] (a global pointer), written by one thread per column. `ws` is
// NW * D floats of shared memory. Called by every thread of the block.
template <int kCols>
__device__ void fold_groups(const Layout& L, float (&acc)[kCols], float* ws,
                            float* out) {
  // within a warp: xor-shuffles over its GW groups, highest bit first
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    if (j >= L.cpt) break;
    for (int off = kWarp / 2; off >= L.cw; off >>= 1)
      acc[j] = __fadd_rn(acc[j], __shfl_xor_sync(0xffffffffu, acc[j], off));
  }
  // the warp's (or, for CW >= 32, the group's) sums to shared memory
  const int wg = L.g / L.gw;  // this thread's index among the NW sums
  if (L.g % L.gw == 0) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = L.c + j * L.cw;
      if (j < L.cpt && col < L.d) ws[wg * L.d + col] = acc[j];
    }
  }
  __syncthreads();
  // halving tree over the NW sums, one thread per column
  for (int col = threadIdx.x; col < L.d; col += kThreads) {
    float v[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) v[w] = w < L.nw ? ws[w * L.d + col] : 0.f;
#pragma unroll
    for (int h = 4; h >= 1; h >>= 1)
      if (h < L.nw)
#pragma unroll
        for (int w = 0; w < h; ++w) v[w] = __fadd_rn(v[w], v[w + h]);
    out[col] = v[0];
  }
}

// 16 bytes global -> shared, asynchronous, L2 only; the bytes past
// `src_bytes` (< 16 at the end of x) are zero-filled and not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// kAsync: x 16-byte aligned and every tile a whole number of 16-byte
// units, so tiles stream through a kStages ring of shared-memory stages by
// cp.async, kStages - 1 tiles ahead of the one being summed; otherwise each
// tile is loaded element by element into stage 0 when it is summed. Both
// phases read the tile where it landed and subtract mu on the fly.
template <typename T, bool kAsync, int kCols>
__global__ void __launch_bounds__(kThreads)
    cov_matvec_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                      const float* __restrict__ w, long long n, int d,
                      int tile_rows, long long rows_per_block, int row_lanes,
                      float* __restrict__ partial,
                      unsigned* __restrict__ ticket, float* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_last;
  const Layout L(d);
  unsigned char* stages = smem_raw;  // [kStages or 1][kStageBytes]
  float2* mw = reinterpret_cast<float2*>(smem_raw + (kAsync ? kStages : 1) * kStageBytes);
  float* ws = reinterpret_cast<float*>(mw + d);  // [8d]: the NW * d group sums
  float* ts = ws + 8 * d;      // [tile_rows] t of the tile's rows
  for (int k = threadIdx.x; k < d; k += kThreads) mw[k] = make_float2(mean[k], w[k]);
  // this thread's columns' means, for the column sums
  float mu_c[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int col = L.c + j * L.cw;
    mu_c[j] = j < L.cpt && col < d ? mean[col] : 0.f;
  }

  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;

  const long long lo = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long hi = min(n, lo + rows_per_block);
  const int tiles = static_cast<int>((hi - lo + tile_rows - 1) / tile_rows);
  // tile `t` of this block into ring stage t % kStages (one commit group)
  auto issue = [&](int t) {
    if (t < tiles) {
      const long long r0 = lo + static_cast<long long>(t) * tile_rows;
      const long long bytes =
          min(static_cast<long long>(tile_rows), hi - r0) * d * sizeof(T);
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(x + r0 * d);
      unsigned char* dst = stages + (t % kStages) * kStageBytes;
      for (int u = threadIdx.x; u * 16 < bytes; u += kThreads)
        cp_async16(dst + u * 16, src + u * 16,
                   static_cast<int>(min(16LL, bytes - u * 16)));
    }
    cp_async_commit();
  };
  if constexpr (kAsync) {
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) issue(t);
  }
  for (int t = 0; t < tiles; ++t) {
    const long long r0 = lo + static_cast<long long>(t) * tile_rows;
    const int rows = static_cast<int>(min(static_cast<long long>(tile_rows), hi - r0));
    const T* xt;  // the tile, in shared memory
    if constexpr (kAsync) {
      cp_async_wait<kStages - 2>();  // this thread's units of tile t landed
      __syncthreads();  // tile t visible; tile t - 1 consumed
      issue(t + kStages - 1);  // into tile t - 1's stage
      xt = reinterpret_cast<const T*>(stages + (t % kStages) * kStageBytes);
    } else {
      __syncthreads();  // tile t - 1 consumed
      T* dst = reinterpret_cast<T*>(stages);
      for (int e = threadIdx.x; e < rows * d; e += kThreads) dst[e] = x[r0 * d + e];
      __syncthreads();
      xt = dst;
    }
    // t_i = sum_k (x_ik - mu_k) w_k by P = row_lanes lanes a row: lane q
    // sums columns q + P*s from 0, s = 0 .. S-1 (S = ceil(D / P)) in turn
    // starting at s = (row mod 32) mod S for rows wider than kRowDotMaxD
    // (so a warp's rows read different banks), then a halving tree over
    // the P lanes (xor-shuffles)
    const int per_pass = kThreads / row_lanes;
    const int q = threadIdx.x % row_lanes;
    const int steps = (d + row_lanes - 1) / row_lanes;
    for (int base = 0; base < rows; base += per_pass) {
      const int i = base + threadIdx.x / row_lanes;
      float tv = 0.f;
      if (i < rows) {
        const T* xr = xt + i * d;
        int st = d > kRowDotMaxD ? static_cast<int>((r0 + i) % kWarp) % steps : 0;
#pragma unroll 4
        for (int s0 = 0; s0 < steps; ++s0) {
          const int k = q + row_lanes * st;
          if (k < d) {
            const float2 m = mw[k];  // (mu_k, w_k)
            tv = __fadd_rn(tv, __fmul_rn(__fsub_rn(widen(xr[k]), m.x), m.y));
          }
          st = st + 1 == steps ? 0 : st + 1;
        }
      }
      for (int off = row_lanes / 2; off >= 1; off >>= 1)
        tv = __fadd_rn(tv, __shfl_xor_sync(0xffffffffu, tv, off));
      if (i < rows && q == 0) ts[i] = tv;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = L.c + j * L.cw;
      if (j >= L.cpt || col >= d) break;
      float a = acc[j];
#pragma unroll 4
      for (int i = L.g; i < rows; i += L.groups)
        a = __fadd_rn(a, __fmul_rn(ts[i], __fsub_rn(widen(xt[i * d + col]), mu_c[j])));
      acc[j] = a;
    }
  }
  if constexpr (kAsync) cp_async_wait<0>();  // no copy outlives the block
  __syncthreads();  // the tiles are consumed
  fold_groups(L, acc, ws, partial + static_cast<long long>(blockIdx.x) * d);

  // the last block to finish folds the partials
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned tk = atomicAdd(ticket, 1u);
    s_last = tk == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (threadIdx.x == 0) *ticket = 0u;  // zero again for the next launch
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int col = L.c + j * L.cw;
    if (j >= L.cpt || col >= d) break;
    // blocks g, g + G, ... in order; kFoldLoads loads in flight at a time
    const int nb = static_cast<int>(gridDim.x);
    const float* src = partial + col;
    float a = 0.f;
    int b = L.g;
    for (; b + (kFoldLoads - 1) * L.groups < nb; b += kFoldLoads * L.groups) {
      float v[kFoldLoads];
#pragma unroll
      for (int u = 0; u < kFoldLoads; ++u)
        v[u] = __ldcg(src + static_cast<long long>(b + u * L.groups) * d);
#pragma unroll
      for (int u = 0; u < kFoldLoads; ++u) a = __fadd_rn(a, v[u]);
    }
    for (; b < nb; b += L.groups)
      a = __fadd_rn(a, __ldcg(src + static_cast<long long>(b) * d));
    acc[j] = a;
  }
  fold_groups(L, acc, ws, y);
}

// The wide route (D > kMaxColsPerThread * kThreads): see the header. acc
// is shared memory (smem_acc) or this block's partial row itself; either
// way each thread reads and writes only its own columns c, c + 256, ... .
template <typename T>
__global__ void __launch_bounds__(kThreads)
    cov_matvec_wide_kernel(const T* __restrict__ x,
                           const float* __restrict__ mean,
                           const float* __restrict__ w, long long n, int d,
                           long long rows_per_block, int smem_acc,
                           float* __restrict__ partial,
                           unsigned* __restrict__ ticket,
                           float* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float ts[kWideRows];
  __shared__ int s_last;
  float* part = partial + static_cast<long long>(blockIdx.x) * d;
  float* acc = smem_acc ? reinterpret_cast<float*>(smem_raw) : part;
  for (int c = threadIdx.x; c < d; c += kThreads) acc[c] = 0.f;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int steps = (d + kWarp - 1) / kWarp;
  const long long lo = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long hi = min(n, lo + rows_per_block);
  for (long long base = lo; base < hi; base += kWideRows) {
    const int rows = static_cast<int>(min(static_cast<long long>(kWideRows), hi - base));
    if (warp < rows) {
      // t of row base + warp: lane q sums columns q + 32*s, s from
      // (row mod 32) mod S around to it, then the xor tree
      const long long row = base + warp;
      const T* xr = x + row * d;
      int st = static_cast<int>(row % kWarp) % steps;
      float tv = 0.f;
#pragma unroll 4
      for (int s0 = 0; s0 < steps; ++s0) {
        const int k = lane + kWarp * st;
        if (k < d)
          tv = __fadd_rn(tv, __fmul_rn(__fsub_rn(widen(xr[k]), __ldg(mean + k)),
                                       __ldg(w + k)));
        st = st + 1 == steps ? 0 : st + 1;
      }
      for (int off = kWarp / 2; off >= 1; off >>= 1)
        tv = __fadd_rn(tv, __shfl_xor_sync(0xffffffffu, tv, off));
      if (lane == 0) ts[warp] = tv;
    }
    __syncthreads();  // the pass's t values are in ts
    const T* xb = x + base * d;
    for (int c = threadIdx.x; c < d; c += kThreads) {
      const float mu = __ldg(mean + c);
      float a = acc[c];
      for (int i = 0; i < rows; ++i)
        a = __fadd_rn(a, __fmul_rn(ts[i], __fsub_rn(widen(xb[static_cast<long long>(i) * d + c]), mu)));
      acc[c] = a;
    }
    __syncthreads();  // ts is rewritten by the next pass
  }
  if (smem_acc)
    for (int c = threadIdx.x; c < d; c += kThreads) part[c] = acc[c];

  // the last block to finish sums the partials, blocks in order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned tk = atomicAdd(ticket, 1u);
    s_last = tk == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (threadIdx.x == 0) *ticket = 0u;  // zero again for the next launch
  const int nb = static_cast<int>(gridDim.x);
  for (int c = threadIdx.x; c < d; c += kThreads) {
    const float* src = partial + c;
    float a = 0.f;
    int b = 0;
    for (; b + kFoldLoads <= nb; b += kFoldLoads) {
      float v[kFoldLoads];
#pragma unroll
      for (int u = 0; u < kFoldLoads; ++u)
        v[u] = __ldcg(src + static_cast<long long>(b + u) * d);
#pragma unroll
      for (int u = 0; u < kFoldLoads; ++u) a = __fadd_rn(a, v[u]);
    }
    for (; b < nb; ++b) a = __fadd_rn(a, __ldcg(src + static_cast<long long>(b) * d));
    y[c] = a;
  }
}

// Raises the wide kernel's dynamic shared-memory ceiling to its largest
// request (kWideSmemMaxD columns) once per device, not on every launch: a
// launch asks for 4 * D bytes and runs with that much whatever the ceiling.
template <typename T>
int allow_wide_smem() {
  static std::atomic<unsigned long long> done{0};  // one bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_acquire) & bit) return 0;
  err = cudaFuncSetAttribute(
      cov_matvec_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(float) * kWideSmemMaxD));
  if (err != cudaSuccess) return static_cast<int>(err);
  done.fetch_or(bit, std::memory_order_release);
  return 0;
}

template <typename T>
int launch_wide(const void* x, const void* mean, const void* w, long long n,
                int d, long long rows_per_block, void* partial, void* ticket,
                void* y, cudaStream_t stream) {
  const long long blocks = (n + rows_per_block - 1) / rows_per_block;
  const int smem_acc = d <= kWideSmemMaxD;
  const size_t smem = smem_acc ? sizeof(float) * static_cast<size_t>(d) : 0;
  if (smem > kDefaultSmem) {
    const int err = allow_wide_smem<T>();
    if (err != 0) return err;
  }
  cov_matvec_wide_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(w), n, d, rows_per_block, smem_acc,
      static_cast<float*>(partial), static_cast<unsigned*>(ticket),
      static_cast<float*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* mean, const void* w, long long n, int d,
           int tile_rows, long long rows_per_block, int row_lanes,
           void* partial, void* ticket, void* y, cudaStream_t stream) {
  const long long blocks = (n + rows_per_block - 1) / rows_per_block;
  const bool async = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     (static_cast<size_t>(tile_rows) * d * sizeof(T)) % 16 == 0;
  const size_t smem = static_cast<size_t>(async ? kStages : 1) * kStageBytes +
                      sizeof(float) * (10 * static_cast<size_t>(d) + tile_rows);
  // one column a thread up to D = 256, else up to kMaxColsPerThread
  auto kernel = d <= kThreads
                    ? (async ? cov_matvec_kernel<T, true, 1>
                             : cov_matvec_kernel<T, false, 1>)
                    : (async ? cov_matvec_kernel<T, true, kMaxColsPerThread>
                             : cov_matvec_kernel<T, false, kMaxColsPerThread>);
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(w), n, d, tile_rows, rows_per_block, row_lanes,
      static_cast<float*>(partial), static_cast<unsigned*>(ticket),
      static_cast<float*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16 (x only; mean and w are f32). tile_rows and
// rows_per_block from ../cov_matvec.py `geometry` (rows_per_block a
// multiple of tile_rows, tile_rows a multiple of the row groups, at most
// kTileValues values a tile; for D > 2,048 the wide route, tile_rows 1 and
// row_lanes 32); partial: (blocks, d) f32 scratch with blocks =
// ceil(n / rows_per_block); ticket: one uint32, 0 at launch and 0 again
// after it; y: (d,) f32.
int cov_matvec_launch(int dtype, const void* x, const void* mean,
                      const void* w, long long n, int d, int tile_rows,
                      long long rows_per_block, int row_lanes, void* partial,
                      void* ticket, void* y, void* stream) {
  if (n <= 0 || d <= 0 || tile_rows <= 0 || rows_per_block % tile_rows != 0 ||
      row_lanes < 1 || row_lanes > kWarp || (row_lanes & (row_lanes - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > kMaxColsPerThread * kThreads) {  // the wide route: T = 1, P = 32
    if (tile_rows != 1 || row_lanes != kWarp)
      return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 1)
      return launch_wide<__nv_bfloat16>(x, mean, w, n, d, rows_per_block,
                                        partial, ticket, y, s);
    if (dtype == 0)
      return launch_wide<float>(x, mean, w, n, d, rows_per_block, partial,
                                ticket, y, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<long long>(tile_rows) * d > kTileValues)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, mean, w, n, d, tile_rows, rows_per_block,
                                 row_lanes, partial, ticket, y, s);
  if (dtype == 0)
    return launch<float>(x, mean, w, n, d, tile_rows, rows_per_block,
                         row_lanes, partial, ticket, y, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
