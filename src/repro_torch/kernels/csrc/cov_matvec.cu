// Hand-written Hopper (sm_90a) kernel for the centered-covariance matvec.
//
//   cov_matvec  replaces src/repro/kernels/cov_matvec.py:_kernel (behind
//               cov_matvec and power_iteration, the PCA step of the paper's
//               §3.2 split). For x (N, D) f32 or bf16 and f32 mean, w (D,)
//               it computes y = (X - mu)^T ((X - mu) w), y (D,) f32.
//
// Bound on this card: one streaming read of x (N * D * itemsize bytes) and
// 4ND operations — a few MB at the sizes the builder meets, so a launch
// (microseconds) outweighs both. The design therefore reads x once per
// block with coalesced loads and keeps every intermediate on chip.
//
// The TPU kernel carries its (1, D) output block across a sequential grid;
// blocks on this card run in no order, so the sum is split in two passes,
// and there are no float atomics: y is bitwise the same from run to run.
//
//   pass 1 (cov_partial_kernel): block b owns rows [b*R, min(N, (b+1)*R)),
//     R a multiple of 256, walked in tiles of 256 rows. Per tile, thread i
//     computes t_i = sum_k (x_ik - mu_k) w_k for row i (k in order) into
//     shared memory; then the threads are split into `groups` row groups
//     times min(D, 256) columns, and thread (g, k) adds t_i * (x_ik - mu_k)
//     for the tile's rows i = g (mod groups), in order, to its running sum.
//     groups = the largest power of two <= 256 / min(D, 256), so a narrow D
//     still keeps the block busy. The group sums are folded by a fixed
//     halving tree (acc[g] += acc[g + s] for s = groups/2, ..., 1) and the
//     block writes its partial row partial[b, :].
//   pass 2 (cov_reduce_kernel): one block per column k: thread j sums
//     partial[b, k] for b = j, j + 256, ... in order, then a fixed halving
//     tree over the 256 thread sums gives y_k.
//
// Arithmetic: explicitly rounded intrinsics (__fsub_rn / __fmul_rn /
// __fadd_rn, never contracted to FMAs), in exactly the order above. The
// plain version in ../cov_matvec.py repeats that order with whole-tensor
// operations, so kernel and plain version agree bitwise.
//
// The C entry point launches both passes on the caller's stream, allocates
// nothing (the wrapper passes the (blocks, D) scratch) and returns
// cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;  // threads per block, rows per tile

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cov_partial_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                       const float* __restrict__ w, int n, int d,
                       int rows_per_block, int groups,
                       float* __restrict__ partial) {
  extern __shared__ float smem[];
  float* ts = smem;             // [kThreads]: t of the tile's rows
  float* acc = smem + kThreads; // [groups][d]
  const int dc = min(d, kThreads);
  const int g = threadIdx.x / dc;
  const int col = threadIdx.x % dc;
  const bool active = g < groups;
  if (active)
    for (int k = col; k < d; k += kThreads) acc[g * d + k] = 0.0f;

  const long long lo = (long long)blockIdx.x * rows_per_block;
  const long long hi = min((long long)n, lo + rows_per_block);
  for (long long base = lo; base < hi; base += kThreads) {
    const long long row = base + threadIdx.x;
    float t = 0.0f;
    if (row < hi) {
      const T* xr = x + row * d;
      for (int k = 0; k < d; ++k)
        t = __fadd_rn(t, __fmul_rn(__fsub_rn(widen(xr[k]), mean[k]), w[k]));
    }
    ts[threadIdx.x] = t;
    __syncthreads();
    if (active) {
      const int cnt = (int)min((long long)kThreads, hi - base);
      for (int k = col; k < d; k += kThreads) {
        const float mu = mean[k];
        float a = acc[g * d + k];
        for (int i = g; i < cnt; i += groups) {
          const float xc = __fsub_rn(widen(x[(base + i) * d + k]), mu);
          a = __fadd_rn(a, __fmul_rn(ts[i], xc));
        }
        acc[g * d + k] = a;
      }
    }
    __syncthreads();
  }
  for (int s = groups / 2; s >= 1; s /= 2) {
    if (g < s)
      for (int k = col; k < d; k += kThreads)
        acc[g * d + k] = __fadd_rn(acc[g * d + k], acc[(g + s) * d + k]);
    __syncthreads();
  }
  if (g == 0)
    for (int k = col; k < d; k += kThreads)
      partial[(long long)blockIdx.x * d + k] = acc[k];
}

__global__ void __launch_bounds__(kThreads)
    cov_reduce_kernel(const float* __restrict__ partial, int blocks, int d,
                      float* __restrict__ y) {
  __shared__ float v[kThreads];
  const int k = blockIdx.x;
  float a = 0.0f;
  for (int b = threadIdx.x; b < blocks; b += kThreads)
    a = __fadd_rn(a, partial[(long long)b * d + k]);
  v[threadIdx.x] = a;
  __syncthreads();
  for (int s = kThreads / 2; s >= 1; s /= 2) {
    if (threadIdx.x < s)
      v[threadIdx.x] = __fadd_rn(v[threadIdx.x], v[threadIdx.x + s]);
    __syncthreads();
  }
  if (threadIdx.x == 0) y[k] = v[0];
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16 (x only; mean and w are f32). partial: (blocks,
// d) f32 scratch with blocks = ceil(n / rows_per_block); y: (d,) f32.
int cov_matvec_launch(int dtype, const void* x, const void* mean,
                      const void* w, int n, int d, int rows_per_block,
                      int groups, void* partial, void* y, void* stream) {
  const int blocks =
      (int)(((long long)n + rows_per_block - 1) / rows_per_block);
  const size_t smem = sizeof(float) * (kThreads + (size_t)groups * d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    cov_partial_kernel<__nv_bfloat16><<<blocks, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(mean),
        static_cast<const float*>(w), n, d, rows_per_block, groups,
        static_cast<float*>(partial));
  } else {
    cov_partial_kernel<float><<<blocks, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(mean),
        static_cast<const float*>(w), n, d, rows_per_block, groups,
        static_cast<float*>(partial));
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cov_reduce_kernel<<<d, kThreads, 0, s>>>(static_cast<const float*>(partial),
                                           blocks, d, static_cast<float*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
