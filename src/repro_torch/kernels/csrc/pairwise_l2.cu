// Hand-written Hopper (sm_90a) kernel for the blocked squared-L2 matrix.
//
//   pairwise_sq_l2  replaces src/repro/kernels/pairwise_l2.py:_kernel (behind
//                   pairwise_sq_l2, pairwise_l2 and lower_bounds). For q (M, D)
//                   and p (N, D), f32 or bf16, it writes the (M, N) f32 matrix
//                   (|q|^2 + |p|^2) - 2 q.p, clamped at 0 — the expansion form
//                   of the TPU kernel, which clamps after its last K step.
//
// Bound on this card: at small D (the tree's D = 2, where every query meets
// every node center) the (M, N) f32 output is the traffic and the kernel is
// bound by device-memory bytes; at wide D (D = 128) the 2MND operations of
// the product bound it, on the CUDA cores: no tensor cores here, because
// they would change the rounding the plain version repeats.
//
// Design: one 64 x 64 output tile per block of 256 threads, each thread a
// 4 x 4 micro-tile (rows ty*4.., columns tx*4..). The K loop walks D in
// chunks of 16: each chunk of q and p rows is staged in shared memory,
// transposed ([k][row]), widened from bf16 to f32 on the way in. Inside a
// chunk every thread accumulates its 16 dot products. The norms ride in the
// same K loop: threads 0..63 each own one q row's |q|^2, threads 64..127 one
// p row's |p|^2, summed from the staged chunk. After the loop the norms go
// through shared memory to the threads that need them.
//
// Arithmetic: every sum runs over k = 0..D-1 in order, with explicitly
// rounded intrinsics (__fmul_rn / __fadd_rn / __fsub_rn, never contracted to
// FMAs), and the final value is ((qn + pn) - 2 * qp) clamped at 0: the plain
// version in ../pairwise_l2.py (the topk_l2 kernel's expansion form) repeats
// exactly these operations, so kernel and plain version agree bitwise.
//
// Ragged M, N, D are masked (zero-filled chunks add nothing to any sum);
// output offsets are 64-bit (M * N passes 2^31 at the shapes it serves).
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;     // output rows and columns per block
constexpr int kChunk = 16;    // K values staged per step
constexpr int kMicro = 4;     // rows / columns per thread
constexpr int kThreads = 256; // (kTile / kMicro)^2
constexpr int kPad = 4;       // keeps [k][row] rows 16-byte aligned

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, int rows,
                                      int d, int row0, int k0,
                                      float (*dst)[kTile + kPad]) {
  // kTile x kChunk values, 4 per thread; consecutive threads read
  // consecutive k of one row
  for (int e = threadIdx.x; e < kTile * kChunk; e += kThreads) {
    const int r = e / kChunk;
    const int kk = e % kChunk;
    const int row = row0 + r;
    const int k = k0 + kk;
    float v = 0.0f;
    if (row < rows && k < d) v = widen(src[(int64_t)row * d + k]);
    dst[kk][r] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pairwise_sq_l2_kernel(const T* __restrict__ q, const T* __restrict__ p,
                          int m, int n, int d, float* __restrict__ out) {
  __shared__ __align__(16) float qs[kChunk][kTile + kPad];
  __shared__ __align__(16) float ps[kChunk][kTile + kPad];
  __shared__ float qn_s[kTile];
  __shared__ float pn_s[kTile];

  const int tx = threadIdx.x % (kTile / kMicro);
  const int ty = threadIdx.x / (kTile / kMicro);
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.0f;
  float nrm = 0.0f;  // threads < 2 * kTile: one row's norm

  for (int k0 = 0; k0 < d; k0 += kChunk) {
    stage(q, m, d, row0, k0, qs);
    stage(p, n, d, col0, k0, ps);
    __syncthreads();
    const int kc = min(kChunk, d - k0);
    if (threadIdx.x < 2 * kTile) {
      float (*src)[kTile + kPad] = threadIdx.x < kTile ? qs : ps;
      const int r = threadIdx.x % kTile;
      for (int kk = 0; kk < kc; ++kk) {
        const float v = src[kk][r];
        nrm = __fadd_rn(nrm, __fmul_rn(v, v));
      }
    }
#pragma unroll 4
    for (int kk = 0; kk < kc; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&qs[kk][ty * kMicro]);
      const float4 b = *reinterpret_cast<const float4*>(&ps[kk][tx * kMicro]);
      const float av[kMicro] = {a.x, a.y, a.z, a.w};
      const float bv[kMicro] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j)
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(av[i], bv[j]));
    }
    __syncthreads();
  }
  if (threadIdx.x < kTile) {
    qn_s[threadIdx.x] = nrm;
  } else if (threadIdx.x < 2 * kTile) {
    pn_s[threadIdx.x - kTile] = nrm;
  }
  __syncthreads();

  const bool vec = (n % 4 == 0) && (col0 + tx * kMicro + kMicro <= n);
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int row = row0 + ty * kMicro + i;
    if (row >= m) break;
    const float qn = qn_s[ty * kMicro + i];
    float v[kMicro];
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const float s = __fadd_rn(qn, pn_s[tx * kMicro + j]);
      v[j] = fmaxf(__fsub_rn(s, __fmul_rn(2.0f, acc[i][j])), 0.0f);
    }
    float* dst = out + (int64_t)row * n + col0 + tx * kMicro;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kMicro; ++j)
        if (col0 + tx * kMicro + j < n) dst[j] = v[j];
    }
  }
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16 (q and p alike). out: (m, n) f32.
int pairwise_sq_l2_launch(int dtype, const void* q, const void* p, int m,
                          int n, int d, void* out, void* stream) {
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    pairwise_sq_l2_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(p), m, n, d,
        static_cast<float*>(out));
  } else {
    pairwise_sq_l2_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(p), m, n, d,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
