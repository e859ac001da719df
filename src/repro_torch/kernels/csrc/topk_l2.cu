// Hand-written Hopper (sm_90a) kernels for the constrained top-k scans.
//
// Two kernels, one selection structure:
//
//   leaf_topk  replaces src/repro/kernels/topk_l2.py:_leaf_kernel (behind
//              leaf_topk_l2_raw and leaf_topk_l2). Each row r scans its OWN
//              (C, D) candidate matrix — the gathered leaf frontier of one
//              (segment, query) pair — in the difference form
//              sum_d (q_d - c_d)^2, widened from f32 / bf16 / int8 x pow2
//              scale, masks gid < 0 and sq > r_sq, and keeps the k smallest
//              by the lexicographic key (sq, slot).
//              Bound on this card: device-memory bytes. Every candidate is
//              read once and used once (a few flops per byte), so the
//              design streams each row's candidates with coalesced loads
//              (one warp per row, lane j reads candidate base + j) and keeps
//              everything else — the running k-best — in shared memory.
//
//   topk_l2    replaces src/repro/kernels/topk_l2.py:_kernel (behind
//              topk_l2, the delta-arena scan). All Q queries scan one shared
//              (N, D) point set in the expansion form q.q + p.p - 2 q.p,
//              clamp at 0, gate on liveness and the squared radius, and keep
//              the k smallest by (sq, slot).
//              Bound on this card: at the main path's N = 4096, D = 2 the
//              bytes (a 32 KB arena) and the distance flops (~9 per pair)
//              take microseconds, and so does a launch; the selection work
//              bounds it (a ballot and a threshold compare per pair, plus
//              the serial insertions: ~0.11 ms at Q = 5300 on an H100).
//              The design shares each tile of points through shared memory
//              between the block's warps (one warp per query), so the arena
//              is read from device memory once per block, and rejects most
//              candidates with one compare against the warp's k-th key.
//
// Selection (both kernels): each warp owns a sorted k-list in shared memory.
// Candidates arrive 32 at a time, one per lane; lanes whose key beats the
// list's k-th key are inserted one by one (lowest lane first): the warp
// counts the entries below the new key, shifts the tail right by one and
// writes the new entry. Keys are unique (slots are), so the final list is
// the unique sorted k-smallest set whatever the insertion order.
//
// Arithmetic: every sum is taken in one fixed order with explicitly
// rounded intrinsics (__fsub_rn / __fmul_rn / __fadd_rn), which nvcc never
// contracts into FMAs. The plain PyTorch versions in ../topk_l2.py repeat
// the same operations in the same order, so kernel and plain version agree
// bitwise, and the leaf kernel's sums equal the traversal's in-loop leaf
// evaluation (`leaf_sq` in ../topk_l2.py) bit for bit.
//
// Every C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kI32Max = 2147483647;
constexpr int kLeafWarps = 4;   // rows per block of leaf_topk
constexpr int kScanWarps = 8;   // queries per block of topk_l2
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ bool key_less(float asq, int aslot, float bsq,
                                         int bslot) {
  return asq < bsq || (asq == bsq && aslot < bslot);
}

// One warp's ascending k-list, three parallel arrays in shared memory.
struct WarpList {
  float* sq;
  int* slot;
  int* gid;
  int k;

  __device__ void init(int lane) {
    for (int i = lane; i < k; i += kWarp) {
      sq[i] = __int_as_float(0x7f800000);  // +inf
      slot[i] = kI32Max;
      gid[i] = -1;
    }
    __syncwarp();
  }

  // Every lane offers one candidate (masked lanes offer (+inf, I32_MAX),
  // which never beats the list). Must be called by all 32 lanes.
  __device__ void offer(int lane, float csq, int cslot, int cgid) {
    const bool pass = key_less(csq, cslot, sq[k - 1], slot[k - 1]);
    unsigned mask = __ballot_sync(kFull, pass);
    while (mask) {
      const int src = __ffs(mask) - 1;
      mask &= mask - 1;
      const float nsq = __shfl_sync(kFull, csq, src);
      const int nslot = __shfl_sync(kFull, cslot, src);
      const int ngid = __shfl_sync(kFull, cgid, src);
      // the list may have tightened since the ballot (warp-uniform test:
      // every lane reads the same shared entries)
      if (!key_less(nsq, nslot, sq[k - 1], slot[k - 1])) continue;
      int below = 0;
      for (int i = lane; i < k; i += kWarp)
        below += key_less(sq[i], slot[i], nsq, nslot) ? 1 : 0;
      for (int off = kWarp / 2; off > 0; off >>= 1)
        below += __shfl_xor_sync(kFull, below, off);
      const int pos = below;  // < k, since the new key beats entry k-1
      // shift [pos, k-1) right by one, highest chunk first so every read
      // of entry i-1 precedes its own overwrite
      for (int base = ((k - 1) / kWarp) * kWarp; base >= 0; base -= kWarp) {
        const int i = base + lane;
        const bool mv = i > pos && i < k;
        float vs = 0.f;
        int vsl = 0, vg = 0;
        if (mv) {
          vs = sq[i - 1];
          vsl = slot[i - 1];
          vg = gid[i - 1];
        }
        __syncwarp();
        if (mv) {
          sq[i] = vs;
          slot[i] = vsl;
          gid[i] = vg;
        }
        __syncwarp();
      }
      if (lane == 0) {
        sq[pos] = nsq;
        slot[pos] = nslot;
        gid[pos] = ngid;
      }
      __syncwarp();
    }
  }

  __device__ void store(int lane, size_t row, float* out_sq, int* out_gid,
                        int* out_slot) const {
    for (int i = lane; i < k; i += kWarp) {
      out_sq[row * k + i] = sq[i];
      out_gid[row * k + i] = gid[i];
      out_slot[row * k + i] = slot[i];
    }
  }
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(int8_t v) {
  return static_cast<float>(v);
}

template <typename T, bool kScale>
__global__ void __launch_bounds__(kLeafWarps * kWarp)
    leaf_topk_kernel(const float* __restrict__ q, const T* __restrict__ cands,
                     const float* __restrict__ cscale,
                     const int* __restrict__ cgids,
                     const float* __restrict__ r_sq, int R, int C, int D,
                     int k, float* __restrict__ out_sq,
                     int* __restrict__ out_gid, int* __restrict__ out_slot) {
  extern __shared__ unsigned char smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int row = blockIdx.x * kLeafWarps + warp;
  if (row >= R) return;  // the whole warp leaves together; no block barrier

  float* all_sq = reinterpret_cast<float*>(smem);
  int* all_slot = reinterpret_cast<int*>(all_sq + kLeafWarps * k);
  int* all_gid = all_slot + kLeafWarps * k;
  WarpList list{all_sq + warp * k, all_slot + warp * k, all_gid + warp * k,
                k};
  list.init(lane);

  const float rs = r_sq[row];
  const float* qr = q + static_cast<size_t>(row) * D;
  const T* cr = cands + static_cast<size_t>(row) * C * D;
  const int* gr = cgids + static_cast<size_t>(row) * C;
  const float* sr = kScale ? cscale + static_cast<size_t>(row) * C : nullptr;

  for (int base = 0; base < C; base += kWarp) {
    const int j = base + lane;
    float sq = __int_as_float(0x7f800000);
    int slot = kI32Max, g = -1;
    if (j < C) {
      const int gid = gr[j];
      const float sc = kScale ? sr[j] : 1.f;
      float acc = 0.f;
      for (int d = 0; d < D; ++d) {
        float c = widen(cr[static_cast<size_t>(j) * D + d]);
        if (kScale) c = __fmul_rn(c, sc);  // exact: pow2 scale
        const float t = __fsub_rn(qr[d], c);
        acc = __fadd_rn(acc, __fmul_rn(t, t));
      }
      if (gid >= 0 && acc <= rs) {
        sq = acc;
        slot = j;
        g = gid;
      }
    }
    list.offer(lane, sq, slot, g);
  }
  list.store(lane, row, out_sq, out_gid, out_slot);
}

__global__ void __launch_bounds__(kScanWarps * kWarp)
    topk_l2_kernel(const float* __restrict__ q, const float* __restrict__ p,
                   const int* __restrict__ gids,
                   const float* __restrict__ r_sq, int Q, int N, int D, int k,
                   int tile, float* __restrict__ out_sq,
                   int* __restrict__ out_gid, int* __restrict__ out_slot) {
  extern __shared__ unsigned char smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int row = blockIdx.x * kScanWarps + warp;
  const bool active = row < Q;  // no early exit: the block shares barriers

  float* tp = reinterpret_cast<float*>(smem);  // (tile, D) points
  float* tpn = tp + static_cast<size_t>(tile) * D;  // (tile,) |p|^2
  int* tg = reinterpret_cast<int*>(tpn + tile);     // (tile,) gids
  float* all_sq = reinterpret_cast<float*>(tg + tile);
  int* all_slot = reinterpret_cast<int*>(all_sq + kScanWarps * k);
  int* all_gid = all_slot + kScanWarps * k;
  WarpList list{all_sq + warp * k, all_slot + warp * k, all_gid + warp * k,
                k};

  const float* qr = q + static_cast<size_t>(active ? row : 0) * D;
  float qn = 0.f;
  for (int d = 0; d < D; ++d) qn = __fadd_rn(qn, __fmul_rn(qr[d], qr[d]));
  const float rs = active ? r_sq[row] : 0.f;
  list.init(lane);

  for (int t0 = 0; t0 < N; t0 += tile) {
    const int nt = min(tile, N - t0);
    __syncthreads();  // the previous tile is fully consumed
    for (int i = threadIdx.x; i < nt * D; i += blockDim.x)
      tp[i] = p[static_cast<size_t>(t0) * D + i];
    for (int i = threadIdx.x; i < nt; i += blockDim.x) tg[i] = gids[t0 + i];
    __syncthreads();
    for (int i = threadIdx.x; i < nt; i += blockDim.x) {
      float s = 0.f;
      for (int d = 0; d < D; ++d)
        s = __fadd_rn(s, __fmul_rn(tp[i * D + d], tp[i * D + d]));
      tpn[i] = s;
    }
    __syncthreads();
    if (!active) continue;
    for (int base = 0; base < nt; base += kWarp) {
      const int j = base + lane;
      float sq = __int_as_float(0x7f800000);
      int slot = kI32Max, g = -1;
      if (j < nt) {
        float dot = 0.f;
        for (int d = 0; d < D; ++d)
          dot = __fadd_rn(dot, __fmul_rn(qr[d], tp[j * D + d]));
        float v = __fsub_rn(__fadd_rn(qn, tpn[j]), __fmul_rn(2.f, dot));
        v = v < 0.f ? 0.f : v;
        const int gid = tg[j];
        if (gid >= 0 && v <= rs) {
          sq = v;
          slot = t0 + j;
          g = gid;
        }
      }
      list.offer(lane, sq, slot, g);
    }
  }
  if (active) list.store(lane, row, out_sq, out_gid, out_slot);
}

template <typename Kernel>
cudaError_t prepare_smem(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, bool kScale>
cudaError_t launch_leaf(const void* q, const void* cands, const void* cscale,
                        const void* cgids, const void* r_sq, int R, int C,
                        int D, int k, void* out_sq, void* out_gid,
                        void* out_slot, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kLeafWarps) * k * 12;
  auto kernel = leaf_topk_kernel<T, kScale>;
  cudaError_t err = prepare_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (R + kLeafWarps - 1) / kLeafWarps;
  kernel<<<blocks, kLeafWarps * kWarp, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(cands),
      static_cast<const float*>(cscale), static_cast<const int*>(cgids),
      static_cast<const float*>(r_sq), R, C, D, k,
      static_cast<float*>(out_sq), static_cast<int*>(out_gid),
      static_cast<int*>(out_slot));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = int8 (cscale required).
int leaf_topk_launch(int dtype, const void* q, const void* cands,
                     const void* cscale, const void* cgids, const void* r_sq,
                     int R, int C, int D, int k, void* out_sq, void* out_gid,
                     void* out_slot, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_leaf<float, false>(q, cands, cscale, cgids, r_sq, R, C, D,
                                       k, out_sq, out_gid, out_slot, s);
    case 1:
      return launch_leaf<__nv_bfloat16, false>(q, cands, cscale, cgids, r_sq,
                                               R, C, D, k, out_sq, out_gid,
                                               out_slot, s);
    case 2:
      return launch_leaf<int8_t, true>(q, cands, cscale, cgids, r_sq, R, C, D,
                                       k, out_sq, out_gid, out_slot, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// tile: points per shared-memory tile, chosen by the caller.
int topk_l2_launch(const void* q, const void* p, const void* gids,
                   const void* r_sq, int Q, int N, int D, int k, int tile,
                   void* out_sq, void* out_gid, void* out_slot,
                   void* stream) {
  const size_t smem = static_cast<size_t>(tile) * (D + 2) * 4 +
                      static_cast<size_t>(kScanWarps) * k * 12;
  cudaError_t err = prepare_smem(topk_l2_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (Q + kScanWarps - 1) / kScanWarps;
  topk_l2_kernel<<<blocks, kScanWarps * kWarp, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(p),
      static_cast<const int*>(gids), static_cast<const float*>(r_sq), Q, N, D,
      k, tile, static_cast<float*>(out_sq), static_cast<int*>(out_gid),
      static_cast<int*>(out_slot));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
