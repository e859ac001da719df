// Hand-written Hopper (sm_90a) kernels for the constrained top-k scans.
//
// Two kernels:
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
//              design keeps loads in flight and selection cheap: one warp
//              per row streams the row's candidates, gids and (int8) scales
//              with 16-byte vector loads, neighbouring lanes on neighbouring
//              addresses (at D = 2: 4 bf16, 2 f32 or 8 int8 candidates a
//              lane), two steps ahead of the selection; rows whose bases
//              are not aligned, and other depths, take element loads. For
//              k <= 32 the k-best lives in registers, one entry a lane: a
//              candidate that does not beat the warp-uniform k-th key is
//              dropped with one compare, the rest are compacted (ballot +
//              popc) into a per-warp buffer and merged 32 at a time by a
//              warp bitonic network, which also refreshes the threshold.
//              For k > 32 the shared-memory insertion list below.
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
// The shared-memory insertion list (topk_l2, and leaf_topk for k > 32):
// each warp owns a sorted k-list in shared memory. Candidates arrive 32 at a
// time, one per lane; lanes whose key beats the list's k-th key are
// inserted one by one (lowest lane first): the warp counts the entries
// below the new key, shifts the tail right by one and writes the new entry.
// Keys are unique (slots are), so every list is the unique sorted
// k-smallest set whatever the order of insertion or merging.
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
constexpr int kLeafWarps = 8;   // rows per block of leaf_topk
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

// -- leaf_topk ------------------------------------------------------------------

// One warp's k-best for k <= 32, in registers: lane i holds the i-th
// smallest entry by (sq, slot), lanes >= k and empty places hold the
// sentinel (+inf, I32_MAX, -1). Survivors of the threshold wait in a
// per-warp shared buffer and are merged 32 at a time with a warp bitonic
// network. The threshold (the k-th key) is warp-uniform: every lane reads
// it from lane k - 1 after each merge.
struct RegList {
  float sq;
  int slot, gid;
  float th_sq;  // the k-th key
  int th_slot;
  int k;

  __device__ void init(int kk) {
    sq = __int_as_float(0x7f800000);
    slot = kI32Max;
    gid = -1;
    th_sq = sq;
    th_slot = slot;
    k = kk;
  }

  __device__ bool beats(float s, int sl) const {
    return key_less(s, sl, th_sq, th_slot);
  }

  // One compare-exchange stage of a bitonic network over the lanes: the
  // lane keeps the smaller of (own, partner across `j`) when `keep_min`.
  __device__ static void stage(float& s, int& sl, int& g, int j,
                               bool keep_min) {
    const float os = __shfl_xor_sync(kFull, s, j);
    const int osl = __shfl_xor_sync(kFull, sl, j);
    const int og = __shfl_xor_sync(kFull, g, j);
    if (key_less(os, osl, s, sl) == keep_min) {
      s = os;
      sl = osl;
      g = og;
    }
  }

  // Merge 32 entries, one per lane, into the list; keys are unique except
  // sentinels, which are identical, so any network order is exact.
  __device__ void merge(int lane, float s, int sl, int g) {
    // sort the batch ascending
#pragma unroll
    for (int kk = 2; kk <= kWarp; kk <<= 1)
#pragma unroll
      for (int j = kk >> 1; j > 0; j >>= 1)
        stage(s, sl, g, j, ((lane & j) == 0) == ((lane & kk) == 0));
    // the 32 smallest of list and batch: list[i] against batch[31 - i]
    // (a bitonic sequence), then a bitonic merge
    const float rs = __shfl_sync(kFull, s, kWarp - 1 - lane);
    const int rsl = __shfl_sync(kFull, sl, kWarp - 1 - lane);
    const int rg = __shfl_sync(kFull, g, kWarp - 1 - lane);
    if (key_less(rs, rsl, sq, slot)) {
      sq = rs;
      slot = rsl;
      gid = rg;
    }
#pragma unroll
    for (int j = kWarp / 2; j > 0; j >>= 1)
      stage(sq, slot, gid, j, (lane & j) == 0);
    th_sq = __shfl_sync(kFull, sq, k - 1);
    th_slot = __shfl_sync(kFull, slot, k - 1);
  }
};

// The per-warp survivor buffer of the register list.
struct Survivors {
  float* sq;
  int* slot;
  int* gid;
  int count;  // warp-uniform

  // Compact the lanes that pass into the buffer (ballot + popc).
  __device__ void push(int lane, bool pass, float s, int sl, int g) {
    const unsigned m = __ballot_sync(kFull, pass);
    if (pass) {
      const int at = count + __popc(m & ((1u << lane) - 1));
      sq[at] = s;
      slot[at] = sl;
      gid[at] = g;
    }
    count += __popc(m);
  }

  // Merge everything buffered into the list, 32 entries at a time.
  __device__ void drain(int lane, RegList& list) {
    __syncwarp();
    for (int i = 0; i < count; i += kWarp) {
      float s = __int_as_float(0x7f800000);
      int sl = kI32Max, g = -1;
      if (i + lane < count) {
        s = sq[i + lane];
        sl = slot[i + lane];
        g = gid[i + lane];
      }
      list.merge(lane, s, sl, g);
    }
    count = 0;
    __syncwarp();
  }
};

// One row's candidates, as one lane sees them: the vector path reads 16
// bytes of candidates (kE of them), their kE gids and (int8) kE scales per
// lane per step; neighbouring lanes read neighbouring addresses.
template <typename T, int VD>
struct Vec {
  static constexpr int kE = VD ? 16 / (VD * (int)sizeof(T)) : 1;
  uint4 c;
  int g[kE];
  float sc[kE];
};

template <int N>
__device__ __forceinline__ void load_words(const void* src, int (&dst)[N]) {
  if constexpr (N == 2) {
    const int2 v = __ldg(static_cast<const int2*>(src));
    dst[0] = v.x;
    dst[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const int4 v = __ldg(static_cast<const int4*>(src) + i / 4);
      dst[i] = v.x;
      dst[i + 1] = v.y;
      dst[i + 2] = v.z;
      dst[i + 3] = v.w;
    }
  }
}

// leaf_topk: one warp per row. Candidates are streamed with 16-byte vector
// loads where the row allows it (VD: the depth the vector path is built
// for, 0 for none; the row's bases aligned), two steps ahead of the
// selection; the rest of the row — or all of it, for other depths or an
// unaligned base — takes element loads. Each
// candidate's sum is the plain version's, in dimension order with
// explicitly rounded operations. Selection: k <= 32 the register list
// (kReg), else the shared-memory insertion list.
template <typename T, bool kScale, int VD, bool kReg>
__global__ void __launch_bounds__(kLeafWarps * kWarp)
    leaf_topk_kernel(const float* __restrict__ q, const T* __restrict__ cands,
                     const float* __restrict__ cscale,
                     const int* __restrict__ cgids,
                     const float* __restrict__ r_sq, int R, int C, int D,
                     int k, float* __restrict__ out_sq,
                     int* __restrict__ out_gid, int* __restrict__ out_slot) {
  using V = Vec<T, VD>;
  constexpr int kE = V::kE;
  constexpr int kBuf = kWarp * (kE + 1);  // survivors between two merges
  extern __shared__ unsigned char smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int row = blockIdx.x * kLeafWarps + warp;
  if (row >= R) return;  // the whole warp leaves together; no block barrier

  RegList reg;
  Survivors buf;
  WarpList list;
  if constexpr (kReg) {
    reg.init(k);
    float* b = reinterpret_cast<float*>(smem) + warp * kBuf * 3;
    buf = Survivors{b, reinterpret_cast<int*>(b + kBuf),
                    reinterpret_cast<int*>(b + 2 * kBuf), 0};
  } else {
    float* all_sq = reinterpret_cast<float*>(smem);
    int* all_slot = reinterpret_cast<int*>(all_sq + kLeafWarps * k);
    int* all_gid = all_slot + kLeafWarps * k;
    list = WarpList{all_sq + warp * k, all_slot + warp * k,
                    all_gid + warp * k, k};
    list.init(lane);
  }
  // every lane offers one candidate (masked lanes pass = false)
  auto offer = [&](bool valid, float sq, int slot, int gid) {
    if constexpr (kReg) {
      buf.push(lane, valid && reg.beats(sq, slot), sq, slot, gid);
    } else {
      if (!valid) {
        sq = __int_as_float(0x7f800000);
        slot = kI32Max;
        gid = -1;
      }
      list.offer(lane, sq, slot, gid);
    }
  };

  const float rs = r_sq[row];
  const float* qr = q + static_cast<size_t>(row) * D;
  const T* cr = cands + static_cast<size_t>(row) * C * D;
  const int* gr = cgids + static_cast<size_t>(row) * C;
  const float* sr = kScale ? cscale + static_cast<size_t>(row) * C : nullptr;

  int done = 0;  // candidates [0, done) went through the vector path
  if constexpr (VD != 0) {
    const bool aligned =
        reinterpret_cast<uintptr_t>(cr) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(gr) % (4 * kE) == 0 &&
        (!kScale || reinterpret_cast<uintptr_t>(sr) % (4 * kE) == 0);
    if (aligned) {
      float qv[VD];
#pragma unroll
      for (int d = 0; d < VD; ++d) qv[d] = qr[d];
      const int units = C / kE;  // whole 16-byte units of the row
      auto load = [&](int u, V& v) {
        if (u < units) {
          v.c = __ldg(reinterpret_cast<const uint4*>(cr) + u);
          load_words(gr + u * kE, v.g);
          if constexpr (kScale) {
            int s[kE];
            load_words(sr + u * kE, s);
#pragma unroll
            for (int e = 0; e < kE; ++e) v.sc[e] = __int_as_float(s[e]);
          }
        }
      };
      V v0, v1, v2;  // this step and the two in flight behind it
      load(lane, v0);
      load(kWarp + lane, v1);
      for (int u0 = 0; u0 < units; u0 += kWarp) {
        load(u0 + 2 * kWarp + lane, v2);
        const int u = u0 + lane;
        const T* cv = reinterpret_cast<const T*>(&v0.c);
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          float acc = 0.f;
#pragma unroll
          for (int d = 0; d < VD; ++d) {
            float c = widen(cv[e * VD + d]);
            if (kScale) c = __fmul_rn(c, v0.sc[e]);  // exact: pow2 scale
            const float t = __fsub_rn(qv[d], c);
            acc = __fadd_rn(acc, __fmul_rn(t, t));
          }
          const bool valid = u < units && v0.g[e] >= 0 && acc <= rs;
          offer(valid, acc, u * kE + e, v0.g[e]);
        }
        if constexpr (kReg) {
          if (buf.count >= kWarp) buf.drain(lane, reg);
        }
        v0 = v1;
        v1 = v2;
      }
      done = units * kE;
    }
  }
  // element loads: the rest of the row
  for (int base = done; base < C; base += kWarp) {
    const int j = base + lane;
    bool valid = false;
    float acc = 0.f;
    int gid = -1;
    if (j < C) {
      gid = gr[j];
      const float sc = kScale ? sr[j] : 1.f;
      for (int d = 0; d < D; ++d) {
        float c = widen(cr[static_cast<size_t>(j) * D + d]);
        if (kScale) c = __fmul_rn(c, sc);  // exact: pow2 scale
        const float t = __fsub_rn(qr[d], c);
        acc = __fadd_rn(acc, __fmul_rn(t, t));
      }
      valid = gid >= 0 && acc <= rs;
    }
    offer(valid, acc, j, gid);
    if constexpr (kReg) {
      if (buf.count >= kWarp) buf.drain(lane, reg);
    }
  }

  if constexpr (kReg) {
    buf.drain(lane, reg);
    if (lane < k) {
      const size_t at = static_cast<size_t>(row) * k + lane;
      out_sq[at] = reg.sq;
      out_gid[at] = reg.gid;
      out_slot[at] = reg.slot;
    }
  } else {
    list.store(lane, row, out_sq, out_gid, out_slot);
  }
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

template <typename T, bool kScale, int VD>
cudaError_t launch_leaf_vd(const void* q, const void* cands,
                           const void* cscale, const void* cgids,
                           const void* r_sq, int R, int C, int D, int k,
                           void* out_sq, void* out_gid, void* out_slot,
                           cudaStream_t stream) {
  const bool reg = k <= kWarp;
  const size_t per_warp =
      reg ? static_cast<size_t>(kWarp) * (Vec<T, VD>::kE + 1) * 12
          : static_cast<size_t>(k) * 12;
  const size_t smem = kLeafWarps * per_warp;
  auto kernel = reg ? leaf_topk_kernel<T, kScale, VD, true>
                    : leaf_topk_kernel<T, kScale, VD, false>;
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

// The vector path is built for D = 2, the main path's depth (every storage
// type's candidates then tile 16 bytes); every other depth streams element
// by element.
template <typename T, bool kScale>
cudaError_t launch_leaf(const void* q, const void* cands, const void* cscale,
                        const void* cgids, const void* r_sq, int R, int C,
                        int D, int k, void* out_sq, void* out_gid,
                        void* out_slot, cudaStream_t stream) {
  auto launch = D == 2 ? launch_leaf_vd<T, kScale, 2>
                       : launch_leaf_vd<T, kScale, 0>;
  return launch(q, cands, cscale, cgids, r_sq, R, C, D, k, out_sq, out_gid,
                out_slot, stream);
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
