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
//              bytes (a 48 KB arena, read from L2 by every block) and the
//              distance operations (~9 per pair) take microseconds; the
//              selection work and, at the main path's Q = 64, the launch
//              and the latency of a few dependent steps bound it. Design,
//              two launches per call:
//                topk_pnorm_kernel  |p|^2 of every arena point, once, into
//                                   a scratch (at D = 2 with the point and
//                                   its gid: one 16-byte record a point,
//                                   padded with dead records to whole
//                                   steps, so the scan's loads need no
//                                   bounds);
//                topk_scan_kernel   grid (query groups of 8) x (arena
//                                   splits S): one warp a query, scanning
//                                   its block's split in steps of 32 x PPL
//                                   points (PPL a lane, the next step's in
//                                   flight). k <= 32: the register list
//                                   below, one filter compare a pair and one
//                                   vote a step; k > 32: the shared-memory
//                                   list, PPL = 1, S = 1.
//              S and PPL depend on (Q, N, k) alone (../topk_l2.py
//              `scan_geometry`), so that Q = 64 still fills the card: with
//              S > 1 each block writes its queries' split k-lists to a
//              scratch; the LAST block of a query group to finish (a
//              __threadfence, then an atomic ticket in a per-stream counter
//              that it resets to 0) merges the group's S k-lists through
//              the same register list. (sq, slot) is a total order, so the
//              k best do not depend on the split or the order of merging:
//              the result equals the plain version's bitwise.
//
// The shared-memory insertion list (k > 32, in both kernels):
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
constexpr int kScanWarps = 8;   // warps per block of topk_l2
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

template <typename Kernel>
cudaError_t prepare_smem(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// -- topk_l2 --------------------------------------------------------------------

// q.p summed in dimension order, the first product not added to 0: the
// plain version's `dot`, operation for operation.
__device__ __forceinline__ float dot_rn(const float* a, const float* b, int D) {
  float s = __fmul_rn(a[0], b[0]);
  for (int d = 1; d < D; ++d) s = __fadd_rn(s, __fmul_rn(a[d], b[d]));
  return s;
}

// |p|^2 of every arena point, once a launch, +inf for a dead point (gid <
// 0), so the scan's one filter compare rejects it. kPack (D = 2): one
// 16-byte record a point, (x, y, |p|^2, gid), so the scan loads a point
// with one vector load, and `records` (>= N) records: the slots past N are
// dead, so every split's steps are whole and need no bounds; otherwise
// |p|^2 alone for the N points.
template <bool kPack>
__global__ void __launch_bounds__(256)
    topk_pnorm_kernel(const float* __restrict__ p,
                      const int* __restrict__ gids, int N, int D, int records,
                      float* __restrict__ pn) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= records) return;
  const float* pr = p + static_cast<size_t>(j) * D;
  const int g = j < N ? gids[j] : -1;
  const float n = g >= 0 ? dot_rn(pr, pr, D) : __int_as_float(0x7f800000);
  if constexpr (kPack) {
    reinterpret_cast<float4*>(pn)[j] =
        g >= 0 ? make_float4(pr[0], pr[1], n, __int_as_float(g))
               : make_float4(0.f, 0.f, n, __int_as_float(-1));
  } else {
    pn[j] = n;
  }
}

struct ScanArgs {
  const float* q;
  const float* p;
  const float* pn;  // from topk_pnorm_kernel: padded (x, y, |p|^2, gid)
                    // records at D = 2, else (N,) |p|^2
  const int* gids;
  const float* r_sq;
  int Q, N, D, k;
  int split;  // arena points per split (a multiple of 32 * PPL)
  int S;      // splits; block b scans split b % S for query group b / S
  float* part_sq;  // (Q, S, k) split k-lists (S > 1)
  int* part_gid;
  int* part_slot;
  unsigned* tickets;  // one per query group: 0 at launch, 0 again after it
  float* out_sq;
  int* out_gid;
  int* out_slot;
};

// One arena point as a lane holds it (VD: the depth the registers are
// built for, 0 for any depth: the coordinates are then read per use).
template <int VD>
struct ArenaPoint {
  float c[VD > 0 ? VD : 1];
  float n;
  int g;
};

// One query as its warp holds it (every lane the same values).
template <int VD>
struct ScanQuery {
  float c[VD > 0 ? VD : 1];
  const float* row;
  float n, rs;
};

// Arena point j; at D = 2 `rec` is this lane's record pointer at j (the
// records are padded, so it is always there), otherwise read by index.
template <int VD>
__device__ __forceinline__ void load_point(const ScanArgs& a, const float4* rec,
                                           int j, bool in, ArenaPoint<VD>& pt) {
  if constexpr (VD == 2) {
    const float4 v = __ldg(rec);
    pt.c[0] = v.x;
    pt.c[1] = v.y;
    pt.n = v.z;
    pt.g = __float_as_int(v.w);
  } else {
    pt.n = __int_as_float(0x7f800000);
    pt.g = -1;
    if (in) {
      pt.n = __ldg(a.pn + j);
      pt.g = __ldg(a.gids + j);
    }
  }
}

// (|q|^2 + |p|^2) - 2 q.p, the dot in dimension order, each operation
// rounded on its own as the plain version does, NOT yet clamped at 0.
template <int VD>
__device__ __forceinline__ float expansion(const ScanQuery<VD>& q,
                                           const ArenaPoint<VD>& pt,
                                           const float* prow, int D) {
  float dot;
  if constexpr (VD > 0) {
    dot = __fmul_rn(q.c[0], pt.c[0]);
#pragma unroll
    for (int d = 1; d < VD; ++d) dot = __fadd_rn(dot, __fmul_rn(q.c[d], pt.c[d]));
  } else {
    dot = __fmul_rn(q.row[0], __ldg(prow));
    for (int d = 1; d < D; ++d)
      dot = __fadd_rn(dot, __fmul_rn(q.row[d], __ldg(prow + d)));
  }
  return __fsub_rn(__fadd_rn(q.n, pt.n), __fmul_rn(2.f, dot));
}

__device__ __forceinline__ float clamp0(float v) { return v < 0.f ? 0.f : v; }

// One query's register k-best to the outputs (lanes < k).
__device__ __forceinline__ void store_reg(const ScanArgs& a, const RegList& r,
                                          int row, int lane) {
  if (lane < a.k) {
    const size_t at = static_cast<size_t>(row) * a.k + lane;
    a.out_sq[at] = r.sq;
    a.out_gid[at] = r.gid;
    a.out_slot[at] = r.slot;
  }
}

// Merge exactly the first 32 buffered survivors (count >= 32) into the
// list, then keep those of the rest that still beat its k-th key, moved to
// the front: one bitonic merge a drain, however full the buffer was.
__device__ __forceinline__ void drain32(Survivors& b, int lane, RegList& list) {
  __syncwarp();
  list.merge(lane, b.sq[lane], b.slot[lane], b.gid[lane]);
  const int rest = b.count - kWarp;
  float s = 0.f;
  int sl = 0, g = 0;
  if (lane < rest) {
    s = b.sq[kWarp + lane];
    sl = b.slot[kWarp + lane];
    g = b.gid[kWarp + lane];
  }
  __syncwarp();
  b.count = 0;
  b.push(lane, lane < rest && list.beats(s, sl), s, sl, g);
  __syncwarp();
}

// topk_l2's scan (see the header): one query a warp, PPL points a lane a
// step. kReg: k <= 32, the register list and any number of splits;
// otherwise the shared-memory list, one point a lane and one split.
template <int VD, int PPL, bool kReg>
__global__ void __launch_bounds__(kScanWarps * kWarp, PPL == 2 ? 5 : 1)
    topk_scan_kernel(const ScanArgs a) {
  constexpr int kSurv = 2 * kWarp;  // survivors between two merges
  extern __shared__ unsigned char smem[];
  __shared__ int s_last;
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int grp = blockIdx.x / a.S;
  const int split = blockIdx.x - grp * a.S;
  const int row = grp * kScanWarps + warp;  // the warp's query
  const bool act = row < a.Q;  // warp-uniform; no early exit (barriers)

  ScanQuery<VD> qs;
  const float* src = a.q + static_cast<size_t>(act ? row : 0) * a.D;
  qs.row = src;
  qs.n = dot_rn(src, src, a.D);
  if constexpr (VD > 0) {
#pragma unroll
    for (int d = 0; d < VD; ++d) qs.c[d] = src[d];
  }
  qs.rs = act ? a.r_sq[row] : 0.f;

  RegList reg;
  Survivors buf;
  WarpList list;
  if constexpr (kReg) {
    reg.init(a.k);
    float* b = reinterpret_cast<float*>(smem) + warp * kSurv * 3;
    buf = Survivors{b, reinterpret_cast<int*>(b + kSurv),
                    reinterpret_cast<int*>(b + 2 * kSurv), 0};
  } else {
    float* all_sq = reinterpret_cast<float*>(smem);
    int* all_slot = reinterpret_cast<int*>(all_sq + kScanWarps * a.k);
    int* all_gid = all_slot + kScanWarps * a.k;
    list = WarpList{all_sq + warp * a.k, all_slot + warp * a.k,
                    all_gid + warp * a.k, a.k};
    list.init(lane);
  }

  const int j0 = split * a.split;
  // D = 2 reads whole steps of padded records; otherwise the split ends at N
  const int j1 = VD == 2 ? j0 + a.split : min(a.N, j0 + a.split);
  if (act) {
    // a step: PPL points a lane (32 * PPL of the split). kReg: a pair can
    // pass only if its unclamped sq <= lim = min(gate, k-th sq) (the clamp
    // only raises a negative sq to 0, and 0 <= lim whenever anything can
    // pass; a dead point's or an empty lane's |p|^2 is +inf); one vote a
    // step, and only steps with such a pair take the exact test, liveness
    // included
    float lim = qs.rs;
    ArenaPoint<VD> cur[PPL], nxt[PPL];
    const float4* rec = nullptr;  // D = 2: this lane's next record
    if constexpr (VD == 2)
      rec = reinterpret_cast<const float4*>(a.pn) + j0 + lane;
#pragma unroll
    for (int p = 0; p < PPL; ++p) {
      const int j = j0 + p * kWarp + lane;
      load_point(a, VD == 2 ? rec + p * kWarp : nullptr, j, j < j1, cur[p]);
    }
#pragma unroll 2
    for (int base = j0; base < j1; base += kWarp * PPL) {
      if constexpr (VD == 2) rec += kWarp * PPL;
#pragma unroll
      for (int p = 0; p < PPL; ++p) {  // the next step's points, in flight
        const int j = base + (PPL + p) * kWarp + lane;
        load_point(a, VD == 2 ? rec + p * kWarp : nullptr, j, j < j1, nxt[p]);
      }
      if constexpr (kReg) {
        float v[PPL];
        bool m[PPL];
        bool any_m = false;
#pragma unroll
        for (int p = 0; p < PPL; ++p) {
          const int j = base + p * kWarp + lane;
          const float* prow = a.p + static_cast<size_t>(j) * a.D;
          v[p] = VD > 0 || j < j1 ? expansion<VD>(qs, cur[p], prow, a.D)
                                  : __int_as_float(0x7f800000);
          m[p] = v[p] <= lim;
          any_m |= m[p];
        }
        if (__any_sync(kFull, any_m)) {
#pragma unroll
          for (int p = 0; p < PPL; ++p) {
            if (!__any_sync(kFull, m[p])) continue;
            const int j = base + p * kWarp + lane;
            const float sq = clamp0(v[p]);
            buf.push(lane,
                     m[p] && cur[p].g >= 0 && sq <= qs.rs && reg.beats(sq, j),
                     sq, j, cur[p].g);
            if (buf.count >= kWarp) {
              drain32(buf, lane, reg);
              lim = fminf(qs.rs, reg.th_sq);
            }
          }
        }
      } else {  // PPL = 1: the shared-memory list
        const int j = base + lane;
        const bool live = j < j1 && cur[0].g >= 0;
        const float* prow = a.p + static_cast<size_t>(j) * a.D;
        const float sq = clamp0(
            VD > 0 || live ? expansion<VD>(qs, cur[0], prow, a.D) : 0.f);
        const bool valid = live && sq <= qs.rs;
        list.offer(lane, valid ? sq : __int_as_float(0x7f800000),
                   valid ? j : kI32Max, valid ? cur[0].g : -1);
      }
#pragma unroll
      for (int p = 0; p < PPL; ++p) cur[p] = nxt[p];
    }
    if constexpr (kReg) buf.drain(lane, reg);
  }

  if (a.S == 1) {
    if (act) {
      if constexpr (kReg) {
        store_reg(a, reg, row, lane);
      } else {
        list.store(lane, static_cast<size_t>(row), a.out_sq, a.out_gid,
                   a.out_slot);
      }
    }
    return;
  }
  if constexpr (kReg) {
    // this split's k-list to the scratch, then the ticket
    if (act && lane < a.k) {
      const size_t at = (static_cast<size_t>(row) * a.S + split) * a.k + lane;
      a.part_sq[at] = reg.sq;
      a.part_gid[at] = reg.gid;
      a.part_slot[at] = reg.slot;
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned t = atomicAdd(a.tickets + grp, 1u);
      s_last = t == static_cast<unsigned>(a.S - 1);
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    if (threadIdx.x == 0) a.tickets[grp] = 0u;  // zero for the next launch
    if (!act) return;
    // the last block merges each query's S split k-lists
    const int total = a.S * a.k;
    reg.init(a.k);
    const size_t b0 = static_cast<size_t>(row) * total;
    for (int e0 = 0; e0 < total; e0 += kWarp) {
      const int e = e0 + lane;
      float sq = __int_as_float(0x7f800000);
      int sl = kI32Max, g = -1;
      if (e < total) {
        sq = __ldcg(a.part_sq + b0 + e);
        sl = __ldcg(a.part_slot + b0 + e);
        g = __ldcg(a.part_gid + b0 + e);
      }
      buf.push(lane, reg.beats(sq, sl), sq, sl, g);
      if (buf.count >= kWarp) drain32(buf, lane, reg);
    }
    buf.drain(lane, reg);
    store_reg(a, reg, row, lane);
  }
}

template <int VD, int PPL, bool kReg>
cudaError_t launch_scan(const ScanArgs& a, int blocks, cudaStream_t stream) {
  const size_t smem = kReg ? static_cast<size_t>(kScanWarps) * 64 * 12
                           : static_cast<size_t>(kScanWarps) * a.k * 12;
  auto kernel = topk_scan_kernel<VD, PPL, kReg>;
  cudaError_t err = prepare_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kScanWarps * kWarp, smem, stream>>>(a);
  return cudaGetLastError();
}

// ppl: points a lane a step, as the geometry chose (k <= 32: 2; else 1)
template <int VD>
cudaError_t launch_scan_vd(const ScanArgs& a, int ppl, int blocks,
                           cudaStream_t stream) {
  if (a.k > kWarp) return launch_scan<VD, 1, false>(a, blocks, stream);
  if (ppl == 2) return launch_scan<VD, 2, true>(a, blocks, stream);
  return cudaErrorInvalidValue;
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


// -- the sort route: k above the insertion list's ceiling -------------------------

// Both functions, for k > kListMaxK (../topk_l2.py `_MAX_K`), where the
// per-warp lists above no longer fit a block's shared memory. It replaces
// no TPU kernel of its own: it is the same two functions (the reference's
// `_leaf_kernel` and `_kernel` take any k) by another selection. One block
// a row writes a 64-bit key per candidate, (sq bits << 32) | slot for a
// candidate that passes the gate and ~0 for a masked one (sq >= 0, so its
// f32 bits order as unsigned integers, and (sq, slot) is the lexicographic
// key), sorts the row's keys ascending and keeps the first k: ties go to
// the lower slot, as the plain versions' stable sorts (and `lax.top_k`)
// do. The sort is a bitonic network in which every compare-exchange puts
// the smaller key at the lower index; the keys past the row's width then
// behave as +inf and are never touched, so the network needs the row's
// width alone, not its next power of two. The keys live in shared memory
// where the row fits (8 B a candidate), otherwise in a global scratch the
// wrapper allocates (`keys`, one row of width keys a block of the launch).
// Bound on this card: the sort's O(n log^2 n) compare-exchanges of each
// row, against the scan's n reads; simple and right first.
constexpr int kSortThreads = 1024;
constexpr unsigned long long kMasked = ~0ull;

struct SortArgs {
  const float* q;
  const void* cands;       // leaf: (R, C, D) storage; arena: p (N, D) f32
  const float* cscale;     // leaf int8: (R, C) pow2 scales
  const int* gids;         // leaf: (R, C); arena: (N,)
  const float* r_sq;
  int row0, n, D, k;       // n: the row's width (C or N)
  unsigned long long* keys;  // global scratch, or nullptr: shared memory
  float* out_sq;
  int* out_gid;
  int* out_slot;
};

template <typename T, bool kScale, bool kArena>
__global__ void __launch_bounds__(kSortThreads)
    topk_sort_kernel(const SortArgs a) {
  extern __shared__ unsigned long long sort_smem[];
  const int row = a.row0 + blockIdx.x;
  const int n = a.n;
  unsigned long long* keys =
      a.keys ? a.keys + static_cast<size_t>(blockIdx.x) * n : sort_smem;
  const float* qr = a.q + static_cast<size_t>(row) * a.D;
  const float rs = a.r_sq[row];
  const int* gr = kArena ? a.gids : a.gids + static_cast<size_t>(row) * n;
  float qn = 0.f;
  if constexpr (kArena) qn = dot_rn(qr, qr, a.D);
  for (int j = threadIdx.x; j < n; j += kSortThreads) {
    const int gid = gr[j];
    float sq;
    if constexpr (kArena) {
      const float* pr = static_cast<const float*>(a.cands) +
                        static_cast<size_t>(j) * a.D;
      sq = clamp0(__fsub_rn(__fadd_rn(qn, dot_rn(pr, pr, a.D)),
                            __fmul_rn(2.f, dot_rn(qr, pr, a.D))));
    } else {
      const T* cr = static_cast<const T*>(a.cands) +
                    (static_cast<size_t>(row) * n + j) * a.D;
      const float sc = kScale ? a.cscale[static_cast<size_t>(row) * n + j] : 1.f;
      sq = 0.f;
      for (int d = 0; d < a.D; ++d) {
        float c = widen(cr[d]);
        if (kScale) c = __fmul_rn(c, sc);  // exact: pow2 scale
        const float t = __fsub_rn(qr[d], c);
        sq = __fadd_rn(sq, __fmul_rn(t, t));
      }
    }
    keys[j] = gid >= 0 && sq <= rs
                  ? (static_cast<unsigned long long>(__float_as_uint(sq)) << 32) |
                        static_cast<unsigned>(j)
                  : kMasked;
  }
  __syncthreads();
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  for (int len = 2; len <= n2; len <<= 1) {
    const int half = len >> 1;
    // the merge's first stage pairs i with its mirror in the len-block
    for (int t = threadIdx.x; t < (n2 >> 1); t += kSortThreads) {
      const int lo = (t / half) * len + (t % half);
      const int hi = (lo / len) * len + len - 1 - (t % half);
      if (hi < n && keys[hi] < keys[lo]) {
        const unsigned long long x = keys[lo];
        keys[lo] = keys[hi];
        keys[hi] = x;
      }
    }
    __syncthreads();
    for (int j = half >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < (n2 >> 1); t += kSortThreads) {
        const int lo = (t / j) * 2 * j + (t % j);
        const int hi = lo + j;
        if (hi < n && keys[hi] < keys[lo]) {
          const unsigned long long x = keys[lo];
          keys[lo] = keys[hi];
          keys[hi] = x;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < a.k; i += kSortThreads) {
    const unsigned long long key = i < n ? keys[i] : kMasked;
    const size_t at = static_cast<size_t>(row) * a.k + i;
    if (key == kMasked) {
      a.out_sq[at] = __int_as_float(0x7f800000);
      a.out_gid[at] = -1;
      a.out_slot[at] = kI32Max;
    } else {
      const int slot = static_cast<int>(key & 0xffffffffu);
      a.out_sq[at] = __uint_as_float(static_cast<unsigned>(key >> 32));
      a.out_gid[at] = gr[slot];
      a.out_slot[at] = slot;
    }
  }
}

template <typename T, bool kScale, bool kArena>
cudaError_t launch_sort(const SortArgs& a, int rows, cudaStream_t stream) {
  const size_t smem = a.keys ? 0 : static_cast<size_t>(a.n) * 8;
  auto kernel = topk_sort_kernel<T, kScale, kArena>;
  cudaError_t err = prepare_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<rows, kSortThreads, smem, stream>>>(a);
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

// ppl (points a lane a step: 2; k > 32 needs 1 and one split) and
// split (arena points per split, a multiple of 32 * ppl) from
// ../topk_l2.py `scan_geometry`.
// Scratch from the wrapper: pn, 4 * (S * split + 32 * ppl) words, 16-byte
// aligned (at D = 2 the point records, else the (N,) |p|^2); with S > 1
// splits the (Q, S, k) split lists part_* and one zeroed ticket per query
// group.
int topk_l2_launch(const void* q, const void* p, const void* gids,
                   const void* r_sq, int Q, int N, int D, int k, int ppl,
                   int split, void* pn, void* part_sq, void* part_gid,
                   void* part_slot, void* tickets, void* out_sq,
                   void* out_gid, void* out_slot, void* stream) {
  if (Q <= 0 || N <= 0 || D <= 0 || k <= 0 || ppl <= 0 || split <= 0 ||
      split % (kWarp * ppl) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int S = (N + split - 1) / split;
  const long long groups = (Q + kScanWarps - 1) / kScanWarps;
  if (groups * S > 0x7fffffffLL ||
      (k > kWarp && (ppl != 1 || S != 1)) ||
      (S > 1 && (part_sq == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v2 = D == 2 && reinterpret_cast<uintptr_t>(pn) % 16 == 0;
  // D = 2: S whole splits of records and one step more (the last step's
  // prefetch), all past N dead
  const int records = v2 ? S * split + kWarp * ppl : N;
  auto pnorm = v2 ? topk_pnorm_kernel<true> : topk_pnorm_kernel<false>;
  pnorm<<<(records + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(p), static_cast<const int*>(gids), N, D,
      records, static_cast<float*>(pn));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ScanArgs a;
  a.q = static_cast<const float*>(q);
  a.p = static_cast<const float*>(p);
  a.pn = static_cast<const float*>(pn);
  a.gids = static_cast<const int*>(gids);
  a.r_sq = static_cast<const float*>(r_sq);
  a.Q = Q;
  a.N = N;
  a.D = D;
  a.k = k;
  a.split = split;
  a.S = S;
  a.part_sq = static_cast<float*>(part_sq);
  a.part_gid = static_cast<int*>(part_gid);
  a.part_slot = static_cast<int*>(part_slot);
  a.tickets = static_cast<unsigned*>(tickets);
  a.out_sq = static_cast<float*>(out_sq);
  a.out_gid = static_cast<int*>(out_gid);
  a.out_slot = static_cast<int*>(out_slot);
  const int blocks = static_cast<int>(groups * S);
  err = v2 ? launch_scan_vd<2>(a, ppl, blocks, s)
           : launch_scan_vd<0>(a, ppl, blocks, s);
  return static_cast<int>(err);
}

// The sort route (k > the list's ceiling) over rows [row0, row0 + rows):
// keys is a global scratch of rows * width 64-bit words, or null to keep
// each row's keys in shared memory (width * 8 bytes must fit a block).
// dtype as leaf_topk_launch's.
int leaf_topk_sort_launch(int dtype, const void* q, const void* cands,
                          const void* cscale, const void* cgids,
                          const void* r_sq, int row0, int rows, int C, int D,
                          int k, void* keys, void* out_sq, void* out_gid,
                          void* out_slot, void* stream) {
  if (rows <= 0 || C <= 0 || D <= 0 || k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  SortArgs a{static_cast<const float*>(q), cands,
             static_cast<const float*>(cscale), static_cast<const int*>(cgids),
             static_cast<const float*>(r_sq), row0, C, D, k,
             static_cast<unsigned long long*>(keys),
             static_cast<float*>(out_sq), static_cast<int*>(out_gid),
             static_cast<int*>(out_slot)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_sort<float, false, false>(a, rows, s);
    case 1:
      return launch_sort<__nv_bfloat16, false, false>(a, rows, s);
    case 2:
      return launch_sort<int8_t, true, false>(a, rows, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int topk_l2_sort_launch(const void* q, const void* p, const void* gids,
                        const void* r_sq, int row0, int rows, int N, int D,
                        int k, void* keys, void* out_sq, void* out_gid,
                        void* out_slot, void* stream) {
  if (rows <= 0 || N <= 0 || D <= 0 || k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  SortArgs a{static_cast<const float*>(q), p, nullptr,
             static_cast<const int*>(gids), static_cast<const float*>(r_sq),
             row0, N, D, k, static_cast<unsigned long long*>(keys),
             static_cast<float*>(out_sq), static_cast<int*>(out_gid),
             static_cast<int*>(out_slot)};
  return static_cast<int>(
      launch_sort<float, false, true>(a, rows, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
