// Scan preprocessing in one launch: the voxel snap, the dedup, the
// compaction and the fixed-point pose transform of
// ops/preprocess.preprocess_plain, bit for bit on the card.
//
// It replaces no TPU kernel: the JAX package preprocesses with XLA
// (warpsense_tpu/ops/preprocess.py), and so did the port, eagerly, in
// some 80 small launches a scan (four stable radix argsorts, the masks,
// the snap, the transform) and three blocking host copies, each a stream
// sync.  Its work is tiny: it reads the scan (13 B a point: xyz and the
// valid byte, 32,766 points in the app) and writes the points and the
// mask (13 B a row), under 1 MB or ~0.3 us at 3.35 TB/s, so it is bound by
// its launch and its own barriers, not by bytes or operations.
//
// Design: one thread-block cluster of up to kMaxCluster CTAs, kTile points
// a CTA, so that N <= 32,768 points (the apps' capacities are 32,766 and
// 32,768) never leave shared memory while they are sorted.
//  1. Each CTA computes, for its points, keep (valid, not near, finite),
//     the voxel center and the output value, and writes them to a scratch
//     row a point (read again after the sort).
//  2. The sort key is the plain version's (cx, cy, cz) with a dropped
//     point at (2^30, 2^30, 2^30), stably.  It is remapped, exactly and
//     in order, to a dense key: a class (below, at or above the sentinel)
//     on top, then per axis (biased center - cluster min) >> the trailing
//     zero bits every such value shares, in as many bits as the largest
//     needs.  Points at the sentinel key get 0 on every axis: their order
//     is the class's alone, ties in input order.  Two cluster-wide
//     reductions through distributed shared memory give the minima, the
//     shared zero bits and the widths.  A scan's ~60 x 30 x 5 m at 64 mm
//     packs into ~27 bits: 4 passes of 8 bits instead of 12.
//  3. A stable LSD radix sort over those bits, the input index riding
//     along.  Each pass ranks its points within the CTA (__match_any_sync
//     a warp, a scan over the warps per digit), exchanges the CTAs'
//     histograms through distributed shared memory and scatters each
//     point into the owning CTA's other buffer.  A pass whose digits are
//     all one skips its scatter; every CTA decides alike from the same
//     totals.
//  4. Dedup and compaction: a point is unique if it is kept and its center
//     differs from the point before it in sorted order (a CTA's first
//     point reads its neighbour's last through distributed shared
//     memory); a ballot and a scan over warps and CTAs give each unique
//     point its row.  The value (the center, or rintf(mm) of the first
//     point with snap off) is transformed in wrapping int32 and written;
//     the rows past the unique ones are zeroed.
// Its bits are the plain version's on the card: mm is __fmul_rn(x, 1000),
// the snap multiplies by the float32 reciprocal of the resolution as
// PyTorch's CUDA division by a Python scalar does (the wrapper passes it),
// then floorf, * res and + res / 2, each rounded once (this file builds
// with -fmad=false); float-to-int casts are cvt.rzi, saturating with NaN
// to 0, as PyTorch's on the card; the transform's products and sums wrap
// modulo 2^32 in any order; div_trunc is |a| >> 15 with the sign put back,
// so INT_MIN divides as the JAX function's |a| // |b| does.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 2;                      // points a thread
constexpr int kTile = kThreads * kItems;       // points a CTA
constexpr int kMaxCluster = 16;                // non-portable, as C22's
constexpr int kWarps = kThreads / 32;
constexpr int kDigits = 256;
constexpr int kSentinel = 1 << 30;             // a dropped point's key
constexpr int kMatrixShift = 15;               // MATRIX_RESOLUTION = 2^15
constexpr unsigned kFull = 0xffffffffu;

typedef unsigned __int128 u128;

struct Params {
  const float* points;          // (n, 3) float32 meters
  const unsigned char* valid;   // (n,) bool
  int4* payload;                // (n, 2): center xyz, value x | value yz, keep
  int* out;                     // (rows, 3) int32 mm
  unsigned char* mask;          // (rows,) bool
  int n, capacity, rows, res, snap;
  float inv_res;                // float32 1 / res
  int m[12];                    // to_int_mat's top three rows
};

struct Smem {
  ulonglong2 keys[2][kTile];            // dense keys, double-buffered
  int idx[2][kTile];                    // their input indices
  unsigned short wc[kWarps][kDigits];   // a round's counts by warp, digit
  unsigned carry[kDigits];              // this CTA's histogram (peers read)
  unsigned pre[kDigits];                // the CTAs before this one's counts
  unsigned base[kDigits];               // the digits before each one's
  unsigned red[kWarps][6];              // warp partials of a reduction
  unsigned part_a[4];                   // min x, y, z; max class (peers)
  unsigned part_b[6];                   // or x, y, z; max x, y, z (peers)
  unsigned all_a[4], all_b[6];          // the cluster's
  unsigned wsum[kDigits / 32];
  unsigned uniq_warp[kItems][kWarps];   // unique points a warp, a round
  unsigned cta_uniq;                    // this CTA's unique points (peers)
  unsigned uniq_before, uniq_total;
  int skip;
};

__device__ __forceinline__ unsigned biased(int v) {
  return (unsigned)v ^ 0x80000000u;
}

__device__ __forceinline__ unsigned digit(ulonglong2 k, int shift) {
  const u128 v = ((u128)k.y << 64) | (u128)k.x;
  return (unsigned)(v >> shift) & (kDigits - 1);
}

// core/geometry.div_trunc(a, MATRIX_RESOLUTION): |a| // 2^15 with the
// sign of a; |INT_MIN| wraps to INT_MIN, whose floor quotient is -65536
__device__ __forceinline__ int div_trunc(int a) {
  const int mag = a < 0 ? (int)(0u - (unsigned)a) : a;
  const int q = mag >> kMatrixShift;
  return a < 0 ? (int)(0u - (unsigned)q) : q;
}

// transform_point_fixed: (R p + t) / MR in wrapping int32
__device__ __forceinline__ void transform(const int* m, const int v[3],
                                          int* out) {
  for (int j = 0; j < 3; ++j) {
    const unsigned acc = (unsigned)v[0] * (unsigned)m[4 * j]
        + (unsigned)v[1] * (unsigned)m[4 * j + 1]
        + (unsigned)v[2] * (unsigned)m[4 * j + 2] + (unsigned)m[4 * j + 3];
    out[j] = div_trunc((int)acc);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
preprocess_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;

  // 1. keep, the center, the value; the class against the sentinel key
  int c[kItems][3];
  unsigned cls[kItems];
  bool here[kItems];
  const float fres = (float)p.res, fhalf = (float)(p.res / 2);
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int i = rank * kTile + r * kThreads + tid;
    here[r] = i < p.n;
    cls[r] = 1;
    c[r][0] = c[r][1] = c[r][2] = 0;
    if (!here[r]) continue;
    float x[3];
    int v[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) x[a] = p.points[3 * i + a];
    // the reference's quirk: near is x, y AND z below 0.3 m
    const bool near = x[0] < 0.3f && x[1] < 0.3f && x[2] < 0.3f;
    const bool keep = p.valid[i] != 0 && !near && isfinite(x[0])
        && isfinite(x[1]) && isfinite(x[2]);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float mm = __fmul_rn(x[a], 1000.0f);
      c[r][a] = (int)__fadd_rn(
          __fmul_rn(floorf(__fmul_rn(mm, p.inv_res)), fres), fhalf);
      v[a] = p.snap ? c[r][a] : (int)rintf(mm);
    }
    if (keep) {
      int order = 0;
#pragma unroll
      for (int a = 2; a >= 0; --a)
        if (c[r][a] != kSentinel) order = c[r][a] < kSentinel ? -1 : 1;
      cls[r] = (unsigned)(order + 1);
    }
    p.payload[2 * i] = make_int4(c[r][0], c[r][1], c[r][2], v[0]);
    p.payload[2 * i + 1] = make_int4(v[1], v[2], (int)keep, 0);
  }

  // 2a. the cluster's minimum biased center an axis (off the sentinel
  // key) and largest class
  {
    unsigned lo[3] = {kFull, kFull, kFull}, top = 0;
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      if (!here[r]) continue;
      top = max(top, cls[r]);
      if (cls[r] != 1)
        for (int a = 0; a < 3; ++a) lo[a] = min(lo[a], biased(c[r][a]));
    }
    for (int a = 0; a < 3; ++a) lo[a] = __reduce_min_sync(kFull, lo[a]);
    top = __reduce_max_sync(kFull, top);
    if (lane == 0) {
      for (int a = 0; a < 3; ++a) s.red[warp][a] = lo[a];
      s.red[warp][3] = top;
    }
    __syncthreads();
    if (tid < 4) {
      unsigned v = s.red[0][tid];
      for (int w = 1; w < kWarps; ++w)
        v = tid < 3 ? min(v, s.red[w][tid]) : max(v, s.red[w][tid]);
      s.part_a[tid] = v;
    }
    cluster.sync();
    if (tid < 4) {
      unsigned v = cluster.map_shared_rank(s.part_a, 0)[tid];
      for (int q = 1; q < csize; ++q) {
        const unsigned u = cluster.map_shared_rank(s.part_a, q)[tid];
        v = tid < 3 ? min(v, u) : max(v, u);
      }
      s.all_a[tid] = v;
    }
    __syncthreads();
  }
  // 2b. the bits every offset from the minimum shares, and the largest
  {
    unsigned any[3] = {0, 0, 0}, top[3] = {0, 0, 0};
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      if (!here[r] || cls[r] == 1) continue;
      for (int a = 0; a < 3; ++a) {
        const unsigned d = biased(c[r][a]) - s.all_a[a];
        any[a] |= d;
        top[a] = max(top[a], d);
      }
    }
    for (int a = 0; a < 3; ++a) {
      any[a] = __reduce_or_sync(kFull, any[a]);
      top[a] = __reduce_max_sync(kFull, top[a]);
    }
    if (lane == 0)
      for (int a = 0; a < 3; ++a) {
        s.red[warp][a] = any[a];
        s.red[warp][3 + a] = top[a];
      }
    __syncthreads();
    if (tid < 6) {
      unsigned v = s.red[0][tid];
      for (int w = 1; w < kWarps; ++w)
        v = tid < 3 ? (v | s.red[w][tid]) : max(v, s.red[w][tid]);
      s.part_b[tid] = v;
    }
    cluster.sync();
    if (tid < 6) {
      unsigned v = cluster.map_shared_rank(s.part_b, 0)[tid];
      for (int q = 1; q < csize; ++q) {
        const unsigned u = cluster.map_shared_rank(s.part_b, q)[tid];
        v = tid < 3 ? (v | u) : max(v, u);
      }
      s.all_b[tid] = v;
    }
    __syncthreads();
  }
  int zeros[3], width[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    zeros[a] = s.all_b[a] ? __ffs(s.all_b[a]) - 1 : 0;
    const unsigned top = s.all_b[3 + a] >> zeros[a];
    width[a] = top ? 32 - __clz(top) : 0;
  }
  const unsigned top_cls = s.all_a[3];
  const int bits = (top_cls ? 32 - __clz(top_cls) : 0) + width[0] + width[1]
      + width[2];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (!here[r]) continue;
    u128 k = cls[r];
    for (int a = 0; a < 3; ++a) {
      const unsigned d = cls[r] == 1
          ? 0u : (biased(c[r][a]) - s.all_a[a]) >> zeros[a];
      k = (k << width[a]) | d;
    }
    const int slot = r * kThreads + tid;
    s.keys[0][slot] = make_ulonglong2((unsigned long long)k,
                                      (unsigned long long)(k >> 64));
    s.idx[0][slot] = rank * kTile + slot;
  }

  // 3. stable LSD radix sort, 8 bits a pass
  int cur = 0;
  for (int shift = 0; shift < bits; shift += 8) {
    if (tid < kDigits) s.carry[tid] = 0;
    if (tid == 0) s.skip = 0;
    unsigned dig[kItems], within[kItems];
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      __syncthreads();          // the last round's reads of wc are done
      unsigned* wc = reinterpret_cast<unsigned*>(&s.wc[0][0]);
      for (int k = tid; k < kWarps * kDigits / 2; k += kThreads) wc[k] = 0;
      __syncthreads();
      const int slot = r * kThreads + tid;
      const bool in = rank * kTile + slot < p.n;
      dig[r] = in ? digit(s.keys[cur][slot], shift) : kDigits;
      const unsigned peers = __match_any_sync(kFull, dig[r]);
      const unsigned before = __popc(peers & lt);
      if (in && before == 0) s.wc[warp][dig[r]] = __popc(peers);
      __syncthreads();
      if (tid < kDigits) {      // exclusive over warps, after the carry
        unsigned run = s.carry[tid];
        for (int w = 0; w < kWarps; ++w) {
          const unsigned n = s.wc[w][tid];
          s.wc[w][tid] = (unsigned short)run;
          run += n;
        }
        s.carry[tid] = run;
      }
      __syncthreads();
      within[r] = in ? s.wc[warp][dig[r]] + before : 0;
    }
    cluster.sync();             // every CTA's histogram is complete
    if (tid < kDigits) {
      unsigned total = 0, pre = 0;
      for (int q = 0; q < csize; ++q) {
        const unsigned h = cluster.map_shared_rank(s.carry, q)[tid];
        pre += q < rank ? h : 0;
        total += h;
      }
      s.pre[tid] = pre;
      unsigned incl = total;
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      if (lane == 31) s.wsum[warp] = incl;
      s.base[tid] = incl - total;
      if (total == (unsigned)p.n) s.skip = 1;   // one digit: in order
    }
    __syncthreads();
    if (tid < kDigits)
      for (int w = 0; w < warp; ++w) s.base[tid] += s.wsum[w];
    __syncthreads();
    if (!s.skip) {
#pragma unroll
      for (int r = 0; r < kItems; ++r) {
        const int slot = r * kThreads + tid;
        if (rank * kTile + slot >= p.n) continue;
        const unsigned dst = s.base[dig[r]] + s.pre[dig[r]] + within[r];
        const int owner = (int)(dst / kTile), to = (int)(dst % kTile);
        cluster.map_shared_rank(&s.keys[cur ^ 1][0], owner)[to] =
            s.keys[cur][slot];
        cluster.map_shared_rank(&s.idx[cur ^ 1][0], owner)[to] =
            s.idx[cur][slot];
      }
      cur ^= 1;
    }
    cluster.sync();             // the scatter has landed; carry is free
  }

  // 4. dedup against the previous point in sorted order, then the rows
  bool uniq[kItems];
  int val[kItems][3];
  unsigned lane_before[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int slot = r * kThreads + tid, pos = rank * kTile + slot;
    uniq[r] = false;
    if (pos < p.n) {
      const int i = s.idx[cur][slot];
      const int4 a = p.payload[2 * i], b = p.payload[2 * i + 1];
      bool first = true;
      if (pos > 0) {
        const int j = slot > 0
            ? s.idx[cur][slot - 1]
            : cluster.map_shared_rank(&s.idx[cur][0], rank - 1)[kTile - 1];
        const int4 pa = p.payload[2 * j];
        first = pa.x != a.x || pa.y != a.y || pa.z != a.z;
      }
      uniq[r] = b.z != 0 && first;
      val[r][0] = a.w;
      val[r][1] = b.x;
      val[r][2] = b.y;
    }
    const unsigned ballot = __ballot_sync(kFull, uniq[r]);
    lane_before[r] = __popc(ballot & lt);
    if (lane == 0) s.uniq_warp[r][warp] = __popc(ballot);
  }
  __syncthreads();
  if (warp == 0) {              // exclusive over (round, warp)
    unsigned run = 0;
    for (int r = 0; r < kItems; ++r) {
      const unsigned v = s.uniq_warp[r][lane];
      unsigned incl = v;
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      s.uniq_warp[r][lane] = run + incl - v;
      run += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) s.cta_uniq = run;
  }
  cluster.sync();
  if (warp == 0) {
    const unsigned v = lane < csize
        ? cluster.map_shared_rank(&s.cta_uniq, lane)[0] : 0u;
    const unsigned before = __reduce_add_sync(kFull, lane < rank ? v : 0u);
    const unsigned total = __reduce_add_sync(kFull, v);
    if (lane == 0) {
      s.uniq_before = before;
      s.uniq_total = total;
    }
  }
  cluster.sync();               // no CTA leaves while a peer reads it
  const unsigned kept = min(s.uniq_total, (unsigned)p.capacity);
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (!uniq[r]) continue;
    const unsigned row = s.uniq_before + s.uniq_warp[r][warp]
        + lane_before[r];
    if (row >= kept) continue;
    transform(p.m, val[r], p.out + 3 * row);
    p.mask[row] = 1;
  }
  for (int row = (int)kept + rank * kThreads + tid; row < p.rows;
       row += csize * kThreads) {
    p.out[3 * row] = p.out[3 * row + 1] = p.out[3 * row + 2] = 0;
    p.mask[row] = 0;
  }
}

}  // namespace

extern "C" {

// the most points one call takes: a full cluster
int ws_preprocess_max_points() { return kTile * kMaxCluster; }

// points (n, 3) float32, valid (n,) bool, payload (n, 8) int32 scratch,
// out (min(n, capacity), 3) int32, mask (min(n, capacity),) bool, all on
// the current device; mat: to_int_mat's top three rows (12 host int32,
// read at the call).  Returns a cudaError_t.
int ws_preprocess(const void* points, const void* valid, void* payload,
                  void* out, void* mask, int n, int capacity, int res,
                  float inv_res, int snap, const int* mat, void* stream) {
  if (n < 1 || n > kTile * kMaxCluster || capacity < 1 || res < 1)
    return (int)cudaErrorInvalidValue;
  // per call, so that every device's context has them
  cudaError_t err = cudaFuncSetAttribute(
      preprocess_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        preprocess_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.points = (const float*)points;
  p.valid = (const unsigned char*)valid;
  p.payload = (int4*)payload;
  p.out = (int*)out;
  p.mask = (unsigned char*)mask;
  p.n = n;
  p.capacity = capacity;
  p.rows = n < capacity ? n : capacity;
  p.res = res;
  p.snap = snap;
  p.inv_res = inv_res;
  for (int k = 0; k < 12; ++k) p.m[k] = mat[k];
  const int csize = (n + kTile - 1) / kTile;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = sizeof(Smem);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, preprocess_kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
