// The registration loop kernel: a whole Gauss-Newton / Levenberg-Marquardt
// registration in one launch, with a plain C interface (ctypes).  Built by
// kernels/_build.py: sm_90a, -fmad=false, no fast math.
//
// It takes the place of the JAX package's device loop
// (warpsense_tpu/ops/registration.py: _gn_loop :212 and _lm_loop :572, a
// lax.while_loop over jacobian_stats_fields :106 / make_packed_stats :454 /
// make_packed_stats_split :512; XLA code, no TPU kernel).  It keeps two
// names for its two halves: K3, an iteration's statistics, and K4, the
// step.  The loop's carry is one float32 state (layout: S_* below, the same
// as ops/registration.py's), read from device memory at the start and
// written back at the end.
//
// What bounds it on an H100: latency.  An iteration gathers one cell per
// point (32,766 points read ~0.5 MB, 0.14 us at 3.35 TB/s) and then solves
// one 6x6 system, a chain of dependent scalar operations.  The design keeps
// the whole loop on the card in one launch, so no host work and no launch
// sits between two iterations.
//
// Design: one thread-block cluster of C = kCluster CTAs (kThreads threads
// each) on neighbouring SMs.  Each CTA holds a copy of the carry in shared
// memory; a first cluster barrier waits until every CTA of the cluster has
// started (before any store into a peer's shared memory).  An iteration in
// every CTA:
//   K3  each thread sums the statistics of its points (the point -> thread
//       map depends on the point count alone: global thread g takes points
//       g, g + C * kThreads, ...), in point order; a warp shuffle tree,
//       then the warps in order, give one row of 29 sums per CTA,
//       which the CTA stores into its slot of every CTA's row buffer
//       (distributed shared memory), double-buffered by the iteration's
//       parity;
//   --  cluster.sync();
//   K4  warp 0 of every CTA reads the C rows from its own shared memory,
//       sums them in ops/registration.sum_partials' order (STEP_LANES = 8
//       interleaved lanes, then the lanes in order) and takes the step on
//       those bits, so every copy of the carry stays equal and nothing is
//       broadcast.
// One cluster barrier an iteration suffices: a CTA stores iteration k+2's
// row into the buffers of iteration k only after every CTA passed the
// barrier of iteration k+1, and by then each has read iteration k's rows.
// The loop ends on the finished flag or at max_iterations, the same test in
// every CTA; a last barrier keeps every CTA's shared memory alive until its
// peers' stores into it are done; CTA 0 writes the carry back.
//
// K3 per point: the int32 fixed-point transform with its wrap, the floor
// cell, the in-bounds test, the ring coordinates, one gather and decode
// (parity: three planes; fast: one packed plane or two exact planes), the
// interpolated residual, J with the cross product as core.geometry.cross
// writes it, and its 29 sums (21 of H's upper triangle, 6 of g, e, c).  The
// mode (coarse: every 4th point; gather: write the per-point cache and
// evaluate; cached: evaluate from the cache; full) is read from the carry,
// the same decision as JAX's reuse / coarse_now.  A thread keeps its points
// across iterations, so the cache it reads is the one it wrote.
//
// K4: the damped system, its LU with partial pivoting in float32 (a zero
// pivot gives NaN), xi_to_transform and the pose product, and the loop's
// tests (4-error window, LM's tiny / !ok, the freeze), in the same float32
// operations, in the same order, as ops/registration.reg_step_plain.  The
// 29 column sums, each pivot step's row updates (one row a lane, held in
// registers) and the 16 entries of the pose product run one a lane; the
// pivot search, the back substitution, sin and cos (from double) and the
// tests run on lane 0.
//
// With a trace pointer, CTA 0 also writes, for iteration i, the carry
// before the step and the C rows it summed into row i of a (max_it,
// STATE_LEN + C * 32) float32 buffer (the checks replay the steps from it).
//
// The sharded loop (parallel/sharded.run_registration_sharded) takes the
// place of the JAX package's loops under shard_map
// (warpsense_tpu/parallel/sharded.py: register_cloud_sharded :145, whose
// statistics are psum-ed :134, and register_cloud_packed_sharded :397, one
// fused psum an iteration :439).  Each rank owns an x-slab of the window's
// ring rows [x_lo, x_lo + x_rows); a point whose cell another rank owns
// adds nothing.  The ranks' rows of an iteration are all-gathered between
// two launches on the stream (NCCL), because a kernel that waited inside
// itself for another process's rows could deadlock on a card that
// time-slices the ranks' kernels.  So an iteration is one launch of
// shard_iter_kernel, the step of the iteration before folded into it:
//   every CTA (the loop kernel's C CTAs and point plan, no cluster) reads
//   the carry slot ``parity`` and, when its PENDING flag is set, the
//   world's gathered rows of that carry's iteration (rank-major), sums them
//   in sum_partials' order and takes step() in its shared memory, so every
//   CTA and every rank holds the same bits with nothing broadcast; CTA 0
//   writes the new carry into the other slot; then, unless the carry
//   stopped, each CTA computes its row of the next iteration's statistics
//   from that carry into this rank's rows of the other slot, which the
//   collective gathers for the next launch.
// The carry and the rows are double-buffered by the launch's parity, so no
// CTA reads what another CTA of its launch writes.  A chunk is CHUNK such
// launches (each followed by the rows' all-gather) and one header read;
// the rows of a chunk's last launch are stepped on by the next chunk's
// first.  The arguments live in device memory (ShardArgs, written by the
// host before each registration), so that a CUDA graph of one chunk,
// captured once, serves every registration of the same kind.  With a
// trace, CTA 0 writes row i (kStateLen + nrows * 32 floats: the carry
// before step i and the rows) where it takes step i.  What bounds it is
// latency, as for the loop kernel: a launch, the step and the statistics
// run one after another, so the design cuts launches (one an iteration)
// and the host's work between them (the captured chunk).

// Two macros are for tools/loop_phases.py alone, which builds a copy of
// this file with them: WS_REG_CLUSTER (C, 16 by default) and
// WS_LOOP_PHASES (CTA 0's thread 0 stamps each iteration's phases with
// clock64() and writes the cycles into the trace's zero columns).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#ifdef WS_LOOP_PHASES
#define PHASE(t) ((t) = clock64())
#else
#define PHASE(t) ((void)0)
#endif

namespace {

constexpr int kThreads = 512;   // a CTA; at 1,024 K3's registers would spill
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 8;       // ops/registration.STEP_LANES
constexpr int kPartials = 32;   // one row a CTA: 21 H, 6 g, e, c, 3 zeros
constexpr int kSums = 29;
constexpr int kStateLen = 96;   // ops/registration.STATE_LEN
// the cluster: 16 CTAs (a non-portable size, which an H100 places) took
// 0.76-0.88 of the portable 8's device time an iteration on every REGLOOP
// problem (PERF.md section 6); kernels/registration.CLUSTER is the same
#ifndef WS_REG_CLUSTER
#define WS_REG_CLUSTER 16
#endif
constexpr int kCluster = WS_REG_CLUSTER;
static_assert(kCluster % kLanes == 0, "add_rows adds whole lanes");
constexpr int kMR = 32768;      // core/consts.MATRIX_RESOLUTION

// state layout: ops/registration.py S_*
enum {
  S_I = 0, S_FIN = 1, S_ERR = 2, S_FROZEN = 3, S_ALPHA = 4, S_IMPROVED = 5,
  S_OK = 6, S_PREV = 8, S_CENTER = 12, S_TRIAL = 16, S_ACC = 32,
  S_ACCH = 48, S_ACCG = 84
};

enum Layout { kParity = 0, kPacked = 1, kExact = 2 };
enum Mode { kFull = 0, kCoarse = 1, kGather = 2, kCached = 3 };

// column scales: ops/registration.py _SC, _SG (parity), _SCP (fast)
constexpr float kSC = 1.0f / 16777216.0f;
constexpr float kSG = 1.0f / 1024.0f;
constexpr float kSCP = 1.0f / 32768.0f;

struct LoopArgs {
  float* state;
  const int* points;
  const unsigned char* mask;
  const int* plane0;
  const int* plane1;
  const int* plane2;
  const int* pos;
  const int* offset;
  unsigned char* c_valid;
  float* c_v;
  float* c_g;
  int* c_cc;
  float* trace;
  int n, X, Y, Z, res, vs, gs, interp, normalize, coarse, split, max_it;
  int lm, recenter;
  float eps, itw, freeze2;
  int res_shift;    // log2(res) when res is a power of two, else -1
  float inv_res;    // 1 / res, exact when res_shift >= 0
};

// a rank's slab: its ring rows [x_lo, x_lo + x_rows) of the window, the
// rows its planes hold (shard_iter_kernel alone takes one, so that the
// loop kernel's arguments stay as they were)
struct Slab {
  int x_lo, x_rows;
};

// C-trunc division by MATRIX_RESOLUTION as core.geometry.div_trunc writes
// it (|a| // b with a sign fix): INT_MIN, whose abs wraps, gives 65536
__device__ __forceinline__ int div_trunc_mr(int a) {
  return a == INT32_MIN ? 65536 : a / kMR;
}

__device__ __forceinline__ int floor_div(int a, int b) {      // b > 0
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int py_mod(int a, int m) {         // m > 0
  int r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ int lo16(int x) {
  return (int)(short)(x & 0xFFFF);
}

__device__ __forceinline__ int hi16(int x) { return x >> 16; }

// the pose's fixed-point matrix, trunc(total * MR) as int32
__device__ __forceinline__ void int_mat(const float* T, int m[12]) {
#pragma unroll
  for (int k = 0; k < 12; ++k) m[k] = (int)truncf(T[k] * (float)kMR);
}

// transform_point_fixed: wrapping int32 multiply-adds, then div_trunc
__device__ __forceinline__ void transform(const int* p, const int m[12],
                                          int out[3]) {
  const unsigned px = (unsigned)p[0], py = (unsigned)p[1],
                 pz = (unsigned)p[2];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const unsigned acc = px * (unsigned)m[4 * j] + py * (unsigned)m[4 * j + 1]
        + pz * (unsigned)m[4 * j + 2] + (unsigned)m[4 * j + 3];
    out[j] = div_trunc_mr((int)acc);
  }
}

// x / res in float32: for a power of two the product with its exact
// reciprocal, which rounds the same exact value once, so the same bits
__device__ __forceinline__ float div_res(const LoopArgs& a, float x) {
  return a.res_shift >= 0 ? x * a.inv_res : x / (float)a.res;
}

// the point's window cell: floor division (an arithmetic shift for a power
// of two), in_bounds(buffer 1), ring coords (the modulo only off the
// window's first turn of the ring) over the whole window; with S then
// ownership: a cell outside the rank's ``slab`` is not valid
// (ops/registration.owned_index_fn's rule), and ``flat`` indexes the
// slab's planes.  The loop kernel, which runs the whole window, is built
// without S and never reads ``slab``: the compare cost it measurable time
// (PERF.md section 6)
template <bool S>
__device__ __forceinline__ bool cell(const LoopArgs& a, Slab slab,
                                     const int pts[3], int buf[3],
                                     long long* flat) {
  const int sz[3] = {a.X, a.Y, a.Z};
  bool ok = true;
  int r[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    buf[k] = a.res_shift >= 0 ? pts[k] >> a.res_shift
                              : floor_div(pts[k], a.res);
    const int d = buf[k] - a.pos[k];
    ok = ok && d >= -(sz[k] / 2) + 1 && d <= (sz[k] - 1) / 2 - 1;
    r[k] = d + a.offset[k];
    if ((unsigned)r[k] >= (unsigned)sz[k]) r[k] = py_mod(r[k], sz[k]);
  }
  int x = r[0];
  if (S) {
    x -= slab.x_lo;
    ok = ok && (unsigned)x < (unsigned)slab.x_rows;
  }
  *flat = ((long long)x * a.Y + r[1]) * a.Z + r[2];
  return ok;
}

// gather and decode one cell: (valid, value, gradient) as integers
template <int L>
__device__ __forceinline__ bool gather(const LoopArgs& a, long long flat,
                                       int* v, int g[3]) {
  if (L == kParity) {
    const int vw = a.plane0[flat];
    const int gxy = a.plane1[flat];
    const int gz = a.plane2[flat];
    *v = lo16(vw);
    g[0] = lo16(gxy);
    g[1] = hi16(gxy);
    g[2] = lo16(gz);
    return hi16(vw) != 0;
  } else if (L == kExact) {
    const int pa = a.plane0[flat];
    const int pb = a.plane1[flat];
    *v = lo16(pa);
    g[0] = hi16(pa);
    g[1] = lo16(pb);
    g[2] = hi16(pb);
    return *v != -32768;
  } else {
    const int code = a.plane0[flat];
    const int vcode = (code >> 24) & 0xFF;
    *v = (vcode - 128) * (1 << a.vs);
    g[0] = (((code >> 16) & 0xFF) - 128) * (1 << a.gs);
    g[1] = (((code >> 8) & 0xFF) - 128) * (1 << a.gs);
    g[2] = ((code & 0xFF) - 128) * (1 << a.gs);
    return vcode != 0;
  }
}

// core.geometry.cross: three products and a difference per component
__device__ __forceinline__ void cross3(const float p[3], const float q[3],
                                       float out[3]) {
  out[0] = p[1] * q[2] - p[2] * q[1];
  out[1] = p[2] * q[0] - p[0] * q[2];
  out[2] = p[0] * q[1] - p[1] * q[0];
}

__device__ __forceinline__ void accumulate(float acc[kSums], const float J[6],
                                           float r) {
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) acc[k++] += J[i] * J[j];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[21 + i] += J[i] * r;
  acc[27] += fabsf(r);
  acc[28] += 1.0f;
}

// fast mode (make_packed_stats / the split's eval_fn) for one valid point
__device__ __forceinline__ void fast_terms(const LoopArgs& a,
                                           const float* T, const int pts[3],
                                           float v, const float gf[3],
                                           const int cc[3], float acc[kSums]) {
  float r = v;
  if (a.interp) {
    float t[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = gf[k] * (float)(pts[k] - cc[k]);
    r = r + ((t[0] + t[1]) + t[2]);
  }
  const float p[3] = {(float)pts[0] - T[3], (float)pts[1] - T[7],
                      (float)pts[2] - T[11]};
  float c[3];
  cross3(p, gf, c);
  const float J[6] = {c[0] * kSCP, c[1] * kSCP, c[2] * kSCP,
                      gf[0], gf[1], gf[2]};
  accumulate(acc, J, r);
}

template <int L, int M, bool S>
__device__ void point_stats(const LoopArgs& a, Slab slab, const float* T,
                            const int m[12], int idx, float acc[kSums]) {
  int pts[3];
  transform(a.points + 3 * (long long)idx, m, pts);
  if (M == kCached) {
    if (!a.c_valid[idx]) return;
    const float gf[3] = {a.c_g[3 * idx], a.c_g[3 * idx + 1],
                         a.c_g[3 * idx + 2]};
    const int cc[3] = {a.c_cc[3 * idx], a.c_cc[3 * idx + 1],
                       a.c_cc[3 * idx + 2]};
    fast_terms(a, T, pts, a.c_v[idx], gf, cc, acc);
    return;
  }
  int buf[3];
  long long flat;
  int v = 0, g[3] = {0, 0, 0};
  bool ok = a.mask[idx] != 0 && cell<S>(a, slab, pts, buf, &flat);
  if (ok) ok = gather<L>(a, flat, &v, g);
  if (L == kParity) {
    if (!ok) return;
    // jacobian_stats_fields: p from the int32 difference to the pose's
    // truncated translation; the voxel gradient, normalized in fast mode
    const int ctr[3] = {(int)truncf(T[3]), (int)truncf(T[7]),
                        (int)truncf(T[11])};
    const float p[3] = {(float)(pts[0] - ctr[0]), (float)(pts[1] - ctr[1]),
                        (float)(pts[2] - ctr[2])};
    float gr[3] = {(float)g[0], (float)g[1], (float)g[2]};
    if (a.normalize) {
#pragma unroll
      for (int k = 0; k < 3; ++k) gr[k] = div_res(a, gr[k]);
    }
    float c[3];
    cross3(p, gr, c);
    const float J[6] = {c[0] * kSC, c[1] * kSC, c[2] * kSC,
                        gr[0] * kSG, gr[1] * kSG, gr[2] * kSG};
    accumulate(acc, J, (float)v);
    return;
  }
  const float gf[3] = {div_res(a, (float)g[0]), div_res(a, (float)g[1]),
                       div_res(a, (float)g[2])};
  int cc[3] = {0, 0, 0};
  if (ok) {
#pragma unroll
    for (int k = 0; k < 3; ++k) cc[k] = buf[k] * a.res + a.res / 2;
  }
  if (M == kGather) {
    a.c_valid[idx] = ok ? 1 : 0;
    a.c_v[idx] = (float)v;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a.c_g[3 * idx + k] = gf[k];
      a.c_cc[3 * idx + k] = cc[k];
    }
  }
  if (ok) fast_terms(a, T, pts, (float)v, gf, cc, acc);
}

// this thread's points (kernels/registration.thread_points is the plan's
// plain model): global thread g of the cluster's kCluster * kThreads
// takes the strided points g, g + kCluster * kThreads, ... in order
template <int L, int M, bool S>
__device__ void thread_points(const LoopArgs& a, Slab slab, const float* T,
                              const int m[12], int g, float acc[kSums]) {
  const int stride = M == kCoarse ? 4 : 1;
  const int count = (a.n + stride - 1) / stride;
  for (int j = g; j < count; j += kCluster * kThreads)
    point_stats<L, M, S>(a, slab, T, m, j * stride, acc);
}

// The sharded K3's parts (shard_iter_kernel): the loop kernel's K3 with
// the same operations in the same order, which the loop kernel writes out
// in its body (called through these helpers, its SASS moved and its
// packed REGLOOP problem ran ~2% slower: PERF.md section 6).

// the iteration's statistics mode, read from the carry: JAX's reuse /
// coarse_now decision
template <int L>
__device__ __forceinline__ int iteration_mode(const float* s,
                                              const LoopArgs& a, int i) {
  if (L == kParity) return kFull;
  if (a.coarse > 0 && i < a.coarse) return kCoarse;
  if (a.split) return s[S_FROZEN] != 0.0f ? kCached : kGather;
  return kFull;
}

// K3 of global thread g at the carry's trial pose: its points' sums (S:
// on a rank's slab)
template <int L, bool S>
__device__ __forceinline__ void thread_stats(const LoopArgs& a, Slab slab,
                                             const float* s, int mode, int g,
                                             float acc[kSums]) {
  const float* T = s + S_TRIAL;
  int m[12];
  int_mat(T, m);
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
  switch (mode) {
    case kCoarse: thread_points<L, kCoarse, S>(a, slab, T, m, g, acc); break;
    case kGather: thread_points<L, kGather, S>(a, slab, T, m, g, acc); break;
    case kCached: thread_points<L, kCached, S>(a, slab, T, m, g, acc); break;
    default: thread_points<L, kFull, S>(a, slab, T, m, g, acc); break;
  }
}

// the CTA's row of sums: a warp shuffle tree, then the warps in order (a
// fixed order of additions); every thread of the CTA calls it; thread t <
// kPartials gets column t (0 past kSums)
__device__ __forceinline__ float cta_row(const float acc[kSums],
                                         float (*red)[kPartials], int tid) {
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    float x = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) red[warp][k] = x;
  }
  __syncthreads();
  float t = 0.0f;
  if (tid < kSums) {
#pragma unroll
    for (int v = 0; v < kWarps; ++v) t += red[v][tid];
  }
  return t;
}

// ------------------------------------------------------------------ K4

// The rows of statistics are summed in ops/registration.sum_partials'
// order: kLanes interleaved lanes (rows l, l + kLanes, ...) each in row
// order, then the lanes in order.  A lane of the warp sums one column; the
// rows arrive kCluster at a time (``x``, read into registers first so the
// reads overlap), each block added into the lanes' sums ``t`` in row order.
__device__ __forceinline__ void add_rows(const float x[kCluster],
                                         float t[kLanes]) {
#pragma unroll
  for (int r = 0; r < kCluster; ++r) t[r % kLanes] = t[r % kLanes] + x[r];
}

__device__ __forceinline__ float lanes_total(const float t[kLanes]) {
  float total = 0.0f;
#pragma unroll
  for (int l = 0; l < kLanes; ++l) total = total + t[l];
  return total;
}

// the step's arrays in shared memory (warp 0 of each CTA works on them):
// the summed statistics, the step xi and the transform it gives
struct StepScratch {
#ifdef WS_LOOP_PHASES
  long long ts[3];
#endif
  float sum[kPartials];
  float xi[6];
  float T[16];
};

// H[i][j] of the summed statistics: the upper triangle's row-major entry
// lo * (11 - lo) / 2 + hi, lo = min(i, j), hi = max(i, j)
__device__ __forceinline__ float h_at(const float* sum, int i, int j) {
  const int lo = i < j ? i : j, hi = i < j ? j : i;
  return sum[lo * (11 - lo) / 2 + hi];
}

// 6x6 solve on one warp, LU with partial pivoting (the first largest
// |pivot|), in the order of ops/registration.solve6; a zero pivot makes
// every y NaN.  Lane r < 6 holds row r of A (``row``) and b[r] (``br``) in
// registers; in each pivot step each lane below the pivot updates its own
// row (its factor one division, each element one product and one
// difference); lane 0 searches the pivot and back-substitutes; shuffles
// move the pivot column, the swapped rows and the pivot row.  Every lane
// returns y.
__device__ __forceinline__ void solve6(float row[6], float br, float y[6],
                                       int lane) {
  constexpr unsigned kAll = 0xffffffffu;
  bool singular = false;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    float col[6];
#pragma unroll
    for (int r = k; r < 6; ++r) col[r] = __shfl_sync(kAll, row[k], r);
    int p = k;
    if (lane == 0) {
      float best = fabsf(col[k]);
#pragma unroll
      for (int r = k + 1; r < 6; ++r) {
        const float v = fabsf(col[r]);
        if (v > best) {
          best = v;
          p = r;
        }
      }
    }
    p = __shfl_sync(kAll, p, 0);
    const int src = lane == k ? p : (lane == p ? k : lane);
#pragma unroll
    for (int j = 0; j < 6; ++j) row[j] = __shfl_sync(kAll, row[j], src);
    br = __shfl_sync(kAll, br, src);
    float pk[6];
#pragma unroll
    for (int j = k; j < 6; ++j) pk[j] = __shfl_sync(kAll, row[j], k);
    const float bk = __shfl_sync(kAll, br, k);
    if (pk[k] == 0.0f) singular = true;
    if (lane > k && lane < 6) {
      const float f = row[k] / pk[k];
#pragma unroll
      for (int j = k + 1; j < 6; ++j) row[j] = row[j] - f * pk[j];
      br = br - f * bk;
    }
  }
  float U[6][6], b[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
#pragma unroll
    for (int j = r; j < 6; ++j) U[r][j] = __shfl_sync(kAll, row[j], r);
    b[r] = __shfl_sync(kAll, br, r);
  }
  float yr[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (lane == 0) {
#pragma unroll
    for (int r = 5; r >= 0; --r) {
      float acc = b[r];
#pragma unroll
      for (int j = r + 1; j < 6; ++j) acc = acc - U[r][j] * yr[j];
      yr[r] = acc / U[r][r];
    }
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    y[k] = __shfl_sync(kAll, yr[k], 0);
    if (singular) y[k] = __int_as_float(0x7fc00000);
  }
}

// y[lane] of a register array (lane < 6), without indexing it at run time
__device__ __forceinline__ float pick6(const float y[6], int lane) {
  float v = y[0];
#pragma unroll
  for (int k = 1; k < 6; ++k) v = lane == k ? y[k] : v;
  return v;
}

// core.geometry.xi_to_transform (Rodrigues about ``c``), then T @ P into
// ``out`` (row-major 4x4; may be P); ops/registration.xi_to_transform_plain's
// order.  Lane 0 forms T; each entry of the product is one lane's.
__device__ __forceinline__ void apply_xi(const float* xi, const float c[3],
                                         const float* P, float* out,
                                         StepScratch& w, int lane) {
  if (lane == 0) {
    const float th2 = (xi[0] * xi[0] + xi[1] * xi[1]) + xi[2] * xi[2];
    const float theta = sqrtf(th2);
    const bool small = theta < 1e-12f;
    const float safe = small ? 1.0f : theta;
    const float u[3] = {xi[0] / safe, xi[1] / safe, xi[2] / safe};
    const float L[9] = {0.0f, -u[2], u[1], u[2], 0.0f, -u[0], -u[1], u[0],
                        0.0f};
    const float sn = (float)sin((double)theta);
    const float c1 = 1.0f - (float)cos((double)theta);
    float R[9];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float ll = (L[i * 3] * L[j] + L[i * 3 + 1] * L[3 + j])
            + L[i * 3 + 2] * L[6 + j];
        const float eye = i == j ? 1.0f : 0.0f;
        R[i * 3 + j] = small ? eye : (eye + sn * L[i * 3 + j]) + c1 * ll;
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float rc = (R[i * 3] * -c[0] + R[i * 3 + 1] * -c[1])
          + R[i * 3 + 2] * -c[2];
#pragma unroll
      for (int j = 0; j < 3; ++j) w.T[i * 4 + j] = R[i * 3 + j];
      w.T[i * 4 + 3] = (rc + c[i]) + xi[3 + i];
    }
    w.T[12] = w.T[13] = w.T[14] = 0.0f;
    w.T[15] = 1.0f;
  }
  __syncwarp();
  float o = 0.0f;
  if (lane < 16) {
    const int i = lane >> 2, j = lane & 3;
    const float* T = w.T;
    o = ((T[i * 4] * P[j] + T[i * 4 + 1] * P[4 + j])
         + T[i * 4 + 2] * P[8 + j]) + T[i * 4 + 3] * P[12 + j];
  }
  __syncwarp();
  if (lane < 16) out[lane] = o;
  __syncwarp();
}

// one step of the loop on warp 0, from the summed statistics w.sum, on the
// carry s (shared memory); every lane computes the same decisions, lane 0
// writes the scalars
__device__ __forceinline__ void step(float* s, StepScratch& w,
                                     const LoopArgs& a, int lane) {
  const float* g = w.sum + 21;
  const int r6 = lane < 6 ? lane : 5;           // this lane's row
  const float e = w.sum[27], c = w.sum[28];
  const int i = (int)s[S_I];
  float* prev = s + S_PREV;
  const float p0 = prev[0], p2 = prev[2];

  if (!a.lm) {
    // _gn_loop: (D H D + alpha c D^2) y = -D g, xi = D y
    const float d = lane < 3 ? kSC : kSG;        // D[lane]
    const bool empty = c <= 0.0f;
    const float ac = s[S_ALPHA] * c;
    float row[6], y[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const float h = h_at(w.sum, r6, j);
      row[j] = empty ? (r6 == j ? 1.0f : 0.0f)
                     : (r6 == j ? h + ac * (d * d) : h);
    }
    if (lane == 0) PHASE(w.ts[0]);
    solve6(row, -g[r6], y, lane);
    if (lane == 0) PHASE(w.ts[1]);
    bool ok = !empty;
#pragma unroll
    for (int k = 0; k < 6; ++k) ok = ok && isfinite(y[k]);
    if (lane < 6) w.xi[lane] = ok ? d * pick6(y, lane) : 0.0f;
    float* T = s + S_TRIAL;
    const float ctr[3] = {
        a.recenter ? truncf(T[3]) : s[S_CENTER],
        a.recenter ? truncf(T[7]) : s[S_CENTER + 1],
        a.recenter ? truncf(T[11]) : s[S_CENTER + 2]};
    __syncwarp();
    if (ok) apply_xi(w.xi, ctr, T, T, w, lane);
    if (lane == 0) PHASE(w.ts[2]);
    if (lane == 0) {
      const float err = e / fmaxf(c, 1.0f);
      const bool fin = (ok && fabsf(err - p2) < a.eps
                        && fabsf(err - p0) < a.eps) || empty;
      prev[0] = prev[1];
      prev[1] = prev[2];
      prev[2] = prev[3];
      prev[3] = err;
      s[S_ERR] = err;
      s[S_OK] = ok ? 1.0f : 0.0f;
      s[S_FIN] = fin ? 1.0f : 0.0f;
      s[S_ALPHA] = s[S_ALPHA] + a.itw;
      s[S_I] = (float)(i + 1);
    }
    return;
  }

  // _lm_loop: delayed accept/reject, Marquardt damping
  const float d = lane < 3 ? kSCP : 1.0f;        // D[lane]
  const float acc_err = s[S_ERR];
  const float err = c > 0.0f ? e / fmaxf(c, 1.0f) : INFINITY;
  bool improved = err <= acc_err;
  float err2 = fminf(err, acc_err);
  if (a.coarse > 0 && i == a.coarse) {
    improved = true;     // the coarse-to-fine hand-off re-baselines
    err2 = err;
  }
  const float alpha = fminf(fmaxf(improved ? s[S_ALPHA] / 3.0f
                                           : s[S_ALPHA] * 4.0f, 1e-5f), 1e5f);
  float* acc = s + S_ACC;
  float* accH = s + S_ACCH;
  float* accg = s + S_ACCG;
  if (improved) {
    if (lane < 16) acc[lane] = s[S_TRIAL + lane];
    for (int q = lane; q < 36; q += 32) accH[q] = h_at(w.sum, q / 6, q % 6);
    if (lane < 6) accg[lane] = g[lane];
  }
  __syncwarp();
  float row[6], y[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const float h = accH[r6 * 6 + j];
    row[j] = r6 == j ? h + alpha * (h + 1e-12f) : h;
  }
  if (lane == 0) PHASE(w.ts[0]);
  solve6(row, -accg[r6], y, lane);
  if (lane == 0) PHASE(w.ts[1]);
  bool ok = isfinite(err2);
#pragma unroll
  for (int k = 0; k < 6; ++k) ok = ok && isfinite(y[k]);
  if (lane < 6) w.xi[lane] = ok ? d * pick6(y, lane) : 0.0f;
  const float ctr[3] = {truncf(acc[3]), truncf(acc[7]), truncf(acc[11])};
  __syncwarp();
  apply_xi(w.xi, ctr, acc, s + S_TRIAL, w, lane);
  if (lane == 0) PHASE(w.ts[2]);
  if (lane == 0) {
    const float* xi = w.xi;
    const float rot2 = (xi[0] * xi[0] + xi[1] * xi[1]) + xi[2] * xi[2];
    const float tr2 = (xi[3] * xi[3] + xi[4] * xi[4]) + xi[5] * xi[5];
    const bool tiny = improved && rot2 < 1e-7f && tr2 < 0.25f;
    const bool window = fabsf(err2 - p2) < a.eps && fabsf(err2 - p0) < a.eps;
    const bool fin = tiny || window || !ok;
    prev[0] = prev[1];
    prev[1] = prev[2];
    prev[2] = prev[3];
    prev[3] = err2;
    if (a.split && improved && i >= a.coarse && tr2 < a.freeze2
        && rot2 < 1e-6f)
      s[S_FROZEN] = 1.0f;
    s[S_ERR] = err2;
    s[S_ALPHA] = alpha;
    s[S_IMPROVED] = improved ? 1.0f : 0.0f;
    s[S_OK] = ok ? 1.0f : 0.0f;
    s[S_FIN] = fin ? 1.0f : 0.0f;
    s[S_I] = (float)(i + 1);
  }
}

// ------------------------------------------------------------ the loop

template <int L>
__global__ void __launch_bounds__(kThreads, 1)
loop_kernel(LoopArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int width = kStateLen + kCluster * kPartials;   // a trace row
  __shared__ float s[kStateLen];
  __shared__ float rows[2][kCluster][kPartials];
  __shared__ float red[kWarps][kPartials];
  __shared__ StepScratch w;
  if (tid < kStateLen) s[tid] = a.state[tid];
  cluster.sync();        // every CTA has started before the first store
#ifdef WS_LOOP_PHASES
  long long t0 = 0, t1 = 0, t2 = 0, t3 = 0, t4 = 0, t5 = 0, t6 = 0;
#endif
  while (true) {
    const int i = (int)s[S_I];
    if (s[S_FIN] != 0.0f || i >= a.max_it) break;
    PHASE(t0);
    int mode = kFull;
    if (L != kParity) {
      if (a.coarse > 0 && i < a.coarse)
        mode = kCoarse;
      else if (a.split)
        mode = s[S_FROZEN] != 0.0f ? kCached : kGather;
    }
    // K3: this CTA's row of sums at the trial pose (shard_iter_kernel's
    // helpers, written out)
    const float* T = s + S_TRIAL;
    int m[12];
    int_mat(T, m);
    float acc[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
    const int gt = rank * kThreads + tid;
    const Slab all{0, a.X};   // not read: without S every row is owned
    switch (mode) {
      case kCoarse:
        thread_points<L, kCoarse, false>(a, all, T, m, gt, acc); break;
      case kGather:
        thread_points<L, kGather, false>(a, all, T, m, gt, acc); break;
      case kCached:
        thread_points<L, kCached, false>(a, all, T, m, gt, acc); break;
      default: thread_points<L, kFull, false>(a, all, T, m, gt, acc); break;
    }
    PHASE(t1);
    // warp tree, then the warps in order: a fixed order of additions
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
      float x = acc[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        x += __shfl_down_sync(0xffffffffu, x, off);
      if (lane == 0) red[warp][k] = x;
    }
    __syncthreads();
    // this CTA's row, stored into every CTA's buffer of this parity
    float* mine = rows[i & 1][rank];
    if (tid < kPartials) {
      float t = 0.0f;
      if (tid < kSums) {
#pragma unroll
        for (int v = 0; v < kWarps; ++v) t += red[v][tid];
      }
#pragma unroll
      for (int r = 0; r < kCluster; ++r)
        cluster.map_shared_rank(mine, r)[tid] = t;
    } else if (a.trace != nullptr && rank == 0
               && tid < kPartials + kStateLen) {
      a.trace[(long long)i * width + (tid - kPartials)] = s[tid - kPartials];
    }
    PHASE(t2);
    cluster.sync();
    PHASE(t3);
    // K4: the C rows in sum_partials' order, then the step, on warp 0
    if (warp == 0) {
      float x[kCluster];
#pragma unroll
      for (int r = 0; r < kCluster; ++r) x[r] = rows[i & 1][r][lane];
      float t[kLanes] = {};
      add_rows(x, t);
      if (a.trace != nullptr && rank == 0) {
#pragma unroll
        for (int r = 0; r < kCluster; ++r)
          a.trace[(long long)i * width + kStateLen + r * kPartials + lane]
              = x[r];
      }
      w.sum[lane] = lanes_total(t);
      __syncwarp();
      PHASE(t4);
      step(s, w, a, lane);
      PHASE(t5);
    }
    __syncthreads();
    PHASE(t6);
#ifdef WS_LOOP_PHASES
    // the cycles of the phases, in three rows' zero columns 29-31
    if (a.trace != nullptr && rank == 0 && tid == 0) {
      float* pr = a.trace + (long long)i * width + kStateLen;
      const long long v[9] = {t1 - t0, t2 - t1, t3 - t2, t4 - t3,
                              w.ts[0] - t4, w.ts[1] - w.ts[0],
                              w.ts[2] - w.ts[1], t5 - w.ts[2], t6 - t5};
      for (int q = 0; q < 9; ++q)
        pr[(q / 3) * kPartials + 29 + q % 3] = (float)v[q];
    }
#endif
  }
  cluster.sync();        // no CTA leaves while a peer still stores into it
  if (rank == 0 && tid < kStateLen) a.state[tid] = s[tid];
}

// --------------------------------------------- the sharded loop's iteration

// a carry slot: the state, then the PENDING flag (ops/registration.py
// CARRY_LEN, PENDING), then unused zeros
constexpr int kCarry = kStateLen + 32;
constexpr int kPending = kStateLen;

// what a sharded iteration reads, in device memory (ws_reg_shard_args
// fills it on the host; the wrapper copies it to the card)
struct ShardArgs {
  LoopArgs a;             // a.state unused: the carry is below
  Slab slab;
  float* carry;           // [2][kCarry]
  float* rows;            // [2][kCluster][kPartials]: this rank's rows
  const float* rows_all;  // [2][nrows][kPartials]: the world's, rank-major
  int nrows;              // world * kCluster
};
constexpr int kArgWords = (int)(sizeof(ShardArgs) / 4);
static_assert(sizeof(ShardArgs) % 4 == 0 && kArgWords <= kThreads,
              "one word of the arguments a thread");

// One sharded iteration (see the head of this file): the step of the
// carry slot ``parity`` on the gathered rows when they are pending, the
// new carry into the other slot (CTA 0), then this rank's rows of the next
// iteration's statistics, a row a CTA, into the other slot of ``rows``.
template <int L>
__global__ void __launch_bounds__(kThreads, 1)
shard_iter_kernel(const ShardArgs* __restrict__ args, int parity) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __shared__ ShardArgs p;
  __shared__ float s[kStateLen];
  __shared__ float red[kWarps][kPartials];
  __shared__ StepScratch w;
  if (tid < kArgWords)
    reinterpret_cast<int*>(&p)[tid] = reinterpret_cast<const int*>(args)[tid];
  __syncthreads();
  const float* src = p.carry + parity * kCarry;
  if (tid < kStateLen) s[tid] = src[tid];
  const bool pending = src[kPending] != 0.0f;
  __syncthreads();
  const LoopArgs& a = p.a;
  if (pending) {
    if (warp == 0) {
      const int n = p.nrows;
      const float* rows = p.rows_all + (long long)parity * n * kPartials;
      float* row = a.trace == nullptr || blockIdx.x != 0 ? nullptr
          : a.trace + (long long)(int)s[S_I] * (kStateLen + n * kPartials);
      if (row != nullptr) {
        for (int k = lane; k < kStateLen; k += 32) row[k] = s[k];
      }
      float t[kLanes] = {};
      for (int b = 0; b < n; b += kCluster) {
        float x[kCluster];
#pragma unroll
        for (int r = 0; r < kCluster; ++r)
          x[r] = rows[(b + r) * kPartials + lane];
        add_rows(x, t);
        if (row != nullptr) {
#pragma unroll
          for (int r = 0; r < kCluster; ++r)
            row[kStateLen + (b + r) * kPartials + lane] = x[r];
        }
      }
      w.sum[lane] = lanes_total(t);
      __syncwarp();
      step(s, w, a, lane);
    }
    __syncthreads();
  }
  const int i = (int)s[S_I];
  const bool go = s[S_FIN] == 0.0f && i < a.max_it;
  if (blockIdx.x == 0) {
    float* dst = p.carry + (1 - parity) * kCarry;
    if (tid < kStateLen) dst[tid] = s[tid];
    else if (tid == kPending) dst[kPending] = go ? 1.0f : 0.0f;
  }
  if (!go) return;
  float acc[kSums];
  thread_stats<L, true>(a, p.slab, s, iteration_mode<L>(s, a, i),
                        (int)blockIdx.x * kThreads + tid, acc);
  const float t = cta_row(acc, red, tid);
  if (tid < kPartials)
    p.rows[((1 - parity) * kCluster + blockIdx.x) * kPartials + tid] = t;
}

// the design's floor: the same cluster doing only each iteration's row
// stores into every CTA (distributed shared memory), cluster.sync() and
// the local read of the C rows, ``iterations`` times; the last sums go to
// ``out`` (32 floats) so nothing is elided
__global__ void __launch_bounds__(kThreads, 1)
empty_cluster_loop(float* out, int iterations) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  __shared__ float rows[2][kCluster][kPartials];
  float total = 0.0f;
  cluster.sync();        // every CTA has started before the first store
  for (int i = 0; i < iterations; ++i) {
    if (tid < kPartials) {
#pragma unroll
      for (int r = 0; r < kCluster; ++r)
        cluster.map_shared_rank(rows[i & 1][rank], r)[tid] = (float)(i + tid);
    }
    cluster.sync();
    if (tid < 32) {
      total = 0.0f;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) total = total + rows[i & 1][r][tid];
    }
    __syncthreads();
  }
  cluster.sync();
  if (rank == 0 && tid < 32) out[tid] = total;
}

// an empty kernel: the launch floor of one kernel on the stream
__global__ void empty_kernel() {}

// a launch of ``kernel`` as one cluster of kCluster CTAs; above the
// portable 8 the kernel is first allowed a non-portable size, once
// (``allowed``: that kernel's own flag)
template <typename K>
cudaLaunchConfig_t cluster_config(cudaStream_t st, cudaLaunchAttribute* attr,
                                  K kernel, bool& allowed) {
  if (kCluster > 8 && !allowed) {
    allowed = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)
        == cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int L>
bool& loop_allowed() {
  static bool allowed = false;
  return allowed;
}

template <int L>
int launch_loop(const LoopArgs& a, cudaStream_t st) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(st, attr, loop_kernel<L>,
                                          loop_allowed<L>());
  return (int)cudaLaunchKernelEx(&cfg, loop_kernel<L>, a);
}

template <int L>
int max_clusters() {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(nullptr, attr, loop_kernel<L>,
                                          loop_allowed<L>());
  int n = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveClusters(
      &n, (const void*)loop_kernel<L>, &cfg);
  return rc == cudaSuccess ? n : -(int)rc;
}

}  // namespace

// iparams: n, X, Y, Z, res, layout, vs, gs, interp, normalize, coarse,
// split, max_it, lm, recenter; fparams: eps, itw, freeze2
static LoopArgs loop_args(float* state, const int* points,
                          const unsigned char* mask, const int* plane0,
                          const int* plane1, const int* plane2,
                          const int* pos, const int* offset,
                          unsigned char* c_valid, float* c_v, float* c_g,
                          int* c_cc, float* trace, const int* iparams,
                          const float* fparams) {
  LoopArgs a{state, points, mask, plane0, plane1, plane2, pos, offset,
             c_valid, c_v, c_g, c_cc, trace,
             iparams[0], iparams[1], iparams[2], iparams[3], iparams[4],
             iparams[6], iparams[7], iparams[8], iparams[9], iparams[10],
             iparams[11], iparams[12], iparams[13], iparams[14],
             fparams[0], fparams[1], fparams[2], -1, 0.0f};
  if (a.res > 0 && (a.res & (a.res - 1)) == 0) {
    a.res_shift = __builtin_ctz((unsigned)a.res);
    a.inv_res = 1.0f / (float)a.res;
  }
  return a;
}

extern "C" {

// the CTAs of the loop kernel's cluster (kernels/registration.CLUSTER)
int ws_reg_cluster() { return kCluster; }

// iparams and fparams as loop_args takes them (host memory, read at the
// call).  ``trace``: null, or (max_it, 96 + kCluster * 32) float32.
int ws_reg_loop(float* state, const int* points, const unsigned char* mask,
                const int* plane0, const int* plane1, const int* plane2,
                const int* pos, const int* offset, unsigned char* c_valid,
                float* c_v, float* c_g, int* c_cc, float* trace,
                const int* iparams, const float* fparams, void* stream) {
  const LoopArgs a = loop_args(state, points, mask, plane0, plane1, plane2,
                               pos, offset, c_valid, c_v, c_g, c_cc, trace,
                               iparams, fparams);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (iparams[5]) {
    case kParity: rc = launch_loop<kParity>(a, st); break;
    case kPacked: rc = launch_loop<kPacked>(a, st); break;
    case kExact: rc = launch_loop<kExact>(a, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return rc != 0 ? rc : (int)cudaGetLastError();
}

// how many clusters of the loop kernel the card can hold at once
// (cudaOccupancyMaxActiveClusters); a cudaError_t as a negative number
int ws_reg_loop_clusters(int layout) {
  switch (layout) {
    case kParity: return max_clusters<kParity>();
    case kPacked: return max_clusters<kPacked>();
    case kExact: return max_clusters<kExact>();
    default: return -(int)cudaErrorInvalidValue;
  }
}

int ws_reg_cluster_empty(float* out, int iterations, void* stream) {
  static bool allowed = false;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(static_cast<cudaStream_t>(stream),
                                          attr, empty_cluster_loop, allowed);
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, empty_cluster_loop, out,
                                            iterations);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

// the bytes of a sharded iteration's arguments (ShardArgs)
int ws_reg_shard_args_size() { return (int)sizeof(ShardArgs); }

// fill ``out`` (ws_reg_shard_args_size() bytes of host memory, copied to
// the card by the wrapper): the loop's arguments as ws_reg_loop takes them
// (no state), with the rank's slab after them (iparams[15] x_lo,
// iparams[16] x_rows), the (2, kCarry) carry, this rank's (2, kCluster,
// 32) rows and the (2, nrows, 32) gathered rows.  ``trace``: null, or
// (max_it, 96 + nrows * 32) float32.
int ws_reg_shard_args(void* out, const int* points, const unsigned char* mask,
                      const int* plane0, const int* plane1, const int* plane2,
                      const int* pos, const int* offset,
                      unsigned char* c_valid, float* c_v, float* c_g,
                      int* c_cc, float* trace, float* carry, float* rows,
                      const float* rows_all, int nrows, const int* iparams,
                      const float* fparams) {
  if (iparams[5] < kParity || iparams[5] > kExact || nrows < 1
      || nrows % kCluster != 0)
    return (int)cudaErrorInvalidValue;
  ShardArgs* p = static_cast<ShardArgs*>(out);
  p->a = loop_args(nullptr, points, mask, plane0, plane1, plane2, pos, offset,
                   c_valid, c_v, c_g, c_cc, trace, iparams, fparams);
  p->slab = Slab{iparams[15], iparams[16]};
  p->carry = carry;
  p->rows = rows;
  p->rows_all = rows_all;
  p->nrows = nrows;
  return 0;
}

// one launch of shard_iter_kernel on ``stream``, the arguments at ``args``
// (device memory, ws_reg_shard_args' block)
int ws_reg_shard_iter(const void* args, int layout, int parity,
                      void* stream) {
  const ShardArgs* p = static_cast<const ShardArgs*>(args);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (parity != 0 && parity != 1) return (int)cudaErrorInvalidValue;
  switch (layout) {
    case kParity:
      shard_iter_kernel<kParity><<<kCluster, kThreads, 0, st>>>(p, parity);
      break;
    case kPacked:
      shard_iter_kernel<kPacked><<<kCluster, kThreads, 0, st>>>(p, parity);
      break;
    case kExact:
      shard_iter_kernel<kExact><<<kCluster, kThreads, 0, st>>>(p, parity);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int ws_reg_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
