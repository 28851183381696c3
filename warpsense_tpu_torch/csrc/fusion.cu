// Kernel K1: projective TSDF sweep + weighted-average merge, in place.
//
// Replaces the TPU kernels warpsense_tpu/kernels/tsdf_pallas.py
// `_fusion_kernel_level16` (level grid, R = I: level_kernel) and
// `_fusion_kernel` (attitude-binned grid: general_kernel).  It computes
// exactly what the JAX twin computes (ops/tsdf_projective.py
// projective_sweep_coords + _projective_math + _merge_planes), including
// under tilt: the TPU kernel's W=0 beam window (fuse only where the
// voxel's column equals its (x, y) column's central column) is a gather
// workaround and is NOT reproduced.  Nor are the TPU layout devices: banked
// lane gathers, the transposed table, lane padding, the NaN hole sentinel
// and the f32 stand-in for integer division (plain C `/` equals it below
// check_fusion_config's bound).
//
// What bounds it on an H100.  A voxel whose update condition `ok` fails
// leaves the map as it is, so the bytes a call must move are the int16
// value and weight of the voxels it fuses, read and written (8 B each), the
// beam table (16 B x channels x columns) and the coordinate vectors: ~60 MB
// for the box-room scan at the 625 x 625 x 235 window, ~18 us at 3.35 TB/s.
// Its float work: the column terms once per (x, y) column, the acceptance
// tests of each voxel inside the exact z cull below, and the value of each
// voxel that passes them (the counts are K1_OPS_* in chip_smoke.py):
// ~2.4 G float32 ops there, ~36 us at the card's 67 TFLOP/s.  So the
// function is bound by its operations, not by its bytes.
//
// The design's own traffic is larger than the function's: the level sweep
// loads the value and weight of every voxel it visits ahead of that
// voxel's tests (which hides the load's latency behind the math), 4 B
// each: the ~58.2M voxels inside the cull's runs at that window, ~233 MB
// or ~70 us at 3.35 TB/s, above the operation bound.  The general sweep
// loads them only for the voxels that pass its beam-free tests (below).
// chip_smoke.py reports this floor beside the bound (sweep_floor_ms).
//
// A call is two launches (three for the general sweep): prepare_kernel
// turns the beam table into float4 rows (bx, by, bz, range) and each
// azimuth column's largest finite range; then level_kernel, or
// general_setup_kernel and general_kernel, sweep and merge.
//
// Design (level_kernel).  A warp takes a tile of kTile (x, y) columns: x is
// blockIdx.y and y comes from blockIdx.x and the warp index, so no voxel
// does an integer division.  Lane l computes the terms of column l once
// (rho2, az, inv_rho, col, col_res: the general path's expressions, which
// at R = I see the same inputs, so the bits cannot change) and searches
// its column's run of z (below).  The warp then sweeps the live columns in
// turn, taking each column's terms from its lane by shuffle, with the lanes
// walking z, so int16 loads and stores stay coalesced.  Each column's beam
// row (channels float4) is copied to shared memory by 16-byte cp.async
// while the column before it is swept (two buffers per warp).  A voxel's
// map entries are loaded before its math, which hides their latency, and
// its acceptance is tested before its value is computed.
//
// The exact cull.  `ok` needs isfinite(b.w), r_vox <= b.w + tau and
// h_res = r_vox * col_res * colstep <= half_res, where b is a beam of the
// column's row.  (1) A row without a finite range fuses nothing: its
// maximum is -inf and the column's run comes out empty.  (2) With m the
// row's largest finite range, b.w <= m gives fl(b.w + tau) <= fl(m + tau),
// since rounding is monotone; h_res is a product of non-negative factors,
// monotone in r_vox; and r_vox = sqrtf(rho2 + dz * dz) does not decrease
// with |dz|, each operation being monotone under round-to-nearest.  So
// keep(dz) = (r_vox <= m + tau && h_res <= half_res) holds on one interval
// of |dz|, that is one run of ascending global z.  The lane finds its ends
// by binary search with the very same float expressions, and only voxels
// inside it run the per-voxel math.  No cull uses ring_ok: banded_atan's
// polynomial is not provably monotone.
//
// The ring offset.  cz comes in ARRAY order: ascending global z rotated by
// the window's ring offset (ops/tsdf_projective.relative_coords).  The cull
// walks global rank j and reads cz[(j + rot) mod Z], where rot, the array
// index of the lowest z, is found from cz itself; a run of global z is up
// to two runs of array z.
//
// Design (general_kernel, any R).  Under a rotation the sensor-frame
// direction d_s = R^T d mixes z into every component, so rho2, the
// azimuth and inv_rho are per voxel and no run of z can be culled exactly
// (r_vox is not provably monotone in z once rotated, and banded_atan's
// monotonicity in float32 is unproved).  What the design removes instead:
// - the rotation's products.  d_s,k = (x R0k + y R1k) + z R2k, summed in
//   that order by the JAX twin (_sensor_direction) and the TPU kernel, so
//   under -fmad=false the bracket is a per-column constant (each lane of
//   the column's warp computes it once) and z R2k a per-z constant
//   (general_setup_kernel writes (z, z R20, z R21, z R22) once per call):
//   a voxel adds three pairs instead of nine products and six sums;
// - work on voxels that cannot fuse: the voxel leaves at the first failed
//   test, in order of cost, each a necessary condition of `ok`:
//   (1) r_vox <= fl(M + tau), M the table's largest finite range (for any
//       finite beam b.w <= M, so fl(b.w + tau) <= fl(M + tau); -inf when
//       the table has none);
//   (2) ring_ok (needs inv_rho and banded_atan, not the azimuth);
//   (3) vertical_ok (needs only r_vox, ringf and ring);
//   (4) horizontal_ok (needs the azimuth: atan2_poly's division);
//   (5) the beam's isfinite(b.w) and r_vox <= b.w + tau, after the gather.
//   A voxel that survives evaluates every expression the parent did, in
//   the same order, so its bits cannot change; ops/tsdf_projective
//   .general_rejects is the plain model of these stages;
// - the map traffic of those voxels: value and weight are loaded only
//   after (4), with the beam, three loads in flight together;
// - the runtime modulo of the column: atan2_poly returns r in [0, pi_f]
//   with its sign (banded_atan(t) lies in [0, 0.786] for t in [0, 1]), so
//   az + pi_f lies in [0, 2 pi_f] (both ends exact) and colf = fl((az +
//   pi_f) * colK) in [0, fl(2 pi_f * colK)], which rounds to at most
//   `columns` for any column count below 2^21: rint(colf) lies in [0,
//   columns] and one conditional subtraction is the floor mod
//   (tests/test_torch_fusion_general.py holds this on the extreme inputs);
// - the reciprocal's division: inv_rho = 1 / max(sqrt(rho2), 1e-20) is
//   __frcp_rn, the correctly rounded reciprocal, the same bits as the
//   correctly rounded quotient of 1.
// The beam table (16 B x channels x columns, 2 MB at 128 x 1024) stays in
// global memory: it is read only by the voxels past (4), through L1/L2,
// where it stays resident; a column's voxels spread over many beam
// columns under tilt, so no row can be staged per column as level_kernel
// does.  One warp per (x, y) column, the lanes walking z in array order
// (coalesced int16 traffic, any ring offset).
//
// What holds it on an H100: instruction issue.  The early-outs' paths are
// prefixes of one another, so a warp iteration issues its deepest lane's
// path (tools/sass_count.py counts them from the SASS and sets them
// against the SMs' issue rate; PERF.md gives the counts).  The merge is the
// longest part of the path and runs on about half of the warp iterations
// of a room scan, though under a tenth of the voxels fuse.  A queue in
// shared memory that merged the passing voxels 32 at a time removed that
// divergence but cost as much in ballots and stores on every iteration; it
// was measured and not kept.
//
// Level work on the general sweep.  At R = I the general sweep gives the
// level sweep's bits: x*1 = x, and x + (+-0) = x for x != 0 while
// +0 + (+-0) = +0, so d_s equals d exactly, signed zeros included, because
// the coordinates come from integers and are never -0.  (Were one -0, d_s
// could carry +0 instead; every later use of d_s squares it, compares it
// with 0, where -0 and +0 agree, or scales it into elevation and azimuth
// terms that are subtracted from nonzero constants, so the result would
// not change either.)  The wrapper runs the general sweep at R = I for a
// level fusion whose beam rows exceed the shared memory a block can opt
// into (ws_fusion_max_channels).
//
// Bit parity with the JAX sweep rests on: -fmad=false (no contraction), no
// fast math (IEEE sqrtf and `/`), rintf for jnp.round (half to even), every
// float constant computed on the host in double and rounded to float
// exactly as JAX rounds a Python float, no double literal in device code,
// each expression evaluated in the JAX order, and floor mod for jnp.mod.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLevelWarps = 4;            // warps per CTA, level sweep
constexpr int kTile = 16;                 // (x, y) columns per level warp
constexpr int kGeneralWarps = 8;          // warps (= columns) per CTA, general
constexpr int kSetupThreads = 256;        // general_setup_kernel's one block
constexpr unsigned kFull = 0xffffffffu;

// float constants, in the order the Python wrapper packs them
enum {
  kR = 0,          // R[0,0] .. R[2,2], row-major (9)
  kAtan = 9,       // _ATAN_COEFFS[0..6] (7)
  kEps20 = 16,     // 1e-20
  kPiHalf,         // pi / 2
  kPi,             // pi
  kOne,            // 1.0
  kHalfV,          // radians(vfov) / 2
  kInvSpacing,     // 1 / spacing
  kSpacing,        // radians(vfov) / (channels - 1)
  kColK,           // columns / (2 pi)
  kColStep,        // 2 pi / columns
  kRingClip,       // 1e4
  kTau,            // float(tau)
  kDzpd,           // float(dz_per_distance)
  kInvMr,          // 1 / MATRIX_RESOLUTION
  kHalfRes,        // resolution * 0.5
  kNegEps,         // -(tau // 10)
  kWres,           // float(WEIGHT_RESOLUTION)
  kInvTauEps,      // 1 / (tau - tau // 10)
  kNumConsts
};

struct Params {
  float c[kNumConsts];
  int X, Y, Z, channels, columns, max_weight;
};

__device__ __forceinline__ float banded_atan(float t, const Params& p) {
  float s = t * t;
  float q = p.c[kAtan + 6];
#pragma unroll
  for (int k = 5; k >= 0; --k) q = q * s + p.c[kAtan + k];
  return q * t;
}

__device__ __forceinline__ float atan2_poly(float y, float x,
                                            const Params& p) {
  float ax = fabsf(x), ay = fabsf(y);
  float hi = fmaxf(fmaxf(ax, ay), p.c[kEps20]);
  float t = fminf(ax, ay) / hi;
  float q = banded_atan(t, p);
  float r = ay > ax ? p.c[kPiHalf] - q : q;
  r = x < 0.0f ? p.c[kPi] - r : r;
  return y < 0.0f ? -r : r;
}

// The terms of a sensor-frame direction that do not depend on its z.
struct ColumnTerms {
  float rho2, inv_rho, col_res;
  int col;
};

__device__ __forceinline__ ColumnTerms column_terms(float dsx, float dsy,
                                                    const Params& p) {
  ColumnTerms t;
  t.rho2 = dsx * dsx + dsy * dsy;
  const float az = atan2_poly(dsy, dsx, p);
  t.inv_rho = p.c[kOne] / fmaxf(sqrtf(t.rho2), p.c[kEps20]);
  const float colf = (az + p.c[kPi]) * p.c[kColK];
  const float cr = rintf(colf);
  int col = (int)cr % p.columns;
  if (col < 0) col += p.columns;                 // jnp.mod floors
  t.col = col;
  t.col_res = fabsf(colf - cr);
  return t;
}

// The ring bin of a direction: returns ringf, sets *ring.
__device__ __forceinline__ float ring_of(float dsz, float inv_rho,
                                         const Params& p, int* ring) {
  const float el = banded_atan(dsz * inv_rho, p);
  float ringf = (p.c[kHalfV] - el) * p.c[kInvSpacing];
  ringf = fminf(fmaxf(ringf, -p.c[kRingClip]), p.c[kRingClip]);
  *ring = (int)rintf(ringf);
  return ringf;
}

// The vertical acceptance of a voxel (the ring-interpolation band): sets
// *v_res, which the value's weight reads again.
__device__ __forceinline__ bool vertical_ok(float r_vox, float ringf,
                                            int ring, const Params& p,
                                            float* v_res) {
  const float delta_z = p.c[kDzpd] * r_vox * p.c[kInvMr];
  *v_res = r_vox * fabsf(ringf - (float)ring) * p.c[kSpacing];
  return *v_res <= fmaxf(delta_z, p.c[kHalfRes]);
}

// The value, weight and merge of voxel i, whose update condition holds but
// for the new weight being nonzero; its map entries (ev, ew) were loaded
// by the caller.
__device__ __forceinline__ void merge_voxel(int16_t* __restrict__ value,
                                            int16_t* __restrict__ weight,
                                            unsigned i, int ev, int ew,
                                            float dx, float dy, float dz,
                                            float r_vox, float v_res,
                                            float4 b, const Params& p) {
  const float ex = dx - b.x, ey = dy - b.y, ez = dz - b.z;
  float val = sqrtf(ex * ex + ey * ey + ez * ez);
  val = fminf(val, p.c[kTau]);
  if (r_vox > b.w) val = -val;
  const bool interp = v_res > p.c[kHalfRes];
  const float wf = val < p.c[kNegEps]
      ? floorf((p.c[kWres] * (p.c[kTau] + val)) * p.c[kInvTauEps])
      : p.c[kWres];
  const int w = (int)wf;
  // new weight 0: the merge leaves (value, weight) as they are
  if (w == 0) return;
  const int nw = interp ? -w : w;
  const int nv = (int)truncf(val);

  int out_v, out_w;
  if (nw > 0 && ew > 0) {
    out_v = (ev * ew + nv * nw) / (ew + nw);
    out_w = min(p.max_weight, ew + nw);
  } else if (ew <= 0) {
    out_v = nv;
    out_w = nw;
  } else {
    return;                                       // nw < 0 < ew: unchanged
  }
  value[i] = (int16_t)out_v;
  weight[i] = (int16_t)out_w;
}

// _projective_math + _merge_planes for voxel i, whose beam is b and whose
// map entries (ev, ew) the caller loaded ahead of the math.  The voxel's
// acceptance comes first: a voxel that fails it skips the value's math.
// Each expression is the one the sweep evaluates, so the bits are the same.
__device__ __forceinline__ void fuse_voxel(int16_t* __restrict__ value,
                                           int16_t* __restrict__ weight,
                                           unsigned i, int ev, int ew,
                                           float dx, float dy, float dz,
                                           float r_vox, float ringf,
                                           int ring, float col_res,
                                           float4 b, const Params& p) {
  const bool ring_ok = ring >= 0 && ring < p.channels;
  float v_res;
  const bool v_ok = vertical_ok(r_vox, ringf, ring, p, &v_res);
  const float h_res = r_vox * col_res * p.c[kColStep];
  const bool horizontal_ok = h_res <= p.c[kHalfRes];
  if (!(ring_ok && isfinite(b.w) && v_ok && horizontal_ok
        && r_vox <= b.w + p.c[kTau]))
    return;
  merge_voxel(value, weight, i, ev, ew, dx, dy, dz, r_vox, v_res, b, p);
}

// The first index in [lo, hi) at which `pred` holds, or hi; `pred` must be
// false up to some index and true from there on.  A 32-ary search: each
// round every lane tests the end of its 32nd of the interval.  The whole
// warp calls it with the same lo and hi.
template <class Pred>
__device__ __forceinline__ int warp_first(int lo, int hi, int lane,
                                          Pred pred) {
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int q = lo + (lane + 1) * step - 1;
    const unsigned bal = __ballot_sync(kFull, q >= hi || pred(q));
    if (bal == 0u) return hi;
    const int k = __ffs(bal) - 1;
    hi = min(hi, lo + (k + 1) * step - 1);
    lo += k * step;
  }
  return hi;
}

// The same for one lane alone: a binary search.
template <class Pred>
__device__ __forceinline__ int lane_first(int lo, int hi, Pred pred) {
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (pred(m)) {
      hi = m;
    } else {
      lo = m + 1;
    }
  }
  return hi;
}

// 16-byte asynchronous copy from global to shared memory (cp.async), and
// its group commit and wait
__device__ __forceinline__ void copy_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One warp per azimuth column of the beam table: the float4 rows (bx, by,
// bz, range) with scanner-relative endpoints (the f32 subtraction the sweep
// does) and the column's largest finite range (-inf where it has none).
__global__ void prepare_kernel(const float* __restrict__ rng,
                               const float* __restrict__ endpoint,
                               const int* __restrict__ scanner,
                               float4* __restrict__ beams,
                               float* __restrict__ rowmax, int channels,
                               int columns) {
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (col >= columns) return;
  const float sx = (float)scanner[0], sy = (float)scanner[1],
              sz = (float)scanner[2];
  float m = -__int_as_float(0x7f800000);         // -inf
  for (int k = lane; k < channels; k += 32) {
    const int i = col * channels + k;
    const float r = rng[i];
    beams[i] = make_float4(endpoint[3 * i] - sx, endpoint[3 * i + 1] - sy,
                           endpoint[3 * i + 2] - sz, r);
    if (isfinite(r)) m = fmaxf(m, r);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, s));
  if (lane == 0) rowmax[col] = m;
}

// Level sweep (R = I): warp w of CTA (bx, x) takes the tile of kTile
// columns (x, y0 .. y0 + kTile - 1), y0 = (bx * kLevelWarps + w) * kTile.
__global__ void __launch_bounds__(32 * kLevelWarps)
level_kernel(int16_t* __restrict__ value, int16_t* __restrict__ weight,
             const float* __restrict__ cx, const float* __restrict__ cy,
             const float* __restrict__ cz, const float4* __restrict__ beams,
             const float* __restrict__ rowmax, Params p) {
  extern __shared__ float4 rows[];      // kLevelWarps x 2 x channels
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x = blockIdx.y;
  const int y0 = (blockIdx.x * kLevelWarps + warp) * kTile;
  if (y0 >= p.Y) return;                // the whole warp leaves
  const int Z = p.Z;
  const float dx = cx[x];

  // (1) lane l: the terms of column y0 + l (at R = I the sensor-frame
  // direction is d itself) and the largest finite range of its beam row
  const bool has = lane < kTile && y0 + lane < p.Y;
  const float dy = has ? cy[y0 + lane] : 0.0f;
  const ColumnTerms t = column_terms(dx, dy, p);
  const float lim = rowmax[t.col] + p.c[kTau];
  const float colstep = p.c[kColStep], half_res = p.c[kHalfRes];

  // (2) global z rank j lies at array index (j + rot) mod Z; ranks below
  // mid have dz < 0 (|dz| falls with j), from mid on dz >= 0
  const float cz0 = cz[0];
  int rot = warp_first(0, Z, lane, [=](int a) { return cz[a] < cz0; });
  if (rot == Z) rot = 0;
  auto dz_at = [=](int j) {
    const int a = j + rot;
    return cz[a < Z ? a : a - Z];
  };
  const int mid = warp_first(0, Z, lane,
                             [=](int j) { return dz_at(j) >= 0.0f; });

  // (3) lane l: the run [lo, hi) of global z where keep(dz) holds (empty
  // where the row has no finite range: lim is -inf)
  auto keep = [=](int j) {
    const float dz = dz_at(j);
    const float r_vox = sqrtf(t.rho2 + dz * dz);
    return r_vox <= lim && r_vox * t.col_res * colstep <= half_res;
  };
  int lo = mid, hi = mid;
  if (has) {
    lo = lane_first(0, mid, keep);
    hi = lane_first(mid, Z, [=](int j) { return !keep(j); });
  }
  unsigned live = __ballot_sync(kFull, lo < hi);
  if (live == 0u) return;

  // (4) the live columns in turn, the lanes walking z; each column's beam
  // row is copied to shared memory while the column before it is swept
  const int channels = p.channels;
  auto buf = [=](int b) { return rows + (2 * warp + b) * channels; };
  auto stage = [=](int b, int c) {
    float4* dst = buf(b);
    const float4* src = beams + __shfl_sync(kFull, t.col, c) * channels;
    for (int k = lane; k < channels; k += 32) copy_async16(dst + k, src + k);
    copy_async_commit();
  };
  int c = __ffs(live) - 1;
  live &= live - 1;
  stage(0, c);
  for (int b = 0;; b ^= 1) {
    const int next = live ? __ffs(live) - 1 : -1;
    if (next >= 0) {
      live &= live - 1;
      stage(b ^ 1, next);
      copy_async_wait<1>();
    } else {
      copy_async_wait<0>();
    }
    __syncwarp();
    const float4* row = buf(b);
    const float rho2 = __shfl_sync(kFull, t.rho2, c);
    const float inv_rho = __shfl_sync(kFull, t.inv_rho, c);
    const float col_res = __shfl_sync(kFull, t.col_res, c);
    const float dyc = __shfl_sync(kFull, dy, c);
    const int clo = __shfl_sync(kFull, lo, c);
    const int chi = __shfl_sync(kFull, hi, c);
    const unsigned base = ((unsigned)x * p.Y + y0 + c) * Z;
    for (int j = clo + lane; j < chi; j += 32) {
      int a = j + rot;
      if (a >= Z) a -= Z;
      const unsigned i = base + a;
      const int ev = value[i], ew = weight[i];   // in flight during the math
      const float dz = cz[a];
      const float r_vox = sqrtf(rho2 + dz * dz);
      int ring;
      const float ringf = ring_of(dz, inv_rho, p, &ring);
      const int ring_c = min(max(ring, 0), channels - 1);
      fuse_voxel(value, weight, i, ev, ew, dx, dyc, dz, r_vox, ringf, ring,
                 col_res, row[ring_c], p);
    }
    __syncwarp();                       // row is restaged two turns on
    if (next < 0) break;
    c = next;
  }
}

// The general sweep's per-call terms, one block: zterm[a] = (z, z R20,
// z R21, z R22) of array index a, and zterm[Z].x = fl(M + tau), M the
// largest of the rows' largest finite ranges (-inf without one).
__global__ void __launch_bounds__(kSetupThreads)
general_setup_kernel(const float* __restrict__ cz,
                     const float* __restrict__ rowmax,
                     float4* __restrict__ zterm, Params p) {
  __shared__ float part[kSetupThreads / 32];
  const float* R = p.c + kR;
  for (int a = threadIdx.x; a < p.Z; a += kSetupThreads) {
    const float dz = cz[a];
    zterm[a] = make_float4(dz, dz * R[6], dz * R[7], dz * R[8]);
  }
  float m = -__int_as_float(0x7f800000);         // -inf
  for (int k = threadIdx.x; k < p.columns; k += kSetupThreads)
    m = fmaxf(m, rowmax[k]);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, s));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kSetupThreads / 32; ++w) m = fmaxf(m, part[w]);
    zterm[p.Z] = make_float4(m + p.c[kTau], 0.0f, 0.0f, 0.0f);
  }
}

// General sweep (any R): one warp per (x, y) column, the lanes walking z in
// array order; a voxel leaves at its first failed acceptance test (the
// note at the top).
__global__ void __launch_bounds__(32 * kGeneralWarps)
general_kernel(int16_t* __restrict__ value, int16_t* __restrict__ weight,
               const float* __restrict__ cx, const float* __restrict__ cy,
               const float4* __restrict__ zterm,
               const float4* __restrict__ beams, Params p) {
  const int lane = threadIdx.x & 31;
  const int x = blockIdx.y;
  const int y = blockIdx.x * kGeneralWarps + (threadIdx.x >> 5);
  if (y >= p.Y) return;
  const unsigned base = ((unsigned)x * p.Y + y) * p.Z;
  const float dx = cx[x], dy = cy[y];
  const float* R = p.c + kR;
  // the column's halves of d_s = R^T d, k = x, y, z: x R0k + y R1k
  const float sx = dx * R[0] + dy * R[3];
  const float sy = dx * R[1] + dy * R[4];
  const float sz = dx * R[2] + dy * R[5];
  const float lim = zterm[p.Z].x;
  const float half_res = p.c[kHalfRes];
  for (int a = lane; a < p.Z; a += 32) {
    const float4 zt = zterm[a];
    const float dsx = sx + zt.y, dsy = sy + zt.z, dsz = sz + zt.w;
    const float rho2 = dsx * dsx + dsy * dsy;
    const float r_vox = sqrtf(rho2 + dsz * dsz);
    if (!(r_vox <= lim)) continue;                              // (1)
    const float inv_rho = __frcp_rn(fmaxf(sqrtf(rho2), p.c[kEps20]));
    int ring;
    const float ringf = ring_of(dsz, inv_rho, p, &ring);
    if (ring < 0 || ring >= p.channels) continue;               // (2)
    float v_res;
    if (!vertical_ok(r_vox, ringf, ring, p, &v_res)) continue;  // (3)
    const float colf = (atan2_poly(dsy, dsx, p) + p.c[kPi]) * p.c[kColK];
    const float cr = rintf(colf);
    const float col_res = fabsf(colf - cr);
    if (!(r_vox * col_res * p.c[kColStep] <= half_res)) continue;  // (4)
    int col = (int)cr;                 // in [0, columns]: the note's bound
    if (col >= p.columns) col -= p.columns;
    const unsigned i = base + a;
    const int ev = value[i], ew = weight[i];
    const float4 b = beams[col * p.channels + ring];
    if (!(isfinite(b.w) && r_vox <= b.w + p.c[kTau])) continue;  // (5)
    merge_voxel(value, weight, i, ev, ew, dx, dy, zt.x, r_vox, v_res, b, p);
  }
}

size_t level_smem(int channels) {
  return sizeof(float4) * 2 * kLevelWarps * channels;
}

// the shared memory a block of the current device can opt into, in *bytes
cudaError_t optin_smem(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(bytes,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

}  // namespace

// Kernel K1: prepare the beam table (float4 rows and row maxima into the
// caller's `beams` and `rowmax` scratch), then sweep and merge in place.
// The general sweep (level == 0) also fills the caller's `zterm` scratch,
// Z + 1 float4; the level sweep ignores it.
extern "C" int ws_fusion_sweep_merge(void* value, void* weight,
                                     const void* cx, const void* cy,
                                     const void* cz, const void* rng,
                                     const void* endpoint,
                                     const void* scanner, void* beams,
                                     void* rowmax, void* zterm,
                                     const float* consts, int X, int Y,
                                     int Z, int channels, int columns,
                                     int max_weight, int level,
                                     void* stream) {
  Params p;
  for (int k = 0; k < kNumConsts; ++k) p.c[k] = consts[k];
  p.X = X;
  p.Y = Y;
  p.Z = Z;
  p.channels = channels;
  p.columns = columns;
  p.max_weight = max_weight;
  cudaStream_t s = (cudaStream_t)stream;
  auto* v = (int16_t*)value;
  auto* w = (int16_t*)weight;
  auto* fx = (const float*)cx;
  auto* fy = (const float*)cy;
  auto* fz = (const float*)cz;
  auto* bm = (float4*)beams;
  auto* rm = (float*)rowmax;
  prepare_kernel<<<(columns + 7) / 8, 256, 0, s>>>(
      (const float*)rng, (const float*)endpoint, (const int*)scanner, bm, rm,
      channels, columns);
  if (level) {
    const int tiles = (Y + kTile - 1) / kTile;
    const dim3 grid((tiles + kLevelWarps - 1) / kLevelWarps, X);
    const size_t smem = level_smem(channels);
    if (smem > 48 * 1024) {          // beyond the default: opt in
      const cudaError_t err = cudaFuncSetAttribute(
          level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    level_kernel<<<grid, 32 * kLevelWarps, smem, s>>>(v, w, fx, fy, fz, bm,
                                                      rm, p);
  } else {
    auto* zt = (float4*)zterm;
    general_setup_kernel<<<1, kSetupThreads, 0, s>>>(fz, rm, zt, p);
    const dim3 grid((Y + kGeneralWarps - 1) / kGeneralWarps, X);
    general_kernel<<<grid, 32 * kGeneralWarps, 0, s>>>(v, w, fx, fy, zt, bm,
                                                       p);
  }
  return (int)cudaGetLastError();
}

extern "C" int ws_fusion_num_consts() { return kNumConsts; }

// The largest channel count whose level-sweep rows fit the shared memory a
// block of the current device can opt into (1,816 at the H100's 232,448
// bytes); a negative cudaError_t on failure.
extern "C" int ws_fusion_max_channels() {
  int bytes = 0;
  const cudaError_t err = optin_smem(&bytes);
  if (err != cudaSuccess) return -(int)err;
  return (int)(bytes / level_smem(1));
}
