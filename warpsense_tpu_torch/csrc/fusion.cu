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
// The design's own traffic is larger than the function's: a sweep loads
// the value and weight of every voxel it visits ahead of that voxel's
// tests (which hides the load's latency behind the math), 4 B each.  The
// level sweep visits the ~58.2M voxels inside the cull's runs at that
// window, ~233 MB or ~70 us at 3.35 TB/s, above the operation bound; the
// general sweep visits all 91.8M, ~367 MB or ~110 us.  chip_smoke.py
// reports this floor beside the bound (sweep_floor_ms).
//
// A call is two launches: prepare_kernel turns the beam table into float4
// rows (bx, by, bz, range) and each azimuth column's largest finite range;
// then level_kernel or general_kernel sweeps and merges.
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
// Design (general_kernel, any R): one warp per (x, y) column, the lanes
// walking z in array order; every voxel rotates its direction and gathers
// its beam through L1/L2.
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
  const float delta_z = p.c[kDzpd] * r_vox * p.c[kInvMr];
  const float v_res = r_vox * fabsf(ringf - (float)ring) * p.c[kSpacing];
  const bool vertical_ok = v_res <= fmaxf(delta_z, p.c[kHalfRes]);
  const float h_res = r_vox * col_res * p.c[kColStep];
  const bool horizontal_ok = h_res <= p.c[kHalfRes];
  if (!(ring_ok && isfinite(b.w) && vertical_ok && horizontal_ok
        && r_vox <= b.w + p.c[kTau]))
    return;
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

// General sweep (any R): one warp per (x, y) column, the lanes walking z in
// array order; every voxel rotates its direction and gathers its beam.
__global__ void __launch_bounds__(32 * kGeneralWarps)
general_kernel(int16_t* __restrict__ value, int16_t* __restrict__ weight,
               const float* __restrict__ cx, const float* __restrict__ cy,
               const float* __restrict__ cz,
               const float4* __restrict__ beams, Params p) {
  const int lane = threadIdx.x & 31;
  const int x = blockIdx.y;
  const int y = blockIdx.x * kGeneralWarps + (threadIdx.x >> 5);
  if (y >= p.Y) return;
  const unsigned base = ((unsigned)x * p.Y + y) * p.Z;
  const float dx = cx[x], dy = cy[y];
  const float* R = p.c + kR;
  for (int a = lane; a < p.Z; a += 32) {
    const unsigned i = base + a;
    const int ev = value[i], ew = weight[i];     // in flight during the math
    const float dz = cz[a];
    // sensor-frame direction d_s = R^T d
    const float dsx = dx * R[0] + dy * R[3] + dz * R[6];
    const float dsy = dx * R[1] + dy * R[4] + dz * R[7];
    const float dsz = dx * R[2] + dy * R[5] + dz * R[8];
    const ColumnTerms t = column_terms(dsx, dsy, p);
    const float r_vox = sqrtf(t.rho2 + dsz * dsz);
    int ring;
    const float ringf = ring_of(dsz, t.inv_rho, p, &ring);
    const int ring_c = min(max(ring, 0), p.channels - 1);
    fuse_voxel(value, weight, i, ev, ew, dx, dy, dz, r_vox, ringf, ring,
               t.col_res, beams[t.col * p.channels + ring_c], p);
  }
}

size_t level_smem(int channels) {
  return sizeof(float4) * 2 * kLevelWarps * channels;
}

}  // namespace

// Kernel K1: prepare the beam table (float4 rows and row maxima into the
// caller's `beams` and `rowmax` scratch), then sweep and merge in place.
extern "C" int ws_fusion_sweep_merge(void* value, void* weight,
                                     const void* cx, const void* cy,
                                     const void* cz, const void* rng,
                                     const void* endpoint,
                                     const void* scanner, void* beams,
                                     void* rowmax, const float* consts,
                                     int X, int Y, int Z, int channels,
                                     int columns, int max_weight, int level,
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
    level_kernel<<<grid, 32 * kLevelWarps, level_smem(channels), s>>>(
        v, w, fx, fy, fz, bm, rm, p);
  } else {
    const dim3 grid((Y + kGeneralWarps - 1) / kGeneralWarps, X);
    general_kernel<<<grid, 32 * kGeneralWarps, 0, s>>>(v, w, fx, fy, fz, bm,
                                                       p);
  }
  return (int)cudaGetLastError();
}

extern "C" int ws_fusion_num_consts() { return kNumConsts; }

// the largest channel count whose level-sweep rows fit the 48 KB of shared
// memory a launch gets without opting in
extern "C" int ws_fusion_max_channels() {
  return (int)((48 * 1024) / level_smem(1));
}
