// Registration kernels K3 (one iteration's statistics) and K4 (one step of
// the Gauss-Newton / Levenberg-Marquardt loop), with a plain C interface
// (ctypes).  Built by kernels/_build.py: sm_90a, -fmad=false, no fast math.
//
// They take the place of the JAX package's device loop
// (warpsense_tpu/ops/registration.py: _gn_loop :212 and _lm_loop :572, a
// lax.while_loop over jacobian_stats_fields :106 / make_packed_stats :454 /
// make_packed_stats_split :512; XLA code, no TPU kernel).  The loop's carry
// lives in one float32 state buffer on the card (layout: S_* below, the
// same as ops/registration.py's), so the host enqueues K3 + K4 pairs and
// reads the state only once a chunk.  A launch that finds the loop finished
// (or at max_iterations) does nothing: more iterations may be enqueued than
// run, as in the while loop.
//
// K3 (stats_kernel): one pass over the points.  Per point: the int32
// fixed-point transform with its wrap, the floor cell, the in-bounds test,
// the ring coordinates, one gather and decode (parity: three planes; fast:
// one packed plane or two exact planes), the interpolated residual, J with
// the cross product as core.geometry.cross writes it, and its 29 sums (21 of
// H's upper triangle, 6 of g, e, c).  The mode (coarse: every 4th point;
// gather: write the per-point cache and evaluate; cached: evaluate from the
// cache; full) is read from the state on the device, the same decision as
// JAX's reuse / coarse_now.  Sums: per thread in point order, then a warp
// shuffle tree and the 8 warps in order, one row of partials per block; the
// grid is fixed by the point count, so the same inputs give the same bits.
// Bound: latency (one gather per point, ~3 MB at 131,072 points is ~1 us at
// 3.35 TB/s), so the design keeps it to one launch and no atomics.
//
// K4 (step_kernel): one block.  256 threads sum the partials' 29 columns in
// 8 interleaved lanes (rows l, l+8, ...), lane sums in order; then one
// thread forms the damped system, solves it by LU with partial pivoting in
// float32 (a zero pivot gives NaN), applies xi_to_transform and the pose
// product, and runs the loop's tests (4-error window, LM's tiny / !ok, the
// freeze), in the same float32 operations, in the same order, as
// ops/registration.reg_step_plain.  Bound: launch latency.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStepThreads = 256;
constexpr int kLanes = kStepThreads / 32;
constexpr int kPartials = 32;   // one row a block: 21 H, 6 g, e, c, 3 zeros
constexpr int kSums = 29;
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

struct StatsArgs {
  const float* state;
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
  float* partials;
  int n, X, Y, Z, res, vs, gs, interp, normalize, coarse, split, max_it;
};

struct StepArgs {
  int lm, recenter, coarse, split, max_it;
  float eps, itw, freeze2;
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

// the point's window cell: floor division, in_bounds(buffer 1), ring coords
__device__ __forceinline__ bool cell(const StatsArgs& a, const int pts[3],
                                     int buf[3], long long* flat) {
  const int sz[3] = {a.X, a.Y, a.Z};
  bool ok = true;
  int r[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    buf[k] = floor_div(pts[k], a.res);
    const int d = buf[k] - a.pos[k];
    ok = ok && d >= -(sz[k] / 2) + 1 && d <= (sz[k] - 1) / 2 - 1;
    r[k] = py_mod(buf[k] - a.pos[k] + a.offset[k], sz[k]);
  }
  *flat = ((long long)r[0] * a.Y + r[1]) * a.Z + r[2];
  return ok;
}

// gather and decode one cell: (valid, value, gradient) as integers
template <int L>
__device__ __forceinline__ bool gather(const StatsArgs& a, long long flat,
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
__device__ __forceinline__ void fast_terms(const StatsArgs& a,
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

template <int L, int M>
__device__ void point_stats(const StatsArgs& a, const float* T,
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
  bool ok = a.mask[idx] != 0 && cell(a, pts, buf, &flat);
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
      for (int k = 0; k < 3; ++k) gr[k] = gr[k] / (float)a.res;
    }
    float c[3];
    cross3(p, gr, c);
    const float J[6] = {c[0] * kSC, c[1] * kSC, c[2] * kSC,
                        gr[0] * kSG, gr[1] * kSG, gr[2] * kSG};
    accumulate(acc, J, (float)v);
    return;
  }
  const float gf[3] = {(float)g[0] / (float)a.res, (float)g[1] / (float)a.res,
                       (float)g[2] / (float)a.res};
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

template <int L, int M>
__device__ void block_points(const StatsArgs& a, const float* T,
                             const int m[12], float acc[kSums]) {
  const int stride = M == kCoarse ? 4 : 1;
  const int count = (a.n + stride - 1) / stride;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < count;
       j += gridDim.x * blockDim.x)
    point_stats<L, M>(a, T, m, j * stride, acc);
}

template <int L>
__global__ void __launch_bounds__(kThreads)
stats_kernel(StatsArgs a) {
  const float* s = a.state;
  const int i = (int)s[S_I];
  if (s[S_FIN] != 0.0f || i >= a.max_it) return;
  int mode = kFull;
  if (L != kParity) {
    if (a.coarse > 0 && i < a.coarse)
      mode = kCoarse;
    else if (a.split)
      mode = s[S_FROZEN] != 0.0f ? kCached : kGather;
  }
  const float* T = s + S_TRIAL;
  int m[12];
  int_mat(T, m);
  float acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
  switch (mode) {
    case kCoarse: block_points<L, kCoarse>(a, T, m, acc); break;
    case kGather: block_points<L, kGather>(a, T, m, acc); break;
    case kCached: block_points<L, kCached>(a, T, m, acc); break;
    default: block_points<L, kFull>(a, T, m, acc); break;
  }
  // warp tree, then the warps in order: a fixed order of additions
  __shared__ float red[kThreads / 32][kPartials];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    float x = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) red[warp][k] = x;
  }
  __syncthreads();
  if (threadIdx.x < kPartials) {
    float t = 0.0f;
    if (threadIdx.x < kSums) {
      for (int w = 0; w < kThreads / 32; ++w) t += red[w][threadIdx.x];
    }
    a.partials[blockIdx.x * kPartials + threadIdx.x] = t;
  }
}

// ------------------------------------------------------------------ K4

// 6x6 solve, LU with partial pivoting (the first largest |pivot|), in the
// order of ops/registration.solve6; a zero pivot makes every y NaN
__device__ void solve6(float A[36], float b[6], float y[6]) {
  bool singular = false;
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float best = fabsf(A[k * 6 + k]);
    for (int r = k + 1; r < 6; ++r) {
      const float v = fabsf(A[r * 6 + k]);
      if (v > best) {
        best = v;
        p = r;
      }
    }
    if (p != k) {
      for (int j = 0; j < 6; ++j) {
        const float t = A[k * 6 + j];
        A[k * 6 + j] = A[p * 6 + j];
        A[p * 6 + j] = t;
      }
      const float t = b[k];
      b[k] = b[p];
      b[p] = t;
    }
    const float piv = A[k * 6 + k];
    if (piv == 0.0f) singular = true;
    for (int r = k + 1; r < 6; ++r) {
      const float f = A[r * 6 + k] / piv;
      for (int j = k + 1; j < 6; ++j) A[r * 6 + j] = A[r * 6 + j] - f * A[k * 6 + j];
      b[r] = b[r] - f * b[k];
    }
  }
  for (int r = 5; r >= 0; --r) {
    float s = b[r];
    for (int j = r + 1; j < 6; ++j) s = s - A[r * 6 + j] * y[j];
    y[r] = s / A[r * 6 + r];
  }
  if (singular) {
    for (int k = 0; k < 6; ++k) y[k] = __int_as_float(0x7fc00000);
  }
}

// core.geometry.xi_to_transform (Rodrigues about ``c``), then T @ P into
// ``out`` (row-major 4x4); ops/registration.xi_to_transform_plain's order
__device__ void apply_xi(const float xi[6], const float c[3], const float* P,
                         float* out) {
  const float th2 = (xi[0] * xi[0] + xi[1] * xi[1]) + xi[2] * xi[2];
  const float theta = sqrtf(th2);
  const bool small = theta < 1e-12f;
  const float safe = small ? 1.0f : theta;
  const float u[3] = {xi[0] / safe, xi[1] / safe, xi[2] / safe};
  const float L[9] = {0.0f, -u[2], u[1], u[2], 0.0f, -u[0], -u[1], u[0], 0.0f};
  const float sn = (float)sin((double)theta);
  const float c1 = 1.0f - (float)cos((double)theta);
  float R[9];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      const float ll = (L[i * 3] * L[j] + L[i * 3 + 1] * L[3 + j])
          + L[i * 3 + 2] * L[6 + j];
      const float eye = i == j ? 1.0f : 0.0f;
      R[i * 3 + j] = small ? eye : (eye + sn * L[i * 3 + j]) + c1 * ll;
    }
  }
  float T[16];
  for (int i = 0; i < 3; ++i) {
    const float rc = (R[i * 3] * -c[0] + R[i * 3 + 1] * -c[1])
        + R[i * 3 + 2] * -c[2];
    for (int j = 0; j < 3; ++j) T[i * 4 + j] = R[i * 3 + j];
    T[i * 4 + 3] = (rc + c[i]) + xi[3 + i];
  }
  T[12] = T[13] = T[14] = 0.0f;
  T[15] = 1.0f;
  float O[16];
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 4; ++j) {
      O[i * 4 + j] = ((T[i * 4] * P[j] + T[i * 4 + 1] * P[4 + j])
                      + T[i * 4 + 2] * P[8 + j]) + T[i * 4 + 3] * P[12 + j];
    }
  }
  for (int k = 0; k < 16; ++k) out[k] = O[k];
}

__global__ void __launch_bounds__(kStepThreads)
step_kernel(float* s, const float* partials, int nblocks, StepArgs a) {
  if (s[S_FIN] != 0.0f || (int)s[S_I] >= a.max_it) return;
  __shared__ float lanes[kLanes][kPartials];
  const int col = threadIdx.x & 31, lane = threadIdx.x >> 5;
  float t = 0.0f;
  for (int r = lane; r < nblocks; r += kLanes) t += partials[r * kPartials + col];
  lanes[lane][col] = t;
  __syncthreads();
  if (threadIdx.x != 0) return;
  float sum[kSums];
  for (int k = 0; k < kSums; ++k) {
    float x = 0.0f;
    for (int l = 0; l < kLanes; ++l) x += lanes[l][k];
    sum[k] = x;
  }
  float H[36], g[6];
  int q = 0;
  for (int i = 0; i < 6; ++i) {
    for (int j = i; j < 6; ++j) {
      H[i * 6 + j] = sum[q];
      H[j * 6 + i] = sum[q];
      ++q;
    }
  }
  for (int i = 0; i < 6; ++i) g[i] = sum[21 + i];
  const float e = sum[27], c = sum[28];
  const int i = (int)s[S_I];
  float* prev = s + S_PREV;
  float A[36], b[6], y[6], xi[6];

  if (!a.lm) {
    // _gn_loop: (D H D + alpha c D^2) y = -D g, xi = D y
    const float D[6] = {kSC, kSC, kSC, kSG, kSG, kSG};
    const bool empty = c <= 0.0f;
    const float ac = s[S_ALPHA] * c;
    for (int k = 0; k < 36; ++k) A[k] = empty ? (k % 7 == 0 ? 1.0f : 0.0f) : H[k];
    if (!empty) {
      for (int k = 0; k < 6; ++k) A[k * 7] = H[k * 7] + ac * (D[k] * D[k]);
    }
    for (int k = 0; k < 6; ++k) b[k] = -g[k];
    solve6(A, b, y);
    bool ok = !empty;
    for (int k = 0; k < 6; ++k) ok = ok && isfinite(y[k]);
    for (int k = 0; k < 6; ++k) xi[k] = ok ? D[k] * y[k] : 0.0f;
    float* T = s + S_TRIAL;
    const float ctr[3] = {
        a.recenter ? truncf(T[3]) : s[S_CENTER],
        a.recenter ? truncf(T[7]) : s[S_CENTER + 1],
        a.recenter ? truncf(T[11]) : s[S_CENTER + 2]};
    if (ok) apply_xi(xi, ctr, T, T);
    const float err = e / fmaxf(c, 1.0f);
    const bool fin = (ok && fabsf(err - prev[2]) < a.eps
                      && fabsf(err - prev[0]) < a.eps) || empty;
    prev[0] = prev[1];
    prev[1] = prev[2];
    prev[2] = prev[3];
    prev[3] = err;
    s[S_ERR] = err;
    s[S_OK] = ok ? 1.0f : 0.0f;
    s[S_FIN] = fin ? 1.0f : 0.0f;
    s[S_ALPHA] = s[S_ALPHA] + a.itw;
    s[S_I] = (float)(i + 1);
    return;
  }

  // _lm_loop: delayed accept/reject, Marquardt damping
  const float D[6] = {kSCP, kSCP, kSCP, 1.0f, 1.0f, 1.0f};
  const float acc_err = s[S_ERR];
  const float err = c > 0.0f ? e / fmaxf(c, 1.0f) : INFINITY;
  bool improved = err <= acc_err;
  float err2 = fminf(err, acc_err);
  if (a.coarse > 0 && i == a.coarse) {
    improved = true;     // the coarse-to-fine hand-off re-baselines
    err2 = err;
  }
  float* acc = s + S_ACC;
  float* accH = s + S_ACCH;
  float* accg = s + S_ACCG;
  if (improved) {
    for (int k = 0; k < 16; ++k) acc[k] = s[S_TRIAL + k];
    for (int k = 0; k < 36; ++k) accH[k] = H[k];
    for (int k = 0; k < 6; ++k) accg[k] = g[k];
  }
  const float alpha = fminf(fmaxf(improved ? s[S_ALPHA] / 3.0f
                                           : s[S_ALPHA] * 4.0f, 1e-5f), 1e5f);
  for (int k = 0; k < 36; ++k) A[k] = accH[k];
  for (int k = 0; k < 6; ++k)
    A[k * 7] = accH[k * 7] + alpha * (accH[k * 7] + 1e-12f);
  for (int k = 0; k < 6; ++k) b[k] = -accg[k];
  solve6(A, b, y);
  bool ok = isfinite(err2);
  for (int k = 0; k < 6; ++k) ok = ok && isfinite(y[k]);
  for (int k = 0; k < 6; ++k) xi[k] = ok ? D[k] * y[k] : 0.0f;
  const float ctr[3] = {truncf(acc[3]), truncf(acc[7]), truncf(acc[11])};
  apply_xi(xi, ctr, acc, s + S_TRIAL);
  const float rot2 = (xi[0] * xi[0] + xi[1] * xi[1]) + xi[2] * xi[2];
  const float tr2 = (xi[3] * xi[3] + xi[4] * xi[4]) + xi[5] * xi[5];
  const bool tiny = improved && rot2 < 1e-7f && tr2 < 0.25f;
  const bool window = fabsf(err2 - prev[2]) < a.eps
      && fabsf(err2 - prev[0]) < a.eps;
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

// an empty kernel: the launch floor K3 and K4 are measured against
__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// iparams: n, X, Y, Z, res, layout, vs, gs, interp, normalize, coarse,
// split, max_it (host memory, read at the call)
int ws_reg_stats(const float* state, const int* points,
                 const unsigned char* mask, const int* plane0,
                 const int* plane1, const int* plane2, const int* pos,
                 const int* offset, unsigned char* c_valid, float* c_v,
                 float* c_g, int* c_cc, float* partials, const int* iparams,
                 int nblocks, void* stream) {
  StatsArgs a{state, points, mask, plane0, plane1, plane2, pos, offset,
              c_valid, c_v, c_g, c_cc, partials,
              iparams[0], iparams[1], iparams[2], iparams[3], iparams[4],
              iparams[6], iparams[7], iparams[8], iparams[9], iparams[10],
              iparams[11], iparams[12]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (iparams[5]) {
    case kParity: stats_kernel<kParity><<<nblocks, kThreads, 0, st>>>(a); break;
    case kPacked: stats_kernel<kPacked><<<nblocks, kThreads, 0, st>>>(a); break;
    case kExact: stats_kernel<kExact><<<nblocks, kThreads, 0, st>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// iparams: lm, recenter, coarse, split, max_it; fparams: eps, itw, freeze2
int ws_reg_step(float* state, const float* partials, int nblocks,
                const int* iparams, const float* fparams, void* stream) {
  StepArgs a{iparams[0], iparams[1], iparams[2], iparams[3], iparams[4],
             fparams[0], fparams[1], fparams[2]};
  step_kernel<<<1, kStepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      state, partials, nblocks, a);
  return (int)cudaGetLastError();
}

int ws_reg_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
