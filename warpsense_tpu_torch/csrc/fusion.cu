// Kernel K1: projective TSDF sweep + weighted-average merge, in place.
//
// Replaces the TPU kernels warpsense_tpu/kernels/tsdf_pallas.py
// `_fusion_kernel_level16` (level grid, R = I; instantiation LEVEL=true)
// and `_fusion_kernel` (attitude-binned grid; LEVEL=false).  It computes
// exactly what the JAX twin computes (ops/tsdf_projective.py
// projective_sweep_coords + _projective_math + _merge_planes), including
// under tilt: the TPU kernel's W=0 beam window (fuse only where the
// voxel's column equals its (x, y) column's central column) is a gather
// workaround and is NOT reproduced.  Nor are the TPU layout devices: banked
// lane gathers, the transposed table, lane padding, the NaN hole sentinel
// and the f32 stand-in for integer division (plain C `/` equals it below
// check_fusion_config's bound).
//
// What bounds it on an H100: one pass over the window.  A voxel that the
// scan does not touch returns before loading the map, so the floor is the
// int16 value+weight read and write of the touched voxels (at most 8 B per
// voxel: 734 MB for the 625 x 625 x 235 window, ~0.22 ms at 3.35 TB/s) plus
// ~150 float32 operations per voxel.  The beam table (channels x columns
// float4 = 2 MB at 128 x 1024) is read through L2.  Design: one thread per
// voxel, z fastest, so neighbouring threads touch neighbouring int16s.
//
// Bit parity with the JAX sweep rests on: -fmad=false (no contraction), no
// fast math (IEEE sqrtf and `/`), rintf for jnp.round (half to even), every
// float constant computed on the host in double and rounded to float
// exactly as JAX rounds a Python float, no double literal in device code,
// each expression evaluated in the JAX order, and floor mod for jnp.mod.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <bool LEVEL>
__global__ void fusion_kernel(int16_t* __restrict__ value,
                              int16_t* __restrict__ weight,
                              const float* __restrict__ cx,
                              const float* __restrict__ cy,
                              const float* __restrict__ cz,
                              const float4* __restrict__ beams, Params p) {
  const unsigned n = (unsigned)p.X * p.Y * p.Z;
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned z = i % p.Z;
  const unsigned xy = i / p.Z;
  const unsigned y = xy % p.Y;
  const unsigned x = xy / p.Y;
  const float dx = cx[x], dy = cy[y], dz = cz[z];

  // sensor-frame direction d_s = R^T d; at R = I it equals d bit for bit
  float dsx, dsy, dsz;
  if (LEVEL) {
    dsx = dx;
    dsy = dy;
    dsz = dz;
  } else {
    const float* R = p.c + kR;
    dsx = dx * R[0] + dy * R[3] + dz * R[6];
    dsy = dx * R[1] + dy * R[4] + dz * R[7];
    dsz = dx * R[2] + dy * R[5] + dz * R[8];
  }
  const float rho2 = dsx * dsx + dsy * dsy;
  const float r_vox = sqrtf(rho2 + dsz * dsz);

  const float az = atan2_poly(dsy, dsx, p);
  const float inv_rho = p.c[kOne] / fmaxf(sqrtf(rho2), p.c[kEps20]);
  const float el = banded_atan(dsz * inv_rho, p);
  float ringf = (p.c[kHalfV] - el) * p.c[kInvSpacing];
  ringf = fminf(fmaxf(ringf, -p.c[kRingClip]), p.c[kRingClip]);
  const float rr = rintf(ringf);
  const int ring = (int)rr;
  const float colf = (az + p.c[kPi]) * p.c[kColK];
  const float cr = rintf(colf);
  int col = (int)cr % p.columns;
  if (col < 0) col += p.columns;                 // jnp.mod floors
  const bool ring_ok = ring >= 0 && ring < p.channels;
  const int ring_c = min(max(ring, 0), p.channels - 1);
  const float4 b = beams[col * p.channels + ring_c];  // (bx, by, bz, range)

  // _projective_math
  const float ex = dx - b.x, ey = dy - b.y, ez = dz - b.z;
  float val = sqrtf(ex * ex + ey * ey + ez * ez);
  val = fminf(val, p.c[kTau]);
  if (r_vox > b.w) val = -val;
  const float delta_z = p.c[kDzpd] * r_vox * p.c[kInvMr];
  const float v_res = r_vox * fabsf(ringf - (float)ring) * p.c[kSpacing];
  const bool vertical_ok = v_res <= fmaxf(delta_z, p.c[kHalfRes]);
  const float col_res = fabsf(colf - cr);
  const float h_res = r_vox * col_res * p.c[kColStep];
  const bool horizontal_ok = h_res <= p.c[kHalfRes];
  const bool interp = v_res > p.c[kHalfRes];
  const float wf = val < p.c[kNegEps]
      ? floorf((p.c[kWres] * (p.c[kTau] + val)) * p.c[kInvTauEps])
      : p.c[kWres];
  const int w = (int)wf;
  const bool ok = ring_ok && isfinite(b.w) && vertical_ok && horizontal_ok
      && (r_vox <= b.w + p.c[kTau]) && (w != 0);
  // new weight 0: the merge leaves (value, weight) as they are
  if (!ok) return;
  const int nw = interp ? -w : w;
  const int nv = (int)truncf(val);

  // _merge_planes
  const int ev = value[i], ew = weight[i];
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

}  // namespace

extern "C" int ws_fusion_sweep_merge(void* value, void* weight,
                                     const void* cx, const void* cy,
                                     const void* cz, const void* beams,
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
  const unsigned n = (unsigned)X * Y * Z;
  const int threads = 256;
  const unsigned blocks = (n + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  auto* v = (int16_t*)value;
  auto* w = (int16_t*)weight;
  auto* bx = (const float*)cx;
  auto* by = (const float*)cy;
  auto* bz = (const float*)cz;
  auto* bm = (const float4*)beams;
  if (level)
    fusion_kernel<true><<<blocks, threads, 0, s>>>(v, w, bx, by, bz, bm, p);
  else
    fusion_kernel<false><<<blocks, threads, 0, s>>>(v, w, bx, by, bz, bm, p);
  return (int)cudaGetLastError();
}

extern "C" int ws_fusion_num_consts() { return kNumConsts; }
