// Kernel K2: packed registration fields (7-point stencil with ring wrap).
//
// Replaces the TPU kernel warpsense_tpu/kernels/fields_pallas.py
// `_rolling_kernel` (through `_rolling_call`), in both of its modes:
//   * packed (EXACT=false): one int32 plane v:8|gx:8|gy:8|gz:8 — value and
//     gradients quantized with a round-to-nearest shift, +128, clipped to
//     [1, 255], value code 0 where the weight is 0;
//   * exact (EXACT=true): two int32 planes v:16|gx:16 and gy:16|gz:16,
//     value -32768 where the weight is 0.
// Per axis the gradient is the C-truncated (v[+1] - v[-1]) / 2 where both
// neighbours carry weight, else 0; neighbours wrap around the window like
// jnp.roll (ops/registration.py precompute_fields_packed{,2}).
//
// What bounds it on an H100: memory.  The window's int16 value and weight
// planes are read once from device memory (367 MB at 625 x 625 x 235; the
// six neighbour reads per plane hit L1/L2) and one int32 plane is written
// (367 MB; two in exact mode), ~0.22 ms at 3.35 TB/s in packed mode.
// Design: one thread per output voxel, z fastest; no rolling scratch —
// the TPU kernel's two-slice VMEM cache is a sequential-grid device that
// blocks running in any order on 132 SMs do not need.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int grad(int nv, int pv, int nw, int pw) {
  return (nw != 0 && pw != 0) ? (nv - pv) / 2 : 0;   // C `/` truncates
}

__device__ __forceinline__ int rshift_round(int x, int s) {
  return s ? (x + ((1 << s) >> 1)) >> s : x;          // arithmetic shift
}

__device__ __forceinline__ uint32_t code8(int x, int s) {
  return (uint32_t)min(max(rshift_round(x, s) + 128, 1), 255);
}

template <bool EXACT>
__global__ void fields_kernel(const int16_t* __restrict__ v,
                              const int16_t* __restrict__ w,
                              int32_t* __restrict__ out_a,
                              int32_t* __restrict__ out_b, int X, int Y,
                              int Z, int vs, int gs) {
  const unsigned n = (unsigned)X * Y * Z;
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned z = i % Z;
  const unsigned xy = i / Z;
  const unsigned y = xy % Y;
  const unsigned x = xy / Y;
  const unsigned sx = (unsigned)Y * Z, sy = Z;
  const unsigned ox = x * sx, oy = y * sy;
  const unsigned xn = (x + 1 == (unsigned)X ? 0 : x + 1) * sx;
  const unsigned xp = (x == 0 ? X - 1 : x - 1) * sx;
  const unsigned yn = (y + 1 == (unsigned)Y ? 0 : y + 1) * sy;
  const unsigned yp = (y == 0 ? Y - 1 : y - 1) * sy;
  const unsigned zn = z + 1 == (unsigned)Z ? 0 : z + 1;
  const unsigned zp = z == 0 ? Z - 1 : z - 1;

  const int g0 = grad(v[xn + oy + z], v[xp + oy + z],
                      w[xn + oy + z], w[xp + oy + z]);
  const int g1 = grad(v[ox + yn + z], v[ox + yp + z],
                      w[ox + yn + z], w[ox + yp + z]);
  const int g2 = grad(v[ox + oy + zn], v[ox + oy + zp],
                      w[ox + oy + zn], w[ox + oy + zp]);
  const int v0 = v[i], w0 = w[i];
  if (EXACT) {
    const int vsent = w0 != 0 ? v0 : -32768;
    out_a[i] = (int32_t)(((uint32_t)(g0 & 0xFFFF) << 16)
                         | (uint32_t)(vsent & 0xFFFF));
    out_b[i] = (int32_t)(((uint32_t)(g2 & 0xFFFF) << 16)
                         | (uint32_t)(g1 & 0xFFFF));
  } else {
    const uint32_t vcode = w0 != 0 ? code8(v0, vs) : 0u;
    out_a[i] = (int32_t)((vcode << 24) | (code8(g0, gs) << 16)
                         | (code8(g1, gs) << 8) | code8(g2, gs));
  }
}

}  // namespace

extern "C" int ws_fields_packed(const void* value, const void* weight,
                                void* out_a, void* out_b, int X, int Y,
                                int Z, int vs, int gs, int exact,
                                void* stream) {
  const unsigned n = (unsigned)X * Y * Z;
  const int threads = 256;
  const unsigned blocks = (n + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  auto* v = (const int16_t*)value;
  auto* w = (const int16_t*)weight;
  auto* a = (int32_t*)out_a;
  auto* b = (int32_t*)out_b;
  if (exact)
    fields_kernel<true><<<blocks, threads, 0, s>>>(v, w, a, b, X, Y, Z, vs,
                                                   gs);
  else
    fields_kernel<false><<<blocks, threads, 0, s>>>(v, w, a, b, X, Y, Z, vs,
                                                    gs);
  return (int)cudaGetLastError();
}
