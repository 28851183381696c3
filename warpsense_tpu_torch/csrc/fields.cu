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
// What bounds it on an H100: bytes.  The function reads the int16 value and
// weight planes once and writes one int32 plane (two in exact mode): 8 B a
// voxel packed, 12 B exact, 0.219 / 0.329 ms at 3.35 TB/s for the
// 625 x 625 x 235 window.  It does no float work, and its integer work is a
// few dozen instructions a voxel.  A thread per voxel reading its seven
// neighbours from global memory spends its time on index arithmetic (the
// divisions that find x, y, z) and load instructions, and fetches each
// input byte from L2 about three times (the x neighbours lie a plane away).
//
// Design: 2.5D blocking along x.  The window is X planes of P = Y*Z voxels;
// in a plane, y-neighbours are P-periodic flat offsets of +-Z (Z divides
// P) and z-neighbours +-1 inside a row.  A block owns a tile of kTile
// consecutive plane positions [t0, t0 + kTile) and marches over a run of
// kRun planes.  Each plane's tile, with a halo of Z positions on each side
// (clipped to the plane), is staged once into shared memory by 16-byte
// cp.async, into a ring of kSlots buffers: planes x-1, x and x+1 are read
// while x+2 is in flight.  So every input byte crosses to the SM once, plus
// the two planes at the run's ends and the halos.  The y wrap (row 0's
// y-1 is row Y-1 and the reverse) falls outside the clipped halo: those two
// rows of each plane read that neighbour from global memory.  The z wrap
// stays inside a row, so inside the stage.  A thread takes plane positions
// t0 + tid + k * kThreads: lanes read consecutive int16 from shared memory
// (no bank conflicts at any misalignment) and write 128 contiguous bytes
// per warp.  z advances by a per-thread counter (one modulo per thread per
// block, none per voxel); all indices stay below 2^31.  Tiles away from the
// plane's first and last rows take a path without masks or wrap tests.
//
// Measured on an H100 and not kept (PERF.md): one 32-bit word per position
// (weight << 16 | value, interleaved through registers: half the shared
// loads) was slower packed and a few percent faster exact, and a kernel
// staging each mode its own way gained less than that on exact; tiles of
// 1024 or 4096, runs of 8, 24 or 32 planes, a fifth slot, a persistent
// grid and streaming stores were each slower or no faster.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 2048;               // plane positions per block
constexpr int kThreads = 256;
constexpr int kPer = kTile / kThreads;    // positions per thread and plane
constexpr int kRun = 16;                  // planes per block
constexpr int kSlots = 4;                 // x-1, x, x+1 and x+2 in flight

__device__ __forceinline__ int grad(int nv, int pv, int nw, int pw) {
  return (nw != 0 && pw != 0) ? (nv - pv) / 2 : 0;   // C `/` truncates
}

// The round-to-nearest shift of the packing and its +128 in one bias:
// ((x + (1 << s >> 1)) >> s) + 128 == (x + bias(s)) >> s (arithmetic shift)
__device__ __forceinline__ int bias(int s) {
  return ((1 << s) >> 1) + (128 << s);
}

__device__ __forceinline__ uint32_t code8(int x, int b, int s) {
  return (uint32_t)min(max((x + b) >> s, 1), 255);
}

// 16-byte asynchronous copy from global to shared memory, reading only
// `bytes` (0..16) of the source and zero-filling the rest
__device__ __forceinline__ void copy_async16(void* smem, const void* gmem,
                                             int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void copy_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Stage plane positions [lo, lo + n) of plane `xs` into slot `dst` (value
// then weight, `span` elements each).  `v` and `w` are the planes' base
// pointers rounded down to a 16-byte boundary, and the window starts `mis`
// (0..7) elements past them in both.  The copy starts at the 16-byte
// boundary at or below the first element, so the element at position q
// lands at dst[(mis + xs * P + lo) % 8 + q - lo]; nothing past the window
// is read, and before it only the rest of its first 16 bytes.
__device__ __forceinline__ void stage(const int16_t* __restrict__ v,
                                      const int16_t* __restrict__ w,
                                      int16_t* dst, int span, unsigned xs,
                                      unsigned P, unsigned lo, unsigned n,
                                      unsigned end, unsigned mis) {
  const unsigned g0 = mis + xs * P + lo;
  const unsigned ga = g0 & ~7u;
  const unsigned chunks = (g0 - ga + n + 7) >> 3;
  for (unsigned c = threadIdx.x; c < chunks; c += kThreads) {
    const unsigned g = ga + 8 * c;
    const int bytes = 2 * (int)min(8u, end - g);
    copy_async16(dst + 8 * c, v + g, bytes);
    copy_async16(dst + span + 8 * c, w + g, bytes);
  }
}

// An int16 load from shared memory (a 32-bit shared address), sign-
// extended.  Volatile, so that every load is emitted where it is written:
// left to itself the compiler loads a value only where its weights are
// nonzero, and that branch diverges where weights vary from voxel to
// voxel.  The clobber keeps it on its side of __syncthreads().
__device__ __forceinline__ int lds16(unsigned addr) {
  int x;
  asm volatile("ld.shared.s16 %0, [%1];\n"
               : "=r"(x)
               : "r"(addr)
               : "memory");
  return x;
}

// Fields of one plane's tile: c, pn, nx are the shared addresses of plane
// position 0 of the staged planes x, x-1, x+1 (value at +2q, weight at
// +2q + wb bytes).  EDGE: the block's tile touches the plane's first or
// last row or its ragged end, so positions are masked and rows 0 and Y-1
// read their wrapped y-neighbour from global memory.
template <bool EXACT, bool EDGE>
__device__ __forceinline__ void tile_fields(
    const int16_t* __restrict__ v, const int16_t* __restrict__ w,
    int32_t* __restrict__ out_a, int32_t* __restrict__ out_b, unsigned c,
    unsigned pn, unsigned nx, unsigned wb, unsigned xbase, unsigned P,
    unsigned Z, unsigned t0, unsigned zstart, unsigned zstep, int vbias,
    int vs, int gbias, int gs) {
  const unsigned zlast = Z - 1;
  unsigned z = zstart;
  unsigned q = t0 + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kPer; ++k, q += kThreads) {
    if (!EDGE || q < P) {
      const unsigned a = c + 2 * q;
      const int v0 = lds16(a), w0 = lds16(a + wb);
      const int xn_v = lds16(nx + 2 * q), xn_w = lds16(nx + 2 * q + wb);
      const int xp_v = lds16(pn + 2 * q), xp_w = lds16(pn + 2 * q + wb);
      int yn_v, yn_w, yp_v, yp_w;
      if (!EDGE || q + Z < P) {
        yn_v = lds16(a + 2 * Z);
        yn_w = lds16(a + 2 * Z + wb);
      } else {                           // row Y-1: y+1 is row 0
        yn_v = v[xbase + q + Z - P];
        yn_w = w[xbase + q + Z - P];
      }
      if (!EDGE || q >= Z) {
        yp_v = lds16(a - 2 * Z);
        yp_w = lds16(a - 2 * Z + wb);
      } else {                           // row 0: y-1 is row Y-1
        yp_v = v[xbase + q + P - Z];
        yp_w = w[xbase + q + P - Z];
      }
      const unsigned zn = z == zlast ? a - 2 * zlast : a + 2;
      const unsigned zp = z == 0 ? a + 2 * zlast : a - 2;
      const int zn_v = lds16(zn), zn_w = lds16(zn + wb);
      const int zp_v = lds16(zp), zp_w = lds16(zp + wb);
      const int g0 = grad(xn_v, xp_v, xn_w, xp_w);
      const int g1 = grad(yn_v, yp_v, yn_w, yp_w);
      const int g2 = grad(zn_v, zp_v, zn_w, zp_w);
      const unsigned i = xbase + q;
      if (EXACT) {
        const int vsent = w0 != 0 ? v0 : -32768;
        out_a[i] = (int32_t)(((uint32_t)(g0 & 0xFFFF) << 16)
                             | (uint32_t)(vsent & 0xFFFF));
        out_b[i] = (int32_t)(((uint32_t)(g2 & 0xFFFF) << 16)
                             | (uint32_t)(g1 & 0xFFFF));
      } else {
        const uint32_t vcode = w0 != 0 ? code8(v0, vbias, vs) : 0u;
        out_a[i] = (int32_t)((vcode << 24) | (code8(g0, gbias, gs) << 16)
                             | (code8(g1, gbias, gs) << 8)
                             | code8(g2, gbias, gs));
      }
    }
    z += zstep;
    if (z >= Z) z -= Z;
  }
}

template <bool EXACT>
__global__ void __launch_bounds__(kThreads)
fields_kernel(const int16_t* __restrict__ v, const int16_t* __restrict__ w,
              int32_t* __restrict__ out_a, int32_t* __restrict__ out_b,
              int X, int Y, int Z, int vs, int gs, int tiles, int span,
              int mis) {
  extern __shared__ __align__(16) int16_t smem[];
  const unsigned P = (unsigned)Y * Z, total = (unsigned)X * P;
  // the 16-byte boundaries at or below the planes' starts
  const int16_t* va = v - mis;
  const int16_t* wa = w - mis;
  const unsigned tile = blockIdx.x % tiles, run = blockIdx.x / tiles;
  const unsigned t0 = tile * kTile;
  const unsigned lo = t0 >= (unsigned)Z ? t0 - Z : 0;
  const unsigned hi = min(t0 + kTile + Z, P);
  const bool edge = t0 < (unsigned)Z || t0 + kTile + Z > P;
  const unsigned x0 = run * kRun, x1 = min(x0 + kRun, (unsigned)X);
  const int slot = 2 * span;
  const int vbias = bias(vs), gbias = bias(gs);

  // slice j of the block's walk is plane (x0 - 1 + j) mod X, in slot j % 4
  auto plane = [&](unsigned j) {
    const unsigned x = x0 + j;            // one past the plane, <= X + 1
    return x == 0 ? X - 1 : (x - 1 < (unsigned)X ? x - 1 : x - 1 - X);
  };
  // smem + offset(j) + q holds plane position q of slice j
  auto offset = [&](unsigned j) {
    return (int)(j % kSlots) * slot
           + (int)((mis + plane(j) * P + lo) & 7u) - (int)lo;
  };
  const unsigned nslices = x1 - x0 + 2;   // x0-1 .. x1
  for (unsigned j = 0; j < kSlots - 1; ++j) {
    if (j < nslices)
      stage(va, wa, smem + (j % kSlots) * slot, span, plane(j), P, lo,
            hi - lo, mis + total, mis);
    copy_async_commit();
  }

  // each thread's z at position t0 + tid, then a counter: one modulo per
  // thread, none per voxel
  const unsigned zstart = (t0 + threadIdx.x) % Z;
  const unsigned zstep = kThreads % Z;

  for (unsigned j = 1; j + 1 < nslices; ++j) {
    // slice j + 2 into the slot that slice j - 2 left
    if (j + 2 < nslices)
      stage(va, wa, smem + ((j + 2) % kSlots) * slot, span, plane(j + 2),
            P, lo, hi - lo, mis + total, mis);
    copy_async_commit();
    copy_async_wait1();                  // slices up to j + 1 have landed
    __syncthreads();
    const unsigned base = (unsigned)__cvta_generic_to_shared(smem);
    const unsigned c = base + 2 * offset(j), wb = 2 * span;
    const unsigned pn = base + 2 * offset(j - 1);
    const unsigned nx = base + 2 * offset(j + 1);
    const unsigned xbase = plane(j) * P;
    if (edge)
      tile_fields<EXACT, true>(v, w, out_a, out_b, c, pn, nx, wb, xbase, P,
                               Z, t0, zstart, zstep, vbias, vs, gbias, gs);
    else
      tile_fields<EXACT, false>(v, w, out_a, out_b, c, pn, nx, wb, xbase, P,
                                Z, t0, zstart, zstep, vbias, vs, gbias, gs);
    __syncthreads();                     // slot of slice j - 1 is free
  }
}

}  // namespace

// The wrapper (kernels/fields.py) checks that the planes start at the same
// offset from a 16-byte boundary and that the stage fits in shared memory
// (smem_bytes).
extern "C" int ws_fields_packed(const void* value, const void* weight,
                                void* out_a, void* out_b, int X, int Y,
                                int Z, int vs, int gs, int exact,
                                void* stream) {
  const int mis = (int)(((uintptr_t)value & 15u) >> 1);
  const unsigned P = (unsigned)Y * Z;
  const int tiles = (int)((P + kTile - 1) / kTile);
  const int runs = (X + kRun - 1) / kRun;
  // a staged plane: tile + 2 halos, the misalignment (< 8) and the last
  // 16-byte copy's rounding (< 8), in elements, a multiple of 8
  const int span = (kTile + 2 * Z + 14 + 7) / 8 * 8;
  const int smem = kSlots * 2 * span * (int)sizeof(int16_t);
  cudaStream_t s = (cudaStream_t)stream;
  auto* v = (const int16_t*)value;
  auto* w = (const int16_t*)weight;
  auto* a = (int32_t*)out_a;
  auto* b = (int32_t*)out_b;
  const unsigned blocks = (unsigned)tiles * runs;
  cudaError_t err;
  if (exact) {
    err = cudaFuncSetAttribute(fields_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    fields_kernel<true><<<blocks, kThreads, smem, s>>>(
        v, w, a, b, X, Y, Z, vs, gs, tiles, span, mis);
  } else {
    err = cudaFuncSetAttribute(fields_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    fields_kernel<false><<<blocks, kThreads, smem, s>>>(
        v, w, a, b, X, Y, Z, vs, gs, tiles, span, mis);
  }
  return (int)cudaGetLastError();
}
