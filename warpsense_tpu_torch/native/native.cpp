// warpsense_tpu_torch native runtime: C++ host-side components.
//
// The port's own copy of warpsense_tpu/native/native.cpp (the same source,
// so both packages compute the same bytes); the reference's C++ runtime
// layer around the device compute:
//   * ws_ringbuf_*  — mutex+condvar concurrent ring buffer, behavioral
//     parity with the reference's concurrent_ring_buffer.h (push_nb(force),
//     pop(timeout), pop_nb, clear), carrying raw byte payloads between
//     data-loader and pipeline threads without the GIL;
//   * ws_preprocess — scan preprocessing host twin: mm scale, voxel-center
//     snap, hash-set dedup, near-origin filter (src/warpsense/app.cpp:
//     120-148);
//   * ws_ring_gather / ws_ring_scatter — the local-map shift slab copies
//     between the ring-buffer window and chunk staging buffers
//     (src/map/hdf5_local_map.cpp:120-198), the host memory-bandwidth hot
//     path of a host-side shift.
//
// A plain C ABI for ctypes.  Build: g++ -O3 -std=c++17 -shared -fPIC
// -pthread (native/__init__.py).

#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <unordered_set>
#include <vector>

extern "C" {

int ws_version() { return 1; }

// ---------------------------------------------------------------- ring buffer

struct RingBuf {
  size_t capacity;
  std::deque<std::vector<uint8_t>> items;
  std::mutex m;
  std::condition_variable not_empty;
  std::condition_variable not_full;
};

void* ws_ringbuf_create(size_t capacity) {
  auto* rb = new RingBuf();
  rb->capacity = capacity ? capacity : 1;
  return rb;
}

void ws_ringbuf_destroy(void* h) { delete static_cast<RingBuf*>(h); }

size_t ws_ringbuf_size(void* h) {
  auto* rb = static_cast<RingBuf*>(h);
  std::lock_guard<std::mutex> lk(rb->m);
  return rb->items.size();
}

void ws_ringbuf_clear(void* h) {
  auto* rb = static_cast<RingBuf*>(h);
  std::lock_guard<std::mutex> lk(rb->m);
  rb->items.clear();
  rb->not_full.notify_all();
}

// force=1: drop oldest when full (push_nb(force), ring semantics).
// timeout_s < 0: non-blocking.  Returns 1 on success.
int ws_ringbuf_push(void* h, const void* data, size_t len, int force,
                    double timeout_s) {
  auto* rb = static_cast<RingBuf*>(h);
  std::unique_lock<std::mutex> lk(rb->m);
  if (rb->items.size() >= rb->capacity) {
    if (force) {
      rb->items.pop_front();
    } else if (timeout_s < 0) {
      return 0;
    } else {
      auto until = std::chrono::steady_clock::now()
                   + std::chrono::duration_cast<std::chrono::nanoseconds>(
                         std::chrono::duration<double>(timeout_s));
      if (!rb->not_full.wait_until(lk, until, [&] {
            return rb->items.size() < rb->capacity;
          }))
        return 0;
    }
  }
  const auto* p = static_cast<const uint8_t*>(data);
  rb->items.emplace_back(p, p + len);
  rb->not_empty.notify_one();
  return 1;
}

// Pops into out (cap out_cap bytes); *out_len = payload size.  Returns 1 on
// success, 0 on timeout/empty, -1 if the payload exceeds out_cap (item is
// left in place).
int ws_ringbuf_pop(void* h, void* out, size_t out_cap, size_t* out_len,
                   double timeout_s) {
  auto* rb = static_cast<RingBuf*>(h);
  std::unique_lock<std::mutex> lk(rb->m);
  if (rb->items.empty()) {
    if (timeout_s < 0) return 0;
    auto until = std::chrono::steady_clock::now()
                 + std::chrono::duration_cast<std::chrono::nanoseconds>(
                       std::chrono::duration<double>(timeout_s));
    if (!rb->not_empty.wait_until(lk, until,
                                  [&] { return !rb->items.empty(); }))
      return 0;
  }
  auto& front = rb->items.front();
  *out_len = front.size();
  if (front.size() > out_cap) return -1;
  std::memcpy(out, front.data(), front.size());
  rb->items.pop_front();
  rb->not_full.notify_one();
  return 1;
}

// ---------------------------------------------------------------- preprocess

// Scan preprocessing host twin (app.cpp:120-148): meters -> mm, voxel-center
// snap, dedup via hash set, near-origin rejection (coordinate-wise AND like
// the reference), optional fixed-point pose transform applied by the caller.
// Returns the number of unique centers written (<= cap).
int64_t ws_preprocess(const float* pts, int64_t n, int32_t resolution,
                      float near_limit_m, int32_t* out, int64_t cap) {
  std::unordered_set<uint64_t> seen;
  seen.reserve(static_cast<size_t>(n));
  int64_t count = 0;
  const int64_t B = 1 << 20;  // 21-bit two's-complement pack per axis
  for (int64_t i = 0; i < n && count < cap; ++i) {
    float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
    if (x == 0.f && y == 0.f && z == 0.f) continue;
    if (x < near_limit_m && y < near_limit_m && z < near_limit_m) continue;
    // floor division to the voxel, center = v*res + res/2
    auto snap = [&](float v_m) -> int64_t {
      int64_t mm = static_cast<int64_t>(std::lround(v_m * 1000.f));
      int64_t q = mm >= 0 ? mm / resolution : -((-mm + resolution - 1) / resolution);
      return q;
    };
    int64_t vx = snap(x), vy = snap(y), vz = snap(z);
    uint64_t key = (static_cast<uint64_t>(vx + B) << 42)
                   | (static_cast<uint64_t>(vy + B) << 21)
                   | static_cast<uint64_t>(vz + B);
    if (!seen.insert(key).second) continue;
    out[3 * count] = static_cast<int32_t>(vx * resolution + resolution / 2);
    out[3 * count + 1] = static_cast<int32_t>(vy * resolution + resolution / 2);
    out[3 * count + 2] = static_cast<int32_t>(vz * resolution + resolution / 2);
    ++count;
  }
  return count;
}

// ------------------------------------------------------- shift slab copies

// Gather the inclusive global-coordinate box [start, end] from the ring
// window (value/weight int16 planes) into a packed uint32 buffer
// (weight << 16 | value, the TSDFEntry layout, map/tsdf.h:16-140).
static inline int64_t mod(int64_t a, int64_t m) {
  int64_t r = a % m;
  return r < 0 ? r + m : r;
}

void ws_ring_gather(const int16_t* value, const int16_t* weight,
                    const int32_t* size, const int32_t* pos,
                    const int32_t* offset, const int64_t* start,
                    const int64_t* end, uint32_t* out) {
  const int64_t sx = size[0], sy = size[1], sz = size[2];
  int64_t k = 0;
  for (int64_t gx = start[0]; gx <= end[0]; ++gx) {
    const int64_t ax = mod(gx - pos[0] + offset[0], sx) * sy * sz;
    for (int64_t gy = start[1]; gy <= end[1]; ++gy) {
      const int64_t ay = ax + mod(gy - pos[1] + offset[1], sy) * sz;
      for (int64_t gz = start[2]; gz <= end[2]; ++gz, ++k) {
        const int64_t a = ay + mod(gz - pos[2] + offset[2], sz);
        out[k] = (static_cast<uint32_t>(static_cast<uint16_t>(weight[a])) << 16)
                 | static_cast<uint16_t>(value[a]);
      }
    }
  }
}

void ws_ring_scatter(int16_t* value, int16_t* weight, const int32_t* size,
                     const int32_t* pos, const int32_t* offset,
                     const int64_t* start, const int64_t* end,
                     const uint32_t* in) {
  const int64_t sx = size[0], sy = size[1], sz = size[2];
  int64_t k = 0;
  for (int64_t gx = start[0]; gx <= end[0]; ++gx) {
    const int64_t ax = mod(gx - pos[0] + offset[0], sx) * sy * sz;
    for (int64_t gy = start[1]; gy <= end[1]; ++gy) {
      const int64_t ay = ax + mod(gy - pos[1] + offset[1], sy) * sz;
      for (int64_t gz = start[2]; gz <= end[2]; ++gz, ++k) {
        const int64_t a = ay + mod(gz - pos[2] + offset[2], sz);
        weight[a] = static_cast<int16_t>(in[k] >> 16);
        value[a] = static_cast<int16_t>(in[k] & 0xFFFF);
      }
    }
  }
}

}  // extern "C"
