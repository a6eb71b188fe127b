// Native scan IO: fast LIDAR binary reading + asynchronous prefetch.
//
// Host-side equivalent of the runtime/data-path work the reference does in
// C++ (its whole tree is C++/ROS; scan ingest is the laserCloudCallback at
// src/icpslam/icp_odometer.cpp:147 of the reference). The pipeline's
// host loop must keep the device fed at 100+ scans/s; Python file IO +
// numpy filtering becomes the bottleneck, so this library provides:
//
//   - scanio_read_bin: mmap-free buffered read of a KITTI velodyne .bin
//     (float32 x,y,z,reflectance records), with range gating and
//     deterministic stride subsampling, writing straight into a
//     caller-provided padded (capacity, 3) buffer + count.
//   - a threaded prefetcher: N worker threads read+filter files ahead of
//     the consumer through a bounded ring buffer (the bounded-queue ingest
//     design of SURVEY.md §5.2), so device compute overlaps disk IO.
//
// Exposed as a plain C ABI for ctypes (no pybind11 dependency).
// Build: make -C native   (produces libscanio.so)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// Read one .bin scan of float32[n][record_stride] records; keep points with
// min_range <= |p| <= max_range; subsample evenly to at most `capacity`
// points. Writes xyz into out[capacity*3] and returns the number of valid
// points, or -1 on IO error.
int scanio_read_bin(const char* path, float* out, int capacity,
                    int record_stride, float min_range, float max_range) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long bytes = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (bytes <= 0 || record_stride < 3) {
    std::fclose(f);
    return -1;
  }
  size_t n = static_cast<size_t>(bytes) / (sizeof(float) * record_stride);
  std::vector<float> raw(n * record_stride);
  size_t got = std::fread(raw.data(), sizeof(float) * record_stride, n, f);
  std::fclose(f);
  n = got;

  const float min2 = min_range * min_range;
  const float max2 = max_range * max_range;

  // first pass: count in-range points
  size_t kept = 0;
  for (size_t i = 0; i < n; ++i) {
    const float* p = raw.data() + i * record_stride;
    float r2 = p[0] * p[0] + p[1] * p[1] + p[2] * p[2];
    if (r2 >= min2 && r2 <= max2) ++kept;
  }
  if (kept == 0) return 0;

  // deterministic even subsample: keep every stride-th surviving point
  const size_t cap = static_cast<size_t>(capacity);
  const double stride = kept > cap ? static_cast<double>(kept) / cap : 1.0;
  double next = 0.0;
  size_t rank = 0, written = 0;
  for (size_t i = 0; i < n && written < cap; ++i) {
    const float* p = raw.data() + i * record_stride;
    float r2 = p[0] * p[0] + p[1] * p[1] + p[2] * p[2];
    if (r2 < min2 || r2 > max2) continue;
    if (static_cast<double>(rank) >= next) {
      float* dst = out + written * 3;
      dst[0] = p[0];
      dst[1] = p[1];
      dst[2] = p[2];
      ++written;
      next += stride;
    }
    ++rank;
  }
  return static_cast<int>(written);
}

// ---------------------------------------------------------------------------
// Prefetcher: worker threads read files ahead into a bounded ring buffer.
// ---------------------------------------------------------------------------

struct Slot {
  std::vector<float> xyz;  // capacity * 3
  int count = 0;
  int index = -1;  // file index, preserves order for the consumer
};

struct Prefetcher {
  std::vector<std::string> paths;
  int capacity;
  int record_stride;
  float min_range, max_range;

  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_produced, cv_space;
  std::queue<Slot> ready;
  size_t max_queue;
  std::atomic<size_t> next_file{0};
  int next_emit = 0;  // next file index the consumer should see
  std::vector<Slot> reorder;  // out-of-order completions parking lot
  std::atomic<bool> stop{false};

  Prefetcher(std::vector<std::string> p, int cap, int stride, float mn,
             float mx, int n_threads, size_t depth)
      : paths(std::move(p)),
        capacity(cap),
        record_stride(stride),
        min_range(mn),
        max_range(mx),
        max_queue(depth) {
    for (int t = 0; t < n_threads; ++t)
      workers.emplace_back([this] { this->work(); });
  }

  void work() {
    for (;;) {
      if (stop.load()) return;
      size_t idx = next_file.fetch_add(1);
      if (idx >= paths.size()) return;
      Slot s;
      s.xyz.resize(static_cast<size_t>(capacity) * 3, 0.0f);
      s.count = scanio_read_bin(paths[idx].c_str(), s.xyz.data(), capacity,
                                record_stride, min_range, max_range);
      s.index = static_cast<int>(idx);
      std::unique_lock<std::mutex> lk(mu);
      // The slot the consumer is waiting for (index == next_emit) must be
      // exempt from the space limit: otherwise out-of-order completions can
      // fill the quota and deadlock producer and consumer against each
      // other (next-in-order blocked on space, consumer blocked on data).
      cv_space.wait(lk, [this, &s] {
        return stop.load() || s.index == next_emit ||
               ready.size() + reorder.size() < max_queue + 8;
      });
      if (stop.load()) return;
      reorder.push_back(std::move(s));
      drain_reorder_locked();
      cv_produced.notify_all();
    }
  }

  // move in-order completions from the parking lot to the consumer queue
  void drain_reorder_locked() {
    bool moved = true;
    while (moved) {
      moved = false;
      for (size_t i = 0; i < reorder.size(); ++i) {
        if (reorder[i].index == next_emit) {
          ready.push(std::move(reorder[i]));
          reorder.erase(reorder.begin() + i);
          ++next_emit;
          moved = true;
          break;
        }
      }
    }
  }

  // Returns count (>=0), or -2 when the stream is exhausted.
  int next(float* out) {
    std::unique_lock<std::mutex> lk(mu);
    cv_produced.wait(lk, [this] {
      return !ready.empty() ||
             (next_emit >= static_cast<int>(paths.size()));
    });
    if (ready.empty()) return -2;
    Slot s = std::move(ready.front());
    ready.pop();
    cv_space.notify_all();
    lk.unlock();
    std::memcpy(out, s.xyz.data(), sizeof(float) * capacity * 3);
    return s.count;
  }

  ~Prefetcher() {
    stop.store(true);
    cv_space.notify_all();
    cv_produced.notify_all();
    for (auto& w : workers) w.join();
  }
};

void* scanio_prefetcher_create(const char** paths, int n_paths, int capacity,
                               int record_stride, float min_range,
                               float max_range, int n_threads, int depth) {
  std::vector<std::string> p(paths, paths + n_paths);
  return new Prefetcher(std::move(p), capacity, record_stride, min_range,
                        max_range, n_threads > 0 ? n_threads : 2,
                        depth > 0 ? depth : 4);
}

int scanio_prefetcher_next(void* handle, float* out) {
  return static_cast<Prefetcher*>(handle)->next(out);
}

void scanio_prefetcher_destroy(void* handle) {
  delete static_cast<Prefetcher*>(handle);
}

}  // extern "C"
