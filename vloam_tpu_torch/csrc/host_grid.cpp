// Ring gridding of a raw lidar cloud on the host, threaded over the cloud.
//
// The C++ twin of data/gridding.grid_cloud that VloamDriver.process calls:
// the finite and minimum-range filter, the ring id from the vertical angle by
// the 16/32/64-beam formulas (scan_registration.cpp:217-254), the azimuth
// relative time from the first and last valid point (:185-294), w = ring +
// scan_period * rel, and the scan-order rank within each ring, capped at
// ring_cap.  The arithmetic is float32 wherever NumPy's grid_cloud computes in
// float32 under NumPy 2's promotion rules (a Python float meets a float32 array
// or scalar as a float32): the angle, start, end, the sweep, rel and w.  NumPy
// may take atan2 from a vector library, so w can differ from it in the last
// bits; xyz, the mask and the counts are the same.
//
// Two passes over the cloud cut into fixed blocks of 4096 points, shared out
// among T threads as they ask for them:
//   1. each point's ring (-1 when it is dropped) and azimuth, each block's ring
//      counts and its first and last valid point;
//   then, on the calling thread, the sweep from the cloud's first and last
//   valid point, and each block's first rank in every ring (an exclusive
//   prefix over the blocks);
//   2. each valid point's cell (ranks past ring_cap dropped), and the cells
//      past each ring's count zeroed and unmasked, so the caller needs to
//      clear nothing beforehand.
// Every cell depends on its point and on the blocks' counts alone, so the
// output is the same for every T.  The worker threads persist between calls
// (a pool made at first use, made again in a forked child); a worker that
// wakes late finds the blocks taken and holds nothing up.  One call runs at a
// time.

#include <sched.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr int kMaxThreads = 8;
constexpr int kMinPointsPerThread = 16384;
constexpr int kBlock = 4096;          // points a block
constexpr int kZeroItems = 8;         // pieces the tail clearing is cut into
constexpr int kMaxRings = 64;
constexpr float kRad2Deg = 180.0f / 3.14159265358979323846f;   // np.degrees on float32
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = static_cast<float>(2.0 * 3.14159265358979323846);
constexpr float kThreePi = static_cast<float>(3.0 * 3.14159265358979323846);

// Runs fn on the calling thread and on tasks - 1 workers at once; fn shares
// out the work itself, so run returns once the calling thread's fn has
// returned and no worker is inside fn.  Not reentrant: the caller serialises.
class Pool {
 public:
  void run(int tasks, const std::function<void()>& fn) {
    if (tasks > 1) {
      std::lock_guard<std::mutex> lk(mu_);
      while (static_cast<int>(workers_) < tasks - 1) {
        std::thread(&Pool::work, this, static_cast<int>(++workers_),
                    generation_).detach();
      }
      job_ = &fn;
      tasks_ = tasks;
      ++generation_;
      wake_.notify_all();
    }
    fn();
    if (tasks > 1) {
      std::unique_lock<std::mutex> lk(mu_);
      job_ = nullptr;   // a worker not yet inside fn stays out
      done_.wait(lk, [this] { return active_ == 0; });
    }
  }

 private:
  void work(int id, uint64_t seen) {
    for (;;) {
      std::unique_lock<std::mutex> lk(mu_);
      wake_.wait(lk, [&] { return generation_ != seen; });
      seen = generation_;
      if (job_ == nullptr || id >= tasks_) continue;
      const std::function<void()>* fn = job_;
      ++active_;
      lk.unlock();
      (*fn)();
      lk.lock();
      if (--active_ == 0) done_.notify_one();
    }
  }

  std::mutex mu_;
  std::condition_variable wake_, done_;
  const std::function<void()>* job_ = nullptr;
  unsigned workers_ = 0;
  int tasks_ = 0, active_ = 0;
  uint64_t generation_ = 0;
};

// Calls item(k) for every k in [0, items), each once, on whichever of the
// threads asks first.
template <class F>
void share(Pool& pool, int tasks, int items, F&& item) {
  std::atomic<int> next{0};
  pool.run(tasks, [&] {
    for (int k; (k = next.fetch_add(1, std::memory_order_relaxed)) < items;) item(k);
  });
}

struct alignas(64) Block {
  int count[kMaxRings];   // pass 1: valid points a ring; pass 2: the next rank a ring
  int64_t first, last;    // the block's first and last valid point, -1 when none
};

// The state one call uses, kept between calls so that they allocate nothing.
// Never destroyed: detached workers wait on its pool until the process ends.
struct Gridder {
  std::mutex call;
  Pool pool;
  std::vector<int8_t> ring;
  std::vector<float> ori;
  std::vector<Block> block;
};

std::mutex g_make;
Gridder* g_gridder = nullptr;
pid_t g_pid = 0;

Gridder& gridder() {
  std::lock_guard<std::mutex> lk(g_make);
  if (g_gridder == nullptr || g_pid != getpid()) {   // a forked child has no workers
    g_gridder = new Gridder();
    g_pid = getpid();
  }
  return *g_gridder;
}

int auto_threads(int64_t n) {
  cpu_set_t set;
  int cpus = sched_getaffinity(0, sizeof(set), &set) == 0 ? CPU_COUNT(&set) : 1;
  int64_t by_size = std::max<int64_t>(1, n / kMinPointsPerThread);
  return static_cast<int>(std::min<int64_t>({cpus, kMaxThreads, by_size}));
}

// The ring of one point (-1 when it is dropped), as grid_cloud computes it.
inline int ring_of(float x, float y, float z, int n_scans, float min_range) {
  if (!(std::isfinite(x) && std::isfinite(y) && std::isfinite(z))) return -1;
  float r = std::sqrt((x * x + y * y) + z * z);
  if (!(r >= min_range)) return -1;
  float horiz = std::sqrt(x * x + y * y);
  float angle = std::atan2(z, std::max(horiz, 1e-12f)) * kRad2Deg;
  int sid;
  bool ok;
  if (n_scans == 16) {
    sid = static_cast<int>((angle + 15.0f) / 2.0f + 0.5f);
    ok = sid >= 0 && sid <= n_scans - 1;
  } else if (n_scans == 32) {
    sid = static_cast<int>((angle + static_cast<float>(92.0 / 3.0)) * 3.0f / 4.0f);
    ok = sid >= 0 && sid <= n_scans - 1;
  } else {
    if (angle >= -8.83f)
      sid = static_cast<int>((2.0f - angle) * 3.0f + 0.5f);
    else
      sid = n_scans / 2 + static_cast<int>((-8.83f - angle) * 2.0f + 0.5f);
    ok = angle <= 2.0f && angle >= -24.33f && sid >= 0 && sid <= 50;
  }
  return ok ? sid : -1;
}

}  // namespace

extern "C" {

// Grids a raw cloud (n x stride float32, xyz in the first 3) into grid_out
// (n_scans, ring_cap, 4) xyzw, mask_out (n_scans, ring_cap) 0/1 bytes and
// n_per_ring_out (n_scans); every element of the three is written.
// n_threads <= 0 takes T from the CPUs this process may run on, at most 8 and
// at most one per 16384 points; tests pass T.  Returns the points gridded, or
// -1 on an unsupported n_scans or a bad size.
int vh_grid_cloud_threaded(const float* pts, int n, int stride, int n_scans, int ring_cap,
                           float min_range, float scan_period, int n_threads,
                           float* grid_out, unsigned char* mask_out, int* n_per_ring_out) {
  if (n_scans != 16 && n_scans != 32 && n_scans != 64) return -1;
  if (n < 0 || stride < 3 || ring_cap < 0) return -1;
  const int R = n_scans, C = ring_cap;
  const int T = n_threads > 0 ? std::min(n_threads, kMaxThreads) : auto_threads(n);
  Gridder& g = gridder();
  std::lock_guard<std::mutex> call(g.call);
  const int nb = (n + kBlock - 1) / kBlock;
  if (g.ring.size() < static_cast<size_t>(n)) {
    g.ring.resize(n);
    g.ori.resize(n);
  }
  if (g.block.size() < static_cast<size_t>(nb)) g.block.resize(nb);
  int8_t* ring = g.ring.data();
  float* ori = g.ori.data();
  Block* block = g.block.data();

  share(g.pool, T, nb, [&](int b) {
    Block& c = block[b];
    std::fill(c.count, c.count + R, 0);
    c.first = c.last = -1;
    for (int64_t i = static_cast<int64_t>(b) * kBlock, e = std::min<int64_t>(i + kBlock, n);
         i < e; ++i) {
      const float* p = pts + i * stride;
      int rr = ring_of(p[0], p[1], p[2], n_scans, min_range);
      ring[i] = static_cast<int8_t>(rr);
      if (rr < 0) continue;
      ori[i] = -std::atan2(p[1], p[0]);
      ++c.count[rr];
      if (c.first < 0) c.first = i;
      c.last = i;
    }
  });

  int64_t first = -1, last = -1;
  for (int b = 0; b < nb; ++b) {
    if (block[b].first < 0) continue;
    if (first < 0) first = block[b].first;
    last = block[b].last;
  }
  float start = 0.0f, sweep = 1.0f;
  if (first >= 0) {
    start = ori[first];
    float end = ori[last] + kTwoPi;
    if (end - start > kThreePi)
      end -= kTwoPi;
    else if (end - start < kPi)
      end += kTwoPi;
    sweep = std::max(end - start, 1e-6f);
  }
  int total = 0;
  for (int r = 0; r < R; ++r) {
    int seen = 0;
    for (int b = 0; b < nb; ++b) {
      int k = block[b].count[r];
      block[b].count[r] = seen;
      seen += k;
    }
    n_per_ring_out[r] = std::min(seen, C);
    total += n_per_ring_out[r];
  }

  share(g.pool, T, nb + kZeroItems, [&](int b) {
    if (b >= nb) {   // clear the cells past the counts of a few rings
      int z = b - nb;
      for (int r = R * z / kZeroItems, e = R * (z + 1) / kZeroItems; r < e; ++r) {
        size_t c0 = static_cast<size_t>(r) * C + n_per_ring_out[r];
        size_t c1 = static_cast<size_t>(r + 1) * C;
        std::memset(grid_out + c0 * 4, 0, (c1 - c0) * 4 * sizeof(float));
        std::memset(mask_out + c0, 0, c1 - c0);
      }
      return;
    }
    int* next = block[b].count;
    for (int64_t i = static_cast<int64_t>(b) * kBlock, e = std::min<int64_t>(i + kBlock, n);
         i < e; ++i) {
      int rr = ring[i];
      if (rr < 0) continue;
      int k = next[rr]++;
      if (k >= C) continue;
      // numpy's float remainder: fmod, moved into [0, 2pi) by one addition,
      // a zero made +0
      float m = std::fmod(ori[i] - start, kTwoPi);
      if (m < 0.0f)
        m += kTwoPi;
      else if (m == 0.0f)
        m = 0.0f;
      float rel = std::min(std::max(m / sweep, 0.0f), 1.0f);
      const float* p = pts + i * stride;
      float* cell = grid_out + (static_cast<size_t>(rr) * C + k) * 4;
      cell[0] = p[0];
      cell[1] = p[1];
      cell[2] = p[2];
      cell[3] = static_cast<float>(rr) + scan_period * rel;
      mask_out[static_cast<size_t>(rr) * C + k] = 1;
    }
  });
  return total;
}

}  // extern "C"
