// Native real-time control runtime: fixed-rate executor + lock-free telemetry
// (the port's own copy of runtime/rt_runtime.cc; host C++, no CUDA).
//
// The compute path of the port is PyTorch and CUDA on the GPU; this library
// is the host-side runtime wrapped around it for deployment: a
// deadline-driven cycle clock (clock_nanosleep on absolute deadlines),
// deadline-miss accounting, a single-producer single-consumer lock-free
// telemetry ring, and latency statistics (p50/p99/max) computed natively.
//
// Exposed as a C ABI consumed from Python via ctypes
// (tum_control_tpu_torch/utils/rt_runtime.py builds it with g++ at the first
// RealtimeExecutor) — no pybind11 dependency.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>
#include <vector>

namespace {

constexpr uint64_t kNsPerSec = 1000000000ull;

struct TelemetryRecord {
  uint64_t cycle;
  uint64_t t_start_ns;     // cycle start (monotonic)
  uint64_t solve_ns;       // measured solve duration
  int32_t status;          // solver status
  float cost;
  float lat_dev;
  float vel_dev;
  float u0;                // applied jerk
  float u1;                // applied steering rate
};

struct Ring {
  explicit Ring(size_t capacity) : buf(capacity), cap(capacity) {}
  bool push(const TelemetryRecord& r) {
    const size_t h = head.load(std::memory_order_relaxed);
    const size_t t = tail.load(std::memory_order_acquire);
    if (h - t >= cap) {
      dropped.fetch_add(1, std::memory_order_relaxed);
      return false;
    }
    buf[h % cap] = r;
    head.store(h + 1, std::memory_order_release);
    return true;
  }
  size_t pop(TelemetryRecord* out, size_t max_n) {
    const size_t t = tail.load(std::memory_order_relaxed);
    const size_t h = head.load(std::memory_order_acquire);
    const size_t n = std::min(max_n, h - t);
    for (size_t i = 0; i < n; ++i) out[i] = buf[(t + i) % cap];
    tail.store(t + n, std::memory_order_release);
    return n;
  }
  std::vector<TelemetryRecord> buf;
  size_t cap;
  std::atomic<size_t> head{0};
  std::atomic<size_t> tail{0};
  std::atomic<uint64_t> dropped{0};
};

uint64_t now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<uint64_t>(ts.tv_sec) * kNsPerSec + ts.tv_nsec;
}

struct Executor {
  Executor(uint64_t period, size_t capacity) : period_ns(period), ring(capacity) {}
  uint64_t period_ns;
  uint64_t next_deadline_ns = 0;
  uint64_t cycles = 0;
  uint64_t deadline_misses = 0;
  Ring ring;
  std::vector<uint32_t> solve_us;  // for percentile stats
};

struct Stats {
  uint64_t cycles;
  uint64_t deadline_misses;
  uint64_t dropped_records;
  double solve_ms_p50;
  double solve_ms_p99;
  double solve_ms_max;
  double solve_ms_mean;
};

double percentile(std::vector<uint32_t>& v, double q) {
  if (v.empty()) return 0.0;
  const size_t k = static_cast<size_t>(q * (v.size() - 1));
  std::nth_element(v.begin(), v.begin() + k, v.end());
  return v[k] / 1000.0;
}

}  // namespace

extern "C" {

void* rt_create(uint64_t period_ns, uint64_t ring_capacity) {
  return new Executor(period_ns, static_cast<size_t>(ring_capacity));
}

void rt_destroy(void* h) { delete static_cast<Executor*>(h); }

// Block until the next cycle deadline (absolute-time sleep; no drift).
// Returns the cycle start timestamp; counts a miss if we were already late.
uint64_t rt_begin_cycle(void* h) {
  auto* ex = static_cast<Executor*>(h);
  const uint64_t now = now_ns();
  if (ex->next_deadline_ns == 0) {
    ex->next_deadline_ns = now + ex->period_ns;
    return now;
  }
  if (now > ex->next_deadline_ns) {
    ex->deadline_misses++;
    // re-anchor to avoid a miss cascade
    ex->next_deadline_ns = now + ex->period_ns;
    return now;
  }
  timespec ts;
  ts.tv_sec = ex->next_deadline_ns / kNsPerSec;
  ts.tv_nsec = ex->next_deadline_ns % kNsPerSec;
  while (clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &ts, nullptr) != 0) {
  }
  const uint64_t start = ex->next_deadline_ns;
  ex->next_deadline_ns += ex->period_ns;
  return start;
}

void rt_record(void* h, uint64_t t_start_ns, uint64_t solve_ns, int32_t status,
               float cost, float lat_dev, float vel_dev, float u0, float u1) {
  auto* ex = static_cast<Executor*>(h);
  TelemetryRecord r{ex->cycles, t_start_ns, solve_ns, status, cost, lat_dev,
                    vel_dev, u0, u1};
  ex->ring.push(r);
  ex->solve_us.push_back(static_cast<uint32_t>(solve_ns / 1000));
  ex->cycles++;
}

void rt_stats(void* h, Stats* out) {
  auto* ex = static_cast<Executor*>(h);
  out->cycles = ex->cycles;
  out->deadline_misses = ex->deadline_misses;
  out->dropped_records = ex->ring.dropped.load();
  std::vector<uint32_t> v = ex->solve_us;
  out->solve_ms_p50 = percentile(v, 0.5);
  out->solve_ms_p99 = percentile(v, 0.99);
  out->solve_ms_max = v.empty() ? 0.0 : *std::max_element(v.begin(), v.end()) / 1000.0;
  double sum = 0;
  for (uint32_t x : v) sum += x;
  out->solve_ms_mean = v.empty() ? 0.0 : sum / v.size() / 1000.0;
}

// Drain up to max_n telemetry records into a packed buffer; returns count.
uint64_t rt_drain(void* h, void* out, uint64_t max_n) {
  auto* ex = static_cast<Executor*>(h);
  return ex->ring.pop(static_cast<TelemetryRecord*>(out), max_n);
}

// Append all drained records to a binary file (packed structs).
uint64_t rt_export(void* h, const char* path) {
  auto* ex = static_cast<Executor*>(h);
  FILE* f = fopen(path, "ab");
  if (!f) return 0;
  TelemetryRecord r;
  uint64_t n = 0;
  while (ex->ring.pop(&r, 1) == 1) {
    fwrite(&r, sizeof(r), 1, f);
    ++n;
  }
  fclose(f);
  return n;
}

uint64_t rt_record_size() { return sizeof(TelemetryRecord); }

}  // extern "C"
