// Native coordination core for the eager (framework-shim) path.
//
// The PyTorch port's copy of horovod_tpu/_core/src/core.cc: the
// reference's C++ runtime pieces (reference layout, SURVEY.md section 3.1):
//   - HandleManager        (horovod/torch/handle_manager.cc)
//   - TensorQueue + cycle scheduler with tensor-fusion grouping
//                          (horovod/common/tensor_queue.cc + the
//                           RunLoopOnce negotiate->fuse cycle of
//                           horovod/common/operations.cc; negotiation
//                           itself is gone -- deterministic batches make
//                           every process's request set identical by
//                           construction)
//   - ResponseCache (LRU)  (horovod/common/response_cache.cc)
//   - Timeline writer      (horovod/common/timeline.cc writer thread)
//   - StallInspector       (horovod/common/stall_inspector.cc)
//
// The compute itself stays in torch.distributed (the Python callback
// dispatches fused collectives); this library owns the *runtime* concerns:
// thread-safe bookkeeping, the background cycle thread, batching policy,
// and trace output.  Exposed as a C ABI for ctypes (no pybind11 in the image).
//
// Build: g++ -O2 -std=c++17 -shared -fPIC -pthread core.cc -o libhvdcore.so

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdarg>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#if defined(__linux__)
#include <pthread.h>
#include <sched.h>
#endif
#include <list>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

double now_s() {
  return std::chrono::duration<double>(Clock::now().time_since_epoch())
      .count();
}

// ---------------------------------------------------------------------------
// Logging (HOROVOD_LOG_LEVEL parity: 0=trace .. 5=fatal, default warning).
// ---------------------------------------------------------------------------

std::atomic<int> g_log_level{3};

void logmsg(int level, const char* fmt, ...) {
  if (level < g_log_level.load(std::memory_order_relaxed)) return;
  static const char* names[] = {"TRACE", "DEBUG", "INFO",
                                "WARNING", "ERROR", "FATAL"};
  char buf[1024];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof(buf), fmt, ap);
  va_end(ap);
  fprintf(stderr, "[hvdcore %s] %s\n",
          names[level < 0 ? 0 : (level > 5 ? 5 : level)], buf);
}

// ---------------------------------------------------------------------------
// HandleManager
// ---------------------------------------------------------------------------

struct HandleEntry {
  bool done = false;
  int status = 0;  // 0 ok; nonzero = error code
  std::string error;
  double created_s = now_s();
};

class HandleManager {
 public:
  int Create() {
    std::lock_guard<std::mutex> g(m_);
    int h = next_++;
    table_.emplace(h, HandleEntry{});
    return h;
  }

  bool Done(int h, int status, const char* msg) {
    std::lock_guard<std::mutex> g(m_);
    auto it = table_.find(h);
    if (it == table_.end()) return false;
    it->second.done = true;
    it->second.status = status;
    it->second.error = msg ? msg : "";
    cv_.notify_all();
    return true;
  }

  // -1 unknown, 0 pending, 1 done
  int Poll(int h) {
    std::lock_guard<std::mutex> g(m_);
    auto it = table_.find(h);
    if (it == table_.end()) return -1;
    return it->second.done ? 1 : 0;
  }

  // status (0 ok, >0 op error); -2 timeout, -3 unknown handle
  int Wait(int h, double timeout_s) {
    std::unique_lock<std::mutex> lk(m_);
    auto it = table_.find(h);
    if (it == table_.end()) return -3;
    auto pred = [&] { return table_.at(h).done; };
    if (timeout_s < 0) {
      cv_.wait(lk, pred);
    } else if (!cv_.wait_for(lk, std::chrono::duration<double>(timeout_s),
                             pred)) {
      return -2;
    }
    return table_.at(h).status;
  }

  int ErrorMsg(int h, char* buf, int n) {
    std::lock_guard<std::mutex> g(m_);
    auto it = table_.find(h);
    if (it == table_.end() || n <= 0) return -1;
    snprintf(buf, n, "%s", it->second.error.c_str());
    return static_cast<int>(it->second.error.size());
  }

  void Release(int h) {
    std::lock_guard<std::mutex> g(m_);
    table_.erase(h);
  }

  int PendingCount() {
    std::lock_guard<std::mutex> g(m_);
    int n = 0;
    for (auto& kv : table_)
      if (!kv.second.done) n++;
    return n;
  }

  // Oldest pending handle age in seconds (stall inspection), 0 if none.
  double OldestPendingAge() {
    std::lock_guard<std::mutex> g(m_);
    double t = now_s(), oldest = 0.0;
    for (auto& kv : table_)
      if (!kv.second.done) oldest = std::max(oldest, t - kv.second.created_s);
    return oldest;
  }

 private:
  std::mutex m_;
  std::condition_variable cv_;
  std::unordered_map<int, HandleEntry> table_;
  int next_ = 1;
};

HandleManager g_handles;

// ---------------------------------------------------------------------------
// TensorQueue + cycle scheduler with fusion grouping
// ---------------------------------------------------------------------------

struct Request {
  int64_t id;
  std::string name;
  int dtype;
  int64_t nbytes;
  int handle;
  double enqueued_s;
};

typedef void (*BatchCallback)(const int64_t* ids, int n);

class CycleScheduler {
 public:
  // deterministic=1: multi-process mode.  Every process must cut
  // IDENTICAL fused batches (NCCL and gloo match collectives by issue
  // order), so time- and buffer-pressure-based dispatch is disabled --
  // batches are cut only at Flush() (synchronize(), a point every rank
  // reaches in the same order) and grouped in name-sorted order.  This replaces the
  // reference's cross-rank readiness negotiation with determinism by
  // construction.
  int Start(double cycle_ms, int64_t fusion_bytes, BatchCallback cb,
            double stall_warn_s, int deterministic) {
    std::lock_guard<std::mutex> g(m_);
    if (running_) return -1;
    cycle_s_ = cycle_ms / 1e3;
    fusion_bytes_ = fusion_bytes;
    cb_ = cb;
    stall_warn_s_ = stall_warn_s;
    deterministic_ = deterministic != 0;
    stop_ = false;
    flush_ = false;
    running_ = true;
    thread_ = std::thread([this] { Loop(); });
    PinThread(thread_);
    return 0;
  }

  // HOROVOD_THREAD_AFFINITY parity (reference env_parser.cc +
  // operations.cc): pin the background cycle thread to the named CPU so
  // it never migrates onto the cores feeding the device.  The reference
  // accepts a comma-separated per-thread list; this runtime has ONE
  // cycle thread, so the FIRST element applies.  Ignored when unset,
  // malformed, or out of range.
  static void PinThread(std::thread& t) {
#if defined(__linux__)
    const char* env = std::getenv("HOROVOD_THREAD_AFFINITY");
    if (!env || !*env) return;
    char* end = nullptr;
    long cpu = std::strtol(env, &end, 10);
    if (end == env || (*end != '\0' && *end != ',') ||
        cpu < 0 || cpu >= CPU_SETSIZE) return;
    cpu_set_t set;
    CPU_ZERO(&set);
    CPU_SET(static_cast<int>(cpu), &set);
    pthread_setaffinity_np(t.native_handle(), sizeof(set), &set);
#else
    (void)t;
#endif
  }

  void Stop() {
    {
      std::lock_guard<std::mutex> g(m_);
      if (!running_) return;
      stop_ = true;
      cv_.notify_all();
    }
    thread_.join();
    {
      std::lock_guard<std::mutex> g(m_);
      running_ = false;
    }
  }

  int64_t Enqueue(const char* name, int dtype, int64_t nbytes, int handle) {
    std::lock_guard<std::mutex> g(m_);
    if (!running_) return -1;
    int64_t id = next_id_++;
    queue_.push_back(
        Request{id, name ? name : "", dtype, nbytes, handle, now_s()});
    // A full fusion buffer is dispatched without waiting out the cycle
    // (matches the reference: a response is cut when the buffer fills).
    // Not in deterministic mode: arrival order may differ per process.
    pending_bytes_ += nbytes;
    if (!deterministic_ && pending_bytes_ >= fusion_bytes_) {
      flush_ = true;
      cv_.notify_all();
    }
    return id;
  }

  void Flush() {
    std::unique_lock<std::mutex> lk(m_);
    if (!running_) return;
    flush_ = true;
    // Watermark: this flush covers only requests already enqueued.  The
    // flag may be consumed by the cycle thread AFTER later requests
    // arrive (a second Flush() returns immediately on an empty queue but
    // leaves flush_ set); without the watermark that stale wakeup would
    // sweep up the next step's partially-enqueued gradients and the
    // fused bucket composition would diverge across processes.
    flush_upto_ = next_id_ - 1;
    cv_.notify_all();
    // Wait until everything covered by this flush has been dispatched --
    // including the callback having RUN (in_flight_), so callers can rely
    // on "flush returned => batches delivered".
    drained_cv_.wait(lk, [this] {
      return !running_ ||
             ((queue_.empty() || queue_.front().id > flush_upto_) &&
              in_flight_ == 0);
    });
  }

  int Pending() {
    std::lock_guard<std::mutex> g(m_);
    return static_cast<int>(queue_.size());
  }

  void UpdateTuning(double cycle_ms, int64_t fusion_bytes) {
    std::lock_guard<std::mutex> g(m_);
    if (cycle_ms > 0) cycle_s_ = cycle_ms / 1e3;
    if (fusion_bytes > 0) fusion_bytes_ = fusion_bytes;
  }

 private:
  void Loop() {
    for (;;) {
      std::vector<Request> batch;
      {
        std::unique_lock<std::mutex> lk(m_);
        cv_.wait_for(lk, std::chrono::duration<double>(cycle_s_),
                     [this] { return stop_ || flush_; });
        if (stop_ && queue_.empty()) break;
        if (deterministic_ && !flush_ && !stop_) {
          // Cycle tick without an explicit flush: stall-check only.
          lk.unlock();
          CheckStalls();
          continue;
        }
        flush_ = false;
        if (deterministic_ && !stop_) {
          // Deterministic mode: drain only up to the flush watermark
          // (see Flush()); requests enqueued after it belong to the
          // next synchronize and must not be swept into this batch.
          while (!queue_.empty() && queue_.front().id <= flush_upto_) {
            pending_bytes_ -= queue_.front().nbytes;
            batch.push_back(queue_.front());
            queue_.pop_front();
          }
        } else {
          batch.assign(queue_.begin(), queue_.end());
          queue_.clear();
          pending_bytes_ = 0;
        }
        if (!batch.empty()) ++in_flight_;
        drained_cv_.notify_all();
      }
      if (!batch.empty()) {
        Dispatch(batch);
        std::lock_guard<std::mutex> g(m_);
        --in_flight_;
        drained_cv_.notify_all();
      }
      CheckStalls();
    }
  }

  // Group by dtype, cutting a group at the fusion threshold, and hand each
  // group to the Python callback (which runs the fused collective).
  void Dispatch(const std::vector<Request>& batch) {
    std::map<int, std::vector<const Request*>> by_dtype;
    for (auto& r : batch) by_dtype[r.dtype].push_back(&r);
    for (auto& kv : by_dtype) {
      if (deterministic_) {
        // Name order is identical across processes even when
        // arrival order is not; sort so bucket composition matches.
        std::sort(kv.second.begin(), kv.second.end(),
                  [](const Request* a, const Request* b) {
                    return a->name < b->name;
                  });
      }
      std::vector<int64_t> ids;
      int64_t bytes = 0;
      for (const Request* r : kv.second) {
        if (!ids.empty() && bytes + r->nbytes > fusion_bytes_) {
          Emit(ids);
          ids.clear();
          bytes = 0;
        }
        ids.push_back(r->id);
        bytes += r->nbytes;
      }
      if (!ids.empty()) Emit(ids);
    }
  }

  void Emit(const std::vector<int64_t>& ids) {
    BatchCallback cb;
    {
      std::lock_guard<std::mutex> g(m_);
      cb = cb_;
    }
    if (cb) cb(ids.data(), static_cast<int>(ids.size()));
  }

  void CheckStalls() {
    if (stall_warn_s_ <= 0) return;
    double age = g_handles.OldestPendingAge();
    double t = now_s();
    if (age > stall_warn_s_ && t - last_stall_warn_s_ > stall_warn_s_) {
      last_stall_warn_s_ = t;
      logmsg(3,
             "stall inspector: a collective has been pending for %.1fs "
             "(threshold %.1fs) -- a peer may be stuck or the device "
             "wedged",
             age, stall_warn_s_);
    }
  }

  std::mutex m_;
  std::condition_variable cv_, drained_cv_;
  std::deque<Request> queue_;
  std::thread thread_;
  BatchCallback cb_ = nullptr;
  double cycle_s_ = 0.001;
  int64_t fusion_bytes_ = 64 << 20;
  int64_t pending_bytes_ = 0;
  double stall_warn_s_ = 60.0;
  double last_stall_warn_s_ = 0.0;
  int64_t next_id_ = 1;
  int64_t flush_upto_ = -1;
  int in_flight_ = 0;
  bool running_ = false, stop_ = false, flush_ = false;
  bool deterministic_ = false;
};

CycleScheduler g_sched;

// ---------------------------------------------------------------------------
// ResponseCache (LRU over request signatures)
// ---------------------------------------------------------------------------

class ResponseCache {
 public:
  void Configure(int capacity) {
    std::lock_guard<std::mutex> g(m_);
    capacity_ = capacity;
    EvictLocked();
  }

  int Lookup(const char* sig) {
    std::lock_guard<std::mutex> g(m_);
    auto it = index_.find(sig);
    if (it == index_.end()) {
      misses_++;
      return 0;
    }
    lru_.splice(lru_.begin(), lru_, it->second);
    hits_++;
    return 1;
  }

  void Insert(const char* sig) {
    std::lock_guard<std::mutex> g(m_);
    auto it = index_.find(sig);
    if (it != index_.end()) {
      lru_.splice(lru_.begin(), lru_, it->second);
      return;
    }
    lru_.emplace_front(sig);
    index_[lru_.front()] = lru_.begin();
    EvictLocked();
  }

  int Size() {
    std::lock_guard<std::mutex> g(m_);
    return static_cast<int>(lru_.size());
  }

  void Stats(int64_t* hits, int64_t* misses) {
    std::lock_guard<std::mutex> g(m_);
    *hits = hits_;
    *misses = misses_;
  }

 private:
  void EvictLocked() {
    while (capacity_ >= 0 && static_cast<int>(lru_.size()) > capacity_) {
      index_.erase(lru_.back());
      lru_.pop_back();
    }
  }

  std::mutex m_;
  std::list<std::string> lru_;
  std::unordered_map<std::string, std::list<std::string>::iterator> index_;
  int capacity_ = 1024;  // HOROVOD_CACHE_CAPACITY default
  int64_t hits_ = 0, misses_ = 0;
};

ResponseCache g_cache;

// ---------------------------------------------------------------------------
// Timeline writer (chrome://tracing JSON, background writer thread)
// ---------------------------------------------------------------------------

class TimelineWriter {
 public:
  int Open(const char* path) {
    std::lock_guard<std::mutex> g(m_);
    if (file_) return -1;
    file_ = fopen(path, "w");
    if (!file_) return -2;
    fputs("[\n", file_);
    first_ = true;
    stop_ = false;
    thread_ = std::thread([this] { Loop(); });
    return 0;
  }

  void Event(const char* name, const char* cat, char ph, double ts_us,
             double dur_us, int64_t tid) {
    char buf[512];
    if (ph == 'X') {
      snprintf(buf, sizeof(buf),
               "{\"name\": \"%s\", \"cat\": \"%s\", \"ph\": \"X\", "
               "\"ts\": %.3f, \"dur\": %.3f, \"pid\": 0, \"tid\": %lld}",
               name, cat, ts_us, dur_us, static_cast<long long>(tid));
    } else {
      snprintf(buf, sizeof(buf),
               "{\"name\": \"%s\", \"cat\": \"%s\", \"ph\": \"%c\", "
               "\"ts\": %.3f, \"pid\": 0, \"tid\": %lld}",
               name, cat, ph, ts_us, static_cast<long long>(tid));
    }
    std::lock_guard<std::mutex> g(m_);
    if (!file_) return;
    events_.emplace_back(buf);
    cv_.notify_one();
  }

  void Close() {
    std::thread t;
    {
      std::lock_guard<std::mutex> g(m_);
      if (!file_) return;
      stop_ = true;
      cv_.notify_all();
      t = std::move(thread_);
    }
    t.join();
    std::lock_guard<std::mutex> g(m_);
    DrainLocked();
    fputs("\n]\n", file_);
    fclose(file_);
    file_ = nullptr;
  }

 private:
  void Loop() {
    for (;;) {
      std::unique_lock<std::mutex> lk(m_);
      cv_.wait_for(lk, std::chrono::milliseconds(100),
                   [this] { return stop_ || !events_.empty(); });
      if (stop_) return;  // final drain happens in Close() under lock
      DrainLocked();
      fflush(file_);
    }
  }

  void DrainLocked() {
    for (auto& e : events_) {
      if (!first_) fputs(",\n", file_);
      first_ = false;
      fputs(e.c_str(), file_);
    }
    events_.clear();
  }

  std::mutex m_;
  std::condition_variable cv_;
  std::thread thread_;
  std::deque<std::string> events_;
  FILE* file_ = nullptr;
  bool first_ = true, stop_ = false;
};

TimelineWriter g_timeline;

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

const char* hvd_core_version() { return "hvdcore 1.0 (torch port)"; }

void hvd_set_log_level(int level) { g_log_level.store(level); }

int hvd_handle_create() { return g_handles.Create(); }
int hvd_handle_done(int h, int status, const char* msg) {
  return g_handles.Done(h, status, msg) ? 0 : -1;
}
int hvd_handle_poll(int h) { return g_handles.Poll(h); }
int hvd_handle_wait(int h, double timeout_s) {
  return g_handles.Wait(h, timeout_s);
}
int hvd_handle_error(int h, char* buf, int n) {
  return g_handles.ErrorMsg(h, buf, n);
}
void hvd_handle_release(int h) { g_handles.Release(h); }
int hvd_handle_pending() { return g_handles.PendingCount(); }

int hvd_sched_start(double cycle_ms, long long fusion_bytes,
                    void (*cb)(const long long*, int),
                    double stall_warn_s, int deterministic) {
  return g_sched.Start(cycle_ms, fusion_bytes,
                       reinterpret_cast<BatchCallback>(cb), stall_warn_s,
                       deterministic);
}
void hvd_sched_stop() { g_sched.Stop(); }
long long hvd_sched_enqueue(const char* name, int dtype, long long nbytes,
                            int handle) {
  return g_sched.Enqueue(name, dtype, nbytes, handle);
}
void hvd_sched_flush() { g_sched.Flush(); }
int hvd_sched_pending() { return g_sched.Pending(); }
void hvd_sched_update_tuning(double cycle_ms, long long fusion_bytes) {
  g_sched.UpdateTuning(cycle_ms, fusion_bytes);
}

void hvd_cache_configure(int capacity) { g_cache.Configure(capacity); }
int hvd_cache_lookup(const char* sig) { return g_cache.Lookup(sig); }
void hvd_cache_insert(const char* sig) { g_cache.Insert(sig); }
int hvd_cache_size() { return g_cache.Size(); }
void hvd_cache_stats(long long* hits, long long* misses) {
  int64_t h, m;
  g_cache.Stats(&h, &m);
  *hits = h;
  *misses = m;
}

int hvd_timeline_open(const char* path) { return g_timeline.Open(path); }
void hvd_timeline_event(const char* name, const char* cat, char ph,
                        double ts_us, double dur_us, long long tid) {
  g_timeline.Event(name, cat, ph, ts_us, dur_us, tid);
}
void hvd_timeline_close() { g_timeline.Close(); }

}  // extern "C"
