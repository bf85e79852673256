// Native data-loading pipeline of normflows_tpu_torch (a copy of the JAX
// package's csrc/nf_dataloader.cpp: the same producer, so that both packages
// give the same batches bit for bit).
//
// The reference's image pipeline is a torch DataLoader with Python-side
// Scale/Jitter/Logit transforms (reference utils/preprocessing.py:4-57,
// examples/glow.ipynb data cells).  This is a multithreaded C++ producer that
// turns uint8 image batches into float32 host tensors -- per-epoch
// shuffling, uniform dequantization jitter, 255/256 scaling, and the logit
// transform -- all off the Python thread; data/native_loader.py's
// prefetch_to_device then copies them to the card from pinned memory.
//
// Design notes:
//  * Zero-copy input: the loader borrows the caller's uint8 buffer (the
//    Python wrapper keeps the array alive).
//  * Deterministic independent of thread count: batch b of epoch e uses an
//    RNG seeded by hash(seed, e, b); shuffling uses an RNG seeded by
//    hash(seed, e).  splitmix64 + xoshiro256** (public-domain algorithms).
//  * Bounded queue of pre-transformed batches (depth = prefetch) so the
//    consumer (device transfer) and producers run concurrently.
//
// C API only -- bound from Python via ctypes.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <memory>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- RNG ----
static inline uint64_t splitmix64(uint64_t& x) {
  uint64_t z = (x += 0x9E3779B97F4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

struct Xoshiro256ss {
  uint64_t s[4];
  explicit Xoshiro256ss(uint64_t seed) {
    for (int i = 0; i < 4; ++i) s[i] = splitmix64(seed);
  }
  static inline uint64_t rotl(uint64_t x, int k) {
    return (x << k) | (x >> (64 - k));
  }
  inline uint64_t next() {
    const uint64_t result = rotl(s[1] * 5, 7) * 9;
    const uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  // uniform in [0, 1)
  inline double uniform() { return (next() >> 11) * 0x1.0p-53; }
  // uniform integer in [0, n)
  inline uint64_t below(uint64_t n) { return next() % n; }
};

static inline uint64_t mix3(uint64_t a, uint64_t b, uint64_t c) {
  uint64_t x = a;
  x ^= splitmix64(b);
  x ^= splitmix64(c) << 1;
  return splitmix64(x);
}

// ------------------------------------------------------------- loader ----
struct Batch {
  int64_t epoch;
  int64_t index;  // batch index within epoch
  std::vector<float> x;
  std::vector<int64_t> y;
};

struct Loader {
  // immutable config
  const uint8_t* data = nullptr;   // (n, item_elems) row-major, borrowed
  const int64_t* labels = nullptr; // (n,) or null, borrowed
  int64_t n = 0;
  int64_t item_elems = 0;
  int64_t batch = 0;
  uint64_t seed = 0;
  bool shuffle = true;
  bool drop_last = true;
  // transform config
  double scale = 255.0 / 256.0;  // applied after /255 normalization
  bool jitter = true;            // + U(0, 1/256)
  bool logit = true;             // log(x'/(1-x')), x' = alpha + (1-alpha)x
  double alpha = 0.05;

  // pipeline state
  int64_t batches_per_epoch = 0;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  std::deque<Batch> queue;
  size_t prefetch = 4;
  std::atomic<bool> stop{false};

  // work assignment: a global monotone batch counter; workers claim ticket
  // t and produce batch (t / bpe, t % bpe).  Completed batches are released
  // to the consumer strictly in ticket order.
  std::atomic<int64_t> next_ticket{0};
  int64_t next_release = 0;  // guarded by mu
  std::deque<Batch> done;    // out-of-order completions, guarded by mu

  // per-epoch shuffle cache; workers of nearby epochs may overlap on tiny
  // datasets, so hand out shared ownership (immutable once built).
  std::mutex perm_mu;
  std::deque<std::pair<int64_t, std::shared_ptr<const std::vector<int64_t>>>>
      perm_cache;

  std::shared_ptr<const std::vector<int64_t>> permutation(int64_t epoch) {
    std::lock_guard<std::mutex> lk(perm_mu);
    for (auto& e : perm_cache)
      if (e.first == epoch) return e.second;
    auto p = std::make_shared<std::vector<int64_t>>(n);
    for (int64_t i = 0; i < n; ++i) (*p)[i] = i;
    if (shuffle) {
      Xoshiro256ss rng(mix3(seed, static_cast<uint64_t>(epoch), 0xA5A5A5A5ULL));
      for (int64_t i = n - 1; i > 0; --i) {
        int64_t j = static_cast<int64_t>(rng.below(static_cast<uint64_t>(i + 1)));
        std::swap((*p)[i], (*p)[j]);
      }
    }
    perm_cache.emplace_back(epoch, p);
    while (perm_cache.size() > 4) perm_cache.pop_front();
    return perm_cache.back().second;
  }

  void transform_item(const uint8_t* src, float* dst, Xoshiro256ss& rng) const {
    const double a = alpha, one_m_a = 1.0 - alpha;
    for (int64_t k = 0; k < item_elems; ++k) {
      double v = static_cast<double>(src[k]) / 255.0;
      v *= scale;
      if (jitter) v += rng.uniform() * (1.0 / 256.0);
      if (logit) {
        double xp = a + one_m_a * v;
        v = std::log(xp / (1.0 - xp));
      }
      dst[k] = static_cast<float>(v);
    }
  }

  void produce(int64_t ticket) {
    const int64_t epoch = ticket / batches_per_epoch;
    const int64_t bidx = ticket % batches_per_epoch;
    const auto perm_ptr = permutation(epoch);
    const auto& perm = *perm_ptr;

    Batch b;
    b.epoch = epoch;
    b.index = bidx;
    const int64_t start = bidx * batch;
    const int64_t count =
        drop_last ? batch : std::min(batch, n - start);
    b.x.resize(static_cast<size_t>(count) * item_elems);
    if (labels) b.y.resize(count);
    Xoshiro256ss rng(mix3(seed, static_cast<uint64_t>(epoch),
                          static_cast<uint64_t>(bidx) + 17));
    for (int64_t i = 0; i < count; ++i) {
      const int64_t src_row = perm[start + i];
      transform_item(data + src_row * item_elems,
                     b.x.data() + i * item_elems, rng);
      if (labels) b.y[static_cast<size_t>(i)] = labels[src_row];
    }

    // release in ticket order.  NOTE: the releasable batch must be popped
    // from `done` BEFORE waiting for queue room — the wait drops the lock,
    // and another worker scanning `done` could otherwise release the same
    // element and invalidate our iterator.
    std::unique_lock<std::mutex> lk(mu);
    done.push_back(std::move(b));
    for (;;) {
      auto it = std::find_if(done.begin(), done.end(), [&](const Batch& d) {
        return d.epoch * batches_per_epoch + d.index == next_release;
      });
      if (it == done.end()) break;
      Batch rel = std::move(*it);
      done.erase(it);
      cv_produce.wait(lk, [&] {
        return stop.load() || queue.size() < prefetch;
      });
      if (stop.load()) return;
      queue.push_back(std::move(rel));
      ++next_release;
      cv_consume.notify_one();
    }
  }

  void worker_main() {
    while (!stop.load()) {
      // claim work only if the pipeline has room (soft bound: queue +
      // in-flight tickets <= prefetch + workers)
      int64_t ticket = next_ticket.fetch_add(1);
      produce(ticket);
      if (stop.load()) return;
      // throttle: don't run far ahead of the consumer
      std::unique_lock<std::mutex> lk(mu);
      cv_produce.wait(lk, [&] {
        return stop.load() ||
               (next_ticket.load() - next_release) <
                   static_cast<int64_t>(prefetch + workers.size());
      });
    }
  }

  void start(int num_threads) {
    batches_per_epoch = drop_last ? n / batch : (n + batch - 1) / batch;
    if (batches_per_epoch <= 0) batches_per_epoch = 1;
    for (int t = 0; t < num_threads; ++t)
      workers.emplace_back([this] { worker_main(); });
  }

  // Blocking pop of the next in-order batch.  Returns item count.
  int64_t next(float* out_x, int64_t* out_y, int64_t* out_epoch) {
    Batch b;
    {
      std::unique_lock<std::mutex> lk(mu);
      cv_consume.wait(lk, [&] { return stop.load() || !queue.empty(); });
      if (stop.load() && queue.empty()) return -1;
      b = std::move(queue.front());
      queue.pop_front();
      cv_produce.notify_all();
    }
    const int64_t count = static_cast<int64_t>(
        b.x.size() / static_cast<size_t>(item_elems));
    std::memcpy(out_x, b.x.data(), b.x.size() * sizeof(float));
    if (out_y && !b.y.empty())
      std::memcpy(out_y, b.y.data(), b.y.size() * sizeof(int64_t));
    if (out_epoch) *out_epoch = b.epoch;
    return count;
  }

  void shutdown() {
    stop.store(true);
    cv_produce.notify_all();
    cv_consume.notify_all();
    for (auto& w : workers)
      if (w.joinable()) w.join();
    workers.clear();
  }
};

}  // namespace

extern "C" {

void* nf_loader_create(const uint8_t* data, const int64_t* labels, int64_t n,
                       int64_t item_elems, int64_t batch, uint64_t seed,
                       int num_threads, int shuffle, int drop_last,
                       double scale, int jitter, int logit, double alpha,
                       int prefetch) {
  if (!data || n <= 0 || item_elems <= 0 || batch <= 0) return nullptr;
  auto* L = new Loader();
  L->data = data;
  L->labels = labels;
  L->n = n;
  L->item_elems = item_elems;
  L->batch = batch;
  L->seed = seed;
  L->shuffle = shuffle != 0;
  L->drop_last = drop_last != 0;
  L->scale = scale;
  L->jitter = jitter != 0;
  L->logit = logit != 0;
  L->alpha = alpha;
  L->prefetch = prefetch > 0 ? static_cast<size_t>(prefetch) : 4;
  L->start(num_threads > 0 ? num_threads : 2);
  return L;
}

int64_t nf_loader_batches_per_epoch(void* handle) {
  return handle ? static_cast<Loader*>(handle)->batches_per_epoch : -1;
}

// Fills out_x (batch*item_elems floats) and optionally out_y (batch int64).
// Returns the number of items in the batch, or -1 after shutdown.
int64_t nf_loader_next(void* handle, float* out_x, int64_t* out_y,
                       int64_t* out_epoch) {
  if (!handle) return -1;
  return static_cast<Loader*>(handle)->next(out_x, out_y, out_epoch);
}

void nf_loader_destroy(void* handle) {
  if (!handle) return;
  auto* L = static_cast<Loader*>(handle);
  L->shutdown();
  delete L;
}

}  // extern "C"
