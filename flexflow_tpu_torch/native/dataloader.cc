// Native batch-staging engine for the training data pipeline.
//
// A copy of flexflow_tpu/native/dataloader.cc, the JAX package's engine,
// so that both draw the same order for a seed.  Reference: the C++
// dataloaders of the reference runtime (src/loc/loader.cc +
// SingleDataLoader): a worker thread gathers shuffled batches into
// staging buffers so the accelerator never waits on host-side indexing.
// The Python DataLoader hands this engine a view of the (row-major)
// dataset; the worker memcpys the permuted rows of upcoming batches into a
// bounded queue of staging buffers WITHOUT holding the GIL, and the Python
// side copies each ready buffer and places it on the devices.
//
// Plain C ABI, driven via ctypes from flexflow_tpu_torch/data/native.py,
// which builds it with g++ into build/native/ at first use.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Batch {
  std::vector<uint8_t> x;
  std::vector<uint8_t> y;
  int64_t epoch;
  int64_t index;  // batch index within the epoch
};

struct Loader {
  const uint8_t* x;       // [n, row_bytes] row-major dataset (borrowed)
  const uint8_t* y;       // [n, label_bytes] labels (borrowed)
  int64_t n;
  int64_t row_bytes;
  int64_t label_bytes;
  int64_t batch;
  int64_t batches_per_epoch;
  bool shuffle;
  uint64_t seed;

  std::thread worker;
  std::mutex mu;
  std::condition_variable ready_cv;   // consumer waits: queue non-empty
  std::condition_variable space_cv;   // producer waits: queue below depth
  std::queue<Batch> queue;
  size_t depth;
  std::atomic<bool> stop{false};
  Batch current;  // last batch handed to the consumer (owns the memory)

  void run() {
    std::mt19937_64 rng(seed);
    std::vector<int64_t> perm(n);
    for (int64_t i = 0; i < n; ++i) perm[i] = i;
    for (int64_t epoch = 0;; ++epoch) {
      if (shuffle) {
        // Fisher-Yates with the engine's own stream: reproducible for a
        // given seed, independent of Python's RNG state
        for (int64_t i = n - 1; i > 0; --i) {
          std::uniform_int_distribution<int64_t> d(0, i);
          std::swap(perm[i], perm[d(rng)]);
        }
      }
      for (int64_t b = 0; b < batches_per_epoch; ++b) {
        Batch out;
        out.epoch = epoch;
        out.index = b;
        out.x.resize(batch * row_bytes);
        out.y.resize(batch * label_bytes);
        for (int64_t j = 0; j < batch; ++j) {
          const int64_t src = perm[b * batch + j];
          std::memcpy(out.x.data() + j * row_bytes, x + src * row_bytes,
                      row_bytes);
          std::memcpy(out.y.data() + j * label_bytes, y + src * label_bytes,
                      label_bytes);
        }
        std::unique_lock<std::mutex> lk(mu);
        space_cv.wait(lk, [&] { return queue.size() < depth || stop; });
        if (stop) return;
        queue.push(std::move(out));
        ready_cv.notify_one();
      }
    }
  }
};

}  // namespace

extern "C" {

// Create a loader over borrowed host buffers (caller keeps them alive).
// Returns an opaque handle.
void* ffdl_create(const void* x, const void* y, int64_t n, int64_t row_bytes,
                  int64_t label_bytes, int64_t batch, int32_t prefetch,
                  int32_t shuffle, uint64_t seed) {
  if (n <= 0 || batch <= 0 || batch > n || row_bytes <= 0) return nullptr;
  auto* l = new Loader();
  l->x = static_cast<const uint8_t*>(x);
  l->y = static_cast<const uint8_t*>(y);
  l->n = n;
  l->row_bytes = row_bytes;
  l->label_bytes = label_bytes;
  l->batch = batch;
  l->batches_per_epoch = n / batch;
  l->shuffle = shuffle != 0;
  l->seed = seed;
  l->depth = prefetch > 0 ? static_cast<size_t>(prefetch) : 1;
  l->worker = std::thread([l] { l->run(); });
  return l;
}

int64_t ffdl_batches_per_epoch(void* handle) {
  return static_cast<Loader*>(handle)->batches_per_epoch;
}

// Block until the next staged batch is ready; returns pointers valid until
// the NEXT ffdl_next/ffdl_destroy call.  Returns the epoch number.
int64_t ffdl_next(void* handle, const void** out_x, const void** out_y) {
  auto* l = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(l->mu);
  l->ready_cv.wait(lk, [&] { return !l->queue.empty(); });
  l->current = std::move(l->queue.front());
  l->queue.pop();
  l->space_cv.notify_one();
  *out_x = l->current.x.data();
  *out_y = l->current.y.data();
  return l->current.epoch;
}

void ffdl_destroy(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(l->mu);
    l->stop = true;
  }
  l->space_cv.notify_all();
  l->worker.join();
  delete l;
}

}  // extern "C"
