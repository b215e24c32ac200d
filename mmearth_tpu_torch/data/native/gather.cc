// Native batch-gather core for the mmpack loader.
//
// The training-path equivalent of FFCV's compiled loader inner loop
// (reference mmearth_dataset.py:300-316 relies on the ffcv native pipeline):
// copy a batch of rows out of a memory-mapped tensor into a contiguous
// pinned-side staging buffer, with a thread pool splitting the rows and an
// optional OS readahead hint for the next batch's rows.
//
// Exposed as a plain C ABI for ctypes (no pybind11 needed).
//
// Built by mmearth_tpu_torch/data/native/__init__.py at first use:
// g++ -O3 -shared -fPIC -std=c++17 -pthread gather.cc
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__unix__) || defined(__APPLE__)
#include <sys/mman.h>
#include <unistd.h>
#endif

extern "C" {

// Copy rows src[idx[i]] -> dst[i] for i in [0, n).  row_bytes is the stride
// of one row in both src and dst.  n_threads <= 0 selects the hardware
// concurrency.
void mm_gather_rows(const uint8_t* src, uint8_t* dst, uint64_t row_bytes,
                    const int64_t* idx, uint64_t n, int n_threads) {
  if (n == 0) return;
  unsigned hw = std::thread::hardware_concurrency();
  unsigned workers = n_threads > 0 ? static_cast<unsigned>(n_threads)
                                   : (hw ? hw : 1u);
  if (workers > n) workers = static_cast<unsigned>(n);

  auto copy_range = [&](uint64_t lo, uint64_t hi) {
    for (uint64_t i = lo; i < hi; ++i) {
      std::memcpy(dst + i * row_bytes,
                  src + static_cast<uint64_t>(idx[i]) * row_bytes, row_bytes);
    }
  };

  if (workers <= 1) {
    copy_range(0, n);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(workers);
  uint64_t chunk = (n + workers - 1) / workers;
  for (unsigned w = 0; w < workers; ++w) {
    uint64_t lo = w * chunk;
    uint64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    pool.emplace_back(copy_range, lo, hi);
  }
  for (auto& t : pool) t.join();
}

// Hint the OS to page in the rows of an upcoming batch (overlap IO with the
// current batch's compute).  Safe no-op where madvise is unavailable.
void mm_prefetch_rows(const uint8_t* src, uint64_t row_bytes,
                      const int64_t* idx, uint64_t n) {
#if defined(__unix__)
  long page = sysconf(_SC_PAGESIZE);
  if (page <= 0) page = 4096;
  for (uint64_t i = 0; i < n; ++i) {
    uintptr_t begin = reinterpret_cast<uintptr_t>(src) +
                      static_cast<uint64_t>(idx[i]) * row_bytes;
    uintptr_t aligned = begin & ~static_cast<uintptr_t>(page - 1);
    size_t len = static_cast<size_t>(begin - aligned) + row_bytes;
    madvise(reinterpret_cast<void*>(aligned), len, MADV_WILLNEED);
  }
#else
  (void)src; (void)row_bytes; (void)idx; (void)n;
#endif
}

}  // extern "C"
