// Native data-loading runtime for the hybrid framework.
//
// Role parity with the reference's native IO layer (NetCDF-C/HDF5 + MPI-IO
// parallel hyperslab readers, mod_io.f90:1905-2282, and the direct-access
// boundary-file reader load_boundary_file, ini_inbcon.f90:463-495): the hot
// host-side paths — boundary record decoding and per-region training-data
// gathers — run in C++ with mmap'd files and a std::thread worker pool, so
// the Python feed never serializes on the GIL.
//
// Exposed C ABI (consumed via ctypes from speedyml/io/native_loader.py):
//   si_read_records   : little-endian f32 records -> f64 grid (lat-flipped,
//                       missing values zeroed)
//   si_stream_open/close : mmap a raw f32 (T, width) series cache
//   si_stream_gather  : out[t, r, j] = series[t0 + t, idx[r, j]]
//                       (the reference's per-region halo hyperslab read)

#include <atomic>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Stream {
  const float *data = nullptr;   // mmap'd base
  size_t bytes = 0;
  int64_t T = 0;
  int64_t width = 0;
  int fd = -1;
};

int hardware_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(n);
}

// run fn(i) for i in [0, n) over a worker pool
template <typename F>
void parallel_for(int64_t n, int threads, F fn) {
  if (n <= 0) return;
  int nw = std::min<int64_t>(threads, n);
  if (nw <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> pool;
  pool.reserve(nw);
  for (int w = 0; w < nw; ++w) {
    pool.emplace_back([&]() {
      for (;;) {
        int64_t i = next.fetch_add(1, std::memory_order_relaxed);
        if (i >= n) return;
        fn(i);
      }
    });
  }
  for (auto &t : pool) t.join();
}

}  // namespace

extern "C" {

// Decode a fort.2x-style file: nrec records of (il, ix) little-endian f32,
// written north->south; output f64 south->north with values <= -999 zeroed.
// Returns the number of records decoded, or -1 on error.
int64_t si_read_records(const char *path, int64_t ix, int64_t il,
                        double *out, int64_t max_records) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); return -1; }
  size_t bytes = static_cast<size_t>(st.st_size);
  int64_t per = ix * il;
  int64_t nrec = static_cast<int64_t>(bytes / (per * 4));
  if (nrec * per * 4 != static_cast<int64_t>(bytes)) { ::close(fd); return -1; }
  if (nrec > max_records) nrec = max_records;

  void *m = mmap(nullptr, bytes, PROT_READ, MAP_PRIVATE, fd, 0);
  ::close(fd);
  if (m == MAP_FAILED) return -1;
  const float *src = static_cast<const float *>(m);

  parallel_for(nrec, hardware_threads(), [&](int64_t r) {
    const float *rec = src + r * per;
    double *dst = out + r * per;
    for (int64_t j = 0; j < il; ++j) {
      const float *row = rec + (il - 1 - j) * ix;   // lat flip
      double *drow = dst + j * ix;
      for (int64_t i = 0; i < ix; ++i) {
        float v = row[i];
        drow[i] = (v <= -999.0f) ? 0.0 : static_cast<double>(v);
      }
    }
  });
  munmap(m, bytes);
  return nrec;
}

// ---- streaming series cache ----
void *si_stream_open(const char *path, int64_t T, int64_t width) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); return nullptr; }
  size_t need = static_cast<size_t>(T) * width * 4;
  if (static_cast<size_t>(st.st_size) < need) { ::close(fd); return nullptr; }
  void *m = mmap(nullptr, need, PROT_READ, MAP_PRIVATE, fd, 0);
  if (m == MAP_FAILED) { ::close(fd); return nullptr; }
  madvise(m, need, MADV_SEQUENTIAL);
  auto *s = new Stream;
  s->data = static_cast<const float *>(m);
  s->bytes = need;
  s->T = T;
  s->width = width;
  s->fd = fd;
  return s;
}

void si_stream_close(void *h) {
  auto *s = static_cast<Stream *>(h);
  if (!s) return;
  if (s->data) munmap(const_cast<float *>(s->data), s->bytes);
  if (s->fd >= 0) ::close(s->fd);
  delete s;
}

// out[t, r, j] = series[t0 + t, idx[r * n_idx + j]] for t in [0, nt),
// r in [0, nr), j in [0, n_idx). Parallel over time steps.
// Returns 0 on success, -1 on bounds error.
int si_stream_gather(void *h, const int32_t *idx, int64_t nr, int64_t n_idx,
                     int64_t t0, int64_t nt, float *out) {
  auto *s = static_cast<Stream *>(h);
  if (!s || t0 < 0 || t0 + nt > s->T) return -1;
  const int64_t w = s->width;
  parallel_for(nt, hardware_threads(), [&](int64_t t) {
    const float *row = s->data + (t0 + t) * w;
    float *dst = out + t * nr * n_idx;
    const int32_t *ip = idx;
    for (int64_t k = 0; k < nr * n_idx; ++k) dst[k] = row[ip[k]];
  });
  return 0;
}

// standalone gather from a caller-provided in-memory series (no mmap):
// used when the series was just produced by the model rather than cached.
int si_mem_gather(const float *series, int64_t T, int64_t width,
                  const int32_t *idx, int64_t nr, int64_t n_idx,
                  int64_t t0, int64_t nt, float *out) {
  if (t0 < 0 || t0 + nt > T) return -1;
  parallel_for(nt, hardware_threads(), [&](int64_t t) {
    const float *row = series + (t0 + t) * width;
    float *dst = out + t * nr * n_idx;
    for (int64_t k = 0; k < nr * n_idx; ++k) dst[k] = row[idx[k]];
  });
  return 0;
}

}  // extern "C"
