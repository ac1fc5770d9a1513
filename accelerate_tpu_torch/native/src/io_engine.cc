// Parallel file IO engine for the checkpoint / offload layer.
//
// The reference delegates all checkpoint IO to torch.save / safetensors /
// torch.distributed.checkpoint (reference checkpointing.py:62,
// utils/offload.py:85) — native code living in those engines.  Here the
// native layer is in-tree: multi-threaded pwrite/pread over aligned chunks,
// a segment writer used to lay out safetensors payloads without an extra
// host-side concatenation copy, and CRC32 integrity checksums.
//
// All entry points are plain C symbols driven through ctypes (no pybind11 in
// the image).  Every call releases the GIL for its whole duration by
// construction (ctypes foreign calls drop the GIL), so checkpoint writes
// overlap Python-side work.

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMinChunk = 4ull << 20;  // 4 MiB floor per IO op

// Clamp thread count: never more threads than chunks of >= kMinChunk.
int clamp_threads(uint64_t size, int nthreads) {
  if (nthreads < 1) nthreads = 1;
  uint64_t max_by_size = size / kMinChunk;
  if (max_by_size < 1) max_by_size = 1;
  if ((uint64_t)nthreads > max_by_size) nthreads = (int)max_by_size;
  return nthreads;
}

// Full pwrite loop (pwrite may write short).
int pwrite_all(int fd, const char* buf, uint64_t size, uint64_t off) {
  while (size > 0) {
    ssize_t n = ::pwrite(fd, buf, size, (off_t)off);
    if (n < 0) {
      if (errno == EINTR) continue;
      return errno;
    }
    buf += n;
    off += (uint64_t)n;
    size -= (uint64_t)n;
  }
  return 0;
}

int pread_all(int fd, char* buf, uint64_t size, uint64_t off) {
  while (size > 0) {
    ssize_t n = ::pread(fd, buf, size, (off_t)off);
    if (n < 0) {
      if (errno == EINTR) continue;
      return errno;
    }
    if (n == 0) return EIO;  // unexpected EOF
    buf += n;
    off += (uint64_t)n;
    size -= (uint64_t)n;
  }
  return 0;
}

// Run `fn(chunk_begin, chunk_size)` over [0, size) split across nthreads.
template <typename Fn>
int parallel_chunks(uint64_t size, int nthreads, Fn fn) {
  nthreads = clamp_threads(size, nthreads);
  if (nthreads == 1) return fn(0, size);
  std::atomic<int> err{0};
  std::vector<std::thread> workers;
  uint64_t chunk = (size + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    uint64_t begin = chunk * t;
    if (begin >= size) break;
    uint64_t len = std::min(chunk, size - begin);
    workers.emplace_back([&, begin, len] {
      int rc = fn(begin, len);
      if (rc != 0) {
        int expected = 0;
        err.compare_exchange_strong(expected, rc);
      }
    });
  }
  for (auto& w : workers) w.join();
  return err.load();
}

// Slicing-by-8 tables: crc32_table[0] is the byte-at-a-time table;
// crc32_table[k][b] advances byte b through k more zero bytes, so eight
// input bytes fold in with eight lookups (several times the byte loop's
// rate on a checkpoint of gigabytes, same checksum as zlib.crc32).
uint32_t crc32_table[8][256];
bool crc32_init = [] {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc32_table[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; ++i)
    for (int k = 1; k < 8; ++k)
      crc32_table[k][i] = (crc32_table[k - 1][i] >> 8) ^ crc32_table[0][crc32_table[k - 1][i] & 0xFF];
  return true;
}();

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// basic file ops
// ---------------------------------------------------------------------------

int64_t at_file_size(const char* path) {
  struct stat st;
  if (::stat(path, &st) != 0) return -(int64_t)errno;
  return (int64_t)st.st_size;
}

// Write `size` bytes to `path` (created/truncated) with `nthreads` parallel
// pwrite workers.  Returns 0 or errno.
int at_write_file(const char* path, const void* data, uint64_t size, int nthreads) {
  int fd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return errno;
  if (size > 0 && ::ftruncate(fd, (off_t)size) != 0) {
    int e = errno;
    ::close(fd);
    return e;
  }
  const char* buf = (const char*)data;
  int rc = parallel_chunks(size, nthreads, [&](uint64_t begin, uint64_t len) {
    return pwrite_all(fd, buf + begin, len, begin);
  });
  if (::close(fd) != 0 && rc == 0) rc = errno;
  return rc;
}

// Read `size` bytes at `offset` from `path` into `data` with parallel pread.
int at_read_file(const char* path, void* data, uint64_t size, uint64_t offset,
                 int nthreads) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return errno;
  char* buf = (char*)data;
  int rc = parallel_chunks(size, nthreads, [&](uint64_t begin, uint64_t len) {
    return pread_all(fd, buf + begin, len, offset + begin);
  });
  ::close(fd);
  return rc;
}

// Write n segments (ptrs[i], sizes[i]) at byte offsets[i] of `path` in one
// pass with a thread pool — the safetensors payload layout writer: header +
// each tensor goes straight from its own host buffer to its file offset, no
// concatenation copy.  total_size pre-truncates the file.
int at_write_file_segments(const char* path, const void** ptrs,
                           const uint64_t* sizes, const uint64_t* offsets,
                           int n, uint64_t total_size, int nthreads) {
  int fd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return errno;
  if (total_size > 0 && ::ftruncate(fd, (off_t)total_size) != 0) {
    int e = errno;
    ::close(fd);
    return e;
  }
  if (nthreads < 1) nthreads = 1;
  std::atomic<int> next{0};
  std::atomic<int> err{0};
  auto worker = [&] {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || err.load() != 0) return;
      int rc = pwrite_all(fd, (const char*)ptrs[i], sizes[i], offsets[i]);
      if (rc != 0) {
        int expected = 0;
        err.compare_exchange_strong(expected, rc);
      }
    }
  };
  int nw = std::min(nthreads, n > 0 ? n : 1);
  std::vector<std::thread> workers;
  for (int t = 1; t < nw; ++t) workers.emplace_back(worker);
  worker();
  for (auto& w : workers) w.join();
  if (::close(fd) != 0 && err.load() == 0) return errno;
  return err.load();
}

// Scatter-read: segment i of `path` at offsets[i] (sizes[i] bytes) into
// ptrs[i] — streaming checkpoint shards directly into per-tensor buffers.
int at_read_file_segments(const char* path, void** ptrs, const uint64_t* sizes,
                          const uint64_t* offsets, int n, int nthreads) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return errno;
  if (nthreads < 1) nthreads = 1;
  std::atomic<int> next{0};
  std::atomic<int> err{0};
  auto worker = [&] {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || err.load() != 0) return;
      int rc = pread_all(fd, (char*)ptrs[i], sizes[i], offsets[i]);
      if (rc != 0) {
        int expected = 0;
        err.compare_exchange_strong(expected, rc);
      }
    }
  };
  int nw = std::min(nthreads, n > 0 ? n : 1);
  std::vector<std::thread> workers;
  for (int t = 1; t < nw; ++t) workers.emplace_back(worker);
  worker();
  for (auto& w : workers) w.join();
  ::close(fd);
  return err.load();
}

// ---------------------------------------------------------------------------
// integrity
// ---------------------------------------------------------------------------

uint32_t at_crc32(const void* data, uint64_t size, uint32_t seed) {
  uint32_t c = seed ^ 0xFFFFFFFFu;
  const unsigned char* p = (const unsigned char*)data;
  uint64_t i = 0;
  for (; i + 8 <= size; i += 8) {  // little-endian hosts (x86-64, aarch64)
    uint32_t lo, hi;
    std::memcpy(&lo, p + i, 4);
    std::memcpy(&hi, p + i + 4, 4);
    lo ^= c;
    c = crc32_table[7][lo & 0xFF] ^ crc32_table[6][(lo >> 8) & 0xFF] ^
        crc32_table[5][(lo >> 16) & 0xFF] ^ crc32_table[4][lo >> 24] ^
        crc32_table[3][hi & 0xFF] ^ crc32_table[2][(hi >> 8) & 0xFF] ^
        crc32_table[1][(hi >> 16) & 0xFF] ^ crc32_table[0][hi >> 24];
  }
  for (; i < size; ++i)
    c = crc32_table[0][(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
// aligned host staging buffers
// ---------------------------------------------------------------------------

void* at_aligned_alloc(uint64_t size, uint64_t align) {
  if (align < 64) align = 64;
  uint64_t rounded = (size + align - 1) / align * align;
  return ::aligned_alloc(align, rounded);
}

void at_aligned_free(void* p) { ::free(p); }

}  // extern "C"
