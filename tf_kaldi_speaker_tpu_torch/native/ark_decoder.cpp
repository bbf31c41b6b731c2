// Native ark decode core for the training data pipeline: the port's copy of
// tf_kaldi_speaker_tpu/native/ark_decoder.cpp. Two changes: the CM decode
// computes in the numpy codec's order, p0 + (p25 - p0) * (v / 64) (the JAX
// copy computes p0 + ((p25 - p0) / 64) * v, which rounds differently in the
// top segment, where 63 is no power of two); and a CM row range that lies
// in a short span is read in one pread where the JAX copy issues one a
// column (pread_cm_rows).
//
// The reference framework delegates all native work to external Kaldi C++
// binaries; its own Python decode of compressed matrices (reference
// dataset/kaldi_io.py:814-867) is the host-side hot loop of training.
// This library re-provides that function natively: positioned partial
// reads (pread, thread-safe, shared fd cache) + piecewise-linear uint8
// dequantization, called from Python via ctypes.
//
// Exposed C ABI:
//   int tfks_decode_submat(path, offset, start, length, out, out_capacity)
//     -> ncols on success (out holds length*ncols floats, row-major)
//     -> negative error code on failure (see TFKS_ERR_*)
//   int tfks_close_all()  -> drop the fd cache (for tests / fork hygiene)

#include <array>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <thread>
#include <unistd.h>
#include <unordered_map>
#include <vector>

#define TFKS_ERR_OPEN -1
#define TFKS_ERR_HEADER -2
#define TFKS_ERR_RANGE -3
#define TFKS_ERR_CAPACITY -4
#define TFKS_ERR_IO -5

namespace {

std::mutex g_fd_mutex;
std::unordered_map<std::string, int> g_fd_cache;

int get_fd(const char *path) {
  std::lock_guard<std::mutex> lock(g_fd_mutex);
  auto it = g_fd_cache.find(path);
  if (it != g_fd_cache.end()) return it->second;
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -1;
  g_fd_cache.emplace(path, fd);
  return fd;
}

bool pread_full(int fd, void *buf, size_t n, int64_t off) {
  uint8_t *p = static_cast<uint8_t *>(buf);
  while (n > 0) {
    ssize_t r = ::pread(fd, p, n, off);
    if (r <= 0) return false;
    p += r;
    off += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

constexpr float kU16Scale = 1.52590218966964e-05f;  // range / 65535

// How much longer than the requested bytes a CM span read may be. CM stores
// its columns one after another, rows bytes each, so rows [start,
// start+length) of every column lie in the span from column 0's first
// requested byte to the last column's last: (cols - 1) * rows + length
// bytes. Reading that span costs one syscall and (rows - length) extra
// bytes a column; reading column by column costs cols syscalls and no extra
// byte. A chunk of a short utterance (rows a few times length, as in
// training on VoxCeleb-length segments) takes the span; a chunk of a long
// one (a 10-minute Fisher side, rows ~ 60,000) is read column by column,
// as the JAX copy reads every matrix. Overridable at build time
// (-DTFKS_CM_SPAN_FACTOR=0 reads every matrix column by column).
#ifndef TFKS_CM_SPAN_FACTOR
#define TFKS_CM_SPAN_FACTOR 4
#endif

// Rows [start, start+length) of every column of the CM matrix whose column
// data begins at data_pos. On success *cols_at points at column 0's rows and
// column c's are at (*cols_at)[c * *stride]. buf is reused by the calling
// thread and only grows.
bool pread_cm_rows(int fd, int64_t data_pos, int32_t rows, int32_t cols,
                   int32_t start, int32_t length, const uint8_t **cols_at,
                   size_t *stride) {
  thread_local std::vector<uint8_t> buf;
  const size_t need = static_cast<size_t>(cols) * length;
  if (need == 0) {
    *cols_at = buf.data();
    *stride = 0;
    return true;
  }
  const size_t span = static_cast<size_t>(cols - 1) * rows + length;
  const bool one_read = span <= static_cast<size_t>(TFKS_CM_SPAN_FACTOR) * need;
  const size_t n = one_read ? span : need;
  if (buf.size() < n) buf.resize(n);
  *cols_at = buf.data();
  if (one_read) {
    *stride = static_cast<size_t>(rows);
    return pread_full(fd, buf.data(), span, data_pos + start);
  }
  *stride = static_cast<size_t>(length);
  for (int32_t c = 0; c < cols; ++c) {
    const int64_t col_off = data_pos + static_cast<int64_t>(c) * rows + start;
    if (!pread_full(fd, buf.data() + static_cast<size_t>(c) * length,
                    static_cast<size_t>(length), col_off))
      return false;
  }
  return true;
}

struct GlobalHeader {
  float min_value;
  float range;
  int32_t num_rows;
  int32_t num_cols;
};

}  // namespace

extern "C" {

// Decode rows [start, start+length) of the matrix whose '\0B' flag sits at
// `offset` in `path`. Supports 'CM ' (only the requested rows of each
// column, or the short span that holds them: pread_cm_rows) and 'FM '
// (contiguous row range). Output is row-major float32 [length, ncols].
int tfks_decode_submat(const char *path, int64_t offset, int32_t start,
                       int32_t length, float *out, int64_t out_capacity) {
  int fd = get_fd(path);
  if (fd < 0) return TFKS_ERR_OPEN;

  char head[5];
  if (!pread_full(fd, head, 5, offset)) return TFKS_ERR_IO;
  if (head[0] != '\0' || head[1] != 'B') return TFKS_ERR_HEADER;
  int64_t pos = offset + 5;

  if (head[2] == 'C' && head[3] == 'M' && head[4] == ' ') {
    GlobalHeader gh;
    if (!pread_full(fd, &gh, sizeof(gh), pos)) return TFKS_ERR_IO;
    pos += sizeof(gh);
    const int32_t rows = gh.num_rows, cols = gh.num_cols;
    // Corrupt negative dims would pass the signed capacity check and then
    // drive a size_t-cast giant vector allocation (bad_alloc across the C
    // ABI aborts the process); reject them as a malformed header.
    if (rows < 0 || cols < 0) return TFKS_ERR_HEADER;
    if (start < 0 || length < 0 || start + length > rows) return TFKS_ERR_RANGE;
    if (static_cast<int64_t>(length) * cols > out_capacity) return TFKS_ERR_CAPACITY;

    std::vector<uint16_t> col_headers(static_cast<size_t>(cols) * 4);
    if (!pread_full(fd, col_headers.data(), col_headers.size() * 2, pos))
      return TFKS_ERR_IO;
    const int64_t data_pos = pos + static_cast<int64_t>(cols) * 8;

    const uint8_t *cols_at;
    size_t stride;
    if (!pread_cm_rows(fd, data_pos, rows, cols, start, length, &cols_at, &stride))
      return TFKS_ERR_IO;
    const float gmin = gh.min_value, gstep = gh.range * kU16Scale;
    for (int32_t c = 0; c < cols; ++c) {
      const float p0 = gmin + gstep * col_headers[c * 4 + 0];
      const float p25 = gmin + gstep * col_headers[c * 4 + 1];
      const float p75 = gmin + gstep * col_headers[c * 4 + 2];
      const float p100 = gmin + gstep * col_headers[c * 4 + 3];
      // The numpy codec's order (kio/ark.py _decode_cm_data), each
      // operation rounded to float32 on its own (built with
      // -ffp-contract=off): bit-equal to it and to the CUDA dequant.
      const float d_lo = p25 - p0, d_mid = p75 - p25, d_hi = p100 - p75;
      const uint8_t *colbuf = cols_at + static_cast<size_t>(c) * stride;
      for (int32_t r = 0; r < length; ++r) {
        const uint8_t v = colbuf[r];
        const float fv = static_cast<float>(v);
        float f;
        if (v <= 64)
          f = p0 + d_lo * (fv / 64.0f);
        else if (v <= 192)
          f = p25 + d_mid * ((fv - 64.0f) / 128.0f);
        else
          f = p75 + d_hi * ((fv - 192.0f) / 63.0f);
        out[static_cast<int64_t>(r) * cols + c] = f;
      }
    }
    return cols;
  }

  if (head[2] == 'F' && head[3] == 'M' && head[4] == ' ') {
    // '\4' rows(int32) '\4' cols(int32), then row-major float32 data.
    uint8_t dims[10];
    if (!pread_full(fd, dims, 10, pos)) return TFKS_ERR_IO;
    int32_t rows, cols;
    std::memcpy(&rows, dims + 1, 4);
    std::memcpy(&cols, dims + 6, 4);
    if (rows < 0 || cols < 0) return TFKS_ERR_HEADER;
    if (start < 0 || length < 0 || start + length > rows) return TFKS_ERR_RANGE;
    if (static_cast<int64_t>(length) * cols > out_capacity) return TFKS_ERR_CAPACITY;
    const int64_t data_pos = pos + 10 + static_cast<int64_t>(start) * cols * 4;
    if (!pread_full(fd, out, static_cast<size_t>(length) * cols * 4, data_pos))
      return TFKS_ERR_IO;
    return cols;
  }

  return TFKS_ERR_HEADER;
}

// Raw-codes read for the decode-on-device path: fills codes (uint8,
// row-major [length, ncols]) and headers (float32 [4, ncols] — dequantized
// p0/p25/p75/p100 per column) WITHOUT applying the piecewise mapping.
int tfks_read_codes(const char *path, int64_t offset, int32_t start,
                    int32_t length, uint8_t *codes, float *headers,
                    int64_t codes_capacity, int64_t headers_capacity) {
  int fd = get_fd(path);
  if (fd < 0) return TFKS_ERR_OPEN;
  char head[5];
  if (!pread_full(fd, head, 5, offset)) return TFKS_ERR_IO;
  if (head[0] != '\0' || head[1] != 'B') return TFKS_ERR_HEADER;
  if (!(head[2] == 'C' && head[3] == 'M' && head[4] == ' ')) return TFKS_ERR_HEADER;
  int64_t pos = offset + 5;
  GlobalHeader gh;
  if (!pread_full(fd, &gh, sizeof(gh), pos)) return TFKS_ERR_IO;
  pos += sizeof(gh);
  const int32_t rows = gh.num_rows, cols = gh.num_cols;
  if (rows < 0 || cols < 0) return TFKS_ERR_HEADER;
  if (start < 0 || length < 0 || start + length > rows) return TFKS_ERR_RANGE;
  if (static_cast<int64_t>(length) * cols > codes_capacity) return TFKS_ERR_CAPACITY;
  // headers is [4, cols] in the CALLER's column count; a corrupt header
  // claiming more columns than the caller allocated would overflow it
  // below even when length*cols fits the codes buffer.
  if (static_cast<int64_t>(cols) * 4 > headers_capacity) return TFKS_ERR_CAPACITY;

  std::vector<uint16_t> col_headers(static_cast<size_t>(cols) * 4);
  if (!pread_full(fd, col_headers.data(), col_headers.size() * 2, pos))
    return TFKS_ERR_IO;
  const float gmin = gh.min_value, gstep = gh.range * kU16Scale;
  for (int32_t k = 0; k < 4; ++k)
    for (int32_t c = 0; c < cols; ++c)
      headers[k * cols + c] = gmin + gstep * col_headers[c * 4 + k];

  const int64_t data_pos = pos + static_cast<int64_t>(cols) * 8;
  const uint8_t *cols_at;
  size_t stride;
  if (!pread_cm_rows(fd, data_pos, rows, cols, start, length, &cols_at, &stride))
    return TFKS_ERR_IO;
  for (int32_t c = 0; c < cols; ++c) {
    const uint8_t *colbuf = cols_at + static_cast<size_t>(c) * stride;
    for (int32_t r = 0; r < length; ++r)
      codes[static_cast<int64_t>(r) * cols + c] = colbuf[r];
  }
  return cols;
}

// Threaded batch variant (mirrors tfks_decode_batch).
int tfks_read_batch_codes(const char **paths, const int64_t *offsets,
                          const int32_t *starts, const int32_t *lengths,
                          int32_t n, int32_t stride_rows, int32_t cols,
                          uint8_t *codes_out, float *headers_out,
                          int32_t num_threads) {
  std::atomic<int32_t> next(0);
  std::atomic<int> err(0);
  std::atomic<int> got_cols(0);
  auto work = [&]() {
    while (true) {
      int32_t i = next.fetch_add(1);
      if (i >= n || err.load() != 0) return;
      uint8_t *cdst = codes_out + static_cast<int64_t>(i) * stride_rows * cols;
      float *hdst = headers_out + static_cast<int64_t>(i) * 4 * cols;
      int r = tfks_read_codes(paths[i], offsets[i], starts[i], lengths[i], cdst,
                              hdst, static_cast<int64_t>(stride_rows) * cols,
                              static_cast<int64_t>(cols) * 4);
      if (r < 0) {
        int expected = 0;
        err.compare_exchange_strong(expected, r);
      } else {
        got_cols.store(r);
        if (r != cols) {
          int expected = 0;
          err.compare_exchange_strong(expected, TFKS_ERR_HEADER);
        }
      }
    }
  };
  int nt = num_threads < 1 ? 1 : num_threads;
  if (nt == 1 || n == 1) {
    work();
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < nt; ++t) pool.emplace_back(work);
    for (auto &th : pool) th.join();
  }
  if (err.load() != 0) return err.load();
  return got_cols.load();
}

int tfks_close_all() {
  std::lock_guard<std::mutex> lock(g_fd_mutex);
  for (auto &kv : g_fd_cache) ::close(kv.second);
  g_fd_cache.clear();
  return 0;
}

// CRC32C (Castagnoli, the LevelDB/TensorBundle checksum polynomial) over a
// byte buffer. The TF-checkpoint exporter (kio/tf_bundle.py) checksums every
// tensor plus each SSTable block; the pure-Python byte loop runs at ~1 MB/s,
// this runs at memory bandwidth (SSE4.2 hardware CRC when -march=native
// provides it, slice-by-table otherwise). Returns the UNMASKED crc;
// LevelDB masking stays in Python.
#if defined(__SSE4_2__)
#include <nmmintrin.h>
#endif

uint32_t tfks_crc32c(const uint8_t *data, int64_t len) {
  uint32_t crc = 0xFFFFFFFFu;
#if defined(__SSE4_2__)
  while (len >= 8) {
    uint64_t chunk;
    std::memcpy(&chunk, data, 8);
    crc = static_cast<uint32_t>(
        _mm_crc32_u64(static_cast<uint64_t>(crc), chunk));
    data += 8;
    len -= 8;
  }
  while (len-- > 0) crc = _mm_crc32_u8(crc, *data++);
#else
  static const auto table = [] {
    std::array<uint32_t, 256> t{};
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1u) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
      t[i] = c;
    }
    return t;
  }();
  for (int64_t i = 0; i < len; ++i)
    crc = table[(crc ^ data[i]) & 0xFFu] ^ (crc >> 8);
#endif
  return crc ^ 0xFFFFFFFFu;
}

// Decode a whole batch in one call: item i fills out[i * stride_rows * cols]
// with rows [starts[i], starts[i]+lengths[i]) of the matrix at
// paths[i]:offsets[i]. A small thread pool overlaps the reads of
// different items (the reference needed 16 loader *processes* to do this
// in Python, data_loader.py:377-394). Returns ncols on success, negative
// error code (of the first failing item) otherwise.
int tfks_decode_batch(const char **paths, const int64_t *offsets,
                      const int32_t *starts, const int32_t *lengths,
                      int32_t n, int32_t stride_rows, int32_t cols,
                      float *out, int32_t num_threads) {
  std::atomic<int32_t> next(0);
  std::atomic<int> err(0);
  std::atomic<int> got_cols(0);

  auto work = [&]() {
    while (true) {
      int32_t i = next.fetch_add(1);
      if (i >= n || err.load() != 0) return;
      float *dst = out + static_cast<int64_t>(i) * stride_rows * cols;
      int r = tfks_decode_submat(paths[i], offsets[i], starts[i], lengths[i],
                                 dst, static_cast<int64_t>(stride_rows) * cols);
      if (r < 0) {
        int expected = 0;
        err.compare_exchange_strong(expected, r);
      } else {
        got_cols.store(r);
        if (r != cols) {
          int expected = 0;
          err.compare_exchange_strong(expected, TFKS_ERR_HEADER);
        }
      }
    }
  };

  int nt = num_threads < 1 ? 1 : num_threads;
  if (nt == 1 || n == 1) {
    work();
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < nt; ++t) pool.emplace_back(work);
    for (auto &th : pool) th.join();
  }
  if (err.load() != 0) return err.load();
  return got_cols.load();
}

}  // extern "C"
