// The port's native MAT-file (Level 5) reader: a copy of the JAX package's
// native/dasmat.cpp with the same C interface and error codes, bound with
// ctypes by dasmtl_torch/data/native.py and built there with g++ on first
// use (apart from the CUDA library: no nvcc is needed).
//
// Native MAT-file (Level 5) reader + multithreaded batch loader.
//
// The reference's data layer bottoms out in scipy.io.loadmat's C parser,
// called one file at a time from Python under the GIL (reference
// dataset_preparation.py:263,312 — eager preload loop and per-__getitem__
// loads; DataLoader num_workers=0, utils.py:154-156, so there is no
// parallelism at all).  This library is the native data runtime:
// a minimal MAT-5 parser for the dataset's array layout plus a std::thread
// fan-out that fills a preallocated [N, rows, cols] float32 batch buffer in
// parallel, GIL-free, saturating host cores during dataset preload and
// lazy-disk gathers.
//
// Supported MAT subset (everything the DAS datasets use; anything else
// returns an error and the Python wrapper falls back to scipy):
//   - Level 5 MAT files (128-byte header), little-endian
//   - top-level miMATRIX elements, plus zlib-wrapped miCOMPRESSED elements
//   - 2-D real dense arrays of class double/single/(u)int8/16/32
//   - named-variable lookup (the reference looks up key 'data',
//     dataset_preparation.py:54-70)
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libdasmat.so dasmat.cpp -lz -pthread

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

// ---- error codes (mirrored in dasmtl_torch/data/native.py) ----------------------
enum {
  DAS_OK = 0,
  DAS_EIO = 1,        // cannot read file
  DAS_EFORMAT = 2,    // not a MAT-5 file / parse error
  DAS_ENOTFOUND = 3,  // key not present
  DAS_ESHAPE = 4,     // dims mismatch caller's buffer
  DAS_EUNSUPPORTED = 5,  // element kind outside the supported subset
  DAS_EZLIB = 6,      // decompression failure
};

// MAT-5 data types
enum {
  miINT8 = 1, miUINT8 = 2, miINT16 = 3, miUINT16 = 4, miINT32 = 5,
  miUINT32 = 6, miSINGLE = 7, miDOUBLE = 9, miMATRIX = 14, miCOMPRESSED = 15,
};
// mxArray classes
enum {
  mxDOUBLE_CLASS = 6, mxSINGLE_CLASS = 7, mxINT8_CLASS = 8,
  mxUINT8_CLASS = 9, mxINT16_CLASS = 10, mxUINT16_CLASS = 11,
  mxINT32_CLASS = 12, mxUINT32_CLASS = 13,
};

struct Element {
  uint32_t type;
  const uint8_t* data;
  uint32_t size;
  const uint8_t* next;  // start of the following element (8-byte aligned)
};

// Parse one tag (+small-element format) at p; end is the buffer limit.
bool parse_element(const uint8_t* p, const uint8_t* end, Element* out) {
  if (p + 8 > end) return false;
  uint32_t word0;
  std::memcpy(&word0, p, 4);
  if (word0 >> 16) {  // small element: size in high 16 bits, data inline
    out->type = word0 & 0xffff;
    out->size = word0 >> 16;
    if (out->size > 4 || p + 8 > end) return false;
    out->data = p + 4;
    out->next = p + 8;
    return true;
  }
  uint32_t size;
  std::memcpy(&size, p + 4, 4);
  out->type = word0;
  out->size = size;
  out->data = p + 8;
  const uint8_t* next = p + 8 + ((size + 7) & ~uint32_t(7));
  if (out->data + size > end || next > end + 8) return false;
  out->next = next > end ? end : next;
  return true;
}

// Convert the MAT column-major numeric payload to row-major float32.
template <typename T>
void fill_row_major(const uint8_t* src, float* dst, int rows, int cols) {
  const T* s = reinterpret_cast<const T*>(src);
  for (int c = 0; c < cols; ++c)
    for (int r = 0; r < rows; ++r)
      dst[r * cols + c] = static_cast<float>(s[c * rows + r]);
}

int element_bytes(uint32_t mi_type) {
  switch (mi_type) {
    case miINT8: case miUINT8: return 1;
    case miINT16: case miUINT16: return 2;
    case miINT32: case miUINT32: case miSINGLE: return 4;
    case miDOUBLE: return 8;
    default: return 0;
  }
}

// Parse one miMATRIX payload; on key match fill dims and optionally data.
// Returns DAS_OK on a successful key match, DAS_ENOTFOUND when this matrix
// has a different name, or an error code.
int parse_matrix(const uint8_t* p, const uint8_t* end, const char* key,
                 int* rows, int* cols, float* out, int expect_rows,
                 int expect_cols) {
  Element flags, dims, name;
  if (!parse_element(p, end, &flags) || flags.type != miUINT32 ||
      flags.size < 8)
    return DAS_EFORMAT;
  uint32_t flags_word;
  std::memcpy(&flags_word, flags.data, 4);
  uint32_t klass = flags_word & 0xff;
  bool is_complex = (flags_word >> 11) & 1;

  if (!parse_element(flags.next, end, &dims) || dims.type != miINT32)
    return DAS_EFORMAT;
  if (!parse_element(dims.next, end, &name) || name.type != miINT8)
    return DAS_EFORMAT;
  std::string var_name(reinterpret_cast<const char*>(name.data), name.size);
  if (var_name != key) return DAS_ENOTFOUND;

  if (dims.size != 8) return DAS_EUNSUPPORTED;  // 2-D only
  int32_t d[2];
  std::memcpy(d, dims.data, 8);
  *rows = d[0];
  *cols = d[1];
  if (is_complex) return DAS_EUNSUPPORTED;
  if (out == nullptr) return DAS_OK;  // dims-only query

  if (d[0] != expect_rows || d[1] != expect_cols) return DAS_ESHAPE;
  Element real;
  if (!parse_element(name.next, end, &real)) return DAS_EFORMAT;
  int ebytes = element_bytes(real.type);
  if (ebytes == 0) return DAS_EUNSUPPORTED;
  if (real.size < uint64_t(d[0]) * d[1] * ebytes) return DAS_EFORMAT;

  // The numeric storage type may be narrower than the array class (MAT
  // writers compress e.g. double arrays of small ints to miUINT8); dispatch
  // on the storage type, which is what the payload actually holds.
  (void)klass;
  switch (real.type) {
    case miDOUBLE: fill_row_major<double>(real.data, out, d[0], d[1]); break;
    case miSINGLE: fill_row_major<float>(real.data, out, d[0], d[1]); break;
    case miINT8: fill_row_major<int8_t>(real.data, out, d[0], d[1]); break;
    case miUINT8: fill_row_major<uint8_t>(real.data, out, d[0], d[1]); break;
    case miINT16: fill_row_major<int16_t>(real.data, out, d[0], d[1]); break;
    case miUINT16:
      fill_row_major<uint16_t>(real.data, out, d[0], d[1]);
      break;
    case miINT32: fill_row_major<int32_t>(real.data, out, d[0], d[1]); break;
    case miUINT32:
      fill_row_major<uint32_t>(real.data, out, d[0], d[1]);
      break;
    default: return DAS_EUNSUPPORTED;
  }
  return DAS_OK;
}

int load_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return DAS_EIO;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n < 128) {
    std::fclose(f);
    return DAS_EFORMAT;
  }
  buf->resize(n);
  size_t got = std::fread(buf->data(), 1, n, f);
  std::fclose(f);
  return got == size_t(n) ? DAS_OK : DAS_EIO;
}

int inflate_element(const uint8_t* data, uint32_t size,
                    std::vector<uint8_t>* out) {
  // zlib streams of MAT matrices for this dataset are small; grow-and-retry.
  uLongf cap = size * 4 + 1024;
  for (int attempt = 0; attempt < 8; ++attempt) {
    out->resize(cap);
    uLongf dest_len = cap;
    int rc = uncompress(out->data(), &dest_len, data, size);
    if (rc == Z_OK) {
      out->resize(dest_len);
      return DAS_OK;
    }
    if (rc != Z_BUF_ERROR) return DAS_EZLIB;
    cap *= 4;
  }
  return DAS_EZLIB;
}

// Walk the top-level elements of a MAT-5 buffer looking for `key`.
int find_and_read(const std::vector<uint8_t>& buf, const char* key, int* rows,
                  int* cols, float* out, int expect_rows, int expect_cols) {
  const uint8_t* p = buf.data() + 128;  // skip header
  const uint8_t* end = buf.data() + buf.size();
  uint16_t version;
  std::memcpy(&version, buf.data() + 124, 2);
  if (buf[126] != 'I' || buf[127] != 'M')  // big-endian files unsupported
    return DAS_EUNSUPPORTED;
  (void)version;

  while (p + 8 <= end) {
    Element el;
    if (!parse_element(p, end, &el)) return DAS_EFORMAT;
    if (el.type == miMATRIX) {
      int rc = parse_matrix(el.data, el.data + el.size, key, rows, cols, out,
                            expect_rows, expect_cols);
      if (rc != DAS_ENOTFOUND) return rc;
    } else if (el.type == miCOMPRESSED) {
      std::vector<uint8_t> inflated;
      int rc = inflate_element(el.data, el.size, &inflated);
      if (rc != DAS_OK) return rc;
      Element inner;
      if (!parse_element(inflated.data(), inflated.data() + inflated.size(),
                         &inner))
        return DAS_EFORMAT;
      if (inner.type == miMATRIX) {
        rc = parse_matrix(inner.data, inner.data + inner.size, key, rows,
                          cols, out, expect_rows, expect_cols);
        if (rc != DAS_ENOTFOUND) return rc;
      }
    }
    p = el.next;
  }
  return DAS_ENOTFOUND;
}

}  // namespace

extern "C" {

// Query the dims of `key` in a MAT file.  Returns DAS_* code.
int das_mat_dims(const char* path, const char* key, int* rows, int* cols) {
  std::vector<uint8_t> buf;
  int rc = load_file(path, &buf);
  if (rc != DAS_OK) return rc;
  return find_and_read(buf, key, rows, cols, nullptr, 0, 0);
}

// Load `key` as row-major float32 into out[rows*cols].
int das_load_mat_f32(const char* path, const char* key, float* out, int rows,
                     int cols) {
  std::vector<uint8_t> buf;
  int rc = load_file(path, &buf);
  if (rc != DAS_OK) return rc;
  int r = 0, c = 0;
  return find_and_read(buf, key, &r, &c, out, rows, cols);
}

// Parallel batch load: fill out[n, rows, cols] from n files using up to
// n_threads worker threads.  Returns DAS_OK only if every file loaded; the
// first failing file's index is written to *fail_index (or -1).
int das_load_many_f32(const char** paths, int n, const char* key, float* out,
                      int rows, int cols, int n_threads, int* fail_index) {
  std::atomic<int> next(0);
  std::atomic<int> first_fail(-1);
  std::atomic<int> fail_code(DAS_OK);
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || first_fail.load() >= 0) return;
      int rc = das_load_mat_f32(paths[i], key,
                                out + size_t(i) * rows * cols, rows, cols);
      if (rc != DAS_OK) {
        int expected = -1;
        if (first_fail.compare_exchange_strong(expected, i))
          fail_code.store(rc);
        return;
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  if (fail_index) *fail_index = first_fail.load();
  return fail_code.load();
}

}  // extern "C"
