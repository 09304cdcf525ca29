// dl4j_native: the host C++ data plane of the PyTorch port
// (deeplearning4j_tpu_torch), its own copy of the JAX package's
// `deeplearning4j_tpu/native/dl4j_native.cpp` (ABI 2): the same functions,
// giving the same results.
//
// Reference analog: the reference reaches native code for its data plane and
// runtime via DataVec record readers (CSV/image -> INDArray,
// `RecordReaderDataSetIterator`), the custom MNIST binary reader
// (`deeplearning4j-core/src/main/java/org/deeplearning4j/datasets/mnist/`),
// and the device-aware prefetch queue (`MagicQueue.java`). Those live here as
// plain C++17 (zlib for PNG only), exposed over a C ABI consumed from Python
// with ctypes. The compute path is PyTorch on the GPU; this is the host-side
// IO tier that feeds it.
//
// Components:
//   * IDX decode (MNIST format): header parse + payload -> caller buffer
//   * CSV float parser: strtof-based two-pass parse, ~10x numpy.loadtxt
//   * u8 -> f32 normalize: scale/shift image payloads without a Python pass
//   * PrefetchRing: background thread streaming fixed-size records from a
//     binary file into a ring of pre-allocated batch buffers (the
//     MagicQueue/AsyncDataSetIterator analog, file-backed)
//   * PNG / BMP / PPM / PGM decode into interleaved u8
//
// Build (deeplearning4j_tpu_torch/native/__init__.py does this at first use):
//   g++ -O3 -std=c++17 -shared -fPIC -pthread -ffp-contract=off \
//       dl4j_native.cpp -o libdl4j_torch_native.so -lz
// (or -DDL4J_NO_ZLIB in place of -lz where zlib's headers are missing).
#ifndef _GNU_SOURCE
#define _GNU_SOURCE  // strtof_l / newlocale
#endif
#include <locale.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// IDX (MNIST binary) decode
// ---------------------------------------------------------------------------

// Parse an IDX header. Returns 0 on success. On success: *dtype_code is the
// IDX type byte (0x08=u8, 0x0B=i16, 0x0C=i32, 0x0D=f32, 0x0E=f64), dims[0..
// *ndim-1] the dimension sizes (max 8 dims).
int idx_header(const char* path, int* dtype_code, int* ndim, int64_t* dims) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  unsigned char magic[4];
  if (std::fread(magic, 1, 4, f) != 4 || magic[0] != 0 || magic[1] != 0) {
    std::fclose(f);
    return -2;
  }
  *dtype_code = magic[2];
  int nd = magic[3];
  if (nd <= 0 || nd > 8) {
    std::fclose(f);
    return -3;
  }
  *ndim = nd;
  for (int i = 0; i < nd; i++) {
    unsigned char b[4];
    if (std::fread(b, 1, 4, f) != 4) {
      std::fclose(f);
      return -4;
    }
    dims[i] = ((int64_t)b[0] << 24) | ((int64_t)b[1] << 16) |
              ((int64_t)b[2] << 8) | (int64_t)b[3];
  }
  std::fclose(f);
  return 0;
}

// Read the IDX payload (raw bytes, big-endian element order as stored) into
// `out` (caller-allocated, `out_bytes` long). Returns bytes read or <0.
int64_t idx_payload(const char* path, unsigned char* out, int64_t out_bytes) {
  int dtype, nd;
  int64_t dims[8];
  int rc = idx_header(path, &dtype, &nd, dims);
  if (rc != 0) return rc;
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 4 + 4 * nd, SEEK_SET);
  int64_t got = (int64_t)std::fread(out, 1, (size_t)out_bytes, f);
  std::fclose(f);
  return got;
}

// ---------------------------------------------------------------------------
// u8 -> f32 normalize (image payload -> network input)
// ---------------------------------------------------------------------------

void u8_to_f32(const unsigned char* src, float* dst, int64_t n, float scale,
               float shift) {
  for (int64_t i = 0; i < n; i++) dst[i] = (float)src[i] * scale + shift;
}

// Binarize variant (reference MnistDataFetcher `binarize` flag,
// MnistDataFetcher.java:40): pixel > threshold -> 1 else 0.
void u8_binarize_f32(const unsigned char* src, float* dst, int64_t n,
                     int threshold) {
  for (int64_t i = 0; i < n; i++) dst[i] = src[i] > threshold ? 1.0f : 0.0f;
}

// ---------------------------------------------------------------------------
// CSV float parser
// ---------------------------------------------------------------------------

// Locale-pinned strtof: the caller's process may run under a comma-decimal
// locale (de_DE etc.), where plain strtof("1.5") would stop at the '.'.
static float strtof_c(const char* s, char** end) {
  static locale_t c_loc = newlocale(LC_ALL_MASK, "C", (locale_t)0);
  return strtof_l(s, end, c_loc);
}

// Count data rows and columns. Rows = newline-terminated non-empty lines
// minus `skip_rows`. Columns = fields in the first counted row; a later row
// with a different field count is an error (-5, matching the loud failure
// of the numpy fallback on ragged CSVs). Returns 0 on success.
int csv_shape(const char* path, int skip_rows, int64_t* rows, int64_t* cols) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  if (sz < 0) {  // non-seekable (FIFO etc.) — fail cleanly, no OOB write
    std::fclose(f);
    return -1;
  }
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf((size_t)sz + 1);
  if (sz > 0 && std::fread(buf.data(), 1, (size_t)sz, f) != (size_t)sz) {
    std::fclose(f);
    return -2;
  }
  std::fclose(f);
  buf[(size_t)sz] = '\0';
  int64_t r = 0, c = 0;
  int skipped = 0;
  const char* p = buf.data();
  const char* end = p + sz;
  while (p < end) {
    const char* line_end = (const char*)memchr(p, '\n', (size_t)(end - p));
    if (!line_end) line_end = end;
    bool empty = true;
    for (const char* q = p; q < line_end; q++)
      if (*q != ' ' && *q != '\r' && *q != '\t') {
        empty = false;
        break;
      }
    if (!empty) {
      if (skipped < skip_rows) {
        skipped++;
      } else {
        int64_t this_c = 1;
        for (const char* q = p; q < line_end; q++)
          if (*q == ',') this_c++;
        if (r == 0) {
          c = this_c;
        } else if (this_c != c) {
          return -5;  // ragged row
        }
        r++;
      }
    }
    p = line_end + 1;
  }
  *rows = r;
  *cols = c;
  return 0;
}

// One-read variant: slurp the file once, derive the shape and parse from
// the same buffer, returning a malloc'd matrix the caller frees with
// csv_free. Returns 0 on success (rows/cols/out filled) or <0 (-5 ragged).
int64_t csv_parse_alloc(const char* path, int skip_rows, float** out,
                        int64_t* rows, int64_t* cols) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  if (sz < 0) {  // non-seekable (FIFO etc.) — fail cleanly, no OOB write
    std::fclose(f);
    return -1;
  }
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf((size_t)sz + 1);
  if (sz > 0 && std::fread(buf.data(), 1, (size_t)sz, f) != (size_t)sz) {
    std::fclose(f);
    return -2;
  }
  std::fclose(f);
  buf[(size_t)sz] = '\0';

  auto line_empty = [](const char* a, const char* b) {
    for (const char* q = a; q < b; q++)
      if (*q != ' ' && *q != '\r' && *q != '\t') return false;
    return true;
  };
  // pass 1: shape (over the in-memory buffer)
  int64_t r = 0, c = 0;
  {
    const char* p = buf.data();
    const char* end = p + sz;
    int skipped = 0;
    while (p < end) {
      const char* le = (const char*)memchr(p, '\n', (size_t)(end - p));
      if (!le) le = end;
      if (!line_empty(p, le)) {
        if (skipped < skip_rows) {
          skipped++;
        } else {
          int64_t tc = 1;
          for (const char* q = p; q < le; q++)
            if (*q == ',') tc++;
          if (r == 0) c = tc;
          else if (tc != c) return -5;  // ragged row
          r++;
        }
      }
      p = le + 1;
    }
  }
  float* m = (float*)std::malloc((size_t)(r * c) * sizeof(float));
  if (!m && r * c > 0) return -6;
  // pass 2: parse (same buffer, no second read)
  {
    char* p = buf.data();
    char* end = p + sz;
    int skipped = 0;
    int64_t rr = 0;
    while (p < end && rr < r) {
      char* le = (char*)memchr(p, '\n', (size_t)(end - p));
      if (!le) le = end;
      if (!line_empty(p, le)) {
        if (skipped < skip_rows) {
          skipped++;
        } else {
          char saved = *le;
          *le = '\0';
          char* q = p;
          for (int64_t cc = 0; cc < c; cc++) {
            char* next = nullptr;
            float v = strtof_c(q, &next);
            if (next == q) v = 0.0f;
            m[rr * c + cc] = v;
            q = next;
            while (q < le && *q != ',') q++;
            if (q < le) q++;
          }
          *le = saved;
          rr++;
        }
      }
      p = le + 1;
    }
  }
  *out = m;
  *rows = r;
  *cols = c;
  return 0;
}

void csv_free(float* p) { std::free(p); }

// Parse into caller-allocated out[rows*cols] (row-major f32). Non-numeric
// fields parse as 0. Returns number of rows parsed or <0.
int64_t csv_parse_f32(const char* path, int skip_rows, float* out,
                      int64_t rows, int64_t cols) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  if (sz < 0) {  // non-seekable (FIFO etc.) — fail cleanly, no OOB write
    std::fclose(f);
    return -1;
  }
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf((size_t)sz + 1);
  if (sz > 0 && std::fread(buf.data(), 1, (size_t)sz, f) != (size_t)sz) {
    std::fclose(f);
    return -2;
  }
  std::fclose(f);
  buf[(size_t)sz] = '\0';
  char* p = buf.data();
  char* end = p + sz;
  int64_t r = 0;
  int skipped = 0;
  while (p < end && r < rows) {
    char* line_end = (char*)memchr(p, '\n', (size_t)(end - p));
    if (!line_end) line_end = end;
    bool empty = true;
    for (char* q = p; q < line_end; q++)
      if (*q != ' ' && *q != '\r' && *q != '\t') {
        empty = false;
        break;
      }
    if (!empty) {
      if (skipped < skip_rows) {
        skipped++;
      } else {
        char saved = *line_end;
        *line_end = '\0';
        char* q = p;
        for (int64_t cc = 0; cc < cols; cc++) {
          char* next = nullptr;
          float v = strtof_c(q, &next);
          if (next == q) v = 0.0f;  // non-numeric field
          out[r * cols + cc] = v;
          q = next;
          while (q < line_end && *q != ',') q++;
          if (q < line_end) q++;
        }
        *line_end = saved;
        r++;
      }
    }
    p = line_end + 1;
  }
  return r;
}

// ---------------------------------------------------------------------------
// PrefetchRing: background-thread record streaming (MagicQueue analog)
// ---------------------------------------------------------------------------

struct PrefetchRing {
  FILE* f = nullptr;
  int64_t record_bytes = 0;   // bytes per record
  int64_t batch_records = 0;  // records per batch
  int64_t total_records = 0;
  int64_t next_record = 0;    // producer cursor
  int64_t produced = 0;       // batches produced
  int64_t consumed = 0;       // batches consumed
  int64_t n_batches = 0;      // total batches per epoch
  int slots = 0;
  std::vector<std::vector<unsigned char>> ring;
  std::vector<int64_t> fill;  // records actually in each slot
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_can_produce, cv_can_consume;
  std::atomic<bool> stop{false};
  int error = 0;

  void run() {
    while (!stop.load()) {
      std::unique_lock<std::mutex> lk(mu);
      cv_can_produce.wait(lk, [&] {
        return stop.load() || (produced - consumed) < slots;
      });
      if (stop.load()) break;
      if (produced >= n_batches) break;  // epoch done
      int slot = (int)(produced % slots);
      int64_t want = std::min(batch_records, total_records - next_record);
      int64_t off = next_record;
      lk.unlock();
      // read outside the lock
      std::fseek(f, (long)(header_bytes + off * record_bytes), SEEK_SET);
      size_t got = std::fread(ring[slot].data(), (size_t)record_bytes,
                              (size_t)want, f);
      lk.lock();
      if ((int64_t)got != want) error = -5;
      fill[slot] = (int64_t)got;
      next_record += want;
      produced++;
      cv_can_consume.notify_all();
    }
  }

  int64_t header_bytes = 0;
};

void* ring_open(const char* path, int64_t header_bytes, int64_t record_bytes,
                int64_t total_records, int64_t batch_records, int slots) {
  auto* r = new PrefetchRing();
  r->f = std::fopen(path, "rb");
  if (!r->f) {
    delete r;
    return nullptr;
  }
  r->header_bytes = header_bytes;
  r->record_bytes = record_bytes;
  r->batch_records = batch_records;
  r->total_records = total_records;
  r->slots = slots < 1 ? 2 : slots;
  r->n_batches = (total_records + batch_records - 1) / batch_records;
  r->ring.resize((size_t)r->slots);
  r->fill.resize((size_t)r->slots, 0);
  for (auto& b : r->ring)
    b.resize((size_t)(record_bytes * batch_records));
  r->worker = std::thread([r] { r->run(); });
  return r;
}

// Pop the next prefetched batch into `out`. Returns records copied, 0 at
// end of epoch, <0 on error.
int64_t ring_next(void* handle, unsigned char* out) {
  auto* r = (PrefetchRing*)handle;
  std::unique_lock<std::mutex> lk(r->mu);
  if (r->consumed >= r->n_batches) return 0;
  r->cv_can_consume.wait(lk, [&] {
    return r->stop.load() || r->error != 0 || r->produced > r->consumed;
  });
  if (r->error != 0) return r->error;
  if (r->stop.load()) return -9;
  int slot = (int)(r->consumed % r->slots);
  int64_t n = r->fill[slot];
  std::memcpy(out, r->ring[slot].data(), (size_t)(n * r->record_bytes));
  r->consumed++;
  r->cv_can_produce.notify_all();
  return n;
}

void ring_close(void* handle) {
  auto* r = (PrefetchRing*)handle;
  r->stop.store(true);
  r->cv_can_produce.notify_all();
  r->cv_can_consume.notify_all();
  if (r->worker.joinable()) r->worker.join();
  if (r->f) std::fclose(r->f);
  delete r;
}

int ring_error(void* handle) { return ((PrefetchRing*)handle)->error; }

}  // extern "C"

// ---------------------------------------------------------------------------
// Image decode: PNG (zlib), BMP (24/32bpp uncompressed), PPM/PGM binary.
// The reference's image tier is DataVec's JavaCV ImageRecordReader
// (`datavec-data-image` NativeImageLoader); here the common lossless
// formats decode natively and the Python side falls back to PIL for JPEG.
// ---------------------------------------------------------------------------
#ifndef DL4J_NO_ZLIB
#include <zlib.h>
#endif

#include <cctype>

namespace {

// sanity caps on untrusted header dimensions: decoders must return -3 on
// corrupt files, never abort the process on a 30 GB bad_alloc or wrap a
// size_t bounds check
constexpr int64_t kMaxDim = 1 << 16;          // 65536 px per side
constexpr int64_t kMaxPixels = 1LL << 28;     // 256M elements (x channels)

static bool dims_ok(int64_t w, int64_t h, int64_t ch) {
  return w > 0 && h > 0 && w <= kMaxDim && h <= kMaxDim &&
         w * h * ch <= kMaxPixels;
}

struct Bytes {
  std::vector<unsigned char> v;
};

static bool read_file(const char* path, std::vector<unsigned char>& out) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n < 0) { std::fclose(f); return false; }
  out.resize((size_t)n);
  size_t got = n ? std::fread(out.data(), 1, (size_t)n, f) : 0;
  std::fclose(f);
  return got == (size_t)n;
}

static uint32_t be32(const unsigned char* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

static int paeth(int a, int b, int c) {
  int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b),
      pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Decode an 8-bit non-interlaced PNG. Returns 0 ok, -2 unsupported,
// -3 corrupt. On ok fills w/h/ch and `pix` (interleaved, palette expanded
// to RGB).
#ifdef DL4J_NO_ZLIB
static int png_decode(const std::vector<unsigned char>& buf, int*, int*,
                      int*, std::vector<unsigned char>&) {
  static const unsigned char SIG[8] = {0x89, 'P', 'N', 'G', '\r', '\n',
                                       0x1A, '\n'};
  // zlib-free build: PNG is unsupported (PIL fallback), other formats work
  (void)SIG;
  return -2;
}
#else
static int png_decode(const std::vector<unsigned char>& buf, int* w, int* h,
                      int* ch, std::vector<unsigned char>& pix) {
  static const unsigned char SIG[8] = {0x89, 'P', 'N', 'G', '\r', '\n',
                                       0x1A, '\n'};
  if (buf.size() < 8 || std::memcmp(buf.data(), SIG, 8) != 0) return -2;
  size_t i = 8;
  uint32_t W = 0, H = 0;
  int bit_depth = 0, color_type = -1, interlace = 0;
  std::vector<unsigned char> idat, plte;
  while (i + 8 <= buf.size()) {
    uint32_t len = be32(&buf[i]);
    if (i + 12 + (size_t)len > buf.size()) return -3;
    const unsigned char* tag = &buf[i + 4];
    const unsigned char* data = &buf[i + 8];
    if (!std::memcmp(tag, "IHDR", 4)) {
      if (len < 13) return -3;
      W = be32(data);
      H = be32(data + 4);
      bit_depth = data[8];
      color_type = data[9];
      interlace = data[12];
    } else if (!std::memcmp(tag, "PLTE", 4)) {
      plte.assign(data, data + len);
    } else if (!std::memcmp(tag, "IDAT", 4)) {
      idat.insert(idat.end(), data, data + len);
    } else if (!std::memcmp(tag, "IEND", 4)) {
      break;
    }
    i += 12 + len;
  }
  if (!W || !H || idat.empty()) return -3;
  if (bit_depth != 8 || interlace != 0) return -2;  // PIL fallback
  if (!dims_ok(W, H, 4)) return -3;
  int nch;
  switch (color_type) {
    case 0: nch = 1; break;   // gray
    case 2: nch = 3; break;   // rgb
    case 3: nch = 1; break;   // palette index (expanded below)
    case 4: nch = 2; break;   // gray+alpha
    case 6: nch = 4; break;   // rgba
    default: return -2;
  }
  size_t stride = (size_t)W * nch;
  std::vector<unsigned char> raw(H * (stride + 1));
  uLongf raw_len = (uLongf)raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), (uLong)idat.size())
          != Z_OK || raw_len != raw.size())
    return -3;
  // unfilter
  std::vector<unsigned char> img(H * stride);
  for (uint32_t y = 0; y < H; y++) {
    const unsigned char* row = &raw[y * (stride + 1)];
    unsigned char filter = row[0];
    const unsigned char* src = row + 1;
    unsigned char* dst = &img[y * stride];
    const unsigned char* up = y ? &img[(y - 1) * stride] : nullptr;
    for (size_t x = 0; x < stride; x++) {
      int a = x >= (size_t)nch ? dst[x - nch] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= (size_t)nch) ? up[x - nch] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return -3;
      }
      dst[x] = (unsigned char)v;
    }
  }
  if (color_type == 3) {  // expand palette to RGB
    if (plte.size() < 3) return -3;
    pix.resize((size_t)W * H * 3);
    for (size_t p = 0; p < (size_t)W * H; p++) {
      size_t idx = (size_t)img[p] * 3;
      if (idx + 2 >= plte.size()) return -3;
      pix[p * 3] = plte[idx];
      pix[p * 3 + 1] = plte[idx + 1];
      pix[p * 3 + 2] = plte[idx + 2];
    }
    nch = 3;
  } else {
    pix.swap(img);
  }
  *w = (int)W;
  *h = (int)H;
  *ch = nch;
  return 0;
}
#endif  // DL4J_NO_ZLIB

// Uncompressed 24/32bpp BMP (bottom-up or top-down), BGR(A) -> RGB(A).
static int bmp_decode(const std::vector<unsigned char>& buf, int* w, int* h,
                      int* ch, std::vector<unsigned char>& pix) {
  if (buf.size() < 54 || buf[0] != 'B' || buf[1] != 'M') return -2;
  auto le32 = [&](size_t o) -> int32_t {
    return (int32_t)(buf[o] | (buf[o + 1] << 8) | (buf[o + 2] << 16) |
                     ((uint32_t)buf[o + 3] << 24));
  };
  auto le16 = [&](size_t o) -> int {
    return buf[o] | (buf[o + 1] << 8);
  };
  uint32_t off = (uint32_t)le32(10);
  int32_t W = le32(18), Hs = le32(22);
  int bpp = le16(28);
  int32_t compression = le32(30);
  if (compression != 0 || (bpp != 24 && bpp != 32)) return -2;
  bool flip = Hs > 0;
  int32_t H = Hs > 0 ? Hs : -Hs;
  if (!dims_ok(W, H, 4)) return -3;
  int sch = bpp / 8;
  int64_t row_in = (((int64_t)W * sch + 3) / 4) * 4;   // 4-byte aligned
  if ((int64_t)off + row_in * H > (int64_t)buf.size()) return -3;
  int nch = sch == 4 ? 4 : 3;
  pix.resize((size_t)W * H * nch);
  for (int32_t y = 0; y < H; y++) {
    const unsigned char* src = &buf[off + (size_t)(flip ? H - 1 - y : y)
                                             * row_in];
    unsigned char* dst = &pix[(size_t)y * W * nch];
    for (int32_t x = 0; x < W; x++) {
      dst[x * nch] = src[x * sch + 2];       // R <- B position
      dst[x * nch + 1] = src[x * sch + 1];   // G
      dst[x * nch + 2] = src[x * sch];       // B <- R position
      if (nch == 4) dst[x * nch + 3] = src[x * sch + 3];
    }
  }
  *w = W;
  *h = H;
  *ch = nch;
  return 0;
}

// Binary PPM (P6, RGB) / PGM (P5, gray), maxval <= 255.
static int pnm_decode(const std::vector<unsigned char>& buf, int* w, int* h,
                      int* ch, std::vector<unsigned char>& pix) {
  if (buf.size() < 2 || buf[0] != 'P' || (buf[1] != '5' && buf[1] != '6'))
    return -2;
  int nch = buf[1] == '6' ? 3 : 1;
  size_t i = 2;
  long vals[3];
  for (int k = 0; k < 3; k++) {
    // skip whitespace + comments
    while (i < buf.size()) {
      if (std::isspace(buf[i])) { i++; continue; }
      if (buf[i] == '#') { while (i < buf.size() && buf[i] != '\n') i++; continue; }
      break;
    }
    long v = 0;
    bool any = false;
    while (i < buf.size() && std::isdigit(buf[i])) {
      v = v * 10 + (buf[i] - '0');
      i++;
      any = true;
    }
    if (!any) return -3;
    vals[k] = v;
  }
  if (i >= buf.size() || !std::isspace(buf[i])) return -3;
  i++;  // single whitespace after maxval
  long W = vals[0], H = vals[1], maxv = vals[2];
  if (maxv <= 0 || maxv > 255) return -2;
  if (!dims_ok(W, H, 3)) return -3;
  size_t need = (size_t)W * H * nch;
  if (buf.size() - i < need) return -3;
  pix.assign(buf.begin() + i, buf.begin() + i + need);
  *w = (int)W;
  *h = (int)H;
  *ch = nch;
  return 0;
}

static int decode_any(const char* path, int* w, int* h, int* ch,
                      std::vector<unsigned char>& pix) {
  // corrupt files must produce an error code, never terminate the host
  // process: guard against bad_alloc/length_error from hostile headers
  try {
    std::vector<unsigned char> buf;
    if (!read_file(path, buf)) return -1;
    int rc = png_decode(buf, w, h, ch, pix);
    if (rc != -2) return rc;
    rc = bmp_decode(buf, w, h, ch, pix);
    if (rc != -2) return rc;
    return pnm_decode(buf, w, h, ch, pix);
  } catch (...) {
    return -3;
  }
}

}  // namespace

extern "C" {

// Decode ONCE into a malloc'd buffer (interleaved u8, row-major) the
// caller frees with image_free. rc: 0 ok (fills *out/w/h/ch), -1 io
// error, -2 unsupported format (caller falls back to PIL), -3 corrupt.
int image_decode_alloc(const char* path, unsigned char** out, int* w,
                       int* h, int* ch) {
  std::vector<unsigned char> pix;
  int rc = decode_any(path, w, h, ch, pix);
  if (rc != 0) return rc;
  *out = (unsigned char*)std::malloc(pix.size() ? pix.size() : 1);
  if (!*out) return -3;
  std::memcpy(*out, pix.data(), pix.size());
  return 0;
}

void image_free(unsigned char* p) { std::free(p); }

// ---------------------------------------------------------------------------
// Version probe
// ---------------------------------------------------------------------------

int dl4j_native_abi() { return 2; }

}  // extern "C"
