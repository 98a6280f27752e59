// Native host runtime for EBCC-TPU.
//
// The reference implements its whole runtime in C (/root/reference/src/
// j2k_codec.h: buffer glue :22-80, zstd stage :656-658, container :704-743).
// In this framework the *compute* path is JAX/XLA on device; this library
// is the native equivalent of the host-side runtime around it:
//
//   * zstd entropy stage (compress/decompress, multi-frame batched with
//     OpenMP-free std::thread fan-out),
//   * bitstream repacking: big-endian u32 word buffers <-> trimmed byte
//     streams for a whole batch in one call,
//   * container frame assembly (header + optional residual + base stream).
//
// Exposed as a C ABI consumed from Python via ctypes
// (ebcc_tpu/runtime/native.py).  No Python.h dependency.

#include <zstd.h>

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// zstd stage
// ---------------------------------------------------------------------------

// Compress n buffers in parallel.  srcs/src_sizes describe inputs; dst is a
// single arena of dst_cap bytes per slot (dst + i*dst_cap); out_sizes[i]
// receives each compressed size (0 on failure/overflow).
void ebcc_zstd_compress_batch(const uint8_t** srcs, const size_t* src_sizes,
                              int n, int level, uint8_t* dst, size_t dst_cap,
                              size_t* out_sizes) {
  int hw = (int)std::thread::hardware_concurrency();
  int nthreads = n < hw ? n : hw;
  if (nthreads < 1) nthreads = 1;
  std::vector<std::thread> ts;
  ts.reserve(nthreads);
  for (int t = 0; t < nthreads; ++t) {
    ts.emplace_back([=]() {
      for (int i = t; i < n; i += nthreads) {
        size_t r = ZSTD_compress(dst + (size_t)i * dst_cap, dst_cap, srcs[i],
                                 src_sizes[i], level);
        out_sizes[i] = ZSTD_isError(r) ? (size_t)-1 : r;
      }
    });
  }
  for (auto& th : ts) th.join();
}

void ebcc_zstd_decompress_batch(const uint8_t** srcs, const size_t* src_sizes,
                                int n, uint8_t* dst, size_t dst_cap,
                                size_t* out_sizes) {
  int hw = (int)std::thread::hardware_concurrency();
  int nthreads = n < hw ? n : hw;
  if (nthreads < 1) nthreads = 1;
  std::vector<std::thread> ts;
  ts.reserve(nthreads);
  for (int t = 0; t < nthreads; ++t) {
    ts.emplace_back([=]() {
      for (int i = t; i < n; i += nthreads) {
        size_t r = ZSTD_decompress(dst + (size_t)i * dst_cap, dst_cap,
                                   srcs[i], src_sizes[i]);
        out_sizes[i] = ZSTD_isError(r) ? (size_t)-1 : r;
      }
    });
  }
  for (auto& th : ts) th.join();
}

size_t ebcc_zstd_bound(size_t src_size) { return ZSTD_compressBound(src_size); }

// ---------------------------------------------------------------------------
// bitstream repacking
// ---------------------------------------------------------------------------

// words: [n, nwords] native-endian u32; per frame, write the first
// ceil(nbits[i]/8) bytes of the big-endian byte view into dst + i*dst_stride.
// Returns nothing; byte counts are implied by nbits.
void ebcc_words_to_bytes_batch(const uint32_t* words, int n, int nwords,
                               const int32_t* nbits, uint8_t* dst,
                               size_t dst_stride) {
  for (int i = 0; i < n; ++i) {
    const uint32_t* w = words + (size_t)i * nwords;
    uint8_t* d = dst + (size_t)i * dst_stride;
    int nbytes = (nbits[i] + 7) / 8;
    int full = nbytes / 4;
    for (int k = 0; k < full; ++k) {
      uint32_t v = w[k];
      d[4 * k + 0] = (uint8_t)(v >> 24);
      d[4 * k + 1] = (uint8_t)(v >> 16);
      d[4 * k + 2] = (uint8_t)(v >> 8);
      d[4 * k + 3] = (uint8_t)v;
    }
    int rem = nbytes - 4 * full;
    if (rem > 0) {
      uint32_t v = w[full];
      for (int b = 0; b < rem; ++b) d[4 * full + b] = (uint8_t)(v >> (24 - 8 * b));
    }
  }
}

// bytes (concatenated streams with per-frame offsets/sizes) -> padded
// [n, nwords] u32 word buffers (zero-filled tails).
void ebcc_bytes_to_words_batch(const uint8_t* bytes, const size_t* offsets,
                               const size_t* sizes, int n, uint32_t* words,
                               int nwords) {
  memset(words, 0, (size_t)n * nwords * sizeof(uint32_t));
  for (int i = 0; i < n; ++i) {
    const uint8_t* s = bytes + offsets[i];
    uint32_t* w = words + (size_t)i * nwords;
    size_t nb = sizes[i];
    size_t cap = (size_t)nwords * 4;
    if (nb > cap) nb = cap;
    size_t full = nb / 4;
    for (size_t k = 0; k < full; ++k) {
      w[k] = ((uint32_t)s[4 * k] << 24) | ((uint32_t)s[4 * k + 1] << 16) |
             ((uint32_t)s[4 * k + 2] << 8) | (uint32_t)s[4 * k + 3];
    }
    size_t rem = nb - 4 * full;
    uint32_t v = 0;
    for (size_t b = 0; b < rem; ++b) v |= (uint32_t)s[4 * full + b] << (24 - 8 * b);
    if (rem) w[full] = v;
  }
}

int ebcc_host_version() { return 1; }

}  // extern "C"
