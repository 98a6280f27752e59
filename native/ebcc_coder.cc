// Native bitplane coder: the entropy stage of the EBCC-TPU codec.
//
// The stream layout is EXACTLY the layout produced/consumed by the JAX
// reference packers (ebcc_tpu/ops/bitplane.py encode_frame/decode_frame) —
// per bitplane b from high to low:
//   [group significance, quadtree level G..1, row-major]
//   per stripe chunk j: [coeff significance bits][signs of new coeffs]
//   per stripe chunk j: [refinement bits of old coeffs]
// Bits are MSB-first within bytes.  Reads past the stream end yield 0.
//
// Rationale: bit-serial packing is the one stage of the pipeline that maps
// badly onto a vector accelerator (1M-element scatters per segment per
// plane); the reference implements the analogous stage (SPIHT, spiht_re.c)
// natively too.
// Transforms, quantisation and the truncation search stay on device; this
// library only turns already-chosen (coefficients, truncation) pairs into
// bytes and back, batched over frames with one thread per frame.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

// word-parallel fast path (ebcc_coder_fast.cc, compiled with -mbmi2)
namespace ebcc_fast {
struct Spec {
  int h, w, g, nplanes, nchunks;
};
bool cpu_has_bmi2();
void encode_one_fast(const int32_t*, const Spec&, int64_t, uint8_t*);
int decode_core_fast(const uint8_t*, int64_t, int, const Spec&, int,
                     uint32_t, uint32_t*, uint8_t*, int16_t*, uint8_t*);
}  // namespace ebcc_fast

namespace {

struct Spec {
  int h, w, g, nplanes, nchunks;
};

int g_force_path = 0;  // 0 = auto, 1 = force scalar, 2 = force fast

inline bool use_fast() {
  static const bool has = ebcc_fast::cpu_has_bmi2();
  if (g_force_path == 1) return false;
  if (g_force_path == 2) return true;
  return has;
}

inline ebcc_fast::Spec to_fast(const Spec& s) {
  return ebcc_fast::Spec{s.h, s.w, s.g, s.nplanes, s.nchunks};
}

static inline int msb_of(uint32_t v) {
  return v ? 31 - __builtin_clz(v) : -1;
}

// Per-frame encoder (scalar path).  coef: int32 [h*w].  out: zeroed byte
// buffer of cap_bytes.  Emits bits until trunc_bits, then stops (the
// remaining stream length is known to the caller from the device counts).
void encode_one_scalar(const int32_t* coef, const Spec& s,
                       int64_t trunc_bits, uint8_t* out) {
  const int h = s.h, w = s.w, g = s.g, J = s.nchunks;
  const size_t n = (size_t)h * w;
  std::vector<int8_t> msb(n);
  std::vector<uint32_t> mag(n);
  std::vector<uint8_t> neg(n);
  int max_step = 0;
  for (size_t i = 0; i < n; ++i) {
    int32_t v = coef[i];
    uint32_t m = (uint32_t)(v < 0 ? -(int64_t)v : v);
    mag[i] = m;
    neg[i] = v < 0;
    int b = msb_of(m);
    msb[i] = (int8_t)b;
    if (b > max_step) max_step = b;
  }
  // smax pyramid: level k has dims (h>>k, w>>k); smax[0] == msb.
  std::vector<std::vector<int8_t>> smax(g + 1);
  smax[0] = msb;
  for (int k = 1; k <= g; ++k) {
    int hk = h >> k, wk = w >> k;
    smax[k].resize((size_t)hk * wk);
    const int8_t* prev = smax[k - 1].data();
    int wp = w >> (k - 1);
    for (int r = 0; r < hk; ++r)
      for (int c = 0; c < wk; ++c) {
        int8_t a = prev[(2 * r) * wp + 2 * c];
        int8_t b2 = prev[(2 * r) * wp + 2 * c + 1];
        int8_t c2 = prev[(2 * r + 1) * wp + 2 * c];
        int8_t d = prev[(2 * r + 1) * wp + 2 * c + 1];
        int8_t m = a > b2 ? a : b2;
        if (c2 > m) m = c2;
        if (d > m) m = d;
        smax[k][(size_t)r * wk + c] = m;
      }
  }

  // per-row maxima let whole rows be skipped at planes where they provably
  // emit nothing (bit ORDER is unchanged; skipped rows contribute no bits)
  std::vector<std::vector<int8_t>> rowmax(g + 1);
  for (int k = 0; k <= g; ++k) {
    int hk = h >> k, wk = w >> k;
    rowmax[k].assign(hk, -1);
    const int8_t* sk = smax[k].data();
    for (int r = 0; r < hk; ++r) {
      int8_t m = -1;
      for (int c = 0; c < wk; ++c) m = std::max(m, sk[(size_t)r * wk + c]);
      rowmax[k][r] = m;
    }
  }

  int64_t pos = 0;
  auto emit = [&](int bit) {
    if (pos < trunc_bits && bit) out[pos >> 3] |= (uint8_t)(0x80u >> (pos & 7));
    ++pos;
  };

  for (int b = s.nplanes - 1; b >= 0 && pos < trunc_bits; --b) {
    // group levels g..1
    for (int k = g; k >= 1; --k) {
      int hk = h >> k, wk = w >> k;
      const int8_t* sk = smax[k].data();
      if (k == g) {
        bool par = max_step >= b;
        if (par) {
          for (size_t i = 0; i < (size_t)hk * wk; ++i)
            if (sk[i] <= b) emit(sk[i] == b);
        }
      } else {
        const int8_t* sp = smax[k + 1].data();
        int wk1 = wk >> 1;
        for (int r = 0; r < hk; ++r) {
          if (rowmax[k + 1][r >> 1] < b) continue;  // no significant parent
          for (int c = 0; c < wk; ++c) {
            if (sp[(size_t)(r >> 1) * wk1 + (c >> 1)] >= b &&
                sk[(size_t)r * wk + c] <= b)
              emit(sk[(size_t)r * wk + c] == b);
          }
        }
      }
    }
    // level-0 passes over J row stripes
    const int8_t* s1 = smax[1].data();
    int w1 = w >> 1;
    for (int j = 0; j < J; ++j) {
      // stripe j: rows r with (r*J)/h == j
      int r0 = (j * h + J - 1) / J, r1 = ((j + 1) * h + J - 1) / J;
      // significance bits
      for (int r = r0; r < r1; ++r) {
        if (rowmax[1][r >> 1] < b) continue;
        for (int c = 0; c < w; ++c) {
          size_t i = (size_t)r * w + c;
          if (s1[(size_t)(r >> 1) * w1 + (c >> 1)] >= b && msb[i] <= b)
            emit(msb[i] == b);
        }
      }
      // sign bits of newly-significant coeffs
      for (int r = r0; r < r1; ++r) {
        if (rowmax[0][r] < b) continue;
        for (int c = 0; c < w; ++c) {
          size_t i = (size_t)r * w + c;
          if (msb[i] == b) emit(neg[i]);
        }
      }
    }
    // refinement passes
    for (int j = 0; j < J; ++j) {
      int r0 = (j * h + J - 1) / J, r1 = ((j + 1) * h + J - 1) / J;
      for (int r = r0; r < r1; ++r) {
        if (rowmax[0][r] <= b) continue;  // no coeff with msb > b
        for (int c = 0; c < w; ++c) {
          size_t i = (size_t)r * w + c;
          if (msb[i] > b) emit((mag[i] >> b) & 1);
        }
      }
    }
  }
}

// Per-frame structural decode into (mag, neg, last) state arrays (scalar
// path).  Returns b_end: the lowest bitplane entered.  For every
// significant coefficient, last is b_end or b_end + 1 (refinement updates
// last at every entered plane until the stream runs out mid-plane).
//
// Chunk masking (format v4): at plane ``mask_plane``, level-0 chunk j is
// present in the stream only when bit j of ``keep_mask`` is set — absent
// chunks consume no bits and decode as past-the-end zeros (mirrors
// ops/bitplane.py decode_frame).  mask_plane < 0 disables.
int decode_core_scalar(const uint8_t* bytes, int64_t nbits, int max_step,
                       const Spec& s, int mask_plane, uint32_t keep_mask,
                       uint32_t* mag, uint8_t* neg,
                       int16_t* last, uint8_t* sig0) {
  const int h = s.h, w = s.w, g = s.g, J = s.nchunks;
  const size_t n = (size_t)h * w;
  memset(sig0, 0, n);
  memset(neg, 0, n);
  memset(mag, 0, n * sizeof(uint32_t));
  for (size_t i = 0; i < n; ++i) last[i] = (int16_t)s.nplanes;
  std::vector<int16_t> newp(n, -1);  // plane at which coeff became significant
  std::vector<std::vector<uint8_t>> sig(g + 1);
  for (int k = 1; k <= g; ++k) sig[k].assign((size_t)(h >> k) * (w >> k), 0);
  // per-row "any significance" flags: rows with none are skipped (bit order
  // is unchanged; such rows emit/consume no bits at this plane)
  std::vector<std::vector<uint8_t>> rowany(g + 1);
  for (int k = 0; k <= g; ++k) rowany[k].assign(h >> k, 0);
  std::vector<uint8_t> rownew(h, 0);

  int64_t pos = 0;
  auto read = [&]() -> int {
    int bit = 0;
    if (pos < nbits) bit = (bytes[pos >> 3] >> (7 - (pos & 7))) & 1;
    ++pos;
    return bit;
  };

  int b_end = s.nplanes;
  for (int b = s.nplanes - 1; b >= 0 && pos < nbits; --b) {
    b_end = b;
    for (int k = g; k >= 1; --k) {
      int hk = h >> k, wk = w >> k;
      uint8_t* sk = sig[k].data();
      if (k == g) {
        if (max_step >= b) {
          for (int r = 0; r < hk; ++r)
            for (int c = 0; c < wk; ++c) {
              size_t i = (size_t)r * wk + c;
              if (!sk[i] && read()) {
                sk[i] = 1;
                rowany[k][r] = 1;
              }
            }
        }
      } else {
        const uint8_t* sp = sig[k + 1].data();
        int wk1 = wk >> 1;
        for (int r = 0; r < hk; ++r) {
          if (!rowany[k + 1][r >> 1]) continue;
          for (int c = 0; c < wk; ++c) {
            size_t i = (size_t)r * wk + c;
            if (sp[(size_t)(r >> 1) * wk1 + (c >> 1)] && !sk[i])
              if (read()) {
                sk[i] = 1;
                rowany[k][r] = 1;
              }
          }
        }
      }
    }
    const uint8_t* s1 = sig[1].data();
    int w1 = w >> 1;
    for (int j = 0; j < J; ++j) {
      if (b == mask_plane && !((keep_mask >> j) & 1u)) continue;
      int r0 = (j * h + J - 1) / J, r1 = ((j + 1) * h + J - 1) / J;
      for (int r = r0; r < r1; ++r) {
        if (!rowany[1][r >> 1]) continue;
        for (int c = 0; c < w; ++c) {
          size_t i = (size_t)r * w + c;
          if (s1[(size_t)(r >> 1) * w1 + (c >> 1)] && !sig0[i]) {
            if (read()) {
              sig0[i] = 1;
              mag[i] = 1u << b;
              last[i] = (int16_t)b;
              newp[i] = (int16_t)b;
              rowany[0][r] = 1;
              rownew[r] = 1;
            }
          }
        }
      }
      for (int r = r0; r < r1; ++r) {
        if (!rownew[r]) continue;
        for (int c = 0; c < w; ++c) {
          size_t i = (size_t)r * w + c;
          if (newp[i] == b) neg[i] = (uint8_t)read();
        }
      }
    }
    for (int j = 0; j < J; ++j) {
      if (b == mask_plane && !((keep_mask >> j) & 1u)) continue;
      int r0 = (j * h + J - 1) / J, r1 = ((j + 1) * h + J - 1) / J;
      for (int r = r0; r < r1; ++r) {
        if (!rowany[0][r]) continue;
        for (int c = 0; c < w; ++c) {
          size_t i = (size_t)r * w + c;
          if (sig0[i] && newp[i] != b) {
            if (pos < nbits) {
              mag[i] |= (uint32_t)read() << b;
              last[i] = (int16_t)b;
            } else {
              ++pos;  // past-the-end read: state frozen, position advances
            }
          }
        }
      }
    }
    std::fill(rownew.begin(), rownew.end(), 0);
  }
  return b_end;
}

// dispatchers: word-parallel fast path when the CPU has BMI2
void encode_one(const int32_t* coef, const Spec& s, int64_t trunc_bits,
                uint8_t* out) {
  if (use_fast())
    ebcc_fast::encode_one_fast(coef, to_fast(s), trunc_bits, out);
  else
    encode_one_scalar(coef, s, trunc_bits, out);
}

int decode_core(const uint8_t* bytes, int64_t nbits, int max_step,
                const Spec& s, int mask_plane, uint32_t keep_mask,
                uint32_t* mag, uint8_t* neg, int16_t* last, uint8_t* sig0) {
  if (use_fast())
    return ebcc_fast::decode_core_fast(bytes, nbits, max_step, to_fast(s),
                                       mask_plane, keep_mask, mag, neg, last,
                                       sig0);
  return decode_core_scalar(bytes, nbits, max_step, s, mask_plane, keep_mask,
                            mag, neg, last, sig0);
}

// f32 packer: midpoint-reconstructed coefficients.
void decode_one(const uint8_t* bytes, int64_t nbits, int max_step,
                const Spec& s, int mask_plane, uint32_t keep_mask,
                float* out) {
  const size_t n = (size_t)s.h * s.w;
  std::vector<uint32_t> mag(n);
  std::vector<uint8_t> neg(n), sig0(n);
  std::vector<int16_t> last(n);
  decode_core(bytes, nbits, max_step, s, mask_plane, keep_mask, mag.data(),
              neg.data(), last.data(), sig0.data());
  for (size_t i = 0; i < n; ++i) {
    if (!sig0[i]) {
      out[i] = 0.0f;
    } else {
      float half =
          last[i] > 0 ? (std::ldexp(1.0f, last[i]) - 1.0f) * 0.5f : 0.0f;
      float v = (float)mag[i] + half;
      out[i] = neg[i] ? -v : v;
    }
  }
}

// u16 packer: sign in bit 15, (last - b_end) in bit 14, (mag >> b_end) in
// bits 0-13.  Valid iff max_step - b_end <= 13 (ok flag); the device
// reconstructs mag = m14 << b_end and half from last = b_end + bit14.
int decode_one_u16(const uint8_t* bytes, int64_t nbits, int max_step,
                   const Spec& s, int mask_plane, uint32_t keep_mask,
                   uint16_t* out, int32_t* out_bend) {
  const size_t n = (size_t)s.h * s.w;
  std::vector<uint32_t> mag(n);
  std::vector<uint8_t> neg(n), sig0(n);
  std::vector<int16_t> last(n);
  int b_end = decode_core(bytes, nbits, max_step, s, mask_plane, keep_mask,
                          mag.data(), neg.data(), last.data(), sig0.data());
  if (b_end >= s.nplanes) b_end = 0;  // empty stream: all zero
  *out_bend = b_end;
  if (max_step - b_end > 13) return 0;  // would overflow 14 bits
  for (size_t i = 0; i < n; ++i) {
    if (!sig0[i]) {
      out[i] = 0;
    } else {
      uint16_t v = (uint16_t)(mag[i] >> b_end);
      if (last[i] > b_end) v |= 1u << 14;
      if (neg[i]) v |= 1u << 15;
      out[i] = v;
    }
  }
  return 1;
}

void run_threads(int n, int nthreads, const std::function<void(int)>& fn) {
  if (nthreads > n) nthreads = n;
  if (nthreads < 1) nthreads = 1;
  std::vector<std::thread> ts;
  ts.reserve(nthreads);
  for (int t = 0; t < nthreads; ++t)
    ts.emplace_back([&, t]() {
      for (int i = t; i < n; i += nthreads) fn(i);
    });
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// test hook: 0 = auto (BMI2 when available), 1 = force scalar, 2 = force
// the word-parallel path
void ebcc_coder_force_path(int v) { g_force_path = v; }

// 1 when the coder currently dispatches to the word-parallel BMI2 path
int ebcc_coder_fast_path() { return use_fast() ? 1 : 0; }

// coef: int32 [n, h*w]; trunc_bits: int64 [n]; out: zeroed uint8
// [n, cap_bytes] arena.
void ebcc_coder_encode_batch(const int32_t* coef, int n, int h, int w, int g,
                             int nplanes, int nchunks,
                             const int64_t* trunc_bits, uint8_t* out,
                             int64_t cap_bytes) {
  Spec s{h, w, g, nplanes, nchunks};
  int hw = (int)std::thread::hardware_concurrency();
  run_threads(n, hw, [&](int i) {
    encode_one(coef + (size_t)i * h * w, s, trunc_bits[i],
               out + (size_t)i * cap_bytes);
  });
}

// float32 variant: coefficients are exact integers (|v| < 2^22) shipped as
// float32, the exact transfer form the device pipeline emits.
void ebcc_coder_encode_batch_f32(const float* coef, int n, int h, int w,
                                 int g, int nplanes, int nchunks,
                                 const int64_t* trunc_bits, uint8_t* out,
                                 int64_t cap_bytes) {
  Spec s{h, w, g, nplanes, nchunks};
  int hw = (int)std::thread::hardware_concurrency();
  run_threads(n, hw, [&](int i) {
    const size_t sz = (size_t)h * w;
    std::vector<int32_t> tmp(sz);
    const float* src = coef + (size_t)i * sz;
    for (size_t k = 0; k < sz; ++k) tmp[k] = (int32_t)src[k];
    encode_one(tmp.data(), s, trunc_bits[i], out + (size_t)i * cap_bytes);
  });
}

// u16 variant: sign in bit 15, (mag >> shift[i]) in the low 15 bits.
void ebcc_coder_encode_batch_u16(const uint16_t* coef, const int32_t* shifts,
                                 int n, int h, int w, int g, int nplanes,
                                 int nchunks, const int64_t* trunc_bits,
                                 uint8_t* out, int64_t cap_bytes) {
  Spec s{h, w, g, nplanes, nchunks};
  int hw = (int)std::thread::hardware_concurrency();
  run_threads(n, hw, [&](int i) {
    const size_t sz = (size_t)h * w;
    std::vector<int32_t> tmp(sz);
    const uint16_t* src = coef + (size_t)i * sz;
    const int sh = shifts[i];
    for (size_t k = 0; k < sz; ++k) {
      int32_t mag = (int32_t)(src[k] & 0x7FFF) << sh;
      tmp[k] = (src[k] & 0x8000) ? -mag : mag;
    }
    encode_one(tmp.data(), s, trunc_bits[i], out + (size_t)i * cap_bytes);
  });
}

// u8 variant: sign in bit 7, (mag >> shift[i]) in the low 7 bits.
void ebcc_coder_encode_batch_u8(const uint8_t* coef, const int32_t* shifts,
                                int n, int h, int w, int g, int nplanes,
                                int nchunks, const int64_t* trunc_bits,
                                uint8_t* out, int64_t cap_bytes) {
  Spec s{h, w, g, nplanes, nchunks};
  int hw = (int)std::thread::hardware_concurrency();
  run_threads(n, hw, [&](int i) {
    const size_t sz = (size_t)h * w;
    std::vector<int32_t> tmp(sz);
    const uint8_t* src = coef + (size_t)i * sz;
    const int sh = shifts[i];
    for (size_t k = 0; k < sz; ++k) {
      int32_t mag = (int32_t)(src[k] & 0x7F) << sh;
      tmp[k] = (src[k] & 0x80) ? -mag : mag;
    }
    encode_one(tmp.data(), s, trunc_bits[i], out + (size_t)i * cap_bytes);
  });
}

// sparse variant: per frame, counts[i] (delta, value) pairs; position of
// entry k = cumulative sum of deltas[0..k]; value: sign in bit 15,
// (mag >> shifts[i]) in the low 15 bits.
void ebcc_coder_encode_batch_sparse(const uint16_t* deltas,
                                    const uint16_t* vals,
                                    const int32_t* counts,
                                    const int32_t* shifts, int64_t kcap,
                                    int n, int h, int w, int g, int nplanes,
                                    int nchunks, const int64_t* trunc_bits,
                                    uint8_t* out, int64_t cap_bytes) {
  Spec s{h, w, g, nplanes, nchunks};
  int hw = (int)std::thread::hardware_concurrency();
  run_threads(n, hw, [&](int i) {
    const size_t sz = (size_t)h * w;
    std::vector<int32_t> tmp(sz, 0);
    const uint16_t* d = deltas + (size_t)i * kcap;
    const uint16_t* v = vals + (size_t)i * kcap;
    const int sh = shifts[i];
    int64_t p = -1;
    for (int32_t k = 0; k < counts[i]; ++k) {
      p = (k == 0) ? (int64_t)d[k] : p + d[k];
      if (p >= (int64_t)sz) break;
      int32_t mag = (int32_t)(v[k] & 0x7FFF) << sh;
      tmp[p] = (v[k] & 0x8000) ? -mag : mag;
    }
    encode_one(tmp.data(), s, trunc_bits[i], out + (size_t)i * cap_bytes);
  });
}

// bytes: concatenated streams; offsets/sizes in bytes; nbits: stored stream
// lengths in bits; max_step: per-frame top plane.  out: float32 [n, h*w].
// mask_plane/keep_mask (format v4 chunk masking) may be NULL (no masking);
// mask_plane[i] < 0 disables masking for frame i.
void ebcc_coder_decode_batch(const uint8_t* bytes, const int64_t* offsets,
                             const int64_t* nbits, const int32_t* max_step,
                             const int32_t* mask_plane,
                             const uint32_t* keep_mask,
                             int n, int h, int w, int g, int nplanes,
                             int nchunks, float* out) {
  Spec s{h, w, g, nplanes, nchunks};
  int hw = (int)std::thread::hardware_concurrency();
  run_threads(n, hw, [&](int i) {
    decode_one(bytes + offsets[i], nbits[i], max_step[i], s,
               mask_plane ? mask_plane[i] : -1, keep_mask ? keep_mask[i] : 0,
               out + (size_t)i * h * w);
  });
}

// u16 variant (smaller host-to-device upload); per-frame ok flags report
// frames whose magnitudes would not fit 14 bits (caller falls back to f32).
void ebcc_coder_decode_batch_u16(const uint8_t* bytes, const int64_t* offsets,
                                 const int64_t* nbits,
                                 const int32_t* max_step,
                                 const int32_t* mask_plane,
                                 const uint32_t* keep_mask,
                                 int n, int h, int w,
                                 int g, int nplanes, int nchunks,
                                 uint16_t* out, int32_t* out_bend,
                                 int32_t* out_ok) {
  Spec s{h, w, g, nplanes, nchunks};
  int hw = (int)std::thread::hardware_concurrency();
  run_threads(n, hw, [&](int i) {
    out_ok[i] = decode_one_u16(bytes + offsets[i], nbits[i], max_step[i], s,
                               mask_plane ? mask_plane[i] : -1,
                               keep_mask ? keep_mask[i] : 0,
                               out + (size_t)i * h * w, out_bend + i);
  });
}

}  // extern "C"
