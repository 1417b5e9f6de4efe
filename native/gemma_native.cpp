// gemma_native: host-side native runtime for the inference engine.
//
// The reference's runtime substrate is C++ (thread_pool.cpp, the patched
// ggml loader, hpc.cpp's host orchestration — see SURVEY.md §2). This
// rebuild keeps device compute in XLA/Pallas, but the load-time hot path —
// decoding multi-GB GGUF block-quant payloads and re-laying them out into
// the K-major device format of quant/qtensor.py — is pure host work and is
// implemented here natively, fanned out over a std::thread pool (the role
// /root/reference/src/thread_pool.cpp plays for the reference's matmul).
//
// Exposed as a C ABI consumed via ctypes (gemma_tpu/native/__init__.py).
// All codecs are bit-exact mirrors of quant/numpy_ref.py and the repack
// layout of quant/qtensor.py (parity-tested in tests/test_native.py):
//   * q4_0 blocks: 18B = f16 d + 16B nibbles      (kernals.cl:13-19 analog)
//   * q8_0 blocks: 34B = f16 d + 32 int8
//   * q4_K superblocks: 144B = f16 d, dmin + 12B 6-bit (sc,mn) + 128B nibbles
//   * q6_K superblocks: 210B = 128B ql + 64B qh + 16 int8 sc + f16 d
//
// Build: g++ -O3 -shared -fPIC (no external deps).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// f16 <-> f32 (bit-exact with numpy: IEEE 754 half, round-to-nearest-even)
// ---------------------------------------------------------------------------

float f16_to_f32(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t mant = h & 0x3FF;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;
    } else {  // subnormal: value = mant * 2^-24 -> normalize to 1.f * 2^(-14-s)
      int shift = 0;
      while (!(mant & 0x400)) {
        mant <<= 1;
        ++shift;
      }
      mant &= 0x3FF;
      bits = sign | ((uint32_t)(113 - shift) << 23) | (mant << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7F800000u | (mant << 13);
  } else {
    bits = sign | ((exp + 112) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

uint16_t f32_to_f16(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  uint32_t sign = (x >> 16) & 0x8000u;
  uint32_t aexp = (x >> 23) & 0xFF;
  uint32_t mant = x & 0x7FFFFFu;
  if (aexp == 0xFF) return (uint16_t)(sign | 0x7C00u | (mant ? 0x200u : 0));
  int e = (int)aexp - 127 + 15;
  if (e >= 31) return (uint16_t)(sign | 0x7C00u);  // overflow -> inf
  if (e <= 0) {
    if (e < -10) return (uint16_t)sign;  // underflow -> 0
    mant |= 0x800000u;                   // implicit bit
    uint32_t shift = (uint32_t)(14 - e);
    uint32_t half = mant >> shift;
    uint32_t rem = mant & ((1u << shift) - 1);
    uint32_t halfway = 1u << (shift - 1);
    if (rem > halfway || (rem == halfway && (half & 1))) ++half;  // RNE
    return (uint16_t)(sign | half);
  }
  uint32_t half = (uint32_t)(e << 10) | (mant >> 13);
  uint32_t rem = mant & 0x1FFF;
  if (rem > 0x1000 || (rem == 0x1000 && (half & 1))) ++half;  // RNE (may carry)
  return (uint16_t)(sign | half);
}

// ---------------------------------------------------------------------------
// Parallel row fan-out
// ---------------------------------------------------------------------------

int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n ? (int)n : 4;
}

template <typename F>
void parallel_rows(int64_t rows, F&& body) {
  int nt = std::min<int64_t>(hw_threads(), rows);
  if (nt <= 1) {
    body(0, rows);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(nt);
  int64_t chunk = (rows + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(rows, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([&body, lo, hi] { body(lo, hi); });
  }
  for (auto& t : ts) t.join();
}

inline uint16_t rd_f16(const uint8_t* p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}

// round-to-nearest-even f32 -> bf16 bits (matches ml_dtypes/numpy astype)
inline uint16_t f32_to_bf16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  uint32_t bias = 0x7FFFu + ((u >> 16) & 1u);
  return (uint16_t)((u + bias) >> 16);
}

inline float bf16_to_f32(uint16_t h) {
  uint32_t u = (uint32_t)h << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

// exact bf16 (hi, lo) split of an f16 value (quant/qtensor.py _hi_lo):
// hi = bf16(x), lo = bf16(x - hi); hi + lo == x bit-for-bit in f32
inline void bf16_hi_lo(uint16_t f16bits, uint16_t* hi, uint16_t* lo) {
  float x = f16_to_f32(f16bits);
  *hi = f32_to_bf16(x);
  *lo = f32_to_bf16(x - bf16_to_f32(*hi));
}

// ggml get_scale_min_k4 (numpy_ref._unpack_scale_min_k4)
void scale_min_k4(const uint8_t* s, uint8_t* sc, uint8_t* mn) {
  for (int j = 0; j < 4; ++j) {
    sc[j] = s[j] & 63;
    mn[j] = s[j + 4] & 63;
  }
  for (int j = 4; j < 8; ++j) {
    sc[j] = (uint8_t)((s[j + 4] & 0x0F) | ((s[j - 4] >> 6) << 4));
    mn[j] = (uint8_t)((s[j + 4] >> 4) | ((s[j] >> 6) << 4));
  }
}

// decode one q6_k superblock's 256 6-bit values (numpy_ref.dequant_q6_k)
void q6k_values(const uint8_t* ql, const uint8_t* qh, uint8_t* q /*256*/) {
  for (int n = 0; n < 2; ++n) {
    const uint8_t* lq = ql + n * 64;
    const uint8_t* hq = qh + n * 32;
    uint8_t* b = q + n * 128;
    for (int j = 0; j < 32; ++j) {
      b[j] = (uint8_t)((lq[j] & 0x0F) | (((hq[j] >> 0) & 3) << 4));
      b[32 + j] = (uint8_t)((lq[32 + j] & 0x0F) | (((hq[j] >> 2) & 3) << 4));
      b[64 + j] = (uint8_t)((lq[j] >> 4) | (((hq[j] >> 4) & 3) << 4));
      b[96 + j] = (uint8_t)((lq[32 + j] >> 4) | (((hq[j] >> 6) & 3) << 4));
    }
  }
}

}  // namespace

extern "C" {

int gt_version() { return 1; }
int gt_nthreads() { return hw_threads(); }

// ---------------------------------------------------------------------------
// Dequantization to f32: raw [rows, cols] ggml payload -> out[rows*cols]
// type codes match gguf.constants.GGMLType
// ---------------------------------------------------------------------------

int gt_dequant(int ggml_type, const uint8_t* raw, int64_t rows, int64_t cols,
               float* out) {
  switch (ggml_type) {
    case 0: {  // F32
      parallel_rows(rows, [&](int64_t lo, int64_t hi) {
        std::memcpy(out + lo * cols, raw + lo * cols * 4, (hi - lo) * cols * 4);
      });
      return 0;
    }
    case 1: {  // F16
      parallel_rows(rows, [&](int64_t lo, int64_t hi) {
        const uint8_t* p = raw + lo * cols * 2;
        float* o = out + lo * cols;
        for (int64_t i = 0; i < (hi - lo) * cols; ++i)
          o[i] = f16_to_f32(rd_f16(p + i * 2));
      });
      return 0;
    }
    case 30: {  // BF16
      parallel_rows(rows, [&](int64_t lo, int64_t hi) {
        const uint8_t* p = raw + lo * cols * 2;
        float* o = out + lo * cols;
        for (int64_t i = 0; i < (hi - lo) * cols; ++i) {
          uint16_t v;
          std::memcpy(&v, p + i * 2, 2);
          uint32_t bits = (uint32_t)v << 16;
          std::memcpy(o + i, &bits, 4);
        }
      });
      return 0;
    }
    case 2: {  // Q4_0: 18B blocks of 32
      int64_t nb = cols / 32;
      parallel_rows(rows, [&](int64_t lo, int64_t hi) {
        for (int64_t r = lo; r < hi; ++r) {
          const uint8_t* row = raw + r * nb * 18;
          float* o = out + r * cols;
          for (int64_t g = 0; g < nb; ++g) {
            const uint8_t* b = row + g * 18;
            float d = f16_to_f32(rd_f16(b));
            const uint8_t* qs = b + 2;
            for (int j = 0; j < 16; ++j) {
              o[g * 32 + j] = d * (float)((int)(qs[j] & 0x0F) - 8);
              o[g * 32 + 16 + j] = d * (float)((int)(qs[j] >> 4) - 8);
            }
          }
        }
      });
      return 0;
    }
    case 8: {  // Q8_0: 34B blocks of 32
      int64_t nb = cols / 32;
      parallel_rows(rows, [&](int64_t lo, int64_t hi) {
        for (int64_t r = lo; r < hi; ++r) {
          const uint8_t* row = raw + r * nb * 34;
          float* o = out + r * cols;
          for (int64_t g = 0; g < nb; ++g) {
            const uint8_t* b = row + g * 34;
            float d = f16_to_f32(rd_f16(b));
            const int8_t* qs = (const int8_t*)(b + 2);
            for (int j = 0; j < 32; ++j) o[g * 32 + j] = d * (float)qs[j];
          }
        }
      });
      return 0;
    }
    case 12: {  // Q4_K: 144B superblocks of 256
      int64_t nsb = cols / 256;
      parallel_rows(rows, [&](int64_t lo, int64_t hi) {
        for (int64_t r = lo; r < hi; ++r) {
          const uint8_t* row = raw + r * nsb * 144;
          float* o = out + r * cols;
          for (int64_t s = 0; s < nsb; ++s) {
            const uint8_t* b = row + s * 144;
            float d = f16_to_f32(rd_f16(b));
            float dmin = f16_to_f32(rd_f16(b + 2));
            uint8_t sc[8], mn[8];
            scale_min_k4(b + 4, sc, mn);
            const uint8_t* qs = b + 16;
            float* os = o + s * 256;
            for (int c = 0; c < 4; ++c) {
              float sl = d * sc[2 * c], ml = dmin * mn[2 * c];
              float sh = d * sc[2 * c + 1], mh = dmin * mn[2 * c + 1];
              const uint8_t* ch = qs + c * 32;
              for (int j = 0; j < 32; ++j) {
                os[c * 64 + j] = sl * (float)(ch[j] & 0x0F) - ml;
                os[c * 64 + 32 + j] = sh * (float)(ch[j] >> 4) - mh;
              }
            }
          }
        }
      });
      return 0;
    }
    case 14: {  // Q6_K: 210B superblocks of 256
      int64_t nsb = cols / 256;
      parallel_rows(rows, [&](int64_t lo, int64_t hi) {
        uint8_t q[256];
        for (int64_t r = lo; r < hi; ++r) {
          const uint8_t* row = raw + r * nsb * 210;
          float* o = out + r * cols;
          for (int64_t s = 0; s < nsb; ++s) {
            const uint8_t* b = row + s * 210;
            const int8_t* sc = (const int8_t*)(b + 192);
            float d = f16_to_f32(rd_f16(b + 208));
            q6k_values(b, b + 128, q);
            float* os = o + s * 256;
            for (int t = 0; t < 16; ++t) {
              float eff = d * (float)sc[t];
              for (int j = 0; j < 16; ++j)
                os[t * 16 + j] = eff * (float)((int)q[t * 16 + j] - 32);
            }
          }
        }
      });
      return 0;
    }
    default:
      return -1;  // unsupported: caller falls back to numpy
  }
}

// ---------------------------------------------------------------------------
// Repack into the K-major device layout of quant/qtensor.py (layout v2).
// Logical tensor [N=rows, K=cols]; outputs are [K-granule, N] row-major,
// i.e. out[kg * N + n]. 4-bit payloads are K-paired signed nibbles:
// byte[k', n] = (v[2k'] & 0xF) | (v[2k'+1] << 4), values pre-biased
// (q4_0/q4_k store q-8; q6_k stores s4 = (u & 15) - 8 of u = q+32, with
// the high 2 bits in a separate plane-major qh array); the matmul kernel
// sign-extends each nibble with two shifts.
// ---------------------------------------------------------------------------

inline uint8_t pack_pair(int v0, int v1) {
  return (uint8_t)((v0 & 0x0F) | ((v1 & 0x0F) << 4));
}

int gt_repack_q4_0(const uint8_t* raw, int64_t N, int64_t K, uint8_t* qs,
                   uint16_t* sc) {
  int64_t nb = K / 32;
  parallel_rows(N, [&](int64_t lo, int64_t hi) {
    for (int64_t n = lo; n < hi; ++n) {
      const uint8_t* row = raw + n * nb * 18;
      for (int64_t g = 0; g < nb; ++g) {
        const uint8_t* b = row + g * 18;
        sc[g * N + n] = rd_f16(b);
        // ggml order: element j<16 = lo nibble of byte j, else hi of j-16
        int e[32];
        for (int j = 0; j < 16; ++j) {
          e[j] = (b[2 + j] & 0x0F) - 8;
          e[16 + j] = (b[2 + j] >> 4) - 8;
        }
        for (int j = 0; j < 16; ++j)
          qs[(g * 16 + j) * N + n] = pack_pair(e[2 * j], e[2 * j + 1]);
      }
    }
  });
  return 0;
}

int gt_repack_q8_0(const uint8_t* raw, int64_t N, int64_t K, int8_t* qs,
                   uint16_t* sc) {
  int64_t nb = K / 32;
  parallel_rows(N, [&](int64_t lo, int64_t hi) {
    for (int64_t n = lo; n < hi; ++n) {
      const uint8_t* row = raw + n * nb * 34;
      for (int64_t g = 0; g < nb; ++g) {
        const uint8_t* b = row + g * 34;
        sc[g * N + n] = rd_f16(b);
        for (int j = 0; j < 32; ++j)
          qs[(g * 32 + j) * N + n] = (int8_t)b[2 + j];
      }
    }
  });
  return 0;
}

int gt_repack_q4_k(const uint8_t* raw, int64_t N, int64_t K, uint8_t* qs,
                   int8_t* meta_out) {
  // layout v4: ALL metadata in ONE int8 array [3K/32, N]; per superblock
  // 24 K-granule rows = 8 sc6, 8 mn6 (exact 6-bit sub-scales/mins), then
  // the bf16 hi/lo quad [d_hi, dmin_hi, d_lo, dmin_lo] as 4 low-byte rows
  // + 4 high-byte rows (the kernel rebuilds bf16 via a 16-bit bitcast and
  // reconstructs f16-exact d = hi + lo in f32)
  int64_t nsb = K / 256;
  parallel_rows(N, [&](int64_t lo, int64_t hi) {
    for (int64_t n = lo; n < hi; ++n) {
      const uint8_t* row = raw + n * nsb * 144;
      for (int64_t s = 0; s < nsb; ++s) {
        const uint8_t* b = row + s * 144;
        uint16_t quad[4];
        bf16_hi_lo(rd_f16(b), &quad[0], &quad[2]);
        bf16_hi_lo(rd_f16(b + 2), &quad[1], &quad[3]);
        uint8_t sc6[8], mn6[8];
        scale_min_k4(b + 4, sc6, mn6);
        int8_t* m = meta_out;
        for (int g = 0; g < 8; ++g) {
          m[(s * 24 + g) * N + n] = (int8_t)sc6[g];
          m[(s * 24 + 8 + g) * N + n] = (int8_t)mn6[g];
        }
        for (int r = 0; r < 4; ++r) {
          m[(s * 24 + 16 + r) * N + n] = (int8_t)(quad[r] & 0xFF);
          m[(s * 24 + 20 + r) * N + n] = (int8_t)(quad[r] >> 8);
        }
        // chunk c (32B): elements 64c+i = ch[i]&0xF (i<32), 64c+32+i = ch[i]>>4
        const uint8_t* ch0 = b + 16;
        for (int c = 0; c < 4; ++c) {
          const uint8_t* ch = ch0 + c * 32;
          int e[64];
          for (int i = 0; i < 32; ++i) {
            e[i] = (ch[i] & 0x0F) - 8;
            e[32 + i] = (ch[i] >> 4) - 8;
          }
          for (int j = 0; j < 32; ++j)
            qs[((int64_t)(s * 128 + c * 32 + j)) * N + n] =
                pack_pair(e[2 * j], e[2 * j + 1]);
        }
      }
    }
  });
  return 0;
}

int gt_repack_q6_k(const uint8_t* raw, int64_t N, int64_t K, uint8_t* ql_out,
                   uint8_t* qh_out, int8_t* sc8_out, uint16_t* d_out) {
  // layout v5 (split-plane, 6.75 bpw; qtensor.py pack_q6_k): the 6-bit
  // value u = q+32 splits into K-paired signed nibbles of s4 = (u&15)-8
  // (ql, [K/2, N]) and plane-major 2-bit fields of hi2 = u>>4 (qh,
  // [K/4, N]: byte row j of superblock s packs hi2[s*256 + i*64 + j] at
  // bits 2i..2i+1) + ggml's EXACT per-16 int8 scales + per-superblock d
  // as exact bf16 hi/lo pairs at K/64 granularity.
  int64_t nsb = K / 256;
  parallel_rows(N, [&](int64_t lo, int64_t hi) {
    uint8_t q[256];
    for (int64_t n = lo; n < hi; ++n) {
      const uint8_t* row = raw + n * nsb * 210;
      for (int64_t s = 0; s < nsb; ++s) {
        const uint8_t* b = row + s * 210;
        const int8_t* sc8 = (const int8_t*)(b + 192);
        uint16_t d_hi, d_lo;
        bf16_hi_lo(rd_f16(b + 208), &d_hi, &d_lo);
        for (int t = 0; t < 16; ++t)
          sc8_out[(s * 16 + t) * N + n] = sc8[t];
        d_out[(s * 4 + 0) * N + n] = d_hi;
        d_out[(s * 4 + 1) * N + n] = d_lo;
        d_out[(s * 4 + 2) * N + n] = d_hi;
        d_out[(s * 4 + 3) * N + n] = d_lo;
        q6k_values(b, b + 128, q);  // u = q+32 in 0..63
        for (int j = 0; j < 128; ++j)
          ql_out[(s * 128 + j) * N + n] =
              pack_pair((q[2 * j] & 15) - 8, (q[2 * j + 1] & 15) - 8);
        for (int j = 0; j < 64; ++j)
          qh_out[(s * 64 + j) * N + n] =
              (uint8_t)((q[j] >> 4) | ((q[64 + j] >> 4) << 2) |
                        ((q[128 + j] >> 4) << 4) | ((q[192 + j] >> 4) << 6));
      }
    }
  });
  return 0;
}

}  // extern "C"
