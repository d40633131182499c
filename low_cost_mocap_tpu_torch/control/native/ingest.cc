// Host-side frame ingest: fused threshold + MSB-first bit-pack.
//
// The live pipeline ships camera frames to the device as 1 bit/pixel
// (ops/detect.py pack_frames / unpack_bits) — the same on-camera
// thresholding trick commercial mocap rigs use.  Packing is on the per-frame
// host hot path, so it is done here in one fused pass (compare + movemask)
// instead of numpy's two-pass compare-then-packbits.
//
// Semantics: out bit (7 - j%8) of byte j/8 is (in[j] >= cutoff), matching
// numpy.packbits' MSB-first bit order exactly.  The caller derives `cutoff`
// from the float threshold so results stay bit-identical to the on-device
// thresholding path (see ops/detect.py).

#include <cstdint>
#include <cstddef>

#if defined(__SSE2__)
#include <emmintrin.h>
#endif
#if defined(__x86_64__)
#include <immintrin.h>
#endif

namespace {

// reverse-bits-in-byte lookup (movemask yields LSB-first bit order)
struct RevTable {
  uint8_t v[256];
  constexpr RevTable() : v() {
    for (int i = 0; i < 256; ++i) {
      uint8_t b = static_cast<uint8_t>(i);
      b = static_cast<uint8_t>((b & 0xF0) >> 4 | (b & 0x0F) << 4);
      b = static_cast<uint8_t>((b & 0xCC) >> 2 | (b & 0x33) << 2);
      b = static_cast<uint8_t>((b & 0xAA) >> 1 | (b & 0x55) << 1);
      v[i] = b;
    }
  }
};
constexpr RevTable kRev;

#if defined(__x86_64__)
// 32 pixels/iteration for AVX2 hosts (runtime-dispatched — the .so stays
// baseline-buildable; the function itself carries the target attribute).
__attribute__((target("avx2"))) void pack_bits_avx2(const uint8_t* in,
                                                    int64_t n_pixels,
                                                    uint8_t cutoff,
                                                    uint8_t* out) {
  const __m256i vcut = _mm256_set1_epi8(static_cast<char>(cutoff));
  int64_t i = 0;
  for (; i + 32 <= n_pixels; i += 32) {
    const __m256i x =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(in + i));
    const __m256i ge = _mm256_cmpeq_epi8(_mm256_max_epu8(x, vcut), x);
    const uint32_t mask =
        static_cast<uint32_t>(_mm256_movemask_epi8(ge));
    out[i / 8] = kRev.v[mask & 0xFF];
    out[i / 8 + 1] = kRev.v[(mask >> 8) & 0xFF];
    out[i / 8 + 2] = kRev.v[(mask >> 16) & 0xFF];
    out[i / 8 + 3] = kRev.v[(mask >> 24) & 0xFF];
  }
  for (; i < n_pixels; i += 8) {
    uint8_t b = 0;
    for (int j = 0; j < 8; ++j)
      b = static_cast<uint8_t>((b << 1) | (in[i + j] >= cutoff ? 1 : 0));
    out[i / 8] = b;
  }
}
#endif

}  // namespace

extern "C" {

// in: n_pixels uint8 values (n_pixels % 8 == 0); out: n_pixels/8 bytes.
void lcm_pack_bits(const uint8_t* in, int64_t n_pixels, uint8_t cutoff,
                   uint8_t* out) {
#if defined(__x86_64__)
  static const bool kHasAvx2 = __builtin_cpu_supports("avx2");
  if (kHasAvx2) {
    pack_bits_avx2(in, n_pixels, cutoff, out);
    return;
  }
#endif
  int64_t i = 0;
#if defined(__SSE2__)
  const __m128i vcut = _mm_set1_epi8(static_cast<char>(cutoff));
  for (; i + 16 <= n_pixels; i += 16) {
    const __m128i x =
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(in + i));
    // x >= cutoff (unsigned): max(x, cutoff) == x
    const __m128i ge = _mm_cmpeq_epi8(_mm_max_epu8(x, vcut), x);
    const int mask = _mm_movemask_epi8(ge);  // bit k = pixel i+k (LSB-first)
    out[i / 8] = kRev.v[mask & 0xFF];
    out[i / 8 + 1] = kRev.v[(mask >> 8) & 0xFF];
  }
#endif
  for (; i < n_pixels; i += 8) {
    uint8_t b = 0;
    for (int j = 0; j < 8; ++j)
      b = static_cast<uint8_t>((b << 1) | (in[i + j] >= cutoff ? 1 : 0));
    out[i / 8] = b;
  }
}

}  // extern "C"

extern "C" {

// Extract the bit-positions of all set bits in an MSB-first packed bitmap
// (the output of lcm_pack_bits).  Writes up to max_out pixel indices;
// returns the TOTAL number of set bits (callers detect overflow by
// count > max_out and fall back to dense ingest).  Thresholded mocap
// frames are ~99.9% zero (a few LED blobs on black), so scanning the
// packed bytes touches 1/8 of the pixels and almost never branches.
int64_t lcm_extract_bits(const uint8_t* packed, int64_t n_bytes,
                         int32_t* out_idx, int64_t max_out) {
  int64_t count = 0;
  int64_t i = 0;
#if defined(__SSE2__)
  const __m128i zero = _mm_setzero_si128();
  for (; i + 16 <= n_bytes; i += 16) {
    const __m128i x =
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(packed + i));
    // skip all-zero 16-byte blocks (the overwhelmingly common case)
    if (_mm_movemask_epi8(_mm_cmpeq_epi8(x, zero)) == 0xFFFF) continue;
    for (int64_t j = i; j < i + 16; ++j) {
      uint8_t b = packed[j];
      while (b) {
        const int bit = __builtin_clz(static_cast<unsigned>(b) << 24);
        if (count < max_out)
          out_idx[count] = static_cast<int32_t>(j * 8 + bit);
        ++count;
        b = static_cast<uint8_t>(b & ~(0x80u >> bit));
      }
    }
  }
#endif
  for (; i < n_bytes; ++i) {
    uint8_t b = packed[i];
    while (b) {
      const int bit = __builtin_clz(static_cast<unsigned>(b) << 24);
      if (count < max_out)
        out_idx[count] = static_cast<int32_t>(i * 8 + bit);
      ++count;
      b = static_cast<uint8_t>(b & ~(0x80u >> bit));
    }
  }
  return count;
}

}  // extern "C"
