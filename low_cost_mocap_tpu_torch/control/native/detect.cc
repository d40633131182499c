// Host-side blob detection: connected components + centroids over the
// packed 1-bit frames the ingest path already produces (ingest.cc).
//
// The device detector (ops/detect.py find_blobs / ops/detect_pallas.py)
// costs ~160 us/frame of per-dispatch device time (scatter + fused kernel)
// even though thresholded mocap frames hold a handful of tiny LED blobs.
// Detecting on the host during ingest removes both from the device step:
// the step then starts at track_from_blobs with a ~100-byte (K, 2)
// centroid upload instead of a bitmap/index upload + on-device CC.
//
// Semantics match ops.detect.find_blobs exactly (threshold -> 8-connected
// components -> binary-mass centroids, components in raster order of their
// topmost-leftmost pixel, first max_blobs kept): a BFS seeded in raster
// scan order discovers each component at its minimum raster index, and
// integer coordinate sums converted to float32 reproduce the device
// kernel's f32 arithmetic bit-for-bit (coordinate sums < 2^24 are exact in
// f32, and a single f32 divide is IEEE-identical).  The device kernel's
// min-label propagation is truncated at cc_iters sweeps, so components
// with geodesic diameter > cc_iters can split there; the BFS here is exact
// CC (documented superset — identical for real LED blobs, which are a few
// pixels across).
//
// One implementation serves both centroid modes (gray == nullptr selects
// binary mass): the component discovery, zero-word skip, generation-
// stamped visited array and slot bookkeeping are shared, so the
// weighted and binary detectors cannot de-synchronize.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" void lcm_pack_bits(const uint8_t* in, int64_t n_pixels,
                              uint8_t cutoff, uint8_t* out);  // ingest.cc

#if defined(__x86_64__)
#include <immintrin.h>
#endif

namespace {

inline bool bit_at(const uint8_t* packed, int64_t idx) {
  return (packed[idx >> 3] >> (7 - (idx & 7))) & 1;
}

// reverse-bits-in-byte (movemask yields LSB-first; the bitmap is
// MSB-first) — same table as ingest.cc's (anonymous namespaces)
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
constexpr RevTable kRevD;

// One component's BFS + centroid, seeded at raster-minimal pixel p.
// Shared by the full-scan and sparse-seeded detectors so their centroid
// arithmetic cannot diverge (bit-identical outputs, tested).
inline void flood_component(const uint8_t* packed, const uint8_t* gray,
                            int32_t H, int32_t W, uint32_t* visited,
                            uint32_t gen, std::vector<int32_t>& stack,
                            int64_t p, float* centroid_xy, float* size_out) {
  int64_t count = 0, sum_x = 0, sum_y = 0;
  int64_t wsum = 0, wsum_x = 0, wsum_y = 0;
  visited[p] = gen;
  stack.push_back(static_cast<int32_t>(p));
  while (!stack.empty()) {
    const int64_t q = stack.back();
    stack.pop_back();
    const int32_t r = static_cast<int32_t>(q / W);
    const int32_t c = static_cast<int32_t>(q % W);
    ++count;
    sum_x += c;
    sum_y += r;
    if (gray) {
      const int64_t I = gray[q];
      wsum += I;
      wsum_x += I * c;
      wsum_y += I * r;
    }
    const int32_t r0 = r > 0 ? r - 1 : 0;
    const int32_t r1 = r < H - 1 ? r + 1 : H - 1;
    const int32_t c0 = c > 0 ? c - 1 : 0;
    const int32_t c1 = c < W - 1 ? c + 1 : W - 1;
    for (int32_t rr = r0; rr <= r1; ++rr)
      for (int32_t cc = c0; cc <= c1; ++cc) {
        const int64_t qq = static_cast<int64_t>(rr) * W + cc;
        if (visited[qq] != gen && bit_at(packed, qq)) {
          visited[qq] = gen;
          stack.push_back(static_cast<int32_t>(qq));
        }
      }
  }
  if (gray) {
    const double ws = wsum > 0 ? static_cast<double>(wsum) : 1.0;
    centroid_xy[0] = static_cast<float>(wsum_x / ws);
    centroid_xy[1] = static_cast<float>(wsum_y / ws);
  } else {
    const float m00 = static_cast<float>(count);
    centroid_xy[0] = static_cast<float>(sum_x) / m00;
    centroid_xy[1] = static_cast<float>(sum_y) / m00;
  }
  *size_out = static_cast<float>(count);
}

// Shared CC + centroid pass.  gray == nullptr: binary-mass centroids,
// f32 arithmetic identical to the device kernel (integer sums exact in
// f32 below 2^24, ONE f32 divide).  gray != nullptr: intensity-weighted
// centroids, sum(I*x)/sum(I) over the component's ORIGINAL uint8
// intensities — sub-pixel recovery of a blob's optical centre (a Gaussian
// spot's weighted mean is its true centre; the binary centroid quantises
// at the threshold boundary).  Integer sums in int64, one double divide:
// deterministic regardless of traversal order.
int32_t detect_impl(const uint8_t* packed, const uint8_t* gray, int32_t H,
                    int32_t W, int32_t max_blobs, float* centroids,
                    uint8_t* valid, float* sizes) {
  // generation-stamped visited array: no per-frame memset of H*W bytes
  static thread_local std::vector<uint32_t> visited;
  static thread_local uint32_t generation = 0;
  static thread_local std::vector<int32_t> stack;
  const int64_t n = static_cast<int64_t>(H) * W;
  if (static_cast<int64_t>(visited.size()) < n) {
    visited.assign(n, 0);
    generation = 0;
  }
  ++generation;
  if (generation == 0) {  // wrap: reset once every 4B frames
    std::fill(visited.begin(), visited.end(), 0);
    generation = 1;
  }
  const uint32_t gen = generation;
  stack.clear();

  std::memset(centroids, 0, sizeof(float) * 2 * max_blobs);
  std::memset(valid, 0, max_blobs);
  std::memset(sizes, 0, sizeof(float) * max_blobs);

  int32_t k = 0;
  const int64_t n_words = n >> 6;  // full 64-bit words of the bitmap
  for (int64_t wi = 0; wi <= n_words && k < max_blobs; ++wi) {
    // skip zero 64-pixel blocks (the overwhelmingly common case)
    if (wi < n_words) {
      uint64_t w;
      std::memcpy(&w, packed + (wi << 3), 8);
      if (w == 0) continue;
    }
    const int64_t base = wi << 6;
    const int64_t end = base + 64 < n ? base + 64 : n;
    for (int64_t p = base; p < end && k < max_blobs; ++p) {
      if (!bit_at(packed, p) || visited[p] == gen) continue;
      // new component; p is its minimum raster index (raster-order seed)
      flood_component(packed, gray, H, W, visited.data(), gen, stack, p,
                      centroids + 2 * k, sizes + k);
      valid[k] = 1;
      ++k;
    }
  }
  return k;
}

// ---------------------------------------------------------------------------
// Sparse one-pass ingest+detect: threshold-scan the uint8 frame directly,
// touch the bitmap ONLY at nonzero bytes, seed CC from the dirty-byte list.
//
// The split path writes a full H*W/8 bitmap and then re-scans all of it;
// for a thresholded mocap frame (~99.9% dark) that is almost entirely
// wasted memory traffic.  Here one streaming AVX2 pass over the pixels
// emits only the nonzero packed bytes (raster-ordered dirty list, so the
// component seeds keep the full scan's raster order), and the persistent
// thread-local bitmap is cleaned by re-zeroing LAST frame's dirty bytes —
// O(blob pixels), not O(H*W).  Outputs are bit-identical to detect_impl
// on pack_bits' bitmap (tested).
// ---------------------------------------------------------------------------

struct SparseScan {
  std::vector<uint8_t> bitmap;   // persistent, zero outside dirty bytes
  std::vector<int32_t> dirty;    // nonzero byte offsets, raster order
};

#if defined(__x86_64__)
// 64 pixels/iteration via AVX-512BW mask compares (one 64-bit mask per
// load, no movemask shuffling); the dark common case is one load + one
// ktest per cache line.
__attribute__((target("avx512f,avx512bw"))) void scan_avx512(
    const uint8_t* frame, int64_t n, uint8_t cutoff, uint8_t* bitmap,
    std::vector<int32_t>& dirty) {
  const __m512i vcut = _mm512_set1_epi8(static_cast<char>(cutoff));
  int64_t i = 0;
  for (; i + 64 <= n; i += 64) {
    const __m512i x =
        _mm512_loadu_si512(reinterpret_cast<const void*>(frame + i));
    const uint64_t mask = _mm512_cmp_epu8_mask(x, vcut, _MM_CMPINT_NLT);
    if (mask == 0) continue;                    // the common case: dark
    for (int b = 0; b < 8; ++b) {
      const uint8_t m = static_cast<uint8_t>(mask >> (8 * b));
      if (!m) continue;
      const int32_t off = static_cast<int32_t>(i / 8) + b;
      bitmap[off] = kRevD.v[m];
      dirty.push_back(off);
    }
  }
  for (; i < n; i += 8) {
    uint8_t m = 0;
    for (int j = 0; j < 8; ++j)
      m = static_cast<uint8_t>((m << 1) | (frame[i + j] >= cutoff ? 1 : 0));
    if (m) {
      bitmap[i / 8] = m;
      dirty.push_back(static_cast<int32_t>(i / 8));
    }
  }
}

__attribute__((target("avx2"))) void scan_avx2(const uint8_t* frame,
                                               int64_t n, uint8_t cutoff,
                                               uint8_t* bitmap,
                                               std::vector<int32_t>& dirty) {
  const __m256i vcut = _mm256_set1_epi8(static_cast<char>(cutoff));
  int64_t i = 0;
  for (; i + 32 <= n; i += 32) {
    const __m256i x =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(frame + i));
    const __m256i ge = _mm256_cmpeq_epi8(_mm256_max_epu8(x, vcut), x);
    const uint32_t mask = static_cast<uint32_t>(_mm256_movemask_epi8(ge));
    if (mask == 0) continue;                    // the common case: dark
    for (int b = 0; b < 4; ++b) {
      const uint8_t m = static_cast<uint8_t>(mask >> (8 * b));
      if (!m) continue;
      const int32_t off = static_cast<int32_t>(i / 8) + b;
      bitmap[off] = kRevD.v[m];
      dirty.push_back(off);
    }
  }
  for (; i < n; i += 8) {
    uint8_t m = 0;
    for (int j = 0; j < 8; ++j)
      m = static_cast<uint8_t>((m << 1) | (frame[i + j] >= cutoff ? 1 : 0));
    if (m) {
      bitmap[i / 8] = m;
      dirty.push_back(static_cast<int32_t>(i / 8));
    }
  }
}
#endif

void scan_scalar(const uint8_t* frame, int64_t n, uint8_t cutoff,
                 uint8_t* bitmap, std::vector<int32_t>& dirty) {
  for (int64_t i = 0; i < n; i += 8) {
    uint8_t m = 0;
    for (int j = 0; j < 8; ++j)
      m = static_cast<uint8_t>((m << 1) | (frame[i + j] >= cutoff ? 1 : 0));
    if (m) {
      bitmap[i / 8] = m;
      dirty.push_back(static_cast<int32_t>(i / 8));
    }
  }
}

int32_t ingest_detect_cam(const uint8_t* frame, int32_t H, int32_t W,
                          uint8_t cutoff, int32_t max_blobs,
                          bool weighted, float* centroids, uint8_t* valid,
                          float* sizes) {
  static thread_local SparseScan ss;
  static thread_local std::vector<uint32_t> visited;
  static thread_local uint32_t generation = 0;
  static thread_local std::vector<int32_t> stack;
  const int64_t n = static_cast<int64_t>(H) * W;
  const int64_t stride = n >> 3;
  if (static_cast<int64_t>(ss.bitmap.size()) < stride) {
    ss.bitmap.assign(stride, 0);
    ss.dirty.clear();
  }
  for (const int32_t off : ss.dirty) ss.bitmap[off] = 0;  // O(blob bytes)
  ss.dirty.clear();

  if (static_cast<int64_t>(visited.size()) < n) {
    visited.assign(n, 0);
    generation = 0;
  }
  ++generation;
  if (generation == 0) {
    std::fill(visited.begin(), visited.end(), 0);
    generation = 1;
  }
  const uint32_t gen = generation;
  stack.clear();

#if defined(__x86_64__)
  static const bool kHasAvx512 = __builtin_cpu_supports("avx512bw");
  static const bool kHasAvx2 = __builtin_cpu_supports("avx2");
  if (kHasAvx512)
    scan_avx512(frame, n, cutoff, ss.bitmap.data(), ss.dirty);
  else if (kHasAvx2)
    scan_avx2(frame, n, cutoff, ss.bitmap.data(), ss.dirty);
  else
    scan_scalar(frame, n, cutoff, ss.bitmap.data(), ss.dirty);
#else
  scan_scalar(frame, n, cutoff, ss.bitmap.data(), ss.dirty);
#endif

  std::memset(centroids, 0, sizeof(float) * 2 * max_blobs);
  std::memset(valid, 0, max_blobs);
  std::memset(sizes, 0, sizeof(float) * max_blobs);

  int32_t k = 0;
  const uint8_t* packed = ss.bitmap.data();
  for (const int32_t off : ss.dirty) {
    if (k >= max_blobs) break;
    const uint8_t b = packed[off];
    for (int j = 0; j < 8 && k < max_blobs; ++j) {
      if (!((b >> (7 - j)) & 1)) continue;
      const int64_t p = (static_cast<int64_t>(off) << 3) + j;
      if (visited[p] == gen) continue;
      flood_component(packed, weighted ? frame : nullptr, H, W,
                      visited.data(), gen, stack, p, centroids + 2 * k,
                      sizes + k);
      valid[k] = 1;
      ++k;
    }
  }
  return k;
}

}  // namespace

extern "C" {

// One camera: packed (H*W/8 bytes, MSB-first rows), outputs
// centroids (max_blobs*2 f32, xy), valid (max_blobs u8),
// sizes (max_blobs f32).  Returns the number of slots filled.
int32_t lcm_detect_blobs(const uint8_t* packed, int32_t H, int32_t W,
                         int32_t max_blobs, float* centroids,
                         uint8_t* valid, float* sizes) {
  return detect_impl(packed, nullptr, H, W, max_blobs, centroids, valid,
                     sizes);
}

// All cameras in one call (amortizes the FFI crossing):
// packed (C, H*W/8) contiguous; outputs (C, max_blobs, ...) contiguous.
void lcm_detect_blobs_multi(const uint8_t* packed, int32_t n_cams,
                            int32_t H, int32_t W, int32_t max_blobs,
                            float* centroids, uint8_t* valid,
                            float* sizes) {
  const int64_t stride = (static_cast<int64_t>(H) * W) >> 3;
  for (int32_t c = 0; c < n_cams; ++c)
    detect_impl(packed + c * stride, nullptr, H, W, max_blobs,
                centroids + c * 2 * max_blobs, valid + c * max_blobs,
                sizes + c * max_blobs);
}

// Intensity-weighted variant: same components (8-connectivity over the
// thresholded bitmap), sub-pixel weighted centroids (see detect_impl).
int32_t lcm_detect_blobs_weighted(const uint8_t* packed,
                                  const uint8_t* gray, int32_t H,
                                  int32_t W, int32_t max_blobs,
                                  float* centroids, uint8_t* valid,
                                  float* sizes) {
  return detect_impl(packed, gray, H, W, max_blobs, centroids, valid,
                     sizes);
}

void lcm_detect_blobs_weighted_multi(const uint8_t* packed,
                                     const uint8_t* gray, int32_t n_cams,
                                     int32_t H, int32_t W,
                                     int32_t max_blobs, float* centroids,
                                     uint8_t* valid, float* sizes) {
  const int64_t fstride = static_cast<int64_t>(H) * W;
  const int64_t stride = fstride >> 3;
  for (int32_t c = 0; c < n_cams; ++c)
    detect_impl(packed + c * stride, gray + c * fstride, H, W, max_blobs,
                centroids + c * 2 * max_blobs, valid + c * max_blobs,
                sizes + c * max_blobs);
}

// Fused per-frame-set ingest: threshold+pack (ingest.cc) straight into a
// thread-local bitmap, then CC centroids — ONE FFI crossing per frame set
// and no Python-visible intermediate bitmap.  This is the live host-detect
// hot path (runtime/engine.py; bench.py): the separate pack_bits +
// detect_blobs calls cost ~120 us per 4-camera frame set in wrapper +
// crossing overhead alone; fused is ~half that.  weighted != 0 selects
// intensity-weighted sub-pixel centroids (EngineConfig.weighted_centroids).
void lcm_ingest_detect_multi(const uint8_t* frames, int32_t n_cams,
                             int32_t H, int32_t W, uint8_t cutoff,
                             int32_t max_blobs, int32_t weighted,
                             float* centroids, uint8_t* valid,
                             float* sizes) {
  const int64_t fstride = static_cast<int64_t>(H) * W;
  for (int32_t c = 0; c < n_cams; ++c)
    ingest_detect_cam(frames + c * fstride, H, W, cutoff, max_blobs,
                      weighted != 0, centroids + c * 2 * max_blobs,
                      valid + c * max_blobs, sizes + c * max_blobs);
}

// Fused ingest straight into the device-upload layout: out is
// (n_frames, max_blobs, 3) float32, slot = [x, y, valid] — exactly the
// packed centroid tensor the jitted step consumes (models/pipeline
// track_from_blobs takes packed[..., :2] / packed[..., 2] > 0.5).  One
// call covers an arbitrary run of frames (a dispatch_batch worth of
// frame sets is n_frames = B * C), eliminating the per-frame Python
// packing loop + np.stack that dominated batched-dispatch host cost.
void lcm_ingest_detect_packed(const uint8_t* frames, int32_t n_frames,
                              int32_t H, int32_t W, uint8_t cutoff,
                              int32_t max_blobs, int32_t weighted,
                              float* out) {
  static thread_local std::vector<float> cent, siz;
  static thread_local std::vector<uint8_t> val;
  if (static_cast<int32_t>(val.size()) < max_blobs) {
    cent.resize(2 * static_cast<size_t>(max_blobs));
    siz.resize(static_cast<size_t>(max_blobs));
    val.resize(static_cast<size_t>(max_blobs));
  }
  const int64_t fstride = static_cast<int64_t>(H) * W;
  for (int32_t c = 0; c < n_frames; ++c) {
    ingest_detect_cam(frames + c * fstride, H, W, cutoff, max_blobs,
                      weighted != 0, cent.data(), val.data(), siz.data());
    float* o = out + static_cast<int64_t>(c) * 3 * max_blobs;
    for (int32_t k = 0; k < max_blobs; ++k) {
      o[3 * k] = cent[2 * k];
      o[3 * k + 1] = cent[2 * k + 1];
      o[3 * k + 2] = val[k] ? 1.0f : 0.0f;
    }
  }
}

}  // extern "C"
