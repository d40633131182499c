// Blob detection kernel: threshold -> truncated connected components ->
// the first K components in raster order with binary moments.
//
// Replaces the TPU kernel low_cost_mocap_tpu/ops/detect_pallas.py
// (_detect_kernel and _shift_min, launched by find_blobs_pallas).  Per
// camera: threshold; label each lit pixel with its raster index; cc_iters
// masked 3x3 min-label sweeps with out-of-frame pixels as big = H*W; the
// first K distinct labels in ascending order; m00, sum x, sum y.
//
// What bounds it on an H100.  Not bytes (the float frames are 1.6 MB at
// the main path's 4x320x320) and not the card's integer rate: the sweeps
// over the lit pixels are a few hundred thousand min/select operations.
// What is left is latency: a chain of sweeps, each a barrier apart, in the
// few blocks that hold lit pixels, then one short pass that orders the
// roots.  A mocap frame is almost all dark, so the design does work only
// where a pixel is lit and keeps the label image out of device memory.
//
// 1. propagate_kernel, grid (tiles_x, tiles_y, C), 32x32 output tiles,
//    512 threads (32 x 16).  A block first reads its own tile; a tile with
//    no lit pixel contributes nothing and the block returns.  Otherwise it
//    loads the tile plus a halo of h pixels into shared memory (both
//    buffers) and runs Jacobi sweeps between the two.  A label moves one
//    pixel a sweep, so the tile is exact when sweep s updates the pixels
//    at least s from the window's border.  (In-place Gauss-Seidel sweeps
//    would carry labels further and join long components that the
//    reference splits.)  Unlit pixels stay big, so a sweep visits only the
//    bounding box of the window's lit pixels, and the block stops as soon
//    as a sweep changes nothing: the next sweep's window lies inside this
//    one and reads the same values, so every later sweep is the identity.
//    In the last pass the labels never reach device memory: each lit pixel
//    of the tile sets bit l of its camera's presence bitmap (H*W bits) and
//    writes the record (l, x, y) into the tile's own segment of a record
//    list, ranked by a ballot a warp and a prefix over the tile's 32 rows;
//    the block writes its tile's count (0 for a dark tile), so no global
//    atomic sits on the chain and nothing but the bitmap needs zeroing.
// 2. finish_kernel, one block per camera.  Each thread counts the set bits
//    of a run of bitmap words (__popc), a block prefix sum ranks them, and
//    the first K set bits in ascending order are the roots.  The block then
//    reads the camera's records, finds each label among the roots by
//    binary search and adds 1, x and y to the root's integer moments with
//    shared-memory atomics, which give the same sums in any order (m00 is
//    32-bit, sum x and sum y 64-bit, so no frame size overflows them).
//    cent = float(sum x) / max(float(m00), 1) is the float32 rounding of
//    the plain version's integer sums.  Slots past the last root get zeros.
//    Only the bitmap is zeroed (a memset on the launch's stream): 51 KB at
//    the main path's shapes, where dense per-label accumulators would be
//    8 MB.
//
// Tile and block.  A 32x32 tile with the main path's 24-pixel halo is an
// 80x80 window, 51 KB in two buffers: four blocks fit an SM, and the 400
// blocks of a fully lit 4x320x320 frame set run in one wave on 132 SMs.  A
// larger tile cuts the halo's redundant work (6.25x the tile's pixels at
// 32, 3x at 64) but in a sparse frame the few lit tiles run side by side,
// so what counts is one block's latency, and that grows with its window.
// 512 threads make each sweep over a fully lit 80x80 window 12.5 pixels a
// thread.
//
// Any cc_iters.  A halo of h needs 2 (32 + 2h)^2 int32 of shared memory;
// 227 KB hold h <= 69.  More sweeps run in passes of at most 69: every
// pass but the last writes its tiles' labels to a global int32 buffer
// (ping-pong between two), and the next pass reads them with its halo.
// Jacobi sweeps compose, so the result after all passes is exact.  A pixel
// is lit iff its label is below big, in every pass; an empty tile of a
// pass that writes labels writes big.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int BX = 32, BY = 16, NT = BX * BY;
constexpr int TILE_PIXELS = TILE * TILE;
// a block's shared memory on Hopper (232,448 bytes), less room for the
// kernels' static shared memory
constexpr int DYN_SMEM_LIMIT = 232448 - 1024;
constexpr int FINISH_THREADS = 1024;

__device__ __forceinline__ int read_label(const float* __restrict__ frame,
                                          const int* __restrict__ lab_in,
                                          int gy, int gx, int H, int W,
                                          float threshold) {
  if (gy < 0 || gy >= H || gx < 0 || gx >= W) return H * W;
  const int p = gy * W + gx;
  if (lab_in != nullptr) return lab_in[p];
  return frame[p] > threshold ? p : H * W;
}

// One pass of h sweeps.  lab_in == nullptr: the first pass, labels from
// the thresholded frame.  lab_out == nullptr: the last pass, which records
// the roots' presence and the lit pixels instead of writing labels.
__global__ void __launch_bounds__(BX * BY)
propagate_kernel(const float* __restrict__ frames,
                 const int* __restrict__ lab_in, int H, int W,
                 float threshold, int h, int* __restrict__ lab_out,
                 unsigned* __restrict__ bitmap, int* __restrict__ count,
                 int* __restrict__ rec_l, int* __restrict__ rec_x,
                 int* __restrict__ rec_y) {
  extern __shared__ int smem[];
  __shared__ int box[4];   // rows lo, hi, cols lo, hi of the lit pixels
  const int R = TILE + 2 * h;
  const int c = blockIdx.z;
  const int n = H * W;
  const int big = n;
  const int ty0 = blockIdx.y * TILE, tx0 = blockIdx.x * TILE;
  const float* frame = frames + (size_t)c * n;
  const int* lin = lab_in == nullptr ? nullptr : lab_in + (size_t)c * n;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * BX + tx;

  // skip a tile with no lit pixel
  int lit = 0;
  for (int ly = ty; ly < TILE; ly += BY)
    for (int lx = tx; lx < TILE; lx += BX)
      lit |= read_label(frame, lin, ty0 + ly, tx0 + lx, H, W, threshold) <
             big;
  if (tid == 0) {
    box[0] = box[2] = R;
    box[1] = box[3] = -1;
  }
  if (!__syncthreads_or(lit)) {
    if (lab_out == nullptr && tid == 0)
      count[(size_t)c * gridDim.x * gridDim.y + blockIdx.y * gridDim.x +
            blockIdx.x] = 0;
    if (lab_out != nullptr) {
      int* lout = lab_out + (size_t)c * n;
      for (int ly = ty; ly < TILE && ty0 + ly < H; ly += BY)
        for (int lx = tx; lx < TILE && tx0 + lx < W; lx += BX)
          lout[(ty0 + ly) * W + tx0 + lx] = big;
    }
    return;
  }

  // load the window into both buffers, and bound its lit pixels; eight
  // loads a round are issued before any is used, so their latencies
  // overlap.  Positions advance by NT pixels without a division.
  const int y0 = ty0 - h, x0 = tx0 - h;
  int* src = smem;
  int* dst = smem + R * R;
  int rlo = R, rhi = -1, clo = R, chi = -1;
  const int dq = NT / R, dr = NT % R;
  int ly = tid / R, lx = tid % R;
  while (ly < R) {
    int l[8], at[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      at[k] = ly < R ? ly * R + lx : -1;
      l[k] = ly < R ? read_label(frame, lin, y0 + ly, x0 + lx, H, W,
                                 threshold)
                    : big;
      if (l[k] < big) {
        rlo = min(rlo, ly);
        rhi = max(rhi, ly);
        clo = min(clo, lx);
        chi = max(chi, lx);
      }
      ly += dq;
      lx += dr;
      if (lx >= R) {
        lx -= R;
        ++ly;
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (at[k] >= 0) {
        src[at[k]] = l[k];
        dst[at[k]] = l[k];
      }
    }
  }
  rlo = __reduce_min_sync(0xffffffffu, rlo);
  rhi = __reduce_max_sync(0xffffffffu, rhi);
  clo = __reduce_min_sync(0xffffffffu, clo);
  chi = __reduce_max_sync(0xffffffffu, chi);
  if ((tid & 31) == 0 && rhi >= 0) {
    atomicMin(box, rlo);
    atomicMax(box + 1, rhi);
    atomicMin(box + 2, clo);
    atomicMax(box + 3, chi);
  }
  __syncthreads();
  // unlit pixels stay big, so a sweep only visits the lit pixels' box;
  // outside it both buffers hold big
  rlo = box[0];
  rhi = box[1];
  clo = box[2];
  chi = box[3];

  // this thread's pixels of the box: the first at (py, px), then every
  // NT-th in raster order; a sweep s updates those at least s from the
  // window's border
  const int bw = chi - clo + 1;
  const int npx = (rhi - rlo + 1) * bw;
  const int bq = NT / bw, br = NT % bw;
  const int py = rlo + tid / bw, px = clo + tid % bw;
  for (int s = 1; s <= h; ++s) {
    int changed = 0;
    int y = py, x = px;
    for (int i = tid; i < npx; i += NT) {
      if (y >= s && y < R - s && x >= s && x < R - s) {
        const int* p = src + y * R + x;
        int v = p[0];
        if (v != big) {
          const int up = min(min(p[-R - 1], p[-R]), p[-R + 1]);
          const int mid = min(min(p[-1], v), p[1]);
          const int dn = min(min(p[R - 1], p[R]), p[R + 1]);
          const int m = min(min(up, mid), dn);
          changed |= m != v;
          v = m;
        }
        dst[y * R + x] = v;
      }
      y += bq;
      x += br;
      if (x >= clo + bw) {
        x -= bw;
        ++y;
      }
    }
    int* t = src;
    src = dst;
    dst = t;
    if (!__syncthreads_or(changed)) break;   // a fixed point: stop
  }

  // one warp per tile row (BX == TILE), so the ballots below are whole
  const int ntiles = gridDim.x * gridDim.y;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const size_t seg = ((size_t)c * ntiles + tile) * TILE_PIXELS;
  unsigned lit_w[TILE / BY];
  int l_own[TILE / BY];
#pragma unroll
  for (int r = 0; r < TILE / BY; ++r) {
    const int ly = h + ty + r * BY;
    const int gy = y0 + ly, gx = x0 + h + tx;
    const int l = gy < H && gx < W ? src[ly * R + h + tx] : big;
    if (lab_out != nullptr && gy < H && gx < W)
      lab_out[(size_t)c * n + gy * W + gx] = l;
    l_own[r] = l;
    lit_w[r] = __ballot_sync(0xffffffffu, l < big);
  }
  if (lab_out != nullptr) return;
  // each warp's lit pixels, ranked within the tile in warp order
  __shared__ int warp_lit[BY * (TILE / BY) + 1];
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < TILE / BY; ++r)
      warp_lit[r * BY + ty] = __popc(lit_w[r]);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < TILE / BY; ++r) {
    const int w = r * BY + ty;
    int base = 0;
    for (int v = 0; v < w; ++v) base += warp_lit[v];
    const int l = l_own[r];
    if (l < big) {
      atomicOr(bitmap + (size_t)c * ((n + 31) / 32) + (l >> 5),
               1u << (l & 31));
      const size_t e = seg + base + __popc(lit_w[r] & ((1u << tx) - 1u));
      rec_l[e] = l;
      rec_x[e] = x0 + h + tx;
      rec_y[e] = y0 + h + ty + r * BY;
    }
    if (w == TILE - 1 && tx == 0)
      count[(size_t)c * ntiles + tile] = base + __popc(lit_w[r]);
  }
}

// Exclusive prefix sum over the block; *total gets the sum of all.
__device__ int block_exclusive_scan(int v, int* red, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  int inc = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += o;
  }
  if (lane == 31) red[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? red[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += o;
    }
    red[lane] = w;   // inclusive sums of the warps' totals
  }
  __syncthreads();
  *total = red[nwarps - 1];
  return inc - v + (warp > 0 ? red[warp - 1] : 0);
}

__global__ void __launch_bounds__(FINISH_THREADS)
finish_kernel(const unsigned* __restrict__ bitmap,
              const int* __restrict__ count, const int* __restrict__ rec_l,
              const int* __restrict__ rec_x, const int* __restrict__ rec_y,
              int n, int ntiles, int K, float* __restrict__ cent,
              unsigned char* __restrict__ valid, float* __restrict__ size) {
  // K slots each: sum x and sum y (u64), m00 (u32), roots (int)
  extern __shared__ unsigned long long acc[];
  unsigned long long* sx = acc;
  unsigned long long* sy = acc + K;
  unsigned* m00 = (unsigned*)(acc + 2 * K);
  int* roots = (int*)(m00 + K);
  __shared__ int red[32];
  const int c = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int nw = (n + 31) / 32;
  const unsigned* bits = bitmap + (size_t)c * nw;
  const int* cnt_c = count + (size_t)c * ntiles;
  const int wpt = (nw + T - 1) / T;
  const int w0 = tid * wpt;
  const int w1 = min(w0 + wpt, nw);

  // the first round of tile counts (one a thread), beside the bitmap
  int my_cnt = tid < ntiles ? cnt_c[tid] : 0;
  for (int j = tid; j < K; j += T) {
    sx[j] = sy[j] = 0ull;
    m00[j] = 0u;
  }
  int cnt = 0;
  for (int w = w0; w < w1; ++w) cnt += __popc(bits[w]);
  int total;
  int rank = block_exclusive_scan(cnt, red, &total);
  for (int w = w0; w < w1 && rank < K; ++w) {
    unsigned b = bits[w];
    while (b != 0u && rank < K) {
      roots[rank++] = w * 32 + __ffs(b) - 1;
      b &= b - 1u;
    }
  }
  __syncthreads();

  // moments: each recorded lit pixel whose label is a root (the roots are
  // ascending: binary search).  A round takes T tiles: a prefix sum of
  // their counts spreads their records over all threads.
  __shared__ int tile_off[FINISH_THREADS];
  const int found = min(total, K);
  for (int t0 = 0; t0 < ntiles; t0 += T) {
    if (t0 > 0) {
      __syncthreads();   // the last round's offsets are read
      my_cnt = t0 + tid < ntiles ? cnt_c[t0 + tid] : 0;
    }
    int nrec;
    tile_off[tid] = block_exclusive_scan(my_cnt, red, &nrec);
    __syncthreads();
    const int nt = min(T, ntiles - t0);
    for (int g = tid; g < nrec; g += T) {
      int lo = 0, hi = nt - 1;   // the last tile whose offset is <= g
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (tile_off[mid] <= g) lo = mid; else hi = mid - 1;
      }
      const size_t e = ((size_t)c * ntiles + t0 + lo) * TILE_PIXELS +
                       (g - tile_off[lo]);
      const int l = rec_l[e], rx = rec_x[e], ry = rec_y[e];
      int a = 0, b = found;
      while (a < b) {
        const int mid = (a + b) >> 1;
        if (roots[mid] < l) a = mid + 1; else b = mid;
      }
      if (a < found && roots[a] == l) {
        atomicAdd(m00 + a, 1u);
        atomicAdd(sx + a, (unsigned long long)rx);
        atomicAdd(sy + a, (unsigned long long)ry);
      }
    }
  }
  __syncthreads();

  for (int j = tid; j < K; j += T) {
    float cx = 0.0f, cy = 0.0f, m = 0.0f;
    if (j < found) {
      m = (float)m00[j];
      const float d = fmaxf(m, 1.0f);
      cx = (float)sx[j] / d;
      cy = (float)sy[j] / d;
    }
    cent[((size_t)c * K + j) * 2] = cx;
    cent[((size_t)c * K + j) * 2 + 1] = cy;
    valid[(size_t)c * K + j] = j < found;
    size[(size_t)c * K + j] = m;
  }
}

size_t tile_count(int H, int W) {
  return (size_t)((W + TILE - 1) / TILE) * ((H + TILE - 1) / TILE);
}

// The largest halo, in sweeps, that one pass can run (69).
int max_halo() {
  int h = 0;
  while (2 * (TILE + 2 * (h + 1)) * (TILE + 2 * (h + 1)) * (int)sizeof(int) <=
         DYN_SMEM_LIMIT)
    ++h;
  return h;
}

}  // namespace

// int32 work space that a launch on (C, H, W) frames needs: the presence
// bitmap (H*W bits a camera, zeroed by the launch), each tile's lit-pixel
// records (label, x, y) and count, then two label images when iters >
// max_halo().
extern "C" long long lcm_detect_work_ints(int C, int H, int W, int iters) {
  const size_t ct = (size_t)C * tile_count(H, W);
  return (long long)((size_t)C * ((H * W + 31) / 32) +
                     ct * (3 * TILE_PIXELS + 1) +
                     (iters > max_halo() ? 2 * (size_t)C * H * W
                                                    : 0));
}

// frames: (C, H, W) float32.  work: lcm_detect_work_ints int32.  out:
// cent (C, K, 2) f32, then size (C, K) f32, then valid (C, K) bytes.
extern "C" int lcm_detect_blobs(const void* frames, int C, int H, int W,
                                float threshold, int K, int iters,
                                void* work, void* out, void* stream) {
  // the attribute is set once per device
  static bool smem_attr_set[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= 64 || !smem_attr_set[device]) {
    err = cudaFuncSetAttribute(propagate_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DYN_SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    if (device < 64) smem_attr_set[device] = true;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const int n = H * W;
  const size_t ct = (size_t)C * tile_count(H, W);
  const size_t nbits = (size_t)C * ((n + 31) / 32);
  unsigned* bitmap = (unsigned*)work;
  err = cudaMemsetAsync(bitmap, 0, nbits * 4, st);
  if (err != cudaSuccess) return (int)err;
  int* rec_l = (int*)work + nbits;
  int* rec_x = rec_l + ct * TILE_PIXELS;
  int* rec_y = rec_x + ct * TILE_PIXELS;
  int* count = rec_y + ct * TILE_PIXELS;
  int* lab[2] = {count + ct, count + ct + (size_t)C * n};

  const int hmax = max_halo();
  const int passes = iters <= hmax ? 1 : (iters + hmax - 1) / hmax;
  const dim3 block(BX, BY);
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, C);
  for (int p = 0; p < passes; ++p) {
    const int h = iters / passes + (p < iters % passes ? 1 : 0);
    const int R = TILE + 2 * h;
    const int* lin = p == 0 ? nullptr : lab[(p - 1) & 1];
    int* lout = p == passes - 1 ? nullptr : lab[p & 1];
    propagate_kernel<<<grid, block, 2 * R * R * sizeof(int), st>>>(
        (const float*)frames, lin, H, W, threshold, h, lout, bitmap, count,
        rec_l, rec_x, rec_y);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  float* cent = (float*)out;
  float* size = cent + (size_t)C * K * 2;
  unsigned char* valid = (unsigned char*)(size + (size_t)C * K);
  finish_kernel<<<C, FINISH_THREADS, (size_t)K * 24, st>>>(
      bitmap, count, rec_l, rec_x, rec_y, n, (int)tile_count(H, W), K, cent,
      valid, size);
  return (int)cudaGetLastError();
}
