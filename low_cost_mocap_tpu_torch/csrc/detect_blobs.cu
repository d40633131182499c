// Blob detection kernel: threshold -> truncated connected components ->
// the first K components in raster order with binary moments.
//
// Replaces the TPU kernel low_cost_mocap_tpu/ops/detect_pallas.py
// (_detect_kernel and _shift_min, launched by find_blobs_pallas).  Per
// camera: threshold; label each lit pixel with its raster index; cc_iters
// masked 3x3 min-label sweeps with out-of-frame pixels as big = H*W; the
// first K distinct labels in ascending order; m00, sum x, sum y.
//
// The TPU kernel kept a whole frame in VMEM.  A 320x320 int32 label image
// is 400 KB, more than one block's 227 KB of shared memory, so the port
// splits the work in two kernels:
//
// 1. propagate_kernel.  Overlapping tiles: each block loads a TILE x TILE
//    output tile plus a halo cc_iters wide, runs every sweep in shared
//    memory with two buffers (Jacobi sweeps), and writes back only the
//    tile.  A label moves at most one pixel per sweep, so the tile is
//    exact; sweep s only updates the pixels at least s from the loaded
//    border, the ones the tile still depends on.  Updating in place
//    (Gauss-Seidel) would carry labels further than cc_iters pixels and
//    join long components that the reference splits.
// 2. roots_kernel.  One block per camera.  Round k takes the block-wide
//    minimum of the labels above root k-1 (the next root) and, in the same
//    pass over the labels, the integer moments of root k-1.  The centroid
//    is float(sum x) / max(float(m00), 1).  These integer sums equal the
//    float32 sums of the reference while the sums stay below 2^24: sum x
//    is at most 319 * m00 on a 320-pixel-wide frame, so that holds for any
//    blob under about 52,000 pixels.  Slots after the last root are
//    invalid with a zero centroid and size.
//
// What bounds it on an H100: integer work, cc_iters sweeps of a 9-way
// min + select over C*H*W pixels (reading the float frames is ~1.6 MB at
// the main path's 4x320x320).  The halo costs redundant sweeps (a 32-pixel
// tile with a 24-pixel halo loads 80x80 pixels); the shrinking window cuts
// about half of that.  The single-block root pass is latency-bound on
// reading the label image K+1 times from L2.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int TILE = 32;

__global__ void propagate_kernel(const float* __restrict__ frames,
                                 int H, int W, float threshold, int iters,
                                 int* __restrict__ labels) {
  extern __shared__ int smem[];
  const int R = TILE + 2 * iters;
  const int c = blockIdx.z;
  const int y0 = blockIdx.y * TILE - iters;
  const int x0 = blockIdx.x * TILE - iters;
  const int big = H * W;
  const float* frame = frames + (size_t)c * H * W;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int bx = blockDim.x, by = blockDim.y;

  for (int ly = ty; ly < R; ly += by) {
    const int gy = y0 + ly;
    for (int lx = tx; lx < R; lx += bx) {
      const int gx = x0 + lx;
      int lab = big;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W &&
          frame[gy * W + gx] > threshold)
        lab = gy * W + gx;
      smem[ly * R + lx] = lab;
    }
  }
  __syncthreads();

  // a pixel is lit iff its label is below big, at every sweep
  for (int s = 1; s <= iters; ++s) {
    const int* src = smem + ((s - 1) & 1) * R * R;
    int* dst = smem + (s & 1) * R * R;
    for (int ly = s + ty; ly < R - s; ly += by) {
      for (int lx = s + tx; lx < R - s; lx += bx) {
        const int* p = src + ly * R + lx;
        int v = p[0];
        if (v != big) {
          const int up = min(min(p[-R - 1], p[-R]), p[-R + 1]);
          const int mid = min(min(p[-1], v), p[1]);
          const int dn = min(min(p[R - 1], p[R]), p[R + 1]);
          v = min(min(up, mid), dn);
        }
        dst[ly * R + lx] = v;
      }
    }
    __syncthreads();
  }

  const int* res = smem + (iters & 1) * R * R;
  for (int ly = iters + ty; ly < iters + TILE; ly += by) {
    const int gy = y0 + ly;
    if (gy >= H) break;
    for (int lx = iters + tx; lx < iters + TILE; lx += bx) {
      const int gx = x0 + lx;
      if (gx < W) labels[(size_t)c * H * W + gy * W + gx] = res[ly * R + lx];
    }
  }
}

__device__ int block_min(int v, int* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = (blockDim.x + 31) >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < nwarps ? red[lane] : INT_MAX;
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ int block_sum(int v, int* red) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = (blockDim.x + 31) >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < nwarps ? red[lane] : 0;
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void roots_kernel(const int* __restrict__ labels, int H, int W,
                             int K, float* __restrict__ cent,
                             unsigned char* __restrict__ valid,
                             float* __restrict__ size) {
  __shared__ int red[32];
  const int c = blockIdx.x;
  const int n = H * W;
  const int big = n;
  const int* lab = labels + (size_t)c * n;
  float* cent_c = cent + (size_t)c * K * 2;
  unsigned char* valid_c = valid + (size_t)c * K;
  float* size_c = size + (size_t)c * K;

  int prev = -1;  // root of the previous round (-1: none yet)
  int k = 0;      // slot of the root being measured
  for (;;) {
    int lo = big, m00 = 0, sx = 0, sy = 0;
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      const int l = lab[p];
      if (l > prev && l < lo) lo = l;
      if (l == prev) {
        m00 += 1;
        sx += p % W;
        sy += p / W;
      }
    }
    const int next = block_min(lo, red);
    if (prev >= 0) {
      m00 = block_sum(m00, red);
      sx = block_sum(sx, red);
      sy = block_sum(sy, red);
      if (threadIdx.x == 0) {
        const float m = fmaxf((float)m00, 1.0f);
        cent_c[2 * k] = (float)sx / m;
        cent_c[2 * k + 1] = (float)sy / m;
        valid_c[k] = 1;
        size_c[k] = (float)m00;
      }
      ++k;
    }
    if (k == K || next == big) break;
    prev = next;
  }
  for (int j = k + threadIdx.x; j < K; j += blockDim.x) {
    cent_c[2 * j] = 0.0f;
    cent_c[2 * j + 1] = 0.0f;
    valid_c[j] = 0;
    size_c[j] = 0.0f;
  }
}

}  // namespace

// Shared memory the propagation needs for cc_iters sweeps (two buffers).
extern "C" int lcm_detect_smem_bytes(int iters) {
  const int R = TILE + 2 * iters;
  return 2 * R * R * (int)sizeof(int);
}

extern "C" int lcm_detect_blobs(const void* frames, int C, int H, int W,
                                float threshold, int K, int iters,
                                void* labels, void* cent, void* valid,
                                void* size, void* stream) {
  const int smem = lcm_detect_smem_bytes(iters);
  cudaError_t err = cudaFuncSetAttribute(
      propagate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(32, 8);
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, C);
  propagate_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)frames, H, W, threshold, iters, (int*)labels);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  roots_kernel<<<C, 1024, 0, (cudaStream_t)stream>>>(
      (const int*)labels, H, W, K, (float*)cent, (unsigned char*)valid,
      (float*)size);
  return (int)cudaGetLastError();
}
