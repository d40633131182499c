// Kalman bank kernel: B sequential tracking steps of an O-object bank.
//
// Replaces the TPU kernel low_cost_mocap_tpu/ops/kalman_pallas.py
// (_bank_kernel, launched by kalman_scan).  Each step, per object:
// lazy init from the lowest-slot candidate; constant-acceleration predict
// as slice arithmetic; first-minimum nearest-candidate association; a
// velocity measurement over the time since the last detection, re-seeded
// after gap_reset_s; six sequential scalar updates (H = [I6|0],
// R = r I); a long-gap re-seed; order-5 Butterworth on heading and
// velocity.  State is committed only on frames with a detection.
//
// Layout.  One block per rig (grid = 1), one thread per object.  The B
// loop runs inside the kernel and the object's state (x, P, filters)
// stays in registers for the whole batch.  The TPU kernel walked B as a
// sequential grid with the state in VMEM; blocks on Hopper run in no
// order, so nothing is carried between blocks.
//
// What bounds it on an H100.  Not bytes (a few KB per batch) and not
// arithmetic (~3k flops per object per step): the step-to-step dependency
// chain of B steps, each a few thousand dependent float32 instructions
// (IEEE divisions included) on one thread.  The design keeps that chain
// free of memory traffic: the state never leaves registers and a step with
// no candidate for the object skips the update, as the commit rule makes
// that step a no-op.  Spreading one object's 9x9 covariance update over a
// warp is the next step for speed.
//
// Numerics.  The operations and their order are those of the plain
// PyTorch chain (low_cost_mocap_tpu_torch/ops/kalman.py:update), which
// follows the JAX package: (x0 + dt*x3) + hdt2*x6; the same two-sided
// F P F^T slice arithmetic; Kv = P[:,k] / (P[k,k] + r); the squared
// distance as (dx*dx + dy*dy) + dz*dz; a strict < over m = 0..M-1 so the
// first minimum wins.  Built with -fmad=false and without fast math, the
// kernel agrees with the chain bitwise.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// Butterworth coefficients, passed by value: they reach the kernel in its
// parameter space, with no device buffer and no copy before the launch.
struct Butter {
  float b[6];
  float a[6];
};

__global__ void kalman_bank_kernel(
    const float* __restrict__ cand_pos,            // (B, M, 3)
    const float* __restrict__ cand_head,           // (B, M)
    const int* __restrict__ cand_index,            // (B, M)
    const unsigned char* __restrict__ cand_valid,  // (B, M) bool
    const float* __restrict__ dts,                 // (B,)
    const Butter bw,
    const float* __restrict__ x_in,                // (O, 9)
    const float* __restrict__ P_in,                // (O, 9, 9)
    const unsigned char* __restrict__ init_in,     // (O,) bool
    const float* __restrict__ prev_in,             // (O, 3)
    const float* __restrict__ lh_in,               // (O, 5)
    const float* __restrict__ lv_in,               // (O, 3, 5)
    const float* __restrict__ age_in,              // (O,)
    float* __restrict__ pos_out,                   // (B, O, 3)
    float* __restrict__ vel_out,                   // (B, O, 3)
    float* __restrict__ head_out,                  // (B, O)
    unsigned char* __restrict__ valid_out,         // (B, O) bool
    float* __restrict__ x_out, float* __restrict__ P_out,
    unsigned char* __restrict__ init_out, float* __restrict__ prev_out,
    float* __restrict__ lh_out, float* __restrict__ lv_out,
    float* __restrict__ age_out,
    int B, int M, int O, float q, float r, float gap_reset_s,
    int report_post) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= O) return;

  float x[9], P[81], prev[3], lh[5], lv[15];
#pragma unroll
  for (int i = 0; i < 9; ++i) x[i] = x_in[o * 9 + i];
#pragma unroll
  for (int i = 0; i < 81; ++i) P[i] = P_in[o * 81 + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) prev[i] = prev_in[o * 3 + i];
#pragma unroll
  for (int i = 0; i < 5; ++i) lh[i] = lh_in[o * 5 + i];
#pragma unroll
  for (int i = 0; i < 15; ++i) lv[i] = lv_in[o * 15 + i];
  bool inited = init_in[o] != 0;
  float age = age_in[o];
  float bc[6], ac[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    bc[i] = bw.b[i];
    ac[i] = bw.a[i];
  }

  for (int t = 0; t < B; ++t) {
    const float dt = dts[t];
    const float* cp = cand_pos + (size_t)t * M * 3;
    const float* ch = cand_head + (size_t)t * M;
    const int* ci = cand_index + (size_t)t * M;
    const unsigned char* cv = cand_valid + (size_t)t * M;
    float* po = pos_out + ((size_t)t * O + o) * 3;
    float* vo = vel_out + ((size_t)t * O + o) * 3;

    int first = -1;
    for (int m = 0; m < M; ++m) {
      if (cv[m] && ci[m] == o) {
        first = m;
        break;
      }
    }
    if (first < 0) {
      // no detection: nothing is committed, the outputs are zero
      po[0] = po[1] = po[2] = 0.0f;
      vo[0] = vo[1] = vo[2] = 0.0f;
      head_out[(size_t)t * O + o] = 0.0f;
      valid_out[(size_t)t * O + o] = 0;
      age = age + dt;
      continue;
    }

    // lazy init from the first (lowest-slot) candidate
    if (!inited) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        x[i] = cp[first * 3 + i];
        prev[i] = cp[first * 3 + i];
      }
      inited = true;
    }

    // predict: F = I + dt blocks, as slice arithmetic
    const float hdt2 = 0.5f * dt * dt;
    float xp[9];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      xp[i] = (x[i] + dt * x[i + 3]) + hdt2 * x[i + 6];
      xp[i + 3] = x[i + 3] + dt * x[i + 6];
      xp[i + 6] = x[i + 6];
    }
    // F @ P on rows, in place: row i reads rows i+3 and i+6, which are
    // still unchanged when rows are taken in increasing order
#pragma unroll
    for (int c = 0; c < 9; ++c) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
        P[i * 9 + c] = (P[i * 9 + c] + dt * P[(i + 3) * 9 + c])
                       + hdt2 * P[(i + 6) * 9 + c];
#pragma unroll
      for (int i = 3; i < 6; ++i)
        P[i * 9 + c] = P[i * 9 + c] + dt * P[(i + 3) * 9 + c];
    }
    // (F @ P) @ F^T on columns, in place, then + Q (q on the diagonal)
#pragma unroll
    for (int i = 0; i < 9; ++i) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        P[i * 9 + c] = (P[i * 9 + c] + dt * P[i * 9 + c + 3])
                       + hdt2 * P[i * 9 + c + 6];
#pragma unroll
      for (int c = 3; c < 6; ++c)
        P[i * 9 + c] = P[i * 9 + c] + dt * P[i * 9 + c + 3];
#pragma unroll
      for (int c = 0; c < 9; ++c)
        P[i * 9 + c] = P[i * 9 + c] + (i == c ? q : 0.0f);
    }

    // associate: nearest candidate, the first minimum
    int sel = 0;
    float best = INFINITY;
    for (int m = 0; m < M; ++m) {
      if (!(cv[m] && ci[m] == o)) continue;
      const float dx = cp[m * 3 + 0] - xp[0];
      const float dy = cp[m * 3 + 1] - xp[1];
      const float dz = cp[m * 3 + 2] - xp[2];
      const float d2 = (dx * dx + dy * dy) + dz * dz;
      if (d2 < best) {
        best = d2;
        sel = m;
      }
    }
    float z[6];
#pragma unroll
    for (int i = 0; i < 3; ++i) z[i] = cp[sel * 3 + i];
    const float elapsed = age + dt;
    const bool reseed = elapsed > gap_reset_s;
    const float el = fmaxf(elapsed, 1e-6f);
#pragma unroll
    for (int i = 0; i < 3; ++i) z[i + 3] = (z[i] - (reseed ? z[i] : prev[i])) / el;

    // correct: six sequential scalar measurement updates
    float xq[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) xq[i] = xp[i];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      float Kv[9], Rk[9];
      const float denom = P[k * 9 + k] + r;
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        Kv[i] = P[i * 9 + k] / denom;
        Rk[i] = P[k * 9 + i];
      }
      const float innov = z[k] - xq[k];
#pragma unroll
      for (int i = 0; i < 9; ++i) xq[i] = xq[i] + Kv[i] * innov;
#pragma unroll
      for (int i = 0; i < 9; ++i)
#pragma unroll
        for (int j = 0; j < 9; ++j)
          P[i * 9 + j] = P[i * 9 + j] - Kv[i] * Rk[j];
    }

    // long-gap reacquisition: re-seed from the measurement
    const bool reseed_all = reseed && inited;
    if (reseed_all) {
#pragma unroll
      for (int i = 0; i < 9; ++i) xq[i] = i < 3 ? z[i] : 0.0f;
#pragma unroll
      for (int i = 0; i < 81; ++i) P[i] = (i % 10 == 0) ? 1.0f : 0.0f;
    }
    const bool rep_post = report_post || reseed_all;
    float xr[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) xr[i] = rep_post ? xq[i] : xp[i];

    // low-pass banks (direct form II transposed, order 5)
    const float hin = ch[sel];
    const float yh = bc[0] * hin + lh[0];
#pragma unroll
    for (int i = 0; i < 4; ++i) lh[i] = (bc[i + 1] * hin + lh[i + 1]) - ac[i + 1] * yh;
    lh[4] = bc[5] * hin - ac[5] * yh;
    float yv[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float* s = lv + c * 5;
      const float vin = xr[3 + c];
      yv[c] = bc[0] * vin + s[0];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] = (bc[i + 1] * vin + s[i + 1]) - ac[i + 1] * yv[c];
      s[4] = bc[5] * vin - ac[5] * yv[c];
    }

    // commit (this object had a detection) and report
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      po[i] = xr[i];
      vo[i] = yv[i];
      prev[i] = z[i];
    }
    head_out[(size_t)t * O + o] = yh;
    valid_out[(size_t)t * O + o] = 1;
#pragma unroll
    for (int i = 0; i < 9; ++i) x[i] = xq[i];
    age = 0.0f;
  }

#pragma unroll
  for (int i = 0; i < 9; ++i) x_out[o * 9 + i] = x[i];
#pragma unroll
  for (int i = 0; i < 81; ++i) P_out[o * 81 + i] = P[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) prev_out[o * 3 + i] = prev[i];
#pragma unroll
  for (int i = 0; i < 5; ++i) lh_out[o * 5 + i] = lh[i];
#pragma unroll
  for (int i = 0; i < 15; ++i) lv_out[o * 15 + i] = lv[i];
  init_out[o] = inited ? 1 : 0;
  age_out[o] = age;
}

}  // namespace

// ba_host: host memory, the (2, 6) float32 Butterworth b; a.
extern "C" int lcm_kalman_bank(
    const void* cand_pos, const void* cand_head, const void* cand_index,
    const void* cand_valid, const void* dts, const void* ba_host,
    const void* x_in, const void* P_in, const void* init_in,
    const void* prev_in, const void* lh_in, const void* lv_in,
    const void* age_in,
    void* pos_out, void* vel_out, void* head_out, void* valid_out,
    void* x_out, void* P_out, void* init_out, void* prev_out, void* lh_out,
    void* lv_out, void* age_out,
    int B, int M, int O, float q, float r, float gap_reset_s,
    int report_post, void* stream) {
  Butter bw;
  const float* ba = (const float*)ba_host;
  for (int i = 0; i < 6; ++i) {
    bw.b[i] = ba[i];
    bw.a[i] = ba[6 + i];
  }
  const int threads = 32;
  const int blocks = (O + threads - 1) / threads;
  kalman_bank_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)cand_pos, (const float*)cand_head,
      (const int*)cand_index, (const unsigned char*)cand_valid,
      (const float*)dts, bw, (const float*)x_in,
      (const float*)P_in, (const unsigned char*)init_in,
      (const float*)prev_in, (const float*)lh_in, (const float*)lv_in,
      (const float*)age_in, (float*)pos_out, (float*)vel_out,
      (float*)head_out, (unsigned char*)valid_out, (float*)x_out,
      (float*)P_out, (unsigned char*)init_out, (float*)prev_out,
      (float*)lh_out, (float*)lv_out, (float*)age_out, B, M, O, q, r,
      gap_reset_s, report_post);
  return (int)cudaGetLastError();
}
