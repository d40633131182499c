// Kalman bank kernel: B sequential tracking steps of an O-object bank.
//
// Replaces the TPU kernel low_cost_mocap_tpu/ops/kalman_pallas.py
// (_bank_kernel, launched by kalman_scan).  Each step, per object:
// lazy init from the lowest-slot candidate; constant-acceleration predict
// as slice arithmetic; nearest-candidate association with the argmin
// rule; a velocity measurement over the time since the last detection,
// re-seeded after gap_reset_s; six sequential scalar updates (H = [I6|0],
// R = r I); a long-gap re-seed; order-5 Butterworth on heading and
// velocity.  State is committed only on frames with a detection.
//
// Two instantiations of one body.  The serving bank (kSmoothFwd = false,
// lcm_kalman_bank) is the above, for the live Engine, batched serving,
// the offline causal bank and streamed blocks.  The RTS smoother's forward
// filter (kSmoothFwd = true, lcm_kalman_forward; kalman.update with
// advance_on_miss, return_cov and report "post") also commits the
// prediction of an initialised object on a step without a detection
// (prev and the low-pass banks stay), and writes the committed x, P and
// the initialised flag after every step, so that a whole recording's
// forward pass is one launch.  The variant is a template parameter, not a
// runtime flag: the serving instantiation compiles to the code it had
// before the variant existed, and the live path's chain of dependent steps
// keeps its registers and schedule.
//
// What bounds it on an H100.  Not bytes (a few KB per batch) and not
// arithmetic (~2k flops per object per step): the step-to-step dependency
// chain.  The TPU walked B as a sequential grid with the state in VMEM;
// blocks on Hopper run in no order, so the B loop runs inside the kernel
// and the chain's length is what the design shortens.
//
// Layout.  One warp per object, ceil(O / 8) blocks of up to 8 object
// warps.  x, the filters, age and prev are replicated on every lane; lane i
// (0-8) holds row i of the 9x9 covariance in nine registers, and rows move
// between lanes by shuffles, so the chain never waits on shared memory.
// - Predict: lane i builds row i of F P from rows i+3 and i+6, then
//   applies F^T to its own row and adds Q, the + 0.0f on the off-diagonal
//   entries included: every entry performs the plain chain's float
//   operations in its order.
// - Six scalar updates: for each k, every lane takes row k from lane k;
//   lane i divides its own P[i][k] by P[k][k] + r, so the nine IEEE
//   divisions run side by side, and updates its row and x[i].  Each step of the
//   chain is a shuffle, an add, a division and a multiply-subtract.  The
//   covariance stays block-diagonal by axis, so two thirds of the
//   dividends are exact zeros; div_rn answers them with the signed zero
//   IEEE division gives, without the division's slow path.
// - Association: candidates stride over the lanes; two warp reductions
//   (__reduce_min_sync) on an integer key that orders d2 with NaN first,
//   then on the slot, give torch.argmin's rule: the first NaN wins, else
//   the first minimum; when every distance is inf, slot 0.
// - Candidates: every object reads the same step's candidates, so the
//   block stages them in shared memory, double-buffered.  Each thread
//   issues its loads for step t + 1 right after the barrier of step t and
//   stores them at the top of step t + 1, so no global load sits on the
//   step-to-step chain.  A candidate's valid flag is folded into its index
//   (-1 when invalid).
// - A step with no candidate for the object skips the update: the commit
//   rule makes that step a no-op except for age (and, in the forward
//   filter, the prediction).
// - The forward filter's per-step outputs: lane i (0-8) stores x[i] and
//   row i of P, lane 0 the flag; no later step reads them, so no store
//   sits on the step-to-step chain.
//
// Numerics.  The operations and their order are those of the plain
// PyTorch chain (low_cost_mocap_tpu_torch/ops/kalman.py:update, with the
// forward filter's options for kSmoothFwd), which
// follows the JAX package: (x0 + dt*x3) + hdt2*x6; the same two-sided
// F P F^T slice arithmetic; Kv = P[:,k] / (P[k,k] + r); the squared
// distance as (dx*dx + dy*dy) + dz*dz.  Built with -fmad=false and without
// fast math, the kernel agrees with the chain bitwise.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_WARPS = 8;     // object warps per block
constexpr unsigned FULL = 0xffffffffu;

// Butterworth coefficients, passed by value: they reach the kernel in its
// parameter space, with no device buffer and no copy before the launch.
struct Butter {
  float b[6];
  float a[6];
};

// One step's candidates in shared memory: pos (M, 3), heading (M),
// index (M, -1 where invalid), dt.
struct Stage {
  float* pos;
  float* head;
  int* idx;
  float* dt;
};

__device__ Stage stage_at(float* base, int M) {
  return Stage{base, base + 3 * M, (int*)(base + 4 * M), base + 5 * M};
}

// a / b, rounded to nearest as IEEE division is.  A zero dividend gets
// its signed zero without the division, whose range check (FCHK) would
// send it to a slow path; a zero or NaN divisor still divides.
__device__ __forceinline__ float div_rn(float a, float b) {
  if (a == 0.0f && b == b && b != 0.0f)
    return __int_as_float((__float_as_int(a) ^ __float_as_int(b)) &
                          0x80000000);
  return a / b;
}

// The forward filter's outputs of one step, at row t * O + o: x (9),
// P (9, 9) and the initialised flag.  Lane i (0-8) stores x[i] and row i
// of P.
__device__ __forceinline__ void store_step(
    float* __restrict__ xs, float* __restrict__ Ps,
    unsigned char* __restrict__ inits, size_t row, const float (&x)[9],
    const float (&Pr)[9], bool inited, int lane) {
  if (lane < 9) {
    float xv = x[0];
#pragma unroll
    for (int i = 1; i < 9; ++i)
      if (lane == i) xv = x[i];
    xs[row * 9 + lane] = xv;
#pragma unroll
    for (int j = 0; j < 9; ++j) Ps[(row * 9 + lane) * 9 + j] = Pr[j];
  }
  if (lane == 0) inits[row] = inited ? 1 : 0;
}

template <bool kSmoothFwd>
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
    int B, int M, int O, int warps, float q, float r, float gap_reset_s,
    int report_post,
    // the forward filter's per-step outputs (kSmoothFwd; unused else)
    float* __restrict__ xs_out,                    // (B, O, 9)
    float* __restrict__ Ps_out,                    // (B, O, 9, 9)
    unsigned char* __restrict__ inits_out) {       // (B, O) bool
  extern __shared__ float smem[];
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int o = blockIdx.x * warps + warp;
  const bool active = warp < warps && o < O;
  // lanes 0-8 hold row `lane` of P; the other lanes carry a row that no
  // result reads
  const int prow = lane % 9;
  float Pr[9], x[9], prev[3], lh[5], lv[15], age = 0.0f;
  bool inited = false;
  if (active) {
#pragma unroll
    for (int i = 0; i < 9; ++i) x[i] = x_in[o * 9 + i];
#pragma unroll
    for (int i = 0; i < 3; ++i) prev[i] = prev_in[o * 3 + i];
#pragma unroll
    for (int i = 0; i < 5; ++i) lh[i] = lh_in[o * 5 + i];
#pragma unroll
    for (int i = 0; i < 15; ++i) lv[i] = lv_in[o * 15 + i];
#pragma unroll
    for (int j = 0; j < 9; ++j) Pr[j] = P_in[o * 81 + prow * 9 + j];
    inited = init_in[o] != 0;
    age = age_in[o];
  }

  // the next step's candidates, loaded ahead into registers: this thread's
  // share is pos elements tid, tid + T, tid + 2T and candidate tid (T >= M
  // unless M > 1024; the rest is then loaded at the store)
  float np0 = 0.0f, np1 = 0.0f, np2 = 0.0f, nhead = 0.0f, ndt = 0.0f;
  int nidx = -1;
  unsigned char nval = 0;
#define LCM_FETCH(t)                                                      \
  do {                                                                    \
    const float* cp_ = cand_pos + (size_t)(t) * M * 3;                    \
    if (tid < 3 * M) np0 = cp_[tid];                                      \
    if (tid + T < 3 * M) np1 = cp_[tid + T];                              \
    if (tid + 2 * T < 3 * M) np2 = cp_[tid + 2 * T];                      \
    if (tid < M) {                                                        \
      nhead = cand_head[(size_t)(t) * M + tid];                           \
      nidx = cand_index[(size_t)(t) * M + tid];                           \
      nval = cand_valid[(size_t)(t) * M + tid];                           \
    }                                                                     \
    if (tid == 0) ndt = dts[t];                                           \
  } while (0)

  if (B > 0) LCM_FETCH(0);
  for (int t = 0; t < B; ++t) {
    const Stage s = stage_at(smem + (t & 1) * (5 * M + 1), M);
    if (tid < 3 * M) s.pos[tid] = np0;
    if (tid + T < 3 * M) s.pos[tid + T] = np1;
    if (tid + 2 * T < 3 * M) s.pos[tid + 2 * T] = np2;
    if (tid < M) {
      s.head[tid] = nhead;
      s.idx[tid] = nval ? nidx : -1;
    }
    if (tid == 0) *s.dt = ndt;
    for (int e = tid + 3 * T; e < 3 * M; e += T)
      s.pos[e] = cand_pos[(size_t)t * M * 3 + e];
    for (int m = tid + T; m < M; m += T) {
      s.head[m] = cand_head[(size_t)t * M + m];
      s.idx[m] = cand_valid[(size_t)t * M + m] ? cand_index[(size_t)t * M + m]
                                               : -1;
    }
    __syncthreads();
    if (t + 1 < B) LCM_FETCH(t + 1);
    if (!active) continue;

    const float dt = *s.dt;
    float* po = pos_out + ((size_t)t * O + o) * 3;
    float* vo = vel_out + ((size_t)t * O + o) * 3;

    // the object's lowest-slot candidate
    int first = -1;
    for (int base = 0; base < M; base += 32) {
      const int m = base + lane;
      const unsigned bal = __ballot_sync(FULL, m < M && s.idx[m] == o);
      if (bal != 0u) {
        first = base + __ffs(bal) - 1;
        break;
      }
    }
    if (first < 0) {
      // no detection: the outputs are zero; the serving bank commits
      // nothing
      if (lane == 0) {
        po[0] = po[1] = po[2] = 0.0f;
        vo[0] = vo[1] = vo[2] = 0.0f;
        head_out[(size_t)t * O + o] = 0.0f;
        valid_out[(size_t)t * O + o] = 0;
      }
      age = age + dt;
      if constexpr (!kSmoothFwd) {
        continue;
      } else if (!inited) {
        store_step(xs_out, Ps_out, inits_out, (size_t)t * O + o, x, Pr,
                   inited, lane);
        continue;
      }
      // the forward filter goes on to predict, and commits the prediction
    }

    // lazy init from the first (lowest-slot) candidate (first >= 0 here
    // whenever the object is not initialised)
    if (!inited) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        x[i] = s.pos[first * 3 + i];
        prev[i] = s.pos[first * 3 + i];
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
    // F @ P on rows: row i from rows i, i+3, i+6 (lanes i+3, i+6)
    float fp[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const float p3 = __shfl_sync(FULL, Pr[j], lane + 3);
      const float p6 = __shfl_sync(FULL, Pr[j], lane + 6);
      fp[j] = prow < 3 ? (Pr[j] + dt * p3) + hdt2 * p6
            : prow < 6 ? Pr[j] + dt * p3
                       : Pr[j];
    }
    // (F @ P) @ F^T on the row's columns, then + Q (q on the diagonal, 0
    // elsewhere)
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const float f = j < 3 ? (fp[j] + dt * fp[j + 3]) + hdt2 * fp[j + 6]
                    : j < 6 ? fp[j] + dt * fp[j + 3]
                            : fp[j];
      Pr[j] = f + (prow == j ? q : 0.0f);
    }
    if constexpr (kSmoothFwd) {
      if (first < 0) {
        // a gap in the forward filter: x_pre and P_pre committed
#pragma unroll
        for (int i = 0; i < 9; ++i) x[i] = xp[i];
        store_step(xs_out, Ps_out, inits_out, (size_t)t * O + o, x, Pr,
                   inited, lane);
        continue;
      }
    }

    // associate: the nearest candidate by torch.argmin's rule, as two
    // warp reductions on an order-preserving key (d2 >= +0, so its bits
    // order it; NaN below everything)
    unsigned best = 0xffffffffu;
    int sel = 0x7fffffff;
    for (int m = lane; m < M; m += 32) {
      float d2 = INFINITY;
      if (s.idx[m] == o) {
        const float dx = s.pos[m * 3 + 0] - xp[0];
        const float dy = s.pos[m * 3 + 1] - xp[1];
        const float dz = s.pos[m * 3 + 2] - xp[2];
        d2 = (dx * dx + dy * dy) + dz * dz;
      }
      const unsigned key = isnan(d2) ? 0u : __float_as_uint(d2) + 1u;
      if (key < best) {   // the lane's candidates in increasing m
        best = key;
        sel = m;
      }
    }
    const unsigned best_w = __reduce_min_sync(FULL, best);
    sel = __reduce_min_sync(FULL, best == best_w ? sel : 0x7fffffff);

    float z[6];
#pragma unroll
    for (int i = 0; i < 3; ++i) z[i] = s.pos[sel * 3 + i];
    const float elapsed = age + dt;
    const bool reseed = elapsed > gap_reset_s;
    const float el = fmaxf(elapsed, 1e-6f);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      z[i + 3] = div_rn(z[i] - (reseed ? z[i] : prev[i]), el);

    // correct: six sequential scalar measurement updates; lane i takes
    // Kv[i] = P[i][k] / (P[k][k] + r) and updates row i and x[i]; row k
    // and x[k] come from lane k
    float xi = xp[0];
#pragma unroll
    for (int i = 1; i < 9; ++i)
      if (prow == i) xi = xp[i];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float denom = __shfl_sync(FULL, Pr[k], k) + r;
      const float innov = z[k] - __shfl_sync(FULL, xi, k);
      float Rk[9];
#pragma unroll
      for (int j = 0; j < 9; ++j) Rk[j] = __shfl_sync(FULL, Pr[j], k);
      float kv = 0.0f;
      if (lane < 9) kv = div_rn(Pr[k], denom);
      xi = xi + kv * innov;
#pragma unroll
      for (int j = 0; j < 9; ++j) Pr[j] = Pr[j] - kv * Rk[j];
    }
    float xq[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) xq[i] = __shfl_sync(FULL, xi, i);

    // long-gap reacquisition: re-seed from the measurement
    const bool reseed_all = reseed && inited;
    if (reseed_all) {
#pragma unroll
      for (int i = 0; i < 9; ++i) xq[i] = i < 3 ? z[i] : 0.0f;
#pragma unroll
      for (int j = 0; j < 9; ++j) Pr[j] = prow == j ? 1.0f : 0.0f;
    }
    const bool rep_post = report_post || reseed_all;
    float xr[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) xr[i] = rep_post ? xq[i] : xp[i];

    // low-pass banks (direct form II transposed, order 5)
    const float hin = s.head[sel];
    const float yh = bw.b[0] * hin + lh[0];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      lh[i] = (bw.b[i + 1] * hin + lh[i + 1]) - bw.a[i + 1] * yh;
    lh[4] = bw.b[5] * hin - bw.a[5] * yh;
    float yv[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float* f = lv + c * 5;
      const float vin = xr[3 + c];
      yv[c] = bw.b[0] * vin + f[0];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        f[i] = (bw.b[i + 1] * vin + f[i + 1]) - bw.a[i + 1] * yv[c];
      f[4] = bw.b[5] * vin - bw.a[5] * yv[c];
    }

    // commit (this object had a detection) and report
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        po[i] = xr[i];
        vo[i] = yv[i];
      }
      head_out[(size_t)t * O + o] = yh;
      valid_out[(size_t)t * O + o] = 1;
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) prev[i] = z[i];
#pragma unroll
    for (int i = 0; i < 9; ++i) x[i] = xq[i];
    age = 0.0f;
    if constexpr (kSmoothFwd)
      store_step(xs_out, Ps_out, inits_out, (size_t)t * O + o, x, Pr,
                 inited, lane);
  }

#undef LCM_FETCH
  if (!active) return;
  if (lane < 9) x_out[o * 9 + lane] = x[lane];
  if (lane < 9) {
#pragma unroll
    for (int j = 0; j < 9; ++j) P_out[o * 81 + lane * 9 + j] = Pr[j];
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) prev_out[o * 3 + i] = prev[i];
#pragma unroll
    for (int i = 0; i < 5; ++i) lh_out[o * 5 + i] = lh[i];
#pragma unroll
    for (int i = 0; i < 15; ++i) lv_out[o * 15 + i] = lv[i];
    init_out[o] = inited ? 1 : 0;
    age_out[o] = age;
  }
}

// Launches B steps of one instantiation.  ba_host: host memory, the
// (2, 6) float32 Butterworth b; a.  out: one buffer.  float32 pos
// (B, O, 3), vel (B, O, 3), heading (B, O), [forward: xs (B, O, 9),
// Ps (B, O, 9, 9),] x (O, 9), P (O, 9, 9), prev_pos (O, 3),
// lpf_heading (O, 5), lpf_vel (O, 3, 5), age (O,); then bytes valid
// (B, O), [forward: initialised (B, O),] initialized (O,).
template <bool kSmoothFwd>
int launch(const void* cand_pos, const void* cand_head,
           const void* cand_index, const void* cand_valid, const void* dts,
           const void* ba_host, const void* x_in, const void* P_in,
           const void* init_in, const void* prev_in, const void* lh_in,
           const void* lv_in, const void* age_in, void* out, int B, int M,
           int O, float q, float r, float gap_reset_s, int report_post,
           void* stream) {
  Butter bw;
  const float* ba = (const float*)ba_host;
  for (int i = 0; i < 6; ++i) {
    bw.b[i] = ba[i];
    bw.a[i] = ba[6 + i];
  }
  const size_t BO = (size_t)B * O;
  const size_t fwd = kSmoothFwd ? BO : 0;   // per-step rows of the variant
  float* pos = (float*)out;
  float* vel = pos + BO * 3;
  float* head = vel + BO * 3;
  float* xs = head + BO;
  float* Ps = xs + fwd * 9;
  float* x = Ps + fwd * 81;
  float* P = x + (size_t)O * 9;
  float* prev = P + (size_t)O * 81;
  float* lh = prev + (size_t)O * 3;
  float* lv = lh + (size_t)O * 5;
  float* age = lv + (size_t)O * 15;
  unsigned char* valid = (unsigned char*)(age + O);
  unsigned char* inits = valid + BO;
  unsigned char* init = inits + fwd;

  const int warps = O < MAX_WARPS ? O : MAX_WARPS;
  int threads = 32 * warps > M ? 32 * warps : M;
  threads = (threads + 31) / 32 * 32;
  if (threads > 1024) threads = 1024;
  const int blocks = (O + warps - 1) / warps;
  const size_t smem = 2 * (5 * (size_t)M + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kalman_bank_kernel<kSmoothFwd>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kalman_bank_kernel<kSmoothFwd><<<blocks, threads, smem,
                                   (cudaStream_t)stream>>>(
      (const float*)cand_pos, (const float*)cand_head,
      (const int*)cand_index, (const unsigned char*)cand_valid,
      (const float*)dts, bw, (const float*)x_in, (const float*)P_in,
      (const unsigned char*)init_in, (const float*)prev_in,
      (const float*)lh_in, (const float*)lv_in, (const float*)age_in, pos,
      vel, head, valid, x, P, init, prev, lh, lv, age, B, M, O, warps, q, r,
      gap_reset_s, report_post, kSmoothFwd ? xs : nullptr,
      kSmoothFwd ? Ps : nullptr, kSmoothFwd ? inits : nullptr);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------
// The RTS smoother's backward pass: two kernels a recording.
//
// It replaces no TPU kernel: the JAX package's backward pass
// (low_cost_mocap_tpu/ops/kalman.py:rts_smooth) is a lax.scan of jnp
// einsums and an inverse.  Its plain version is
// low_cost_mocap_tpu_torch/ops/kalman.py:rts_smooth (_rts_gains, then
// _rts_step through the loop runner), which performs these float32
// operations in this order, so the two agree bitwise.
//
// What bounds it on an H100.  Not bytes (~2 MB a 1,500-frame recording of
// two objects) and not arithmetic (a few MFLOP): the sweep's chain of
// dependent steps, T - 1 of them, each a 9x9 update of the carry.  The
// recursion's gain C_k = P_k F' P_pred^-1 does not depend on the carry, so
// the design takes everything but the carry's update off the chain:
// - kalman_bank_rts_gains: every (k, o) at once, nine threads a problem
//   (thread r owns row r of C_k), enough to fill the card.  Each thread
//   builds P_pred = (F P_k) F' + Q as slice arithmetic, factors it in
//   registers (LU without pivoting, which its positive definiteness makes
//   stable; Cholesky would read one triangle of a matrix that is symmetric
//   only to rounding, and solve another system), and solves
//   c P_pred = (P_k F')[r] by substitution: no inverse.  C, x_pred and
//   P_pred go to scratch.
// - kalman_bank_rts_sweep: one warp an object, lane i (0-8) holding row i
//   of the smoothed covariance, the smoothed mean on every lane.  Each step
//   x_s[k] = x_k + C (x_s[k+1] - x_pred) and P_s[k] = P_k + (C D) C' with
//   D = P_s[k+1] - P_pred.  The rows of C and D every lane needs go
//   through shared memory (double-buffered, one __syncwarp a step, read
//   as float4), the new mean by shuffles.  Step k-1's C, P_k, P_pred and
//   means are loaded into registers while step k computes, so no global
//   load sits on the chain.
// Every sum runs in index order (j = 0 .. 8); built with -fmad=false.

namespace {

constexpr int RTS_ROW = 12;                   // padded row: three float4
constexpr int RTS_MAT = 9 * RTS_ROW;          // one 9x9 matrix in smem
constexpr int RTS_WARP = 4 * RTS_MAT;         // two buffers of C and D

// The transition on one index of a 9-vector v: (F v)[i] as slice
// arithmetic (v[i], v[i+3], v[i+6] of one row or column).
__device__ __forceinline__ float f_at(int i, float a, float b, float c,
                                      float dt, float hdt2) {
  return i < 3 ? (a + dt * b) + hdt2 * c : i < 6 ? a + dt * b : a;
}

__global__ void kalman_bank_rts_gains(
    const float* __restrict__ xs,      // (T, O, 9) filtered means
    const float* __restrict__ Ps,      // (T, O, 9, 9) filtered covariances
    const float* __restrict__ dts,     // (T,)
    float* __restrict__ C_out,         // (T-1, O, 9, 9)
    float* __restrict__ xp_out,        // (T-1, O, 9)
    float* __restrict__ Pp_out,        // (T-1, O, 9, 9)
    long long N, int O, float q) {     // N = (T-1) * O problems
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long p = g / 9;           // problem (k, o), k * O + o
  const int r = (int)(g - p * 9);      // this thread's row of C
  if (p >= N) return;
  const float dt = dts[p / O + 1];
  const float hdt2 = 0.5f * dt * dt;
  const float* P = Ps + p * 81;
  const float* x = xs + p * 9;

  // A = (F P) F' + Q: row i of F P from rows i, i+3, i+6, then the
  // columns
  float A[9][9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    float fp[9];
#pragma unroll
    for (int j = 0; j < 9; ++j)
      fp[j] = f_at(i, P[i * 9 + j], i < 6 ? P[(i + 3) * 9 + j] : 0.0f,
                   i < 3 ? P[(i + 6) * 9 + j] : 0.0f, dt, hdt2);
#pragma unroll
    for (int j = 0; j < 9; ++j)
      A[i][j] = f_at(j, fp[j], j < 6 ? fp[j + 3] : 0.0f,
                     j < 3 ? fp[j + 6] : 0.0f, dt, hdt2) +
                (i == j ? q : 0.0f);
  }
  // this thread's outputs beside C: x_pred[r] and row r of P_pred
  const float* pr = P + r * 9;
  const float xpr = f_at(r, x[r], r < 6 ? x[r + 3] : 0.0f,
                         r < 3 ? x[r + 6] : 0.0f, dt, hdt2);
  xp_out[p * 9 + r] = xpr;
#pragma unroll
  for (int i = 0; i < 9; ++i)
    if (i == r) {
#pragma unroll
      for (int j = 0; j < 9; ++j) Pp_out[p * 81 + i * 9 + j] = A[i][j];
    }
  // row r of P F'
  float gr[9];
#pragma unroll
  for (int j = 0; j < 9; ++j)
    gr[j] = f_at(j, pr[j], j < 6 ? pr[j + 3] : 0.0f,
                 j < 3 ? pr[j + 6] : 0.0f, dt, hdt2);

  // A = L U in place (Doolittle: L unit lower below the diagonal, U on
  // and above it)
#pragma unroll
  for (int j = 0; j < 9; ++j) {
#pragma unroll
    for (int m = j; m < 9; ++m) {
      float u = A[j][m];
#pragma unroll
      for (int k = 0; k < j; ++k) u = u - A[j][k] * A[k][m];
      A[j][m] = u;
    }
#pragma unroll
    for (int i = j + 1; i < 9; ++i) {
      float l = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) l = l - A[i][k] * A[k][j];
      A[i][j] = div_rn(l, A[j][j]);
    }
  }
  // row r of C: w U = gr, then c L = w
  float w[9];
#pragma unroll
  for (int m = 0; m < 9; ++m) {
    float t = gr[m];
#pragma unroll
    for (int k = 0; k < m; ++k) t = t - w[k] * A[k][m];
    w[m] = div_rn(t, A[m][m]);
  }
  float c[9];
#pragma unroll
  for (int m = 8; m >= 0; --m) {
    float t = w[m];
#pragma unroll
    for (int k = m + 1; k < 9; ++k) t = t - c[k] * A[k][m];
    c[m] = t;
  }
#pragma unroll
  for (int j = 0; j < 9; ++j) C_out[p * 81 + r * 9 + j] = c[j];
}

// One step's inputs of the sweep, as lane `row` holds them.
struct RtsStage {
  float c[9];    // row of C_k
  float pk[9];   // row of P_k
  float pp[9];   // row of P_pred
  float xp[9];   // x_pred, all of it
  float xk;      // x_k[row]
};

__device__ __forceinline__ void rts_load(
    RtsStage& s, const float* __restrict__ xs, const float* __restrict__ Ps,
    const float* __restrict__ C, const float* __restrict__ xp,
    const float* __restrict__ Pp, size_t ko, int row) {
  const size_t m = ko * 81 + row * 9;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    s.c[j] = C[m + j];
    s.pk[j] = Ps[m + j];
    s.pp[j] = Pp[m + j];
    s.xp[j] = xp[ko * 9 + j];
  }
  s.xk = xs[ko * 9 + row];
}

__global__ void kalman_bank_rts_sweep(
    const float* __restrict__ xs, const float* __restrict__ Ps,
    const float* __restrict__ C, const float* __restrict__ xp,
    const float* __restrict__ Pp,
    float* __restrict__ xs_out,        // (T, O, 9)
    float* __restrict__ Ps_out,        // (T, O, 9, 9)
    int T, int O, int warps) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int o = blockIdx.x * warps + warp;
  if (o >= O) return;                  // a whole warp; no block barrier
  const int row = lane % 9;            // lanes 9-31 repeat rows 0-8
  const bool owner = lane < 9;
  float* sw = (float*)smem4 + warp * RTS_WARP;

  // the carry: the last frame, which is also its smoothed value
  const size_t last = (size_t)(T - 1) * O + o;
  float xn[9], pn[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    xn[j] = xs[last * 9 + j];
    pn[j] = Ps[last * 81 + row * 9 + j];
  }
  if (owner) {
    xs_out[last * 9 + row] = xs[last * 9 + row];
#pragma unroll
    for (int j = 0; j < 9; ++j) Ps_out[last * 81 + row * 9 + j] = pn[j];
  }

  RtsStage cur, nxt;
  rts_load(cur, xs, Ps, C, xp, Pp, (size_t)(T - 2) * O + o, row);
  for (int k = T - 2; k >= 0; --k) {
    const size_t ko = (size_t)k * O + o;
    if (k > 0) rts_load(nxt, xs, Ps, C, xp, Pp, ko - O, row);
    float* sc = sw + (k & 1) * 2 * RTS_MAT;   // C rows, then D rows
    float* sd = sc + RTS_MAT;
    if (owner) {
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        sc[row * RTS_ROW + j] = cur.c[j];
        sd[row * RTS_ROW + j] = pn[j] - cur.pp[j];
      }
    }
    __syncwarp();

    // x_s[k][row] = x_k[row] + sum_j C[row][j] (x_s[k+1] - x_pred)[j]
    float dx[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) dx[j] = xn[j] - cur.xp[j];
    float acc = cur.c[0] * dx[0];
#pragma unroll
    for (int j = 1; j < 9; ++j) acc = acc + cur.c[j] * dx[j];
    const float xi = cur.xk + acc;

    // U = C D on this row: U[m] = sum_j C[row][j] D[j][m]
    float u[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const float4* d4 = (const float4*)(sd + j * RTS_ROW);
      const float4 a = d4[0], b = d4[1], e = d4[2];
      const float d[9] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, e.x};
#pragma unroll
      for (int m = 0; m < 9; ++m)
        u[m] = j == 0 ? cur.c[0] * d[m] : u[m] + cur.c[j] * d[m];
    }
    // P_s[k][row][l] = P_k[row][l] + sum_m U[m] C[l][m]
    float pnew[9];
#pragma unroll
    for (int l = 0; l < 9; ++l) {
      const float4* c4 = (const float4*)(sc + l * RTS_ROW);
      const float4 a = c4[0], b = c4[1], e = c4[2];
      const float cl[9] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, e.x};
      float s = u[0] * cl[0];
#pragma unroll
      for (int m = 1; m < 9; ++m) s = s + u[m] * cl[m];
      pnew[l] = cur.pk[l] + s;
    }

    // the new carry; the mean comes from lanes 0-8
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      xn[j] = __shfl_sync(FULL, xi, j);
      pn[j] = pnew[j];
    }
    if (owner) {
      xs_out[ko * 9 + row] = xi;
#pragma unroll
      for (int j = 0; j < 9; ++j) Ps_out[ko * 81 + row * 9 + j] = pnew[j];
    }
    cur = nxt;
  }
}

}  // namespace

// The serving bank: B steps with report "pre" or "post".
extern "C" int lcm_kalman_bank(
    const void* cand_pos, const void* cand_head, const void* cand_index,
    const void* cand_valid, const void* dts, const void* ba_host,
    const void* x_in, const void* P_in, const void* init_in,
    const void* prev_in, const void* lh_in, const void* lv_in,
    const void* age_in, void* out, int B, int M, int O, float q, float r,
    float gap_reset_s, int report_post, void* stream) {
  return launch<false>(cand_pos, cand_head, cand_index, cand_valid, dts,
                       ba_host, x_in, P_in, init_in, prev_in, lh_in, lv_in,
                       age_in, out, B, M, O, q, r, gap_reset_s, report_post,
                       stream);
}

// The RTS smoother's forward filter: B steps, the prediction committed
// through gaps, report "post", the per-step x, P and initialised flag.
extern "C" int lcm_kalman_forward(
    const void* cand_pos, const void* cand_head, const void* cand_index,
    const void* cand_valid, const void* dts, const void* ba_host,
    const void* x_in, const void* P_in, const void* init_in,
    const void* prev_in, const void* lh_in, const void* lv_in,
    const void* age_in, void* out, int B, int M, int O, float q, float r,
    float gap_reset_s, void* stream) {
  return launch<true>(cand_pos, cand_head, cand_index, cand_valid, dts,
                      ba_host, x_in, P_in, init_in, prev_in, lh_in, lv_in,
                      age_in, out, B, M, O, q, r, gap_reset_s, 1, stream);
}

// The RTS smoother's backward pass over T >= 2 frames of O >= 1 objects:
// the gains, then the sweep, on one stream.  out: float32 xs_s (T, O, 9)
// then Ps_s (T, O, 9, 9).  scratch: float32 C (T-1, O, 9, 9), x_pred
// (T-1, O, 9), P_pred (T-1, O, 9, 9).
extern "C" int lcm_kalman_rts(const void* xs, const void* Ps,
                              const void* dts, void* out, void* scratch,
                              int T, int O, float q, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long N = (long long)(T - 1) * O;
  float* C = (float*)scratch;
  float* xp = C + N * 81;
  float* Pp = xp + N * 9;
  float* xs_out = (float*)out;
  float* Ps_out = xs_out + (size_t)T * O * 9;
  const int threads = 9 * 32;          // 32 problems a block
  kalman_bank_rts_gains<<<(unsigned)((N * 9 + threads - 1) / threads),
                          threads, 0, st>>>(
      (const float*)xs, (const float*)Ps, (const float*)dts, C, xp, Pp, N,
      O, q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int warps = O < MAX_WARPS ? O : MAX_WARPS;
  kalman_bank_rts_sweep<<<(O + warps - 1) / warps, 32 * warps,
                          warps * RTS_WARP * sizeof(float), st>>>(
      (const float*)xs, (const float*)Ps, C, xp, Pp, xs_out, Ps_out, T, O,
      warps);
  return (int)cudaGetLastError();
}
