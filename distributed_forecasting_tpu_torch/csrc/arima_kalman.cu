// ARIMA's Kalman filter and forecast recursion on Hopper (sm_90a).
//
// arima_filter replaces, per series, the Kalman lax.scan of the reference's
// distributed_forecasting_tpu/models/arima.py::_kalman_loglik_impl
// (arima.py:198-227) and, for d = 1, the integration lax.scan of _finalize
// (arima.py:473-495).  arima_predict replaces the predict-only recursion of
// _forecast_impl's fc_one (arima.py:576-588).  Neither has a Pallas kernel:
// XLA compiles each scan into one loop on the device.  The port's plain
// twins are models/arima._kalman_loglik_impl, _integrate and _predict_path.
//
// The state space is Harvey's ARMA form: state dimension r = max(p, q + 1),
// transition T with phi in its first column and ones on its superdiagonal,
// disturbance loading R = (1, theta_1..theta_q, 0..), observation e_1.  T's
// fixed structure makes every product a pair of terms:
//   (T a)_i        = phi_i a_0 + a_{i+1}
//   M = T P        : M_il = phi_i P_0l + P_{i+1,l}
//   T P T'         : N_ij = M_i0 phi_j + M_{i,j+1}
// (a_r = P_r. = M_.r = 0), exactly the non-zero terms of the reference's
// dense products, in their order.  P0 is the reference's _init_cov: 30
// fixed-point iterations of P = T P T' + R R' from R R'.
//
// Contract: bitwise equal to the twins on the card.  The twins write the
// same structured products as elementwise tensor operations, so the kernels
// compute term for term what they compute: no contraction (the library is
// built with --fmad=false), IEEE division, logf, the floor of the innovation
// variance written as `x < eps ? eps : x` so that a NaN passes as
// torch.clamp_min lets it, and both branches of each masked step formed and
// selected as torch.where does.
//
// Design, one series a thread (hw_filter's style):
//   - r <= 8: a template instance per r, the state a and covariance P in
//     registers under static indices (every loop over r unrolled).  That
//     covers the default (2, 1, 1) (r = 2), the order: auto ladder (r <= 4)
//     and weekly seasonal P = Q = 1, m = 7 (r = 8).  A block is one warp,
//     32 rows.  Time goes in chunks of 32 steps through shared-memory tiles
//     (odd row stride, no bank conflicts): while the lanes run chunk c,
//     cp.async brings chunk c + 1 in, lane j copying step j of every row
//     (coalesced); each chunk's outputs leave from a tile in coalesced rows.
//     A step reading and writing global memory itself would put 32
//     scattered lines per access, and their latency, on the chain;
//   - 8 < r <= 64 (e.g. m = 52 with P = 1, r = 52): one warp a series, P
//     and T P in shared memory, each lane a strided share of the r^2
//     entries, three warp barriers a step;
//   - a larger r is refused (ARIMA_R_TOO_LARGE; the wrapper raises
//     ValueError): there is no fallback;
//   - arima_filter's d = 1 integration needs sigma^2 = ssq / n, known only
//     after the last step, so it is a second staged pass that reads back the
//     one-step predictions and variances the first wrote (from L2).
//
// Bound on an H100 SXM at the fit shape (S 500, T 1,826, r 2, d 1): bytes,
// zc, zmask, y and mask read and preds, Fs, fitted and fitted_var written,
// 4 * 8 * S * T = 29 MB -> 8.7 us; operations, ~8 r^2 + 5 r + 12 a step,
// ~50 MFLOP -> 0.8 us.  What bounds it is the serial chain of each row: a
// step's covariance depends on the last through the floor of P_00, an IEEE
// division (the gain) and ~6 dependent operations, ~40-60 cycles, so T
// steps take ~40-55 us at 1.98 GHz whatever the width; 500 rows are only 16
// warps, one an SM.  The step as compiled is longer than that chain: ~130
// instructions at r = 2 issued in order by one warp, with three IEEE
// divisions (each a reciprocal, two refinements and a guarded call to the
// slow path between convergence barriers) and logf behind a branch on the
// mask.  PERF.md holds the measured times.
//
// arima_predict at the forecast's shape (S 500, H 91, r 2) on an H100 SXM:
// bytes, the state read and zf, vf written, 0.11 us; its chain, read from
// the SASS (scripts/cuda_kernel_report.py --chain), 5 dependent
// instructions a step from P_00 to the next P_00, 20 cycles at 4 each, H *
// 20 cycles at 1.98 GHz = 0.92 us; and the launch: an empty kernel launched
// the same way takes 1.85 us back to back on the device, the largest of the
// three and so the bound.  Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py --kernel-times): 5.17 us on the device, 36% of that bound
// (the first design, one warp doing both recursions and every store: 6.3
// us); a call costs the host 30-50 us (checks, two allocations, ctypes),
// several times the device's part.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float EPS = 1e-6f;       // models/arima._EPS
constexpr int LYAPUNOV_ITERS = 30;  // models/arima._init_cov
constexpr int REG_R = 8;            // largest r held in registers
constexpr int MAX_R = 64;           // largest r the shared-memory path takes
constexpr int ROWS = 32;            // series per block on the register path
// the launchers' status for an r beyond MAX_R (CUDA's own error codes are
// never negative)
constexpr int ARIMA_R_TOO_LARGE = -1;

__device__ __forceinline__ float clamp_eps(float x) {
  return x < EPS ? EPS : x;
}

// ---------------------------------------------------------------- r <= 8

template <int R>
struct Model {
  float phi[R];  // first column of T, zero past p
  float rv[R];   // R = (1, theta, 0..)

  __device__ __forceinline__ void load(const float* __restrict__ phi_in,
                                       const float* __restrict__ theta_in,
                                       int s, int p, int q) {
#pragma unroll
    for (int i = 0; i < R; ++i)
      phi[i] = i < p ? phi_in[static_cast<size_t>(s) * p + i] : 0.0f;
    rv[0] = 1.0f;
#pragma unroll
    for (int i = 1; i < R; ++i)
      rv[i] = i - 1 < q ? theta_in[static_cast<size_t>(s) * q + i - 1] : 0.0f;
  }

  // M = T P
  __device__ __forceinline__ void tp(const float (&P)[R][R],
                                     float (&M)[R][R]) const {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int l = 0; l < R; ++l)
        M[i][l] = phi[i] * P[0][l] + (i + 1 < R ? P[i + 1][l] : 0.0f);
  }

  // (T P T' + R R')_ij from M = T P
  __device__ __forceinline__ float tpt_rr(const float (&M)[R][R], int i,
                                          int j) const {
    return (M[i][0] * phi[j] + (j + 1 < R ? M[i][j + 1] : 0.0f)) +
           rv[i] * rv[j];
  }

  // a <- T a
  __device__ __forceinline__ void ta(float (&a)[R]) const {
    const float a0 = a[0];
#pragma unroll
    for (int i = 0; i < R; ++i)
      a[i] = phi[i] * a0 + (i + 1 < R ? a[i + 1] : 0.0f);
  }

  // P <- T P T' + R R'
  __device__ __forceinline__ void predict_cov(float (&P)[R][R]) const {
    float M[R][R];
    tp(P, M);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) P[i][j] = tpt_rr(M, i, j);
  }

  // the stationary covariance P0
  __device__ __forceinline__ void init_cov(float (&P)[R][R]) const {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) P[i][j] = rv[i] * rv[j];
    for (int it = 0; it < LYAPUNOV_ITERS; ++it) predict_cov(P);
  }
};

// Warp-cooperative staging of (rows x CH)-step tiles: lane j moves step
// t0 + j of every row, so each copy instruction is one coalesced 128-byte
// row segment.  Tiles are [ROWS][TS] floats (odd stride: a lane reading its
// own row's steps hits a distinct bank).
constexpr int CH = 32;             // steps per chunk
constexpr int TS = CH + 1;         // tile row stride
constexpr int TILE = ROWS * TS;    // floats per tile

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// copy steps [t0, t0 + n) of rows [row0, row0 + rows) of src (S, T) into
// tile, asynchronously
__device__ __forceinline__ void stage(float* tile, const float* src, int rows,
                                      int T, int row0, int t0, int n,
                                      int lane) {
  if (lane < n)
    for (int i = 0; i < rows; ++i)
      cp_async4(tile + i * TS + lane,
                src + static_cast<size_t>(row0 + i) * T + t0 + lane);
}

// write steps [t0, t0 + n) of the tile's rows out to dst (S, T)
__device__ __forceinline__ void write_out(float* dst, const float* tile,
                                          int rows, int T, int row0, int t0,
                                          int n, int lane) {
  if (lane < n)
    for (int i = 0; i < rows; ++i)
      dst[static_cast<size_t>(row0 + i) * T + t0 + lane] = tile[i * TS + lane];
}

// One block is one warp and 32 rows, a row a lane.  Each pass walks time in
// chunks of CH steps: while the lanes run chunk c out of shared memory,
// cp.async brings chunk c + 1 in (double-buffered), and the chunk's outputs
// leave from shared memory in coalesced rows once it is done.
template <int R>
__global__ void __launch_bounds__(ROWS)
    arima_filter_kernel(const float* __restrict__ zc,
                        const float* __restrict__ zmask,
                        const float* __restrict__ y,
                        const float* __restrict__ mask,
                        const float* __restrict__ phi_in,
                        const float* __restrict__ theta_in,
                        const float* __restrict__ mean,
                        const float* __restrict__ y_first,
                        float* __restrict__ preds, float* __restrict__ Fs,
                        float* __restrict__ a_T, float* __restrict__ P_T,
                        float* __restrict__ ssq_out,
                        float* __restrict__ ldet_out,
                        float* __restrict__ n_out, float* __restrict__ fitted,
                        float* __restrict__ fitted_var,
                        float* __restrict__ level_end,
                        float* __restrict__ var_end, int S, int T, int p,
                        int q, int d) {
  // pass 1: in[buf][zc, zmask], out[preds, Fs]; pass 2: in[buf][y, mask,
  // preds, Fs], out[fitted, fitted_var]
  __shared__ float smem[10 * TILE];
  const int lane = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, S - row0);
  const bool live = lane < rows;
  const int s = live ? row0 + lane : row0;  // dead lanes stage, not compute
  const int chunks = (T + CH - 1) / CH;
  float* out0 = smem + 8 * TILE;
  float* out1 = smem + 9 * TILE;

  Model<R> mdl;
  mdl.load(phi_in, theta_in, s, p, q);
  float P[R][R];
  mdl.init_cov(P);
  float a[R];
#pragma unroll
  for (int i = 0; i < R; ++i) a[i] = 0.0f;
  float ssq = 0.0f, ldet = 0.0f, n = 0.0f;

  auto in1 = [&](int c, int k) { return smem + ((c & 1) * 2 + k) * TILE; };
  auto stage1 = [&](int c) {
    if (c < chunks) {
      const int t0 = c * CH, m = min(CH, T - t0);
      stage(in1(c, 0), zc, rows, T, row0, t0, m, lane);
      stage(in1(c, 1), zmask, rows, T, row0, t0, m, lane);
    }
    cp_async_commit();
  };
  stage1(0);
  for (int c = 0; c < chunks; ++c) {
    stage1(c + 1);
    cp_async_wait_prior();  // chunk c has landed
    __syncwarp();
    const int t0 = c * CH, m = min(CH, T - t0);
    const float* zr = in1(c, 0) + lane * TS;
    const float* mr = in1(c, 1) + lane * TS;
    if (live) {
#pragma unroll 4
      for (int j = 0; j < m; ++j) {
        const float zt = zr[j];
        const float mt = mr[j];
        const float pred = a[0];
        const float F = clamp_eps(P[0][0]);
        const float v = zt - pred;
        float M[R][R];
        mdl.tp(P, M);
        float K[R];
#pragma unroll
        for (int i = 0; i < R; ++i) K[i] = M[i][0] / F;
        const bool obs = mt > 0.0f;
        mdl.ta(a);
#pragma unroll
        for (int i = 0; i < R; ++i) a[i] = obs ? a[i] + K[i] * v : a[i];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int k = 0; k < R; ++k) {
            const float pp = mdl.tpt_rr(M, i, k);
            P[i][k] = obs ? pp - (K[i] * K[k]) * F : pp;
          }
        ssq = ssq + (obs ? v * v / F : 0.0f);
        ldet = ldet + (obs ? logf(F) : 0.0f);
        n = n + mt;
        out0[lane * TS + j] = pred;
        out1[lane * TS + j] = F;
      }
    }
    __syncwarp();
    write_out(preds, out0, rows, T, row0, t0, m, lane);
    write_out(Fs, out1, rows, T, row0, t0, m, lane);
    __syncwarp();
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      a_T[static_cast<size_t>(s) * R + i] = a[i];
#pragma unroll
      for (int k = 0; k < R; ++k)
        P_T[(static_cast<size_t>(s) * R + i) * R + k] = P[i][k];
    }
    ssq_out[s] = ssq;
    ldet_out[s] = ldet;
    n_out[s] = n;
  }
  if (d != 1) return;

  // pass 2, the d = 1 integration: the fitted level carried over unobserved
  // steps, its variance accumulated random-walk style.  It reads back the
  // predictions this warp wrote (each lane its own columns).
  __threadfence_block();
  const float s2 = ssq / (n < 1.0f ? 1.0f : n);
  const float mu = mean[s];
  float lvl = y_first[s], var = 0.0f;
  auto in2 = [&](int c, int k) { return smem + ((c & 1) * 4 + k) * TILE; };
  auto stage2 = [&](int c) {
    if (c < chunks) {
      const int t0 = c * CH, m = min(CH, T - t0);
      stage(in2(c, 0), y, rows, T, row0, t0, m, lane);
      stage(in2(c, 1), mask, rows, T, row0, t0, m, lane);
      stage(in2(c, 2), preds, rows, T, row0, t0, m, lane);
      stage(in2(c, 3), Fs, rows, T, row0, t0, m, lane);
    }
    cp_async_commit();
  };
  stage2(0);
  for (int c = 0; c < chunks; ++c) {
    stage2(c + 1);
    cp_async_wait_prior();
    __syncwarp();
    const int t0 = c * CH, m = min(CH, T - t0);
    const float* yr = in2(c, 0) + lane * TS;
    const float* mr = in2(c, 1) + lane * TS;
    const float* pr = in2(c, 2) + lane * TS;
    const float* fr = in2(c, 3) + lane * TS;
    if (live) {
#pragma unroll 4
      for (int j = 0; j < m; ++j) {
        const float zh = pr[j] + mu;
        const float mean_t = lvl + zh;
        const float var_t = var + fr[j] * s2;
        out0[lane * TS + j] = mean_t;
        out1[lane * TS + j] = var_t;
        const bool obs = mr[j] > 0.0f;
        lvl = obs ? yr[j] : mean_t;
        var = obs ? 0.0f * var_t : var_t;
      }
    }
    __syncwarp();
    write_out(fitted, out0, rows, T, row0, t0, m, lane);
    write_out(fitted_var, out1, rows, T, row0, t0, m, lane);
    __syncwarp();
  }
  if (live) {
    level_end[s] = lvl;
    var_end[s] = var;
  }
}

// arima_predict's block: 32 rows and two warps.  Warp 0 runs the chain, the
// covariance recursion P <- T P T' + R R', and writes P_00 to a vf tile;
// warp 1 runs the state recursion a <- T a, writes zf = a_0 to a zf tile,
// and writes both tiles out (vf times sigma^2, the twin's one multiply), so
// the chain warp never stores to global memory.  Both warps store their
// tiles in 16-byte vectors of 4 steps (a shared store queued behind the
// other warp's write-out stalls a warp's in-order issue; one store in 4
// steps leaves less to queue), so tile rows are PTS = 36 floats (16-byte
// aligned; 36 = 4 mod 32: the 8 lanes of a vector store's phase hit
// distinct banks).  The tiles are double-buffered per chunk; two named
// barriers per buffer hand a vf tile over (FULL: warp 0 wrote it, EMPTY:
// warp 1 wrote it out).
constexpr int PREDICT_THREADS = 2 * ROWS;
constexpr int PTS = CH + 4;
constexpr int PTILE = ROWS * PTS;
constexpr int BAR_FULL = 1;   // + buffer (0, 1)
constexpr int BAR_EMPTY = 3;  // + buffer (0, 1)

__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(PREDICT_THREADS)
               : "memory");
}

__device__ __forceinline__ void pair_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(PREDICT_THREADS)
               : "memory");
}

// The block's n-float rows [row0, row0 + rows) of src (S, n) into dst, one
// coalesced run of asynchronous copies by all of the block's threads (every
// copy in flight at once; the caller waits for them).
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int row0, int rows, int n,
                                           int tid) {
  const float* from = src + static_cast<size_t>(row0) * n;
  for (int k = tid; k < rows * n; k += PREDICT_THREADS)
    cp_async4(dst + k, from + k);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Write steps [t0, t0 + n) of the tile's rows out to dst (S, H), each times
// its row's scale (SCALED: vf) or as is (zf); eight rows' loads in flight
// at a time.
template <bool SCALED>
__device__ __forceinline__ void write_rows(float* dst, const float* tile,
                                           const float* scale, int rows,
                                           int H, int row0, int t0, int n,
                                           int lane) {
  if (lane >= n) return;
  float* out = dst + static_cast<size_t>(row0) * H + t0 + lane;
#pragma unroll 8
  for (int i = 0; i < rows; ++i) {
    const float v = tile[i * PTS + lane];
    out[static_cast<size_t>(i) * H] = SCALED ? v * scale[i] : v;
  }
}

template <int R>
__global__ void __launch_bounds__(PREDICT_THREADS)
    arima_predict_kernel(const float* __restrict__ phi_in,
                         const float* __restrict__ theta_in,
                         const float* __restrict__ a0,
                         const float* __restrict__ P0,
                         const float* __restrict__ sigma2,
                         float* __restrict__ zf, float* __restrict__ vf,
                         int S, int H, int p, int q) {
  __shared__ __align__(16) float tiles[4 * PTILE];  // zf[2], vf[2] (raw P_00)
  __shared__ float s_phi[ROWS * R], s_theta[ROWS * R], s_a0[ROWS * R];
  __shared__ float s_P0[ROWS * R * R], s_s2[ROWS];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, S - row0);
  stage_rows(s_phi, phi_in, row0, rows, p, tid);
  stage_rows(s_theta, theta_in, row0, rows, q, tid);
  stage_rows(s_a0, a0, row0, rows, R, tid);
  stage_rows(s_P0, P0, row0, rows, R * R, tid);
  stage_rows(s_s2, sigma2, row0, rows, 1, tid);
  cp_async_wait_all();
  __syncthreads();
  const int k = lane < rows ? lane : 0;  // dead lanes rerun row 0, store nothing
  Model<R> mdl;
  mdl.load(s_phi, s_theta, k, p, q);
  const int chunks = (H + CH - 1) / CH;

  if (tid < ROWS) {  // warp 0: the covariance chain
    float P[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) P[i][j] = s_P0[(k * R + i) * R + j];
    for (int c = 0; c < chunks; ++c) {
      const int b = c & 1, h0 = c * CH, m = min(CH, H - h0);
      float* out = tiles + (2 + b) * PTILE;
      if (c >= 2) pair_sync(BAR_EMPTY + b);  // chunk c - 2 written out
      for (int j = 0; j < m; j += 4) {  // past m the vector's rest is unused
        float4 v;
        mdl.predict_cov(P);
        v.x = P[0][0];
        if (j + 1 < m) mdl.predict_cov(P);
        v.y = P[0][0];
        if (j + 2 < m) mdl.predict_cov(P);
        v.z = P[0][0];
        if (j + 3 < m) mdl.predict_cov(P);
        v.w = P[0][0];
        *reinterpret_cast<float4*>(out + lane * PTS + j) = v;
      }
      if (c + 1 < chunks) {
        pair_arrive(BAR_FULL + b);
      } else {  // the last chunk: warp 0 writes its own tile out
        __syncwarp();
        write_rows<true>(vf, out, s_s2, rows, H, row0, h0, m, lane);
      }
    }
    return;
  }

  // warp 1: the state, zf, and the write-out of both tiles
  float a[R];
#pragma unroll
  for (int i = 0; i < R; ++i) a[i] = s_a0[k * R + i];
  for (int c = 0; c < chunks; ++c) {
    const int b = c & 1, h0 = c * CH, m = min(CH, H - h0);
    float* out = tiles + b * PTILE;
    for (int j = 0; j < m; j += 4) {
      float4 v;
      mdl.ta(a);
      v.x = a[0];
      if (j + 1 < m) mdl.ta(a);
      v.y = a[0];
      if (j + 2 < m) mdl.ta(a);
      v.z = a[0];
      if (j + 3 < m) mdl.ta(a);
      v.w = a[0];
      *reinterpret_cast<float4*>(out + lane * PTS + j) = v;
    }
    __syncwarp();
    write_rows<false>(zf, out, nullptr, rows, H, row0, h0, m, lane);
    if (c + 1 < chunks) {
      pair_sync(BAR_FULL + b);  // chunk c's vf tile is whole
      write_rows<true>(vf, tiles + (2 + b) * PTILE, s_s2, rows, H, row0, h0,
                       m, lane);
      if (c + 2 < chunks) pair_arrive(BAR_EMPTY + b);
    }
    __syncwarp();  // every lane read the zf tile before it is rewritten
  }
}

// ------------------------------------------------------- 8 < r <= MAX_R

// Shared memory of one series (floats): P and M r*r each; a, Ta, K, phi, rv
// r each.
__host__ __device__ constexpr int warp_smem_floats(int r) {
  return 2 * r * r + 5 * r;
}

struct WarpModel {
  int r;
  float *P, *M, *a, *ta, *K, *phi, *rv;

  __device__ WarpModel(float* smem, int r_) : r(r_) {
    P = smem;
    M = P + r * r;
    a = M + r * r;
    ta = a + r;
    K = ta + r;
    phi = K + r;
    rv = phi + r;
  }

  __device__ void load(const float* __restrict__ phi_in,
                       const float* __restrict__ theta_in, int s, int p,
                       int q, int lane) {
    for (int i = lane; i < r; i += 32) {
      phi[i] = i < p ? phi_in[static_cast<size_t>(s) * p + i] : 0.0f;
      rv[i] = i == 0 ? 1.0f
                     : (i - 1 < q ? theta_in[static_cast<size_t>(s) * q + i - 1]
                                  : 0.0f);
    }
    __syncwarp();
  }

  // M = T P (and Ta = T a, into ta)
  __device__ void tp(int lane) {
    for (int idx = lane; idx < r * r; idx += 32) {
      const int i = idx / r, l = idx - i * r;
      M[idx] = phi[i] * P[l] + (i + 1 < r ? P[idx + r] : 0.0f);
    }
    for (int i = lane; i < r; i += 32)
      ta[i] = phi[i] * a[0] + (i + 1 < r ? a[i + 1] : 0.0f);
    __syncwarp();
  }

  __device__ float tpt_rr(int i, int j) const {
    return (M[i * r] * phi[j] + (j + 1 < r ? M[i * r + j + 1] : 0.0f)) +
           rv[i] * rv[j];
  }

  // P <- T P T' + R R' from M (no gain)
  __device__ void predict_cov_from_m(int lane) {
    for (int idx = lane; idx < r * r; idx += 32) {
      const int i = idx / r, j = idx - i * r;
      P[idx] = tpt_rr(i, j);
    }
    __syncwarp();
  }

  __device__ void init_cov(int lane) {
    for (int idx = lane; idx < r * r; idx += 32) {
      const int i = idx / r, j = idx - i * r;
      P[idx] = rv[i] * rv[j];
    }
    __syncwarp();
    for (int it = 0; it < LYAPUNOV_ITERS; ++it) {
      tp(lane);
      predict_cov_from_m(lane);
    }
  }
};

__global__ void __launch_bounds__(32)
    arima_filter_kernel_warp(const float* __restrict__ zc, const float* __restrict__ zmask,
                const float* __restrict__ y, const float* __restrict__ mask,
                const float* __restrict__ phi_in,
                const float* __restrict__ theta_in,
                const float* __restrict__ mean,
                const float* __restrict__ y_first, float* __restrict__ preds,
                float* __restrict__ Fs, float* __restrict__ a_T,
                float* __restrict__ P_T, float* __restrict__ ssq_out,
                float* __restrict__ ldet_out, float* __restrict__ n_out,
                float* __restrict__ fitted, float* __restrict__ fitted_var,
                float* __restrict__ level_end, float* __restrict__ var_end,
                int S, int T, int p, int q, int r, int d) {
  extern __shared__ float smem[];
  const int s = blockIdx.x;
  const int lane = threadIdx.x;
  WarpModel mdl(smem, r);
  mdl.load(phi_in, theta_in, s, p, q, lane);
  for (int i = lane; i < r; i += 32) mdl.a[i] = 0.0f;
  mdl.init_cov(lane);  // its first barrier also covers a
  // every lane carries the same scalars; lane 0 writes them
  float ssq = 0.0f, ldet = 0.0f, n = 0.0f;
  const size_t base = static_cast<size_t>(s) * T;

  for (int t = 0; t < T; ++t) {
    const float zt = __ldg(zc + base + t);
    const float mt = __ldg(zmask + base + t);
    const float pred = mdl.a[0];
    const float F = clamp_eps(mdl.P[0]);
    const float v = zt - pred;
    const bool obs = mt > 0.0f;
    mdl.tp(lane);
    for (int i = lane; i < r; i += 32) {
      const float k = mdl.M[i * r] / F;
      mdl.K[i] = k;
      mdl.a[i] = obs ? mdl.ta[i] + k * v : mdl.ta[i];
    }
    __syncwarp();
    for (int idx = lane; idx < r * r; idx += 32) {
      const int i = idx / r, j = idx - i * r;
      const float pp = mdl.tpt_rr(i, j);
      mdl.P[idx] = obs ? pp - (mdl.K[i] * mdl.K[j]) * F : pp;
    }
    __syncwarp();
    ssq = ssq + (obs ? v * v / F : 0.0f);
    ldet = ldet + (obs ? logf(F) : 0.0f);
    n = n + mt;
    if (lane == 0) {
      preds[base + t] = pred;
      Fs[base + t] = F;
    }
  }

  for (int idx = lane; idx < r * r; idx += 32)
    P_T[static_cast<size_t>(s) * r * r + idx] = mdl.P[idx];
  for (int i = lane; i < r; i += 32)
    a_T[static_cast<size_t>(s) * r + i] = mdl.a[i];
  if (lane != 0) return;
  ssq_out[s] = ssq;
  ldet_out[s] = ldet;
  n_out[s] = n;
  if (d != 1) return;

  const float s2 = ssq / (n < 1.0f ? 1.0f : n);
  const float mu = mean[s];
  float lvl = y_first[s], var = 0.0f;
  for (int t = 0; t < T; ++t) {
    const float zh = preds[base + t] + mu;
    const float mean_t = lvl + zh;
    const float var_t = var + Fs[base + t] * s2;
    fitted[base + t] = mean_t;
    fitted_var[base + t] = var_t;
    const bool obs = __ldg(mask + base + t) > 0.0f;
    lvl = obs ? __ldg(y + base + t) : mean_t;
    var = obs ? 0.0f * var_t : var_t;
  }
  level_end[s] = lvl;
  var_end[s] = var;
}

__global__ void __launch_bounds__(32)
    arima_predict_kernel_warp(const float* __restrict__ phi_in,
                 const float* __restrict__ theta_in,
                 const float* __restrict__ a0, const float* __restrict__ P0,
                 const float* __restrict__ sigma2, float* __restrict__ zf,
                 float* __restrict__ vf, int S, int H, int p, int q, int r) {
  extern __shared__ float smem[];
  const int s = blockIdx.x;
  const int lane = threadIdx.x;
  WarpModel mdl(smem, r);
  mdl.load(phi_in, theta_in, s, p, q, lane);
  for (int idx = lane; idx < r * r; idx += 32)
    mdl.P[idx] = P0[static_cast<size_t>(s) * r * r + idx];
  for (int i = lane; i < r; i += 32)
    mdl.a[i] = a0[static_cast<size_t>(s) * r + i];
  __syncwarp();
  const float s2 = sigma2[s];
  const size_t base = static_cast<size_t>(s) * H;
  for (int h = 0; h < H; ++h) {
    mdl.tp(lane);
    for (int i = lane; i < r; i += 32) mdl.a[i] = mdl.ta[i];
    mdl.predict_cov_from_m(lane);  // ends in a warp barrier
    if (lane == 0) {
      zf[base + h] = mdl.a[0];
      vf[base + h] = mdl.P[0] * s2;
    }
    __syncwarp();
  }
}

template <int R>
cudaError_t launch_filter_reg(const float* zc, const float* zmask,
                              const float* y, const float* mask,
                              const float* phi, const float* theta,
                              const float* mean, const float* y_first,
                              float* preds, float* Fs, float* a_T, float* P_T,
                              float* ssq, float* ldet, float* n, float* fitted,
                              float* fitted_var, float* level_end,
                              float* var_end, int S, int T, int p, int q,
                              int d, cudaStream_t st) {
  const int blocks = (S + ROWS - 1) / ROWS;
  arima_filter_kernel<R><<<blocks, ROWS, 0, st>>>(
      zc, zmask, y, mask, phi, theta, mean, y_first, preds, Fs, a_T, P_T, ssq,
      ldet, n, fitted, fitted_var, level_end, var_end, S, T, p, q, d);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_predict_reg(const float* phi, const float* theta,
                               const float* a0, const float* P0,
                               const float* sigma2, float* zf, float* vf,
                               int S, int H, int p, int q, cudaStream_t st) {
  const int blocks = (S + ROWS - 1) / ROWS;
  arima_predict_kernel<R><<<blocks, PREDICT_THREADS, 0, st>>>(
      phi, theta, a0, P0, sigma2, zf, vf, S, H, p, q);
  return cudaGetLastError();
}

}  // namespace

// C launchers read through ctypes (ops/_build.py).  Each launches on
// `stream` and returns cudaGetLastError() of the launch (0 on success), or
// ARIMA_R_TOO_LARGE for an r beyond MAX_R; the wrappers (ops/kalman.py)
// check shapes, types and contiguity first.  y, mask, y_first, fitted,
// fitted_var, level_end and var_end are read or written only for d = 1.
extern "C" int arima_filter_launch(
    const float* zc, const float* zmask, const float* y, const float* mask,
    const float* phi, const float* theta, const float* mean,
    const float* y_first, float* preds, float* Fs, float* a_T, float* P_T,
    float* ssq, float* ldet, float* n, float* fitted, float* fitted_var,
    float* level_end, float* var_end, int S, int T, int p, int q, int r,
    int d, void* stream) {
  if (S <= 0 || r < 1 || p > r || q >= r)
    return static_cast<int>(cudaErrorInvalidValue);
  if (r > MAX_R) return ARIMA_R_TOO_LARGE;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ARIMA_FILTER_REG(R)                                                  \
  case R:                                                                    \
    return static_cast<int>(launch_filter_reg<R>(                            \
        zc, zmask, y, mask, phi, theta, mean, y_first, preds, Fs, a_T, P_T,  \
        ssq, ldet, n, fitted, fitted_var, level_end, var_end, S, T, p, q, d, \
        st));
  switch (r) {
    ARIMA_FILTER_REG(1)
    ARIMA_FILTER_REG(2)
    ARIMA_FILTER_REG(3)
    ARIMA_FILTER_REG(4)
    ARIMA_FILTER_REG(5)
    ARIMA_FILTER_REG(6)
    ARIMA_FILTER_REG(7)
    ARIMA_FILTER_REG(8)
    default:
      break;
  }
#undef ARIMA_FILTER_REG
  static_assert(REG_R == 8, "the switch above instantiates r = 1..REG_R");
  const size_t smem = warp_smem_floats(r) * sizeof(float);
  arima_filter_kernel_warp<<<S, 32, smem, st>>>(zc, zmask, y, mask, phi, theta, mean,
                                   y_first, preds, Fs, a_T, P_T, ssq, ldet, n,
                                   fitted, fitted_var, level_end, var_end, S,
                                   T, p, q, r, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int arima_predict_launch(const float* phi, const float* theta,
                                    const float* a0, const float* P0,
                                    const float* sigma2, float* zf, float* vf,
                                    int S, int H, int p, int q, int r,
                                    void* stream) {
  if (S <= 0 || H <= 0 || r < 1 || p > r || q >= r)
    return static_cast<int>(cudaErrorInvalidValue);
  if (r > MAX_R) return ARIMA_R_TOO_LARGE;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ARIMA_PREDICT_REG(R)                                                 \
  case R:                                                                    \
    return static_cast<int>(launch_predict_reg<R>(phi, theta, a0, P0,       \
                                                  sigma2, zf, vf, S, H, p,   \
                                                  q, st));
  switch (r) {
    ARIMA_PREDICT_REG(1)
    ARIMA_PREDICT_REG(2)
    ARIMA_PREDICT_REG(3)
    ARIMA_PREDICT_REG(4)
    ARIMA_PREDICT_REG(5)
    ARIMA_PREDICT_REG(6)
    ARIMA_PREDICT_REG(7)
    ARIMA_PREDICT_REG(8)
    default:
      break;
  }
#undef ARIMA_PREDICT_REG
  const size_t smem = warp_smem_floats(r) * sizeof(float);
  arima_predict_kernel_warp<<<S, 32, smem, st>>>(phi, theta, a0, P0, sigma2, zf, vf, S, H,
                                    p, q, r);
  return static_cast<int>(cudaGetLastError());
}

// A kernel that does nothing, launched in `blocks` blocks as arima_predict's
// launcher launches its own (S / 32 rounded up, two warps each): the launch
// floor that no design of a small kernel goes under.  A measurement entry
// only (chip_smoke.py binds and times it); no module of the package calls it.
__global__ void arima_empty_kernel() {}

extern "C" int arima_empty_launch(int blocks, void* stream) {
  arima_empty_kernel<<<blocks, PREDICT_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

static const char* arima_error_string(int err) {
  if (err == ARIMA_R_TOO_LARGE)
    return "the state dimension r = max(p, q + 1) (seasonal lags included) "
           "exceeds the kernels' limit of 64";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* arima_filter_error_string(int err) {
  return arima_error_string(err);
}

extern "C" const char* arima_predict_error_string(int err) {
  return arima_error_string(err);
}
