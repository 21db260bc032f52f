// The exact Gaussian likelihood of ARIMA's MLE fit and its gradient, on
// Hopper (sm_90a), by forward-mode differentiation of the Kalman filter.
//
// arima_loglik_grad replaces the reverse-mode autodiff that the reference's
// 'mle' fit takes of its Kalman filter (distributed_forecasting_tpu/models/
// arima.py: jax.value_and_grad of nll_one, arima.py:408-426, through the
// lax.scan of _kalman_loglik_impl, arima.py:198-227, and _init_cov's 30
// Lyapunov iterations, arima.py:170-180).  There is no Pallas kernel: XLA
// differentiates the scan.  The port's plain twin is
// models/arima.arima_loglik_grad_reference.
//
// What it computes, per series: the filter's ssq (sum of v^2 / F), ldet (sum
// of log F) and n (observed steps), exactly as csrc/arima_kalman.cu's
// arima_filter computes them (the same products in the same order: bitwise
// equal), and the Jacobians d ssq / d c and d ldet / d c for every
// coefficient c of (phi_1..phi_p, theta_1..theta_q).
//
// Forward mode rather than an adjoint.  p + q is small (3 at the default
// (2, 1, 1), <= 5 on the order: auto ladder; the MLE fit refuses seasonal
// terms), so carrying one tangent (da, dP) per coefficient beside the primal
// (a, P) gives the whole Jacobian in one pass over T with no per-step
// storage and no reverse sweep.  A phi_i direction has dT = e_i e_0' (dphi =
// e_i); a theta_j direction dR = e_j (drv = e_j).  With dRR' = dR R' + R dR'
// the recursion is
//   P0:        dP <- dT P T' + T dP T' + T P dT' + dRR'  (all 30 iterations)
//   observed:  dF = P_00 > eps ? dP_00 : 0,  dv = -da_0
//              dK = (d(T P)_:0 - K dF) / F
//              da <- dT a + T da + dK v + K dv
//              dP <- d(T P T') + dRR' - ((dK K' + K dK') F + K K' dF)
//              dssq += (2 v dv - (v^2 / F) dF) / F,  dldet += dF / F
//   masked:    da <- dT a + T da,  dP <- d(T P T') + dRR'
// where d(T X) = dT X + T dX (T's structure makes dT X the row X_0. added
// to row i of a phi_i direction) and d(M T') = dM T' + M dT'.  Each
// direction is computed generically, with dphi and drv one-hot vectors (or
// zero: a launch with no coefficient computes the primal alone), so the
// twin writes the same elementwise operations.
//
// Contract: bitwise equal to the twin on the card, and the primal bitwise
// equal to arima_filter's: the library is built with --fmad=false, every
// operation is written in the twin's order, the floor of F is
// `x < eps ? eps : x`, and both branches of a masked step are formed and
// one selected, as torch.where does.
//
// Design: one thread a (series, coefficient).  It recomputes the primal and
// carries its own tangent, so the serial chain is the primal's plus the
// tangent's and registers stay near 2 (r + r^2) (one thread a series with
// every tangent would hold (1 + p + q)(r + r^2) and run the tangents in
// series).  At the fit shape (500 series, (2, 1, 1)) that is 1,500 threads,
// at the CV pass's 1,500 rows 4,500.
//   - r <= 8: a template instance per r, state in registers under static
//     indices; a block is one warp, 32 series of one coefficient
//     (blockIdx.y); time goes in chunks of 32 steps through shared-memory
//     tiles filled by cp.async while the previous chunk runs, as
//     arima_filter stages its inputs;
//   - 8 < r <= 64: one warp a (series, coefficient), P, T P and their
//     tangents in shared memory (4 r^2 floats, 68 KB at r = 64), each lane
//     a strided share of the r^2 entries, three warp barriers a step;
//   - a larger r is refused (ARIMA_R_TOO_LARGE; the wrapper raises
//     ValueError): there is no fallback.
//
// Bound on an H100 SXM at the fit shape (S 500, T 1,826, r 2, 3
// coefficients): bytes, zc and zmask read once, 7.3 MB -> 2.2 us;
// operations, the primal once (~8 r^2 + 5 r + 8 a step) and each tangent
// (~19 r^2 + 11 r + 12 a step), ~350 MFLOP -> 5.2 us at float32's 67
// TFLOP/s.  What bounds it is each thread's serial chain, 1,826 steps of the
// primal's and the tangent's dependent operations (three IEEE divisions a
// step), with 48 warps on 132 SMs.  PERF.md holds the measured times.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float EPS = 1e-6f;       // models/arima._EPS
constexpr int LYAPUNOV_ITERS = 30;  // models/arima._init_cov
constexpr int MAX_R = 64;           // largest r the shared-memory path takes
constexpr int ROWS = 32;            // series per block on the register path
constexpr int ARIMA_R_TOO_LARGE = -1;

__device__ __forceinline__ float clamp_eps(float x) {
  return x < EPS ? EPS : x;
}

// ---------------------------------------------------------------- r <= 8

// The model of one (series, direction): T's first column and R, and the
// direction's one-hot dphi / drv (zero past p, q; all zero for dir >= k).
template <int R>
struct TangentModel {
  float phi[R], rv[R], dph[R], drv[R];

  __device__ __forceinline__ void load(const float* __restrict__ phi_in,
                                       const float* __restrict__ theta_in,
                                       int s, int p, int q, int dir) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      phi[i] = i < p ? phi_in[static_cast<size_t>(s) * p + i] : 0.0f;
      dph[i] = (dir < p && i == dir) ? 1.0f : 0.0f;
      drv[i] = (dir >= p && dir < p + q && i == dir - p + 1) ? 1.0f : 0.0f;
    }
    rv[0] = 1.0f;
#pragma unroll
    for (int i = 1; i < R; ++i)
      rv[i] = i - 1 < q ? theta_in[static_cast<size_t>(s) * q + i - 1] : 0.0f;
  }

  // M = T P and dM = T dP + dT P
  __device__ __forceinline__ void tp(const float (&P)[R][R],
                                     const float (&dP)[R][R], float (&M)[R][R],
                                     float (&dM)[R][R]) const {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int l = 0; l < R; ++l) {
        M[i][l] = phi[i] * P[0][l] + (i + 1 < R ? P[i + 1][l] : 0.0f);
        dM[i][l] = (phi[i] * dP[0][l] + (i + 1 < R ? dP[i + 1][l] : 0.0f)) +
                   dph[i] * P[0][l];
      }
  }

  // (T P T' + R R')_ij from M = T P
  __device__ __forceinline__ float tpt_rr(const float (&M)[R][R], int i,
                                          int j) const {
    return (M[i][0] * phi[j] + (j + 1 < R ? M[i][j + 1] : 0.0f)) +
           rv[i] * rv[j];
  }

  // its tangent: (dM T' + M dT') + dRR'
  __device__ __forceinline__ float dtpt_rr(const float (&M)[R][R],
                                           const float (&dM)[R][R], int i,
                                           int j) const {
    return ((dM[i][0] * phi[j] + (j + 1 < R ? dM[i][j + 1] : 0.0f)) +
            M[i][0] * dph[j]) +
           (drv[i] * rv[j] + rv[i] * drv[j]);
  }
};

// Warp-cooperative staging of (rows x CH)-step tiles, as in
// csrc/arima_kalman.cu: lane j moves step t0 + j of every row.
constexpr int CH = 32;
constexpr int TS = CH + 1;
constexpr int TILE = ROWS * TS;

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

__device__ __forceinline__ void stage(float* tile, const float* src, int rows,
                                      int T, int row0, int t0, int n,
                                      int lane) {
  if (lane < n)
    for (int i = 0; i < rows; ++i)
      cp_async4(tile + i * TS + lane,
                src + static_cast<size_t>(row0 + i) * T + t0 + lane);
}

// One block is one warp: 32 series (a lane each) of one direction,
// blockIdx.y.  Direction dir < k writes column dir of dssq / dldet; the
// blocks of direction 0 write ssq, ldet and n.
template <int R>
__global__ void __launch_bounds__(ROWS)
    arima_loglik_grad_kernel(const float* __restrict__ zc,
                             const float* __restrict__ zmask,
                             const float* __restrict__ phi_in,
                             const float* __restrict__ theta_in,
                             float* __restrict__ ssq_out,
                             float* __restrict__ ldet_out,
                             float* __restrict__ n_out,
                             float* __restrict__ dssq_out,
                             float* __restrict__ dldet_out, int S, int T,
                             int p, int q) {
  __shared__ float smem[4 * TILE];
  const int lane = threadIdx.x;
  const int dir = blockIdx.y;
  const int k = p + q;
  const int row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, S - row0);
  const bool live = lane < rows;
  const int s = live ? row0 + lane : row0;
  const int chunks = (T + CH - 1) / CH;

  TangentModel<R> mdl;
  mdl.load(phi_in, theta_in, s, p, q, dir);
  float P[R][R], dP[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      P[i][j] = mdl.rv[i] * mdl.rv[j];
      dP[i][j] = mdl.drv[i] * mdl.rv[j] + mdl.rv[i] * mdl.drv[j];
    }
  for (int it = 0; it < LYAPUNOV_ITERS; ++it) {
    float M[R][R], dM[R][R];
    mdl.tp(P, dP, M, dM);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        P[i][j] = mdl.tpt_rr(M, i, j);
        dP[i][j] = mdl.dtpt_rr(M, dM, i, j);
      }
  }
  float a[R], da[R];
#pragma unroll
  for (int i = 0; i < R; ++i) a[i] = da[i] = 0.0f;
  float ssq = 0.0f, ldet = 0.0f, n = 0.0f, dssq = 0.0f, dldet = 0.0f;

  auto tile = [&](int c, int which) {
    return smem + ((c & 1) * 2 + which) * TILE;
  };
  auto stage_chunk = [&](int c) {
    if (c < chunks) {
      const int t0 = c * CH, m = min(CH, T - t0);
      stage(tile(c, 0), zc, rows, T, row0, t0, m, lane);
      stage(tile(c, 1), zmask, rows, T, row0, t0, m, lane);
    }
    cp_async_commit();
  };
  stage_chunk(0);
  for (int c = 0; c < chunks; ++c) {
    stage_chunk(c + 1);
    cp_async_wait_prior();
    __syncwarp();
    const int m = min(CH, T - c * CH);
    const float* zr = tile(c, 0) + lane * TS;
    const float* mr = tile(c, 1) + lane * TS;
    if (live) {
#pragma unroll 2
      for (int j = 0; j < m; ++j) {
        const float zt = zr[j];
        const float mt = mr[j];
        const float pred = a[0];
        const float F = clamp_eps(P[0][0]);
        const float v = zt - pred;
        const float dF = P[0][0] > EPS ? dP[0][0] : 0.0f;
        const float dv = -da[0];
        float M[R][R], dM[R][R];
        mdl.tp(P, dP, M, dM);
        float K[R], dK[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          K[i] = M[i][0] / F;
          dK[i] = (dM[i][0] - K[i] * dF) / F;
        }
        const bool obs = mt > 0.0f;
        // a <- T a (+ K v), da <- dT a + T da (+ dK v + K dv)
        const float a0 = a[0], da0 = da[0];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float ta = mdl.phi[i] * a0 + (i + 1 < R ? a[i + 1] : 0.0f);
          const float dta =
              (mdl.phi[i] * da0 + (i + 1 < R ? da[i + 1] : 0.0f)) +
              mdl.dph[i] * a0;
          a[i] = obs ? ta + K[i] * v : ta;
          da[i] = obs ? (dta + dK[i] * v) + K[i] * dv : dta;
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int l = 0; l < R; ++l) {
            const float pp = mdl.tpt_rr(M, i, l);
            const float dpp = mdl.dtpt_rr(M, dM, i, l);
            P[i][l] = obs ? pp - (K[i] * K[l]) * F : pp;
            dP[i][l] = obs ? dpp - ((dK[i] * K[l] + K[i] * dK[l]) * F +
                                    (K[i] * K[l]) * dF)
                           : dpp;
          }
        const float w = v * v / F;
        ssq = ssq + (obs ? w : 0.0f);
        ldet = ldet + (obs ? logf(F) : 0.0f);
        n = n + mt;
        dssq = dssq + (obs ? (2.0f * v * dv - w * dF) / F : 0.0f);
        dldet = dldet + (obs ? dF / F : 0.0f);
      }
    }
    __syncwarp();  // the next stage overwrites this chunk's buffer
  }
  if (!live) return;
  if (dir == 0) {
    ssq_out[s] = ssq;
    ldet_out[s] = ldet;
    n_out[s] = n;
  }
  if (dir < k) {
    dssq_out[static_cast<size_t>(s) * k + dir] = dssq;
    dldet_out[static_cast<size_t>(s) * k + dir] = dldet;
  }
}

// ------------------------------------------------------- 8 < r <= MAX_R

// Shared memory of one (series, direction), floats: P, M, dP, dM r*r each;
// a, ta, K, da, dta, dK, phi, rv, dph, drv r each.
__host__ __device__ constexpr int warp_smem_floats(int r) {
  return 4 * r * r + 10 * r;
}

struct WarpTangent {
  int r;
  float *P, *M, *dP, *dM, *a, *ta, *K, *da, *dta, *dK, *phi, *rv, *dph, *drv;

  __device__ WarpTangent(float* smem, int r_) : r(r_) {
    P = smem;
    M = P + r * r;
    dP = M + r * r;
    dM = dP + r * r;
    a = dM + r * r;
    ta = a + r;
    K = ta + r;
    da = K + r;
    dta = da + r;
    dK = dta + r;
    phi = dK + r;
    rv = phi + r;
    dph = rv + r;
    drv = dph + r;
  }

  __device__ void load(const float* __restrict__ phi_in,
                       const float* __restrict__ theta_in, int s, int p,
                       int q, int dir, int lane) {
    for (int i = lane; i < r; i += 32) {
      phi[i] = i < p ? phi_in[static_cast<size_t>(s) * p + i] : 0.0f;
      rv[i] = i == 0 ? 1.0f
                     : (i - 1 < q ? theta_in[static_cast<size_t>(s) * q + i - 1]
                                  : 0.0f);
      dph[i] = (dir < p && i == dir) ? 1.0f : 0.0f;
      drv[i] = (dir >= p && dir < p + q && i == dir - p + 1) ? 1.0f : 0.0f;
      a[i] = 0.0f;
      da[i] = 0.0f;
    }
    __syncwarp();
  }

  // M = T P, dM = T dP + dT P; ta = T a, dta = T da + dT a
  __device__ void tp(int lane) {
    for (int idx = lane; idx < r * r; idx += 32) {
      const int i = idx / r, l = idx - i * r;
      M[idx] = phi[i] * P[l] + (i + 1 < r ? P[idx + r] : 0.0f);
      dM[idx] = (phi[i] * dP[l] + (i + 1 < r ? dP[idx + r] : 0.0f)) +
                dph[i] * P[l];
    }
    for (int i = lane; i < r; i += 32) {
      ta[i] = phi[i] * a[0] + (i + 1 < r ? a[i + 1] : 0.0f);
      dta[i] = (phi[i] * da[0] + (i + 1 < r ? da[i + 1] : 0.0f)) +
               dph[i] * a[0];
    }
    __syncwarp();
  }

  __device__ float tpt_rr(int i, int j) const {
    return (M[i * r] * phi[j] + (j + 1 < r ? M[i * r + j + 1] : 0.0f)) +
           rv[i] * rv[j];
  }

  __device__ float dtpt_rr(int i, int j) const {
    return ((dM[i * r] * phi[j] + (j + 1 < r ? dM[i * r + j + 1] : 0.0f)) +
            M[i * r] * dph[j]) +
           (drv[i] * rv[j] + rv[i] * drv[j]);
  }

  __device__ void init_cov(int lane) {
    for (int idx = lane; idx < r * r; idx += 32) {
      const int i = idx / r, j = idx - i * r;
      P[idx] = rv[i] * rv[j];
      dP[idx] = drv[i] * rv[j] + rv[i] * drv[j];
    }
    __syncwarp();
    for (int it = 0; it < LYAPUNOV_ITERS; ++it) {
      tp(lane);
      for (int idx = lane; idx < r * r; idx += 32) {
        const int i = idx / r, j = idx - i * r;
        P[idx] = tpt_rr(i, j);
        dP[idx] = dtpt_rr(i, j);
      }
      __syncwarp();
    }
  }
};

__global__ void __launch_bounds__(32)
    arima_loglik_grad_kernel_warp(const float* __restrict__ zc,
                                  const float* __restrict__ zmask,
                                  const float* __restrict__ phi_in,
                                  const float* __restrict__ theta_in,
                                  float* __restrict__ ssq_out,
                                  float* __restrict__ ldet_out,
                                  float* __restrict__ n_out,
                                  float* __restrict__ dssq_out,
                                  float* __restrict__ dldet_out, int S, int T,
                                  int p, int q, int r) {
  extern __shared__ float smem[];
  const int s = blockIdx.x;
  const int dir = blockIdx.y;
  const int k = p + q;
  const int lane = threadIdx.x;
  WarpTangent mdl(smem, r);
  mdl.load(phi_in, theta_in, s, p, q, dir, lane);
  mdl.init_cov(lane);
  // every lane carries the same scalars; lane 0 writes them
  float ssq = 0.0f, ldet = 0.0f, n = 0.0f, dssq = 0.0f, dldet = 0.0f;
  const size_t base = static_cast<size_t>(s) * T;

  for (int t = 0; t < T; ++t) {
    const float zt = __ldg(zc + base + t);
    const float mt = __ldg(zmask + base + t);
    const float pred = mdl.a[0];
    const float F = clamp_eps(mdl.P[0]);
    const float v = zt - pred;
    const float dF = mdl.P[0] > EPS ? mdl.dP[0] : 0.0f;
    const float dv = -mdl.da[0];
    const bool obs = mt > 0.0f;
    mdl.tp(lane);
    for (int i = lane; i < r; i += 32) {
      const float kk = mdl.M[i * r] / F;
      const float dk = (mdl.dM[i * r] - kk * dF) / F;
      mdl.K[i] = kk;
      mdl.dK[i] = dk;
      mdl.a[i] = obs ? mdl.ta[i] + kk * v : mdl.ta[i];
      mdl.da[i] = obs ? (mdl.dta[i] + dk * v) + kk * dv : mdl.dta[i];
    }
    __syncwarp();
    for (int idx = lane; idx < r * r; idx += 32) {
      const int i = idx / r, j = idx - i * r;
      const float pp = mdl.tpt_rr(i, j);
      const float dpp = mdl.dtpt_rr(i, j);
      mdl.P[idx] = obs ? pp - (mdl.K[i] * mdl.K[j]) * F : pp;
      mdl.dP[idx] =
          obs ? dpp - ((mdl.dK[i] * mdl.K[j] + mdl.K[i] * mdl.dK[j]) * F +
                       (mdl.K[i] * mdl.K[j]) * dF)
              : dpp;
    }
    __syncwarp();
    const float w = v * v / F;
    ssq = ssq + (obs ? w : 0.0f);
    ldet = ldet + (obs ? logf(F) : 0.0f);
    n = n + mt;
    dssq = dssq + (obs ? (2.0f * v * dv - w * dF) / F : 0.0f);
    dldet = dldet + (obs ? dF / F : 0.0f);
  }
  if (lane != 0) return;
  if (dir == 0) {
    ssq_out[s] = ssq;
    ldet_out[s] = ldet;
    n_out[s] = n;
  }
  if (dir < k) {
    dssq_out[static_cast<size_t>(s) * k + dir] = dssq;
    dldet_out[static_cast<size_t>(s) * k + dir] = dldet;
  }
}

template <int R>
cudaError_t launch_reg(const float* zc, const float* zmask, const float* phi,
                       const float* theta, float* ssq, float* ldet, float* n,
                       float* dssq, float* dldet, int S, int T, int p, int q,
                       cudaStream_t st) {
  const dim3 grid((S + ROWS - 1) / ROWS, p + q > 0 ? p + q : 1);
  arima_loglik_grad_kernel<R><<<grid, ROWS, 0, st>>>(
      zc, zmask, phi, theta, ssq, ldet, n, dssq, dldet, S, T, p, q);
  return cudaGetLastError();
}

}  // namespace

// The C launcher read through ctypes (ops/_build.py): launches on `stream`
// and returns cudaGetLastError() of the launch (0 on success), or
// ARIMA_R_TOO_LARGE for an r beyond MAX_R.  The wrapper
// (ops/kalman.arima_loglik_grad) checks shapes, types and contiguity first.
// dssq and dldet are (S, p + q); with p + q = 0 they are not written.
extern "C" int arima_loglik_grad_launch(const float* zc, const float* zmask,
                                        const float* phi, const float* theta,
                                        float* ssq, float* ldet, float* n,
                                        float* dssq, float* dldet, int S,
                                        int T, int p, int q, int r,
                                        void* stream) {
  if (S <= 0 || r < 1 || p > r || q >= r)
    return static_cast<int>(cudaErrorInvalidValue);
  if (r > MAX_R) return ARIMA_R_TOO_LARGE;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ARIMA_GRAD_REG(R)                                                    \
  case R:                                                                    \
    return static_cast<int>(launch_reg<R>(zc, zmask, phi, theta, ssq, ldet,  \
                                          n, dssq, dldet, S, T, p, q, st));
  switch (r) {
    ARIMA_GRAD_REG(1)
    ARIMA_GRAD_REG(2)
    ARIMA_GRAD_REG(3)
    ARIMA_GRAD_REG(4)
    ARIMA_GRAD_REG(5)
    ARIMA_GRAD_REG(6)
    ARIMA_GRAD_REG(7)
    ARIMA_GRAD_REG(8)
    default:
      break;
  }
#undef ARIMA_GRAD_REG
  const size_t smem = warp_smem_floats(r) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        arima_loglik_grad_kernel_warp,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(S, p + q > 0 ? p + q : 1);
  arima_loglik_grad_kernel_warp<<<grid, 32, smem, st>>>(
      zc, zmask, phi, theta, ssq, ldet, n, dssq, dldet, S, T, p, q, r);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* arima_loglik_grad_error_string(int err) {
  if (err == ARIMA_R_TOO_LARGE)
    return "the state dimension r = max(p, q + 1) exceeds the kernel's "
           "limit of 64";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
