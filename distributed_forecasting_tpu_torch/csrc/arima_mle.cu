// The exact Gaussian likelihood of ARIMA's MLE fit, its gradient, and the
// whole Adam fit, on Hopper (sm_90a), by forward-mode differentiation of the
// Kalman filter.
//
// They replace what the reference's 'mle' fit does with XLA
// (distributed_forecasting_tpu/models/arima.py: fit_one's lax.scan of
// fit_steps Adam steps, arima.py:419-426, each taking jax.value_and_grad of
// nll_one, arima.py:408-418, through the lax.scan of _kalman_loglik_impl,
// arima.py:198-227, and _init_cov's 30 Lyapunov iterations, arima.py:
// 170-180).  There is no Pallas kernel: XLA differentiates the scan.  The
// port's plain twins are models/arima.arima_loglik_grad_reference and
// models/arima.mle_fit_reference.
//
// Two entry points share one filter step:
//   - arima_loglik_grad: one evaluation.  Per series the filter's ssq (sum
//     of v^2 / F), ldet (sum of log F) and n (observed steps), exactly as
//     csrc/arima_kalman.cu's arima_filter computes them (the same operations
//     in the same order: bitwise equal), and the Jacobians d ssq / d c and
//     d ldet / d c for every coefficient c of (phi_1..phi_p,
//     theta_1..theta_q).
//   - arima_mle_fit: the whole fit, `steps` steps of Adam from u = 0 on the
//     unconstrained PACF parameters u (S, p + q), in one launch.  Each step
//     maps u to (phi, theta) (tanh, then Durbin-Levinson), runs the filter
//     with one tangent per coordinate of u, forms the gradient of the
//     concentrated NLL plus the Gaussian prior
//       0.5 n log(max(ssq / n, eps)) + 0.5 ldet + 0.5 |u / prior_scale|^2
//     (n floored at 1, the clamp's gradient zero), zeroes a non-finite
//     entry, and takes the Adam step of ops/optim.adam as it runs on the
//     card: the bias corrections come from the wrapper's table, and a
//     division by one of them is a product with its float32 reciprocal, as
//     PyTorch's CUDA division by a CPU scalar computes it.
//
// Forward mode rather than an adjoint.  p + q is small (3 at the default
// (2, 1, 1); the MLE fit refuses seasonal terms), so one tangent (da, dP)
// per direction beside the primal (a, P) gives the whole gradient in one
// pass over T with no per-step storage and no reverse sweep.  A direction
// is a pair (dphi, drv) of tangents of T's first column and of the loading
// R = (1, theta, 0..): one-hot for arima_loglik_grad, and for the fit column
// j of the Jacobian of (phi, theta) in u_j, carried forward through tanh and
// the Durbin-Levinson recursion, so the filter's tangent is d / d u_j
// directly and no lane reduces across directions.  With dRR' = dR R' + R dR'
// the recursion is
//   P0:        dP <- dT P T' + T dP T' + T P dT' + dRR'  (all 30 iterations)
//   observed:  dF = P_00 > eps ? dP_00 : 0,  dv = -da_0,  rF = 1 / F
//              dK = (d(T P)_:0 - K dF) rF
//              da <- dT a + T da + dK v + K dv
//              dP <- d(T P T') + dRR' - ((dK K' + K dK') F + K K' dF)
//              dssq += (2 v dv - (v^2 / F) dF) rF,  dldet += dF rF
//   masked:    da <- dT a + T da,  dP <- d(T P T') + dRR'
// where d(T X) = dT X + T dX (T's structure makes dT X the row X_0. times
// dphi) and d(M T') = dM T' + M dT'.  The tangent side divides once a step
// (rF, correctly rounded) and multiplies; the primal keeps K = M / F and
// v^2 / F as divisions, so its ssq, ldet and n stay arima_filter's.
//
// Contract: bitwise equal to the twins on the card: the library is built
// with --fmad=false, every operation is written in the twin's order, the
// floor of F is `x < eps ? eps : x`, both branches of a masked step are
// formed and one selected, as torch.where does.
//
// Design:
//   - r <= 8: a template instance per r, state in registers under static
//     indices.  A lane is a (series, direction), the directions of a series
//     adjacent lanes; it holds all of a, P and their tangents (P and dP move
//     to the lane's column of shared memory at r = 8 and dP at r = 7, where
//     the registers would spill) and updates them row by row.  A block is
//     one warp holding as many series as fit (p + q <= 15 lanes each).  The
//     fit keeps u and its Adam moments in shared memory, one slot a lane,
//     where the lanes of a series read each other's u once a step.  Time
//     goes in chunks of 32 steps through shared-memory tiles of zc and
//     zmask, filled by cp.async while the previous chunk runs, one tile row
//     a series, read by every lane of the series.  (Spreading a (series,
//     direction) over r lanes that exchange rows by __shfl_sync was built
//     and measured 2.6-5.4x slower at every r: the shuffles sit on each
//     step's chain.  PERF.md holds both layouts' cycles per step.)
//   - 8 < r <= 64: one warp a (series, direction) for an evaluation (one a
//     series for the fit, its directions one after another), P, T P and
//     their tangents in shared memory (4 r^2 floats, 68 KB at r = 64), each
//     lane a strided share of the r^2 entries, three warp barriers a step;
//   - a larger r is refused (ARIMA_R_TOO_LARGE; the wrapper raises
//     ValueError): there is no fallback.
//
// Bound on an H100 SXM at the fit shape (S 500, T 1,826, r 2, 3
// coefficients), one evaluation: bytes, zc and zmask read once, 7.3 MB ->
// 2.2 us; operations, the primal once (~8 r^2 + 5 r + 8 a step) and each
// tangent (~19 r^2 + 11 r + 12 a step), ~350 MFLOP -> 5.2 us at float32's
// 67 TFLOP/s.  A fit is `steps` evaluations plus the map and Adam.  What
// bounds both is each lane's serial chain, 1,826 steps of the primal's and
// the tangent's dependent operations, with a few warps on 132 SMs.
// PERF.md holds the measured times.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float EPS = 1e-6f;       // models/arima._EPS
constexpr int LYAPUNOV_ITERS = 30;  // models/arima._init_cov
constexpr int REG_R = 8;            // largest r in registers
constexpr int MAX_R = 64;           // largest r the shared-memory path takes
constexpr int ARIMA_R_TOO_LARGE = -1;

__device__ __forceinline__ float clamp_eps(float x) {
  return x < EPS ? EPS : x;
}

// The Adam step's float32 scalars, as the card's twin uses them
// (ops/optim.adam): b1, 1 - b1, b2, 1 - b2, -lr, eps, and the prior's
// 1 / prior_scale^2.
struct AdamScalars {
  float b1, omb1, b2, omb2, neg_lr, eps, prior;
};

struct Sums {
  float ssq, ldet, n, dssq, dldet;
};

// The gradient of the loss in one coordinate u from the filter's sums along
// its direction, a non-finite value zeroed (models/arima._mle_grad)
__device__ __forceinline__ float loss_grad(const Sums& acc, float u,
                                           float prior) {
  const float nn = acc.n < 1.0f ? 1.0f : acc.n;
  const float c = acc.ssq / nn;
  const float gs = c > EPS ? 0.5f * (1.0f / c) : 0.0f;
  const float g = (gs * acc.dssq + 0.5f * acc.dldet) + u * prior;
  return isfinite(g) ? g : 0.0f;
}

// One Adam step of u with its moments (ops/optim.adam on the card); bc the
// step's two bias corrections
__device__ __forceinline__ void adam_step(float& u, float& mu, float& nu,
                                          float g, const float* bc,
                                          const AdamScalars& ad) {
  const float inv1 = 1.0f / bc[0];
  const float inv2 = 1.0f / bc[1];
  mu = ad.b1 * mu + ad.omb1 * g;
  nu = ad.b2 * nu + ad.omb2 * (g * g);
  u = u + (ad.neg_lr * (mu * inv1)) / (sqrtf(nu * inv2) + ad.eps);
}

// ---------------------------------------------------------------- r <= 8

// The model of one (series, direction): T's first column phi and the
// loading rv, and the direction's tangents of both.
template <int R>
struct Model {
  float phi[R], rv[R], dph[R], drv[R];

  // (phi, theta) from memory and a one-hot direction: dir < p is phi_dir,
  // p <= dir < p + q theta_{dir - p}, any other dir none
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

  // Durbin-Levinson (models/arima._pacf_stack) of tanh(u_0..u_{n-1}) into
  // c, and its tangent along u_dir into dc (zero where dir is not in
  // [0, n)); both zero past n.  models/arima._pacf_jacobian's operations.
  static __device__ __forceinline__ void pacf(const float (&u)[R], int n,
                                              int dir, float (&c)[R],
                                              float (&dc)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) c[i] = dc[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (j < n) {
        const float rj = tanhf(u[j]);
        const float drj = j == dir ? (1.0f - rj) * (1.0f + rj) : 0.0f;
        float nc[R], ndc[R];
#pragma unroll
        for (int i = 0; i < j; ++i) {
          nc[i] = c[i] - rj * c[j - 1 - i];
          ndc[i] = dc[i] - (drj * c[j - 1 - i] + rj * dc[j - 1 - i]);
        }
#pragma unroll
        for (int i = 0; i < j; ++i) {
          c[i] = nc[i];
          dc[i] = ndc[i];
        }
        c[j] = rj;
        dc[j] = drj;
      }
    }
  }

  // the model at u (ua = u_0..u_{p-1}, um = u_p..u_{p+q-1}, zero past) along
  // the direction u_dir
  __device__ __forceinline__ void from_u(const float (&ua)[R],
                                         const float (&um)[R], int p, int q,
                                         int dir) {
    float c[R], dc[R];
    pacf(ua, p, dir, c, dc);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      phi[i] = i < p ? c[i] : 0.0f;
      dph[i] = i < p ? dc[i] : 0.0f;
    }
    pacf(um, q, dir - p, c, dc);
    rv[0] = 1.0f;
    drv[0] = 0.0f;
#pragma unroll
    for (int i = 1; i < R; ++i) {
      rv[i] = i - 1 < q ? c[i - 1] : 0.0f;
      drv[i] = i - 1 < q ? dc[i - 1] : 0.0f;
    }
  }

  // (T P T' + R R')_ij from row i of M = T P
  __device__ __forceinline__ float tpt_rr(const float (&Mi)[R], float rvi,
                                          int j) const {
    return (Mi[0] * phi[j] + (j + 1 < R ? Mi[j + 1] : 0.0f)) + rvi * rv[j];
  }

  // its tangent: (dM T' + M dT') + dRR'
  __device__ __forceinline__ float dtpt_rr(const float (&Mi)[R],
                                           const float (&dMi)[R], float rvi,
                                           float drvi, int j) const {
    return ((dMi[0] * phi[j] + (j + 1 < R ? dMi[j + 1] : 0.0f)) +
            Mi[0] * dph[j]) +
           (drvi * rv[j] + rvi * drv[j]);
  }
};

// An r x r matrix of one lane: in registers, or in the lane's column of a
// shared-memory array (entry (i, l) at [(i r + l) 32 + lane]: a warp's
// lanes on consecutive words) where the registers run out.
template <int R, bool SHARED>
struct LaneMatrix;

template <int R>
struct LaneMatrix<R, false> {
  float v[R][R];
  __device__ __forceinline__ void bind(float*, int) {}
  __device__ __forceinline__ float operator()(int i, int l) const {
    return v[i][l];
  }
  __device__ __forceinline__ void set(int i, int l, float x) { v[i][l] = x; }
};

template <int R>
struct LaneMatrix<R, true> {
  float* col;
  __device__ __forceinline__ void bind(float* smem, int lane) {
    col = smem + lane;
  }
  __device__ __forceinline__ float operator()(int i, int l) const {
    return col[(i * R + l) * 32];
  }
  __device__ __forceinline__ void set(int i, int l, float x) {
    col[(i * R + l) * 32] = x;
  }
};

// dP (from r = 7) and P (from r = 8) live in shared memory: in registers,
// P, dP, their row-0 copies, the gains and the model spill past the 255
// registers at r = 7 and 8
constexpr int SHARED_DP_R = 7;
constexpr int SHARED_P_R = 8;

// The lane holds a, P and their tangents whole.  A step goes row by row:
// row i of M = T P needs row 0 (kept aside) and row i + 1 (not yet
// overwritten), so only one row of M and dM is live at a time.
template <int R>
struct Filter {
  static constexpr bool SHARED = R >= SHARED_DP_R;
  float a[R], da[R];
  LaneMatrix<R, (R >= SHARED_P_R)> P;
  LaneMatrix<R, SHARED> dP;

  // row i of M = T P and of dM = T dP + dT P, from row 0 (P0, dP0)
  __device__ __forceinline__ void tp_row(const Model<R>& m, int i,
                                         const float (&P0)[R],
                                         const float (&dP0)[R],
                                         float (&Mi)[R],
                                         float (&dMi)[R]) const {
#pragma unroll
    for (int l = 0; l < R; ++l) {
      Mi[l] = m.phi[i] * P0[l] + (i + 1 < R ? P(i + 1, l) : 0.0f);
      dMi[l] = (m.phi[i] * dP0[l] + (i + 1 < R ? dP(i + 1, l) : 0.0f)) +
               m.dph[i] * P0[l];
    }
  }

  __device__ __forceinline__ void row0(float (&P0)[R], float (&dP0)[R]) const {
#pragma unroll
    for (int l = 0; l < R; ++l) {
      P0[l] = P(0, l);
      dP0[l] = dP(0, l);
    }
  }

  // smem: the block's shared dP array (32 r^2 floats) where SHARED
  __device__ __forceinline__ void init(const Model<R>& m, int lane,
                                       float* smem) {
    dP.bind(smem, lane);
    P.bind(smem + 32 * R * R, lane);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      a[i] = da[i] = 0.0f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        P.set(i, j, m.rv[i] * m.rv[j]);
        dP.set(i, j, m.drv[i] * m.rv[j] + m.rv[i] * m.drv[j]);
      }
    }
    for (int it = 0; it < LYAPUNOV_ITERS; ++it) {
      float P0[R], dP0[R];
      row0(P0, dP0);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float Mi[R], dMi[R];
        tp_row(m, i, P0, dP0, Mi, dMi);
#pragma unroll
        for (int j = 0; j < R; ++j) {
          P.set(i, j, m.tpt_rr(Mi, m.rv[i], j));
          dP.set(i, j, m.dtpt_rr(Mi, dMi, m.rv[i], m.drv[i], j));
        }
      }
    }
  }

  __device__ __forceinline__ void step(const Model<R>& m, float zt, float mt,
                                       Sums& acc) {
    const float pred = a[0];
    const float F = clamp_eps(P(0, 0));
    const float v = zt - pred;
    const float dF = P(0, 0) > EPS ? dP(0, 0) : 0.0f;
    const float dv = -da[0];
    const float rF = 1.0f / F;
    float P0[R], dP0[R];
    row0(P0, dP0);
    // the gains, from column 0 of M and dM
    float K[R], dK[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float M0 = m.phi[i] * P0[0] + (i + 1 < R ? P(i + 1, 0) : 0.0f);
      const float dM0 =
          (m.phi[i] * dP0[0] + (i + 1 < R ? dP(i + 1, 0) : 0.0f)) +
          m.dph[i] * P0[0];
      K[i] = M0 / F;
      dK[i] = (dM0 - K[i] * dF) * rF;
    }
    const bool obs = mt > 0.0f;
    // a <- T a (+ K v), da <- dT a + T da (+ dK v + K dv)
    const float a0 = a[0], da0 = da[0];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float ta = m.phi[i] * a0 + (i + 1 < R ? a[i + 1] : 0.0f);
      const float dta = (m.phi[i] * da0 + (i + 1 < R ? da[i + 1] : 0.0f)) +
                        m.dph[i] * a0;
      a[i] = obs ? ta + K[i] * v : ta;
      da[i] = obs ? (dta + dK[i] * v) + K[i] * dv : dta;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float Mi[R], dMi[R];
      tp_row(m, i, P0, dP0, Mi, dMi);
#pragma unroll
      for (int l = 0; l < R; ++l) {
        const float pp = m.tpt_rr(Mi, m.rv[i], l);
        const float dpp = m.dtpt_rr(Mi, dMi, m.rv[i], m.drv[i], l);
        P.set(i, l, obs ? pp - (K[i] * K[l]) * F : pp);
        dP.set(i, l,
               obs ? dpp - ((dK[i] * K[l] + K[i] * dK[l]) * F +
                            (K[i] * K[l]) * dF)
                   : dpp);
      }
    }
    const float w = v * v / F;
    acc.ssq = acc.ssq + (obs ? w : 0.0f);
    acc.ldet = acc.ldet + (obs ? logf(F) : 0.0f);
    acc.n = acc.n + mt;
    acc.dssq = acc.dssq + (obs ? (2.0f * v * dv - w * dF) * rF : 0.0f);
    acc.dldet = acc.dldet + (obs ? dF * rF : 0.0f);
  }
};

// Warp-cooperative staging of (rows x CH)-step tiles, as in
// csrc/arima_kalman.cu: lane j moves step t0 + j of a row.
constexpr int CH = 32;
constexpr int TS = CH + 1;
constexpr int ROWS = 32;  // series a block holds at most
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

// The lanes of a block (one warp) on the register path: kk = max(p + q, 1)
// lanes a series, 32 / kk series a block (the rest of the warp idle); a
// lane outside every series computes on the block's first series and writes
// nothing.
struct Layout {
  int lane, row, dir, s0, rows;
  bool live;

  __device__ __forceinline__ Layout(int S, int kk) {
    lane = threadIdx.x;
    const int spb = 32 / kk;
    s0 = blockIdx.x * spb;
    rows = min(spb, S - s0);
    const int slot = lane / kk;
    live = slot < rows;
    row = live ? slot : 0;
    dir = live ? lane - slot * kk : 0;
  }
};

// The shared memory of a register-path block: the double-buffered zc and
// zmask tiles, the fit's u and Adam moments of each lane (kept here, not in
// registers, across the time loop), and (r >= SHARED_DP_R) the lanes' dP
// (and at r >= SHARED_P_R their P).
template <int R>
struct BlockSmem {
  static constexpr bool SHARED_DP = R >= SHARED_DP_R;
  float tiles[4 * TILE];
  float u[32], mu[32], nu[32];
  float dP[SHARED_DP ? 32 * R * R * (R >= SHARED_P_R ? 2 : 1) : 1];
};

// Buffer `which` (0 zc, 1 zmask) of chunk c's tile
template <int R>
__device__ __forceinline__ float* tile(BlockSmem<R>& sm, int c, int which) {
  return sm.tiles + ((c & 1) * 2 + which) * TILE;
}

// Start the copies of chunk c (if any) into its tile, and commit them as a
// group: lane j moves step t0 + j of each of the block's series.
template <int R>
__device__ __forceinline__ void stage_chunk(BlockSmem<R>& sm, const Layout& L,
                                            const float* __restrict__ zc,
                                            const float* __restrict__ zmask,
                                            int T, int c, int chunks) {
  if (c < chunks) {
    const int t0 = c * CH, n = min(CH, T - t0);
    if (L.lane < n)
      for (int i = 0; i < L.rows; ++i) {
        const size_t src = static_cast<size_t>(L.s0 + i) * T + t0 + L.lane;
        cp_async4(tile(sm, c, 0) + i * TS + L.lane, zc + src);
        cp_async4(tile(sm, c, 1) + i * TS + L.lane, zmask + src);
      }
  }
  cp_async_commit();
}

// One pass of the filter and its tangent over this lane's series, its time
// steps staged through the block's tiles.
template <int R>
__device__ __forceinline__ Sums filter_pass(const Model<R>& m, const Layout& L,
                                            BlockSmem<R>& sm,
                                            const float* __restrict__ zc,
                                            const float* __restrict__ zmask,
                                            int T) {
  // two time steps unrolled where the registers allow: past r = 5 the
  // second copy's temporaries spill
  constexpr int UNROLL = R > 5 ? 1 : 2;
  const int chunks = (T + CH - 1) / CH;
  Filter<R> f;
  f.init(m, L.lane, sm.dP);
  Sums acc{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  stage_chunk(sm, L, zc, zmask, T, 0, chunks);
  for (int c = 0; c < chunks; ++c) {
    stage_chunk(sm, L, zc, zmask, T, c + 1, chunks);
    cp_async_wait_prior();
    __syncthreads();
    const int n = min(CH, T - c * CH);
    const float* zr = tile(sm, c, 0) + L.row * TS;
    const float* mr = tile(sm, c, 1) + L.row * TS;
#pragma unroll UNROLL
    for (int j = 0; j < n; ++j) f.step(m, zr[j], mr[j], acc);
    __syncthreads();  // the next stage overwrites this chunk's buffer
  }
  return acc;
}

// Both entry points on the register path.  FIT: `steps` Adam steps from
// u = 0, writing u (S, p + q); else one evaluation at (phi, theta) with
// one-hot directions: the lanes of direction 0 write ssq, ldet and n,
// direction dir < p + q column dir of dssq and dldet.
template <int R, bool FIT>
__device__ __forceinline__ void mle_body(
    const float* __restrict__ zc, const float* __restrict__ zmask,
    const float* __restrict__ phi_in, const float* __restrict__ theta_in,
    const float* __restrict__ bc, float* __restrict__ ssq_out,
    float* __restrict__ ldet_out, float* __restrict__ n_out,
    float* __restrict__ dssq_out, float* __restrict__ dldet_out,
    float* __restrict__ u_out, int S, int T, int p, int q, int steps,
    const AdamScalars& ad) {
  __shared__ BlockSmem<R> sm;
  const int k = p + q, kk = k > 0 ? k : 1;
  const Layout L(S, kk);
  const int s = L.s0 + L.row;

  if constexpr (FIT) {
    // a live lane's u, mu and nu at sm.u[lane], sm.mu[lane], sm.nu[lane]
    const int g = L.live ? L.lane : 0;
    if (L.live) sm.u[g] = sm.mu[g] = sm.nu[g] = 0.0f;
    for (int it = 0; it < steps; ++it) {
      __syncthreads();
      float ua[R], um[R];
      const float* us = sm.u + L.row * kk;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        ua[i] = i < p ? us[i] : 0.0f;
        um[i] = i < q ? us[p + i] : 0.0f;
      }
      Model<R> m;
      m.from_u(ua, um, p, q, L.dir);
      const Sums acc = filter_pass(m, L, sm, zc, zmask, T);
      float u = sm.u[g], mu = sm.mu[g], nu = sm.nu[g];
      adam_step(u, mu, nu, loss_grad(acc, u, ad.prior), bc + 2 * it, ad);
      __syncthreads();  // every lane of the series has read the old values
      if (L.live) {
        sm.u[g] = u;
        sm.mu[g] = mu;
        sm.nu[g] = nu;
      }
    }
    __syncthreads();
    if (L.live) u_out[static_cast<size_t>(s) * k + L.dir] = sm.u[g];
  } else {
    Model<R> m;
    m.load(phi_in, theta_in, s, p, q, L.dir);
    const Sums acc = filter_pass(m, L, sm, zc, zmask, T);
    if (!L.live) return;
    if (L.dir == 0) {
      ssq_out[s] = acc.ssq;
      ldet_out[s] = acc.ldet;
      n_out[s] = acc.n;
    }
    if (L.dir < k) {
      dssq_out[static_cast<size_t>(s) * k + L.dir] = acc.dssq;
      dldet_out[static_cast<size_t>(s) * k + L.dir] = acc.dldet;
    }
  }
}

// No __launch_bounds__: with it ptxas trades registers for occupancy and
// spills a few bytes in several instances; without, none spills (a block
// is one warp of at most 255 registers).
template <int R>
__global__ void arima_loglik_grad_kernel(
    const float* __restrict__ zc, const float* __restrict__ zmask,
    const float* __restrict__ phi_in, const float* __restrict__ theta_in,
    float* __restrict__ ssq_out, float* __restrict__ ldet_out,
    float* __restrict__ n_out, float* __restrict__ dssq_out,
    float* __restrict__ dldet_out, int S, int T, int p, int q) {
  mle_body<R, false>(zc, zmask, phi_in, theta_in, nullptr, ssq_out,
                     ldet_out, n_out, dssq_out, dldet_out, nullptr, S, T, p,
                     q, 0, AdamScalars{});
}

template <int R>
__global__ void arima_mle_fit_kernel(const float* __restrict__ zc,
                                     const float* __restrict__ zmask,
                                     const float* __restrict__ bc,
                                     float* __restrict__ u_out, int S, int T,
                                     int p, int q, int steps, AdamScalars ad) {
  mle_body<R, true>(zc, zmask, nullptr, nullptr, bc, nullptr, nullptr,
                    nullptr, nullptr, nullptr, u_out, S, T, p, q, steps, ad);
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
    for (int i = lane; i < r; i += 32) a[i] = da[i] = 0.0f;
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

  // one pass over series s; every lane returns the same sums
  __device__ Sums pass(const float* __restrict__ zc,
                       const float* __restrict__ zmask, int s, int T,
                       int lane) {
    init_cov(lane);
    Sums acc{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    const size_t row = static_cast<size_t>(s) * T;
    for (int t = 0; t < T; ++t) {
      const float zt = __ldg(zc + row + t);
      const float mt = __ldg(zmask + row + t);
      const float pred = a[0];
      const float F = clamp_eps(P[0]);
      const float v = zt - pred;
      const float dF = P[0] > EPS ? dP[0] : 0.0f;
      const float dv = -da[0];
      const float rF = 1.0f / F;
      const bool obs = mt > 0.0f;
      tp(lane);
      for (int i = lane; i < r; i += 32) {
        const float kk = M[i * r] / F;
        const float dk = (dM[i * r] - kk * dF) * rF;
        K[i] = kk;
        dK[i] = dk;
        a[i] = obs ? ta[i] + kk * v : ta[i];
        da[i] = obs ? (dta[i] + dk * v) + kk * dv : dta[i];
      }
      __syncwarp();
      for (int idx = lane; idx < r * r; idx += 32) {
        const int i = idx / r, j = idx - i * r;
        const float pp = tpt_rr(i, j);
        const float dpp = dtpt_rr(i, j);
        P[idx] = obs ? pp - (K[i] * K[j]) * F : pp;
        dP[idx] = obs ? dpp - ((dK[i] * K[j] + K[i] * dK[j]) * F +
                               (K[i] * K[j]) * dF)
                      : dpp;
      }
      __syncwarp();
      const float w = v * v / F;
      acc.ssq = acc.ssq + (obs ? w : 0.0f);
      acc.ldet = acc.ldet + (obs ? logf(F) : 0.0f);
      acc.n = acc.n + mt;
      acc.dssq = acc.dssq + (obs ? (2.0f * v * dv - w * dF) * rF : 0.0f);
      acc.dldet = acc.dldet + (obs ? dF * rF : 0.0f);
    }
    return acc;
  }
};

// Durbin-Levinson of tanh(u_0..u_{n-1}) (n <= 64) into c and its tangent
// along u_dir into dc, in shared memory, lanes over the coefficients: the
// operations of Model::pacf.
__device__ void pacf_warp(const float* u, int n, int dir, float* c, float* dc,
                          int lane) {
  for (int j = 0; j < n; ++j) {
    const float rj = tanhf(u[j]);
    const float drj = j == dir ? (1.0f - rj) * (1.0f + rj) : 0.0f;
    float nc[2], ndc[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = lane + 32 * e;
      if (i < j) {
        nc[e] = c[i] - rj * c[j - 1 - i];
        ndc[e] = dc[i] - (drj * c[j - 1 - i] + rj * dc[j - 1 - i]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = lane + 32 * e;
      if (i < j) {
        c[i] = nc[e];
        dc[i] = ndc[e];
      }
    }
    if (lane == 0) {
      c[j] = rj;
      dc[j] = drj;
    }
    __syncwarp();
  }
}

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
  const Sums acc = mdl.pass(zc, zmask, s, T, lane);
  // every lane carries the same sums; lane 0 writes them
  if (lane != 0) return;
  if (dir == 0) {
    ssq_out[s] = acc.ssq;
    ldet_out[s] = acc.ldet;
    n_out[s] = acc.n;
  }
  if (dir < k) {
    dssq_out[static_cast<size_t>(s) * k + dir] = acc.dssq;
    dldet_out[static_cast<size_t>(s) * k + dir] = acc.dldet;
  }
}

// Shared memory of the fit's warp path beyond warp_smem_floats(r): u, its
// moments and gradient (k each), the map's c and dc (r each).
__host__ __device__ constexpr int fit_warp_smem_floats(int r, int k) {
  return warp_smem_floats(r) + 4 * k + 2 * r;
}

// The fit on the shared-memory path: one warp a series, its directions one
// after another each step.
__global__ void __launch_bounds__(32)
    arima_mle_fit_kernel_warp(const float* __restrict__ zc,
                              const float* __restrict__ zmask,
                              const float* __restrict__ bc,
                              float* __restrict__ u_out, int S, int T, int p,
                              int q, int r, int steps, AdamScalars ad) {
  extern __shared__ float smem[];
  const int s = blockIdx.x;
  const int k = p + q;
  const int lane = threadIdx.x;
  WarpTangent mdl(smem, r);
  float* su = smem + warp_smem_floats(r);
  float* smu = su + k;
  float* snu = smu + k;
  float* sg = snu + k;
  float* sc = sg + k;
  float* sdc = sc + r;
  for (int j = lane; j < k; j += 32) su[j] = smu[j] = snu[j] = 0.0f;
  __syncwarp();
  for (int it = 0; it < steps; ++it) {
    for (int dir = 0; dir < k; ++dir) {
      pacf_warp(su, p, dir, sc, sdc, lane);
      for (int i = lane; i < r; i += 32) {
        mdl.phi[i] = i < p ? sc[i] : 0.0f;
        mdl.dph[i] = i < p ? sdc[i] : 0.0f;
      }
      __syncwarp();
      pacf_warp(su + p, q, dir - p, sc, sdc, lane);
      for (int i = lane; i < r; i += 32) {
        mdl.rv[i] = i == 0 ? 1.0f : (i - 1 < q ? sc[i - 1] : 0.0f);
        mdl.drv[i] = i == 0 ? 0.0f : (i - 1 < q ? sdc[i - 1] : 0.0f);
      }
      __syncwarp();
      const Sums acc = mdl.pass(zc, zmask, s, T, lane);
      if (lane == 0) sg[dir] = loss_grad(acc, su[dir], ad.prior);
      __syncwarp();
    }
    for (int j = lane; j < k; j += 32)
      adam_step(su[j], smu[j], snu[j], sg[j], bc + 2 * it, ad);
    __syncwarp();
  }
  for (int j = lane; j < k; j += 32)
    u_out[static_cast<size_t>(s) * k + j] = su[j];
}

// ------------------------------------------------------------- launchers

template <int R, bool FIT>
cudaError_t launch_reg(const float* zc, const float* zmask, const float* phi,
                       const float* theta, const float* bc, float* ssq,
                       float* ldet, float* n, float* dssq, float* dldet,
                       float* u, int S, int T, int p, int q, int steps,
                       const AdamScalars& ad, cudaStream_t st) {
  const int spb = 32 / (p + q > 0 ? p + q : 1);
  const int blocks = (S + spb - 1) / spb;
  if constexpr (FIT)
    arima_mle_fit_kernel<R><<<blocks, 32, 0, st>>>(zc, zmask, bc, u, S, T, p,
                                                   q, steps, ad);
  else
    arima_loglik_grad_kernel<R><<<blocks, 32, 0, st>>>(
        zc, zmask, phi, theta, ssq, ldet, n, dssq, dldet, S, T, p, q);
  return cudaGetLastError();
}

template <bool FIT>
int dispatch_reg(int r, const float* zc, const float* zmask, const float* phi,
                 const float* theta, const float* bc, float* ssq, float* ldet,
                 float* n, float* dssq, float* dldet, float* u, int S, int T,
                 int p, int q, int steps, const AdamScalars& ad,
                 cudaStream_t st) {
#define ARIMA_MLE_REG(R)                                                    \
  case R:                                                                   \
    return static_cast<int>(launch_reg<R, FIT>(zc, zmask, phi, theta, bc,   \
                                               ssq, ldet, n, dssq, dldet, u, \
                                               S, T, p, q, steps, ad, st));
  switch (r) {
    ARIMA_MLE_REG(1)
    ARIMA_MLE_REG(2)
    ARIMA_MLE_REG(3)
    ARIMA_MLE_REG(4)
    ARIMA_MLE_REG(5)
    ARIMA_MLE_REG(6)
    ARIMA_MLE_REG(7)
    ARIMA_MLE_REG(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ARIMA_MLE_REG
}

template <typename Kernel>
int set_smem(Kernel* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

}  // namespace

// The C launchers read through ctypes (ops/_build.py): each launches on
// `stream` and returns cudaGetLastError() of the launch (0 on success) or
// ARIMA_R_TOO_LARGE for an r beyond MAX_R.  The wrappers (ops/kalman.
// arima_loglik_grad, arima_mle_fit) check shapes, types and contiguity
// first.

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
  const AdamScalars none{};
  if (r <= REG_R)
    return dispatch_reg<false>(r, zc, zmask, phi, theta, nullptr, ssq, ldet,
                               n, dssq, dldet, nullptr, S, T, p, q, 0, none,
                               st);
  const size_t smem = warp_smem_floats(r) * sizeof(float);
  const int err = set_smem(arima_loglik_grad_kernel_warp, smem);
  if (err) return err;
  const dim3 grid(S, p + q > 0 ? p + q : 1);
  arima_loglik_grad_kernel_warp<<<grid, 32, smem, st>>>(
      zc, zmask, phi, theta, ssq, ldet, n, dssq, dldet, S, T, p, q, r);
  return static_cast<int>(cudaGetLastError());
}

// u (S, p + q) after `steps` Adam steps from 0; bc (steps, 2) the bias
// corrections of steps 1..steps.  p + q >= 1 and steps >= 1.
extern "C" int arima_mle_fit_launch(const float* zc, const float* zmask,
                                    const float* bc, float* u, int S, int T,
                                    int p, int q, int r, int steps, float b1, float omb1, float b2,
                                    float omb2, float neg_lr, float eps,
                                    float prior, void* stream) {
  if (S <= 0 || r < 1 || p > r || q >= r || p + q < 1 || steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (r > MAX_R) return ARIMA_R_TOO_LARGE;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AdamScalars ad{b1, omb1, b2, omb2, neg_lr, eps, prior};
  if (r <= REG_R)
    return dispatch_reg<true>(r, zc, zmask, nullptr, nullptr, bc, nullptr,
                              nullptr, nullptr, nullptr, nullptr, u, S, T, p,
                              q, steps, ad, st);
  const size_t smem = fit_warp_smem_floats(r, p + q) * sizeof(float);
  const int err = set_smem(arima_mle_fit_kernel_warp, smem);
  if (err) return err;
  arima_mle_fit_kernel_warp<<<S, 32, smem, st>>>(zc, zmask, bc, u, S, T, p, q,
                                                 r, steps, ad);
  return static_cast<int>(cudaGetLastError());
}

static const char* mle_error_string(int err) {
  if (err == ARIMA_R_TOO_LARGE)
    return "the state dimension r = max(p, q + 1) exceeds the kernel's "
           "limit of 64";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* arima_loglik_grad_error_string(int err) {
  return mle_error_string(err);
}

extern "C" const char* arima_mle_fit_error_string(int err) {
  return mle_error_string(err);
}
