// Holt-Winters winner refit on Hopper (sm_90a).
//
// Replaces the reference's per-series lax.scan filter
// (distributed_forecasting_tpu/models/holt_winters.py::_filter, vmapped over
// the winners in fit), which has no Pallas kernel: XLA compiles it into one
// loop on the device.  The port's plain twin is models/holt_winters._filter
// with one candidate per row.  For every row it runs the Holt-Winters filter
// (additive or multiplicative seasonality, damped trend) over the whole
// history, trailing masked steps included (forecast reads the fitted path and
// the final state at the end of the grid), and writes the final level, trend
// and season, the masked MSE and the (S, T) one-step-ahead fitted path.
//
// Contract: bitwise equal to the twin on the card.  The refit's state is what
// forecasting and serving read, and the reference pins it to one step body.
// So the arithmetic is the twin's (holt_winters._hw_step), term for term and
// in its order: no contraction (the library is built with --fmad=false), IEEE
// division, the multiplicative clamp written as `x < eps ? eps : x` so that a
// NaN passes through as torch.clamp_min lets it, (1 - alpha) rounded on its
// own, and both branches computed and selected per step as torch.where does.
//
// Design (warp-specialised: the chain never waits on memory):
//   - one thread per row; level, trend, sse and n in registers.  A block is
//     32 rows and four warps: warp 0, the consumer, runs the 32 rows'
//     recursion; warps 1-3, the producers, do all the memory traffic;
//   - season length 7 is a template instance with the time loop unrolled by
//     7: the seasonal states live in registers under static slot indices.
//     Any other m keeps them in shared memory, season[slot * 32 + lane];
//   - time goes in chunks of 63-64 steps through [32][65] shared-memory
//     tiles: a ring of four for y and mask, two for the fitted path.  While
//     the consumer runs chunk c, the producers copy chunk c + 3 of y and
//     mask in (coalesced 4-byte cp.async, a warp to a row; three chunks in
//     flight hide the memory latency, which is longer than one chunk's
//     compute) and write chunk c - 1 of the path out (coalesced stores);
//     one block barrier per chunk.  The consumer reads its own tile row
//     (odd row stride: no bank conflicts).
//
// Bound on an H100 SXM at the fit shape (S 500, T 1,826): bytes, y and mask
// read and the path written, 4 * 3 * S * T = 11 MB -> 3.3 us; operations,
// 20 per step, 18 MFLOP -> 0.3 us.  What really bounds it is the serial
// chain: each step's trend depends on the previous one through about eight
// dependent operations (~30 cycles), so T * 30 cycles at 1.98 GHz is ~28 us
// whatever the width, and 500 rows are only 16 warps.  Only a parallel-prefix
// form of the filter could go below that chain.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int ROWS = 32;       // rows per block: the consumer warp
constexpr int PRODUCERS = 96;  // three producer warps
constexpr int THREADS = ROWS + PRODUCERS;
constexpr int STRIDE = 65;     // floats per tile row: odd, >= any chunk
constexpr int TILE = ROWS * STRIDE;
constexpr int RING = 4;        // y and mask tiles in flight: chunk c in c % 4
constexpr int AHEAD = RING - 1;  // chunks staged ahead of the consumer
// y[RING], mask[RING], path[2]: chunk c's path tile is c % 2
constexpr int TILE_FLOATS = (2 * RING + 2) * TILE;
constexpr float EPS = 1e-6f;           // holt_winters._EPS
// the launcher's status when a season does not fit shared memory (CUDA's
// own error codes are never negative)
constexpr int HW_SEASON_TOO_LONG = -1;

template <int M>
struct Chunk {
  static constexpr int value = M > 0 ? (64 / M) * M : 64;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Barrier 1 over the whole block, reached by the consumer and the producers
// from their own code (each warp takes one side).
__device__ __forceinline__ void block_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

__device__ __forceinline__ float clamp_eps(float x) {
  return x < EPS ? EPS : x;
}

// Producer q (0 .. PRODUCERS - 1): copy n steps from t0 of the block's rows
// into the y and mask tiles; producer warp w takes rows w, w + 3, ...
__device__ __forceinline__ void stage(const float* __restrict__ y,
                                      const float* __restrict__ mask,
                                      int rows, int T, int row0, int t0,
                                      int n, float* ty, float* tm, int q) {
  const int lane = q & 31;
  for (int i = q >> 5; i < rows; i += PRODUCERS / 32) {
    const size_t base = static_cast<size_t>(row0 + i) * T + t0;
    for (int j = lane; j < n; j += 32) {
      cp_async4(ty + i * STRIDE + j, y + base + j);
      cp_async4(tm + i * STRIDE + j, mask + base + j);
    }
  }
}

// Producer q: write n steps of the path tile out to fitted, from t0.
__device__ __forceinline__ void write_out(float* __restrict__ fitted,
                                          const float* tp, int rows, int T,
                                          int row0, int t0, int n, int q) {
  const int lane = q & 31;
  for (int i = q >> 5; i < rows; i += PRODUCERS / 32) {
    float* dst = fitted + static_cast<size_t>(row0 + i) * T + t0;
    for (int j = lane; j < n; j += 32) dst[j] = tp[i * STRIDE + j];
  }
}

// One step of holt_winters._hw_step for one row; returns pred.
template <bool MULT>
__device__ __forceinline__ float step(float yt, float mt, float a,
                                      float one_a, float be, float one_be,
                                      float g, float one_g, float p, float& l,
                                      float& b, float& s, float& sse,
                                      float& n) {
  const float si = s;
  const float pb = p * b;
  const float lp = l + pb;
  float pred, l_obs, s_obs;
  if (MULT) {
    pred = lp * si;
    l_obs = a * yt / clamp_eps(si) + one_a * lp;
    s_obs = g * yt / clamp_eps(l_obs) + one_g * si;
  } else {
    pred = lp + si;
    l_obs = a * (yt - si) + one_a * lp;
    s_obs = g * (yt - l_obs) + one_g * si;
  }
  const float b_obs = be * (l_obs - l) + one_be * pb;
  const bool obs = mt > 0.0f;
  s = obs ? s_obs : si;
  l = obs ? l_obs : lp;
  b = obs ? b_obs : pb;
  const float err = (yt - pred) * mt;
  sse = sse + err * err;
  n = n + mt;
  return pred;
}

template <int M, bool MULT>
__global__ void __launch_bounds__(THREADS)
    hw_filter_kernel(const float* __restrict__ y,
                     const float* __restrict__ mask,
                     const float* __restrict__ alpha,
                     const float* __restrict__ beta,
                     const float* __restrict__ gamma,
                     const float* __restrict__ phi,
                     const float* __restrict__ l0,
                     const float* __restrict__ b0,
                     const float* __restrict__ s0, float* __restrict__ level,
                     float* __restrict__ trend, float* __restrict__ season,
                     float* __restrict__ mse, float* __restrict__ fitted,
                     int S, int T, int m) {
  constexpr int CH = Chunk<M>::value;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, S - row0);
  const int chunks = (T + CH - 1) / CH;
  // the tiles of chunk c: y, mask (ring of RING) and path (two)
  auto ty = [&](int c) { return smem + (c % RING) * TILE; };
  auto tm = [&](int c) { return smem + (RING + c % RING) * TILE; };
  auto tp = [&](int c) { return smem + (2 * RING + (c & 1)) * TILE; };

  if (tid >= ROWS) {  // producers: every chunk's memory traffic
    const int q = tid - ROWS;
    // one copy group per chunk, AHEAD chunks in flight; a group may be empty
    auto stage_chunk = [&](int c) {
      if (c < chunks)
        stage(y, mask, rows, T, row0, c * CH, min(CH, T - c * CH), ty(c),
              tm(c), q);
      cp_async_commit();
    };
    for (int c = 0; c < AHEAD; ++c) stage_chunk(c);
    cp_async_wait<AHEAD - 1>();  // chunk 0 has landed
    block_barrier();
    for (int c = 0; c < chunks; ++c) {
      stage_chunk(c + AHEAD);  // into the slot chunk c - 1 left
      if (c > 0) write_out(fitted, tp(c - 1), rows, T, row0, (c - 1) * CH, CH, q);
      cp_async_wait<AHEAD - 1>();  // chunk c + 1 has landed
      block_barrier();  // chunk c computed
    }
    if (chunks > 0) {
      const int t0 = (chunks - 1) * CH;
      write_out(fitted, tp(chunks - 1), rows, T, row0, t0, T - t0, q);
    }
    return;
  }

  // the consumer: one row per lane
  const int lane = tid;
  const int r = row0 + lane;
  const bool live = r < S;
  const int rr = live ? r : S - 1;  // dead lanes rerun the last row, store nothing
  float* ss = smem + TILE_FLOATS;   // M == 0: [m][ROWS]

  const float a = alpha[rr], be = beta[rr], g = gamma[rr], p = phi[rr];
  const float one_a = 1.0f - a, one_be = 1.0f - be, one_g = 1.0f - g;
  float l = l0[rr], b = b0[rr];
  float sse = 0.0f, n = 0.0f;
  float s[M > 0 ? M : 1];
  if constexpr (M > 0) {
#pragma unroll
    for (int j = 0; j < M; ++j) s[j] = s0[static_cast<size_t>(rr) * M + j];
  } else {
    for (int j = 0; j < m; ++j)
      ss[j * ROWS + lane] = s0[static_cast<size_t>(rr) * m + j];
  }

  int slot = 0;  // M == 0 only
  block_barrier();  // chunk 0 staged
  for (int c = 0; c < chunks; ++c) {
    const int steps = min(CH, T - c * CH);
    const float* yr = ty(c) + lane * STRIDE;
    const float* mr = tm(c) + lane * STRIDE;
    float* pr = tp(c) + lane * STRIDE;

    if constexpr (M > 0) {
      // chunks start at multiples of M, so the slot of chunk step i + j is j
      int i = 0;
      for (; i + M <= steps; i += M) {
        float yv[M], mv[M];  // the group's inputs first, off the chain
#pragma unroll
        for (int j = 0; j < M; ++j) {
          yv[j] = yr[i + j];
          mv[j] = mr[i + j];
        }
#pragma unroll
        for (int j = 0; j < M; ++j)
          pr[i + j] = step<MULT>(yv[j], mv[j], a, one_a, be, one_be, g, one_g,
                                 p, l, b, s[j], sse, n);
      }
#pragma unroll
      for (int j = 0; j < M; ++j)
        if (i + j < steps)
          pr[i + j] = step<MULT>(yr[i + j], mr[i + j], a, one_a, be, one_be,
                                 g, one_g, p, l, b, s[j], sse, n);
    } else {
      for (int i = 0; i < steps; ++i) {
        float& sk = ss[slot * ROWS + lane];
        pr[i] = step<MULT>(yr[i], mr[i], a, one_a, be, one_be, g, one_g, p,
                           l, b, sk, sse, n);
        if (++slot == m) slot = 0;
      }
    }
    block_barrier();  // chunk c computed
  }

  if (!live) return;
  level[r] = l;
  trend[r] = b;
  mse[r] = sse / fmaxf(n, 1.0f);
  if constexpr (M > 0) {
#pragma unroll
    for (int j = 0; j < M; ++j) season[static_cast<size_t>(r) * M + j] = s[j];
  } else {
    for (int j = 0; j < m; ++j)
      season[static_cast<size_t>(r) * m + j] = ss[j * ROWS + lane];
  }
}

template <int M, bool MULT>
int launch(const float* y, const float* mask, const float* alpha,
           const float* beta, const float* gamma, const float* phi,
           const float* l0, const float* b0, const float* s0, float* level,
           float* trend, float* season, float* mse, float* fitted, int S,
           int T, int m, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hw_filter_kernel<M, MULT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (S + ROWS - 1) / ROWS;
  hw_filter_kernel<M, MULT><<<blocks, THREADS, smem, stream>>>(
      y, mask, alpha, beta, gamma, phi, l0, b0, s0, level, trend, season, mse,
      fitted, S, T, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C launcher read through ctypes (ops/_build.py).  `multiplicative` selects
// the seasonality mode (0 additive, 1 multiplicative).  Launches on `stream`
// and returns cudaGetLastError() of the launch (0 on success), or
// HW_SEASON_TOO_LONG when the tiles and a shared-memory season do not fit
// the device's shared memory; the wrapper (ops/fused_scan._hw_filter_cuda)
// checks shapes, types and contiguity first.
extern "C" int hw_filter_launch(const float* y, const float* mask,
                                const float* alpha, const float* beta,
                                const float* gamma, const float* phi,
                                const float* l0, const float* b0,
                                const float* s0, float* level, float* trend,
                                float* season, float* mse, float* fitted,
                                int S, int T, int m, int multiplicative,
                                void* stream) {
  if (S <= 0 || m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  size_t smem = TILE_FLOATS * sizeof(float);
  if (m != 7) {
    int dev = 0, limit = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (smem + static_cast<size_t>(m) * ROWS * sizeof(float) >
        static_cast<size_t>(limit))
      return HW_SEASON_TOO_LONG;
  }
  if (m == 7)
    return multiplicative
               ? launch<7, true>(y, mask, alpha, beta, gamma, phi, l0, b0, s0,
                                 level, trend, season, mse, fitted, S, T, m,
                                 smem, st)
               : launch<7, false>(y, mask, alpha, beta, gamma, phi, l0, b0,
                                  s0, level, trend, season, mse, fitted, S, T,
                                  m, smem, st);
  smem += static_cast<size_t>(m) * ROWS * sizeof(float);
  return multiplicative
             ? launch<0, true>(y, mask, alpha, beta, gamma, phi, l0, b0, s0,
                               level, trend, season, mse, fitted, S, T, m,
                               smem, st)
             : launch<0, false>(y, mask, alpha, beta, gamma, phi, l0, b0, s0,
                                level, trend, season, mse, fitted, S, T, m,
                                smem, st);
}

extern "C" const char* hw_filter_error_string(int err) {
  if (err == HW_SEASON_TOO_LONG)
    return "the season does not fit in one block's shared memory";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
