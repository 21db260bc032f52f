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
// Design (warp-specialised: the consumer warp issues only the recursion and
// touches shared memory between blocks of steps, never inside one):
//   - one thread per row; level, trend, the season and the error sums in
//     registers.  A block is 32 rows: warp 0, the consumer, runs the 32
//     rows' recursion; the producers do all the global memory traffic:
//     three warps for the shared-memory season; at m 7 fifteen while the
//     grid fits one wave of such blocks (512 threads of ~117 registers
//     take an SM's register file: one block an SM), else seven, so that
//     two blocks share an SM (as shared memory allows) and a fleet runs in
//     half the waves.  The launcher reads the wave from the device;
//   - season length 7 is a template instance with the seasonal states in
//     registers under static slot indices.  It walks time in blocks of 28
//     steps (4 groups of 7, 7 vectors of 4): a block's y and mask come out
//     of shared memory as 16-byte vectors as the block before it ends, its
//     28 preds stay in registers and leave as 7 vector stores as it ends.
//     Any other m keeps the season in shared memory, season[slot * 32 +
//     lane], and moves one step at a time, each step loading the next
//     step's inputs and season slot (for m = 1 the state stays in a
//     register);
//   - time goes in chunks (56 steps at m 7, 64 otherwise) through shared
//     tiles: a ring of four for y and mask, two for the fitted path.  While
//     the consumer runs chunk c, the producers copy chunk c + 3 in
//     (coalesced 4-byte cp.async, a warp to a row; chunks c + 1 and c + 2
//     have landed, so the consumer loads chunk c + 1's first block before
//     the barrier that ends chunk c) and write chunk c - 1's path out
//     (coalesced stores); one block barrier per chunk;
//   - why fifteen producers: the consumer's step loop runs slower the
//     longer the producers stay busy in a chunk, though it never waits for
//     them (its barrier waits are ~0.2 cycles a step); fifteen warps finish
//     a chunk's copies sooner than seven, seven sooner than three.  Forming
//     the error sums on a producer warp made the consumer slower, and
//     cutting the trend's chain did not speed the loop much: it is bound by
//     its issue, not by its chain (PERF.md has the measurements);
//   - the launcher grants the instance the device's opt-in shared memory
//     once per (instance, device), not on every launch.
//
// Bound on an H100 SXM at the fit shape (S 500, T 1,826, m 7, additive):
// bytes, y and mask read and the path written, 4 * 3 * S * T = 11 MB ->
// 3.3 us; operations, 20 a step, 18 MFLOP -> 0.3 us.  The serial chain, read
// from the SASS (scripts/cuda_kernel_report.py --chain): 7 dependent
// instructions a step from b to the next b, 28 cycles at 4 each, so T * 28
// cycles at 1.98 GHz is 25.8 us for each wave of blocks (one wave up to
// 32 rows an SM, 4,224 rows on 132 SMs; past that, 64 rows an SM a wave).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py
// --kernel-times): 49.3 cycles a step by the slope over T, 0.0491 ms, 53%
// of that chain bound (the first design, three producers and the sums
// inline: 67.7 cycles, 0.0671 ms).  Past one wave, seven producers: 0.0657
// ms at 4,225 rows and 0.210 ms at 20,480 (fifteen: 0.091, 0.246; three:
// 0.094, 0.276; the first design: 0.082, 0.242).
// Only a parallel-prefix form could go below the chain, and the bitwise
// contract pins the step body.
//
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

namespace {

constexpr int ROWS = 32;       // rows per block: the consumer warp
// Producer threads: at m 7 WIDE while the grid fits one wave, else NARROW;
// SMEM for the shared-memory season (its consumer touches shared memory
// every step, and more producers' copies beside it slowed it)
constexpr int WIDE = 480;
constexpr int NARROW = 224;
constexpr int SMEM = 96;
constexpr int AHEAD = 3;       // chunks staged ahead of the consumer
constexpr float EPS = 1e-6f;           // holt_winters._EPS
// the launcher's status when a season does not fit shared memory (CUDA's
// own error codes are never negative)
constexpr int HW_SEASON_TOO_LONG = -1;
constexpr int MAX_DEVICES = 64;  // devices whose launch settings are cached

// The tile geometry of an instance.  The register-season instance (M > 0)
// moves its inputs and its path in 16-byte vectors of 4 steps, in blocks of
// 4 M steps (whole groups of M and whole vectors), two blocks a chunk; a
// tile row is 68 floats (16-byte aligned, and 68 = 4 mod 32, so the 8 lanes
// of a vector access's phase hit distinct banks).  The shared-memory-season
// instance (M == 0) moves one step at a time in chunks of 64; a row is 65
// floats (odd: lanes reading their own rows hit distinct banks).  RING y
// and mask tiles: chunk c in slot c % RING.
template <int M>
struct Layout {
  static constexpr int BLOCK = M > 0 ? 4 * M : 1;
  static constexpr int CH = M > 0 ? 8 * M : 64;
  static constexpr int STRIDE = M > 0 ? 68 : 65;
  static constexpr int TILE = ROWS * STRIDE;
  static constexpr int RING = AHEAD + 1;
  // y[RING], mask[RING], path[2]: chunk c's path tile is c % 2
  static constexpr int FLOATS = (2 * RING + 2) * TILE;
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
template <int THREADS>
__device__ __forceinline__ void block_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

__device__ __forceinline__ float clamp_eps(float x) {
  return x < EPS ? EPS : x;
}

// Working producer warp w of nw, lane `lane`: copy n steps from t0 of the
// block's rows into the y and mask tiles; warp w takes rows w, w + nw, ...
template <int STRIDE>
__device__ __forceinline__ void stage(const float* __restrict__ y,
                                      const float* __restrict__ mask,
                                      int rows, int T, int row0, int t0,
                                      int n, float* ty, float* tm, int w,
                                      int nw, int lane) {
  for (int i = w; i < rows; i += nw) {
    const size_t base = static_cast<size_t>(row0 + i) * T + t0;
    for (int j = lane; j < n; j += 32) {
      cp_async4(ty + i * STRIDE + j, y + base + j);
      cp_async4(tm + i * STRIDE + j, mask + base + j);
    }
  }
}

// Working producer warp w of nw: write n steps of the path tile out to
// fitted, from t0.
template <int STRIDE>
__device__ __forceinline__ void write_out(float* __restrict__ fitted,
                                          const float* tp, int rows, int T,
                                          int row0, int t0, int n, int w,
                                          int nw, int lane) {
  for (int i = w; i < rows; i += nw) {
    float* dst = fitted + static_cast<size_t>(row0 + i) * T + t0;
    for (int j = lane; j < n; j += 32) dst[j] = tp[i * STRIDE + j];
  }
}

// A row's parameters and the (1 - x) terms, rounded once.
struct Params {
  float a, one_a, be, one_be, g, one_g, p;
};

// One step of holt_winters._hw_step for one row, and its error terms:
// err = (y - pred) * mask, sse += err * err, n += mask, in t order as the
// twin forms them; returns pred.
template <bool MULT>
__device__ __forceinline__ float step(float yt, float mt, const Params& k,
                                      float& l, float& b, float& s,
                                      float& sse, float& cnt) {
  const float si = s;
  const float pb = k.p * b;
  const float lp = l + pb;
  float pred, l_obs, s_obs;
  if (MULT) {
    pred = lp * si;
    l_obs = k.a * yt / clamp_eps(si) + k.one_a * lp;
    s_obs = k.g * yt / clamp_eps(l_obs) + k.one_g * si;
  } else {
    pred = lp + si;
    l_obs = k.a * (yt - si) + k.one_a * lp;
    s_obs = k.g * (yt - l_obs) + k.one_g * si;
  }
  const float b_obs = k.be * (l_obs - l) + k.one_be * pb;
  const bool obs = mt > 0.0f;
  s = obs ? s_obs : si;
  l = obs ? l_obs : lp;
  b = obs ? b_obs : pb;
  const float err = (yt - pred) * mt;
  sse = sse + err * err;
  cnt = cnt + mt;
  return pred;
}

// The register-season instance's state: level, trend, the M seasonal
// states under static slot indices, and the error sums.
template <int M>
struct State {
  float l, b, s[M], sse, cnt;
};

// 4 steps of one row, moved as one 16-byte shared-memory access
struct alignas(16) Vec {
  float v[4];
};

template <int M>
__device__ __forceinline__ void load_block(Vec (&yv)[M], Vec (&mv)[M],
                                           const float* yr, const float* mr) {
#pragma unroll
  for (int v = 0; v < M; ++v) {
    yv[v] = reinterpret_cast<const Vec*>(yr)[v];
    mv[v] = reinterpret_cast<const Vec*>(mr)[v];
  }
}

// 4 M steps from a multiple of M (step 4 v + e in slot (4 v + e) % M) out
// of registers, the preds kept in registers and stored as M vectors at the
// end.
template <int M, bool MULT>
__device__ __forceinline__ void run_block(const Vec (&yv)[M],
                                          const Vec (&mv)[M], float* pr,
                                          const Params& k, State<M>& st) {
  Vec pv[M];
#pragma unroll
  for (int v = 0; v < M; ++v)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pv[v].v[e] = step<MULT>(yv[v].v[e], mv[v].v[e], k, st.l, st.b,
                              st.s[(4 * v + e) % M], st.sse, st.cnt);
#pragma unroll
  for (int v = 0; v < M; ++v) reinterpret_cast<Vec*>(pr)[v] = pv[v];
}

// The last chunk's steps past its whole blocks (fewer than 4 M, from a
// multiple of M), one at a time.
template <int M, bool MULT>
__device__ __forceinline__ void run_tail(const float* yr, const float* mr,
                                         float* pr, int n, const Params& k,
                                         State<M>& st) {
  for (int i = 0; i < n; i += M) {
#pragma unroll
    for (int j = 0; j < M; ++j)
      if (i + j < n)
        pr[i + j] = step<MULT>(yr[i + j], mr[i + j], k, st.l, st.b,
                               st.s[j], st.sse, st.cnt);
  }
}

// One chunk of the shared-memory season, season[slot * ROWS + lane]: each
// step loads the next step's inputs and, for m >= 2, its season slot (last
// written m - 1 >= 1 steps before), so neither load's latency is on the
// chain; for m = 1 (ONE) the next step's season is this step's.
template <bool MULT, bool ONE>
__device__ __forceinline__ void run_chunk_smem(const float* yr,
                                               const float* mr, float* pr,
                                               int steps, const Params& k,
                                               float* ss, int lane, int m,
                                               int& slot, float& s_cur,
                                               float& l, float& b,
                                               float& sse, float& cnt) {
  float yt = yr[0], mt = mr[0];
  for (int i = 0; i < steps; ++i) {
    const int next = slot + 1 == m ? 0 : slot + 1;
    float yn = yt, mn = mt;
    if (i + 1 < steps) {
      yn = yr[i + 1];
      mn = mr[i + 1];
    }
    const float s_next = ONE ? 0.0f : ss[next * ROWS + lane];
    float sk = s_cur;
    pr[i] = step<MULT>(yt, mt, k, l, b, sk, sse, cnt);
    ss[slot * ROWS + lane] = sk;
    s_cur = ONE ? sk : s_next;
    slot = next;
    yt = yn;
    mt = mn;
  }
}

// what a measurement instance (PROBE) records per block, lane 0 of the
// consumer: start, loop start, loop end (clock64), the cycles spent in the
// chunk barriers, the global timer (ns) at start and loop end, and the SM
// the block ran on
constexpr int PROBE_FIELDS = 7;

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// P: the producer threads (WIDE, NARROW or SMEM)
template <int M, bool MULT, bool PROBE, int P>
__global__ void __launch_bounds__(ROWS + P)
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
                     long long* __restrict__ probe, int S, int T, int m) {
  using L = Layout<M>;
  constexpr int CH = L::CH;
  extern __shared__ __align__(16) float smem[];
  constexpr int THREADS = ROWS + P;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, S - row0);
  const int chunks = (T + CH - 1) / CH;
  // the tiles of chunk c: y and mask (ring of RING), path (two)
  auto ty = [&](int c) { return smem + (c % L::RING) * L::TILE; };
  auto tm = [&](int c) { return smem + (L::RING + c % L::RING) * L::TILE; };
  auto tp = [&](int c) { return smem + (2 * L::RING + (c & 1)) * L::TILE; };

  if (tid >= ROWS) {  // producers: every chunk's memory traffic
    const int q = tid - ROWS, lane = q & 31;
    const int nw = P / 32, w = q >> 5;
    // one copy group per chunk, AHEAD chunks in flight; a group may be empty
    auto stage_chunk = [&](int c) {
      if (c < chunks)
        stage<L::STRIDE>(y, mask, rows, T, row0, c * CH, min(CH, T - c * CH),
                         ty(c), tm(c), w, nw, lane);
      cp_async_commit();
    };
    for (int c = 0; c < AHEAD; ++c) stage_chunk(c);
    // chunks 0 and 1 have landed: the consumer loads chunk c + 1's first
    // block before the barrier that ends chunk c
    cp_async_wait<AHEAD - 2>();
    block_barrier<THREADS>();
    for (int c = 0; c < chunks; ++c) {
      stage_chunk(c + AHEAD);  // into a slot no chunk still in use holds
      if (c > 0)  // chunk c - 1 is whole: CH steps
        write_out<L::STRIDE>(fitted, tp(c - 1), rows, T, row0, (c - 1) * CH,
                             CH, w, nw, lane);
      cp_async_wait<AHEAD - 2>();  // chunk c + 2 has landed
      block_barrier<THREADS>();  // chunk c computed
    }
    if (chunks > 0) {
      const int t0 = (chunks - 1) * CH;
      write_out<L::STRIDE>(fitted, tp(chunks - 1), rows, T, row0, t0, T - t0,
                           w, nw, lane);
    }
    return;
  }

  // the consumer: one row per lane
  const int lane = tid;
  const int r = row0 + lane;
  const bool live = r < S;
  const int rr = live ? r : S - 1;  // dead lanes rerun the last row, store nothing
  float* ss = smem + L::FLOATS;     // M == 0: [m][ROWS]
  auto yrow = [&](int c) { return ty(c) + lane * L::STRIDE; };
  auto mrow = [&](int c) { return tm(c) + lane * L::STRIDE; };
  auto prow = [&](int c) { return tp(c) + lane * L::STRIDE; };

  Params k;
  k.a = alpha[rr];
  k.be = beta[rr];
  k.g = gamma[rr];
  k.p = phi[rr];
  k.one_a = 1.0f - k.a;
  k.one_be = 1.0f - k.be;
  k.one_g = 1.0f - k.g;
  // held in registers: the compiler would otherwise recompute each of them
  // in the step loop
  asm volatile("" : "+f"(k.one_a), "+f"(k.one_be), "+f"(k.one_g));
  State<(M > 0 ? M : 1)> st;
  st.l = l0[rr];
  st.b = b0[rr];
  st.sse = 0.0f;
  st.cnt = 0.0f;
  if constexpr (M > 0) {
#pragma unroll
    for (int j = 0; j < M; ++j) st.s[j] = s0[static_cast<size_t>(rr) * M + j];
  } else {
    for (int j = 0; j < m; ++j)
      ss[j * ROWS + lane] = s0[static_cast<size_t>(rr) * m + j];
    st.s[0] = ss[lane];  // slot 0's state, carried in a register
  }

  long long t_start = 0, ns_start = 0, t_loop = 0, waited = 0;
  if constexpr (PROBE) {
    t_start = clock64();
    ns_start = global_ns();
  }
  int slot = 0;  // M == 0 only
  block_barrier<THREADS>();  // chunks 0 and 1 staged
  if constexpr (PROBE) t_loop = clock64();
  // M > 0: every shared-memory access of the consumer sits between two
  // blocks of 4 M steps (the block's inputs loaded as the block before it
  // ends, its preds stored as it ends), never inside one: a shared access
  // queued behind the producers' copies stalls the consumer's in-order
  // issue, and the producers copy in bursts after each barrier
  [[maybe_unused]] Vec yv[M > 0 ? M : 1], mv[M > 0 ? M : 1];
  if constexpr (M > 0)
    if (T >= L::BLOCK) load_block(yv, mv, yrow(0), mrow(0));
  for (int c = 0; c < chunks; ++c) {
    const int steps = min(CH, T - c * CH);
    if constexpr (M > 0) {
      // chunks start at multiples of M, so the slot of chunk step i + j is j
      const int blocks = steps / L::BLOCK;
#pragma unroll 1
      for (int q = 0; q < blocks; ++q) {
        run_block<M, MULT>(yv, mv, prow(c) + q * L::BLOCK, k, st);
        if (q + 1 < blocks)
          load_block(yv, mv, yrow(c) + (q + 1) * L::BLOCK,
                     mrow(c) + (q + 1) * L::BLOCK);
        else if (c + 1 < chunks && T - (c + 1) * CH >= L::BLOCK)
          load_block(yv, mv, yrow(c + 1), mrow(c + 1));  // landed, visible
      }
      const int i = blocks * L::BLOCK;
      if (i < steps)
        run_tail<M, MULT>(yrow(c) + i, mrow(c) + i, prow(c) + i, steps - i,
                          k, st);
    } else if (m == 1) {
      run_chunk_smem<MULT, true>(yrow(c), mrow(c), prow(c), steps, k, ss,
                                 lane, m, slot, st.s[0], st.l, st.b, st.sse,
                                 st.cnt);
    } else {
      run_chunk_smem<MULT, false>(yrow(c), mrow(c), prow(c), steps, k, ss,
                                  lane, m, slot, st.s[0], st.l, st.b, st.sse,
                                  st.cnt);
    }
    long long t_bar = 0;
    if constexpr (PROBE) t_bar = clock64();
    block_barrier<THREADS>();  // chunk c computed
    if constexpr (PROBE) waited += clock64() - t_bar;
  }
  if constexpr (PROBE) {
    if (lane == 0) {
      long long* out = probe + blockIdx.x * PROBE_FIELDS;
      out[0] = t_start;
      out[1] = t_loop;
      out[2] = clock64();
      out[3] = waited;
      out[4] = ns_start;
      out[5] = global_ns();
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      out[6] = sm;
    }
  }

  if (!live) return;
  mse[r] = st.sse / fmaxf(st.cnt, 1.0f);
  level[r] = st.l;
  trend[r] = st.b;
  if constexpr (M > 0) {
#pragma unroll
    for (int j = 0; j < M; ++j)
      season[static_cast<size_t>(r) * M + j] = st.s[j];
  } else {
    for (int j = 0; j < m; ++j)
      season[static_cast<size_t>(r) * m + j] = ss[j * ROWS + lane];
  }
}

// The device's opt-in shared memory per block, read once per device.
cudaError_t smem_limit(int dev, int* limit) {
  static std::atomic<int> cached[MAX_DEVICES];
  if (dev < MAX_DEVICES && (*limit = cached[dev].load()) > 0)
    return cudaSuccess;
  const cudaError_t e = cudaDeviceGetAttribute(
      limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess && dev < MAX_DEVICES) cached[dev].store(*limit);
  return e;
}

// The instance may take the device's whole opt-in shared memory: granted
// once per (instance, device), not on every launch.
template <int M, bool MULT, bool PROBE, int P>
cudaError_t grant(int dev, int limit) {
  static std::atomic<bool> granted[MAX_DEVICES];
  if (dev < MAX_DEVICES && granted[dev].load()) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      hw_filter_kernel<M, MULT, PROBE, P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (e == cudaSuccess && dev < MAX_DEVICES) granted[dev].store(true);
  return e;
}

// The blocks of an m 7 instance that the device runs at once (one wave):
// its SMs times the blocks an SM holds, read once per (instance, device).
template <bool MULT, bool PROBE, int P>
cudaError_t wave(int dev, int limit, int* blocks) {
  static std::atomic<int> cached[MAX_DEVICES];
  if (dev < MAX_DEVICES && (*blocks = cached[dev].load()) > 0)
    return cudaSuccess;
  int sms = 0, per_sm = 0;
  cudaError_t e = grant<7, MULT, PROBE, P>(dev, limit);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, hw_filter_kernel<7, MULT, PROBE, P>, ROWS + P,
        Layout<7>::FLOATS * sizeof(float));
  if (e != cudaSuccess) return e;
  *blocks = sms * per_sm;
  if (dev < MAX_DEVICES && *blocks > 0) cached[dev].store(*blocks);
  return cudaSuccess;
}

template <int M, bool MULT, bool PROBE, int P>
int launch(const float* y, const float* mask, const float* alpha,
           const float* beta, const float* gamma, const float* phi,
           const float* l0, const float* b0, const float* s0, float* level,
           float* trend, float* season, float* mse, float* fitted,
           long long* probe, int S, int T, int m, int dev, int limit,
           cudaStream_t stream) {
  size_t smem = Layout<M>::FLOATS * sizeof(float);
  if (M == 0) smem += static_cast<size_t>(m) * ROWS * sizeof(float);
  if (smem > static_cast<size_t>(limit)) return HW_SEASON_TOO_LONG;
  const cudaError_t e = grant<M, MULT, PROBE, P>(dev, limit);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (S + ROWS - 1) / ROWS;
  hw_filter_kernel<M, MULT, PROBE, P><<<blocks, ROWS + P, smem, stream>>>(
      y, mask, alpha, beta, gamma, phi, l0, b0, s0, level, trend, season, mse,
      fitted, probe, S, T, m);
  return static_cast<int>(cudaGetLastError());
}

// m 7: fifteen producer warps while the grid fits one wave of them, else
// seven (two blocks an SM: half the waves).
template <bool MULT, bool PROBE>
int launch7(const float* y, const float* mask, const float* alpha,
            const float* beta, const float* gamma, const float* phi,
            const float* l0, const float* b0, const float* s0, float* level,
            float* trend, float* season, float* mse, float* fitted,
            long long* probe, int S, int T, int m, int dev, int limit,
            cudaStream_t stream) {
  if (Layout<7>::FLOATS * sizeof(float) > static_cast<size_t>(limit))
    return HW_SEASON_TOO_LONG;
  int one_wave = 0;
  const cudaError_t e = wave<MULT, PROBE, WIDE>(dev, limit, &one_wave);
  if (e != cudaSuccess) return static_cast<int>(e);
  if ((S + ROWS - 1) / ROWS <= one_wave)
    return launch<7, MULT, PROBE, WIDE>(y, mask, alpha, beta, gamma, phi, l0,
                                        b0, s0, level, trend, season, mse,
                                        fitted, probe, S, T, m, dev, limit,
                                        stream);
  return launch<7, MULT, PROBE, NARROW>(y, mask, alpha, beta, gamma, phi, l0,
                                        b0, s0, level, trend, season, mse,
                                        fitted, probe, S, T, m, dev, limit,
                                        stream);
}

template <bool PROBE>
int dispatch(const float* y, const float* mask, const float* alpha,
             const float* beta, const float* gamma, const float* phi,
             const float* l0, const float* b0, const float* s0, float* level,
             float* trend, float* season, float* mse, float* fitted,
             long long* probe, int S, int T, int m, int multiplicative,
             void* stream) {
  if (S <= 0 || m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = smem_limit(dev, &limit);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (m == 7)
    return multiplicative
               ? launch7<true, PROBE>(y, mask, alpha, beta, gamma, phi, l0,
                                      b0, s0, level, trend, season, mse,
                                      fitted, probe, S, T, m, dev, limit, st)
               : launch7<false, PROBE>(y, mask, alpha, beta, gamma, phi, l0,
                                       b0, s0, level, trend, season, mse,
                                       fitted, probe, S, T, m, dev, limit,
                                       st);
  return multiplicative
             ? launch<0, true, PROBE, SMEM>(y, mask, alpha, beta, gamma, phi,
                                            l0, b0, s0, level, trend, season,
                                            mse, fitted, probe, S, T, m, dev,
                                            limit, st)
             : launch<0, false, PROBE, SMEM>(y, mask, alpha, beta, gamma, phi,
                                             l0, b0, s0, level, trend, season,
                                             mse, fitted, probe, S, T, m, dev,
                                             limit, st);
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
  return dispatch<false>(y, mask, alpha, beta, gamma, phi, l0, b0, s0, level,
                         trend, season, mse, fitted, nullptr, S, T, m,
                         multiplicative, stream);
}

// The same kernel as a measurement instance: hw_filter_launch's arguments
// and `probe`, (blocks, PROBE_FIELDS) int64, where the consumer's lane 0 of
// each block writes what it measured.  A measurement entry only
// (chip_smoke.py binds and calls it); no module of the package calls it.
extern "C" int hw_filter_probe_launch(
    const float* y, const float* mask, const float* alpha, const float* beta,
    const float* gamma, const float* phi, const float* l0, const float* b0,
    const float* s0, float* level, float* trend, float* season, float* mse,
    float* fitted, long long* probe, int S, int T, int m, int multiplicative,
    void* stream) {
  return dispatch<true>(y, mask, alpha, beta, gamma, phi, l0, b0, s0, level,
                        trend, season, mse, fitted, probe, S, T, m,
                        multiplicative, stream);
}

extern "C" const char* hw_filter_error_string(int err) {
  if (err == HW_SEASON_TOO_LONG)
    return "the season does not fit in one block's shared memory";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
