// Holt-Winters candidate scoring on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel distributed_forecasting_tpu/ops/fused_scan.py
// ::hw_score (body _score_kernel).  For every (series, candidate) pair it runs
// the additive Holt-Winters filter with trend damping over the whole history
// and returns the masked one-step-ahead MSE, sse / max(n_obs, 1).  The
// arithmetic is the reference's _hw_step, expression for expression, and the
// plain twin ops/fused_scan.hw_score_reference is the same sequence in
// PyTorch.  The build turns off multiply-add contraction (--fmad=false, see
// ops/_build.py), so each operation rounds on its own as in the twin.
//
// Design (simple first):
//   - one thread per (series, candidate); blockIdx.x is the series,
//     blockIdx.y the block of candidates (at most 128 threads, whole warps);
//   - level, trend, sse and n_obs live in registers;
//   - the m seasonal states of every thread live in dynamic shared memory at
//     season[slot * blockDim.x + threadIdx.x]: consecutive threads hit
//     consecutive banks, so no bank conflicts;
//   - the slot t mod m is read and written directly, with a counter that
//     wraps at m (no one-hot, no modulo);
//   - every thread of a block reads the same y[s, t] and mask[s, t], a
//     broadcast load that L1 serves after the first warp.
//
// Bound on an H100 SXM (published: 3.35 TB/s HBM, 67 TFLOP/s float32 outside
// the tensor cores).  At the main path's shape, S = 500 series, T = 1,826
// days, C = 96 candidates, m = 7:
//   bytes: y and mask 2 * 500 * 1826 * 4 = 7.30 MB, plus states, grid and the
//          (S, C) output, 7.5 MB in all -> 2.2 us;
//   operations: 20 float32 operations per filter step (3 selects and the
//          loop-invariant 1 - alpha, 1 - beta, 1 - gamma not counted) times
//          S * C * T = 87.6 M steps = 1.75 GFLOP -> 26 us.
// So the least time is 26 us, bound by operations.  What will really bound
// it is the serial chain over T: each step's trend depends on the previous
// one through about eight dependent operations (~30 cycles), and with only
// 48 k threads (about three warps per scheduler) there is too little
// parallel work to hide that latency and the instruction issue of each step.
// Making it fast (several candidates per thread to overlap the chains,
// staging y and mask in shared memory, multiply-add) is later work; the
// measured time stands beside this bound in PERF.md.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

__global__ void hw_score_kernel(const float* __restrict__ y,
                                const float* __restrict__ mask,
                                const float* __restrict__ alpha,
                                const float* __restrict__ beta,
                                const float* __restrict__ gamma,
                                const float* __restrict__ phi,
                                const float* __restrict__ l0,
                                const float* __restrict__ b0,
                                const float* __restrict__ s0,
                                float* __restrict__ out, int T, int C, int m) {
  extern __shared__ float season[];  // [m][blockDim.x]
  const int tid = threadIdx.x;
  const int width = blockDim.x;
  const int series = blockIdx.x;
  const int c = blockIdx.y * width + tid;
  // lanes past the last candidate rerun candidate C - 1 and store nothing
  const int cc = c < C ? c : C - 1;
  const float a = alpha[cc];
  const float be = beta[cc];
  const float g = gamma[cc];
  const float p = phi[cc];
  const float one_a = 1.0f - a;
  const float one_be = 1.0f - be;
  const float one_g = 1.0f - g;

  const float* ys = y + static_cast<size_t>(series) * T;
  const float* ms = mask + static_cast<size_t>(series) * T;
  const float* ss = s0 + static_cast<size_t>(series) * m;
  for (int k = 0; k < m; ++k) season[k * width + tid] = ss[k];

  float l = l0[series];
  float b = b0[series];
  float sse = 0.0f;
  float n = 0.0f;
  int slot = 0;
  for (int t = 0; t < T; ++t) {
    const float yt = ys[t];
    const float mt = ms[t];
    float* sp = season + slot * width + tid;
    const float si = *sp;
    const float pb = p * b;
    const float lp = l + pb;
    const float pred = lp + si;
    const float l_obs = a * (yt - si) + one_a * lp;
    const float s_obs = g * (yt - l_obs) + one_g * si;
    const float b_obs = be * (l_obs - l) + one_be * pb;
    const bool obs = mt > 0.0f;  // masked steps: predict-only branch
    l = obs ? l_obs : lp;
    b = obs ? b_obs : pb;
    *sp = obs ? s_obs : si;
    const float err = (yt - pred) * mt;
    sse = sse + err * err;
    n = n + mt;
    if (++slot == m) slot = 0;
  }
  if (c < C) out[static_cast<size_t>(series) * C + c] = sse / fmaxf(n, 1.0f);
}

}  // namespace

// C launcher read through ctypes (ops/_build.py).  Launches on `stream` and
// returns cudaGetLastError() of the launch (0 on success); the wrapper
// (ops/fused_scan._hw_score_cuda) checks shapes, types and contiguity first.
extern "C" int hw_score_launch(const float* y, const float* mask,
                               const float* alpha, const float* beta,
                               const float* gamma, const float* phi,
                               const float* l0, const float* b0,
                               const float* s0, float* out, int S, int T,
                               int C, int m, int threads, int cand_blocks,
                               void* stream) {
  const size_t smem = static_cast<size_t>(m) * threads * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hw_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(S, cand_blocks);
  hw_score_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      y, mask, alpha, beta, gamma, phi, l0, b0, s0, out, T, C, m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hw_score_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
