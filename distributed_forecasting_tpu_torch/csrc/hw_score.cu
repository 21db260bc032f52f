// Holt-Winters candidate scoring on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel distributed_forecasting_tpu/ops/fused_scan.py
// ::hw_score (body _score_kernel).  For every (series, candidate) pair it runs
// the additive Holt-Winters filter with trend damping over the series'
// history and returns the masked one-step-ahead MSE, sse / max(n_obs, 1).
// The plain twin is ops/fused_scan.hw_score_reference.  Only the argmin over
// candidates consumes the scores, and the winner is refit exactly by
// csrc/hw_filter.cu, so scoring is tolerance-grade: it agrees with the twin
// within rtol 1e-5 / atol 1e-6 (the reference's own kernel-vs-scan bound),
// not bit for bit.
//
// Order of operations of one observed step, per candidate (the library is
// built with --fmad=false, so only the one __fmaf_rn written out contracts):
//   pb = phi * b;  lp = l + pb;  pred = lp + s
//   l' = alpha * (y - s) + (1 - alpha) * lp
//   s' = gamma * (y - l') + (1 - gamma) * s
//   b' = beta * (l' - l) + (1 - beta) * pb
//   e  = (y - pred) * mask;  sse = fma(e, e, sse)
// 19 float operations (the FMA counts two) in 18 instructions per
// candidate, 18 in 17 where the mask is exactly 1 (the multiply by it is
// dropped), plus n += mask once per series.  The recursion (l, b, s) rounds
// exactly as the twin's does; only the error sum contracts.  Two shorter
// forms were tried and break the tolerance: contracting the recursion too
// (three more FMAs), and the error-correction form of the same step
//   e = y - pred;  l' = lp + alpha e;  s' = s + gamma (1 - alpha) e;
//   b' = pb + beta alpha e         (12 operations with the error sum)
// Where a candidate's filter diverges (the m = 30 grid on the committed data
// has such candidates, with scores near 4e8), each rounding difference grows
// with the state, and the scores drift about 5e-5 relative from the twin's
// (PERF.md).  The error sum adds non-negative terms, so its rounding stays
// within the tolerance.
// A masked step (mask <= 0) takes the predict-only branch:
//   pb = phi * b;  l = l + pb;  b = pb       (season untouched, 2 operations)
// which is what the twin's select gives (its error term is 0 * finite).
//
// Design:
//   - one warp per series and 32 * K candidates (K = 3 in registers per
//     thread, three independent chains in flight): the default grid (96) is
//     one warp per series, the damped grid (288) three.  A block is one
//     series and up to four warps; grid (S, blocks per series).  Candidate
//     k of lane g is g + k * lanes; lanes past the last candidate rerun
//     candidate C - 1 and store nothing;
//   - the series is staged once per block: y and mask in chunks of about
//     512 steps, coalesced 16-byte cp.async copies, double-buffered, so each
//     step reads a shared-memory broadcast.  Rows start anywhere (T is not a
//     multiple of 4), so each chunk copies the 16-byte segments that cover
//     it and reads from an offset; a segment may hold up to 3 floats of the
//     neighbouring row, never bytes outside an aligned 16-byte segment that
//     also holds data of this tensor;
//   - season length 7 is a template instance: the time loop is unrolled by
//     7 so every slot index is static and the K * 7 seasonal states live in
//     registers.  Any other m keeps them in dynamic shared memory,
//     season[(slot * K + k) * blockDim.x + tid], with a slot counter;
//   - the mask is uniform across the block (one series), so the masked
//     branch is a real branch with no divergence.  The register instance
//     reads each group of 7 steps' y and mask into registers first, and a
//     group whose mask is 1 at every step runs as straight-line code (and
//     drops the multiply by the mask, exact at 1), so one step's
//     independent work overlaps the previous step's chain (with a branch
//     per step instead, the fit shape takes 1.2x as long: PERF.md);
//   - each row stops after its last observed step (t_end from the wrapper):
//     trailing masked steps change neither sse nor n.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s float32 outside the tensor
// cores), counted by ops/fused_scan.hw_score_work from the run's mask: at the
// fit shape (S 500, T 1,826, C 96, every step observed with weight 1)
// 18 * 87.6 M + 0.9 M = 1.58 GFLOP -> 23.6 us; bytes (y, mask, grid,
// states, scores) 7.5 MB -> 2.2 us.  So it is bound by operations.  The
// 12-operation form above would put the bound at 15.7 us, but its scores
// miss the tolerance, so the bound counts the form that meets it.
// Instruction issue sets a floor above that: one warp step is ~3 * 17 + ~3
// instructions (loads, n), 500 warps on 528 schedulers at one instruction a
// cycle, 1,826 steps: ~50 us at 1.98 GHz.
// Measured times stand beside the bound in PERF.md.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int K = 3;          // candidates per thread
constexpr int CHUNK = 512;    // steps per staged chunk (a multiple of M below)
constexpr int BUF = 520;      // floats per staged array: a chunk + alignment
constexpr int STAGE_FLOATS = 2 * 2 * BUF;  // [buffer][y | mask][BUF]
// the launcher's status when a season does not fit shared memory (CUDA's
// own error codes are never negative)
constexpr int HW_SEASON_TOO_LONG = -1;

template <int M>
struct Chunk {
  static constexpr int value = M > 0 ? (CHUNK / M) * M : CHUNK;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy steps [t0, t1) of the row that starts at element row0 of y and mask
// into by / bm as whole aligned 16-byte segments.  Returns the offset of
// step t0 in the buffers.
__device__ __forceinline__ int stage(const float* __restrict__ y,
                                     const float* __restrict__ mask,
                                     size_t row0, int t0, int t1, float* by,
                                     float* bm) {
  const size_t first = (row0 + t0) & ~static_cast<size_t>(3);
  const size_t last = (row0 + t1 + 3) & ~static_cast<size_t>(3);
  const int nseg = static_cast<int>((last - first) >> 2);
  for (int i = threadIdx.x; i < nseg; i += blockDim.x) {
    cp_async16(by + 4 * i, y + first + 4 * i);
    cp_async16(bm + 4 * i, mask + first + 4 * i);
  }
  return static_cast<int>(row0 + t0 - first);
}

// UNIT: the step's mask value is exactly 1, so (y - pred) * mask is y - pred
template <bool UNIT = false>
__device__ __forceinline__ void observed(float yt, float mt, float a,
                                         float one_a, float be, float one_be,
                                         float g, float one_g, float p,
                                         float& l, float& b, float& s,
                                         float& sse) {
  const float pb = p * b;
  const float lp = l + pb;
  const float pred = lp + s;
  const float l_obs = a * (yt - s) + one_a * lp;
  const float s_obs = g * (yt - l_obs) + one_g * s;
  const float b_obs = be * (l_obs - l) + one_be * pb;
  const float err = UNIT ? yt - pred : (yt - pred) * mt;
  sse = __fmaf_rn(err, err, sse);
  l = l_obs;
  b = b_obs;
  s = s_obs;
}

__device__ __forceinline__ void masked(float p, float& l, float& b) {
  const float pb = p * b;
  l = l + pb;
  b = pb;
}

// M > 0: season length M, states in registers.  M == 0: season length m,
// states in shared memory after the staging buffers.
template <int M>
__global__ void __launch_bounds__(128)
    hw_score_kernel(const float* __restrict__ y, const float* __restrict__ mask,
                    const float* __restrict__ alpha,
                    const float* __restrict__ beta,
                    const float* __restrict__ gamma,
                    const float* __restrict__ phi,
                    const float* __restrict__ l0, const float* __restrict__ b0,
                    const float* __restrict__ s0,
                    const int* __restrict__ t_end, float* __restrict__ out,
                    int T, int C, int m) {
  constexpr int CH = Chunk<M>::value;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int width = blockDim.x;
  const int series = blockIdx.x;
  const int lanes = gridDim.y * width;
  const int lane = blockIdx.y * width + tid;

  float a[K], one_a[K], be[K], one_be[K], g[K], one_g[K], p[K];
  float l[K], b[K], sse[K];
  const float l_init = l0[series];
  const float b_init = b0[series];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = lane + k * lanes;
    const int cc = c < C ? c : C - 1;
    a[k] = alpha[cc];
    be[k] = beta[cc];
    g[k] = gamma[cc];
    p[k] = phi[cc];
    one_a[k] = 1.0f - a[k];
    one_be[k] = 1.0f - be[k];
    one_g[k] = 1.0f - g[k];
    l[k] = l_init;
    b[k] = b_init;
    sse[k] = 0.0f;
  }
  float s[K][M > 0 ? M : 1];
  float* season = smem + STAGE_FLOATS;  // M == 0: [m][K][width]
  if constexpr (M > 0) {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < M; ++j) s[k][j] = s0[series * M + j];
  } else {
    for (int j = 0; j < m; ++j) {
      const float v = s0[static_cast<size_t>(series) * m + j];
#pragma unroll
      for (int k = 0; k < K; ++k) season[(j * K + k) * width + tid] = v;
    }
  }

  const int te = t_end[series];
  const size_t row0 = static_cast<size_t>(series) * T;
  float n = 0.0f;
  int slot = 0;  // M == 0 only
  int off = 0;
  if (te > 0) off = stage(y, mask, row0, 0, min(CH, te), smem, smem + BUF);
  cp_async_commit();
  for (int t0 = 0, it = 0; t0 < te; t0 += CH, ++it) {
    const int ce = min(t0 + CH, te);
    int off_next = 0;
    if (ce < te) {
      float* nb = smem + ((it + 1) & 1) * 2 * BUF;
      off_next = stage(y, mask, row0, ce, min(ce + CH, te), nb, nb + BUF);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ys = smem + (it & 1) * 2 * BUF + off - t0;  // indexed by t
    const float* ms = ys + BUF;

    if constexpr (M > 0) {
      // t0 is a multiple of M, so the slot of step t + j is j.  Each group
      // of M steps reads its y and mask into registers first; a group whose
      // mask is 1 at every step (the common case) runs straight-line code,
      // so the steps' independent work overlaps; any other group branches
      // per step.
      int t = t0;
      for (; t + M <= ce; t += M) {
        float yv[M], mv[M];
        bool all_one = true;
#pragma unroll
        for (int j = 0; j < M; ++j) {
          yv[j] = ys[t + j];
          mv[j] = ms[t + j];
          all_one = all_one && mv[j] == 1.0f;
        }
        if (all_one) {
#pragma unroll
          for (int j = 0; j < M; ++j) {
            n = n + 1.0f;
#pragma unroll
            for (int k = 0; k < K; ++k)
              observed<true>(yv[j], 1.0f, a[k], one_a[k], be[k], one_be[k],
                             g[k], one_g[k], p[k], l[k], b[k], s[k][j],
                             sse[k]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < M; ++j) {
            if (mv[j] > 0.0f) {
              n = n + mv[j];
#pragma unroll
              for (int k = 0; k < K; ++k)
                observed(yv[j], mv[j], a[k], one_a[k], be[k], one_be[k],
                         g[k], one_g[k], p[k], l[k], b[k], s[k][j], sse[k]);
            } else {
#pragma unroll
              for (int k = 0; k < K; ++k) masked(p[k], l[k], b[k]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < M; ++j) {  // the last chunk's partial group
        if (t + j < ce) {
          const float yt = ys[t + j];
          const float mt = ms[t + j];
          if (mt > 0.0f) {
            n = n + mt;
#pragma unroll
            for (int k = 0; k < K; ++k)
              observed(yt, mt, a[k], one_a[k], be[k], one_be[k], g[k],
                       one_g[k], p[k], l[k], b[k], s[k][j], sse[k]);
          } else {
#pragma unroll
            for (int k = 0; k < K; ++k) masked(p[k], l[k], b[k]);
          }
        }
      }
    } else {
      for (int t = t0; t < ce; ++t) {
        const float yt = ys[t];
        const float mt = ms[t];
        float* sp = season + slot * K * width + tid;
        if (mt > 0.0f) {
          n = n + mt;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            float sk = sp[k * width];
            observed(yt, mt, a[k], one_a[k], be[k], one_be[k], g[k],
                     one_g[k], p[k], l[k], b[k], sk, sse[k]);
            sp[k * width] = sk;
          }
        } else {
#pragma unroll
          for (int k = 0; k < K; ++k) masked(p[k], l[k], b[k]);
        }
        if (++slot == m) slot = 0;
      }
    }
    __syncthreads();  // the buffer is restaged two chunks on
    off = off_next;
  }

  const float denom = fmaxf(n, 1.0f);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = lane + k * lanes;
    if (c < C) out[static_cast<size_t>(series) * C + c] = sse[k] / denom;
  }
}

template <int M>
int launch(const float* y, const float* mask, const float* alpha,
           const float* beta, const float* gamma, const float* phi,
           const float* l0, const float* b0, const float* s0,
           const int* t_end, float* out, int S, int T, int C, int m,
           int threads, int cand_blocks, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hw_score_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(S, cand_blocks);
  hw_score_kernel<M><<<grid, threads, smem, stream>>>(
      y, mask, alpha, beta, gamma, phi, l0, b0, s0, t_end, out, T, C, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C launcher read through ctypes (ops/_build.py).  Picks the geometry from
// (C, m): one warp per 32 * K candidates, a series' warps split evenly over
// the fewest blocks of at most four (96 -> one warp, 288 -> one block of
// three); a shared-memory season cuts the block to the warps whose states
// fit.  Launches on `stream` and returns cudaGetLastError() of the launch (0
// on success), or HW_SEASON_TOO_LONG when not even one warp's season fits
// the device's shared memory.  The wrapper (ops/fused_scan._hw_score_cuda)
// checks shapes, types, contiguity and the 16-byte alignment of y and mask.
extern "C" int hw_score_launch(const float* y, const float* mask,
                               const float* alpha, const float* beta,
                               const float* gamma, const float* phi,
                               const float* l0, const float* b0,
                               const float* s0, const int* t_end, float* out,
                               int S, int T, int C, int m, void* stream) {
  if (S <= 0 || C <= 0 || m <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int warps = (C + 32 * K - 1) / (32 * K);
  int blocks = (warps + 3) / 4;
  int threads = (warps + blocks - 1) / blocks * 32;
  size_t smem = STAGE_FLOATS * sizeof(float);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m == 7)
    return launch<7>(y, mask, alpha, beta, gamma, phi, l0, b0, s0, t_end, out,
                     S, T, C, m, threads, blocks, smem, st);
  int dev = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t per_thread = static_cast<size_t>(m) * K * sizeof(float);
  const size_t room = static_cast<size_t>(limit) > smem ? limit - smem : 0;
  const int fit = static_cast<int>(room / per_thread / 32 * 32);
  if (fit < 32) return HW_SEASON_TOO_LONG;
  if (threads > fit) {
    threads = fit;
    blocks = (warps * 32 + threads - 1) / threads;
  }
  smem += per_thread * threads;
  return launch<0>(y, mask, alpha, beta, gamma, phi, l0, b0, s0, t_end, out,
                   S, T, C, m, threads, blocks, smem, st);
}

extern "C" const char* hw_score_error_string(int err) {
  if (err == HW_SEASON_TOO_LONG)
    return "the season does not fit in one block's shared memory";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
