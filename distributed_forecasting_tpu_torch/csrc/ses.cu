// The croston and theta recurrences on Hopper (sm_90a).
//
// croston_filter replaces the reference's Croston / SBA / TSB lax.scans
// (distributed_forecasting_tpu/models/croston.py: the fit's at :127 (TSB)
// and :142 (croston, SBA), the streaming update's at :210 and :231).
// ses_filter replaces theta's SES scan (distributed_forecasting_tpu/models/
// theta.py::_ses_path, :104, vmapped over the alpha grid) and the streaming
// update's scan (:236).  Neither has a Pallas origin: XLA compiles each scan
// into one loop on the device.  The port's plain twins are
// ops/ses.croston_filter_reference and ops/ses.ses_filter_reference, the
// Python loops of models/croston._croston_step / _tsb_step and
// models/theta._ses_step.
//
// Contract: bitwise equal to the twins on the card.  A streamed state must
// continue the fit's bit for bit, and the fit's state is what forecasting
// and serving read.  So each step is the twin's arithmetic, term for term
// and in its order: no contraction (the library is built with
// --fmad=false), IEEE division, torch.clamp_min(p, 1) written as
// `p < 1 ? 1 : p` so that a NaN passes through as it does in torch, both
// branches of each torch.where formed and then selected, the interval
// restart `q * keep` a multiply (not a select), and every Python-float
// constant (alpha, 1 - alpha, 1 - alpha / 2, beta, 1 - beta, theta's line
// weights) rounded to float32 on the host, as torch rounds a Python scalar
// before it multiplies a float32 tensor.  Theta's 1 - alpha is the float32
// subtraction the twin makes on the float32 alpha.  The demand test
// y > 1e-6 compares against float32(1e-6): no float32 lies between the two.
//
// Design: one thread per lane (a row for croston, a (row, alpha) pair for
// theta), 32 lanes a block, the carries in registers.  The inputs are
// time-major, (T, S), so a warp's 32 lanes read one contiguous 128-byte
// segment a step and write one (croston's path, theta's buffer row): no
// staging is needed for coalescing.  At the main path's widths the grid is
// small (500 rows: 16 warps; 500 x 7 lanes: 110), one warp an SM, so
// nothing hides a warp's own latencies and the step's instruction count is
// the cost: time goes in whole blocks of U steps with no bounds test, each
// input's address one wide multiply-add off the block's pointer (32-bit
// offsets, 64-bit pointers advanced a block at a time), and the loads of
// block b + 1 issued before block b's recursion runs, into a second set of
// registers (the two used in turn, no copies); the steps past the last
// whole block go one at a time.  The first design (16-step blocks, a bounds
// test and a 64-bit index product on every load and store) spent ~180
// cycles a step at 500 x 1,826 on an H100 (0.147 ms croston, 0.166 ms
// theta): its step was address arithmetic, not the recursion.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32) at the fit shapes:
// croston (S 500, T 1,826): y and mask read and the path written,
// 4 * 3 * S * T = 11.0 MB -> 3.3 us; theta (S 500, A 7, T 1,826): z and
// mask read and the (T + 1, S, A) buffer written, 33.1 MB -> 9.9 us.  The
// serial chain is the recursion's dependent instructions a step: croston's
// z and p updates (multiply, add, select: 3; the SASS predicates the
// select onto the add) and theta's level update (the same), about 12-16
// cycles a step at 4 a dependent instruction, so T * ~16 cycles = 14.8 us
// at 1.98 GHz for croston and T * ~12 = 11.1 us for theta: both are bound
// by their chain, not by bytes or operations (chip_smoke.py's phase 25 and
// --kernel-times measure them; PERF.md has the numbers).
//
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int LANES = 32;    // lanes per block: one warp
constexpr int U_FIT = 32;    // steps a pipeline block: two inputs a step
constexpr int U_SCORED = 8;  // theta's scored form: five inputs a step
constexpr float EPS = 1e-6f;  // the demand threshold, float32(1e-6)

enum Variant { CROSTON = 0, SBA = 1, TSB = 2 };

// The Python-float constants of the step, each rounded to float32 on the
// host (ops/ses.py): alpha, 1 - alpha, 1 - alpha / 2, beta * 1.0, 1 - beta.
struct CrostonConst {
  float a, c1a, sba, b, c1b;
};

// Load U steps of each time-major input into r[k][0..U): in[k] points at
// the lane's element of the block's first step, the steps S floats apart.
// Each address is one wide multiply-add off the block's pointer.
template <int U, int N>
__device__ __forceinline__ void load_block(const float* (&in)[N],
                                           float (&r)[N][U], unsigned S) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int j = 0; j < U; ++j) r[k][j] = __ldg(in[k] + j * S);
  }
}

template <int N>
__device__ __forceinline__ void advance(const float* (&in)[N], size_t by) {
#pragma unroll
  for (int k = 0; k < N; ++k) in[k] += by;
}

// Runs `lane` over T steps of its N time-major inputs (in[k] at the lane's
// element of step 0): whole blocks of U steps whose loads are issued one
// block ahead, into a second set of registers (the two sets used in
// turn), then the steps past the last whole block one at a time.  The
// lane advances its own output pointers.
template <int U, int N, class Lane>
__device__ __forceinline__ void drive(Lane& lane, const float* (&in)[N],
                                      int T, unsigned S) {
  const int blocks = T / U;
  const size_t stride = static_cast<size_t>(U) * S;
  float ra[N][U], rb[N][U];
  if (blocks > 0) load_block<U>(in, ra, S);
  for (int b = 0; b < blocks; b += 2) {
    const bool next = b + 1 < blocks;
    if (next) {
      advance(in, stride);
      load_block<U>(in, rb, S);
    }
    lane.template run<U>(ra);
    if (!next) break;
    if (b + 2 < blocks) {
      advance(in, stride);
      load_block<U>(in, ra, S);
    }
    lane.template run<U>(rb);
  }
  if (blocks > 0) advance(in, stride);  // past the last whole block
  for (int t = blocks * U; t < T; ++t) {
    float r[N][1];
    load_block<1>(in, r, S);
    advance(in, S);
    lane.template run<1>(r);
  }
}

// Croston / SBA / TSB for one row.  Inputs y, mask.  Carries (z, p, q) for
// croston and SBA, (z, b) for TSB (b in p's place, q unused).  SUMS: also
// the running squared one-step error and observed count, from (sse0, n0),
// as the streaming update accumulates them.  `path` is the row's element
// of the next step's one-step rate.
template <int V, bool SUMS>
struct CrostonLane {
  float z, p, q, sse, n;
  CrostonConst c;
  float* path;
  unsigned S;

  template <int U>
  __device__ __forceinline__ void run(const float (&r)[2][U]) {
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const float yt = r[0][j];
      const float mt = r[1][j];
      float rate;
      if constexpr (V == TSB) {
        rate = z * p;
        const bool observed = mt > 0.0f;
        const bool demand = (yt > EPS) & observed;
        const float b_in = demand ? c.b : 0.0f;
        const float c1b_b = c.c1b * p;
        const float b_new = b_in + c1b_b;
        const float ay = c.a * yt;
        const float c1a_z = c.c1a * z;
        const float z_new = ay + c1a_z;
        p = observed ? b_new : p;
        z = demand ? z_new : z;
      } else {
        const float pc = p < 1.0f ? 1.0f : p;
        rate = z / pc;
        if constexpr (V == SBA) rate = rate * c.sba;
        const bool demand = (yt > EPS) & (mt > 0.0f);
        const float q_new = q + mt;
        const float ay = c.a * yt;
        const float c1a_z = c.c1a * z;
        const float z_new = ay + c1a_z;
        const float a_q = c.a * q_new;
        const float c1a_p = c.c1a * p;
        const float p_new = a_q + c1a_p;
        const float keep = demand ? 0.0f : 1.0f;
        z = demand ? z_new : z;
        p = demand ? p_new : p;
        q = q_new * keep;
      }
      path[j * S] = rate;
      if constexpr (SUMS) {
        const float d = yt - rate;
        const float err = d * mt;
        const float e2 = err * err;
        sse = sse + e2;
        n = n + mt;
      }
    }
    path += static_cast<size_t>(U) * S;
  }
};

template <int V, bool SUMS>
__global__ void __launch_bounds__(LANES)
    croston_filter_kernel(const float* __restrict__ y,
                          const float* __restrict__ mask,
                          const float* __restrict__ z0,
                          const float* __restrict__ p0,
                          const float* __restrict__ q0,
                          const float* __restrict__ sse0,
                          const float* __restrict__ n0, float* path, float* z,
                          float* p, float* q, float* sse, float* n, int S,
                          int T, CrostonConst c) {
  const int s = blockIdx.x * LANES + threadIdx.x;
  if (s >= S) return;
  CrostonLane<V, SUMS> lane;
  lane.c = c;
  lane.z = z0[s];
  lane.p = p0[s];
  lane.q = V == TSB ? 0.0f : q0[s];
  lane.sse = SUMS ? sse0[s] : 0.0f;
  lane.n = SUMS ? n0[s] : 0.0f;
  lane.path = path + s;
  lane.S = static_cast<unsigned>(S);
  const float* in[2] = {y + s, mask + s};
  drive<U_FIT>(lane, in, T, static_cast<unsigned>(S));
  z[s] = lane.z;
  p[s] = lane.p;
  if (V != TSB) q[s] = lane.q;
  if (SUMS) {
    sse[s] = lane.sse;
    n[s] = lane.n;
  }
}

// Masked SES for lane i = (row s, candidate a) of an (S, A) alpha grid:
// buf[t + 1] = where(mask > 0, (1 - alpha) * level + alpha * z, level),
// buf[0] = l0[s].  SCORED (A 1, the streaming update): also each step's
// fitted value (w * level + w1 * trend) * si, written to `fitted`, and the
// running squared error and observed count from (sse0, n0).  Inputs z,
// mask (and y, trend, si when SCORED); the A lanes of a row read the same
// addresses.  `buf` is the lane's element of the next step's row (t + 1),
// `fitted` the row's element of step t.
template <bool SCORED>
struct SesLane {
  float al, om, level, sse, n, w, w1;
  float* buf;
  float* fitted;
  unsigned S, SA;

  template <int U>
  __device__ __forceinline__ void run(const float (&r)[SCORED ? 5 : 2][U]) {
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const float mt = r[1][j];
      const float az = al * r[0][j];
      float carry = om * level;
      carry = carry + az;
      const float next = mt > 0.0f ? carry : level;
      buf[j * SA] = next;
      if constexpr (SCORED) {
        const float wl = w * level;
        const float wt = w1 * r[3][j];
        const float line = wl + wt;
        const float f = line * r[4][j];
        fitted[j * S] = f;
        const float d = r[2][j] - f;
        const float err = d * mt;
        const float e2 = err * err;
        sse = sse + e2;
        n = n + mt;
      }
      level = next;
    }
    buf += static_cast<size_t>(U) * SA;
    if constexpr (SCORED) fitted += static_cast<size_t>(U) * S;
  }
};

template <bool SCORED>
__global__ void __launch_bounds__(LANES)
    ses_filter_kernel(const float* __restrict__ zl,
                      const float* __restrict__ mask,
                      const float* __restrict__ l0,
                      const float* __restrict__ alpha,
                      const float* __restrict__ y,
                      const float* __restrict__ trend,
                      const float* __restrict__ si,
                      const float* __restrict__ sse0,
                      const float* __restrict__ n0, float* buf, float* fitted,
                      float* sse_out, float* n_out, int S, int T, int A,
                      float w, float w1) {
  const int i = blockIdx.x * LANES + threadIdx.x;
  const int SA = S * A;
  if (i >= SA) return;
  const int s = i / A;
  SesLane<SCORED> lane;
  lane.al = alpha[i];
  lane.om = 1.0f - lane.al;
  lane.level = l0[s];
  lane.sse = SCORED ? sse0[s] : 0.0f;
  lane.n = SCORED ? n0[s] : 0.0f;
  lane.w = w;
  lane.w1 = w1;
  lane.S = static_cast<unsigned>(S);
  lane.SA = static_cast<unsigned>(SA);
  buf[i] = lane.level;
  lane.buf = buf + SA + i;
  lane.fitted = SCORED ? fitted + s : nullptr;
  if constexpr (SCORED) {
    const float* in[5] = {zl + s, mask + s, y + s, trend + s, si + s};
    drive<U_SCORED>(lane, in, T, static_cast<unsigned>(S));
    sse_out[s] = lane.sse;
    n_out[s] = lane.n;
  } else {
    const float* in[2] = {zl + s, mask + s};
    drive<U_FIT>(lane, in, T, static_cast<unsigned>(S));
  }
}

template <int V>
cudaError_t launch_croston(const float* y, const float* mask, const float* z0,
                           const float* p0, const float* q0,
                           const float* sse0, const float* n0, float* path,
                           float* z, float* p, float* q, float* sse, float* n,
                           int S, int T, CrostonConst c, cudaStream_t st) {
  const int blocks = (S + LANES - 1) / LANES;
  if (sse0 != nullptr)
    croston_filter_kernel<V, true><<<blocks, LANES, 0, st>>>(
        y, mask, z0, p0, q0, sse0, n0, path, z, p, q, sse, n, S, T, c);
  else
    croston_filter_kernel<V, false><<<blocks, LANES, 0, st>>>(
        y, mask, z0, p0, q0, sse0, n0, path, z, p, q, sse, n, S, T, c);
  return cudaGetLastError();
}

}  // namespace

// C launchers read through ctypes (ops/_build.py).  Each launches on
// `stream` and returns cudaGetLastError() of the launch (0 on success), or
// SES_BAD_ARGUMENTS for arguments the kernels do not take; the wrappers
// (ops/ses.py) check shapes, types and contiguity first.  Every array is
// float32, contiguous, time-major where it has a time axis.
//
// croston_filter: y, mask (T, S); z0, p0 (S,) and q0 (S,) for croston and
// SBA (null for TSB, whose b rides in p0 / p); path (T, S) out; z, p, q
// (S,) out (q null for TSB); sse0, n0 in and sse, n out (S,), all four
// null when the sums are not wanted.  variant: 0 croston, 1 SBA, 2 TSB.
constexpr int SES_BAD_ARGUMENTS = -1;
// the in-block offsets (j * S, j * S * A) are 32-bit: a block of U_FIT
// steps spans at most this many elements
constexpr long long MAX_BLOCK_ELEMENTS = 0xffffffffLL;

extern "C" int croston_filter_launch(const float* y, const float* mask,
                                     const float* z0, const float* p0,
                                     const float* q0, const float* sse0,
                                     const float* n0, float* path, float* z,
                                     float* p, float* q, float* sse, float* n,
                                     int S, int T, int variant, float alpha,
                                     float one_minus_alpha, float sba_factor,
                                     float beta, float one_minus_beta,
                                     void* stream) {
  if (S <= 0 || T < 0 || variant < CROSTON || variant > TSB ||
      static_cast<long long>(S) * U_FIT > MAX_BLOCK_ELEMENTS)
    return SES_BAD_ARGUMENTS;
  if ((sse0 == nullptr) != (sse == nullptr) ||
      (sse0 == nullptr) != (n0 == nullptr) ||
      (sse0 == nullptr) != (n == nullptr))
    return SES_BAD_ARGUMENTS;
  if (variant != TSB && (q0 == nullptr || q == nullptr))
    return SES_BAD_ARGUMENTS;
  const CrostonConst c{alpha, one_minus_alpha, sba_factor, beta,
                       one_minus_beta};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case CROSTON:
      return static_cast<int>(launch_croston<CROSTON>(
          y, mask, z0, p0, q0, sse0, n0, path, z, p, q, sse, n, S, T, c, st));
    case SBA:
      return static_cast<int>(launch_croston<SBA>(
          y, mask, z0, p0, q0, sse0, n0, path, z, p, q, sse, n, S, T, c, st));
    default:
      return static_cast<int>(launch_croston<TSB>(
          y, mask, z0, p0, q0, sse0, n0, path, z, p, q, sse, n, S, T, c, st));
  }
}

// ses_filter: z, mask (T, S); l0 (S,); alpha (S, A); buf (T + 1, S, A) out.
// The scored form (A 1): y, trend, si (T, S) and sse0, n0 (S,) in, fitted
// (T, S) and sse, n (S,) out, w = float32(1 / theta) and w1 = float32(1 -
// 1 / theta); all eight arrays null for the plain form.
extern "C" int ses_filter_launch(const float* z, const float* mask,
                                 const float* l0, const float* alpha,
                                 const float* y, const float* trend,
                                 const float* si, const float* sse0,
                                 const float* n0, float* buf, float* fitted,
                                 float* sse, float* n, int S, int T, int A,
                                 float w, float w1, void* stream) {
  if (S <= 0 || T < 0 || A <= 0 ||
      static_cast<long long>(S) * A * U_FIT > MAX_BLOCK_ELEMENTS)
    return SES_BAD_ARGUMENTS;
  // the sums say which form (an empty (T, S) grid has no data pointer)
  const bool scored = sse0 != nullptr;
  if (scored && (A != 1 || n0 == nullptr || sse == nullptr || n == nullptr))
    return SES_BAD_ARGUMENTS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long lanes = static_cast<long long>(S) * A;
  const int blocks = static_cast<int>((lanes + LANES - 1) / LANES);
  if (scored)
    ses_filter_kernel<true><<<blocks, LANES, 0, st>>>(
        z, mask, l0, alpha, y, trend, si, sse0, n0, buf, fitted, sse, n, S, T,
        A, w, w1);
  else
    ses_filter_kernel<false><<<blocks, LANES, 0, st>>>(
        z, mask, l0, alpha, y, trend, si, sse0, n0, buf, fitted, sse, n, S, T,
        A, w, w1);
  return static_cast<int>(cudaGetLastError());
}

static const char* ses_error_string(int err) {
  if (err == SES_BAD_ARGUMENTS)
    return "arguments the kernel does not take (an empty batch, an unknown "
           "variant, a partial set of optional arrays, or more than 2^32 / "
           "32 lanes)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" const char* croston_filter_error_string(int err) {
  return ses_error_string(err);
}

extern "C" const char* ses_filter_error_string(int err) {
  return ses_error_string(err);
}
