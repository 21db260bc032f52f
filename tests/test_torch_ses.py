"""Port parity: ``ops/ses.py``, the croston and theta recurrences' wrappers
and plain twins, on the CPU.

- **wrappers and twins, bitwise**: on a CPU tensor each wrapper runs its
  twin, so ``croston_filter`` / ``ses_filter`` equal
  ``croston_filter_reference`` / ``ses_filter_reference`` bit for bit, and
  the fits through them equal the twin run on the fits' own carries.
- **twins against the reference's scans** (the JAX package on the CPU, the
  same numpy inputs from a seed):
  - croston / SBA / TSB: the fitted path, ``z``, ``p`` and ``sigma``
    against ``models/croston.fit``, within rtol 1e-5 / atol 1e-6 of the
    data's scale (``tests/test_torch_croston.py``'s bound: the initial size
    mean reduces in another order, a few float32 roundings carried over T
    steps);
  - theta: every alpha's one-step path and final level against the
    reference's ``_ses_path`` vmapped over rows and alphas, within rtol
    1e-5 / atol 1e-5 of the data's scale (``tests/test_torch_theta.py``'s
    bound: XLA on the CPU contracts ``alpha*z + (1-alpha)*level`` into an
    FMA and the twin does not);
  - both streaming updates against the reference's ``update_state`` from
    the reference's own fit and carries, with the same bounds; the counts
    (``n_obs``, croston's ``q``) exactly.
- **work counts, exactly**: the float32 operations that
  ``croston_filter_work`` / ``ses_filter_work`` count are the arithmetic
  operations the twins run, element for element (a dispatch mode counts
  them), and the bytes are each input read and each output written once.
- the wrappers refuse a device other than cpu or cuda, and an unknown
  variant.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from distributed_forecasting_tpu.models import croston as jcr
from distributed_forecasting_tpu.models import theta as jth
from distributed_forecasting_tpu_torch.models import croston as tcr
from distributed_forecasting_tpu_torch.models import theta as tth
from distributed_forecasting_tpu_torch.ops import ses

torch.set_num_threads(1)

VARIANTS = ["croston", "sba", "tsb"]
CROSTON_RTOL = 1e-5   # atol 1e-6 of the data's scale
THETA_RTOL = 1e-5     # atol 1e-5 of the data's scale
ALPHAS = (0.02, 0.05, 0.1, 0.2, 0.3, 0.5, 0.8)


def _demand(S=12, T=300, seed=0):
    """Intermittent whole-number demand (tests/test_torch_croston.py's
    shape), with a row with no demand, a fully masked row, a masked tail,
    a dead tail and a non-binary mask on one row."""
    rng = np.random.default_rng(seed)
    rate = rng.uniform(0.05, 0.6, size=(S, 1))
    size = rng.uniform(1, 12, size=(S, 1))
    y = np.where(rng.random((S, T)) < rate,
                 np.round(rng.exponential(size, (S, T))) + 1, 0.0)
    mask = (rng.random((S, T)) > 0.08).astype(np.float32)
    y[2] = 0.0
    mask[3] = 0.0
    mask[4, T - 50:] = 0.0
    y[5, T - 100:] = 0.0
    mask[6, ::3] = 0.5
    return (y * mask).astype(np.float32), mask


def _line(S=12, T=360, seed=1):
    """A theta line (trend, weekly cycle, noise), a late-starting row, an
    all-zero row and a fully masked row."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    z = (rng.uniform(5, 30, (S, 1)) + 0.03 * t[None]
         + 3 * np.sin(2 * np.pi * t / 7)[None] + rng.normal(0, 1.5, (S, T)))
    mask = (rng.random((S, T)) > 0.07).astype(np.float32)
    mask[1, :150] = 0.0
    z[2] = 0.0
    mask[3] = 0.0
    return (z * mask).astype(np.float32), mask


def _tm(a):
    """A (S, T) numpy array as a time-major (T, S) tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).T))


def _croston_carry(y, mask, variant):
    """The fit's initial carries for numpy y, mask (S, T)."""
    return tcr.initial_carry(torch.from_numpy(y), torch.from_numpy(mask),
                             variant)


def _same(a, b):
    return torch.equal(torch.nan_to_num(a, nan=7.0),
                       torch.nan_to_num(b, nan=7.0)) and torch.equal(
        a.isnan(), b.isnan())


# -- wrappers and twins, bitwise -----------------------------------------------

@pytest.mark.parametrize("sums", [False, True], ids=["fit", "sums"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_croston_wrapper_on_the_cpu_is_the_twin(variant, sums):
    y, mask = _demand(T=80)
    y[7, 10] = np.nan
    carry = _croston_carry(y, mask, variant)
    S = y.shape[0]
    s0 = (torch.rand(S), torch.full((S,), 2.0)) if sums else None
    before = ses.croston_filter.launches
    got = ses.croston_filter(_tm(y), _tm(mask), carry, 0.2, variant, 0.3,
                             sums=s0)
    want = ses.croston_filter_reference(_tm(y), _tm(mask), carry, 0.2,
                                        variant, 0.3, sums=s0)
    assert ses.croston_filter.launches == before  # the twin never counts
    flat = lambda r: [r[0], *r[1], *(r[2] or ())]  # noqa: E731
    assert all(_same(a, b) for a, b in zip(flat(got), flat(want)))
    assert (got[2] is None) == (not sums)


@pytest.mark.parametrize("shared", [True, False], ids=["A7", "A1"])
def test_ses_wrapper_on_the_cpu_is_the_twin(shared):
    z, mask = _line(T=90)
    S = z.shape[0]
    l0 = torch.arange(S, dtype=torch.float32)
    if shared:
        alpha = torch.tensor(ALPHAS)[None].expand(S, 7).contiguous()
        scored = None
    else:
        alpha = torch.tensor(ALPHAS)[torch.arange(S) % 7][:, None]
        g = torch.Generator().manual_seed(2)
        scored = (torch.rand(90, S, generator=g), torch.rand(90, S, generator=g),
                  torch.rand(90, S, generator=g) + 0.5, 2.0, torch.zeros(S),
                  torch.zeros(S))
    got = ses.ses_filter(_tm(z), _tm(mask), l0, alpha, scored=scored)
    want = ses.ses_filter_reference(_tm(z), _tm(mask), l0, alpha,
                                    scored=scored)
    got, want = ((got,), (want,)) if scored is None else (got, want)
    assert all(_same(a, b) for a, b in zip(got, want))


def test_the_fits_run_the_twins():
    """``croston.fit`` and ``theta.ses_paths`` hand the filters the fit's
    own carries: their outputs are the twins' on those carries."""
    y, mask = _demand()
    for variant in VARIANTS:
        cfg = tcr.CrostonConfig(variant=variant)
        p = tcr.fit(torch.from_numpy(y), torch.from_numpy(mask),
                    torch.arange(y.shape[1]), cfg)
        path, carry, _ = ses.croston_filter_reference(
            _tm(y), _tm(mask), _croston_carry(y, mask, variant), cfg.alpha,
            variant, cfg.beta)
        assert torch.equal(p.fitted, path.t())
        assert torch.equal(p.z_level, carry[0])
        want_p = (1.0 / torch.clamp_min(carry[1], 1e-6) if variant == "tsb"
                  else carry[1])
        assert torch.equal(p.p_level, want_p)
    z, m = _line()
    buf = tth.ses_paths(torch.from_numpy(z), torch.from_numpy(m),
                        torch.tensor(ALPHAS))
    assert buf.shape == (z.shape[1] + 1, z.shape[0], 7)
    zt, mt = torch.from_numpy(z), torch.from_numpy(m)
    want = ses.ses_filter_reference(
        _tm(z), _tm(m), tth.head_level(zt, mt),
        torch.tensor(ALPHAS)[None].expand(z.shape[0], 7).contiguous())
    assert torch.equal(buf, want)


# -- twins against the reference's scans --------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_croston_twin_matches_the_reference_scan(variant):
    y, mask = _demand(seed=3)
    S, T = y.shape
    day = np.arange(17_000, 17_000 + T, dtype=np.int32)
    cfg = jcr.CrostonConfig(variant=variant)
    jp = jcr.fit(jnp.asarray(y), jnp.asarray(mask), jnp.asarray(day), cfg)
    path, carry, (sse, n) = ses.croston_filter_reference(
        _tm(y), _tm(mask), _croston_carry(y, mask, variant), cfg.alpha,
        variant, cfg.beta, sums=(torch.zeros(S), torch.zeros(S)))
    p = (1.0 / torch.clamp_min(carry[1], 1e-6) if variant == "tsb"
         else carry[1])
    sigma = torch.sqrt(sse / torch.clamp_min(n, 1.0))
    scale = float(np.abs(y).max())
    for what, got, want in (("fitted", path.t(), jp.fitted),
                            ("z", carry[0], jp.z_level),
                            ("p", p, jp.p_level), ("sigma", sigma, jp.sigma)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=CROSTON_RTOL, atol=1e-6 * scale,
                                   err_msg=what)


def test_ses_twin_matches_the_reference_scan_for_every_alpha():
    z, mask = _line(seed=4)
    S, T = z.shape
    alphas = jnp.asarray(ALPHAS, jnp.float32)
    preds, levels = jax.vmap(lambda zs, ms: jax.vmap(
        lambda a: jth._ses_path(zs, ms, a))(alphas))(jnp.asarray(z),
                                                     jnp.asarray(mask))
    buf = tth.ses_paths(torch.from_numpy(z), torch.from_numpy(mask),
                        torch.tensor(ALPHAS))
    scale = max(float(np.abs(z).max()), 1.0)
    np.testing.assert_allclose(buf[:-1].permute(1, 2, 0).numpy(),
                               np.asarray(preds), rtol=THETA_RTOL,
                               atol=THETA_RTOL * scale, err_msg="paths")
    np.testing.assert_allclose(buf[-1].numpy(), np.asarray(levels),
                               rtol=THETA_RTOL, atol=THETA_RTOL * scale,
                               err_msg="levels")


def _new_columns(seed, S, k):
    y, mask = _demand(S=S, T=k, seed=seed)
    mask[:, 2:4] = 0.0  # gap days
    return y, mask


@pytest.mark.parametrize("variant", VARIANTS)
def test_croston_update_twin_matches_the_reference_update(variant):
    """From the reference's fit and carries: the twin's rates, carries and
    sums over 11 new columns against the reference's ``update_state``."""
    y, mask = _demand(seed=5, T=200)
    S, T = y.shape
    k = 11
    y_new, m_new = _new_columns(6, S, k)
    cfg = jcr.CrostonConfig(variant=variant)
    day = jnp.arange(T, dtype=jnp.int32)
    jp = jcr.fit(jnp.asarray(y), jnp.asarray(mask), day, cfg)
    jaux = jcr.init_update_aux(jp, y=jnp.asarray(y), mask=jnp.asarray(mask))
    jp2, jaux2, jpreds = jcr.update_state(
        jp, jaux, jnp.asarray(y_new), jnp.asarray(m_new), jnp.ones(k),
        jnp.arange(T, T + k, dtype=jnp.int32), cfg)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    carry = ((t(jp.z_level), t(jaux["b"])) if variant == "tsb"
             else (t(jp.z_level), t(jp.p_level), t(jaux["q"])))
    path, carry, (sse, n) = ses.croston_filter_reference(
        _tm(y_new), _tm(m_new), carry, cfg.alpha, variant, cfg.beta,
        sums=(t(jaux["sse"]), t(jaux["n_obs"])))
    scale = float(np.abs(y).max())
    close = lambda got, want, what: np.testing.assert_allclose(  # noqa: E731
        got.numpy(), np.asarray(want), rtol=CROSTON_RTOL, atol=1e-6 * scale,
        err_msg=what)
    close(path.t(), jpreds, "rates")
    close(carry[0], jp2.z_level, "z")
    close(sse, jaux2["sse"], "sse")
    np.testing.assert_array_equal(n.numpy(), np.asarray(jaux2["n_obs"]))
    if variant == "tsb":
        close(carry[1], jaux2["b"], "b")
    else:
        close(carry[1], jp2.p_level, "p")
        np.testing.assert_array_equal(carry[2].numpy(), np.asarray(jaux2["q"]))


def test_theta_update_twin_matches_the_reference_update():
    """From the reference's theta fit: the scored twin (one alpha a row)
    over 11 new columns, its inputs formed as the reference's
    ``update_state`` forms them, against that update."""
    z, mask = _line(seed=7, T=210)
    y = np.abs(z)
    S, T = y.shape
    k = 11
    y_new = np.abs(_line(seed=8, T=k)[0]) + 1.0
    m_new = np.ones((S, k), np.float32)
    m_new[:, 3:5] = 0.0
    m_new[3] = 0.0
    cfg = jth.ThetaConfig()
    day = np.arange(17_000, 17_000 + T, dtype=np.int32)
    day_new = np.arange(17_000 + T, 17_000 + T + k, dtype=np.int32)
    jp = jth.fit(jnp.asarray(y), jnp.asarray(mask), jnp.asarray(day), cfg)
    jaux = jth.init_update_aux(jp, mask=jnp.asarray(mask))
    jp2, jaux2, jpreds = jth.update_state(
        jp, jaux, jnp.asarray(y_new), jnp.asarray(m_new), jnp.ones(k),
        jnp.asarray(day_new), cfg)
    seas, slope, icpt = (np.asarray(a) for a in (jp.seas, jp.slope,
                                                 jp.intercept))
    si = seas[:, day_new % cfg.season_length]
    t = (day_new - day[0]).astype(np.float32)
    trend = icpt[:, None] + slope[:, None] * t[None, :]
    zline = (cfg.theta * (y_new / np.maximum(si, 1e-6))
             + (1.0 - cfg.theta) * trend).astype(np.float32)
    tt = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    buf, fitted, sse, n = ses.ses_filter_reference(
        _tm(zline), _tm(m_new), tt(jp.level), tt(jp.alpha)[:, None],
        scored=(_tm(y_new), _tm(trend.astype(np.float32)),
                _tm(si.astype(np.float32)), cfg.theta, tt(jaux["sse"]),
                tt(jaux["n_obs"])))
    scale = max(float(np.abs(y).max()), 1.0)
    for what, got, want in (("level", buf[-1, :, 0], jp2.level),
                            ("fitted", fitted.t(), jpreds),
                            ("sse", sse, jaux2["sse"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=THETA_RTOL, atol=THETA_RTOL * scale,
                                   err_msg=what)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jaux2["n_obs"]))


# -- work counts ---------------------------------------------------------------

class _CountArithmetic(TorchDispatchMode):
    """Counts the elements written by float32 arithmetic operations (add,
    sub, mul, div; selects, compares and copies not counted)."""

    OPS = {"add", "add_", "sub", "rsub", "mul", "mul_", "div"}

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in self.OPS:
            res = out if isinstance(out, torch.Tensor) else out[0]
            if res.dtype == torch.float32:
                self.ops += res.numel()
        return out


@pytest.mark.parametrize("sums", [False, True], ids=["fit", "sums"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_croston_filter_work_counts_the_twins_operations(variant, sums):
    S, T = 8, 25
    y, mask = _demand(S=S, T=T, seed=9)
    carry = _croston_carry(y, mask, variant)
    yt, mt = _tm(y), _tm(mask)
    s0 = (torch.zeros(S), torch.zeros(S)) if sums else None
    with _CountArithmetic() as c:
        ses.croston_filter_reference(yt, mt, carry, 0.1, variant, 0.1,
                                     sums=s0)
    ops, nbytes = ses.croston_filter_work(S, T, variant, sums)
    assert ops == c.ops
    carries = (2 if variant == "tsb" else 3) + (2 if sums else 0)
    assert nbytes == 4 * (2 * S * T + S * T + 2 * carries * S)
    assert ses.croston_filter_work(500, 1826, "sba") == (
        10 * 500 * 1826, 4 * (3 * 500 * 1826 + 6 * 500))


@pytest.mark.parametrize("scored", [False, True], ids=["A7", "scored"])
def test_ses_filter_work_counts_the_twins_operations(scored):
    S, T = 6, 25
    z, mask = _line(S=S, T=T, seed=10)
    A = 1 if scored else 7
    alpha = torch.tensor(ALPHAS[:A])[None].expand(S, A).contiguous()
    sc = ((_tm(z), _tm(z), _tm(mask) + 1.0, 2.0, torch.zeros(S),
           torch.zeros(S)) if scored else None)
    with _CountArithmetic() as c:
        ses.ses_filter_reference(_tm(z), _tm(mask), torch.zeros(S), alpha,
                                 scored=sc)
    ops, nbytes = ses.ses_filter_work(S, T, A, scored)
    assert ops == c.ops
    want = 2 * S * T + S * A + S + (T + 1) * S * A
    if scored:
        want += 3 * S * T + S * T + 4 * S
    assert nbytes == 4 * want
    assert ses.ses_filter_work(500, 1826, 7) == (
        3 * 7 * 500 * 1826 + 500 * 7,
        4 * (2 * 500 * 1826 + 500 * 7 + 500 + 1827 * 500 * 7))


# -- refusals ------------------------------------------------------------------

def test_the_wrappers_refuse_a_device_other_than_cpu_or_cuda():
    y = torch.empty(5, 4, device="meta")
    carry = tuple(torch.empty(4, device="meta") for _ in range(3))
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        ses.croston_filter(y, y, carry, 0.1, "sba")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        ses.ses_filter(y, y, carry[0], torch.empty(4, 7, device="meta"))


def test_an_unknown_variant_is_refused():
    y, mask = _demand(S=8, T=10)
    with pytest.raises(ValueError, match="unknown CrostonConfig.variant"):
        ses.croston_filter(_tm(y), _tm(mask), _croston_carry(y, mask, "sba"),
                           0.1, "holt")


# -- the kernel source, compiled for the host ----------------------------------

# csrc/ses.cu's kernels need no CUDA feature beyond the launch syntax and
# __ldg: under this shim the host's compiler builds them, each "thread" run
# in turn (the lanes share nothing), so the kernels' block and tail logic
# and their addressing run here against the twins.  Contraction is off
# (-ffp-contract=off), as --fmad=false keeps it off on the card: the host's
# float32 operations round as torch's CPU kernels do.
_SHIM = """
#include <cstddef>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
struct HostDim { unsigned x; };
static HostDim blockIdx, threadIdx;
template <class T> inline T __ldg(const T* p) { return *p; }
typedef int cudaError_t;
typedef void* cudaStream_t;
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "host"; }
template <class F, class... A>
void host_launch(int grid, int block, F f, A... a) {
  for (unsigned b = 0; b < unsigned(grid); ++b)
    for (unsigned t = 0; t < unsigned(block); ++t) {
      blockIdx.x = b;
      threadIdx.x = t;
      f(a...);
    }
}
"""


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """ops/ses's launchers bound to the host build of csrc/ses.cu."""
    import contextlib
    import ctypes
    import os
    import re
    import shutil
    import subprocess

    from distributed_forecasting_tpu_torch.ops import _build

    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    with open(os.path.join(_build.CSRC, "ses.cu")) as f:
        src = f.read()
    src = src.replace("#include <cuda_runtime.h>", _SHIM)
    src = re.sub(r"(\w+_kernel<[^<>]*>)<<<([^,]+), ([^,]+), [^>]*>>>\(",
                 r"host_launch(\2, \3, \1, ", src)
    tmp = tmp_path_factory.mktemp("ses_host")
    (tmp / "ses_host.cpp").write_text(src)
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-o", str(tmp / "libses.so"),
                    str(tmp / "ses_host.cpp")], check=True, timeout=120)
    lib = ctypes.CDLL(str(tmp / "libses.so"))
    for name, n_float in (("croston_filter", 5), ("ses_filter", 2)):
        launch = getattr(lib, f"{name}_launch")
        launch.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 3
                           + [ctypes.c_float] * n_float + [ctypes.c_void_p])
        launch.restype = ctypes.c_int
        getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
    mp = pytest.MonkeyPatch()
    mp.setattr(_build, "library", lambda: lib)
    mp.setattr(ses, "_stream", lambda dev: ctypes.c_void_p(None))
    mp.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    yield ses
    mp.undo()


def _host_case(S, T, seed):
    g = torch.Generator().manual_seed(seed)
    y = torch.round(torch.rand(T, S, generator=g) * 20)
    y = torch.where(torch.rand(T, S, generator=g) < 0.5, 0.0, y)
    m = (torch.rand(T, S, generator=g) > 0.1).float()
    if S > 6 and T > 2:
        y[:, 1] = 0.0
        m[:, 2] = 0.0
        y[T // 2, 3], m[T // 2, 3] = float("nan"), 1.0
        m[::2, 5] = 0.5
    return y, m, g


# T around the blocks of 32 steps (the fit forms) and 8 (theta's scored
# form), and S around the 32-lane blocks
HOST_SHAPES = [(S, T) for S in (1, 7, 33) for T in (0, 1, 2, 31, 32, 33, 65,
                                                    97, 130)]


@pytest.mark.parametrize("S,T", HOST_SHAPES)
def test_the_kernel_source_built_for_the_host_equals_the_twins(host_kernels,
                                                               S, T):
    y, m, g = _host_case(S, T, 100 * S + T)
    for variant, sums in ((v, s) for v in VARIANTS for s in (False, True)):
        carry = (torch.rand(S, generator=g) * 9,
                 torch.rand(S, generator=g) * 3 + 1.0,
                 torch.round(torch.rand(S, generator=g) * 4))
        carry = carry[:2] if variant == "tsb" else carry
        s0 = (torch.rand(S, generator=g), torch.full((S,), 3.0)) if sums \
            else None
        launch, got = host_kernels._croston_filter_launcher(
            y, m, carry, 0.13, variant, 0.21, s0)
        launch()
        want = ses.croston_filter_reference(y, m, carry, 0.13, variant, 0.21,
                                            sums=s0)
        flat = lambda r: [r[0], *r[1], *(r[2] or ())]  # noqa: E731
        assert all(_same(a, b) for a, b in zip(flat(got), flat(want))), \
            (variant, sums)
    z, l0 = y * 1.3 - 2.0, torch.arange(S, dtype=torch.float32)
    alpha = torch.tensor(ALPHAS)[None].expand(S, 7).contiguous()
    launch, got = host_kernels._ses_filter_launcher(z, m, l0, alpha, None)
    launch()
    assert _same(got, ses.ses_filter_reference(z, m, l0, alpha))
    scored = (torch.rand(T, S, generator=g) * 30,
              torch.rand(T, S, generator=g) * 5 + 10,
              torch.rand(T, S, generator=g) + 0.5, 2.0,
              torch.rand(S, generator=g), torch.full((S,), 5.0))
    one = alpha[:, 3:4].contiguous()
    launch, got = host_kernels._ses_filter_launcher(z, m, l0, one, scored)
    launch()
    want = ses.ses_filter_reference(z, m, l0, one, scored=scored)
    assert all(_same(a, b) for a, b in zip(got, want))
