"""Batched masked ridge solves for the curve model (port of the reference's
``ops/solve.py``).

The curve model's MAP problem is a penalized least squares in the feature
basis, so fitting every series is one batched normal-equation solve:

    (X^T diag(w_s) X + diag(lambda)) beta_s = X^T diag(w_s) y_s

with X the SHARED (T, F) design and only the weights w_s per series.

**The Gram.** ``einsum("st,tf,tg->sfg", w, X, X)`` in PyTorch contracts
pairwise and materializes (S, T, F) — 223 MB at 500 x 1,826 x 61 and 668 MB
at the CV pass's 1,500 rows.  :func:`masked_gram` builds the same G as ONE
GEMM of the weights with the symmetric half of the row-wise Kronecker table
of the shared design, ``w (S, T) @ KR (T, F(F+1)/2)`` (14 MB at F = 61),
then unpacks the (S, F(F+1)/2) result into (S, F, F).  The symmetric half
does half the full table's work (2 S T F(F+1)/2 operations) and the unpack
is one gather of S F^2 floats.  The per-series (S, T, F + R) design of the
per-series regressor path materializes by nature, as in the reference.

**Solve routes**, the reference's own backend split (its ``_use_xla_spd``):

* on the CPU the port runs its copies of the reference's CPU factorizations
  — the floored column Cholesky (:func:`_cholesky_floored`, pivot floor
  ``_CHOL_FLOOR = 1e-12``: a PSD-but-singular system stays finite) and the
  partially pivoted LU (:func:`_solve_lu`) — so the parity tests compare
  like with like;
* on the card, the libraries: cuSOLVER's batched ``potrf``
  (``torch.linalg.cholesky_ex``) and two cuBLAS batched triangular solves
  (``torch.linalg.solve_triangular``) for the SPD systems,
  ``torch.linalg.solve_ex`` for :func:`solve_dense`.  Nothing is called
  with ``check_errors=True``, which would put a host sync in the fit; the
  triangular solves report no status at all (``torch.cholesky_solve``'s
  batched route may check one, so it is not used).  A row whose
  factorization fails (``info != 0``) comes out NaN — never the finite
  garbage of a partly factored L — so the engine's fail-safe
  (``engine/fit.health_fallback``) flags that series, as the reference's
  native ``cho_factor`` route does.

The reference's VMEM chunking of the batched Cholesky is a TPU scoped-memory
concern and is not ported: cuSOLVER takes the whole batch in one call.
"""

from __future__ import annotations

import torch

from distributed_forecasting_tpu_torch.ops.metrics import masked_median

_CHOL_FLOOR = 1e-12  # pivot floor: keeps a PSD-but-singular system finite


def _sym_index(F: int, device):
    """(rows, cols) of the upper triangle (F(F+1)/2 pairs, row-major) and
    the (F, F) map from every (f, g) to its pair's position."""
    iu, ju = torch.triu_indices(F, F, device=device)
    pos = torch.empty((F, F), dtype=torch.long, device=device)
    k = torch.arange(iu.numel(), device=device)
    pos[iu, ju] = k
    pos[ju, iu] = k
    return iu, ju, pos


def masked_gram(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-series Gram matrices ``G[s] = X^T diag(w[s]) X`` with no (S, T, F)
    intermediate.  X: (T, F) shared design; w: (S, T) weights.  Returns
    (S, F, F): one GEMM with the symmetric Kronecker half, then unpacked."""
    F = X.shape[-1]
    iu, ju, pos = _sym_index(F, X.device)
    kr = X[:, iu] * X[:, ju]                       # (T, F(F+1)/2)
    packed = w @ kr                                # (S, F(F+1)/2)
    return packed[:, pos.reshape(-1)].reshape(w.shape[0], F, F)


def gram_work(S: int, T: int, F: int) -> tuple:
    """(float32 operations, bytes) of :func:`masked_gram`'s least work: the
    symmetric half, 2 S T F(F+1)/2 operations; w and X read once, the
    (S, F, F) Gram written once."""
    half = F * (F + 1) // 2
    return 2 * S * T * half, 4 * (S * T + T * F + S * F * F)


def cho_solve_work(S: int, F: int) -> tuple:
    """(float32 operations, bytes) of S Cholesky factorizations and solves
    of (F, F) systems: F^3/3 for the factor, 2 F^2 for the two triangular
    solves; A and b read once, x written once."""
    return S * (F ** 3 // 3 + 2 * F * F), 4 * S * (F * F + 2 * F)


def _cholesky_floored(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of batched small SPD matrices, one column at a time
    (the reference's ``_cholesky_xla``): F steps of batched work, each pivot
    floored at ``_CHOL_FLOOR`` so a PSD-but-singular system stays finite."""
    F = A.shape[-1]
    idx = torch.arange(F, device=A.device)
    L = torch.zeros_like(A)
    for j in range(F):
        c = A[..., :, j] - (L @ L[..., j, :, None])[..., 0]
        d = torch.sqrt(torch.clamp_min(c[..., j], _CHOL_FLOOR))
        L[..., :, j] = torch.where(idx > j, c / d[..., None],
                                   torch.where(idx == j, d[..., None], 0.0))
    return L


def _solve_cholesky_floored(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve batched SPD ``A x = b`` through :func:`_cholesky_floored`:
    forward then back substitution.  A: (..., F, F), b: (..., F)."""
    F = b.shape[-1]
    L = _cholesky_floored(A)
    y = torch.zeros_like(b)
    for j in range(F):
        y[..., j] = (b[..., j] - torch.sum(L[..., j, :] * y, dim=-1)) / L[..., j, j]
    x = torch.zeros_like(b)
    for j in reversed(range(F)):
        x[..., j] = (y[..., j] - torch.sum(L[..., :, j] * x, dim=-1)) / L[..., j, j]
    return x


def _solve_lu(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dense solve by LU with partial pivoting (the reference's
    ``_solve_lu_xla``, its row swaps done with the same one-hot arithmetic).
    Pivoting matters: a Yule-Walker Toeplitz system is not guaranteed
    definite.  A: (..., F, F), b: (..., F)."""
    F = b.shape[-1]
    idx = torch.arange(F, device=A.device)
    U, y = A.clone(), b.clone()
    for j in range(F):
        cand = torch.where(idx >= j, torch.abs(U[..., :, j]), -torch.inf)
        piv1 = torch.nn.functional.one_hot(torch.argmax(cand, dim=-1),
                                           F).to(U.dtype)
        j1 = (idx == j).to(U.dtype)
        row_j = U[..., j, :]
        row_p = (piv1[..., None, :] @ U)[..., 0, :]
        d_row = row_p - row_j
        U = U + j1[:, None] * d_row[..., None, :] - piv1[..., :, None] * d_row[..., None, :]
        yp = torch.sum(piv1 * y, dim=-1)
        d_y = (yp - y[..., j])[..., None]
        y = y + j1 * d_y - piv1 * d_y
        row_j = U[..., j, :]
        yj = y[..., j]
        piv = row_j[..., j]
        piv = torch.where(torch.abs(piv) < _CHOL_FLOOR,
                          torch.where(piv < 0, -_CHOL_FLOOR, _CHOL_FLOOR), piv)
        f = torch.where(idx > j, U[..., :, j] / piv[..., None], 0.0)
        U = U - f[..., :, None] * row_j[..., None, :]
        y = y - f * yj[..., None]
    x = torch.zeros_like(b)
    for j in reversed(range(F)):
        x[..., j] = (y[..., j] - torch.sum(U[..., j, :] * x, dim=-1)) / U[..., j, j]
    return x


def _nan_where_failed(x: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """Rows whose factorization failed (``info != 0``) become NaN."""
    return torch.where((info != 0)[..., None], torch.nan, x)


def solve_dense(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched small dense solve ``A x = b``: the pivoted LU on the CPU,
    cuSOLVER's ``solve_ex`` on the card (failed rows NaN).
    A: (..., F, F), b: (..., F) -> (..., F)."""
    if A.device.type == "cpu":
        return _solve_lu(A, b)
    x, info = torch.linalg.solve_ex(A, b[..., None])
    return _nan_where_failed(x[..., 0], info)


def batched_cho_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the batched SPD systems ``A[s] x[s] = b[s]``: the floored
    column Cholesky on the CPU; on the card ``cholesky_ex`` and two
    triangular solves, with no host sync and failed rows NaN.
    A: (S, F, F), b: (S, F) -> (S, F)."""
    if A.device.type == "cpu":
        return _solve_cholesky_floored(A, b)
    L, info = torch.linalg.cholesky_ex(A)
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]
    return _nan_where_failed(x, info)


def normal_equations(X, y, w, lam, jitter: float = 1e-6):
    """The penalized normal equations ``(A, b)`` of :func:`ridge_solve_batch`:
    A = G + diag(lam + jitter), b = X^T (w y)."""
    F = X.shape[-1]
    if X.dim() == 3:
        G = torch.bmm((X * w[..., None]).transpose(1, 2), X)
        b = torch.bmm((w * y)[:, None, :], X)[:, 0, :]
    else:
        G = masked_gram(X, w)
        b = (w * y) @ X
    lam = torch.as_tensor(lam, dtype=torch.float32, device=X.device)
    eye = torch.eye(F, dtype=X.dtype, device=X.device)
    if lam.dim() == 1:
        D = torch.diag(lam + jitter)[None]
    else:
        D = (lam + jitter)[:, :, None] * eye[None]
    return G + D, b


def ridge_solve_batch(X, y, w, lam, jitter: float = 1e-6) -> torch.Tensor:
    """Solve the batched penalized normal equations.

    X: (T, F) shared design, or (S, T, F) per series (the per-series
    regressor path); y, w: (S, T); lam: per-feature ridge precision, (F,)
    or (S, F).  Returns beta (S, F), through :func:`batched_cho_solve`.
    """
    A, b = normal_equations(X, y, w, lam, jitter)
    return batched_cho_solve(A, b)


def yule_walker_masked(z, m, K: int, per_lag_norm: bool = False,
                       jitter_rel: float = 0.0, jitter_abs: float = 0.0,
                       eps: float = 1e-12):
    """Batched masked Yule-Walker AR(K) solve.  z, m: (S, T).  Returns
    ``(coef (S, K), acov (S, K+1))``: biased (divisor n_0) autocovariances,
    or with ``per_lag_norm`` pairwise-normalized autocorrelations
    (acov_0 = 1).  The Toeplitz system gets ``jitter_rel * acov_0 +
    jitter_abs`` on its diagonal and goes through :func:`solve_dense`."""
    zm = z * m
    if per_lag_norm:
        g0 = torch.sum(zm * zm, dim=1) / torch.clamp_min(torch.sum(m, dim=1), 1.0)
        g0 = torch.clamp_min(g0, eps)
        rows = [torch.ones_like(g0)]
        for k in range(1, K + 1):
            num = torch.sum(zm[:, k:] * zm[:, :-k], dim=1)
            den = torch.clamp_min(torch.sum(m[:, k:] * m[:, :-k], dim=1), 1.0)
            rows.append((num / den) / g0)
    else:
        n0 = torch.clamp_min(torch.sum(m, dim=1), 1.0)
        rows = [torch.sum(zm * zm, dim=1) / n0]
        for k in range(1, K + 1):
            rows.append(torch.sum(zm[:, k:] * zm[:, :-k], dim=1) / n0)
    acov = torch.stack(rows, dim=1)  # (S, K+1)
    ar = torch.arange(K, device=z.device)
    idx = torch.abs(ar[:, None] - ar[None, :])
    eye = torch.eye(K, dtype=z.dtype, device=z.device)[None]
    R = (acov[:, idx] + jitter_rel * acov[:, :1, None] * eye
         + jitter_abs * eye)
    return solve_dense(R, acov[:, 1:K + 1]), acov


def fitted_values(X: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """(S, T) fitted path of a shared (T, F) or per-series (S, T, F)
    design."""
    if X.dim() == 3:
        return torch.bmm(X, beta[:, :, None])[..., 0]
    return beta @ X.T


def weighted_residual_scale(X, y, w, beta) -> torch.Tensor:
    """Per-series residual standard deviation under the weights.  (S,)"""
    r2 = w * (y - fitted_values(X, beta)) ** 2
    n = torch.clamp_min(torch.sum(w, dim=1), 1.0)
    return torch.sqrt(torch.sum(r2, dim=1) / n)


def masked_mad_scale(r: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Robust per-series residual scale, 1.4826 * median(|r|) under the
    mask (consistent for the Gaussian sigma).  (S, T) -> (S,)."""
    return 1.4826 * masked_median(torch.abs(r), mask)


def huber_irls_solve(X, y, mask, lam, delta: float = 1.345, iters: int = 3):
    """Huber-robust penalized regression by IRLS: start from the L2 solve,
    then ``iters`` times weight each point by ``min(1, delta s / |r|)``
    (s the MAD scale of the residuals) and re-solve.  Returns (beta, the
    final (S, T) weights inside the mask)."""
    beta = ridge_solve_batch(X, y, mask, lam)
    w_rob = mask
    for _ in range(int(iters)):
        r = y - fitted_values(X, beta)
        s = torch.clamp_min(masked_mad_scale(r, mask), 1e-9)[:, None]
        a = torch.abs(r) / s
        w_h = torch.where(a <= delta, 1.0, delta / torch.clamp_min(a, 1e-9))
        w_rob = mask * w_h
        beta = ridge_solve_batch(X, y, w_rob, lam)
    return beta, w_rob
