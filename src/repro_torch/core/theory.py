"""Convergence-rate theory of the paper, as executable formulas (port of
``repro/core/theory.py``).

Everything the theorems need: rho, rho_2, eigenvalue extremes (exact for
small n, Lanczos for large), the rate factors nu_tau(beta) / omega_tau(beta)
/ chi, the optimal step size beta~ = 1/(1+2 rho tau), and bound curves that
the tests check measured error against.

Matrix functions take tensors and compute on their device, returning
0-dim tensors as the reference returns arrays; the scalar formulas take
and return Python numbers.  ``lanczos_extreme_eigs`` takes a
``torch.Generator`` (or the start vector ``v0``) where the reference takes
a ``jax.random`` key: a different stream, so the tests hand the port the
reference's start vector.
"""
from __future__ import annotations

import math

import torch


def rho(A: torch.Tensor) -> torch.Tensor:
    """rho = max_l (1/n) sum_r |A_lr|   (Thm 4.1)."""
    n = A.shape[0]
    return A.abs().sum(1).max() / n


def rho2(A: torch.Tensor) -> torch.Tensor:
    """rho_2 = max_l (1/n) sum_r A_lr^2   (Thm 6.1)."""
    n = A.shape[0]
    return (A * A).sum(1).max() / n


def block_rho(A: torch.Tensor, block: int) -> torch.Tensor:
    """Block generalization of rho for the block iteration: the max over
    block-rows of the mean absolute block-coupling.  Reduces to rho when
    block == 1."""
    n = A.shape[0]
    nb = n // block
    Ab = A.abs().reshape(nb, block, nb, block).sum(dim=(1, 3)) / block
    return Ab.sum(1).max() / nb


def extreme_eigs_dense(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    ev = torch.linalg.eigvalsh(A)
    return ev[0], ev[-1]


def lanczos_extreme_eigs(A: torch.Tensor, *,
                         generator: torch.Generator | None = None,
                         v0: torch.Tensor | None = None, iters: int = 64):
    """Lanczos estimate of (lam_min, lam_max) for large A (no full eigh).

    Full reorthogonalization against all ``iters + 1`` Lanczos vectors
    (iters is small); returns Ritz extremes.  The start vector is ``v0``
    when given, else a normal draw of ``generator`` on A's device.  Every
    step stays on the device: no value is read back to the host.
    """
    n = A.shape[0]
    if v0 is None:
        if generator is None:
            raise ValueError("lanczos_extreme_eigs needs a generator or v0")
        v0 = torch.randn((n,), generator=generator, dtype=A.dtype,
                         device=A.device)
    v0 = v0.to(A.device, A.dtype)
    v0 = v0 / torch.linalg.vector_norm(v0)
    V = torch.zeros((iters + 1, n), dtype=A.dtype, device=A.device)
    V[0] = v0
    alphas = torch.zeros((iters,), dtype=A.dtype, device=A.device)
    betas = torch.zeros((iters,), dtype=A.dtype, device=A.device)
    for i in range(iters):
        v = V[i]
        w = A @ v
        alpha = v @ w
        w = w - alpha * v
        if i > 0:
            w = w - betas[i - 1] * V[i - 1]
        # full reorthogonalization
        w = w - V.T @ (V @ w)
        beta = torch.linalg.vector_norm(w)
        V[i + 1] = torch.where(beta > 1e-12, w / beta, 0.0)
        alphas[i] = alpha
        betas[i] = beta
    T = (torch.diag(alphas) + torch.diag(betas[:-1], 1)
         + torch.diag(betas[:-1], -1))
    ev = torch.linalg.eigvalsh(T)
    return ev[0], ev[-1]


# ---------------------------------------------------------------------------
# Rate factors
# ---------------------------------------------------------------------------

def nu_tau(rho_val: float, tau: int, beta: float = 1.0) -> float:
    """Sec. 5: nu_tau(beta) = 2 beta - beta^2 - 2 rho tau beta^2.
    beta = 1 recovers Thm 4.1's nu_tau = 1 - 2 rho tau."""
    return 2 * beta - beta**2 - 2 * rho_val * tau * beta**2


def beta_opt(rho_val: float, tau: int) -> float:
    """Optimal step size beta~ = 1/(1 + 2 rho tau); nu_tau(beta~) = beta~."""
    return 1.0 / (1.0 + 2.0 * rho_val * tau)


def omega_tau(rho2_val: float, tau: int, beta: float) -> float:
    """Thm 6.1: omega_tau(beta) = beta (1 - beta - rho_2 tau^2 beta / 2)."""
    return beta * (1.0 - beta - rho2_val * tau**2 * beta / 2.0)


def beta_opt_inconsistent(rho2_val: float, tau: int) -> float:
    """argmax_beta omega_tau(beta) = 1 / (2 + rho_2 tau^2)."""
    return 1.0 / (2.0 + rho2_val * tau**2)


def _check_lam_max(lam_max: float, n: int, where: str) -> None:
    """Both epoch formulas need 0 < lam_max/n < 1 (they take logs/negative
    powers of 1 - lam_max/n).  lam_max == n is reachable for a valid
    unit-diagonal SPD matrix (the all-ones rank-one-plus-identity family
    pushes lam_max -> n), where the expressions degenerate, so reject with
    the actual constraint instead."""
    if not 0.0 < lam_max < n:
        raise ValueError(
            f"{where} needs 0 < lam_max < n (got lam_max={lam_max}, "
            f"n={n}): the epoch length ~ log(1/2)/log(1 - lam_max/n) is "
            "undefined at the boundary — lam_max = n means a single "
            "coordinate step can solve the dominant mode, so no epoch "
            "analysis applies")


def chi_consistent(rho_val: float, tau: int, lam_max: float, n: int,
                   beta: float = 1.0) -> float:
    _check_lam_max(lam_max, n, "chi_consistent")
    dmax = 1.0 - lam_max / n
    return rho_val * tau**2 * beta**2 * lam_max * dmax ** (-2 * tau) / n


def epoch_len(lam_max: float, n: int) -> int:
    """T0 = ceil(log(1/2) / log(1 - lam_max/n)) ~= 0.693 n / lam_max."""
    _check_lam_max(lam_max, n, "epoch_len")
    return int(math.ceil(math.log(0.5) / math.log(1.0 - lam_max / n)))


# ---------------------------------------------------------------------------
# Bound curves (what the tests check against)
# ---------------------------------------------------------------------------

def ll_bound(e0, m, lam_min: float, n: int):
    """Leventhal-Lewis synchronous bound (2): E_m <= (1 - lam_min/n)^m E_0."""
    return (1.0 - lam_min / n) ** m * e0


def thm41a_factor(rho_val, tau, kappa, beta=1.0):
    """Thm 4.1(a)/Sec.5(a): E_m <= (1 - nu_tau(beta)/(2 kappa)) E_0 for
    m >= ~0.693 n / lam_max, assuming nu_tau > 0."""
    return 1.0 - nu_tau(rho_val, tau, beta) / (2.0 * kappa)


def thm61a_factor(rho2_val, tau, kappa, beta):
    """Thm 6.1(a): E_m <= (1 - omega_tau(beta)/kappa) E_0."""
    return 1.0 - omega_tau(rho2_val, tau, beta) / kappa


def iters_to_eps(n: int, lam_min: float, eps: float, delta: float) -> int:
    """Sec. 2.2 Markov bound: m >= (n/lam_min) ln(1/(delta eps^2))."""
    return int(math.ceil(n / lam_min * math.log(1.0 / (delta * eps**2))))


# ---------------------------------------------------------------------------
# Randomized Kaczmarz (Sec. 7: unsymmetric / overdetermined least squares)
# ---------------------------------------------------------------------------
#
# RK with row sampling P(i) = ||A_i||^2 / ||A||_F^2 is RGS run implicitly on
# the normal equations; the analogues of the paper's quantities are built
# from normalized-row coherences <A_l/||A_l||, A_r/||A_r||> in place of the
# unit-diagonal couplings A_lr, and the sampling distribution p_r in place
# of the uniform 1/n.

def rk_row_probs(A: torch.Tensor) -> torch.Tensor:
    """Row sampling distribution p_i = ||A_i||^2 / ||A||_F^2."""
    rn = (A * A).sum(1)
    return rn / rn.sum()


def _coherences(A: torch.Tensor) -> torch.Tensor:
    """The (m, m) Gram matrix of A's normalized rows (the m^2 n part)."""
    Ahat = A / torch.sqrt((A * A).sum(1))[:, None]
    return Ahat @ Ahat.T


def rk_rho(A: torch.Tensor) -> torch.Tensor:
    """RK analogue of rho (Thm 4.1): max_l E_r |<A_l/||A_l||, A_r/||A_r||>|
    under row sampling.  Reduces to the paper's rho when A is square,
    unit-diagonal SPD and sampling is uniform.  O(m^2 n) and an (m, m)
    Gram matrix on A's device: diagnostic / step-size use only."""
    return (_coherences(A).abs_() @ rk_row_probs(A)).max()


def rk_rho2(A: torch.Tensor) -> torch.Tensor:
    """RK analogue of rho_2 (Thm 6.1): max_l E_r <A_l/||A_l||, A_r/||A_r||>^2
    under row sampling (squared coherences, for the inconsistent-read
    rate)."""
    G = _coherences(A)
    return ((G * G) @ rk_row_probs(A)).max()


def rk_factor(A: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Strohmer-Vershynin per-iteration contraction of E||x - x*||^2 for
    (beta-damped) RK on a consistent system:
    1 - beta(2-beta) sigma_min(A)^2 / ||A||_F^2."""
    s = torch.linalg.svdvals(A)
    return 1.0 - beta * (2.0 - beta) * (s[-1] ** 2) / (s ** 2).sum()


def rk_bound(e0, m, factor):
    """Expected-error bound curve: E||x_m - x*||^2 <= factor^m * E_0."""
    return factor**m * e0


def beta_opt_rk(rho_rk: float, tau: int) -> float:
    """Thm-analogous step size for asynchronous RK: beta~ = 1/(1+2 rho_rk
    tau), the paper's beta~ with ``rk_rho`` standing in for rho."""
    return 1.0 / (1.0 + 2.0 * rho_rk * tau)


def async_rk_factor(A: torch.Tensor, tau: int, beta: float,
                    rho_rk: float | None = None) -> torch.Tensor:
    """Per-iteration factor for delay-tau RK: 1 - nu_tau(rho_rk) sigma_min^2
    / ||A||_F^2 — Thm 4.1(a)'s shape with the RK contraction modulus.

    Pass ``rho_rk`` when already computed: ``rk_rho`` costs O(m^2 n)."""
    s = torch.linalg.svdvals(A)
    if rho_rk is None:
        rho_rk = float(rk_rho(A))
    nu = nu_tau(rho_rk, tau, beta)
    return 1.0 - nu * (s[-1] ** 2) / (s ** 2).sum()


# ---------------------------------------------------------------------------
# Perturbed rates — what bounded inexactness (quantized payloads, low-
# precision storage) does to a linear contraction
# ---------------------------------------------------------------------------
#
# If the exact iteration contracts the error norm by sqrt(factor) per step
# and each step injects a relative perturbation eps, the perturbed iteration
# still contracts at (sqrt(factor) + eps)^2 per step (worst case,
# perturbation aligned with the error).  Once sqrt(factor) + eps >= 1 the
# contraction argument gives nothing, hence the min with 1.

def perturbed_factor(factor: float, eps: float) -> float:
    """Per-iteration contraction of the eps-perturbed iteration:
    min(1, (sqrt(max(factor, 0)) + eps)^2)."""
    if eps < 0:
        raise ValueError(f"perturbation bound must be >= 0, got {eps}")
    root = math.sqrt(max(float(factor), 0.0)) + float(eps)
    return min(1.0, root * root)


def iteration_inflation(factor: float, eps: float) -> float:
    """Predicted iterations-to-tolerance ratio (perturbed / exact):
    log(factor) / log(perturbed_factor(factor, eps)).

    Both factors must be contractions (< 1); a degenerate perturbed factor
    (>= 1) returns ``inf``: the bound predicts only an eps-ball floor."""
    f = float(factor)
    if not 0.0 < f < 1.0:
        raise ValueError(f"exact factor must be in (0, 1), got {factor}")
    pf = perturbed_factor(f, eps)
    if pf >= 1.0:
        return math.inf
    return math.log(f) / math.log(pf)
