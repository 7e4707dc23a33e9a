"""Universal Kepler solver and two-body propagation, batched and masked.

Port of ``outfit_tpu/kepler/universal.py``:

* preliminary psi guesses in the three regimes (elliptic Newton on
  Kepler's equation, damped hyperbolic Newton, Cardano on Barker's cubic),
* safeguarded Newton on f(psi) = r0*s1 + sig0*s2 + s3 - sqrt(mu)*dt with
  the step clamp, sign-change damping, and the residual-scale acceptance
  beside the relative-step test (``docs/DESIGN.md:412-431``),
* the expanding-bracket bisection fallback (f is monotone, f' = r1 > 0),
* Lagrange f-g propagation and the f-g velocity correction.

The JAX batch-converged ``while_loop``s are Python loops that read the
device once per trip (``done.all()``); done lanes are frozen by masked
``where``s, so a lane's result does not depend on its batch.  Failures are
status codes, not exceptions.

The kernels run in their inputs' precision: float64, or float32 on the
mixed-precision path, where the convergence tolerances are floored at the
working dtype's epsilon as in the JAX package (``_conv``); the absolute
angular-momentum guard of ``velocity_correction`` stays at float64's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from outfit_tpu_torch import trace
from outfit_tpu_torch.constants import GAUSS_GRAV_SQUARED
from outfit_tpu_torch.kepler.angles import principal_angle
from outfit_tpu_torch.kepler.stumpff import halving_count, s_funct
from outfit_tpu_torch.utils.linalg import cross3, norm3
from outfit_tpu_torch.utils.tensors import as_float, as_floats, lanewise

_EPS = torch.finfo(torch.float64).eps

# -- status codes (errors-as-data inside batched kernels) --------------------
OK = 0
STATUS_NO_CONVERGENCE = 1
STATUS_DEGENERATE_STATE = 2
STATUS_UNSTABLE_G = 4


@dataclass(frozen=True)
class SolverConfig:
    """Solver tuning (parity: ``SolverParams``, ``src/kepler/params.rs:24-44``)."""

    convergency: float = 100.0 * float(_EPS)
    max_newton: int = 50
    max_iter_prelim: int = 20
    max_bisection: int = 120
    #: run the bracketing fallback on lanes where Newton failed (SolverKind::Auto)
    auto_fallback: bool = True


def _feps(x) -> float:
    """Machine epsilon of the tensor ``x``'s dtype."""
    return torch.finfo(x.dtype).eps


def _conv(cfg: SolverConfig, x) -> float:
    """Effective convergence tolerance: the configured value, floored at
    100 eps of the working dtype (so float32 lanes can converge)."""
    return max(cfg.convergency, 100.0 * _feps(x))


class KeplerParams(NamedTuple):
    """Batched universal-Kepler inputs; alpha = -1/a = 2E/mu."""

    dt: torch.Tensor
    r0: torch.Tensor
    sig0: torch.Tensor
    mu: torch.Tensor
    alpha: torch.Tensor
    e0: torch.Tensor


class KeplerSolution(NamedTuple):
    psi: torch.Tensor
    s0: torch.Tensor
    s1: torch.Tensor
    s2: torch.Tensor
    s3: torch.Tensor
    converged: torch.Tensor  # bool


# ---------------------------------------------------------------------------
# Preliminary guesses
# ---------------------------------------------------------------------------


def _prelim_elliptic(p: KeplerParams, cfg: SolverConfig):
    """psi guess for alpha < 0.  Parity: ``prelim_elliptic.rs:72-134``."""
    conv = _conv(cfg, p.dt)
    neg_alpha = torch.clamp(-p.alpha, min=_EPS)
    sqrt_na = torch.sqrt(neg_alpha)
    a0 = 1.0 / neg_alpha
    n = torch.sqrt(p.mu) * neg_alpha * sqrt_na

    cos_u0 = (1.0 - p.r0 / a0) / torch.clamp(p.e0, min=_EPS)
    u0 = torch.where(
        torch.abs(cos_u0) <= 1.0,
        torch.arccos(torch.clamp(cos_u0, -1.0, 1.0)),
        torch.where(cos_u0 >= 1.0, torch.zeros_like(cos_u0), math.pi),
    )
    u0 = torch.where(p.sig0 < 0.0, -u0, u0)
    u0 = principal_angle(u0)

    ell0 = principal_angle(u0 - p.e0 * torch.sin(u0))
    target_m = ell0 + n * p.dt  # unwrapped: preserves multi-revolution arcs

    u = target_m
    done = torch.zeros_like(target_m, dtype=torch.bool)
    for _ in range(cfg.max_iter_prelim):
        res = u - p.e0 * torch.sin(u) - target_m
        dres = 1.0 - p.e0 * torch.cos(u)
        step = -res / dres
        un = torch.where(done, u, u + step)
        done = done | (torch.abs(step) < conv * 1e3)
        u = un

    psi = (u - u0) / sqrt_na
    psi_circ = n * p.dt / sqrt_na  # nearly circular orbit
    return torch.where(p.e0 < conv, psi_circ, psi)


def _prelim_hyperbolic(p: KeplerParams, cfg: SolverConfig):
    """psi guess for alpha > 0.  Parity: ``prelim_hyperbolic.rs:47-140``."""
    conv = _conv(cfg, p.dt)
    alpha = torch.clamp(p.alpha, min=_EPS)
    sqrt_a = torch.sqrt(alpha)
    a0 = -1.0 / alpha
    n = torch.sqrt(p.mu) * alpha * sqrt_a

    cosh_f0 = (1.0 - p.r0 / a0) / torch.clamp(p.e0, min=_EPS)
    f0 = torch.where(
        cosh_f0 > 1.0,
        torch.log(
            torch.clamp(cosh_f0, min=1.0)
            + torch.sqrt(torch.clamp(cosh_f0 * cosh_f0 - 1.0, min=0.0))
        ),
        0.0,
    )
    f0 = torch.where(p.sig0 < 0.0, -f0, f0)

    ell0 = p.e0 * lanewise(torch.sinh, f0) - f0
    target_m = ell0 + n * p.dt

    f = torch.zeros_like(target_m)
    done = torch.zeros_like(target_m, dtype=torch.bool)
    for _ in range(cfg.max_iter_prelim):
        small = torch.abs(f) < 15.0
        fs = torch.clamp(f, -15.0, 15.0)
        res = p.e0 * lanewise(torch.sinh, fs) - fs - target_m
        dres = p.e0 * lanewise(torch.cosh, fs) - 1.0
        step = -res / torch.where(torch.abs(dres) > _EPS, dres, _EPS)
        cand = f + step
        newton_f = torch.where(f * cand < 0.0, 0.5 * f, cand)
        fn = torch.where(small, newton_f, 0.5 * f)
        fn = torch.where(done, f, fn)
        done = done | (torch.abs(fn - f) < conv * 1e3)
        f = fn
    return (f - f0) / sqrt_a


def _prelim_parabolic(p: KeplerParams):
    """psi guess for alpha == 0 via Cardano on Barker's cubic.
    Parity: ``prelim_parabolic.rs:264-380``."""
    smdt = torch.sqrt(p.mu) * p.dt

    b = 3.0 * p.sig0
    c = 6.0 * p.r0
    d = -6.0 * smdt
    shift = b / 3.0
    pp = c - b * shift
    qq = 2.0 * shift**3 - c * shift + d

    half_q = qq / 2.0
    disc = half_q * half_q + (pp / 3.0) ** 3

    def cbrt(x):
        return torch.sign(x) * lanewise(torch.pow, torch.abs(x), 1.0 / 3.0)

    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    root_single = cbrt(-half_q + sq) + cbrt(-half_q - sq) - shift

    pp_safe = torch.clamp(pp, max=-_EPS)
    acos_arg = torch.clamp(
        (3.0 * qq) / (2.0 * pp_safe) * torch.sqrt(-3.0 / pp_safe), -1.0, 1.0
    )
    base = torch.arccos(acos_arg) / 3.0
    amp = 2.0 * torch.sqrt(-pp_safe / 3.0)
    roots3 = torch.stack(
        [
            amp * torch.cos(base),
            amp * torch.cos(base - 2.0 * math.pi / 3.0),
            amp * torch.cos(base - 4.0 * math.pi / 3.0),
        ],
        dim=-1,
    ) - shift[..., None]

    def cubic(psi):
        res = psi**3 / 6.0 + p.sig0 / 2.0 * psi**2 + p.r0 * psi - smdt
        der = psi**2 / 2.0 + p.sig0 * psi + p.r0
        return res, der

    lin_est = smdt / torch.clamp(p.r0, min=_EPS)
    der3 = roots3**2 / 2.0 + p.sig0[..., None] * roots3 + p.r0[..., None]
    dist = torch.abs(roots3 - lin_est[..., None])
    any_mono = torch.any(der3 >= 0.0, dim=-1)
    penal = torch.where(any_mono[..., None] & (der3 < 0.0), math.inf, torch.zeros_like(der3))
    pick = torch.argmin(dist + penal, dim=-1)
    root_trig = torch.gather(roots3, -1, pick[..., None])[..., 0]

    psi = torch.where(disc > 0.0, root_single, root_trig)
    for _ in range(2):
        res, der = cubic(psi)
        psi = psi - res / torch.where(torch.abs(der) > _EPS, der, _EPS)
    return torch.where(p.dt == 0.0, 0.0, psi)


def prelim_kepuni(p: KeplerParams, cfg: SolverConfig = SolverConfig()):
    """Initial universal-anomaly guess, selected per lane by the sign of alpha.
    Parity: ``UniversalKeplerParams::prelim_kepuni`` (params.rs:185-191)."""
    psi_e = _prelim_elliptic(p, cfg)
    psi_h = _prelim_hyperbolic(p, cfg)
    psi_p = _prelim_parabolic(p)
    return torch.where(p.alpha < 0.0, psi_e, torch.where(p.alpha > 0.0, psi_h, psi_p))


# ---------------------------------------------------------------------------
# Newton solver + bracketing fallback
# ---------------------------------------------------------------------------


def _residual_and_derivative(psi, p: KeplerParams, k=None, kmax=None):
    s0, s1, s2, s3 = s_funct(psi, p.alpha, k, kmax)
    res = p.r0 * s1 + p.sig0 * s2 + s3 - torch.sqrt(p.mu) * p.dt
    der = p.r0 * s0 + p.sig0 * s1 + s2
    return res, der, (s0, s1, s2, s3)


def _newton(psi0, p: KeplerParams, cfg: SolverConfig):
    """Masked safeguarded Newton with batch-converged exit.

    Parity: ``run_newton`` (newton_solver.rs:240-277).  Each trip reads the
    device once: how many lanes are not done, together with the halving
    bound of the trip's Stumpff evaluation."""
    eps = _feps(p.dt)
    conv = _conv(cfg, p.dt)
    res_tol = 10.0 * eps * (1.0 + torch.abs(torch.sqrt(p.mu) * p.dt))

    psi = psi0
    done = torch.zeros(psi0.shape, dtype=torch.bool, device=psi0.device)
    if psi0.numel() == 0:
        return psi, done
    for _ in range(cfg.max_newton):
        psi_s = torch.where(torch.isfinite(psi), psi, 0.5)
        k = halving_count(psi_s, torch.broadcast_to(p.alpha, psi_s.shape))
        live, kmax = trace.sites.kepler_newton.tolist(torch.stack([(~done).sum(), k.max()]), done.numel())
        if not live:
            break
        res, der, _ = _residual_and_derivative(psi_s, p, k, kmax)

        res_ok = torch.abs(res) <= res_tol
        der_bad = ~torch.isfinite(der) | (torch.abs(der) < 10.0 * eps)

        raw = -res / torch.where(der_bad, 1.0, der)
        mx = 2.0 * (1.0 + torch.abs(psi_s))
        step = torch.clamp(raw, -mx, mx)
        cand = psi_s + step
        cand = torch.where(cand * psi_s < 0.0, 0.5 * psi_s, cand)  # sign-change damping

        new_psi = torch.where(der_bad, 0.5 * psi_s, cand)
        step_conv = (~der_bad) & (torch.abs(step) <= conv * (1.0 + torch.abs(new_psi)))

        psi = torch.where(done | res_ok, psi_s, new_psi)
        done = done | res_ok | step_conv
    return psi, done


def _bisection_fallback(psi0, p: KeplerParams, cfg: SolverConfig, need):
    """Expanding-bracket + bisection on lanes where Newton failed (fixed
    trip counts: 64 expansions, ``cfg.max_bisection`` halvings)."""
    smdt = torch.sqrt(p.mu) * p.dt

    def f(psi):
        _, s1, s2, s3 = s_funct(psi, p.alpha)
        return p.r0 * s1 + p.sig0 * s2 + s3 - smdt

    psi0 = torch.where(torch.isfinite(psi0), psi0, 0.0)
    d = 1.0 + 0.1 * torch.abs(psi0)
    lo, hi = psi0 - d, psi0 + d
    ok = torch.zeros(psi0.shape, dtype=torch.bool, device=psi0.device)
    for _ in range(64):
        flo, fhi = f(lo), f(hi)
        ok_now = (flo <= 0.0) & (fhi >= 0.0)
        lo_n = torch.where(ok | ok_now, lo, torch.where(flo > 0.0, lo - d, lo))
        hi_n = torch.where(ok | ok_now, hi, torch.where(fhi < 0.0, hi + d, hi))
        lo, hi, d, ok = lo_n, hi_n, d * 2.0, ok | ok_now
    bracketed = ok

    for _ in range(cfg.max_bisection):
        mid = 0.5 * (lo + hi)
        fm = f(mid)
        lo, hi = torch.where(fm <= 0.0, mid, lo), torch.where(fm <= 0.0, hi, mid)
    root = 0.5 * (lo + hi)
    return torch.where(need & bracketed, root, psi0), need & bracketed


def solve_kepuni(
    p: KeplerParams,
    cfg: SolverConfig = SolverConfig(),
    psi_guess=None,
) -> KeplerSolution:
    """Solve the universal Kepler equation for every lane.

    Parity: ``solve_kepuni_with_guess`` + the ``SolverKind::Auto`` fallback
    (newton_solver.rs:151, params.rs:130-142).  ``psi_guess``: a warm start,
    or None for :func:`prelim_kepuni`."""
    if psi_guess is None:
        psi0 = prelim_kepuni(p, cfg)
    else:
        psi0 = torch.broadcast_to(as_float(psi_guess, p.dt.device), p.dt.shape)

    psi, converged = _newton(psi0, p, cfg)

    # the bracketing pass runs only when some lane failed (lax.cond)
    if cfg.auto_fallback and not trace.sites.kepler_fallback.item(converged.all()):
        psi_fb, fb_ok = _bisection_fallback(psi0, p, cfg, ~converged)
        psi, converged = torch.where(converged, psi, psi_fb), converged | fb_ok

    s0, s1, s2, s3 = s_funct(psi, p.alpha)
    return KeplerSolution(psi, s0, s1, s2, s3, converged)


# ---------------------------------------------------------------------------
# Two-body propagation (Lagrange f-g)
# ---------------------------------------------------------------------------


class PropagResult(NamedTuple):
    """Parity: ``UniversalPropagResult`` (propagation.rs:13-32)."""

    r1: torch.Tensor  # (..., 3)
    v1: torch.Tensor  # (..., 3)
    f_lag: torch.Tensor
    g_lag: torch.Tensor
    f_dot: torch.Tensor
    g_dot: torch.Tensor
    psi: torch.Tensor
    status: torch.Tensor  # int32, OK == 0


def initial_orbital_state(position, velocity, mu=GAUSS_GRAV_SQUARED):
    """(r0, sig0, alpha, e) from a Cartesian state.
    Parity: ``initial_orbital_state`` (propagation.rs:190-207)."""
    r0 = norm3(position)
    v2 = torch.sum(velocity * velocity, dim=-1)
    sig0 = torch.sum(position * velocity, dim=-1) / math.sqrt(mu)
    alpha = (v2 - 2.0 * mu / r0) / mu
    h2 = torch.sum(cross3(position, velocity) ** 2, dim=-1)
    ecc = torch.sqrt(torch.clamp(1.0 + alpha * h2 / mu, min=0.0))
    return r0, sig0, alpha, ecc


def propagate_universal(
    position,
    velocity,
    t0,
    t1,
    cfg: SolverConfig = SolverConfig(),
    psi_guess=None,
    mu=GAUSS_GRAV_SQUARED,
) -> PropagResult:
    """Propagate Cartesian states (..., 3) from t0 to t1 (broadcastable).
    Parity: ``propagate_universal`` (propagation.rs:114-174).  The epoch
    difference is taken at the epochs' precision, then cast to the states'."""
    position, velocity = as_floats(position, velocity)
    eps = _feps(position)
    r0, sig0, alpha, ecc = initial_orbital_state(position, velocity, mu)
    dt = as_float(t1, position.device) - as_float(t0, position.device)
    dt = torch.broadcast_to(dt.to(position.dtype), r0.shape)

    mu_arr = torch.full_like(r0, mu)
    params = KeplerParams(dt=dt, r0=r0, sig0=sig0, mu=mu_arr, alpha=alpha, e0=ecc)
    sol = solve_kepuni(params, cfg, psi_guess)

    sqrt_mu = torch.sqrt(mu_arr)
    r1 = r0 * sol.s0 + sig0 * sol.s1 + sol.s2

    f = 1.0 - sol.s2 / r0
    g = (r0 * sol.s1 + sig0 * sol.s2) / sqrt_mu
    r1_safe = torch.where(torch.abs(r1) > eps, r1, 1.0)
    f_dot = -(sqrt_mu / (r0 * r1_safe)) * sol.s1
    g_dot = 1.0 - sol.s2 / r1_safe

    pos1 = f[..., None] * position + g[..., None] * velocity
    vel1 = f_dot[..., None] * position + g_dot[..., None] * velocity

    status = torch.where(
        r0 < eps,
        STATUS_DEGENERATE_STATE,
        torch.where(
            ~sol.converged,
            STATUS_NO_CONVERGENCE,
            torch.where(r1 < eps, STATUS_DEGENERATE_STATE, OK),
        ),
    ).to(torch.int32)
    return PropagResult(pos1, vel1, f, g, f_dot, g_dot, sol.psi, status)


# ---------------------------------------------------------------------------
# Lagrange f-g velocity correction
# ---------------------------------------------------------------------------


class VelocityCorrection(NamedTuple):
    v2_corrected: torch.Tensor  # (..., 3)
    f: torch.Tensor
    g: torch.Tensor
    psi: torch.Tensor
    status: torch.Tensor


def velocity_correction(
    x1,
    x2,
    v2,
    dt,
    peri_max,
    ecc_max,
    chi_guess=None,
    eps=1e3 * float(_EPS),
    cfg: SolverConfig | None = None,
) -> VelocityCorrection:
    """Refine v2 from two positions via Lagrange f-g.

    Parity: ``velocity_correction_with_guess`` (velocity.rs:94-209): solve
    the universal Kepler equation from the state at t2 over dt, then
    v2' = (x1 - f*x2)/g with f = 1 - s2/r2, g = dt - s3/sqrt(mu).  As in the
    reference, the eccentricity-control flag only shapes (e, energy); it
    does not reject.
    """
    # imported here: elements.orb_elem imports this package
    from outfit_tpu_torch.elements.orb_elem import eccentricity_control

    if cfg is None:
        cfg = SolverConfig(convergency=eps)
    x1, x2, v2 = as_floats(x1, x2, v2)
    deps = _feps(x2)

    mu = GAUSS_GRAV_SQUARED
    r2 = norm3(x2)
    sig2 = torch.sum(x2 * v2, dim=-1) / math.sqrt(mu)

    h_norm = norm3(cross3(x2, v2))
    # absolute guard (velocity.rs:118), independent of the working dtype
    degenerate = ~torch.isfinite(h_norm) | (h_norm <= 1e6 * _EPS)

    _accepted, ecc, _q, energy = eccentricity_control(x2, v2, peri_max, ecc_max)

    dt = torch.broadcast_to(as_float(dt, x2.device).to(x2.dtype), r2.shape)
    params = KeplerParams(
        dt=dt,
        r0=r2,
        sig0=sig2,
        mu=torch.full_like(r2, mu),
        alpha=2.0 * energy / mu,
        e0=ecc,
    )
    sol = solve_kepuni(params, cfg, chi_guess)

    f = 1.0 - sol.s2 / r2
    g = dt - sol.s3 / math.sqrt(mu)

    g_min = 100.0 * deps * (1.0 + torch.abs(dt))
    g_bad = ~torch.isfinite(g) | (torch.abs(g) < g_min)
    g_safe = torch.where(g_bad, 1.0, g)

    v_corr = (x1 - f[..., None] * x2) / g_safe[..., None]

    status = torch.where(
        degenerate,
        STATUS_DEGENERATE_STATE,
        torch.where(
            ~sol.converged,
            STATUS_NO_CONVERGENCE,
            torch.where(g_bad, STATUS_UNSTABLE_G, OK),
        ),
    ).to(torch.int32)
    return VelocityCorrection(v_corr, f, g, sol.psi, status)
