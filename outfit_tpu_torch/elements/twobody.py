"""Two-body propagation of equinoctial elements with analytic Jacobians.

Port of ``outfit_tpu/elements/twobody.py``:

1. mean motion n = sqrt(mu/a^3); lambda(t1) = lambda0 + n (t1 - t0),
2. generalized Kepler equation F - k sin F + h cos F = lambda(t1), solved by
   a trig-free Newton iteration (tol 100*eps, max 25 iterations),
3. position/velocity from the equinoctial (f, g, w) basis,
4. optional analytic 6x3 Jacobians d(pos)/d(elem), d(vel)/d(elem).

The JAX ``while_loop`` of the Kepler solve is a Python ``while`` on
``done.all()``: one host sync per trip.  Done lanes are frozen exactly as
in the JAX loop, so a lane's result does not depend on the batch.
"""

import math
from typing import NamedTuple

import torch

from outfit_tpu_torch import trace
from outfit_tpu_torch.constants import DPI, GAUSS_GRAV_SQUARED
from outfit_tpu_torch.elements.types import EquinoctialElements
from outfit_tpu_torch.kepler.angles import principal_angle
from outfit_tpu_torch.utils.tensors import as_float, lanewise

_EPS = torch.finfo(torch.float64).eps
#: the Kepler solve's trip cap, and its residual acceptance |F - k sin F +
#: h cos F - lam| <= 1e-12 rad, as in the JAX package (there for emulated
#: f64; here the step test fires first in all but rounding-stall lanes)
MAX_ITER = 25
RES_TOL = 1e-12


class TwoBodyResult(NamedTuple):
    position: torch.Tensor  # (..., 3)
    velocity: torch.Tensor  # (..., 3)
    dpos_delem: torch.Tensor  # (..., 6, 3)
    dvel_delem: torch.Tensor  # (..., 6, 3)
    converged: torch.Tensor  # bool
    anomaly: torch.Tensor  # (...,) generalized eccentric longitude F
    anomaly_sin: torch.Tensor  # sin F (rotation-carried, ~1 ulp)
    anomaly_cos: torch.Tensor  # cos F


# Taylor coefficients of sin/cos for the clamped Newton step (|d| <= 1):
# truncation error below one f64 ulp of the rotation update.
_SIN_C = [
    -1.0 / 6, 1.0 / 120, -1.0 / 5040, 1.0 / 362880, -1.0 / 39916800,
    1.0 / 6227020800, -1.0 / 1307674368000, 1.0 / 355687428096000,
]
_COS_C = [
    -1.0 / 2, 1.0 / 24, -1.0 / 720, 1.0 / 40320, -1.0 / 3628800,
    1.0 / 479001600, -1.0 / 87178291200, 1.0 / 20922789888000,
    -1.0 / 6402373705728000,
]


def _sincos_step(d):
    """sin/cos of a step clamped to |d| <= 1, by Taylor polynomial (Horner)."""
    d2 = d * d
    s = _SIN_C[-1]
    for c in reversed(_SIN_C[:-1]):
        s = s * d2 + c
    s = d * (1.0 + d2 * s)
    c = _COS_C[-1]
    for cc in reversed(_COS_C[:-1]):
        c = c * d2 + cc
    c = 1.0 + d2 * c
    return s, c


def solve_generalized_kepler(
    eq: EquinoctialElements, mean_longitude_t1, max_iter=MAX_ITER, warm=None
):
    """Newton on F - k sin F + h cos F = lambda(t1) from x0 = pi + varpi,
    carrying (sin F, cos F) through the loop by rotation with the step.

    ``warm``: optional (F, sin F, cos F) from a previous solve; F is remapped
    into the current [varpi, varpi + 2pi) window.  Non-finite warm entries
    fall back to the cold start per lane.

    Returns (F, sin F, cos F, converged).
    """
    lam = mean_longitude_t1
    eps = torch.finfo(lam.dtype).eps
    tol = 100.0 * eps
    res_tol = RES_TOL
    shape = lam.shape

    e2 = eq.h**2 + eq.k**2
    circular = e2 <= 100.0 * _EPS
    varpi = torch.where(circular, 0.0, principal_angle(lanewise(torch.atan2, eq.h, eq.k)))
    inv_e = torch.where(circular, 0.0, 1.0 / torch.sqrt(torch.where(circular, 1.0, e2)))
    # x0 = pi + varpi:  sin(x0) = -sin(varpi) = -h/e,  cos(x0) = -k/e
    f = torch.broadcast_to(math.pi + varpi, shape)
    s = torch.broadcast_to(-eq.h * inv_e, shape)
    c = torch.broadcast_to(torch.where(circular, -1.0, -eq.k * inv_e), shape)
    if warm is not None:
        fw, sw, cw = warm
        ok = torch.isfinite(fw) & torch.isfinite(sw) & torch.isfinite(cw)
        fw_safe = torch.where(ok, fw, 0.0)
        fw_mapped = varpi + torch.remainder(fw_safe - varpi, DPI)
        f = torch.where(ok, fw_mapped, f)
        s = torch.where(ok, sw, s)
        c = torch.where(ok, cw, c)

    done = torch.zeros(shape, dtype=torch.bool, device=lam.device)
    it = 0
    while it < max_iter and trace.sites.twobody_kepler.live_lanes(~done):
        res = f - eq.k * s + eq.h * c - lam
        der = 1.0 - eq.k * c - eq.h * s
        raw = -res / torch.where(torch.abs(der) > eps, der, eps)
        step = torch.clamp(raw, -1.0, 1.0)
        sd, cd = _sincos_step(step)
        fn = torch.where(done, f, f + step)
        sn = torch.where(done, s, s * cd + c * sd)
        cn = torch.where(done, c, c * cd - s * sd)
        done = done | (torch.abs(raw) <= tol) | (torch.abs(res) <= res_tol)
        f, s, c = fn, sn, cn
        it += 1
    # first-order renormalization of the rotation drift
    scale = 0.5 * (3.0 - (s * s + c * c))
    return f, s * scale, c * scale, done


def propagate_twobody(
    eq: EquinoctialElements,
    t0,
    t1,
    compute_derivatives: bool = True,
    mu: float = GAUSS_GRAV_SQUARED,
    kepler_warm=None,
    kepler_solution=None,
) -> TwoBodyResult:
    """Propagate equinoctial elements to t1 (Cartesian state + partials).

    ``kepler_warm``: optional (F, sin F, cos F) warm start for the Kepler
    solve (the differential-correction loop passes the previous iteration's).
    ``kepler_solution``: optional (F, sin F, cos F) that skips the solve (the
    mixed-precision Jacobian pass reuses the float64 solution).

    The elements' dtype is the working precision; the epoch difference is
    taken at the epochs' own precision (float64 MJDs) and then cast to it.
    """
    a = eq.semi_major_axis
    h, k, p, q = eq.h, eq.k, eq.p, eq.q
    t1 = as_float(t1, a.device)
    dt = torch.broadcast_to(
        t1 - as_float(t0, a.device), torch.broadcast_shapes(a.shape, t1.shape)
    ).to(a.dtype)

    n = torch.sqrt(mu / a**3)
    lam1 = eq.mean_longitude + n * dt

    e2 = h * h + k * k
    varpi = torch.where(e2 > 100.0 * _EPS, principal_angle(lanewise(torch.atan2, h, k)), 0.0)
    lam1 = principal_angle(lam1)
    lam1 = torch.where(lam1 < varpi, lam1 + DPI, lam1)

    if kepler_solution is not None:
        F, sF, cF = (torch.broadcast_to(v, lam1.shape).to(a.dtype) for v in kepler_solution)
        converged = torch.isfinite(F) & torch.isfinite(sF) & torch.isfinite(cF)
    else:
        F, sF, cF, converged = solve_generalized_kepler(eq, lam1, warm=kepler_warm)

    # --- in-plane coordinates ------------------------------------------------
    beta = 1.0 / (1.0 + torch.sqrt(torch.clamp(1.0 - e2, min=0.0)))
    bhk = beta * h * k

    xe = a * ((1.0 - beta * h * h) * cF + bhk * sF - k)
    ye = a * ((1.0 - beta * k * k) * sF + bhk * cF - h)

    u = 1.0 + p * p + q * q
    inv_u = 1.0 / u
    common = 2.0 * p * q * inv_u
    f_vec = torch.stack(
        torch.broadcast_tensors(
            (1.0 - p * p + q * q) * inv_u, common, -2.0 * p * inv_u
        ),
        dim=-1,
    )
    g_vec = torch.stack(
        torch.broadcast_tensors(
            common, (1.0 + p * p - q * q) * inv_u, 2.0 * q * inv_u
        ),
        dim=-1,
    )

    pos = xe[..., None] * f_vec + ye[..., None] * g_vec

    r = torch.sqrt(xe * xe + ye * ye)
    v_const = n * a * a / r
    v_xe = v_const * (bhk * cF - (1.0 - beta * h * h) * sF)
    v_ye = v_const * ((1.0 - beta * k * k) * cF - bhk * sF)
    vel = v_xe[..., None] * f_vec + v_ye[..., None] * g_vec

    if not compute_derivatives:
        zero = torch.zeros(pos.shape[:-1] + (6, 3), dtype=pos.dtype, device=pos.device)
        return TwoBodyResult(pos, vel, zero, zero, converged, F, sF, cF)

    # --- analytic partials ---------------------------------------------------
    w_vec = torch.stack(
        torch.broadcast_tensors(
            2.0 * p * inv_u, -2.0 * q * inv_u, (1.0 - p * p - q * q) * inv_u
        ),
        dim=-1,
    )
    inv_r = 1.0 / r
    inv_1b = 1.0 / (1.0 - beta)
    b3 = beta**3

    tmp1 = lam1 - F
    tmp2 = beta + h * h * b3 * inv_1b
    tmp3 = h * k * b3 * inv_1b
    tmp4 = beta * h - sF
    tmp5 = beta * k - cF
    tmp6 = beta + k * k * b3 * inv_1b
    tmp7 = 1.0 - r / a
    tmp8 = sF - h
    tmp9 = cF - k
    tmp10 = a * cF * inv_r
    tmp11 = a * sF * inv_r
    tmp12 = n * a * a * inv_r

    dtv = dt

    # position partials
    dpos1 = (pos - 1.5 * vel * dtv[..., None]) / a[..., None]
    dx1 = -a * (tmp1 * tmp2 + a * cF * tmp4 * inv_r)
    dx2 = a * (tmp1 * tmp3 - 1.0 + a * cF * tmp5 * inv_r)
    dpos2 = dx1[..., None] * f_vec + dx2[..., None] * g_vec
    dx1 = -a * (tmp1 * tmp3 + 1.0 - a * sF * tmp4 * inv_r)
    dx2 = a * (tmp1 * tmp6 - a * sF * tmp5 * inv_r)
    dpos3 = dx1[..., None] * f_vec + dx2[..., None] * g_vec
    dpos4 = (
        2.0
        * (q[..., None] * (ye[..., None] * f_vec - xe[..., None] * g_vec)
           - xe[..., None] * w_vec)
        * inv_u[..., None]
    )
    dpos5 = (
        2.0
        * (p[..., None] * (-ye[..., None] * f_vec + xe[..., None] * g_vec)
           + ye[..., None] * w_vec)
        * inv_u[..., None]
    )
    dpos6 = vel / n[..., None]

    # velocity partials
    dvel1 = -(vel - 3.0 * mu * pos * dtv[..., None] / (r**3)[..., None]) / (
        2.0 * a[..., None]
    )
    dv1 = tmp12 * (tmp7 * tmp2 + a * a * tmp8 * tmp4 * inv_r**2 + tmp10 * cF)
    dv2 = -tmp12 * (tmp7 * tmp3 + a * a * tmp8 * tmp5 * inv_r**2 - tmp10 * sF)
    dvel2 = dv1[..., None] * f_vec + dv2[..., None] * g_vec
    dv1 = tmp12 * (tmp7 * tmp3 + a * a * tmp9 * tmp4 * inv_r**2 - tmp11 * cF)
    dv2 = -tmp12 * (tmp7 * tmp6 + a * a * tmp9 * tmp5 * inv_r**2 + tmp11 * sF)
    dvel3 = dv1[..., None] * f_vec + dv2[..., None] * g_vec
    dvel4 = (
        2.0
        * (q[..., None] * (v_ye[..., None] * f_vec - v_xe[..., None] * g_vec)
           - v_xe[..., None] * w_vec)
        * inv_u[..., None]
    )
    dvel5 = (
        2.0
        * (p[..., None] * (-v_ye[..., None] * f_vec + v_xe[..., None] * g_vec)
           + v_ye[..., None] * w_vec)
        * inv_u[..., None]
    )
    dvel6 = -(n * a**3)[..., None] * pos * (inv_r**3)[..., None]

    dpos = torch.stack(
        torch.broadcast_tensors(dpos1, dpos2, dpos3, dpos4, dpos5, dpos6), dim=-2
    )
    dvel = torch.stack(
        torch.broadcast_tensors(dvel1, dvel2, dvel3, dvel4, dvel5, dvel6), dim=-2
    )
    return TwoBodyResult(pos, vel, dpos, dvel, converged, F, sF, cF)
