"""Gauss's method of initial orbit determination, in plain PyTorch.

One triplet per row: three epochs (MJD TT), the observed right ascensions
and declinations, and the observer's heliocentric equatorial J2000
positions (AU).  The steps are those of Outfit's ``GaussObs::prelim_orbit``
(``src/initial_orbit_determination/gauss.rs``):

1. the scaled intervals tau1 = k (t1 - t2), tau3 = k (t3 - t2), the matrix S
   of the three lines of sight and its inverse, and the vectors
   a = (tau3 / tau13, -1, -tau1 / tau13),
   b = (a1 (tau13^2 - tau3^2) / 6, 0, a3 (tau13^2 - tau1^2) / 6);
2. the eighth-degree polynomial r2^8 + c6 r2^6 + c3 r2^3 + c0 in the central
   heliocentric distance (``coeff_eight_poly``);
3. its roots, real (|Im| under a tolerance) and positive inside
   [``R2_MIN_AU``, ``R2_MAX_AU``], the ``MAX_TESTED_SOLUTIONS`` smallest
   kept;
4. per root, c = (a1 + b1 / r2^3, -1, a3 + b3 / r2^3), the ranges
   rho = -(S^-1 sum c_j R_j) / c, rejected under ``MIN_RHO2_AU`` at the
   centre, the positions R_j + rho_j u_j, the epoch t2 - rho2 / c_light,
   Gibbs's velocity at the centre, and the eccentricity control (e <
   ``MAX_ECC``, perihelion < ``MAX_PERIHELION_AU``, nonzero angular
   momentum);
5. the two-sided Lagrange f-g refinement (``pos_and_vel_correction``): from
   the central state, f and g towards each side by a universal-variable
   Kepler solve; the new velocity is the mean of (x_j - f_j x2) / g_j over
   the sides, the new c = (g3 / D, -1, -g1 / D) with D = f1 g3 - f3 g1 gives
   the new ranges, positions and epoch; a step that fails the eccentricity
   control or the range floor ends the refinement of that root as not
   corrected; the refinement stops when the positions move by at most
   ``NEWTON_EPS`` relative.

The settings are Outfit's defaults, module constants named after the
``IODParams`` fields that hold them.

Departures from Outfit, each of no consequence for a converged answer:

* the roots come from the eigenvalues of the polynomial's companion matrix
  (``torch.linalg.eigvals``), not from Aberth's iteration, so there is no
  Descartes prefilter and no iteration cap;
* the Kepler solve is Curtis's universal-anomaly form (Stumpff C and S of
  z = alpha chi^2), by Newton steps from the previous refinement's anomaly
  (first from sqrt(mu) |alpha| dt), capped at a tenth of an orbit each; the
  f and g it gives are the same functions of dt as Outfit's Goodyear form;
* the refinement runs at most ``NEWTON_MAX_IT`` trips with a per-root done
  mask in place of the batch's early exit;
* the candidate kept per row is chosen by :func:`best_candidate` over the
  caller's scoring, corrected roots first, then the least RMS, as Outfit's
  ``prelim_orbit`` chooses;
* epochs stay float64 and only their differences enter the working
  precision (the dtype of the angles), so a float32 call is a float32
  computation of everything but the absolute epochs.
"""

import math
from typing import NamedTuple

import torch

from portbench.reference.ephem import equatorial_to_ecliptic
from portbench.reference.twobody import C_AU_DAY, MU

#: Gaussian gravitational constant, AU^(3/2) / day
K_GAUSS = math.sqrt(MU)
#: ``IODParams.max_tested_solutions``: the roots kept per triplet
MAX_TESTED_SOLUTIONS = 3
#: ``IODParams.r2_min_au``, ``r2_max_au``: the central distance's bracket, AU
R2_MIN_AU, R2_MAX_AU = 0.05, 200.0
#: ``IODParams.min_rho2_au``: the central range's floor, AU
MIN_RHO2_AU = 0.01
#: ``IODParams.max_ecc``, ``max_perihelion_au``: the eccentricity control
MAX_ECC, MAX_PERIHELION_AU = 5.0, 1e3
#: ``IODParams.newton_max_it``: trips of the f-g refinement
NEWTON_MAX_IT = 50
#: ``IODParams.newton_eps``: the relative move of the positions that ends it
NEWTON_EPS = 1e-10
#: ``IODParams.root_imag_eps``: the imaginary part under which a root is real
ROOT_IMAG_EPS = 1e-6
#: Newton steps of the universal Kepler solve at most (the reference's own
#: cap: it stops at 1e3 eps relative, as ``IODParams.kepler_eps``)
KEPLER_MAX_IT = 100


class Candidates(NamedTuple):
    """Per (row, root): positions at the three epochs (R, M, 3, 3), the
    central velocity (R, M, 3), the light-time epoch (R, M) float64, the
    root r2, and whether the root passed the acceptance (``valid``) and the
    refinement (``corrected``)."""

    pos: torch.Tensor
    vel: torch.Tensor
    epoch: torch.Tensor
    r2: torch.Tensor
    valid: torch.Tensor
    corrected: torch.Tensor


def unit_vectors(ra, dec):
    cd = torch.cos(dec)
    return torch.stack([cd * torch.cos(ra), cd * torch.sin(ra), torch.sin(dec)], dim=-1)


def polynomial(tau1, tau3, s_inv, s_mat, obs_pos):
    """(a, b, c0, c3, c6) of the eighth-degree polynomial."""
    tau13 = tau3 - tau1
    a = torch.stack([tau3 / tau13, -torch.ones_like(tau1), -tau1 / tau13], dim=-1)
    b = torch.stack([a[..., 0] * (tau13**2 - tau3**2) / 6, torch.zeros_like(tau1),
                     a[..., 2] * (tau13**2 - tau1**2) / 6], dim=-1)
    ra_vec = (a[..., None] * obs_pos).sum(-2)
    rb_vec = (b[..., None] * obs_pos).sum(-2)
    a2 = (s_inv[..., 1, :] * ra_vec).sum(-1)
    b2 = (s_inv[..., 1, :] * rb_vec).sum(-1)
    r2 = obs_pos[..., 1, :]
    s2r2 = (s_mat[..., :, 1] * r2).sum(-1)
    c6 = -(a2**2) - (r2 * r2).sum(-1) - 2 * a2 * s2r2
    c3 = -2 * b2 * (a2 + s2r2)
    c0 = -(b2**2)
    return a, b, c0, c3, c6


def roots(c0, c3, c6):
    """The ``MAX_TESTED_SOLUTIONS`` smallest real positive roots in
    [R2_MIN_AU, R2_MAX_AU] of x^8 + c6 x^6 + c3 x^3 + c0, ascending, from
    the companion matrix's eigenvalues: (R, MAX_TESTED_SOLUTIONS) values and
    a mask of those that exist."""
    R = c0.shape[0]
    comp = torch.zeros((R, 8, 8), dtype=c0.dtype)
    comp[:, 1:, :-1] = torch.eye(7, dtype=c0.dtype)
    # the last column holds -coefficient of x^j, j = 0..7
    comp[:, 0, 7] = -c0
    comp[:, 3, 7] = -c3
    comp[:, 6, 7] = -c6
    z = torch.linalg.eigvals(comp)
    x = z.real
    tol = torch.clamp(100 * torch.finfo(c0.dtype).eps * (1 + x.abs()), min=ROOT_IMAG_EPS)
    ok = (z.imag.abs() < tol) & (x > 0) & (x >= R2_MIN_AU) & (x <= R2_MAX_AU)
    x = torch.where(ok, x, torch.inf)
    x, _ = torch.sort(x, dim=-1)
    x = x[:, :MAX_TESTED_SOLUTIONS]
    return torch.where(torch.isfinite(x), x, 1.0), torch.isfinite(x)


def positions(c_vec, s_inv, u, obs_pos, time):
    """Ranges from ``c_vec`` (..., 3): positions (..., 3, 3), the epoch at
    the centre corrected for light time (float64) and the range floor."""
    g = (c_vec[..., None] * obs_pos).sum(-2)
    rho = -(s_inv @ g[..., None])[..., 0] / c_vec
    pos = obs_pos + rho[..., None] * u
    epoch = time[..., 1] - rho[..., 1].to(torch.float64) / C_AU_DAY
    return pos, epoch, rho[..., 1] >= MIN_RHO2_AU


def gibbs_velocity(pos, tau1, tau3):
    tau13 = tau3 - tau1
    rm3 = torch.linalg.vector_norm(pos, dim=-1) ** -3
    d1 = tau3 * (rm3[..., 0] / 12 - 1 / (tau1 * tau13))
    d2 = (tau1 + tau3) * (rm3[..., 1] / 12 - 1 / (tau1 * tau3))
    d3 = -tau1 * (rm3[..., 2] / 12 + 1 / (tau3 * tau13))
    d = torch.stack([-d1, d2, d3], dim=-1)
    return K_GAUSS * (d[..., None] * pos).sum(-2)


def accepted(pos, vel):
    """The eccentricity control: nonzero angular momentum, e < MAX_ECC and
    perihelion distance < MAX_PERIHELION_AU."""
    h = torch.linalg.cross(pos, vel)
    h2 = (h * h).sum(-1)
    r = torch.linalg.vector_norm(pos, dim=-1)
    e = torch.linalg.vector_norm(torch.linalg.cross(vel, h) / MU - pos / r[..., None], dim=-1)
    return (h2 > 0) & (e < MAX_ECC) & (h2 / (MU * (1 + e)) < MAX_PERIHELION_AU)


def stumpff(z):
    """Stumpff's C(z) and S(z), by their series near z = 0."""
    small = z.abs() < 1e-2
    zs = torch.where(small, 1.0, z)
    sq = torch.sqrt(zs.abs())
    c_pos, s_pos = (1 - torch.cos(sq)) / zs, (sq - torch.sin(sq)) / sq**3
    c_neg, s_neg = (torch.cosh(sq) - 1) / -zs, (torch.sinh(sq) - sq) / sq**3
    c_ser = 1 / 2 - z / 24 + z * z / 720 - z**3 / 40320
    s_ser = 1 / 6 - z / 120 + z * z / 5040 - z**3 / 362880
    c = torch.where(small, c_ser, torch.where(z > 0, c_pos, c_neg))
    s = torch.where(small, s_ser, torch.where(z > 0, s_pos, s_neg))
    return c, s


def lagrange_fg(r0_vec, v0_vec, dt, chi0=None):
    """f, g, the universal anomaly chi and whether its solve converged, from
    the state (..., 3) over ``dt`` (...) days: Newton on Curtis's universal
    Kepler equation until every step is under 1e3 eps relative."""
    r0 = torch.linalg.vector_norm(r0_vec, dim=-1)
    vr0 = (r0_vec * v0_vec).sum(-1) / r0
    alpha = 2 / r0 - (v0_vec * v0_vec).sum(-1) / MU
    sq_mu_dt = K_GAUSS * dt
    chi = K_GAUSS * alpha.abs() * dt if chi0 is None else chi0
    # a step of at most a tenth of an orbit's anomaly (2 pi / sqrt(alpha))
    cap = torch.where(alpha > 0, 0.2 * math.pi / torch.sqrt(alpha.clamp(min=1e-12)), torch.inf)
    tol = 1e3 * torch.finfo(chi.dtype).eps
    converged = torch.zeros_like(chi, dtype=torch.bool)
    for _ in range(KEPLER_MAX_IT):
        z = alpha * chi * chi
        c, s = stumpff(z)
        fn = r0 * vr0 / K_GAUSS * chi * chi * c + (1 - alpha * r0) * chi**3 * s + r0 * chi - sq_mu_dt
        dfn = r0 * vr0 / K_GAUSS * chi * (1 - z * s) + (1 - alpha * r0) * chi * chi * c + r0
        step = torch.clamp(fn / dfn, -cap, cap)
        step = torch.where(torch.isfinite(step) & ~converged, step, 0.0)
        chi = chi - step
        converged = converged | (torch.isfinite(chi) & (step.abs() <= tol * (1 + chi.abs())))
        if converged.all():
            break
    z = alpha * chi * chi
    c, s = stumpff(z)
    f = 1 - chi * chi / r0 * c
    g = dt - chi**3 * s / K_GAUSS
    return f, g, chi, converged


def gauss(time, ra, dec, obs_pos):
    """Gauss IOD of one triplet per row: ``time`` (R, 3) float64 MJD TT,
    ``ra``, ``dec`` (R, 3) and ``obs_pos`` (R, 3, 3) in the working
    precision.  Returns :class:`Candidates` over the
    ``MAX_TESTED_SOLUTIONS`` roots."""
    dtype = ra.dtype
    dt = time - time[:, 1:2]
    tau1, tau3 = (K_GAUSS * dt[:, 0]).to(dtype), (K_GAUSS * dt[:, 2]).to(dtype)
    u = unit_vectors(ra, dec)  # (R, 3 epochs, 3)
    s_mat = u.transpose(-1, -2)
    s_inv = torch.linalg.inv(s_mat)
    a, b, c0, c3, c6 = polynomial(tau1, tau3, s_inv, s_mat, obs_pos)
    x, has = roots(c0, c3, c6)
    M = x.shape[1]

    def per_root(t):
        return t[:, None].expand(t.shape[:1] + (M,) + t.shape[1:])

    s_inv_m, u_m, pos_m, time_m = per_root(s_inv), per_root(u), per_root(obs_pos), per_root(time)
    r2m3 = x**-3
    c_vec = torch.stack([a[:, None, 0] + b[:, None, 0] * r2m3, -torch.ones_like(x),
                         a[:, None, 2] + b[:, None, 2] * r2m3], dim=-1)
    pos, epoch, rho_ok = positions(c_vec, s_inv_m, u_m, pos_m, time_m)
    vel = gibbs_velocity(pos, tau1[:, None], tau3[:, None])
    valid = has & rho_ok & accepted(pos[..., 1, :], vel)

    dt1, dt3 = per_root(dt[:, 0]).to(dtype), per_root(dt[:, 2]).to(dtype)
    alive, done, committed = valid.clone(), torch.zeros_like(valid), torch.zeros_like(valid)
    chi1 = chi3 = None
    for _ in range(NEWTON_MAX_IT):
        live = alive & ~done
        if not live.any():
            break
        x1, x2, x3 = pos[..., 0, :], pos[..., 1, :], pos[..., 2, :]
        f1, g1, chi1, ok1 = lagrange_fg(x2, vel, dt1, chi1)
        f3, g3, chi3, ok3 = lagrange_fg(x2, vel, dt3, chi3)
        new_vel = 0.5 * ((x1 - f1[..., None] * x2) / g1[..., None] + (x3 - f3[..., None] * x2) / g3[..., None])
        det = f1 * g3 - f3 * g1
        det_ok = torch.isfinite(det) & (det.abs() > torch.finfo(dtype).eps)
        det = torch.where(det_ok, det, 1.0)
        cv = torch.stack([g3 / det, -torch.ones_like(det), -g1 / det], dim=-1)
        new_pos, new_epoch, rho_ok = positions(cv, s_inv_m, u_m, pos_m, time_m)
        usable = live & ok1 & ok3 & det_ok & rho_ok & torch.isfinite(new_vel).all(-1)
        acc = accepted(new_pos[..., 1, :], new_vel)
        step = usable & acc
        moved = torch.linalg.vector_norm((new_pos - pos).flatten(-2), dim=-1)
        rel = moved / torch.linalg.vector_norm(new_pos.flatten(-2), dim=-1)
        pos = torch.where(step[..., None, None], new_pos, pos)
        vel = torch.where(step[..., None], new_vel, vel)
        epoch = torch.where(step, new_epoch, epoch)
        committed = committed | step
        # an accepted-state failure rejects the root; any other failure
        # leaves its last committed state, and it stops there
        alive = alive & ~(usable & ~acc)
        done = done | (step & (rel <= NEWTON_EPS)) | (live & ~usable)
    corrected = valid & alive & committed
    return Candidates(pos, vel, epoch, x, valid, corrected)


def equinoctial(pos_ecl, vel_ecl):
    """Equinoctial elements (a, h, k, p, q, lambda) of heliocentric
    ecliptic states (..., 3), elliptic orbits (non-singular formulas of
    Broucke and Cefola)."""
    r = torch.linalg.vector_norm(pos_ecl, dim=-1)
    v2 = (vel_ecl * vel_ecl).sum(-1)
    a = 1 / (2 / r - v2 / MU)
    hv = torch.linalg.cross(pos_ecl, vel_ecl)
    w = hv / torch.linalg.vector_norm(hv, dim=-1, keepdim=True)
    p = w[..., 0] / (1 + w[..., 2])
    q = -w[..., 1] / (1 + w[..., 2])
    u = 1 + p * p + q * q
    fh = torch.stack([(1 - p * p + q * q) / u, 2 * p * q / u, -2 * p / u], dim=-1)
    gh = torch.stack([2 * p * q / u, (1 + p * p - q * q) / u, 2 * q / u], dim=-1)
    ev = ((v2 - MU / r)[..., None] * pos_ecl - (pos_ecl * vel_ecl).sum(-1, keepdim=True) * vel_ecl) / MU
    k, h = (ev * fh).sum(-1), (ev * gh).sum(-1)
    x1, y1 = (pos_ecl * fh).sum(-1), (pos_ecl * gh).sum(-1)
    root = torch.sqrt(1 - h * h - k * k)
    beta = 1 / (1 + root)
    cos_f = k + ((1 - k * k * beta) * x1 - h * k * beta * y1) / (a * root)
    sin_f = h + ((1 - h * h * beta) * y1 - h * k * beta * x1) / (a * root)
    big_f = torch.atan2(sin_f, cos_f)
    lam = torch.remainder(big_f - k * torch.sin(big_f) + h * torch.cos(big_f), 2 * math.pi)
    return torch.stack([a, h, k, p, q, lam], dim=-1)


def candidate_elements(cands: Candidates):
    """Equinoctial elements (R, M, 6) of each candidate's central state."""
    return equinoctial(equatorial_to_ecliptic(cands.pos[..., 1, :]), equatorial_to_ecliptic(cands.vel))


def best_candidate(cands: Candidates, rms):
    """Per row the candidate ``prelim_orbit`` keeps: among the corrected
    ones if any, else among the valid, the least finite ``rms`` (R, M).
    Returns (index (R,), found (R,))."""
    finite = torch.isfinite(rms)
    corr = cands.corrected & cands.valid & finite
    pool = torch.where(corr.any(-1, keepdim=True), corr, cands.valid & finite)
    score = torch.where(pool, rms, torch.inf)
    return score.argmin(-1), pool.any(-1)
