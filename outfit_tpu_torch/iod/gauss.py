"""Batched Gauss IOD core.

Port of ``outfit_tpu/iod/gauss.py``.  Reference
``src/initial_orbit_determination/gauss.rs``:

* ``gauss_prelim`` (:532-549): scaled time intervals, LOS unit matrix + inverse,
* ``coeff_eight_poly`` (:585-614): sparse degree-8 coefficients (c0, c3, c6),
* Descartes prefilter and Aberth roots, filters Re > 0, |Im| < eps, the r2
  plausibility window; the ``max_tested_solutions`` smallest valid roots,
* positions with light-time correction and the min-rho2 rejection,
  Gibbs velocity, eccentricity-controlled acceptance,
* the two-sided Lagrange f-g refinement (:1284-1418) with chi warm starts,
* the mixed-precision path: ``gauss_candidates(..., work_dtype=float32)``
  runs the iterative stages (Aberth, the f-g correction) in float32 while
  the one-shot prelim algebra and the absolute MJDs stay float64, and
  :func:`polish_selected` recovers float64 accuracy for the winners.

Lane layout: a leading lane axis L (triplet x realization);
``pos[..., j, :]`` is the vector at epoch j.
"""

from typing import NamedTuple

import torch

from outfit_tpu_torch import trace
from outfit_tpu_torch.constants import GAUSS_GRAV, ROT_EQUMJ2000_TO_ECLMJ2000, VLIGHT_AU
from outfit_tpu_torch.elements.orb_elem import ccek1, eccentricity_control
from outfit_tpu_torch.iod.params import IODParams
from outfit_tpu_torch.iod.roots import aberth_deg8, descartes_upper_bound
from outfit_tpu_torch.kepler.universal import SolverConfig, velocity_correction
from outfit_tpu_torch.utils.linalg import matvec_small, norm3, rotate3

_EPS = torch.finfo(torch.float64).eps


class GaussTriplets(NamedTuple):
    """Batched observation triplets (lane axis L); ``obs_pos[l, j, :]`` is
    the observer's heliocentric position at epoch j, equatorial J2000, AU."""

    ra: torch.Tensor  # (L, 3) radians
    dec: torch.Tensor  # (L, 3)
    time: torch.Tensor  # (L, 3) MJD TT
    obs_pos: torch.Tensor  # (L, 3, 3)


class GaussCandidates(NamedTuple):
    """Per-(lane, root) candidate states after accept + correction."""

    pos: torch.Tensor  # (L, K, 3, 3) positions at the three epochs (equ J2000)
    vel: torch.Tensor  # (L, K, 3) velocity at the central epoch
    epoch: torch.Tensor  # (L, K) light-time-corrected reference epoch
    valid: torch.Tensor  # (L, K) accept_root passed
    corrected: torch.Tensor  # (L, K) f-g correction committed and survived
    chi1: torch.Tensor  # (L, K) final left universal-anomaly warm start
    chi2: torch.Tensor  # (L, K) final right universal-anomaly warm start
    r2: torch.Tensor  # (L, K) the degree-8 root (central heliocentric distance)


def unit_vectors(ra, dec):
    cd = torch.cos(dec)
    return torch.stack([cd * torch.cos(ra), cd * torch.sin(ra), torch.sin(dec)], dim=-1)


def _inv3(m):
    """Closed-form batched 3x3 inverse (adjugate / det); returns (inv, det)."""
    a = m
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
    c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    adj = torch.stack(
        [
            torch.stack([c00, c10, c20], dim=-1),
            torch.stack([c01, c11, c21], dim=-1),
            torch.stack([c02, c12, c22], dim=-1),
        ],
        dim=-2,
    )
    det_safe = torch.where(torch.abs(det) > torch.finfo(det.dtype).tiny, det, 1.0)
    return adj / det_safe[..., None, None], det


def gauss_prelim(tri: GaussTriplets):
    """tau1/tau3, LOS matrix S (columns = unit vectors), S^-1, a, b vectors.

    The working dtype follows ``tri.ra``; ``tri.time`` stays float64 (an
    absolute MJD does not fit in float32) and only the day-scale
    differences are cast down."""
    dtype = tri.ra.dtype
    t = tri.time
    tau1 = (GAUSS_GRAV * (t[..., 0] - t[..., 1])).to(dtype)
    tau3 = (GAUSS_GRAV * (t[..., 2] - t[..., 1])).to(dtype)
    tau13 = tau3 - tau1
    a = torch.stack([tau3 / tau13, -torch.ones_like(tau1), -(tau1 / tau13)], dim=-1)
    b = torch.stack(
        [
            a[..., 0] * (tau13**2 - tau3**2) / 6.0,
            torch.zeros_like(tau1),
            a[..., 2] * (tau13**2 - tau1**2) / 6.0,
        ],
        dim=-1,
    )
    u = unit_vectors(tri.ra, tri.dec)  # (L, 3epoch, 3coord)
    s_mat = torch.swapaxes(u, -1, -2)  # columns are unit vectors
    s_inv, det = _inv3(s_mat)
    nonsingular = torch.abs(det) > 1e2 * torch.finfo(dtype).eps
    return tau1, tau3, s_mat, s_inv, a, b, u, nonsingular


def coeff_eight_poly(tri: GaussTriplets, s_mat, s_inv, a, b):
    """Sparse coefficients (c0, c3, c6).  Parity: gauss.rs:585-614."""
    ra_vec = torch.sum(a[..., None] * tri.obs_pos, dim=-2)
    rb_vec = torch.sum(b[..., None] * tri.obs_pos, dim=-2)
    row1 = s_inv[..., 1, :]  # second row of S^-1
    a2star = torch.sum(row1 * ra_vec, dim=-1)
    b2star = torch.sum(row1 * rb_vec, dim=-1)
    p2 = tri.obs_pos[..., 1, :]
    r22 = torch.sum(p2 * p2, dim=-1)
    s2 = s_mat[..., :, 1]
    s2r2 = torch.sum(s2 * p2, dim=-1)
    c6 = -(a2star**2) - r22 - 2.0 * a2star * s2r2
    c3 = -2.0 * b2star * (a2star + s2r2)
    c0 = -(b2star**2)
    return c0, c3, c6


def _positions_from_cvec(tri, s_inv, u, c_vec, min_rho2):
    """rho solve + light-time epoch.  Parity: gauss.rs:702-724.
    ``c_vec``: (..., 3).  Returns (pos (..., 3, 3), epoch, rho2_ok)."""
    gcap = torch.sum(c_vec[..., None] * tri.obs_pos, dim=-2)
    crhom = matvec_small(s_inv, gcap)
    rho = -crhom / c_vec
    rho2_ok = rho[..., 1] >= min_rho2
    pos = tri.obs_pos + rho[..., None] * u
    epoch = tri.time[..., 1] - rho[..., 1] / VLIGHT_AU
    return pos, epoch, rho2_ok


def gibbs_velocity(pos, tau1, tau3):
    """Gibbs velocity at the central epoch.  Parity: gauss.rs:754-781."""
    tau13 = tau3 - tau1
    r = norm3(pos)  # (..., 3)
    rm3 = 1.0 / r**3
    d1 = tau3 * (rm3[..., 0] / 12.0 - 1.0 / (tau1 * tau13))
    d2 = (tau1 + tau3) * (rm3[..., 1] / 12.0 - 1.0 / (tau1 * tau3))
    d3 = -tau1 * (rm3[..., 2] / 12.0 + 1.0 / (tau3 * tau13))
    d = torch.stack([-d1, d2, d3], dim=-1)
    return GAUSS_GRAV * torch.sum(d[..., None] * pos, dim=-2)


def _fg_correction(
    tri_b, s_inv_b, u_b, dt01, dt21, pos, vel, epoch, chi1, chi2, alive0,
    params: IODParams, max_it: int,
):
    """Two-sided Lagrange f-g refinement (gauss.rs:1284-1418), shared by the
    candidate axis of :func:`gauss_candidates` and the float64 polish of the
    selected candidate.  ``epoch`` stays float64; positions and velocities
    run in ``pos.dtype``.

    The loop runs while some candidate is alive and unconverged (one
    device read per trip).  A lane that is done or dead keeps its warm
    starts, state and ``corrected`` decision frozen on the trips other
    lanes keep alive.  Returns (pos, vel, epoch, chi1, chi2, alive,
    committed)."""
    with trace.span("iod.fg_correction"):
        feps = torch.finfo(pos.dtype).eps
        # relative-step convergence floored at 10 eps of the working dtype
        done_eps = max(params.newton_eps, 10.0 * feps)
        # Newton-only solver, as the reference's velocity_correction
        # (velocity.rs:131-138)
        vc_cfg = SolverConfig(convergency=params.kepler_eps, auto_fallback=False)

        cpos, cvel, cepoch = pos, vel, epoch
        alive = alive0
        committed = torch.zeros_like(alive0)
        done = torch.zeros_like(alive0)
        K = chi1.shape[-1]
        dts = torch.cat(
            [torch.broadcast_to(dt01, chi1.shape), torch.broadcast_to(dt21, chi2.shape)], dim=-1
        )
        for _ in range(max_it):
            if not trace.sites.iod_fg.live_lanes(alive & ~done):
                break
            x1 = cpos[..., 0, :]
            x2 = cpos[..., 1, :]
            x3 = cpos[..., 2, :]
            # one stacked solve for both sides along the candidate axis (L, 2K)
            both = velocity_correction(
                torch.cat([x1, x3], dim=-2),
                torch.cat([x2, x2], dim=-2),
                torch.cat([cvel, cvel], dim=-2),
                dts,
                params.max_perihelion_au,
                params.max_ecc,
                chi_guess=torch.cat([chi1, chi2], dim=-1),
                cfg=vc_cfg,
            )
            left = type(both)(*(f[..., :K, :] if f.dim() > chi1.dim() else f[..., :K] for f in both))
            right = type(both)(*(f[..., K:, :] if f.dim() > chi1.dim() else f[..., K:] for f in both))
            iter_ok = (left.status == 0) & (right.status == 0)
            chi_upd = iter_ok & alive & ~done
            chi1n = torch.where(chi_upd, left.psi, chi1)
            chi2n = torch.where(chi_upd, right.psi, chi2)

            new_vel = 0.5 * (left.v2_corrected + right.v2_corrected)
            fl = left.f * right.g - right.f * left.g
            fl_ok = torch.isfinite(fl) & (torch.abs(fl) > feps)
            inv_f = 1.0 / torch.where(fl_ok, fl, 1.0)
            cv = torch.stack([right.g * inv_f, -torch.ones_like(inv_f), -left.g * inv_f], dim=-1)
            new_pos, new_epoch, rho_ok = _positions_from_cvec(tri_b, s_inv_b, u_b, cv, params.min_rho2_au)
            acc_i, _, _, _ = eccentricity_control(
                new_pos[..., 1, :], new_vel, params.max_perihelion_au, params.max_ecc
            )
            # hard reject (not re-judged once done): the candidate loses correction
            hard_reject = iter_ok & fl_ok & rho_ok & ~acc_i & ~done
            commit = iter_ok & fl_ok & rho_ok & acc_i & alive & ~done

            denom = torch.sqrt(torch.sum(new_pos**2, dim=(-1, -2)))
            rel_err = torch.sqrt(torch.sum((new_pos - cpos) ** 2, dim=(-1, -2))) / torch.where(
                denom > feps, denom, 1.0
            )

            cpos = torch.where(commit[..., None, None], new_pos, cpos)
            cvel = torch.where(commit[..., None], new_vel, cvel)
            cepoch = torch.where(commit, new_epoch, cepoch)
            alive = alive & ~hard_reject
            committed = committed | commit
            # a lane that neither commits nor moves its warm starts is stationary
            stalled = (
                alive
                & ~done
                & ~commit
                & (torch.abs(chi1n - chi1) <= feps * (1.0 + torch.abs(chi1)))
                & (torch.abs(chi2n - chi2) <= feps * (1.0 + torch.abs(chi2)))
            )
            done = done | (commit & (rel_err <= done_eps)) | stalled
            chi1, chi2 = chi1n, chi2n
        return cpos, cvel, cepoch, chi1, chi2, alive, committed


def gauss_candidates(tri: GaussTriplets, params: IODParams, work_dtype=None) -> GaussCandidates:
    """Roots -> accepted preliminary states -> f-g corrected states, masked.

    ``work_dtype`` is the precision of the iterative stages (Aberth, the f-g
    correction); the one-shot prelim algebra (LOS inverse, polynomial
    coefficients, singularity gate) runs at the input precision, and the
    absolute MJDs stay float64."""
    dtype = tri.ra.dtype if work_dtype is None else work_dtype
    tau1, tau3, s_mat, s_inv, a, b, u, nonsing = gauss_prelim(tri)
    c0, c3, c6 = coeff_eight_poly(tri, s_mat, s_inv, a, b)
    if dtype != tri.ra.dtype:
        tau1, tau3, s_inv, u, a, b, c0, c3, c6 = (
            x.to(dtype) for x in (tau1, tau3, s_inv, u, a, b, c0, c3, c6)
        )
        tri = GaussTriplets(tri.ra.to(dtype), tri.dec.to(dtype), tri.time, tri.obs_pos.to(dtype))

    descartes_ok = descartes_upper_bound(c0, c3, c6) > 0
    roots = aberth_deg8(
        c0, c3, c6, params.aberth_max_iter, params.aberth_eps,
        active=descartes_ok & nonsing, sort=False,
    )
    r2 = roots.real  # (L, 8)
    # a real float32 root carries ~|z| 100 eps of imaginary noise: the
    # reference's absolute cut is floored at a dtype-scaled relative one
    imag_tol = torch.clamp(100.0 * torch.finfo(dtype).eps * (1.0 + torch.abs(r2)), min=params.root_imag_eps)
    root_ok = (
        (torch.abs(roots.imag) < imag_tol)
        & (r2 > 0.0)
        & (r2 >= params.r2_min_au)
        & (r2 <= params.r2_max_au)
        & descartes_ok[..., None]
        & nonsing[..., None]
    )
    # keep the max_tested_solutions smallest valid roots, ascending; a stable
    # sort gives lax.top_k's lower-index-first order on ties
    n_keep = min(params.max_tested_solutions, 8)
    masked = torch.where(root_ok, r2, torch.inf)
    order = torch.argsort(masked, dim=-1, stable=True)[..., :n_keep]
    r2 = torch.gather(masked, -1, order)
    root_ok = torch.gather(root_ok, -1, order)
    r2_safe = torch.where(root_ok, r2, 1.0)

    # --- accept_root (preliminary state per root) ---------------------------
    r2m3 = 1.0 / r2_safe**3
    c_vec = torch.stack(
        [
            a[..., None, 0] + b[..., None, 0] * r2m3,
            -torch.ones_like(r2m3),
            a[..., None, 2] + b[..., None, 2] * r2m3,
        ],
        dim=-1,
    )  # (L, K, 3)

    tri8 = GaussTriplets(
        tri.ra[..., None, :], tri.dec[..., None, :], tri.time[..., None, :],
        tri.obs_pos[..., None, :, :],
    )
    s_inv8, u8 = s_inv[..., None, :, :], u[..., None, :, :]
    pos, epoch, rho2_ok = _positions_from_cvec(tri8, s_inv8, u8, c_vec, params.min_rho2_au)
    vel = gibbs_velocity(pos, tau1[..., None], tau3[..., None])
    acc, _, _, _ = eccentricity_control(pos[..., 1, :], vel, params.max_perihelion_au, params.max_ecc)
    valid = root_ok & rho2_ok & acc

    # --- pos_and_vel_correction ----------------------------------------------
    dt01 = (tri.time[..., 0] - tri.time[..., 1])[..., None]
    dt21 = (tri.time[..., 2] - tri.time[..., 1])[..., None]
    dt_ok = (torch.abs(dt01) > _EPS) & (torch.abs(dt21) > _EPS)

    chi0 = torch.zeros(epoch.shape, dtype=r2.dtype, device=epoch.device)
    cpos, cvel, cepoch, chi1, chi2, alive, committed = _fg_correction(
        tri8, s_inv8, u8, dt01, dt21, pos, vel, epoch, chi0, chi0,
        valid & dt_ok, params, params.newton_max_it,
    )

    corrected = valid & alive & committed
    out_pos = torch.where(corrected[..., None, None], cpos, pos)
    out_vel = torch.where(corrected[..., None], cvel, vel)
    out_epoch = torch.where(corrected, cepoch, epoch)
    return GaussCandidates(out_pos, out_vel, out_epoch, valid, corrected, chi1, chi2, r2)


def polish_selected(tri: GaussTriplets, r2, pos, vel, epoch, corrected, chi1, chi2, params: IODParams, max_it: int = 12):
    """Float64 refinement of the selected candidate per lane (mixed precision).

    The float32 pass decides which candidate wins; this recovers float64
    accuracy for that one candidate: three Newton steps on the degree-8
    polynomial (float64 coefficients) from the float32 root, the float64
    rebuild of the preliminary state (rho solve, light time, Gibbs), and for
    corrected lanes the two-sided f-g correction resumed in float64 from the
    (cast) float32 fixed point with its chi warm starts.  ``tri`` must be
    the float64 triplets.  Returns (pos, vel, epoch, corrected)."""
    f64 = torch.float64
    tau1, tau3, s_mat, s_inv, a, b, u, _ = gauss_prelim(tri)
    c0, c3, c6 = coeff_eight_poly(tri, s_mat, s_inv, a, b)

    x = r2.to(f64)
    bad_root = ~torch.isfinite(x) | (x <= 0.0)
    x = torch.where(bad_root, 1.0, x)
    for _ in range(3):
        x2 = x * x
        x3 = x2 * x
        x5 = x3 * x2
        x6 = x3 * x3
        x7 = x6 * x
        x8 = x6 * x2
        pv = x8 + c6 * x6 + c3 * x3 + c0
        dpv = 8.0 * x7 + 6.0 * c6 * x5 + 3.0 * c3 * x2
        dpv = torch.where(torch.abs(dpv) > _EPS, dpv, 1.0)
        # clamped to stay on the positive branch of the same root
        x = x - torch.clamp(pv / dpv, -0.5 * x, 0.5 * x)

    r2m3 = 1.0 / x**3
    c_vec = torch.stack([a[..., 0] + b[..., 0] * r2m3, -torch.ones_like(r2m3), a[..., 2] + b[..., 2] * r2m3], dim=-1)
    pos0, epoch0, _ = _positions_from_cvec(tri, s_inv, u, c_vec, params.min_rho2_au)
    vel0 = gibbs_velocity(pos0, tau1, tau3)

    # corrected lanes resume from the float32 fixed point; the others take
    # the float64 preliminary rebuild (the reference returns the preliminary
    # orbit for them, gauss.rs:1238-1247)
    init_pos = torch.where(corrected[..., None, None], pos.to(f64), pos0)
    init_vel = torch.where(corrected[..., None], vel.to(f64), vel0)
    init_epoch = torch.where(corrected, epoch.to(f64), epoch0)

    dt01 = tri.time[..., 0] - tri.time[..., 1]
    dt21 = tri.time[..., 2] - tri.time[..., 1]
    cpos, cvel, cepoch, _, _, alive, committed = _fg_correction(
        tri, s_inv, u, dt01, dt21, init_pos, init_vel, init_epoch, chi1.to(f64), chi2.to(f64),
        corrected & ~bad_root, params, max_it,
    )
    refined = corrected & alive & committed
    out_pos = torch.where(refined[..., None, None], cpos, init_pos)
    out_vel = torch.where(refined[..., None], cvel, init_vel)
    out_epoch = torch.where(refined, cepoch, init_epoch)
    # the corrected flag is the float32 pass's decision; a lane whose float64
    # resume could not commit keeps the (cast) float32 fixed point
    return out_pos, out_vel, out_epoch, corrected


def candidates_to_elements(cands: GaussCandidates):
    """Central state -> ecliptic frame -> orbital elements per candidate.
    Parity: ``compute_orbit_from_state`` (gauss.rs:906-923) + ccek1."""
    p_ecl = rotate3(ROT_EQUMJ2000_TO_ECLMJ2000, cands.pos[..., 1, :])
    v_ecl = rotate3(ROT_EQUMJ2000_TO_ECLMJ2000, cands.vel)
    return ccek1(p_ecl, v_ecl)
