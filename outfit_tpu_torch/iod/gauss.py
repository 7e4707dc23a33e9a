"""Batched Gauss IOD core.

Port of ``outfit_tpu/iod/gauss.py`` (float64; the mixed-precision polish
pass is not ported).  Reference ``src/initial_orbit_determination/gauss.rs``:

* ``gauss_prelim`` (:532-549): scaled time intervals, LOS unit matrix + inverse,
* ``coeff_eight_poly`` (:585-614): sparse degree-8 coefficients (c0, c3, c6),
* Descartes prefilter and Aberth roots, filters Re > 0, |Im| < eps, the r2
  plausibility window; the ``max_tested_solutions`` smallest valid roots,
* positions with light-time correction and the min-rho2 rejection,
  Gibbs velocity, eccentricity-controlled acceptance,
* the two-sided Lagrange f-g refinement (:1284-1418) with chi warm starts.

Lane layout: a leading lane axis L (triplet x realization);
``pos[..., j, :]`` is the vector at epoch j.
"""

from typing import NamedTuple

import torch

from outfit_tpu_torch.constants import GAUSS_GRAV, ROT_EQUMJ2000_TO_ECLMJ2000, VLIGHT_AU
from outfit_tpu_torch.elements.orb_elem import ccek1, eccentricity_control
from outfit_tpu_torch.iod.params import IODParams
from outfit_tpu_torch.iod.roots import aberth_deg8, descartes_upper_bound
from outfit_tpu_torch.kepler.universal import SolverConfig, velocity_correction
from outfit_tpu_torch.utils.linalg import matvec_small, norm3, rotate3

_EPS = torch.finfo(torch.float64).eps
_TINY = torch.finfo(torch.float64).tiny


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
    det_safe = torch.where(torch.abs(det) > _TINY, det, 1.0)
    return adj / det_safe[..., None, None], det


def gauss_prelim(tri: GaussTriplets):
    """tau1/tau3, LOS matrix S (columns = unit vectors), S^-1, a, b vectors."""
    t = tri.time
    tau1 = GAUSS_GRAV * (t[..., 0] - t[..., 1])
    tau3 = GAUSS_GRAV * (t[..., 2] - t[..., 1])
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
    nonsingular = torch.abs(det) > 1e2 * _EPS
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
    """Two-sided Lagrange f-g refinement (gauss.rs:1284-1418).

    The loop runs while some candidate is alive and unconverged (one
    device read per trip).  A lane that is done or dead keeps its warm
    starts, state and ``corrected`` decision frozen on the trips other
    lanes keep alive.  Returns (pos, vel, epoch, chi1, chi2, alive,
    committed)."""
    feps = _EPS
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
        if not bool((alive & ~done).any()):
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


def gauss_candidates(tri: GaussTriplets, params: IODParams) -> GaussCandidates:
    """Roots -> accepted preliminary states -> f-g corrected states, masked."""
    tau1, tau3, s_mat, s_inv, a, b, u, nonsing = gauss_prelim(tri)
    c0, c3, c6 = coeff_eight_poly(tri, s_mat, s_inv, a, b)

    descartes_ok = descartes_upper_bound(c0, c3, c6) > 0
    roots = aberth_deg8(
        c0, c3, c6, params.aberth_max_iter, params.aberth_eps,
        active=descartes_ok & nonsing, sort=False,
    )
    r2 = roots.real  # (L, 8)
    imag_tol = torch.clamp(100.0 * _EPS * (1.0 + torch.abs(r2)), min=params.root_imag_eps)
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

    chi0 = torch.zeros_like(epoch)
    cpos, cvel, cepoch, chi1, chi2, alive, committed = _fg_correction(
        tri8, s_inv8, u8, dt01, dt21, pos, vel, epoch, chi0, chi0,
        valid & dt_ok, params, params.newton_max_it,
    )

    corrected = valid & alive & committed
    out_pos = torch.where(corrected[..., None, None], cpos, pos)
    out_vel = torch.where(corrected[..., None], cvel, vel)
    out_epoch = torch.where(corrected, cepoch, epoch)
    return GaussCandidates(out_pos, out_vel, out_epoch, valid, corrected, chi1, chi2, r2)


def candidates_to_elements(cands: GaussCandidates):
    """Central state -> ecliptic frame -> orbital elements per candidate.
    Parity: ``compute_orbit_from_state`` (gauss.rs:906-923) + ccek1."""
    p_ecl = rotate3(ROT_EQUMJ2000_TO_ECLMJ2000, cands.pos[..., 1, :])
    v_ecl = rotate3(ROT_EQUMJ2000_TO_ECLMJ2000, cands.vel)
    return ccek1(p_ecl, v_ecl)
