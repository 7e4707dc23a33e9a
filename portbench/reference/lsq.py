"""Differential correction with outlier rejection, in plain PyTorch.

The semantics the deployments state (Outfit's ``diff_cor`` and
``outlier_rejection``): weighted least squares of the RA and Dec residuals
(RA wrapped, weights 1 / sigma^2), Newton steps on the normal equations,
a step accepted unless the normal matrix does not invert, the orbit leaves
the plausibility box, the RMS grows past the divergence ratio (after the
grace iterations) or stagnates; converged when the step's norm in the
normal matrix's metric falls under the threshold.  Between Newton loops an
observation is rejected when its chi-squared, with the orbit's own
uncertainty projected out, exceeds the rejection threshold, and recovered
under the recovery threshold; the loops stop when a pass changes nothing.
The covariance is rescaled by the RMS (``least_square.rs``).

Rows are independent; they run side by side, each with its own state.
``dtype`` is the working precision of the elements, observations and
normal equations; epochs stay float64 and only their differences are cast.
"""

import math
from dataclasses import dataclass

import torch

from portbench.reference.twobody import radec_and_partials

RUNNING, OK, BIZARRE, DIVERGED, INVERSION_FAILED = 0, 1, 2, 3, 4


@dataclass
class Observations:
    """Per-row observations, padded to a common width: (R, N) arrays and
    the observer (R, N, 3), heliocentric equatorial J2000, AU."""

    mjd: torch.Tensor
    ra: torch.Tensor
    dec: torch.Tensor
    sigma_ra: torch.Tensor
    sigma_dec: torch.Tensor
    observer: torch.Tensor
    valid: torch.Tensor

    def rows(self, idx):
        return Observations(*(getattr(self, f)[idx] for f in
                              ("mjd", "ra", "dec", "sigma_ra", "sigma_dec", "observer", "valid")))


def _wrap(d):
    d = torch.remainder(d, 2 * math.pi)
    return torch.where(d > math.pi, d - 2 * math.pi, d)


def _bizarre(x, limits):
    a = x[:, 0]
    e = torch.sqrt(x[:, 1] ** 2 + x[:, 2] ** 2)
    return ((e > limits["eccentricity_limit"]) | (a < limits["min_semi_major_axis"])
            | (a > limits["max_semi_major_axis"]) | (a * (1 - e) < limits["min_periapsis_distance"])
            | (a * (1 + e) > limits["max_apoapsis_distance"]))


def newton_step(x, epoch, obs, active_sel, dtype):
    """One Newton step from ``x`` (R, 6) on the active observations."""
    ra, dec, dra, ddec = radec_and_partials(x, epoch, obs.mjd, obs.observer.to(dtype))
    usable = obs.valid & torch.isfinite(ra) & torch.isfinite(dec)
    active = active_sel & usable
    o_ra, o_dec = obs.ra.to(dtype), obs.dec.to(dtype)
    res_ra = torch.where(usable, _wrap(o_ra - ra), 0.0)
    res_dec = torch.where(usable, o_dec - dec, 0.0)
    dra = torch.where(usable[..., None], dra, 0.0)
    ddec = torch.where(usable[..., None], ddec, 0.0)
    w_ra = torch.where(active, 1 / obs.sigma_ra.to(dtype) ** 2, 0.0)
    w_dec = torch.where(active, 1 / obs.sigma_dec.to(dtype) ** 2, 0.0)
    normal = (torch.einsum("rn,rni,rnj->rij", w_ra, dra, dra) + torch.einsum("rn,rni,rnj->rij", w_dec, ddec, ddec))
    rhs = torch.einsum("rn,rni,rn->ri", w_ra, dra, res_ra) + torch.einsum("rn,rni,rn->ri", w_dec, ddec, res_dec)
    q = (w_ra * res_ra**2 + w_dec * res_dec**2).sum(-1)
    m = 2 * active.sum(-1)
    finite = torch.isfinite(normal).all(-1).all(-1)
    eye = torch.eye(6, dtype=dtype, device=x.device).expand_as(normal)
    chol, info = torch.linalg.cholesky_ex(torch.where(finite[:, None, None], normal, eye))
    chol = torch.where((info == 0)[:, None, None], chol, eye)
    cov = torch.cholesky_inverse(chol)
    inv_ok = finite & (info == 0) & torch.isfinite(cov).all(-1).all(-1) & (m >= 1)
    dx = torch.where(inv_ok[:, None], torch.einsum("rij,rj->ri", cov, rhs), 0.0)
    norm = torch.sqrt(torch.clamp(torch.einsum("ri,rij,rj->r", dx, normal, dx), min=0.0))
    rms = torch.where(m > 0, torch.sqrt(q / torch.clamp(m, min=1)), 0.0)
    return dict(corrected=x + dx, norm=norm, rms=rms, cov=cov, normal=normal, inv_ok=inv_ok, m=m,
                res_ra=res_ra, res_dec=res_dec, dra=dra, ddec=ddec)


def differential_correction(x0, epoch, obs: Observations, cfg, dtype=torch.float64):
    """Fit every row from ``x0`` (R, 6) at ``epoch`` (R,).  ``cfg`` holds the
    configuration's correction settings (the keys of the workload file's
    ``correction``).  Returns a dict of (R,)-leading tensors: ``elements``,
    ``status``, ``rms``, ``covariance`` (rescaled), ``n_active``."""
    R = x0.shape[0]
    dev = x0.device
    limits = cfg["orbital_limits"]
    x = x0.to(dtype)
    sel = obs.valid.clone()  # active; valid & ~sel = rejected
    status = torch.zeros(R, dtype=torch.int64, device=dev)
    big = torch.finfo(dtype).max
    last = dict(rms=torch.full((R,), big, dtype=dtype, device=dev),
                cov=torch.zeros((R, 6, 6), dtype=dtype, device=dev),
                m=torch.zeros(R, dtype=torch.int64, device=dev),
                res_ra=torch.zeros(obs.mjd.shape, dtype=dtype, device=dev),
                res_dec=torch.zeros(obs.mjd.shape, dtype=dtype, device=dev),
                dra=torch.zeros(obs.mjd.shape + (6,), dtype=dtype, device=dev),
                ddec=torch.zeros(obs.mjd.shape + (6,), dtype=dtype, device=dev))
    outer_done = torch.zeros(R, dtype=torch.bool, device=dev)
    for p in range(cfg["max_outlier_rejection_passes"] + 1):
        live = (status == RUNNING) & ~outer_done
        if not live.any():
            break
        prev_rms = torch.full((R,), big, dtype=dtype, device=dev)
        stagn = torch.zeros(R, dtype=torch.int64, device=dev)
        inner_done = ~live
        converged = torch.zeros(R, dtype=torch.bool, device=dev)
        for it in range(cfg["max_newton_iterations"]):
            if inner_done.all():
                break
            act = ~inner_done
            s = newton_step(x, epoch, obs, sel, dtype)
            inv_fail = act & ~s["inv_ok"]
            bizarre = act & ~inv_fail & _bizarre(s["corrected"], limits)
            had_prev = prev_rms < big
            ratio = s["rms"] / prev_rms
            keep = act & ~inv_fail & ~bizarre
            diverged = (keep & had_prev & (it >= cfg["divergence_grace_iterations"])
                        & (ratio >= cfg["rms_divergence_ratio"]))
            stagnated = keep & ~diverged & had_prev & (ratio >= cfg["rms_stagnation_ratio"])
            stagn = torch.where(stagnated, stagn + 1, 0)
            stagn_break = stagnated & (stagn >= cfg["max_stagnation_iterations"])
            advance = keep & ~diverged & ~stagn_break
            conv = advance & (s["norm"] < cfg["convergence_threshold"])
            status = torch.where(inv_fail, INVERSION_FAILED, torch.where(
                bizarre, BIZARRE, torch.where(diverged, DIVERGED, status)))
            x = torch.where(advance[:, None], s["corrected"], x)
            for key, val in (("rms", s["rms"]), ("cov", s["cov"]), ("m", s["m"]), ("res_ra", s["res_ra"]),
                             ("res_dec", s["res_dec"]), ("dra", s["dra"]), ("ddec", s["ddec"])):
                mask = advance.reshape((R,) + (1,) * (val.dim() - 1))
                last[key] = torch.where(mask, val, last[key])
            inner_done = inner_done | inv_fail | bizarre | diverged | stagn_break | conv
            prev_rms = torch.where(advance, s["rms"], prev_rms)
            converged = converged | conv
        running = status == RUNNING
        if not cfg["enable_outlier_rejection"]:
            outer_done = outer_done | running
            continue
        clean = (last["rms"] < cfg["convergence_before_rejection_threshold"]) & (p == 0)
        done_now = running & ~outer_done & (clean | ~converged)
        need = running & ~outer_done & ~done_now
        if need.any():
            new_sel, changes = _outlier_pass(last, sel, obs, cfg, dtype)
            sel = torch.where(need[:, None], new_sel, sel)
            outer_done = outer_done | done_now | (need & (changes == 0))
        else:
            outer_done = outer_done | done_now
    status = torch.where(status == RUNNING, OK, status)
    m = last["m"]
    factor = torch.sqrt(m.to(dtype) / torch.clamp(m - 6, min=1).to(dtype))
    mu = torch.where(m > 6, torch.where(last["rms"] > 1, last["rms"] * factor, factor), 1.0)
    return dict(elements=x, status=status, rms=last["rms"], covariance=last["cov"] * (mu * mu)[:, None, None],
                n_active=(sel & obs.valid).sum(-1))


def _outlier_pass(last, sel, obs, cfg, dtype):
    """New selection and the count of changed observations: chi-squared of
    each residual pair against its variance less the orbit's projection
    (active observations only; rejected ones keep their full variance)."""
    cov, dra, ddec = last["cov"], last["dra"], last["ddec"]
    w = sel.to(dtype)
    paa = torch.einsum("rni,rij,rnj->rn", dra, cov, dra) * w
    pdd = torch.einsum("rni,rij,rnj->rn", ddec, cov, ddec) * w
    pad = torch.einsum("rni,rij,rnj->rn", dra, cov, ddec) * w
    v00 = obs.sigma_ra.to(dtype) ** 2 - paa
    v11 = obs.sigma_dec.to(dtype) ** 2 - pdd
    v01 = -pad
    det = v00 * v11 - v01 * v01
    scale = torch.maximum(v00.abs(), v11.abs())
    singular = (det.abs() < torch.finfo(torch.float64).eps * scale**2) | (scale == 0)
    xr, xd = last["res_ra"], last["res_dec"]
    chi2 = (v11 * xr * xr - 2 * v01 * xr * xd + v00 * xd * xd) / torch.where(singular, 1.0, det)
    reject = sel & obs.valid & ~singular & (chi2 > cfg["chi_squared_rejection_threshold"])
    recover = ~sel & obs.valid & ~singular & (chi2 <= cfg["chi_squared_recovery_threshold"])
    new_sel = (sel & ~reject) | recover
    return new_sel, (reject | recover).sum(-1)


def mahalanobis(x, y, cov):
    """sqrt((x - y)^T cov^-1 (x - y)) per row: the gap in the orbit's own
    standard deviations."""
    d = (x - y).to(torch.float64)
    sol = torch.linalg.solve(cov.to(torch.float64), d[..., None])[..., 0]
    return torch.sqrt(torch.clamp((d * sol).sum(-1), min=0.0))
