"""Nested Newton / outlier-rejection loops, batched over trajectories.

Port of ``outfit_tpu/lsq/loop.py``: the
inner Newton loop with inversion / bizarre / divergence / stagnation /
convergence checks in the reference's order, the outer projection-based
chi-squared outlier-rejection loop, and the final covariance rescale.
``precision="mixed"`` adds the float32 pre-warm (:func:`_prewarm_f32`),
float32 Jacobians inside the float64 loop, and one float64 linearization
at the converged elements; with an N-body propagator (a float64
integrator) ``"mixed"`` runs the plain float64 loop.

Every trajectory carries its own loop-state lanes; terminal failures are
status codes, frozen in place while other trajectories continue.  The JAX
``while_loop``s and ``cond`` are Python ``while``/``if`` on the count of
live lanes (one host sync per trip, read through a
:mod:`outfit_tpu_torch.trace` site); every done-lane gate is kept as
written there, so a lane's result does not depend on the rest of the
batch.
"""

from typing import NamedTuple

import torch

from outfit_tpu_torch import trace
from outfit_tpu_torch.elements.types import EquinoctialElements, is_bizarre
from outfit_tpu_torch.lsq.config import DifferentialCorrectionConfig
from outfit_tpu_torch.lsq.iteration import (
    SEL_ACTIVE,
    SEL_FORCED_OUT,
    SEL_REJECTED,
    ObsArrays,
    single_iteration,
)

_BIG = torch.finfo(torch.float64).max
_EPS = torch.finfo(torch.float64).eps

STATUS_RUNNING = 0
STATUS_OK = 1
STATUS_BIZARRE = 2
STATUS_DIVERGED = 3
STATUS_INVERSION_FAILED = 4


class DiffCorResult(NamedTuple):
    elements: torch.Tensor  # (T, 6) final equinoctial vector (ecliptic)
    status: torch.Tensor  # (T,) STATUS_*
    normalised_rms: torch.Tensor  # (T,)
    covariance: torch.Tensor  # (T, 6, 6) rescaled
    normal_matrix: torch.Tensor  # (T, 6, 6) rescaled
    selection: torch.Tensor  # (T, N) final selection codes
    num_measurements: torch.Tensor  # (T,)
    total_newton_iterations: torch.Tensor  # (T,)


class _St(NamedTuple):
    elements: torch.Tensor
    selection: torch.Tensor
    status: torch.Tensor
    # saved from the last advanced Newton step
    last_rms: torch.Tensor
    last_cov: torch.Tensor
    last_normal: torch.Tensor
    last_m: torch.Tensor
    last_res_ra: torch.Tensor
    last_res_dec: torch.Tensor
    last_dra: torch.Tensor
    last_ddec: torch.Tensor
    inv_ok_last: torch.Tensor
    outer_done: torch.Tensor
    total_newton: torch.Tensor
    # (T, N, 3) generalized-Kepler (F, sin, cos) of the last evaluation —
    # warm start for the next iteration's solve (NaN = cold start)
    kepler: torch.Tensor


def check_supported(cfg: DifferentialCorrectionConfig) -> None:
    """Raise for a configuration the correction does not take."""
    if cfg.precision not in ("f64", "mixed"):
        raise ValueError(
            f"DifferentialCorrectionConfig.precision must be 'f64' or 'mixed', got {cfg.precision!r}"
        )


def _elements_bizarre(vec, limits):
    eq = EquinoctialElements(
        torch.zeros(vec.shape[:-1], dtype=vec.dtype, device=vec.device),
        *(vec[..., i] for i in range(6)),
    )
    return is_bizarre(eq, limits)


def _prewarm_f32(elements0, epoch, obs: ObsArrays, cfg: DifferentialCorrectionConfig, selection0, free):
    """Float32 Newton pre-warm (mixed precision): iterate until the
    correction norm reaches the float32 floor, with guarded advances only
    (a step is taken only if the inversion succeeded and the result is not
    bizarre).  No statuses and no outlier decisions: the float64 loop owns
    every contract; this only moves the start close to the chi-squared
    minimum.  Absolute MJDs stay float64.  Returns (elements float64, the
    batch's trip count), the count of the batch's slowest row, as in the
    JAX package."""
    T = obs.mjd.shape[0]
    f32 = torch.float32
    obs32 = ObsArrays(
        obs.mjd, *(x.to(f32) for x in (obs.ra, obs.dec, obs.sigma_ra, obs.sigma_dec, obs.helio_pos)), obs.valid,
        # the pre-warm fits the debiased residuals too: without the bias it
        # converges to the biased optimum and the float64 loop walks back
        *(None if b is None else b.to(f32) for b in (obs.bias_ra, obs.bias_dec)),
    )
    # the sigma-weighted correction norm has a float32 noise floor around
    # 0.01-0.1: stop on the threshold or when the decrease plateaus
    thr = max(cfg.convergence_threshold, 1e-3)
    dev = obs.mjd.device
    el = elements0.to(f32)
    prev_norm = torch.full((T,), torch.finfo(f32).max, dtype=f32, device=dev)
    done = torch.zeros(T, dtype=torch.bool, device=dev)
    kep = torch.full(obs.mjd.shape + (3,), float("nan"), dtype=f32, device=dev)
    it = 0
    while it < cfg.prewarm_max_iterations and trace.sites.lsq_prewarm.live_lanes(~done):
        res = single_iteration(
            el, epoch, selection0, obs32, free, kepler_warm=(kep[..., 0], kep[..., 1], kep[..., 2]),
        )
        sane = (
            res.inversion_ok
            & torch.isfinite(res.correction_norm)
            & ~_elements_bizarre(res.corrected, cfg.orbital_limits)
        )
        adv = ~done & sane
        el = torch.where(adv[:, None], res.corrected, el)
        plateau = (res.correction_norm >= 0.5 * prev_norm) & (it >= 2)
        done = done | ~sane | (adv & ((res.correction_norm < thr) | plateau))
        prev_norm = torch.where(adv, res.correction_norm, prev_norm)
        kep = res.kepler
        it += 1
    bad = ~torch.isfinite(el).all(dim=-1)
    el64 = torch.where(bad[:, None], elements0, el.to(torch.float64))
    return el64, it


def run_differential_correction(
    elements0,
    epoch,
    obs: ObsArrays,
    cfg: DifferentialCorrectionConfig,
    selection0=None,
    ephem=None,
) -> DiffCorResult:
    """Batched differential correction.

    ``elements0`` (T, 6) equinoctial vectors (ecliptic J2000), ``epoch`` (T,),
    ``obs`` padded observation arrays; ``selection0`` optional initial
    selection codes (default: all valid observations Active); ``ephem``
    (tables on the observations' device) for an N-body ``cfg.propagator``.
    """
    return differential_correction(elements0, epoch, obs, cfg, selection0, ephem)[0]


def differential_correction(elements0, epoch, obs: ObsArrays, cfg: DifferentialCorrectionConfig, selection0=None,
                            ephem=None):
    """:func:`run_differential_correction`, and the mixed-precision
    pre-warm's trip count (0 without a pre-warm), which every row's
    ``total_newton_iterations`` holds."""
    check_supported(cfg)
    T, N = obs.mjd.shape
    dev = obs.mjd.device
    f64 = dict(dtype=torch.float64, device=dev)
    if selection0 is None:
        selection0 = torch.where(obs.valid, SEL_ACTIVE, SEL_FORCED_OUT).to(torch.int32)
    # uploaded once: a per-iteration upload would wait for the card's queue
    free = torch.as_tensor([bool(f) for f in cfg.free_elements], device=dev)
    limits = cfg.orbital_limits
    elements0 = torch.as_tensor(elements0, **f64)
    # mixed: float32 Jacobians inside the float64 loop (the residuals stay
    # float64, so the fixed point is the float64 one)
    # two-body only: with the N-body propagator "mixed" runs this float64
    # loop, with no pre-warm and no float32 Jacobians
    mixed = cfg.precision == "mixed" and not cfg.propagator.nbody
    jac_dtype = torch.float32 if mixed else None
    prewarm = 0
    if mixed:
        elements0, prewarm = _prewarm_f32(elements0, epoch, obs, cfg, selection0, free)

    st = _St(
        elements=elements0,
        selection=selection0,
        status=torch.zeros(T, dtype=torch.int32, device=dev),
        last_rms=torch.full((T,), _BIG, **f64),
        last_cov=torch.zeros((T, 6, 6), **f64),
        last_normal=torch.zeros((T, 6, 6), **f64),
        last_m=torch.zeros(T, dtype=torch.int32, device=dev),
        last_res_ra=torch.zeros((T, N), **f64),
        last_res_dec=torch.zeros((T, N), **f64),
        last_dra=torch.zeros((T, N, 6), **f64),
        last_ddec=torch.zeros((T, N, 6), **f64),
        inv_ok_last=torch.zeros(T, dtype=torch.bool, device=dev),
        outer_done=torch.zeros(T, dtype=torch.bool, device=dev),
        total_newton=torch.full((T,), prewarm, dtype=torch.int32, device=dev),
        kepler=torch.full((T, N, 3), float("nan"), **f64),
    )

    def inner_loop(st: _St):
        running0 = (st.status == STATUS_RUNNING) & ~st.outer_done
        prev_rms = torch.full((T,), _BIG, **f64)
        stagn = torch.zeros(T, dtype=torch.int32, device=dev)
        inner_done = ~running0
        converged = torch.zeros(T, dtype=torch.bool, device=dev)
        it = 0
        while it < cfg.max_newton_iterations and trace.sites.lsq_newton.live_lanes(~inner_done):
            act = ~inner_done
            res = single_iteration(
                st.elements, epoch, st.selection, obs, free, cfg.propagator, ephem, jac_dtype,
                kepler_warm=(st.kepler[..., 0], st.kepler[..., 1], st.kepler[..., 2]),
            )

            inv_fail = act & ~res.inversion_ok
            bizarre = act & ~inv_fail & _elements_bizarre(res.corrected, limits)
            had_prev = prev_rms < _BIG
            ratio = res.normalised_rms / prev_rms
            diverged = (
                act & ~inv_fail & ~bizarre & had_prev
                & (it >= cfg.divergence_grace_iterations)
                & (ratio >= cfg.rms_divergence_ratio)
            )
            stagnated = (
                act & ~inv_fail & ~bizarre & ~diverged & had_prev
                & (ratio >= cfg.rms_stagnation_ratio)
            )
            stagn = torch.where(stagnated, stagn + 1, 0).to(torch.int32)
            stagn_break = stagnated & (stagn >= cfg.max_stagnation_iterations)

            advance = act & ~inv_fail & ~bizarre & ~diverged & ~stagn_break
            conv = advance & (res.correction_norm < cfg.convergence_threshold)

            status = torch.where(
                inv_fail,
                STATUS_INVERSION_FAILED,
                torch.where(
                    bizarre, STATUS_BIZARRE,
                    torch.where(diverged, STATUS_DIVERGED, st.status),
                ),
            ).to(torch.int32)

            a1 = advance[:, None]
            a2 = advance[:, None, None]
            st = st._replace(
                elements=torch.where(a1, res.corrected, st.elements),
                status=status,
                last_rms=torch.where(advance, res.normalised_rms, st.last_rms),
                last_cov=torch.where(a2, res.covariance, st.last_cov),
                last_normal=torch.where(a2, res.normal_matrix, st.last_normal),
                last_m=torch.where(advance, res.num_measurements, st.last_m),
                last_res_ra=torch.where(a1, res.residual_ra, st.last_res_ra),
                last_res_dec=torch.where(a1, res.residual_dec, st.last_res_dec),
                last_dra=torch.where(a2, res.d_ra, st.last_dra),
                last_ddec=torch.where(a2, res.d_dec, st.last_ddec),
                inv_ok_last=torch.where(advance, res.inversion_ok, st.inv_ok_last),
                total_newton=st.total_newton + act.to(torch.int32),
                # gated on activity: a done lane's re-solve would dither by
                # ~1 ulp per extra trip and make results depend on the batch
                kepler=torch.where(act[:, None, None], res.kepler, st.kepler),
            )
            inner_done = inner_done | inv_fail | bizarre | diverged | stagn_break | conv
            prev_rms = torch.where(advance, res.normalised_rms, prev_rms)
            converged = converged | conv
            it += 1
        return st, converged

    def outlier_step(st: _St):
        """Projection chi^2 update."""
        cov = st.last_cov
        var_ra = obs.sigma_ra**2
        var_dec = obs.sigma_dec**2
        gca = torch.sum(cov[:, None] * st.last_dra[..., None, :], -1)
        gcd = torch.sum(cov[:, None] * st.last_ddec[..., None, :], -1)
        # projection term for ACTIVE observations only
        wa = (st.selection == SEL_ACTIVE).to(torch.float64)
        paa = torch.sum(st.last_dra * gca, dim=-1) * wa
        pdd = torch.sum(st.last_ddec * gcd, dim=-1) * wa
        pad = torch.sum(st.last_dra * gcd, dim=-1) * wa
        v00 = var_ra - paa
        v11 = var_dec - pdd
        v01 = -pad
        det = v00 * v11 - v01 * v01
        scale = torch.maximum(torch.abs(v00), torch.abs(v11))
        singular = (torch.abs(det) < _EPS * scale**2) | (scale == 0.0)
        det_safe = torch.where(singular, 1.0, det)
        # chi^2 = xi^T V^-1 xi with analytic 2x2 inverse
        xr, xd = st.last_res_ra, st.last_res_dec
        chi2 = (v11 * xr * xr - 2.0 * v01 * xr * xd + v00 * xd * xd) / det_safe

        sel = st.selection
        orc = cfg.outlier_rejection
        reject = (sel == SEL_ACTIVE) & ~singular & (chi2 > orc.chi_squared_rejection_threshold)
        recover = (sel == SEL_REJECTED) & ~singular & (chi2 <= orc.chi_squared_recovery_threshold)
        new_sel = torch.where(
            reject, SEL_REJECTED, torch.where(recover, SEL_ACTIVE, sel)
        ).to(torch.int32)
        changes = torch.sum((reject | recover) & obs.valid, dim=-1)
        return new_sel, changes

    def outer_body(outer_pass, st: _St):
        st, inner_converged = inner_loop(st)
        running = st.status == STATUS_RUNNING

        if not cfg.enable_outlier_rejection:
            return st._replace(outer_done=st.outer_done | running)

        clean = (st.last_rms < cfg.convergence_before_rejection_threshold) & (outer_pass == 0)
        done_now = running & ~st.outer_done & (clean | ~inner_converged)
        # the chi^2 projection is only needed for lanes still in play
        need = running & ~st.outer_done & ~done_now
        if not trace.sites.lsq_outlier.live_lanes(need):
            return st._replace(outer_done=st.outer_done | done_now)
        new_sel, changes = outlier_step(st)
        stable = need & (changes == 0)
        return st._replace(
            selection=torch.where(need[:, None], new_sel, st.selection),
            outer_done=st.outer_done | done_now | stable,
        )

    # exits as soon as every trajectory is settled
    p = 0
    while p < cfg.max_outlier_rejection_passes + 1 and trace.sites.lsq_passes.live_lanes(
        (st.status == STATUS_RUNNING) & ~st.outer_done
    ):
        st = outer_body(p, st)
        p += 1

    if mixed:
        # one float64 linearization at the converged elements refreshes what
        # the float32 Jacobians accumulated (the elements do not move)
        res = single_iteration(
            st.elements, epoch, st.selection, obs, free, cfg.propagator, ephem,
            kepler_warm=(st.kepler[..., 0], st.kepler[..., 1], st.kepler[..., 2]),
        )
        keep = (st.status == STATUS_RUNNING) & res.inversion_ok
        k1, k2 = keep[:, None], keep[:, None, None]
        st = st._replace(
            last_rms=torch.where(keep, res.normalised_rms, st.last_rms),
            last_cov=torch.where(k2, res.covariance, st.last_cov),
            last_normal=torch.where(k2, res.normal_matrix, st.last_normal),
            last_m=torch.where(keep, res.num_measurements, st.last_m),
            last_res_ra=torch.where(k1, res.residual_ra, st.last_res_ra),
            last_res_dec=torch.where(k1, res.residual_dec, st.last_res_dec),
        )

    # final status: running lanes that completed the loops are OK
    status = torch.where(st.status == STATUS_RUNNING, STATUS_OK, st.status).to(torch.int32)

    # covariance rescale (least_square.rs:371-391)
    n_free = int(sum(cfg.free_elements))
    m = st.last_m
    factor = torch.sqrt(
        m.to(torch.float64) / torch.clamp(m - n_free, min=1).to(torch.float64)
    )
    mu = torch.where(
        n_free < m,
        torch.where(st.last_rms > 1.0, st.last_rms * factor, factor),
        1.0,
    )
    mu2 = (mu * mu)[:, None, None]
    cov = st.last_cov * mu2
    normal = st.last_normal / mu2

    rms_out = torch.where(st.last_rms < _BIG, st.last_rms, float("inf"))
    return DiffCorResult(
        st.elements, status, rms_out, cov, normal, st.selection, st.last_m,
        st.total_newton,
    ), prewarm
