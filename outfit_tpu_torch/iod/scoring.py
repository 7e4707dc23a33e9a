"""Batched apparent positions and RMS orbit scoring.

Port of ``outfit_tpu/iod/scoring.py``:

* apparent position: topocentric (RA, Dec) with first-order aberration
  (``observation_ephemeris.rs:222-275``, ``aberration.rs:112``),
* ``ephemeris_error`` (:388-416): (cos(dec) dRA/sigma_RA)^2 + (dDec/sigma)^2
  with RA wrapping,
* ``rms_orbit_error`` (``trajectory.rs:352-427``): RMS over the triplet's
  time window, denominator 2N, by full masked evaluation.

Elements are equinoctial in the ecliptic J2000 frame; states are rotated
to equatorial before the topocentric geometry.  Non-elliptic candidates
(e >= 1) and unconverged propagations score +inf.
"""

import math

import torch

from outfit_tpu_torch import trace
from outfit_tpu_torch.constants import DPI, ROT_ECLMJ2000_TO_EQUMJ2000, VLIGHT_AU
from outfit_tpu_torch.elements.twobody import propagate_twobody
from outfit_tpu_torch.elements.types import EquinoctialElements
from outfit_tpu_torch.utils.linalg import norm3, rotate3
from outfit_tpu_torch.utils.tensors import lanewise


def correct_aberration_first_order(relative, velocity):
    """d' = d - (|d|/c) * v.  Parity: ``aberration.rs:112``."""
    dist = norm3(relative)[..., None]
    return relative - dist / VLIGHT_AU * velocity


def apparent_radec(ast_pos_equ, ast_vel_equ, obs_pos_equ):
    """Topocentric (RA, Dec) with first-order aberration, batched."""
    cor = correct_aberration_first_order(ast_pos_equ - obs_pos_equ, ast_vel_equ)
    x, y, z = cor[..., 0], cor[..., 1], cor[..., 2]
    dec = lanewise(torch.atan2, z, lanewise(torch.hypot, x, y))
    ra = torch.remainder(lanewise(torch.atan2, y, x), DPI)
    return ra, dec


def ephemeris_error_terms(eq: EquinoctialElements, obs_mjd, obs_ra, obs_dec, sig_ra, sig_dec, obs_helio_pos_equ):
    """Per-observation weighted squared residuals.  Element fields (...,),
    observation arrays (..., N), ``obs_helio_pos_equ`` (..., N, 3)."""
    st = propagate_twobody(
        EquinoctialElements(eq.reference_epoch, *(f[..., None] for f in eq[1:])),
        eq.reference_epoch[..., None],
        obs_mjd,
        compute_derivatives=False,
    )
    pos_equ = rotate3(ROT_ECLMJ2000_TO_EQUMJ2000, st.position)
    vel_equ = rotate3(ROT_ECLMJ2000_TO_EQUMJ2000, st.velocity)
    ra, dec = apparent_radec(pos_equ, vel_equ, obs_helio_pos_equ)

    diff_ra = torch.remainder(obs_ra - ra, DPI)
    diff_ra = torch.where(diff_ra > math.pi, diff_ra - DPI, diff_ra)
    diff_dec = obs_dec - dec
    term_ra = (torch.cos(obs_dec) * diff_ra / sig_ra) ** 2
    term_dec = (diff_dec / sig_dec) ** 2
    # an unconverged Kepler solve leaves stale angles: score it inf
    return torch.where(st.converged, term_ra + term_dec, torch.inf)


def rms_orbit_error(eq: EquinoctialElements, obs_mjd, obs_ra, obs_dec, sig_ra, sig_dec, obs_helio_pos_equ, window_mask):
    """Masked-window RMS = sqrt(sum(terms) / (2 N)); +inf when the orbit is
    non-elliptic or the window is empty.  Runs inside the span
    ``iod.scoring`` of :mod:`outfit_tpu_torch.trace`."""
    with trace.span("iod.scoring"):
        terms = ephemeris_error_terms(eq, obs_mjd, obs_ra, obs_dec, sig_ra, sig_dec, obs_helio_pos_equ)
        terms = torch.where(window_mask, terms, 0.0)
        n = torch.sum(window_mask, dim=-1)
        denom = 2.0 * torch.clamp(n, min=1).to(terms.dtype)
        rms = torch.sqrt(torch.sum(terms, dim=-1) / denom)
        ok = (eq.eccentricity() < 1.0) & (n > 0) & torch.isfinite(rms)
        return torch.where(ok, rms, torch.inf)
