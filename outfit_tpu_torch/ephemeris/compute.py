"""Batched apparent-position + geometry core.

Port of ``outfit_tpu/ephemeris/compute.py``:

* ``ApparentPosition``: RA/Dec (equatorial J2000) + geocentric and
  heliocentric distances,
* first/second-order aberration (second order = two-pass Keplerian
  retro-propagation with the two-body propagator),
* ``BodyGeometry``: phase angle, solar elongation, topocentric radial
  velocity, dRA/dt, dDec/dt with clamped acos and the true topocentric
  velocity v_body - v_obs,
* e >= 1 precheck: flagged per lane.

Batched over any common leading shape of (elements, epochs, observer
states), on the epochs' device.
"""

from typing import NamedTuple

import torch

from outfit_tpu_torch.constants import DPI, ROT_ECLMJ2000_TO_EQUMJ2000, VLIGHT_AU
from outfit_tpu_torch.elements.twobody import propagate_twobody
from outfit_tpu_torch.elements.types import EquinoctialElements
from outfit_tpu_torch.ephemeris.config import AberrationOrder
from outfit_tpu_torch.propagator.config import PropagatorKind
from outfit_tpu_torch.utils.linalg import norm3, rotate3
from outfit_tpu_torch.utils.tensors import as_f64, lanewise


class ApparentPosition(NamedTuple):
    ra: torch.Tensor
    dec: torch.Tensor
    geocentric_distance: torch.Tensor
    heliocentric_distance: torch.Tensor


class BodyGeometry(NamedTuple):
    phase_angle: torch.Tensor
    solar_elongation: torch.Tensor
    radial_velocity: torch.Tensor
    d_ra_dt: torch.Tensor
    d_dec_dt: torch.Tensor


class EphemerisOutput(NamedTuple):
    position: ApparentPosition
    geometry: BodyGeometry
    ok: torch.Tensor  # per-lane validity (elliptic + converged)


def _broadcast_elements(eq: EquinoctialElements, shape, device):
    return EquinoctialElements(*[torch.broadcast_to(as_f64(f, device), shape) for f in eq])


def _propagate_equ(eq: EquinoctialElements, epochs, propagator, ephem):
    """Heliocentric state at the epochs, rotated to equatorial J2000."""
    if propagator.nbody:
        from outfit_tpu_torch.propagator.nbody import propagate_nbody

        st = propagate_nbody(eq, epochs, ephem, propagator.config, device=epochs.device)
        pos_ecl, vel_ecl, conv = st.position, st.velocity, st.status == 0
    else:
        st = propagate_twobody(eq, eq.reference_epoch, epochs, compute_derivatives=False)
        pos_ecl, vel_ecl, conv = st.position, st.velocity, st.converged
    return (
        rotate3(ROT_ECLMJ2000_TO_EQUMJ2000, pos_ecl),
        rotate3(ROT_ECLMJ2000_TO_EQUMJ2000, vel_ecl),
        conv,
    )


def _aberrated_topocentric(
    eq, epochs, ast_pos, ast_vel, obs_pos, order: AberrationOrder
):
    topo = ast_pos - obs_pos
    if order == AberrationOrder.FIRST:
        dt = norm3(topo)[..., None] / VLIGHT_AU
        return topo - dt * ast_vel

    # second order: two-pass Keplerian retro-propagation
    def retro(separation):
        t_ret = epochs - separation / VLIGHT_AU
        st = propagate_twobody(eq, eq.reference_epoch, t_ret, compute_derivatives=False)
        return rotate3(ROT_ECLMJ2000_TO_EQUMJ2000, st.position)

    r1 = retro(norm3(topo))
    d1 = r1 - obs_pos
    r2 = retro(norm3(d1))
    return r2 - obs_pos


def compute_apparent(
    eq: EquinoctialElements,
    epochs,
    obs_pos_equ,
    obs_vel_equ,
    propagator: PropagatorKind = PropagatorKind.two_body(),
    aberration: AberrationOrder = AberrationOrder.FIRST,
    ephem=None,
) -> EphemerisOutput:
    """Apparent position + geometry for batched (epoch, observer) lanes.

    ``eq`` fields broadcastable against ``epochs`` (...,);
    ``obs_pos_equ``/``obs_vel_equ`` (..., 3) observer heliocentric states.
    """
    epochs = as_f64(epochs)
    dev = epochs.device
    obs_pos_equ = as_f64(obs_pos_equ, dev)
    obs_vel_equ = as_f64(obs_vel_equ, dev)
    eqb = _broadcast_elements(eq, epochs.shape, dev)
    ast_pos, ast_vel, conv = _propagate_equ(eqb, epochs, propagator, ephem)

    topo = _aberrated_topocentric(
        eqb, epochs, ast_pos, ast_vel, obs_pos_equ, aberration
    )
    x, y, z = topo[..., 0], topo[..., 1], topo[..., 2]
    rho_xy = lanewise(torch.hypot, x, y)
    rho = norm3(topo)
    ra = torch.remainder(lanewise(torch.atan2, y, x), DPI)
    dec = lanewise(torch.atan2, z, rho_xy)

    r_helio = norm3(ast_pos)
    r_obs = norm3(obs_pos_equ)

    pos_out = ApparentPosition(ra, dec, rho, r_helio)

    rho_safe = torch.where(rho > 0, rho, 1.0)
    cos_phase = torch.sum(ast_pos * topo, dim=-1) / (
        torch.where(r_helio > 0, r_helio, 1.0) * rho_safe
    )
    phase = torch.acos(torch.clamp(cos_phase, -1.0, 1.0))
    cos_elong = torch.sum(-obs_pos_equ * topo, dim=-1) / (
        torch.where(r_obs > 0, r_obs, 1.0) * rho_safe
    )
    elong = torch.acos(torch.clamp(cos_elong, -1.0, 1.0))

    v_topo = ast_vel - obs_vel_equ
    rdot = torch.sum(topo * v_topo, dim=-1) / rho_safe

    rho_xy2 = torch.clamp(rho_xy * rho_xy, min=1e-300)
    d_ra_dt = (x * v_topo[..., 1] - y * v_topo[..., 0]) / rho_xy2
    rho2 = torch.clamp(rho * rho, min=1e-300)
    d_dec_dt = (
        v_topo[..., 2] * rho_xy
        - z * (x * v_topo[..., 0] + y * v_topo[..., 1]) / torch.clamp(rho_xy, min=1e-300)
    ) / rho2

    geom = BodyGeometry(phase, elong, rdot, d_ra_dt, d_dec_dt)

    elliptic = eqb.eccentricity() < 1.0
    ok = conv & elliptic & torch.isfinite(ra) & (rho > 0)
    return EphemerisOutput(pos_out, geom, ok)
