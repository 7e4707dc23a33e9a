"""N-body propagation of equinoctial elements with STM-propagated Jacobians.

Port of ``outfit_tpu/propagator/nbody.py``:

* 42-component augmented state [r, v, Phi(6x6)] in the ecliptic J2000
  heliocentric frame,
* Newtonian perturber accelerations with the Sun's direct term providing
  the Keplerian central force; perturber positions frozen at t0 by default
  or, with ``NBodyConfig(frozen_perturbers=False)``, interpolated from the
  ephemeris tables at every integrator stage time,
* the heliocentric indirect term a_ind = -GM_i r_i/|r_i|^3, and perturber
  states rotated from equatorial J2000 into the ecliptic integration frame,
* variational equations dPhi/dt = A Phi, A = [[0, I], [da/dr, 0]],
* element Jacobians J(t1) = Phi(t1) @ J0 with J0 from the analytic
  two-body Jacobians at t0,
* dt < 1e-14 short-circuit.

The integration runs on ``device``, by default the card when one is
present, with the inputs and the ephemeris tables moved there; on a CUDA
device every perturber lookup is a launch of the Chebyshev kernel (through
``JPLEphem.body_ephemeris``).
"""

from typing import NamedTuple

import numpy as np
import torch

from outfit_tpu_torch import trace
from outfit_tpu_torch.constants import ROT_EQUMJ2000_TO_ECLMJ2000
from outfit_tpu_torch.elements.twobody import propagate_twobody
from outfit_tpu_torch.elements.types import EquinoctialElements
from outfit_tpu_torch.ephem.bodies import Body, gm_au3_day2
from outfit_tpu_torch.propagator.config import NBodyConfig
from outfit_tpu_torch.propagator.dop853 import dop853_integrate
from outfit_tpu_torch.utils.linalg import rotate3
from outfit_tpu_torch.utils.tensors import as_f64, device_constant, input_device

_EYE3 = np.eye(3)
_EYE6_FLAT = np.eye(6).reshape(36)


class NBodyResult(NamedTuple):
    position: torch.Tensor  # (..., 3) ecliptic J2000, AU
    velocity: torch.Tensor  # (..., 3) AU/day
    dpos_delem: torch.Tensor  # (..., 6, 3)
    dvel_delem: torch.Tensor  # (..., 6, 3)
    status: torch.Tensor  # 0 ok
    n_steps: torch.Tensor  # accepted DOP853 steps per lane


def _perturber_gms(config: NBodyConfig, device=None) -> torch.Tensor:
    gms = []
    for b in config.perturbing_bodies:
        body = Body(b)
        gm = gm_au3_day2(body)
        if gm is None:
            raise ValueError(f"no GM for perturbing body {body!r}")
        gms.append(gm)
    return torch.as_tensor(np.array(gms), dtype=torch.float64, device=device)


def _perturber_positions(ephem, config: NBodyConfig, t_mjd):
    """Heliocentric ECLIPTIC perturber positions at epoch(s) ``t_mjd``, on
    the ephemeris tables' device.

    ``t_mjd`` may be batched (...,); returns (..., P, 3).  One table lookup
    per non-Sun body, so it can run inside the integrator's right-hand
    side."""
    t_mjd = as_f64(t_mjd, ephem.device)
    # stacked, then rotated together: per element the arithmetic of rotating
    # each body alone (the Sun's zeros stay zeros)
    p_equ = torch.stack(
        [ephem.body_ephemeris(Body(b), t_mjd)[0] for b in config.perturbing_bodies], dim=-2
    )
    return rotate3(ROT_EQUMJ2000_TO_ECLMJ2000, p_equ)


def perturber_snapshots(ephem, config: NBodyConfig, t0_mjd):
    """Heliocentric ECLIPTIC positions + GMs of the perturbers at epoch t0.

    ``t0_mjd`` may be batched (...,); returns (pos (..., P, 3), gm (P,)).
    """
    pos = _perturber_positions(ephem, config, t0_mjd)
    return pos, _perturber_gms(config, pos.device)


def _indirect_acceleration(pert_pos, gm):
    """The heliocentric indirect term -sum_i GM_i r_i / |r_i|^3; Sun lanes
    (|r_i| ~ 0) are skipped."""
    rp2 = torch.sum(pert_pos * pert_pos, dim=-1)
    rpn = torch.sqrt(rp2)
    is_sun = rpn <= 1e-10
    rpm3 = torch.where(is_sun, 0.0, 1.0 / torch.where(is_sun, 1.0, rp2 * rpn))
    return -torch.sum((gm * rpm3)[..., None] * pert_pos, dim=-2)


def _acceleration_and_gradient(r, pert_pos, gm, acc_indirect=None):
    """Total heliocentric acceleration + gravity gradient da/dr.

    r (..., 3); pert_pos (..., P, 3); gm (P,).  ``acc_indirect``: the
    indirect term where the caller holds it already (it depends on the
    perturbers alone, so frozen perturbers give one value for the whole
    integration).  Every reduction runs over the perturber axis or a
    3-vector, never over lanes.
    """
    d = r[..., None, :] - pert_pos  # (..., P, 3)
    d2 = torch.sum(d * d, dim=-1)
    dn = torch.sqrt(d2)
    dm3 = 1.0 / (d2 * dn)
    gdm3 = gm * dm3
    acc_direct = -torch.sum(gdm3[..., None] * d, dim=-2)
    if acc_indirect is None:
        acc_indirect = _indirect_acceleration(pert_pos, gm)

    eye = device_constant(_EYE3, r.device)
    dm5 = dm3 / d2
    w = gm * 3.0 * dm5  # (..., P)
    grad = torch.sum(
        w[..., None, None] * d[..., :, None] * d[..., None, :], dim=-3
    ) - torch.sum(gdm3, dim=-1)[..., None, None] * eye
    return acc_direct + acc_indirect, grad


def propagate_nbody(
    eq: EquinoctialElements,
    t1_mjd_tt,
    ephem,
    config: NBodyConfig = NBodyConfig(),
    device=None,
) -> NBodyResult:
    """Propagate equinoctial elements under N-body dynamics with Jacobians.

    Batched over the elements' leading shape; ``t1`` broadcastable.
    ``device``: where the integration runs and the result lies; default
    ``"cuda"`` when a card is present (the card of a CUDA tensor among the
    elements and ``t1``), else ``"cpu"``.
    """
    with trace.span("propagate"):
        dev = input_device(device, *eq, t1_mjd_tt)
        ephem = ephem.to(dev)
        t0r = as_f64(eq.reference_epoch, dev).to(dev)
        t1r = as_f64(t1_mjd_tt, dev).to(dev)
        batch = torch.broadcast_shapes(t0r.shape, t1r.shape)
        t0 = torch.broadcast_to(t0r, batch)
        t1 = torch.broadcast_to(t1r, batch)
        eq = EquinoctialElements(*[torch.broadcast_to(as_f64(f, dev).to(dev), batch) for f in eq])

        # initial state + analytic element Jacobians at t0
        init = propagate_twobody(eq, 0.0, 0.0, compute_derivatives=True)
        j0 = torch.cat([init.dpos_delem, init.dvel_delem], dim=-1)  # (...,6,6)
        # rows = elements, cols = (pos, vel); STM right-multiplies J0^T

        gm = _perturber_gms(config, dev)
        if config.frozen_perturbers:
            # snapshot semantics: positions at t0, accurate for arcs of up to
            # ~30 days
            pert_pos = _perturber_positions(ephem, config, t0)
            acc_ind = _indirect_acceleration(pert_pos, gm)

        phi0 = torch.broadcast_to(device_constant(_EYE6_FLAT, dev), batch + (36,))
        y0 = torch.cat([init.position, init.velocity, phi0], dim=-1)

        def rhs(t, y):
            r = y[..., 0:3]
            v = y[..., 3:6]
            phi = y[..., 6:42].reshape(y.shape[:-1] + (6, 6))
            if config.frozen_perturbers:
                acc, grad = _acceleration_and_gradient(r, pert_pos, gm, acc_ind)
            else:
                # time-varying perturbers: table lookup at each integration time
                acc, grad = _acceleration_and_gradient(r, _perturber_positions(ephem, config, t), gm)
            # A = [[0, I], [grad, 0]] exploited structurally: rows 0-2 of dPhi
            # are Phi rows 3-5, rows 3-5 are grad @ Phi[0:3]
            dphi_bot = torch.sum(grad[..., :, :, None] * phi[..., None, 0:3, :], dim=-2)
            # y[..., 24:42] is Phi rows 3-5, flattened
            return torch.cat(
                [v, acc, y[..., 24:42], dphi_bot.reshape(y.shape[:-1] + (18,))], dim=-1
            )

        res = dop853_integrate(
            rhs, y0, t0, t1, rtol=config.rel_tol, atol=config.abs_tol,
            max_steps=config.max_steps, device=dev,
        )

        pos1 = res.y[..., 0:3]
        vel1 = res.y[..., 3:6]
        phi1 = res.y[..., 6:42].reshape(batch + (6, 6))

        # J(t1) = Phi(t1) @ J0_state, with J0_state (6state x 6elem) = j0^T
        j_state = torch.sum(
            phi1[..., None, :, :] * j0[..., :, None, :], dim=-1
        )  # (..., 6elem, 6state)
        dpos = j_state[..., 0:3]
        dvel = j_state[..., 3:6]

        # dt ~ 0 short-circuit
        tiny = torch.abs(t1 - t0) < 1e-14
        pos1 = torch.where(tiny[..., None], init.position, pos1)
        vel1 = torch.where(tiny[..., None], init.velocity, vel1)
        dpos = torch.where(tiny[..., None, None], init.dpos_delem, dpos)
        dvel = torch.where(tiny[..., None, None], init.dvel_delem, dvel)
        status = torch.where(tiny, 0, res.status).to(torch.int32)
        n_steps = torch.where(tiny, 0, res.n_steps).to(torch.int32)

        return NBodyResult(pos1, vel1, dpos, dvel, status, n_steps)
