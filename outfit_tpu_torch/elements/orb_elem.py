"""Cartesian state -> orbital elements (ccek1) and dynamic acceptability.

Port of ``outfit_tpu/elements/orb_elem.py`` (reference ``src/orb_elem.rs``):
``ccek1`` classifies 1/a into Keplerian or Cometary element sets with the
equatorial and near-parabolic regularizations; ``eccentricity_control``
derives (accepted, e, q, energy) from the Lenz-Runge vector.  A per-lane
``kind`` code selects the meaning of the 6 element slots:

    kind == KIND_KEPLERIAN: (a, e, i, Omega, omega, M)     - elliptic
    kind == KIND_COMETARY:  (q, e, i, Omega, omega, nu)    - parabolic/hyperbolic
"""

from typing import NamedTuple

import torch

from outfit_tpu_torch.constants import GAUSS_GRAV_SQUARED
from outfit_tpu_torch.kepler.angles import principal_angle as _wrap
from outfit_tpu_torch.utils.linalg import cross3, norm3
from outfit_tpu_torch.utils.tensors import as_floats, lanewise

_EPS = torch.finfo(torch.float64).eps

KIND_KEPLERIAN = 0
KIND_COMETARY = 1

_EPS_EQ = 1e-15  # equatorial-orbit threshold on sin(i)
_EPS_PARAB = 1e-12  # near-parabolic threshold on 1/a
_EPS_E = 5e-15  # |e - 1| near-parabolic threshold


def eccentricity_control(position, velocity, peri_max, ecc_max):
    """(accepted, eccentricity, perihelion, energy) for batched states.

    Parity: ``src/orb_elem.rs:257-301``; degenerate angular momentum lanes
    are not accepted.  Runs in the inputs' precision."""
    position, velocity = as_floats(position, velocity)
    mu = GAUSS_GRAV_SQUARED

    v2 = torch.sum(velocity * velocity, dim=-1)
    r = norm3(position)
    h = cross3(position, velocity)
    h2 = torch.sum(h * h, dim=-1)
    degenerate = torch.sqrt(h2) == 0.0

    r_safe = torch.where(r > 0.0, r, 1.0)
    lenz = cross3(velocity, h) / mu - position / r_safe[..., None]
    ecc = norm3(lenz)
    peri = h2 / (mu * (1.0 + ecc))
    energy = v2 / 2.0 - mu / r_safe

    accepted = (~degenerate) & (ecc < ecc_max) & (peri < peri_max)
    return accepted, ecc, peri, energy


class StateElements(NamedTuple):
    """Batched output of :func:`ccek1` (see module docstring)."""

    kind: torch.Tensor  # int32
    elements: torch.Tensor  # (..., 6)


def ccek1(position, velocity):
    """Cartesian heliocentric state (ecliptic J2000) -> orbital elements.
    Parity: ``src/orb_elem.rs:58-226``.  Runs in the inputs' precision."""
    position, velocity = as_floats(position, velocity)
    mu = GAUSS_GRAV_SQUARED

    # 1) angular momentum and orbital plane
    h = cross3(position, velocity)
    h2 = torch.sum(h * h, dim=-1)
    hn = torch.sqrt(h2)
    hu = h / torch.where(hn > 0.0, hn, 1.0)[..., None]

    sin_i = torch.sqrt(hu[..., 0] ** 2 + hu[..., 1] ** 2)
    incl = _wrap(lanewise(torch.atan2, sin_i, hu[..., 2]))
    equatorial = sin_i <= _EPS_EQ
    incl = torch.where(equatorial, 0.0, incl)
    node = torch.where(equatorial, 0.0, _wrap(lanewise(torch.atan2, hu[..., 0], -hu[..., 1])))

    # 2) rotate into the orbital frame: R = rotmt(i, X) @ rotmt(node, Z)
    ci, si = torch.cos(incl), torch.sin(incl)
    cn, sn = torch.cos(node), torch.sin(node)

    def rot(v):
        x, y, z = v[..., 0], v[..., 1], v[..., 2]
        x1 = cn * x + sn * y
        y1 = -sn * x + cn * y
        y2 = ci * y1 + si * z
        return x1, y2

    px, py = rot(position)
    vx, vy = rot(velocity)

    rv_dot = px * vx + py * vy
    r = torch.sqrt(px * px + py * py)
    v2 = vx * vx + vy * vy

    inv_a = 2.0 / r - v2 / mu

    # --- elliptic branch -----------------------------------------------------
    a = 1.0 / torch.where(torch.abs(inv_a) > _EPS, inv_a, _EPS)
    a_safe = torch.where(inv_a > _EPS_PARAB, a, 1.0)
    n_mot = torch.sqrt(mu / a_safe**3)
    e_sin = rv_dot / (n_mot * a_safe * a_safe)
    e_cos = v2 * r / mu - 1.0
    ecc_k = torch.sqrt(e_sin * e_sin + e_cos * e_cos)

    u = lanewise(torch.atan2, e_sin, e_cos)  # eccentric anomaly
    mean_anom = _wrap(u - ecc_k * torch.sin(u))

    x1 = torch.cos(u) - ecc_k
    rad = torch.sqrt(torch.clamp(1.0 - ecc_k * ecc_k, min=0.0))
    x2 = rad * torch.sin(u)
    nrm = torch.sqrt(x1 * x1 + x2 * x2)
    nrm = torch.where(nrm > 0.0, nrm, 1.0)
    x1n, x2n = x1 / nrm, x2 / nrm
    sin_per = x1n * py - x2n * px
    cos_per = x1n * px + x2n * py
    argp_k = _wrap(lanewise(torch.atan2, sin_per, cos_per))

    # --- cometary branch (parabolic & hyperbolic share the formulas) --------
    p_slr = h2 / mu  # semi-latus rectum
    ec_cos = p_slr / r - 1.0
    ec_sin = rv_dot * p_slr / (torch.where(hn > 0.0, hn, 1.0) * r)
    nu = lanewise(torch.atan2, ec_sin, ec_cos)
    ecc_c = torch.sqrt(ec_cos * ec_cos + ec_sin * ec_sin)
    argp_c = _wrap(lanewise(torch.atan2, py, px) - nu)

    parabolic = torch.abs(inv_a) <= _EPS_PARAB
    near_parab_e = torch.where(
        inv_a > _EPS_PARAB, torch.abs(ecc_k - 1.0) < _EPS_E, torch.abs(ecc_c - 1.0) < _EPS_E
    )
    is_parab = parabolic | near_parab_e

    ecc_out_c = torch.where(is_parab, 1.0, ecc_c)
    q_c = torch.where(is_parab, p_slr / 2.0, p_slr / (1.0 + ecc_out_c))

    elliptic = (inv_a > _EPS_PARAB) & ~is_parab

    kind = torch.where(elliptic, KIND_KEPLERIAN, KIND_COMETARY).to(torch.int32)
    e0 = torch.where(elliptic, a, q_c)
    e1 = torch.where(elliptic, ecc_k, ecc_out_c)
    e4 = torch.where(elliptic, argp_k, argp_c)
    e5 = torch.where(elliptic, mean_anom, nu)
    elements = torch.stack([e0, e1, incl, node, e4, e5], dim=-1)
    return StateElements(kind, elements)

