"""Batched orbital element sets and conversions.

Port of ``outfit_tpu/elements/types.py`` without the Jacobians: NamedTuples
of tensors with a shared leading batch shape.  Element ordering in
6-vectors: Keplerian [a, e, i, Omega, omega, M], Equinoctial
[a, h, k, p, q, lambda], Cometary [q, e, i, Omega, omega, nu].
"""

import math
from typing import NamedTuple

import torch

from outfit_tpu_torch.kepler.angles import principal_angle

_EPS_REG = 1.0e-12  # near-circular / near-equatorial regularization threshold


class KeplerianElements(NamedTuple):
    reference_epoch: torch.Tensor
    semi_major_axis: torch.Tensor
    eccentricity: torch.Tensor
    inclination: torch.Tensor
    ascending_node_longitude: torch.Tensor
    periapsis_argument: torch.Tensor
    mean_anomaly: torch.Tensor


class EquinoctialElements(NamedTuple):
    reference_epoch: torch.Tensor
    semi_major_axis: torch.Tensor
    h: torch.Tensor  # e sin(Omega + omega)
    k: torch.Tensor  # e cos(Omega + omega)
    p: torch.Tensor  # tan(i/2) sin Omega
    q: torch.Tensor  # tan(i/2) cos Omega
    mean_longitude: torch.Tensor

    def eccentricity(self):
        return torch.sqrt(self.h**2 + self.k**2)


class CometaryElements(NamedTuple):
    reference_epoch: torch.Tensor
    perihelion_distance: torch.Tensor
    eccentricity: torch.Tensor
    inclination: torch.Tensor
    ascending_node_longitude: torch.Tensor
    periapsis_argument: torch.Tensor
    true_anomaly: torch.Tensor


class EquinoctialLimits(NamedTuple):
    """Bizarre-orbit bounds."""

    eccentricity_limit: float = 1.2
    min_semi_major_axis: float = 1e-6
    max_semi_major_axis: float = 1e4
    min_periapsis_distance: float = 1e-6
    max_apoapsis_distance: float = 1e4


def is_bizarre(eq: EquinoctialElements, limits: EquinoctialLimits = EquinoctialLimits()):
    """True where the elements leave the EquinoctialLimits box."""
    e = eq.eccentricity()
    a = eq.semi_major_axis
    peri = a * (1.0 - e)
    apo = a * (1.0 + e)
    return (
        (e > limits.eccentricity_limit)
        | (a < limits.min_semi_major_axis)
        | (a > limits.max_semi_major_axis)
        | (peri < limits.min_periapsis_distance)
        | (apo > limits.max_apoapsis_distance)
    )


def keplerian_to_equinoctial(kep: KeplerianElements) -> EquinoctialElements:
    dig = kep.ascending_node_longitude + kep.periapsis_argument
    h = kep.eccentricity * torch.sin(dig)
    k = kep.eccentricity * torch.cos(dig)
    t = torch.tan(kep.inclination / 2.0)
    p = t * torch.sin(kep.ascending_node_longitude)
    q = t * torch.cos(kep.ascending_node_longitude)
    lam = principal_angle(dig + kep.mean_anomaly)
    return EquinoctialElements(kep.reference_epoch, kep.semi_major_axis, h, k, p, q, lam)


def equinoctial_to_keplerian(eq: EquinoctialElements) -> KeplerianElements:
    ecc = torch.sqrt(eq.h**2 + eq.k**2)
    dig = torch.where(ecc < _EPS_REG, 0.0, torch.atan2(eq.h, eq.k))
    tgi2 = torch.sqrt(eq.p**2 + eq.q**2)
    node = torch.where(tgi2 < _EPS_REG, 0.0, torch.atan2(eq.p, eq.q))
    incl = 2.0 * torch.atan(tgi2)
    argp = principal_angle(dig - node)
    mean_anom = principal_angle(eq.mean_longitude - dig)
    return KeplerianElements(
        eq.reference_epoch, eq.semi_major_axis, ecc, incl, node, argp, mean_anom
    )


def cometary_to_keplerian(com: CometaryElements) -> KeplerianElements:
    """Cometary -> Keplerian; the mean anomaly is the hyperbolic M for e > 1
    and the elliptic one for e < 1.  Parabolic lanes give a non-finite a;
    callers gate on that.  Parity: ``cometary_to_keplerian`` (:264-290)."""
    e = com.eccentricity
    p_slr = com.perihelion_distance * (1.0 + e)
    one = e * e - 1.0
    a = -p_slr / torch.where(torch.abs(one) > 0.0, one, math.nan)

    s = torch.sqrt(torch.abs(e - 1.0) / (e + 1.0))
    t = torch.tan(0.5 * com.true_anomaly)
    # hyperbolic branch: H = 2 atanh(s tan(nu/2)), M = e sinh H - H
    x = torch.clamp(s * t, -1.0 + 1e-15, 1.0 - 1e-15)
    hh = 2.0 * torch.atanh(x)
    m_hyp = e * torch.sinh(hh) - hh
    # elliptic branch: E = 2 atan(s tan(nu/2)), M = E - e sin E
    ee = 2.0 * torch.atan(s * t)
    m_ell = ee - e * torch.sin(ee)
    m = torch.where(e < 1.0, m_ell, m_hyp)
    return KeplerianElements(
        com.reference_epoch, a, e, com.inclination,
        com.ascending_node_longitude, com.periapsis_argument, m,
    )


def cometary_to_equinoctial(com: CometaryElements) -> EquinoctialElements:
    return keplerian_to_equinoctial(cometary_to_keplerian(com))
