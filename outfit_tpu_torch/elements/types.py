"""Batched orbital element sets and conversions.

Port of the Keplerian and equinoctial half of ``outfit_tpu/elements/types.py``:
NamedTuples of tensors with a shared leading batch shape.  Element ordering
in 6-vectors: Keplerian [a, e, i, Omega, omega, M], Equinoctial
[a, h, k, p, q, lambda].
"""

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
