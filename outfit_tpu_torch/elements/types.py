"""Batched orbital element sets and conversions.

Port of ``outfit_tpu/elements/types.py``: NamedTuples of tensors with a
shared leading batch shape, the conversions, and the 6x6 transformation
Jacobians used for covariance propagation (``keplerian_element.rs:312``,
``equinoctial_element.rs:1049``, ``cometary_element.rs:333-426``).
Element ordering in 6-vectors: Keplerian [a, e, i, Omega, omega, M],
Equinoctial [a, h, k, p, q, lambda], Cometary [q, e, i, Omega, omega, nu].
"""

import math
from typing import NamedTuple, Union

import numpy as np
import torch

from outfit_tpu_torch.kepler.angles import principal_angle
from outfit_tpu_torch.utils.linalg import matmul_small
from outfit_tpu_torch.utils.tensors import as_floats, lanewise

_EPS_REG = 1.0e-12  # near-circular / near-equatorial regularization threshold

_RAD_TO_DEG = 180.0 / 3.141592653589793


def _host(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _fmt_scalar(x):
    a = _host(x)
    return f"{float(a):.6f}" if a.size == 1 else f"<batch {a.shape}>"


def _fmt_angle(x):
    a = _host(x)
    if a.size != 1:
        return f"<batch {a.shape}>"
    v = float(a)
    return f"{v:.6f} rad ({v * _RAD_TO_DEG:.6f}°)"


def _stack(*fields):
    return torch.stack(as_floats(*fields), dim=-1)


class KeplerianElements(NamedTuple):
    reference_epoch: torch.Tensor
    semi_major_axis: torch.Tensor
    eccentricity: torch.Tensor
    inclination: torch.Tensor
    ascending_node_longitude: torch.Tensor
    periapsis_argument: torch.Tensor
    mean_anomaly: torch.Tensor

    @property
    def vector(self):
        return _stack(
            self.semi_major_axis, self.eccentricity, self.inclination, self.ascending_node_longitude,
            self.periapsis_argument, self.mean_anomaly,
        )

    def __str__(self):
        """Parity: KeplerianElements Display (keplerian_element.rs:429-468)."""
        return (
            f"Elements @ epoch (MJD): {_fmt_scalar(self.reference_epoch)}\n"
            "-------------------------------------------\n"
            f"  a   (semi-major axis)       = {_fmt_scalar(self.semi_major_axis)} AU\n"
            f"  e   (eccentricity)          = {_fmt_scalar(self.eccentricity)}\n"
            f"  i   (inclination)           = {_fmt_angle(self.inclination)}\n"
            f"  Ω   (longitude of node)     = {_fmt_angle(self.ascending_node_longitude)}\n"
            f"  ω   (argument of periapsis) = {_fmt_angle(self.periapsis_argument)}\n"
            f"  M   (mean anomaly)          = {_fmt_angle(self.mean_anomaly)}\n"
        )


class EquinoctialElements(NamedTuple):
    reference_epoch: torch.Tensor
    semi_major_axis: torch.Tensor
    h: torch.Tensor  # e sin(Omega + omega)
    k: torch.Tensor  # e cos(Omega + omega)
    p: torch.Tensor  # tan(i/2) sin Omega
    q: torch.Tensor  # tan(i/2) cos Omega
    mean_longitude: torch.Tensor

    @property
    def vector(self):
        return _stack(self.semi_major_axis, self.h, self.k, self.p, self.q, self.mean_longitude)

    @classmethod
    def from_vector(cls, epoch, vec):
        return cls(epoch, *[vec[..., i] for i in range(6)])

    def eccentricity(self):
        return torch.sqrt(self.h**2 + self.k**2)

    def __str__(self):
        """Parity: EquinoctialElements Display (equinoctial_element.rs:1170-1208)."""
        return (
            f"Elements @ epoch (MJD): {_fmt_scalar(self.reference_epoch)}\n"
            "------------------------------------------------\n"
            f"  a   (semi-major axis)            = {_fmt_scalar(self.semi_major_axis)} AU\n"
            f"  h   (e·sin(Ω+ω))                 = {_fmt_scalar(self.h)}\n"
            f"  k   (e·cos(Ω+ω))                 = {_fmt_scalar(self.k)}\n"
            f"  p   (tan(i/2)·sinΩ)              = {_fmt_scalar(self.p)}\n"
            f"  q   (tan(i/2)·cosΩ)              = {_fmt_scalar(self.q)}\n"
            f"  λ   (mean longitude)             = {_fmt_angle(self.mean_longitude)}\n"
        )


class CometaryElements(NamedTuple):
    reference_epoch: torch.Tensor
    perihelion_distance: torch.Tensor
    eccentricity: torch.Tensor
    inclination: torch.Tensor
    ascending_node_longitude: torch.Tensor
    periapsis_argument: torch.Tensor
    true_anomaly: torch.Tensor

    @property
    def vector(self):
        return _stack(
            self.perihelion_distance, self.eccentricity, self.inclination, self.ascending_node_longitude,
            self.periapsis_argument, self.true_anomaly,
        )

    def __str__(self):
        """Parity: CometaryElements Display (cometary_element.rs:508-556)."""
        return (
            f"Elements @ epoch (MJD): {_fmt_scalar(self.reference_epoch)}\n"
            "------------------------------------------------\n"
            f"  q   (perihelion distance)     = {_fmt_scalar(self.perihelion_distance)} AU\n"
            f"  e   (eccentricity)            = {_fmt_scalar(self.eccentricity)}\n"
            f"  i   (inclination)             = {_fmt_angle(self.inclination)}\n"
            f"  Ω   (longitude of node)       = {_fmt_angle(self.ascending_node_longitude)}\n"
            f"  ω   (argument of periapsis)   = {_fmt_angle(self.periapsis_argument)}\n"
            f"  ν   (true anomaly)            = {_fmt_angle(self.true_anomaly)}\n"
        )


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
    dig = torch.where(ecc < _EPS_REG, 0.0, lanewise(torch.atan2, eq.h, eq.k))
    tgi2 = torch.sqrt(eq.p**2 + eq.q**2)
    node = torch.where(tgi2 < _EPS_REG, 0.0, lanewise(torch.atan2, eq.p, eq.q))
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
    hh = 2.0 * lanewise(torch.atanh, x)
    m_hyp = e * lanewise(torch.sinh, hh) - hh
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


# ---------------------------------------------------------------------------
# Jacobians (rows = target, cols = source; batched (..., 6, 6))
# ---------------------------------------------------------------------------


def _mat6(cols):
    """Stack 6 column lists of scalars into (..., 6, 6)."""
    return torch.stack([torch.stack(c, dim=-1) for c in cols], dim=-1)


def jacobian_keplerian_to_equinoctial(kep: KeplerianElements):
    """d(a,h,k,p,q,lambda)/d(a,e,i,Omega,omega,M).
    Parity: ``keplerian_element.rs:312-`` (jacobian_to_equinoctial)."""
    e = kep.eccentricity
    varpi = kep.ascending_node_longitude + kep.periapsis_argument
    sv, cv = torch.sin(varpi), torch.cos(varpi)
    so, co = torch.sin(kep.ascending_node_longitude), torch.cos(kep.ascending_node_longitude)
    half_i = kep.inclination / 2.0
    th = torch.tan(half_i)
    dth = 0.5 / torch.cos(half_i) ** 2

    z = torch.zeros_like(e)
    o = torch.ones_like(e)
    cols = [
        [o, z, z, z, z, z],  # d/da
        [z, sv, cv, z, z, z],  # d/de
        [z, z, z, dth * so, dth * co, z],  # d/di
        [z, e * cv, -e * sv, th * co, -th * so, o],  # d/dOmega
        [z, e * cv, -e * sv, z, z, o],  # d/domega
        [z, z, z, z, z, o],  # d/dM
    ]
    return _mat6(cols)


def jacobian_equinoctial_to_keplerian(eq: EquinoctialElements):
    """d(a,e,i,Omega,omega,M)/d(a,h,k,p,q,lambda).

    Parity: ``equinoctial_element.rs:1049-1140`` including the e->0 / i->0
    regularizations at eps = 1e-12."""
    h, k, p, q = eq.h, eq.k, eq.p, eq.q
    e = torch.sqrt(h * h + k * k)
    e2 = torch.clamp(e * e, min=_EPS_REG**2)
    circ = e < _EPS_REG
    dv_dh = torch.where(circ, 0.0, k / e2)
    dv_dk = torch.where(circ, 0.0, -h / e2)
    de_dh = h / torch.clamp(e, min=_EPS_REG)
    de_dk = k / torch.clamp(e, min=_EPS_REG)

    t = torch.sqrt(p * p + q * q)
    t2 = torch.clamp(t * t, min=_EPS_REG**2)
    eqt = t < _EPS_REG
    denom = torch.clamp(t * (1.0 + t * t), min=_EPS_REG)
    di_dp = torch.where(eqt, 0.0, 2.0 * p / denom)
    di_dq = torch.where(eqt, 0.0, 2.0 * q / denom)
    dn_dp = torch.where(eqt, 0.0, q / t2)
    dn_dq = torch.where(eqt, 0.0, -p / t2)

    z = torch.zeros_like(h)
    o = torch.ones_like(h)
    cols = [
        [o, z, z, z, z, z],  # d/da
        [z, de_dh, z, z, dv_dh, -dv_dh],  # d/dh
        [z, de_dk, z, z, dv_dk, -dv_dk],  # d/dk
        [z, z, di_dp, dn_dp, -dn_dp, z],  # d/dp
        [z, z, di_dq, dn_dq, -dn_dq, z],  # d/dq
        [z, z, z, z, z, o],  # d/dlambda
    ]
    return _mat6(cols)


def jacobian_cometary_to_keplerian(com: CometaryElements):
    """d(a,e,i,Omega,omega,M)/d(q,e,i,Omega,omega,nu).

    Parity: ``cometary_element.rs:333-393`` (elliptic and hyperbolic
    branches), with the elliptic dM/de carrying the sqrt(1-e^2) factor the
    reference omits, as in the JAX package."""
    qd = com.perihelion_distance
    e = com.eccentricity
    nu = com.true_anomaly
    one_me = 1.0 - e
    cn, sn = torch.cos(nu), torch.sin(nu)
    denom = 1.0 + e * cn
    denom2 = denom * denom

    da_dq = 1.0 / one_me
    da_de = qd / one_me**2

    dm_de_ell = -sn * torch.sqrt(torch.abs(1.0 - e * e)) * (2.0 + e * cn) / denom2
    dm_dnu_ell = lanewise(torch.pow, torch.abs(1.0 - e * e), 1.5) / denom2
    e2m1 = torch.sqrt(torch.abs(e * e - 1.0))
    dm_de_hyp = sn * e2m1 * (2.0 + e * cn) / denom2
    dm_dnu_hyp = e2m1**3 / denom2

    ell = e < 1.0
    dm_de = torch.where(ell, dm_de_ell, dm_de_hyp)
    dm_dnu = torch.where(ell, dm_dnu_ell, dm_dnu_hyp)

    z = torch.zeros_like(e)
    o = torch.ones_like(e)
    cols = [
        [da_dq, z, z, z, z, z],  # d/dq
        [da_de, o, z, z, z, dm_de],  # d/de
        [z, z, o, z, z, z],  # d/di
        [z, z, z, o, z, z],  # d/dOmega
        [z, z, z, z, o, z],  # d/domega
        [z, z, z, z, z, dm_dnu],  # d/dnu
    ]
    return _mat6(cols)


def jacobian_cometary_to_equinoctial(com: CometaryElements):
    """Chain rule via Keplerian.  Parity: ``cometary_element.rs:418-426``."""
    kep = cometary_to_keplerian(com)
    return matmul_small(jacobian_keplerian_to_equinoctial(kep), jacobian_cometary_to_keplerian(com))


#: Reference-name alias (``OrbitalElements`` sum type, orbit_type/mod.rs:221):
#: any of the three element representations.
OrbitalElements = Union[KeplerianElements, EquinoctialElements, CometaryElements]
