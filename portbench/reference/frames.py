"""A station's geocentric position in the mean equator and equinox of
J2000, in plain PyTorch.

Body-fixed position from the station's parallax constants (Earth radius
6,378.137 km), turned by the Greenwich apparent sidereal time (IAU-1982
mean sidereal time of UT1, UT1 = UTC, plus the equation of the equinoxes)
to the true equator of date, then by the IAU-1980 nutation and the
IAU-1976 precession back to J2000.  The nutation series is a frozen copy
in ``data/nutation_iau1980.csv``.
"""

import json
import math
import os

import numpy as np
import torch

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
ARCSEC = math.pi / 648000.0
EARTH_RADIUS_AU = 6378.137 / 149_597_870.7
MJD_J2000 = 51544.5


def _rot(angle, axis):
    """Passive rotation by ``angle`` about ``axis`` (x_new = R x), (..., 3, 3)."""
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    rows = {0: [[o, z, z], [z, c, s], [z, -s, c]],
            1: [[c, z, -s], [z, o, z], [s, z, c]],
            2: [[c, s, z], [-s, c, z], [z, z, o]]}[axis]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _centuries(mjd_tt):
    return (mjd_tt - MJD_J2000) / 36525.0


def mean_obliquity(mjd_tt):
    t = _centuries(mjd_tt)
    return (((0.00181 * t - 0.0006) * t - 46.815) * t + 84381.448) * ARCSEC


def nutation(mjd_tt):
    """(dpsi, deps) in radians, IAU 1980."""
    rows = np.loadtxt(os.path.join(DATA, "nutation_iau1980.csv"), delimiter=",", comments="#")
    mult, amp = torch.as_tensor(rows[:, :5]), torch.as_tensor(rows[:, 5:])
    t = _centuries(mjd_tt)[..., None]
    fund = torch.stack([
        485866.733 + (1717915922.633 + (31.310 + 0.064 * t) * t) * t,
        1287099.804 + (129596581.224 + (-0.577 - 0.012 * t) * t) * t,
        335778.877 + (1739527263.137 + (-13.257 + 0.011 * t) * t) * t,
        1072261.307 + (1602961601.328 + (-6.891 + 0.019 * t) * t) * t,
        450160.280 + (-6962890.539 + (7.455 + 0.008 * t) * t) * t,
    ], -1)[..., 0, :] * ARCSEC
    arg = fund @ mult.T
    dpsi = ((amp[:, 0] + amp[:, 1] * t) * torch.sin(arg)).sum(-1)
    deps = ((amp[:, 2] + amp[:, 3] * t) * torch.cos(arg)).sum(-1)
    return dpsi * 1e-4 * ARCSEC, deps * 1e-4 * ARCSEC


def precession(mjd_tt):
    """J2000 -> mean equator and equinox of date (passive), IAU 1976."""
    t = _centuries(mjd_tt)
    deg = math.pi / 180
    zeta = ((0.0000050 * t + 0.0000839) * t + 0.6406161) * t * deg
    z = ((0.0000051 * t + 0.0003041) * t + 0.6406161) * t * deg
    theta = ((-0.0000116 * t - 0.0001185) * t + 0.5567530) * t * deg
    return _rot(-z, 2) @ _rot(theta, 1) @ _rot(-zeta, 2)


def tt_to_utc(mjd_tt):
    with open(os.path.join(DATA, "leap_seconds.json"), encoding="utf-8") as fh:
        steps = torch.as_tensor(json.load(fh)["steps"], dtype=torch.float64)

    def tai_utc(m):
        i = torch.clamp(torch.searchsorted(steps[:, 0].contiguous(), m.contiguous(), right=True) - 1, 0,
                        len(steps) - 1)
        return steps[i, 1]

    guess = mjd_tt - (tai_utc(mjd_tt) + 32.184) / 86400.0
    return mjd_tt - (tai_utc(guess) + 32.184) / 86400.0


def gmst(mjd_ut1):
    """IAU-1982 mean sidereal time, the polynomial at 0h UT1 of the day plus
    the day's fraction at the sidereal rate, in [0, 2 pi)."""
    day = torch.floor(mjd_ut1)
    t = (day - MJD_J2000) / 36525.0
    g0 = (((-6.2e-6 * t + 9.3104e-2) * t + 8640184.812866) * t + 24110.54841) * (2 * math.pi / 86400.0)
    g = g0 + (mjd_ut1 - day) * 2 * math.pi * 1.00273790934
    return torch.remainder(g, 2 * math.pi)


def station_equatorial(mjd_tt, station, stations):
    """Geocentric position (..., 3) of station ``station`` (..., indices)
    at ``mjd_tt`` (...), mean equator and equinox of J2000, AU."""
    lon = torch.as_tensor(stations["longitude"])[station]
    rc = torch.as_tensor(stations["rho_cos_phi"])[station]
    rs = torch.as_tensor(stations["rho_sin_phi"])[station]
    fixed = EARTH_RADIUS_AU * torch.stack([rc * torch.cos(lon), rc * torch.sin(lon), rs], -1)
    dpsi, deps = nutation(mjd_tt)
    eps = mean_obliquity(mjd_tt)
    gast = gmst(tt_to_utc(mjd_tt)) + dpsi * torch.cos(eps)
    nut = _rot(-(eps + deps), 0) @ _rot(-dpsi, 2) @ _rot(eps, 0)  # mean -> true of date
    m = precession(mjd_tt).transpose(-1, -2) @ nut.transpose(-1, -2) @ _rot(-gast, 2)
    return (m @ fixed[..., None])[..., 0]
