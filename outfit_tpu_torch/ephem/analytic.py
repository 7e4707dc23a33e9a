# Source: outfit_tpu/ephem/analytic.py (copied; numpy only).
"""File-free analytic planetary ephemeris source.

Builds Chebyshev tables from Standish's "Approximate Positions of the
Planets" mean Keplerian elements (heliocentric mean-ecliptic J2000) and a
truncated lunar theory (Astronomical Almanac low-precision Moon) for the
geocentric Moon.  Accuracy vs DE440: planets ~1e-5 AU, Moon ~2e-4 of its
geocentric distance (Earth position error < 5e-7 AU).
"""

import numpy as np

from outfit_tpu_torch.constants import AU
from outfit_tpu_torch.ephem.bodies import Body
from outfit_tpu_torch.ephem.chebyshev import fit_body_table

#: Earth/Moon mass ratio (DE440)
EMRAT = 81.3005682214972154

_DEG = np.pi / 180.0
_J2000_JD = 2451545.0
_MJD2JD = 2400000.5

# Standish 1800-2050 table: a, e, I, L, varpi, Omega (AU, deg) + per-century rates.
_STANDISH = {
    Body.MERCURY_BARY: (
        [0.38709927, 0.20563593, 7.00497902, 252.25032350, 77.45779628, 48.33076593],
        [0.00000037, 0.00001906, -0.00594749, 149472.67411175, 0.16047689, -0.12534081],
    ),
    Body.VENUS_BARY: (
        [0.72333566, 0.00677672, 3.39467605, 181.97909950, 131.60246718, 76.67984255],
        [0.00000390, -0.00004107, -0.00078890, 58517.81538729, 0.00268329, -0.27769418],
    ),
    Body.EMB: (
        [1.00000261, 0.01671123, -0.00001531, 100.46457166, 102.93768193, 0.0],
        [0.00000562, -0.00004392, -0.01294668, 35999.37244981, 0.32327364, 0.0],
    ),
    Body.MARS_BARY: (
        [1.52371034, 0.09339410, 1.84969142, -4.55343205, -23.94362959, 49.55953891],
        [0.00001847, 0.00007882, -0.00813131, 19140.30268499, 0.44441088, -0.29257343],
    ),
    Body.JUPITER_BARY: (
        [5.20288700, 0.04838624, 1.30439695, 34.39644051, 14.72847983, 100.47390909],
        [-0.00011607, -0.00013253, -0.00183714, 3034.74612775, 0.21252668, 0.20469106],
    ),
    Body.SATURN_BARY: (
        [9.53667594, 0.05386179, 2.48599187, 49.95424423, 92.59887831, 113.66242448],
        [-0.00125060, -0.00050991, 0.00193609, 1222.49362201, -0.41897216, -0.28867794],
    ),
    Body.URANUS_BARY: (
        [19.18916464, 0.04725744, 0.77263783, 313.23810451, 170.95427630, 74.01692503],
        [-0.00196176, -0.00004397, -0.00242939, 428.48202785, 0.40805281, 0.04240589],
    ),
    Body.NEPTUNE_BARY: (
        [30.06992276, 0.00859048, 1.77004347, -55.12002969, 44.96476227, 131.78422574],
        [0.00026291, 0.00005105, 0.00035372, 218.45945325, -0.32241464, -0.00508664],
    ),
    Body.PLUTO_BARY: (
        [39.48211675, 0.24882730, 17.14001206, 238.92903833, 224.06891629, 110.30393684],
        [-0.00031596, 0.00005170, 0.00004818, 145.20780515, -0.04062942, -0.01183482],
    ),
}

#: Obliquity of the ecliptic at J2000 (IAU-1976), radians
_EPS0 = 84381.448 * np.pi / 648000.0


def _ecl_to_equ(v):
    """Rotate ecliptic-J2000 vectors (n, 3) to equatorial J2000."""
    c, s = np.cos(_EPS0), np.sin(_EPS0)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return np.stack([x, c * y - s * z, s * y + c * z], axis=-1)


def planet_position_ecliptic(body: Body, mjd_tt):
    """Heliocentric ecliptic-J2000 position (AU) from Standish mean elements."""
    mjd_tt = np.asarray(mjd_tt, dtype=np.float64)
    t = (mjd_tt + _MJD2JD - _J2000_JD) / 36525.0
    e0, rate = _STANDISH[Body(body)]
    a = e0[0] + rate[0] * t
    e = e0[1] + rate[1] * t
    inc = (e0[2] + rate[2] * t) * _DEG
    ell = (e0[3] + rate[3] * t) * _DEG
    varpi = (e0[4] + rate[4] * t) * _DEG
    node = (e0[5] + rate[5] * t) * _DEG

    argp = varpi - node
    m = np.remainder(ell - varpi + np.pi, 2 * np.pi) - np.pi

    # Kepler solve (Newton, e < 0.26 everywhere in the table)
    u = m + e * np.sin(m)
    for _ in range(10):
        u = u - (u - e * np.sin(u) - m) / (1.0 - e * np.cos(u))

    xp = a * (np.cos(u) - e)
    yp = a * np.sqrt(1.0 - e * e) * np.sin(u)

    cw, sw = np.cos(argp), np.sin(argp)
    co, so = np.cos(node), np.sin(node)
    ci, si = np.cos(inc), np.sin(inc)
    x = (cw * co - sw * so * ci) * xp + (-sw * co - cw * so * ci) * yp
    y = (cw * so + sw * co * ci) * xp + (-sw * so + cw * co * ci) * yp
    z = (sw * si) * xp + (cw * si) * yp
    return np.stack([x, y, z], axis=-1)


def moon_geocentric_ecliptic(mjd_tt):
    """Geocentric ecliptic position of the Moon (AU), truncated lunar theory
    referred to the mean ecliptic of date, precessed to J2000 in longitude."""
    mjd_tt = np.asarray(mjd_tt, dtype=np.float64)
    t = (mjd_tt + _MJD2JD - _J2000_JD) / 36525.0

    lam = (
        218.32
        + 481267.881 * t
        + 6.29 * np.sin((135.0 + 477198.87 * t) * _DEG)
        - 1.27 * np.sin((259.3 - 413335.36 * t) * _DEG)
        + 0.66 * np.sin((235.7 + 890534.22 * t) * _DEG)
        + 0.21 * np.sin((269.9 + 954397.74 * t) * _DEG)
        - 0.19 * np.sin((357.5 + 35999.05 * t) * _DEG)
        - 0.11 * np.sin((186.5 + 966404.03 * t) * _DEG)
    )
    beta = (
        5.13 * np.sin((93.3 + 483202.02 * t) * _DEG)
        + 0.28 * np.sin((228.2 + 960400.89 * t) * _DEG)
        - 0.28 * np.sin((318.3 + 6003.15 * t) * _DEG)
        - 0.17 * np.sin((217.6 - 407332.21 * t) * _DEG)
    )
    par = (
        0.9508
        + 0.0518 * np.cos((135.0 + 477198.87 * t) * _DEG)
        + 0.0095 * np.cos((259.3 - 413335.36 * t) * _DEG)
        + 0.0078 * np.cos((235.7 + 890534.22 * t) * _DEG)
        + 0.0028 * np.cos((269.9 + 954397.74 * t) * _DEG)
    )
    # general precession in longitude: 1.3969713 deg / Julian century
    lam = lam - 1.3969713 * t
    r_km = 6378.14 / np.sin(par * _DEG)
    lam_r = lam * _DEG
    beta_r = beta * _DEG
    r = r_km / AU
    return np.stack(
        [
            r * np.cos(beta_r) * np.cos(lam_r),
            r * np.cos(beta_r) * np.sin(lam_r),
            r * np.sin(beta_r),
        ],
        axis=-1,
    )


#: per-body (granule_days, n_coeff) for the analytic tables
_GRANULES = {
    Body.MERCURY_BARY: (8.0, 14),
    Body.VENUS_BARY: (16.0, 14),
    Body.EMB: (16.0, 14),
    Body.MARS_BARY: (16.0, 12),
    Body.JUPITER_BARY: (32.0, 12),
    Body.SATURN_BARY: (32.0, 10),
    Body.URANUS_BARY: (32.0, 8),
    Body.NEPTUNE_BARY: (32.0, 8),
    Body.PLUTO_BARY: (32.0, 8),
    Body.MOON: (4.0, 13),
}


def build_analytic_tables(t_start_mjd: float, t_end_mjd: float):
    """Body -> BodyTable dict (equatorial J2000, AU; heliocentric planets,
    geocentric Moon, the Sun the implied center)."""
    tables = {}
    for body, (gran, ncoeff) in _GRANULES.items():
        if body == Body.MOON:
            fn = lambda m: _ecl_to_equ(moon_geocentric_ecliptic(m))
        else:
            fn = lambda m, b=body: _ecl_to_equ(planet_position_ecliptic(b, m))
        tables[body] = fit_body_table(fn, t_start_mjd, t_end_mjd, gran, ncoeff)
    return tables
