"""Frozen analytic ephemeris of the benchmark: planets, Moon and Earth.

The deployments name the built-in analytic source (Standish's "Approximate
Positions of the Planets" mean elements, 1800-2050 table, and the
Astronomical Almanac's low-precision Moon).  This file holds its own copy
of those published numbers and evaluates them directly, in plain PyTorch
at any float dtype, so that the traffic and the reference never read a
table the program built.

Positions are heliocentric, in AU; ``*_ecliptic`` in the mean ecliptic of
J2000, ``*_equatorial`` rotated by the IAU-1976 obliquity at J2000.
"""

import math

import torch

#: Earth/Moon mass ratio (DE440)
EMRAT = 81.3005682214972154
#: km per AU (IAU 2012)
AU_KM = 149_597_870.7
#: IAU-1976 mean obliquity at J2000, radians
OBLIQUITY_J2000 = 84381.448 * math.pi / 648000.0

_DEG = math.pi / 180.0
_MJD_J2000 = 51544.5

# a (AU), e, I, L, long. perihelion, long. node (deg); then rates per century
STANDISH = {
    "mercury": ((0.38709927, 0.20563593, 7.00497902, 252.25032350, 77.45779628, 48.33076593),
                (0.00000037, 0.00001906, -0.00594749, 149472.67411175, 0.16047689, -0.12534081)),
    "venus": ((0.72333566, 0.00677672, 3.39467605, 181.97909950, 131.60246718, 76.67984255),
              (0.00000390, -0.00004107, -0.00078890, 58517.81538729, 0.00268329, -0.27769418)),
    "emb": ((1.00000261, 0.01671123, -0.00001531, 100.46457166, 102.93768193, 0.0),
            (0.00000562, -0.00004392, -0.01294668, 35999.37244981, 0.32327364, 0.0)),
    "mars": ((1.52371034, 0.09339410, 1.84969142, -4.55343205, -23.94362959, 49.55953891),
             (0.00001847, 0.00007882, -0.00813131, 19140.30268499, 0.44441088, -0.29257343)),
    "jupiter": ((5.20288700, 0.04838624, 1.30439695, 34.39644051, 14.72847983, 100.47390909),
                (-0.00011607, -0.00013253, -0.00183714, 3034.74612775, 0.21252668, 0.20469106)),
    "saturn": ((9.53667594, 0.05386179, 2.48599187, 49.95424423, 92.59887831, 113.66242448),
               (-0.00125060, -0.00050991, 0.00193609, 1222.49362201, -0.41897216, -0.28867794)),
    "uranus": ((19.18916464, 0.04725744, 0.77263783, 313.23810451, 170.95427630, 74.01692503),
               (-0.00196176, -0.00004397, -0.00242939, 428.48202785, 0.40805281, 0.04240589)),
    "neptune": ((30.06992276, 0.00859048, 1.77004347, -55.12002969, 44.96476227, 131.78422574),
                (0.00026291, 0.00005105, 0.00035372, 218.45945325, -0.32241464, -0.00508664)),
    "pluto": ((39.48211675, 0.24882730, 17.14001206, 238.92903833, 224.06891629, 110.30393684),
              (-0.00031596, 0.00005170, 0.00004818, 145.20780515, -0.04062942, -0.01183482)),
}

#: DE440 GM (km^3/s^2) of the Sun and the perturbers N-body propagation uses
GM_KM3_S2 = {
    "sun": 1.32712440041e11, "mercury": 2.203178e4, "venus": 3.2485857e5, "emb": 4.03503235e5,
    "mars": 4.28283736e4, "jupiter": 1.267127648e8, "saturn": 3.79406252e7, "uranus": 5.7945564e6,
    "neptune": 6.8365271e6, "pluto": 9.755e2,
}


def gm_au3_day2(body):
    return GM_KM3_S2[body] * 86400.0**2 / AU_KM**3


def ecliptic_to_equatorial(v):
    c, s = math.cos(OBLIQUITY_J2000), math.sin(OBLIQUITY_J2000)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([x, c * y - s * z, s * y + c * z], dim=-1)


def equatorial_to_ecliptic(v):
    c, s = math.cos(OBLIQUITY_J2000), math.sin(OBLIQUITY_J2000)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([x, c * y + s * z, -s * y + c * z], dim=-1)


def _centuries(mjd_tt):
    return (mjd_tt - _MJD_J2000) / 36525.0


def planet_ecliptic(body, mjd_tt):
    """Heliocentric mean-ecliptic J2000 position of ``body`` at ``mjd_tt``
    (a tensor; its dtype is the working precision)."""
    t = _centuries(mjd_tt)
    el, rate = STANDISH[body]
    a, e, inc, ell, varpi, node = (el[i] + rate[i] * t for i in range(6))
    inc, ell, varpi, node = inc * _DEG, ell * _DEG, varpi * _DEG, node * _DEG
    argp = varpi - node
    m = torch.remainder(ell - varpi + math.pi, 2 * math.pi) - math.pi
    u = m + e * torch.sin(m)
    for _ in range(12):
        u = u - (u - e * torch.sin(u) - m) / (1.0 - e * torch.cos(u))
    xp = a * (torch.cos(u) - e)
    yp = a * torch.sqrt(1.0 - e * e) * torch.sin(u)
    cw, sw, co, so, ci, si = (torch.cos(argp), torch.sin(argp), torch.cos(node), torch.sin(node),
                              torch.cos(inc), torch.sin(inc))
    return torch.stack([
        (cw * co - sw * so * ci) * xp + (-sw * co - cw * so * ci) * yp,
        (cw * so + sw * co * ci) * xp + (-sw * so + cw * co * ci) * yp,
        (sw * si) * xp + (cw * si) * yp,
    ], dim=-1)


def moon_geocentric_ecliptic(mjd_tt):
    """Geocentric Moon (AU): the Almanac's truncated series, referred to
    the ecliptic of date and precessed to J2000 in longitude."""
    t = _centuries(mjd_tt)

    def sin(c0, c1):
        return torch.sin((c0 + c1 * t) * _DEG)

    def cos(c0, c1):
        return torch.cos((c0 + c1 * t) * _DEG)

    lam = (218.32 + 481267.881 * t + 6.29 * sin(135.0, 477198.87) - 1.27 * sin(259.3, -413335.36)
           + 0.66 * sin(235.7, 890534.22) + 0.21 * sin(269.9, 954397.74) - 0.19 * sin(357.5, 35999.05)
           - 0.11 * sin(186.5, 966404.03))
    beta = (5.13 * sin(93.3, 483202.02) + 0.28 * sin(228.2, 960400.89) - 0.28 * sin(318.3, 6003.15)
            - 0.17 * sin(217.6, -407332.21))
    par = (0.9508 + 0.0518 * cos(135.0, 477198.87) + 0.0095 * cos(259.3, -413335.36)
           + 0.0078 * cos(235.7, 890534.22) + 0.0028 * cos(269.9, 954397.74))
    lam = (lam - 1.3969713 * t) * _DEG
    beta = beta * _DEG
    r = 6378.14 / torch.sin(par * _DEG) / AU_KM
    return torch.stack([r * torch.cos(beta) * torch.cos(lam), r * torch.cos(beta) * torch.sin(lam),
                        r * torch.sin(beta)], dim=-1)


def earth_equatorial(mjd_tt):
    """Heliocentric Earth, equatorial J2000: EMB - Moon / (1 + EMRAT)."""
    emb = planet_ecliptic("emb", mjd_tt)
    moon = moon_geocentric_ecliptic(mjd_tt)
    return ecliptic_to_equatorial(emb - moon / (1.0 + EMRAT))
