# Source: outfit_tpu/ephem/bodies.py (copied; imports retargeted to this package).
"""Solar-system body identifiers and DE440 gravitational parameters.

Parity: ``src/jpl_ephem/naif/naif_ids/`` (NAIF ID enums) and
``src/propagator/planet_gm.rs`` (DE440 GM table in AU^3/day^2).
"""

import enum

from outfit_tpu_torch.constants import AU


class Body(enum.IntEnum):
    """NAIF-style identifiers for the bodies the ephemeris backends serve."""

    SSB = 0
    MERCURY_BARY = 1
    VENUS_BARY = 2
    EMB = 3
    MARS_BARY = 4
    JUPITER_BARY = 5
    SATURN_BARY = 6
    URANUS_BARY = 7
    NEPTUNE_BARY = 8
    PLUTO_BARY = 9
    SUN = 10
    MOON = 301  # geocentric in DE files
    EARTH = 399


_KM3_S2_TO_AU3_DAY2 = (86400.0 * 86400.0) / (AU**3)

#: DE440 GM values (km^3/s^2) -> AU^3/day^2.  Parity: planet_gm.rs:29-57.
GM_AU3_DAY2 = {
    Body.SUN: 1.32712440041e11 * _KM3_S2_TO_AU3_DAY2,
    Body.MERCURY_BARY: 2.203178e4 * _KM3_S2_TO_AU3_DAY2,
    Body.VENUS_BARY: 3.2485857e5 * _KM3_S2_TO_AU3_DAY2,
    Body.EMB: 4.03503235e5 * _KM3_S2_TO_AU3_DAY2,
    Body.MARS_BARY: 4.28283736e4 * _KM3_S2_TO_AU3_DAY2,
    Body.JUPITER_BARY: 1.267127648e8 * _KM3_S2_TO_AU3_DAY2,
    Body.SATURN_BARY: 3.79406252e7 * _KM3_S2_TO_AU3_DAY2,
    Body.URANUS_BARY: 5.7945564e6 * _KM3_S2_TO_AU3_DAY2,
    Body.NEPTUNE_BARY: 6.8365271e6 * _KM3_S2_TO_AU3_DAY2,
    Body.PLUTO_BARY: 9.755e2 * _KM3_S2_TO_AU3_DAY2,
    Body.MOON: 4.902800066e3 * _KM3_S2_TO_AU3_DAY2,
}


def gm_au3_day2(body: Body):
    """GM in AU^3/day^2, or None.  Parity: ``gm_au3_day2`` (planet_gm.rs:60)."""
    return GM_AU3_DAY2.get(Body(body))
