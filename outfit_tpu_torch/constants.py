# Source: outfit_tpu/constants.py (copied unchanged; numpy only).
"""Physical constants and unit conversions.

Behavioral parity with the reference's ``src/constants.rs`` (values are IAU
standard data): Gaussian gravitational constant (:70-73), speed of light
(:76-79), AU in km (:37), J2000 epoch (:43), Earth rotation vector (:82),
equatorial<->ecliptic J2000 rotations (:93-121), Earth ellipsoid (:61-67).
"""

import math

import numpy as np

# --- angles / time -----------------------------------------------------------
DPI = 2.0 * math.pi
SECONDS_PER_DAY = 86_400.0
#: Astronomical Unit in kilometers (IAU 2012)
AU = 149_597_870.7
#: Epoch-comparison tolerance used by frame transformations (days)
EPS = 1e-6
#: MJD of J2000.0 (2000-01-01 12:00:00 TT)
T2000 = 51544.5
#: JD - MJD offset
JDTOMJD = 2400000.5
#: degrees -> radians
RADEG = math.pi / 180.0
#: arcseconds -> radians
RADSEC = math.pi / 648000.0
#: radians -> arcseconds
RAD2ARC = 648000.0 / math.pi
#: hours -> radians
RADH = DPI / 24.0

# --- Earth -------------------------------------------------------------------
#: Earth equatorial radius, meters (GRS1980/WGS84)
EARTH_MAJOR_AXIS = 6_378_137.0
#: Earth polar radius, meters (GRS1980/WGS84)
EARTH_MINOR_AXIS = 6_356_752.3
#: Earth equatorial radius in AU
ERAU = (EARTH_MAJOR_AXIS / 1000.0) / AU
#: sidereal / solar day ratio
SIDEREAL_RATIO = 1.00273790934
#: Angular velocity of Earth rotation (rad/day), z-axis component
EARTH_ROTATION_RATE = DPI * SIDEREAL_RATIO
#: Earth rotation vector (rad/day) in the body-fixed/equatorial frame
EARTH_ROTATION = np.array([0.0, 0.0, EARTH_ROTATION_RATE])

# --- gravity / light ---------------------------------------------------------
#: Gaussian gravitational constant k [AU^(3/2) day^-1 Msun^(-1/2)]
GAUSS_GRAV = 0.01720209895
GAUSS_GRAV_SQUARED = GAUSS_GRAV * GAUSS_GRAV
#: speed of light, km/s
VLIGHT = 2.99792458e5
#: speed of light, AU/day
VLIGHT_AU = VLIGHT / AU * SECONDS_PER_DAY

# --- J2000 equatorial <-> ecliptic rotations --------------------------------
# Mean obliquity at J2000 from the IAU-1976 polynomial evaluated at T2000;
# identical to rotpn(Equm(J2000) -> Eclm(J2000)).  Computed (not hard-coded)
# so it stays consistent with frames.obleq by construction.
_EPS_J2000 = (
    ((23.0 * 3600.0 + 26.0 * 60.0) + 21.448) * RADSEC
)  # obleq polynomial at t=0

ROT_EQUMJ2000_TO_ECLMJ2000 = np.array(
    [
        [1.0, 0.0, 0.0],
        [0.0, math.cos(_EPS_J2000), math.sin(_EPS_J2000)],
        [0.0, -math.sin(_EPS_J2000), math.cos(_EPS_J2000)],
    ]
)
ROT_ECLMJ2000_TO_EQUMJ2000 = ROT_EQUMJ2000_TO_ECLMJ2000.T.copy()
