"""Chebyshev ephemeris tables, their CUDA evaluation kernel, the DE file
parsers (Horizon, NAIF) and the query facade."""

from outfit_tpu_torch.ephem.api import JPLEphem
from outfit_tpu_torch.ephem.bodies import GM_AU3_DAY2, Body, gm_au3_day2
from outfit_tpu_torch.ephem.chebyshev import BodyTable, interpolate_body

__all__ = ["GM_AU3_DAY2", "Body", "BodyTable", "JPLEphem", "gm_au3_day2", "interpolate_body"]
