# Source: outfit_tpu/observations/ades.py (one pass for records and sigmas: read_ades).
"""ADES (IAU Astrometric Data Exchange Standard) XML parser.

Handles both the obsBlock/obsData layout and the flat layout of
``<optical>`` elements (fixtures ``tests/data/example_ades*.xml``,
``flat_ades.xml``).

Fields consumed: permID / provID / trkSub (trajectory id, in that priority),
stn (observatory), obsTime (ISO UTC -> MJD TT), ra / dec (degrees),
rmsRA / rmsDec (arcsec; rmsRA is per ADES already cos(dec)-scaled), mag.
"""

import datetime as _dt
import math
import xml.etree.ElementTree as ET
from typing import List, Optional

from outfit_tpu_torch.constants import RADEG, RADSEC
from outfit_tpu_torch.observations.mpc80 import MpcRecord
from outfit_tpu_torch.time.scales import utc_mjd_to_tt


def _obstime_to_mjd_tt(text: str) -> float:
    text = text.strip()
    if text.endswith("Z"):
        text = text[:-1]
    dt = _dt.datetime.fromisoformat(text)
    delta = dt - _dt.datetime(1858, 11, 17)
    mjd_utc = delta.days + delta.seconds / 86400.0 + delta.microseconds / 86.4e9
    return float(utc_mjd_to_tt(mjd_utc))


def _text(el, tag) -> Optional[str]:
    child = el.find(tag)
    return child.text.strip() if child is not None and child.text else None


def _iter_complete_optical(root):
    """The SINGLE record-acceptance rule, shared by the record and sigma
    passes so the two lists can never misalign on a malformed block."""
    for opt in root.iter("optical"):
        traj_id = (
            _text(opt, "permID") or _text(opt, "provID") or _text(opt, "trkSub")
        )
        if (
            traj_id is None
            or _text(opt, "obsTime") is None
            or _text(opt, "ra") is None
            or _text(opt, "dec") is None
        ):
            continue
        yield traj_id, opt


def read_ades(path: str):
    """``(records, sigmas)`` of an ADES XML file in one pass over it: the
    results of :func:`parse_ades_file` and :func:`ades_sigmas`."""
    root = ET.parse(path).getroot()
    records: List[MpcRecord] = []
    sigmas = []
    for traj_id, opt in _iter_complete_optical(root):
        mag_txt = _text(opt, "mag")
        records.append(
            MpcRecord(
                traj_id=traj_id,
                mjd_tt=_obstime_to_mjd_tt(_text(opt, "obsTime")),
                ra=float(_text(opt, "ra")) * RADEG,
                dec=float(_text(opt, "dec")) * RADEG,
                mag=float(mag_txt) if mag_txt else None,
                band=_text(opt, "band") or " ",
                observatory=_text(opt, "stn") or "500",
                discovery=(_text(opt, "disc") == "*"),
            )
        )
        rms_ra = _text(opt, "rmsRA")
        rms_dec = _text(opt, "rmsDec")
        sigmas.append(
            (
                float(rms_ra) * RADSEC if rms_ra else math.nan,
                float(rms_dec) * RADSEC if rms_dec else math.nan,
            )
        )
    return records, sigmas


def parse_ades_file(path: str) -> List[MpcRecord]:
    """Parse an ADES XML file into observation records.

    RA/Dec sigmas come from rmsRA/rmsDec when present (converted from arcsec
    to radians; the caller's error model fills any gaps), recorded as NaN
    otherwise (:func:`ades_sigmas`).
    """
    return read_ades(path)[0]


def ades_sigmas(path: str):
    """Per-record (rms_ra, rms_dec) in radians (NaN when absent), aligned
    with :func:`parse_ades_file` output order (same acceptance rule)."""
    return read_ades(path)[1]
