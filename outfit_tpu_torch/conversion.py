# Source: outfit_tpu/conversion.py (copied; numpy only).
"""Angle/coordinate parsing, formatting, and conversions.

Parity with ``src/conversion.rs``: arcsec<->rad (:123), sexagesimal RA/DEC
parsing with digit-derived accuracy (:158, :205), vector formatting (:262),
carry-safe sexagesimal rendering (:307, :375), cartesian_to_radec (:430).
"""

import math
from typing import Optional, Tuple

import numpy as np

from outfit_tpu_torch.constants import DPI


def arcsec_to_rad(arcsec: float) -> float:
    return math.radians(arcsec / 3600.0)


def rad_to_arcsec(rad: float) -> float:
    return math.degrees(rad) * 3600.0


def _accuracy_from_digits(seconds_text: str, base_unit: float) -> float:
    """Accuracy implied by the number of decimals in the seconds field,
    in units of ``base_unit * 3600`` arcsec (parity: compute_accuracy)."""
    if "." in seconds_text:
        decimals = len(seconds_text.split(".", 1)[1])
    else:
        decimals = 0
    return 10.0 ** (-decimals) * base_unit * 3600.0


def parse_ra_to_deg(ra: str) -> Optional[Tuple[float, float]]:
    """'HH MM SS.ss' -> (degrees, accuracy_arcsec); None on bad input."""
    parts = ra.split()
    if len(parts) != 3:
        return None
    try:
        h, m = float(parts[0]), float(parts[1])
        s = float(parts[2])
    except ValueError:
        return None
    deg = (h + m / 60.0 + s / 3600.0) * 15.0
    return deg, _accuracy_from_digits(parts[2], 1.0 / 3600.0)


def parse_dec_to_deg(dec: str) -> Optional[Tuple[float, float]]:
    """'+DD MM SS.s' -> (degrees, accuracy_arcsec); None on bad input."""
    parts = dec.split()
    if len(parts) != 3:
        return None
    sign = -1.0 if parts[0].startswith("-") else 1.0
    try:
        d = float(parts[0].lstrip("+-"))
        m = float(parts[1])
        s = float(parts[2])
    except ValueError:
        return None
    deg = sign * (d + m / 60.0 + s / 3600.0)
    return deg, _accuracy_from_digits(parts[2], 1.0 / 3600.0)


def fmt_ss(seconds: float, prec: int) -> str:
    """Two-digit zero-padded seconds.  Parity: time.rs fmt_ss.

    Delegates to the canonical carry-sensitive formatter in time.scales so
    a rounding fix cannot miss one of two copies."""
    from outfit_tpu_torch.time.scales import _fmt_ss

    return _fmt_ss(seconds, prec)


def ra_hms_prec(rad: float, prec: int) -> Tuple[int, int, float]:
    """RA (radians) -> (HH, MM, SS.s) with carry-safe rounding."""
    hours = (rad % DPI) * 24.0 / DPI
    hh = int(hours)
    minutes = (hours - hh) * 60.0
    mm = int(minutes)
    ss = (minutes - mm) * 60.0
    # carry on rounding
    if round(ss * 10**prec) >= 60 * 10**prec:
        ss = 0.0
        mm += 1
        if mm >= 60:
            mm = 0
            hh = (hh + 1) % 24
    return hh, mm, round(ss, prec)


def dec_sdms_prec(rad: float, prec: int) -> Tuple[str, int, int, float]:
    """Dec (radians) -> (sign, DD, MM, SS.s) with carry-safe rounding."""
    sign = "-" if rad < 0 else "+"
    deg = abs(math.degrees(rad))
    dd = int(deg)
    minutes = (deg - dd) * 60.0
    mm = int(minutes)
    ss = (minutes - mm) * 60.0
    if round(ss * 10**prec) >= 60 * 10**prec:
        ss = 0.0
        mm += 1
        if mm >= 60:
            mm = 0
            dd += 1
    return sign, dd, mm, round(ss, prec)


def fmt_vec3_au(v, prec: int) -> str:
    x, y, z = (float(c) for c in np.asarray(v))
    return f"[ {x:.{prec}f}, {y:.{prec}f}, {z:.{prec}f} ] AU"


def cartesian_to_radec(position) -> Tuple[float, float, float]:
    """(x, y, z) -> (ra, dec, distance); parity: conversion.rs:430-447."""
    p = np.asarray(position, dtype=np.float64)
    norm = float(np.linalg.norm(p))
    if norm == 0.0:
        return 0.0, 0.0, 0.0
    dec = math.asin(float(p[2]) / norm)
    cd = math.cos(dec)
    if cd == 0.0:
        return 0.0, dec, norm
    ra = math.atan2(float(p[1]), float(p[0]))
    if ra < 0.0:
        ra += DPI
    return ra, dec, norm
