# Source: outfit_tpu/observations/mpc80.py (copied; imports retargeted to this package).
"""MPC 80-column astrometric record parser.

Format (1-based columns, public MPC specification):
  1-5   packed number        6-12  packed provisional designation
  13    discovery asterisk   14    note 1        15    note 2 / obs type
  16-32 date 'YYYY MM DD.dddddd' (UTC)
  33-44 RA  'HH MM SS.ddd'   45-56 Dec 'sDD MM SS.dd'
  66-71 magnitude            71/72 band          78-80 observatory code

Satellite/roving-observer continuation lines (note2 in 's', 'v', 'r') are
skipped.  Epochs convert UTC -> MJD(TT) via the leap-second table
(parity: photom's ``from_mpc_80_col``; epoch parity pinned by the reference
oracle ``frac_date_to_mjd("1976 09 20.93878") = 43041.93932611111``).
"""

from dataclasses import dataclass
from typing import List, Optional

from outfit_tpu_torch.constants import RADH, RADEG
from outfit_tpu_torch.time.scales import frac_date_to_mjd


@dataclass
class MpcRecord:
    traj_id: str
    mjd_tt: float
    ra: float  # radians
    dec: float  # radians
    mag: Optional[float]
    band: str
    observatory: str
    discovery: bool
    catalog: str = " "

    def _replace_traj(self, tid: str) -> "MpcRecord":
        import dataclasses

        return dataclasses.replace(self, traj_id=tid)


def _parse_ra(text: str) -> float:
    parts = text.split()
    hh = float(parts[0])
    mm = float(parts[1]) if len(parts) > 1 else 0.0
    ss = float(parts[2]) if len(parts) > 2 else 0.0
    return (hh + mm / 60.0 + ss / 3600.0) * RADH


def _parse_dec(text: str) -> float:
    text = text.strip()
    sign = -1.0 if text.startswith("-") else 1.0
    body = text.lstrip("+-")
    parts = body.split()
    dd = float(parts[0])
    mm = float(parts[1]) if len(parts) > 1 else 0.0
    ss = float(parts[2]) if len(parts) > 2 else 0.0
    return sign * (dd + mm / 60.0 + ss / 3600.0) * RADEG


def parse_line(line: str) -> Optional[MpcRecord]:
    """Parse one 80-column record; returns None for non-optical lines."""
    if len(line) < 56:
        return None
    note2 = line[14]
    if note2 in ("s", "v", "r", "R"):  # satellite/roving second lines
        return None
    number = line[0:5].strip()
    prov = line[5:12].strip()
    traj_id = number or prov
    if not traj_id:
        return None
    date_str = line[15:32].strip()
    try:
        parts = date_str.split()
        mjd_tt = frac_date_to_mjd(f"{parts[0]} {parts[1]} {parts[2]}")
        ra = _parse_ra(line[32:44])
        dec = _parse_dec(line[44:56])
    except (ValueError, IndexError):
        return None
    mag_str = line[65:70].strip() if len(line) > 65 else ""
    try:
        mag = float(mag_str)
    except ValueError:
        mag = None
    band = line[70] if len(line) > 70 else " "
    obs_code = line[77:80].strip() if len(line) >= 78 else "500"
    return MpcRecord(
        traj_id=traj_id,
        mjd_tt=mjd_tt,
        ra=ra,
        dec=dec,
        mag=mag,
        band=band,
        observatory=obs_code or "500",
        discovery=line[12] == "*",
        catalog=line[71] if len(line) > 71 else " ",
    )


def parse_file(path: str) -> List[MpcRecord]:
    records = []
    with open(path, encoding="utf-8", errors="replace") as fh:
        for line in fh:
            rec = parse_line(line.rstrip("\n"))
            if rec is not None:
                records.append(rec)
    return records
