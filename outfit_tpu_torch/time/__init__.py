"""Time scales (host-side numpy) and sidereal time (tensors)."""

from outfit_tpu_torch.time.scales import (
    Ut1Provider,
    date_to_mjd,
    frac_date_to_mjd,
    iso_tt_from_mjd,
    iso_utc_from_mjd_tt,
    jd_to_mjd,
    mjd_to_jd,
    tai_minus_utc,
    tt_mjd_to_utc,
    utc_jd_to_tt_mjd,
    utc_mjd_to_tt,
)
from outfit_tpu_torch.time.sidereal import gmst

__all__ = [
    "Ut1Provider",
    "date_to_mjd",
    "frac_date_to_mjd",
    "gmst",
    "iso_tt_from_mjd",
    "iso_utc_from_mjd_tt",
    "jd_to_mjd",
    "mjd_to_jd",
    "tai_minus_utc",
    "tt_mjd_to_utc",
    "utc_jd_to_tt_mjd",
    "utc_mjd_to_tt",
]
