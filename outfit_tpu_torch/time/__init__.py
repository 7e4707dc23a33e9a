"""Time scales (host-side numpy) and sidereal time (tensors)."""

from outfit_tpu_torch.time.scales import Ut1Provider, frac_date_to_mjd, tai_minus_utc, tt_mjd_to_utc, utc_mjd_to_tt
from outfit_tpu_torch.time.sidereal import gmst

__all__ = ["Ut1Provider", "frac_date_to_mjd", "gmst", "tai_minus_utc", "tt_mjd_to_utc", "utc_mjd_to_tt"]
