"""Greenwich Mean Sidereal Time (IAU 1982) on tensors.

Port of ``outfit_tpu/time/sidereal.py``: the same polynomial in the same
operation order, vectorized over any leading shape.
"""

import torch

from outfit_tpu_torch.constants import DPI, SIDEREAL_RATIO, T2000
from outfit_tpu_torch.utils.tensors import as_f64

# GMST at 0h UT1 polynomial coefficients (seconds)
_C0 = 24110.54841
_C1 = 8640184.812866
_C2 = 9.3104e-2
_C3 = -6.2e-6


def gmst(tjm_ut1, device=None):
    """GMST in radians, normalized to [0, 2pi), for MJD (UT1)."""
    tjm = as_f64(tjm_ut1, device)
    itjm = torch.floor(tjm)
    t = (itjm - T2000) / 36525.0
    gmst0 = (((_C3 * t + _C2) * t + _C1) * t + _C0) * (DPI / 86400.0)
    h = (tjm - itjm) * DPI
    g = gmst0 + h * SIDEREAL_RATIO
    return g - torch.floor(g / DPI) * DPI
