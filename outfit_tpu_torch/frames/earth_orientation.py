"""IAU-1976 precession, IAU-1980 (Wahr) nutation, mean obliquity, on tensors.

Port of ``outfit_tpu/frames/earth_orientation.py``.  The 106-term nutation
series is the published IAU-1980 table evaluated as

    arg   = M @ [l, l', F, D, Om]        (106x5 integer multipliers)
    dpsi  = sum((A + At*t) * sin(arg))
    deps  = sum((B + Bt*t) * cos(arg))

with the contractions written as broadcast-multiply + sum, the JAX
package's summation form.  Amplitudes are in 0.1 milliarcsec (1e-4 arcsec).
Every function takes ``device=`` for Python-scalar epochs; tensor epochs
keep their own device.
"""

import numpy as np
import torch

from outfit_tpu_torch.constants import RADEG, RADSEC, T2000
from outfit_tpu_torch.utils.linalg import matmul_small
from outfit_tpu_torch.utils.tensors import as_f64

# ---------------------------------------------------------------------------
# IAU-1980 nutation series: columns (l, l', F, D, Om, A, A_t, B, B_t)
# (Explanatory Supplement to the Astronomical Almanac, table 3.222.1).
# ---------------------------------------------------------------------------
_NUT_SERIES = np.array(
    [
        #  l  l'  F   D  Om        A      A_t       B     B_t
        [0, 0, 0, 0, 1, -171996.0, -174.2, 92025.0, 8.9],
        [0, 0, 0, 0, 2, 2062.0, 0.2, -895.0, 0.5],
        [-2, 0, 2, 0, 1, 46.0, 0.0, -24.0, 0.0],
        [-2, 0, 2, 0, 0, -11.0, 0.0, 0.0, 0.0],
        [-2, 0, 2, 0, 2, -3.0, 0.0, 1.0, 0.0],
        [1, -1, 0, -1, 0, -3.0, 0.0, 0.0, 0.0],
        [0, -2, 2, -2, 1, -2.0, 0.0, 1.0, 0.0],
        [2, 0, -2, 0, 1, 1.0, 0.0, 0.0, 0.0],
        [0, 0, 2, -2, 2, -13187.0, -1.6, 5736.0, -3.1],
        [0, 1, 0, 0, 0, 1426.0, -3.4, 54.0, -0.1],
        [0, 1, 2, -2, 2, -517.0, 1.2, 224.0, -0.6],
        [0, -1, 2, -2, 2, 217.0, -0.5, -95.0, 0.3],
        [0, 0, 2, -2, 1, 129.0, 0.1, -70.0, 0.0],
        [2, 0, 0, -2, 0, 48.0, 0.0, 1.0, 0.0],
        [0, 0, 2, -2, 0, -22.0, 0.0, 0.0, 0.0],
        [0, 2, 0, 0, 0, 17.0, -0.1, 0.0, 0.0],
        [0, 1, 0, 0, 1, -15.0, 0.0, 9.0, 0.0],
        [0, 2, 2, -2, 2, -16.0, 0.1, 7.0, 0.0],
        [0, -1, 0, 0, 1, -12.0, 0.0, 6.0, 0.0],
        [-2, 0, 0, 2, 1, -6.0, 0.0, 3.0, 0.0],
        [0, -1, 2, -2, 1, -5.0, 0.0, 3.0, 0.0],
        [2, 0, 0, -2, 1, 4.0, 0.0, -2.0, 0.0],
        [0, 1, 2, -2, 1, 4.0, 0.0, -2.0, 0.0],
        [1, 0, 0, -1, 0, -4.0, 0.0, 0.0, 0.0],
        [2, 1, 0, -2, 0, 1.0, 0.0, 0.0, 0.0],
        [0, 0, -2, 2, 1, 1.0, 0.0, 0.0, 0.0],
        [0, 1, -2, 2, 0, -1.0, 0.0, 0.0, 0.0],
        [0, 1, 0, 0, 2, 1.0, 0.0, 0.0, 0.0],
        [-1, 0, 0, 1, 1, 1.0, 0.0, 0.0, 0.0],
        [0, 1, 2, -2, 0, -1.0, 0.0, 0.0, 0.0],
        [0, 0, 2, 0, 2, -2274.0, -0.2, 977.0, -0.5],
        [1, 0, 0, 0, 0, 712.0, 0.1, -7.0, 0.0],
        [0, 0, 2, 0, 1, -386.0, -0.4, 200.0, 0.0],
        [1, 0, 2, 0, 2, -301.0, 0.0, 129.0, -0.1],
        [1, 0, 0, -2, 0, -158.0, 0.0, -1.0, 0.0],
        [-1, 0, 2, 0, 2, 123.0, 0.0, -53.0, 0.0],
        [0, 0, 0, 2, 0, 63.0, 0.0, -2.0, 0.0],
        [1, 0, 0, 0, 1, 63.0, 0.1, -33.0, 0.0],
        [-1, 0, 0, 0, 1, -58.0, -0.1, 32.0, 0.0],
        [-1, 0, 2, 2, 2, -59.0, 0.0, 26.0, 0.0],
        [1, 0, 2, 0, 1, -51.0, 0.0, 27.0, 0.0],
        [0, 0, 2, 2, 2, -38.0, 0.0, 16.0, 0.0],
        [2, 0, 0, 0, 0, 29.0, 0.0, -1.0, 0.0],
        [1, 0, 2, -2, 2, 29.0, 0.0, -12.0, 0.0],
        [2, 0, 2, 0, 2, -31.0, 0.0, 13.0, 0.0],
        [0, 0, 2, 0, 0, 26.0, 0.0, -1.0, 0.0],
        [-1, 0, 2, 0, 1, 21.0, 0.0, -10.0, 0.0],
        [-1, 0, 0, 2, 1, 16.0, 0.0, -8.0, 0.0],
        [1, 0, 0, -2, 1, -13.0, 0.0, 7.0, 0.0],
        [-1, 0, 2, 2, 1, -10.0, 0.0, 5.0, 0.0],
        [1, 1, 0, -2, 0, -7.0, 0.0, 0.0, 0.0],
        [0, 1, 2, 0, 2, 7.0, 0.0, -3.0, 0.0],
        [0, -1, 2, 0, 2, -7.0, 0.0, 3.0, 0.0],
        [1, 0, 2, 2, 2, -8.0, 0.0, 3.0, 0.0],
        [1, 0, 0, 2, 0, 6.0, 0.0, 0.0, 0.0],
        [2, 0, 2, -2, 2, 6.0, 0.0, -3.0, 0.0],
        [0, 0, 0, 2, 1, -6.0, 0.0, 3.0, 0.0],
        [0, 0, 2, 2, 1, -7.0, 0.0, 3.0, 0.0],
        [1, 0, 2, -2, 1, 6.0, 0.0, -3.0, 0.0],
        [0, 0, 0, -2, 1, -5.0, 0.0, 3.0, 0.0],
        [1, -1, 0, 0, 0, 5.0, 0.0, 0.0, 0.0],
        [2, 0, 2, 0, 1, -5.0, 0.0, 3.0, 0.0],
        [0, 1, 0, -2, 0, -4.0, 0.0, 0.0, 0.0],
        [1, 0, -2, 0, 0, 4.0, 0.0, 0.0, 0.0],
        [0, 0, 0, 1, 0, -4.0, 0.0, 0.0, 0.0],
        [1, 1, 0, 0, 0, -3.0, 0.0, 0.0, 0.0],
        [1, 0, 2, 0, 0, 3.0, 0.0, 0.0, 0.0],
        [1, -1, 2, 0, 2, -3.0, 0.0, 1.0, 0.0],
        [-1, -1, 2, 2, 2, -3.0, 0.0, 1.0, 0.0],
        [-2, 0, 0, 0, 1, -2.0, 0.0, 1.0, 0.0],
        [3, 0, 2, 0, 2, -3.0, 0.0, 1.0, 0.0],
        [0, -1, 2, 2, 2, -3.0, 0.0, 1.0, 0.0],
        [1, 1, 2, 0, 2, 2.0, 0.0, -1.0, 0.0],
        [-1, 0, 2, -2, 1, -2.0, 0.0, 1.0, 0.0],
        [2, 0, 0, 0, 1, 2.0, 0.0, -1.0, 0.0],
        [1, 0, 0, 0, 2, -2.0, 0.0, 1.0, 0.0],
        [3, 0, 0, 0, 0, 2.0, 0.0, 0.0, 0.0],
        [0, 0, 2, 1, 2, 2.0, 0.0, -1.0, 0.0],
        [-1, 0, 0, 0, 2, 1.0, 0.0, -1.0, 0.0],
        [1, 0, 0, -4, 0, -1.0, 0.0, 0.0, 0.0],
        [-2, 0, 2, 2, 2, 1.0, 0.0, -1.0, 0.0],
        [-1, 0, 2, 4, 2, -2.0, 0.0, 1.0, 0.0],
        [2, 0, 0, -4, 0, -1.0, 0.0, 0.0, 0.0],
        [1, 1, 2, -2, 2, 1.0, 0.0, -1.0, 0.0],
        [1, 0, 2, 2, 1, -1.0, 0.0, 1.0, 0.0],
        [-2, 0, 2, 4, 2, -1.0, 0.0, 1.0, 0.0],
        [-1, 0, 4, 0, 2, 1.0, 0.0, 0.0, 0.0],
        [1, -1, 0, -2, 0, 1.0, 0.0, 0.0, 0.0],
        [2, 0, 2, -2, 1, 1.0, 0.0, -1.0, 0.0],
        [2, 0, 2, 2, 2, -1.0, 0.0, 0.0, 0.0],
        [1, 0, 0, 2, 1, -1.0, 0.0, 0.0, 0.0],
        [0, 0, 4, -2, 2, 1.0, 0.0, 0.0, 0.0],
        [3, 0, 2, -2, 2, 1.0, 0.0, 0.0, 0.0],
        [1, 0, 2, -2, 0, -1.0, 0.0, 0.0, 0.0],
        [0, 1, 2, 0, 1, 1.0, 0.0, 0.0, 0.0],
        [-1, -1, 0, 2, 1, 1.0, 0.0, 0.0, 0.0],
        [0, 0, -2, 0, 1, -1.0, 0.0, 0.0, 0.0],
        [0, 0, 2, -1, 2, -1.0, 0.0, 0.0, 0.0],
        [0, 1, 0, 2, 0, -1.0, 0.0, 0.0, 0.0],
        [1, 0, -2, -2, 0, -1.0, 0.0, 0.0, 0.0],
        [0, -1, 2, 0, 1, -1.0, 0.0, 0.0, 0.0],
        [1, 1, 0, -2, 1, -1.0, 0.0, 0.0, 0.0],
        [1, 0, -2, 2, 0, -1.0, 0.0, 0.0, 0.0],
        [2, 0, 0, 2, 0, 1.0, 0.0, 0.0, 0.0],
        [0, 0, 2, 4, 2, -1.0, 0.0, 0.0, 0.0],
        [0, 1, 0, 1, 0, 1.0, 0.0, 0.0, 0.0],
    ]
)
assert _NUT_SERIES.shape == (106, 9)

_NUT_MULT = _NUT_SERIES[:, :5]  # (106, 5)

# Fundamental argument polynomials (arcsec), Delaunay arguments l, l', F, D, Om
_FUND_POLY = np.array(
    [
        [485_866.733, 1_717_915_922.633, 31.310, 0.064],  # l  (Moon anomaly)
        [1_287_099.804, 129_596_581.224, -0.577, -0.012],  # l' (Sun anomaly)
        [335_778.877, 1_739_527_263.137, -13.257, 0.011],  # F
        [1_072_261.307, 1_602_961_601.328, -6.891, 0.019],  # D
        [450_160.280, -6_962_890.539, 7.455, 0.008],  # Om
    ]
)


def _consts(device):
    """The series tables as float64 tensors on ``device``."""
    return (
        torch.as_tensor(_FUND_POLY, dtype=torch.float64, device=device),
        torch.as_tensor(_NUT_MULT, dtype=torch.float64, device=device),
        torch.as_tensor(_NUT_SERIES[:, 5:], dtype=torch.float64, device=device),
    )


def obleq(tjm, device=None):
    """Mean obliquity of the ecliptic (IAU 1976), radians.  MJD(TT) in."""
    t = (as_f64(tjm, device) - T2000) / 36525.0
    ob0 = ((23.0 * 3600.0 + 26.0 * 60.0) + 21.448) * RADSEC
    ob1 = -46.815 * RADSEC
    ob2 = -0.0006 * RADSEC
    ob3 = 0.00181 * RADSEC
    return ((ob3 * t + ob2) * t + ob1) * t + ob0


def nutn80(tjm, device=None):
    """IAU-1980 nutation angles (dpsi, deps) in ARCSECONDS.  MJD(TT) in.

    Vectorized: input shape (...) -> outputs shape (...).
    """
    t = (as_f64(tjm, device) - T2000) / 36525.0
    fund_poly, mult, amp = _consts(t.device)
    tp = torch.stack([torch.ones_like(t), t, t * t, t * t * t], dim=-1)  # (..., 4)
    fund = torch.sum(tp[..., None, :] * fund_poly, -1) * RADSEC  # (..., 5)
    arg = torch.sum(fund[..., None, :] * mult, -1)  # (..., 106)
    t_ = t[..., None]
    a, at, b, bt = amp[:, 0], amp[:, 1], amp[:, 2], amp[:, 3]
    dpsi = torch.sum((a + at * t_) * torch.sin(arg), dim=-1)
    deps = torch.sum((b + bt * t_) * torch.cos(arg), dim=-1)
    return dpsi * 1e-4, deps * 1e-4


def rnut80(tjm, device=None):
    """Nutation rotation matrix (mean equator of date -> true equator of
    date), passive form: ``x_true = N @ x_mean``.  Returns (..., 3, 3)."""
    from outfit_tpu_torch.frames.ref_system import rotmt

    epsm = obleq(tjm, device)
    dpsi, deps = nutn80(tjm, device)
    dpsi = dpsi * RADSEC
    epst = epsm + deps * RADSEC
    return matmul_small(
        matmul_small(rotmt(-epst, 0), rotmt(-dpsi, 2)), rotmt(epsm, 0)
    )


def equequ(tjm, device=None):
    """Equation of the equinoxes (radians): dpsi * cos(eps).  MJD(TT) in."""
    oblm = obleq(tjm, device)
    dpsi, _ = nutn80(tjm, device)
    return RADSEC * dpsi * torch.cos(oblm)


def prec(tjm, device=None):
    """IAU-1976 precession matrix from J2000 to mean equator/equinox of
    date, passive: ``x_mean(tjm) = prec(tjm) @ x_J2000``.  Returns (..., 3, 3)."""
    from outfit_tpu_torch.frames.ref_system import rotmt

    t = (as_f64(tjm, device) - T2000) / 36525.0
    zeta = ((0.0000050 * t + 0.0000839) * t + 0.6406161) * t * RADEG
    z = ((0.0000051 * t + 0.0003041) * t + 0.6406161) * t * RADEG
    theta = ((-0.0000116 * t - 0.0001185) * t + 0.5567530) * t * RADEG
    return matmul_small(
        matmul_small(rotmt(-z, 2), rotmt(theta, 1)), rotmt(-zeta, 2)
    )
