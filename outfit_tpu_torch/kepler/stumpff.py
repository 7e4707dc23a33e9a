"""Generalized Stumpff functions s0..s3, batched.

Port of ``outfit_tpu/kepler/stumpff.py``: the same (psi, alpha) ->
(s0, s1, s2, s3) contract with alpha = -1/a,

    s2 = psi^2/2 + beta psi^4/4! + ...,   s3 = psi^3/3! + beta psi^5/5! + ...
    s0 = 1 + alpha*s2,  s1 = psi + alpha*s3,  beta = alpha*psi^2.

The halving count is closed-form, ``k = ceil(log4(|beta|))``; the series runs
a fixed 12 terms at the reduced ``|beta| <= 1``; the duplication loop
scales s2/s3 back up with the cancellation-free recurrences

    s2(2p) = 2*s2*(2 + alpha*s2),   s3(2p) = 2*(s3 + p*s2 + alpha*s2*s3).

The JAX ``while_loop`` over the duplication runs to the batch's ``max(k)``;
here that bound is read once per call (one host sync), and lanes with
fewer halvings are frozen by a masked ``where``, so the values are those
of the JAX loop whatever the batch holds.
"""

import numpy as np
import torch

from outfit_tpu_torch import trace
from outfit_tpu_torch.utils.tensors import as_floats, device_constant

#: Reduce |beta| below this before the series (power of 4 friendly).
_BETA_THRESHOLD = 1.0
#: Fixed series term count at |beta| <= 1 (term ratio < 1/12 per step).
_N_SERIES = 12
#: Max halvings: covers |beta| up to 4^40 ~ 1e24.
_MAX_HALVINGS = 40

_POW2NEG = 2.0 ** -np.arange(_MAX_HALVINGS + 1, dtype=np.float64)


def halving_count(psi, alpha):
    """Per-lane duplication count ``k`` (int64) of :func:`s_funct`."""
    beta = alpha * psi * psi
    safe = torch.clamp(torch.abs(beta), min=_BETA_THRESHOLD)
    k = torch.clamp(torch.ceil(0.5 * torch.log2(safe / _BETA_THRESHOLD)), 0, _MAX_HALVINGS)
    # a NaN lane halves 0 times, as XLA's float->int conversion makes it
    return torch.nan_to_num(k, nan=0.0).to(torch.int64)


def s_funct(psi, alpha, k=None, kmax=None):
    """Compute (s0, s1, s2, s3) for universal anomaly psi and alpha = -1/a.

    Shapes broadcast.  ``k`` (from :func:`halving_count`) and ``kmax`` (any
    bound >= ``k.max()``) may be passed by a caller that already has them;
    otherwise ``kmax`` is read from the device here.  Runs in the
    inputs' precision (float32 on the mixed-precision path).
    """
    psi, alpha = torch.broadcast_tensors(*as_floats(psi, alpha))
    beta = alpha * psi * psi
    if k is None:
        k = halving_count(psi, alpha)
    if kmax is None:
        kmax = trace.sites.stumpff_kmax.item(k.max()) if k.numel() else 0

    scale = device_constant(_POW2NEG, psi.device, psi.dtype)[k]  # exact powers of two
    psi_r = psi * scale
    beta_r = beta * scale * scale

    psi2 = psi_r * psi_r
    s2 = 0.5 * psi2
    s3 = s2 * psi_r / 3.0
    term2 = s2
    term3 = s3
    for n in range(1, _N_SERIES + 1):
        term2 = term2 * (beta_r / ((2.0 * n + 1.0) * (2.0 * n + 2.0)))
        term3 = term3 * (beta_r / ((2.0 * n + 2.0) * (2.0 * n + 3.0)))
        s2 = s2 + term2
        s3 = s3 + term3

    p = psi_r
    for i in range(kmax):
        act = i < k
        s2n = 2.0 * s2 * (2.0 + alpha * s2)
        s3n = 2.0 * (s3 + p * s2 + alpha * s2 * s3)
        p = torch.where(act, 2.0 * p, p)
        s2 = torch.where(act, s2n, s2)
        s3 = torch.where(act, s3n, s3)

    s0 = 1.0 + alpha * s2
    s1 = psi + alpha * s3
    return s0, s1, s2, s3
