"""Peaks of the card and the operations and bytes of the program's
kernels, reckoned from the shapes of each call.

Peaks: NVIDIA H100 SXM (data sheet): HBM3 3.35 TB/s, float64 outside the
tensor cores 34 TFLOP/s.  A kernel's least time is the larger of its
bytes over the bandwidth and its operations over the peak rate; each
input byte is counted once, each output byte once.
"""

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FP64_FLOP_PER_S = 34e12


def k1_flops(n_coeff, ch, deriv):
    """Floating-point operations of one K1 query: x and tau (5), the T_k
    recurrence (3 per k >= 2) and dT_k (5 more), the contraction (a
    multiply and an add per coefficient and channel, twice with the
    derivative) and the derivative's scale."""
    per_k = 3 + (5 if deriv else 0)
    return 5 + (n_coeff - 2) * per_k + n_coeff * ch * 2 * (2 if deriv else 1) + (ch if deriv else 0)


def touched_rows(mjd, t0, gran, n_gran):
    """The distinct table rows K1 reads for the epochs ``mjd``: their
    granule indices, clamped to the table."""
    return len(np.unique(np.clip(np.floor((np.asarray(mjd) - t0) / gran), 0, n_gran - 1)))


def k1_bound_s(n, coeffs_shape, deriv, rows):
    """Least seconds of one K1 call: the epochs (n), the outputs (n x ch,
    twice with the derivative) and the ``rows`` table rows read, against
    the operations."""
    g, ch, c = coeffs_shape
    nbytes = 8 * (n + n * ch * (2 if deriv else 1) + rows * ch * c)
    return max(nbytes / HBM_BYTES_PER_S, n * k1_flops(c, ch, deriv) / FP64_FLOP_PER_S)
