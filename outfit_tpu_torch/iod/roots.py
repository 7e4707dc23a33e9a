"""Batched Aberth-Ehrlich root finder for the sparse Gauss degree-8 polynomial

    p(x) = x^8 + c6 x^6 + c3 x^3 + c0.

Port of ``outfit_tpu/iod/roots.py``: complex arithmetic as explicit
(re, im) pairs in the coefficients' precision (float64, or float32 on the
mixed-precision path, with the division guard and the freeze threshold
floored at that dtype's tiny and epsilon), a fixed initial circle, sticky
per-root freezing, and a batch-converged loop that reads the device once
per trip.  Roots are returned sorted by real part unless ``sort=False``.
"""

import numpy as np
import torch

from outfit_tpu_torch import trace
from outfit_tpu_torch.utils.tensors import as_floats, device_constant, lanewise

#: initial circle: 8 angles with a Bini-style offset of 0.4
_THETA = 2.0 * np.pi * np.arange(8) / 8.0 + 0.4
_COS_THETA, _SIN_THETA = np.cos(_THETA), np.sin(_THETA)


def descartes_upper_bound(c0, c3, c6):
    """Upper bound on positive real roots via Descartes' rule of signs
    (sign sequence of [1, c6, c3, c0], zeros skipped).
    Parity: ``descartes_upper_bound_deg8_sparse`` (gauss.rs:214-240)."""
    c6, c3, c0 = as_floats(c6, c3, c0)
    prev = torch.ones_like(c6)
    cnt = torch.zeros(c6.shape, dtype=torch.int32, device=c6.device)
    for c in (c6, c3, c0):
        s = torch.sign(c)
        is_nonzero = s != 0
        cnt = cnt + (is_nonzero & (s * prev < 0)).to(torch.int32)
        prev = torch.where(is_nonzero, s, prev)
    return cnt


class ComplexRoots:
    """(re, im) pair container for the (..., 8) roots."""

    def __init__(self, re, im):
        self.real = re
        self.imag = im

    @property
    def shape(self):
        return self.real.shape


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cdiv(ar, ai, br, bi):
    d = br * br + bi * bi
    d = torch.where(d > torch.finfo(d.dtype).tiny, d, 1.0)
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def aberth_deg8(c0, c3, c6, max_iter: int = 50, eps: float = 1e-6, active=None, sort=True):
    """All 8 complex roots of x^8 + c6 x^6 + c3 x^3 + c0, batched.

    ``active``: optional per-lane mask; inactive lanes are frozen from the
    start so they never hold the loop open (the reference skips Aberth for
    Descartes-zero triplets, gauss.rs:1130-1135)."""
    c0, c3, c6 = as_floats(c0, c3, c6)
    dev, dtype = c0.device, c0.dtype
    shape = torch.broadcast_shapes(c0.shape, c3.shape, c6.shape)
    c0, c3, c6 = (torch.broadcast_to(c, shape)[..., None] for c in (c0, c3, c6))

    def p(zr, zi):
        z2r, z2i = _cmul(zr, zi, zr, zi)
        z3r, z3i = _cmul(z2r, z2i, zr, zi)
        z6r, z6i = _cmul(z3r, z3i, z3r, z3i)
        z8r, z8i = _cmul(z6r, z6i, z2r, z2i)
        return z8r + c6 * z6r + c3 * z3r + c0, z8i + c6 * z6i + c3 * z3i

    def dp(zr, zi):
        z2r, z2i = _cmul(zr, zi, zr, zi)
        z4r, z4i = _cmul(z2r, z2i, z2r, z2i)
        z5r, z5i = _cmul(z4r, z4i, zr, zi)
        z7r, z7i = _cmul(z5r, z5i, z2r, z2i)
        return (
            8.0 * z7r + 6.0 * c6 * z5r + 3.0 * c3 * z2r,
            8.0 * z7i + 6.0 * c6 * z5i + 3.0 * c3 * z2i,
        )

    # initial circle: radius |c0|^(1/8) floored at 0.3, angular offset 0.4
    r = torch.clamp(lanewise(torch.pow, torch.abs(c0[..., 0]), 0.125), min=0.3)[..., None]
    zr = r * device_constant(_COS_THETA, dev, dtype)
    zi = r * device_constant(_SIN_THETA, dev, dtype)

    eye = torch.eye(8, dtype=torch.bool, device=dev)
    # freeze threshold: eps capped at ~machine precision of float64, floored
    # at 30 eps of the working dtype (a 1e-6 relative step is out of reach
    # of clustered float32 roots; the mixed path re-Newtons the winner)
    thr = max(min(eps, 450.0 * 2.220446049250313e-16), 30.0 * torch.finfo(dtype).eps)

    done = torch.zeros(zr.shape, dtype=torch.bool, device=dev)
    if active is not None:
        done = done | ~active[..., None]
    for _ in range(max_iter):
        if not trace.sites.iod_aberth.live_lanes(~done):
            break
        pr, pi = p(zr, zi)
        dpr, dpi = dp(zr, zi)
        nr, ni = _cdiv(pr, pi, dpr, dpi)  # Newton correction
        # sum over j != i of 1 / (z_i - z_j)
        dr = torch.where(eye, 1.0, zr[..., :, None] - zr[..., None, :])
        di = torch.where(eye, 0.0, zi[..., :, None] - zi[..., None, :])
        ir, ii = _cdiv(torch.ones_like(dr), torch.zeros_like(di), dr, di)
        sr = torch.sum(torch.where(eye, 0.0, ir), dim=-1)
        si = torch.sum(torch.where(eye, 0.0, ii), dim=-1)
        # w = newton / (1 - newton * sum)
        tr, ti = _cmul(nr, ni, sr, si)
        wr, wi = _cdiv(nr, ni, 1.0 - tr, -ti)
        wmag = torch.sqrt(wr * wr + wi * wi)
        zmag = torch.sqrt(zr * zr + zi * zi)
        # sticky freeze: a converged root stays frozen
        done = done | (wmag <= thr * (1.0 + zmag))
        zr = torch.where(done, zr, zr - wr)
        zi = torch.where(done, zi, zi - wi)
    if not sort:
        return ComplexRoots(zr, zi)
    order = torch.argsort(zr, dim=-1, stable=True)
    return ComplexRoots(torch.gather(zr, -1, order), torch.gather(zi, -1, order))

