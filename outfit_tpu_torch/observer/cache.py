"""Per-dataset precomputed observer state tensors.

Port of ``outfit_tpu/observer/cache.py``: once per dataset, the geocentric
and heliocentric observer states of every observation, as dense ``(n, 3)``
float64 tensors on the fitting device.

The slow frame chain (precession + 106-term nutation, and the equation of
the equinoxes) is fitted once per dataset with Chebyshev polynomials on
<= 8-day granules (:func:`_frame_table`) and evaluated per observation by
the CUDA kernel of :mod:`outfit_tpu_torch.ephem.chebyshev_cuda`
(:func:`_frame_interp`); the Earth's state comes from the ephemeris tables
through the same kernel.
"""

from typing import NamedTuple

import numpy as np
import torch

from outfit_tpu_torch import trace
from outfit_tpu_torch.ephem import chebyshev_cuda
from outfit_tpu_torch.ephem.chebyshev import granule_index
from outfit_tpu_torch.frames import RefEpoch, RefSystem, equequ, rotmt, rotpn
from outfit_tpu_torch.observer.geometry import earth_fixed_position, earth_fixed_velocity, helio_state
from outfit_tpu_torch.time import gmst
from outfit_tpu_torch.time.scales import Ut1Provider
from outfit_tpu_torch.utils.linalg import matmul_small
from outfit_tpu_torch.utils.tensors import resolve_device

#: Chebyshev-Lobatto coefficients per frame-table granule
_N_COEFF = 14


def _frame_table(t0, gran, n_gran, device):
    """Chebyshev coefficients of the slow frame chain on [t0, t0+G*gran]:
    the 9 components of rotpn(Equt(of-date) -> Eclm(J2000)) plus the
    equation of the equinoxes.  Returns (G, 10, C), contiguous."""
    C = _N_COEFF
    k = np.arange(C)
    nodes01 = 0.5 * (1.0 - np.cos(np.pi * k / (C - 1)))  # ascending in t
    f64 = dict(dtype=torch.float64, device=device)
    tk = t0 + gran * (
        torch.arange(n_gran, **f64)[:, None] + torch.as_tensor(nodes01, **f64)[None, :]
    )
    m_slow = rotpn(
        RefSystem.equt(RefEpoch.of_date(tk)), RefSystem.eclm(RefEpoch.j2000())
    )  # (G, C, 3, 3)
    eqq = equequ(tk)  # (G, C)
    chan = torch.cat([m_slow.reshape(n_gran, C, 9), eqq[..., None]], dim=-1)  # (G, C, 10)

    # first-kind Chebyshev-Lobatto fit (see chebyshev.fit_body_table), samples
    # flipped to align with x_m = cos(pi m / (C-1))
    T = np.cos(np.pi * np.outer(np.arange(C), k) / (C - 1))
    w = np.ones(C)
    w[0] = w[-1] = 0.5
    scale = np.full(C, 2.0 / (C - 1))
    scale[0] = scale[-1] = 1.0 / (C - 1)
    Tw = torch.as_tensor(T * w * scale[:, None], **f64)  # (j, m)
    samples = torch.flip(chan, dims=[1])  # (G, m, 10)
    coeffs = torch.sum(
        Tw[None, :, None, :] * torch.swapaxes(samples, 1, 2)[:, None, :, :],
        dim=-1,
    )  # (G, j, 10)
    return torch.swapaxes(coeffs, 1, 2).contiguous()


def _frame_split(vals):
    m_slow = vals[..., :9].reshape(vals.shape[:-1] + (3, 3))
    return m_slow, vals[..., 9]


def _frame_interp_plain(coeffs, mjd, t0, gran):
    """Plain PyTorch evaluation of the frame table at ``mjd`` (any device):
    (M_slow (..., 3, 3), equequ (...))."""
    n_gran, _, C = coeffs.shape
    idx, tau = granule_index(mjd, t0, gran, n_gran)
    t_prev = torch.ones_like(tau)
    t_cur = tau
    ts = [t_prev, t_cur]
    for _ in range(2, C):
        t_next = 2.0 * tau * t_cur - t_prev
        ts.append(t_next)
        t_prev, t_cur = t_cur, t_next
    tb = torch.stack(ts[:C], dim=-1)  # (..., C)
    ch = coeffs[idx]  # (..., 10, C)
    return _frame_split(torch.sum(ch * tb[..., None, :], dim=-1))


def _frame_interp(coeffs, mjd, t0, gran):
    """Evaluate the frame table at ``mjd`` (N,): the CUDA kernel for epochs
    on a CUDA device, the plain version on the CPU."""
    if mjd.device.type != "cuda":
        return _frame_interp_plain(coeffs, mjd, t0, gran)
    vals, _ = chebyshev_cuda.evaluate(coeffs, mjd.contiguous(), t0, gran, "frame")
    return _frame_split(vals)


def _cache_compute(mjd, tut, fp, fv, t0, gran, ephem, cache_velocity, n_gran):
    coeffs = _frame_table(t0, gran, n_gran, mjd.device)
    m_slow, eqq = _frame_interp(coeffs, mjd, t0, gran)
    g = gmst(tut) + eqq
    rot_earth = rotmt(-g, 2)  # body-fixed -> true equator of date
    m = matmul_small(m_slow, rot_earth)
    geo_pos = torch.sum(m * fp[..., None, :], -1)
    geo_vel = torch.sum(m * fv[..., None, :], -1)
    if not cache_velocity:
        geo_vel = torch.zeros_like(geo_vel)
    hp, hv = helio_state(ephem, mjd, geo_pos, geo_vel)
    return geo_pos, geo_vel, hp, hv


def frame_granules(mjd_tt: np.ndarray):
    """``(n_gran, gran, t0)`` of the frame table, as ``cache.py:213-218``:
    <= 8-day granules, a power-of-two count capped at 4096."""
    span = float(mjd_tt.max() - mjd_tt.min())
    n_gran = 8
    while n_gran * 8.0 < span and n_gran < 4096:
        n_gran *= 2
    gran = max(span / n_gran, 1e-3) * (1.0 + 1e-9)
    return n_gran, gran, float(mjd_tt.min())


class ObserverCache(NamedTuple):
    """Dense per-observation observer states: geocentric in ecliptic J2000,
    heliocentric in equatorial J2000.

    The tensors hold ``nb`` rows, ``n`` real ones padded to a power of two
    as the JAX package pads them (padded rows repeat the first epoch); the
    unpadded views are properties.
    """

    n: int  # real observation count
    mjd_tt: np.ndarray  # (n,) host-resident epochs
    geo_pos_pad: torch.Tensor  # (nb, 3) AU
    geo_vel_pad: torch.Tensor  # (nb, 3) AU/day
    helio_pos_pad: torch.Tensor  # (nb, 3) AU
    helio_vel_pad: torch.Tensor  # (nb, 3) AU/day

    @property
    def geo_pos_ecl(self):
        return self.geo_pos_pad[: self.n]

    @property
    def geo_vel_ecl(self):
        return self.geo_vel_pad[: self.n]

    @property
    def helio_pos_equ(self):
        return self.helio_pos_pad[: self.n]

    @property
    def helio_vel_equ(self):
        return self.helio_vel_pad[: self.n]

    @classmethod
    def build(cls, dataset, ephem, ut1: Ut1Provider = None, cache_velocity: bool = True, device=None):
        """Build from an ObsDataset + ephemeris: the JAX parameters in the
        JAX order, then ``device`` (None: the card when one is present).
        ``cache_velocity=False`` zeroes the geocentric observer velocity, so
        the heliocentric velocity is the Earth's.  UT1 table interpolation
        stays host-side."""
        with trace.span("observer_cache"):
            device = resolve_device(device)
            if ut1 is None:
                ut1 = Ut1Provider()
            if len(dataset.mjd_tt) == 0:
                z = torch.zeros((0, 3), dtype=torch.float64, device=device)
                return cls(0, np.zeros(0), z, z, z, z)
            ephem = ephem.to(device)
            fixed_pos = np.stack([np.asarray(earth_fixed_position(o)) for o in dataset.observers])
            fixed_vel = np.stack([np.asarray(earth_fixed_velocity(o)) for o in dataset.observers])

            n = len(dataset.mjd_tt)
            nb = 8
            while nb < n:
                nb *= 2
            pad = nb - n
            mjd_np = np.concatenate([dataset.mjd_tt, np.full(pad, dataset.mjd_tt[0])])
            tut = ut1.tt_mjd_to_ut1(mjd_np)
            oi = np.concatenate([np.asarray(dataset.observer_index, np.int64), np.zeros(pad, np.int64)])
            n_gran, gran, t0 = frame_granules(dataset.mjd_tt)

            f64 = dict(dtype=torch.float64, device=device)
            oi_t = torch.as_tensor(oi, device=device)
            geo_pos, geo_vel, hp, hv = _cache_compute(
                torch.as_tensor(mjd_np, **f64),
                torch.as_tensor(tut, **f64),
                torch.as_tensor(fixed_pos, **f64)[oi_t],
                torch.as_tensor(fixed_vel, **f64)[oi_t],
                t0, gran, ephem, cache_velocity, n_gran,
            )
            return cls(n, np.asarray(dataset.mjd_tt), geo_pos, geo_vel, hp, hv)
