"""Chebyshev ephemeris tables and batched interpolation.

Port of ``outfit_tpu/ephem/chebyshev.py``.  Per body, a granule-uniform
coefficient tensor ``coeffs[n_granules, 3, n_coeff]`` in AU over
``[t0, t0 + n_granules * granule_days]`` (MJD TT/TDB).  A query is one
gather (granule row) and one Chebyshev-basis contraction.

:func:`interpolate_body` launches the CUDA kernel
(:mod:`outfit_tpu_torch.ephem.chebyshev_cuda`) for epochs on a CUDA device
and :func:`interpolate_body_plain` for epochs on the CPU.
"""

from typing import NamedTuple

import numpy as np
import torch

from outfit_tpu_torch.ephem import chebyshev_cuda
from outfit_tpu_torch.utils.tensors import as_f64


class BodyTable(NamedTuple):
    """Granule-uniform Chebyshev table for one body (positions in AU)."""

    t0: float  # MJD of first granule start
    granule_days: float
    coeffs: torch.Tensor  # (n_granules, 3, n_coeff) float64, contiguous

    @property
    def t_end(self):
        return self.t0 + self.coeffs.shape[0] * self.granule_days

    def to(self, device) -> "BodyTable":
        return self._replace(coeffs=self.coeffs.to(device))


def _chebyshev_basis(tau, n):
    """T_k(tau) and dT_k/dtau for k < n; tau shape (...) -> (..., n)."""
    t_prev = torch.ones_like(tau)
    t_cur = tau
    d_prev = torch.zeros_like(tau)
    d_cur = torch.ones_like(tau)
    ts = [t_prev, t_cur]
    ds = [d_prev, d_cur]
    for _ in range(2, n):
        t_next = 2.0 * tau * t_cur - t_prev
        d_next = 2.0 * t_cur + 2.0 * tau * d_cur - d_prev
        ts.append(t_next)
        ds.append(d_next)
        t_prev, t_cur = t_cur, t_next
        d_prev, d_cur = d_cur, d_next
    return torch.stack(ts[:n], dim=-1), torch.stack(ds[:n], dim=-1)


def granule_index(mjd, t0, gran, n_gran):
    """(granule index, tau in [-1, 1]) of each epoch, as the JAX package's
    ``chebyshev.py:63-65``: the index is clamped after flooring."""
    x = (mjd - t0) / gran
    idx = torch.clamp(torch.floor(x).to(torch.int64), 0, n_gran - 1)
    tau = 2.0 * (x - idx) - 1.0
    return idx, tau


def interpolate_body_plain(table: BodyTable, mjd, velocity: bool = True):
    """Plain PyTorch interpolation: position (AU) and velocity (AU/day) at
    batched epochs, on any device.  Epochs outside coverage are clamped to
    the boundary granule."""
    mjd = as_f64(mjd, table.coeffs.device)
    n_gran, _, n_coeff = table.coeffs.shape
    idx, tau = granule_index(mjd, table.t0, table.granule_days, n_gran)
    c = table.coeffs[idx]  # (..., 3, n_coeff)
    tb, db = _chebyshev_basis(tau, n_coeff)  # (..., n_coeff)
    pos = torch.sum(c * tb[..., None, :], -1)
    if not velocity:
        return pos, None
    vel = torch.sum(c * db[..., None, :], -1) * (2.0 / table.granule_days)
    return pos, vel


def interpolate_body(table: BodyTable, mjd, velocity: bool = True):
    """Position (AU) and velocity (AU/day) at batched epochs: the CUDA
    kernel for epochs on a CUDA device, the plain version on the CPU."""
    mjd = as_f64(mjd, table.coeffs.device)
    if mjd.device.type != "cuda":
        return interpolate_body_plain(table, mjd, velocity)
    flat = mjd.reshape(-1).contiguous()
    pos, vel = chebyshev_cuda.evaluate(
        table.coeffs, flat, table.t0, table.granule_days, "body"
    )
    shape = mjd.shape + (3,)
    return pos.reshape(shape), (vel.reshape(shape) if velocity else None)


def fit_body_table(
    state_fn,
    t0: float,
    t1: float,
    granule_days: float = 16.0,
    n_coeff: int = 14,
) -> BodyTable:
    """Build a BodyTable by Chebyshev-fitting a host-side position function
    (numpy, the JAX package's arithmetic), ``state_fn(mjd_array) -> (n, 3)``
    AU, by Chebyshev-Gauss-Lobatto collocation per granule."""
    n_gran = int(np.ceil((t1 - t0) / granule_days))
    k = np.arange(n_coeff)
    nodes = 0.5 * (1.0 - np.cos(np.pi * k / (n_coeff - 1)))  # [0,1], ascending

    starts = t0 + granule_days * np.arange(n_gran)
    times = (starts[:, None] + granule_days * nodes[None, :]).ravel()
    pos = np.asarray(state_fn(times)).reshape(n_gran, n_coeff, 3)

    T = np.cos(np.pi * np.outer(np.arange(n_coeff), k) / (n_coeff - 1))
    w = np.ones(n_coeff)
    w[0] = w[-1] = 0.5
    scale = np.ones(n_coeff) * (2.0 / (n_coeff - 1))
    scale[0] = scale[-1] = 1.0 / (n_coeff - 1)
    samples = pos[:, ::-1, :]  # aligned with x_m = cos(pi m / (n-1))
    coeffs = np.einsum("jm,m,gmc->gcj", T, w, samples) * scale
    return BodyTable(float(t0), float(granule_days), torch.from_numpy(np.ascontiguousarray(coeffs)))
