"""Batched adaptive DOP853 integrator (Dormand-Prince 8(5,3)).

Port of ``outfit_tpu/propagator/dop853.py``: a lane-batched, masked,
adaptive-step explicit Runge-Kutta with Hairer's DOP853 coefficients (from
scipy's published tables), scipy's combined 5th/3rd-order error estimate
and the standard step-size controller.

Every lane carries its own (t, h, y, done, failed, steps); each loop trip
advances all unfinished lanes in lockstep and accepts or rejects the step
per lane by mask.  The loop exits when every lane has reached t1 or failed,
or the step budget is spent (status 1).  The JAX ``while_loop`` is a Python
``while`` on the count of unfinished lanes: one host sync per trip.  No
reduction runs over lanes except that exit test, so a lane's result does
not depend on the rest of the batch.

The controller's ``err_norm ** (-1/8)`` is taken as three square roots and
a reciprocal: each is correctly rounded on the CPU's scalar and vector
paths and on CUDA alike, where ``pow`` differs in the last bit, and an
accept or reject near ``err_norm == 1`` would then depend on where a lane
lies in its batch.
"""

import functools
from typing import NamedTuple

import numpy as np
import torch

from outfit_tpu_torch import trace
from outfit_tpu_torch.utils.tensors import as_f64, input_device

_N_STAGES = 12

_SAFETY = 0.9
_MIN_FACTOR = 0.2
_MAX_FACTOR = 10.0


@functools.lru_cache(maxsize=None)
def _tableau():
    """Hairer's coefficients ``(A, B, C, E3, E5)`` from scipy, read on the
    first integration so that the package imports, and fits with the
    two-body propagator run, where scipy is not installed; an integration
    without scipy raises the ImportError."""
    from scipy.integrate._ivp import dop853_coefficients as d

    assert int(d.N_STAGES) == _N_STAGES
    return (
        np.array(d.A[:_N_STAGES, :_N_STAGES]),
        np.array(d.B),
        np.array(d.C[:_N_STAGES]),
        np.array(d.E3),  # (13,)
        np.array(d.E5),
    )


class Dop853Result(NamedTuple):
    y: torch.Tensor  # (..., n) final state
    status: torch.Tensor  # (...): 0 ok, 1 step budget exhausted
    n_steps: torch.Tensor  # accepted steps


def _combine(weights, ks):
    """sum_s weights[s] * ks[s] over the non-zero weights, accumulated in
    stage order."""
    acc = None
    for w, k in zip(weights, ks):
        w = float(w)
        if w != 0.0:
            acc = w * k if acc is None else acc + w * k
    return acc


def dop853_integrate(rhs, y0, t0, t1, rtol=1e-12, atol=1e-12, max_steps=1000, device=None):
    """Integrate dy/dt = rhs(t, y) from t0 to t1, batched over leading dims.

    ``y0`` (..., n); ``t0``/``t1`` broadcastable to (...).  ``rhs`` must be
    vectorized over the same batch shape and is called with tensors on the
    integration's device.  Supports per-lane forward or backward
    integration (h carries the sign of t1 - t0).  ``device``: where the
    integration runs; default ``"cuda"`` when a card is present (the card
    of a CUDA tensor among ``y0``, ``t0`` and ``t1``), else ``"cpu"``.
    """
    with trace.span("dop853"):
        tab_a, tab_b, tab_c, tab_e3, tab_e5 = _tableau()
        dev = input_device(device, y0, t0, t1)
        y = as_f64(y0, dev).to(dev)
        batch = y.shape[:-1]
        n = y.shape[-1]
        t0 = torch.broadcast_to(as_f64(t0, dev).to(dev), batch)
        t1 = torch.broadcast_to(as_f64(t1, dev).to(dev), batch)

        span = t1 - t0
        direction = torch.where(span >= 0, 1.0, -1.0)
        # initial step: conservative fraction of the span
        h_cur = direction * torch.clamp(torch.abs(span) * 1e-3, min=1e-8)
        # keep the sign, bound below to avoid stalling
        h_min = 1e-12 * torch.maximum(torch.abs(t0), torch.abs(t1)) + 1e-13
        h_floor = direction * h_min

        t = t0
        done = torch.abs(span) < 1e-14
        failed = torch.zeros(batch, dtype=torch.bool, device=dev)
        steps = torch.zeros(batch, dtype=torch.int32, device=dev)

        trips = 0
        while trips < max_steps and trace.sites.dop853.live_lanes(~done & ~failed):
            # clip h so we do not overshoot t1
            remaining = t1 - t
            h = torch.where(torch.abs(h_cur) > torch.abs(remaining), remaining, h_cur)
            h = torch.where(done, 0.0, h)
            hb = h[..., None]

            k = [rhs(t, y)]
            for s in range(1, _N_STAGES):
                k.append(rhs(t + float(tab_c[s]) * h, y + hb * _combine(tab_a[s, :s], k)))
            y_new = y + hb * _combine(tab_b, k)
            k.append(rhs(t + h, y_new))  # K[12] (FSAL-style extra evaluation)

            # scipy's combined 5th/3rd order error estimate
            scale = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y_new))
            err5 = _combine(tab_e5, k) / scale
            err3 = _combine(tab_e3, k) / scale
            e5n2 = torch.sum(err5 * err5, dim=-1) / n
            e3n2 = torch.sum(err3 * err3, dim=-1) / n
            denom = e5n2 + 0.01 * e3n2
            pos = denom > 0
            err_norm = torch.abs(h) * e5n2 / torch.sqrt(torch.where(pos, denom, 1.0))
            err_norm = torch.where(pos, err_norm, 0.0)

            accept = (err_norm <= 1.0) & ~done & ~failed

            factor = _SAFETY * torch.where(
                err_norm > 0, 1.0 / torch.sqrt(torch.sqrt(torch.sqrt(err_norm))), _MAX_FACTOR
            )
            factor = torch.clamp(factor, _MIN_FACTOR, _MAX_FACTOR)
            h_next = h * factor
            small = torch.abs(h_next) < h_min
            stalled = ~done & small
            h_next = torch.where(small, h_floor, h_next)

            t = torch.where(accept, t + h, t)
            y = torch.where(accept[..., None], y_new, y)
            h_cur = torch.where(done, h_cur, h_next)
            done = done | (accept & (torch.abs(t1 - t) < 1e-12))
            failed = failed | stalled
            steps = steps + accept.to(torch.int32)
            trips += 1

        status = torch.where(done, 0, 1).to(torch.int32)
        return Dop853Result(y, status, steps)
