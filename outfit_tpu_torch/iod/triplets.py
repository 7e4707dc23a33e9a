# Source: outfit_tpu/iod/triplets.py (numpy helpers copied; the device enumerator
# _enum_device ported to torch).
"""Triplet generation, scoring, and RMS-window selection.

Parity with ``src/initial_orbit_determination/triplet_generation/``:

* ``downsample_uniform_with_edges`` (index_generator.rs:66-75),
* feasible windows dt_min <= t_k - t_i <= dt_max with i < j < k
  (index_generator.rs:94-260),
* spacing weight s(dt) = dtw/dt if dt <= dtw else 1 + dt/dtw summed over
  both gaps (mod.rs:148-274), best-K selection (mod.rs:365-408),

and ``select_rms_interval`` (trajectory.rs:294-350).
"""

from typing import List, Tuple

import numpy as np
import torch


def downsample_uniform_with_edges(n: int, max_keep: int) -> np.ndarray:
    if n == 0:
        return np.empty(0, dtype=np.int64)
    if max_keep >= n:
        return np.arange(n)
    if max_keep <= 3:
        return np.array([0, n // 2, n - 1])
    i = np.arange(max_keep)
    return i * (n - 1) // (max_keep - 1)


def triplet_weight(t1, t2, t3, dtw: float):
    """float64 spacing weight: s(dt) = dtw/dt if dt <= dtw else 1 + dt/dtw
    (mod.rs:148-274) summed over both gaps, one division per gap."""
    inv_dtw = 1.0 / dtw

    def s_gap(dt):
        return np.where(dt <= dtw, dtw / np.maximum(dt, 1e-300), 1.0 + dt * inv_dtw)

    return s_gap(t2 - t1) + s_gap(t3 - t2)


#: tiny f32 floor guarding the s_gap division (1e-300 underflows in f32)
_W32_TINY = np.float32(1e-38)

#: finite cap keeping feasible weights strictly below the +inf infeasible
#: sentinel (a zero intra-triplet gap would overflow f32 to +inf)
_W32_CAP = np.float32(3.0e38)


def triplet_weight32(t1, t2, t3, dtw: float):
    """float32 selection weight: the quantized ordering key shared bitwise
    by the numpy and device enumerators.  Gaps are computed in f64 and
    rounded once; every later operation is f32."""
    dtw32 = np.float32(dtw)
    inv32 = np.float32(1.0 / dtw)
    one32 = np.float32(1.0)

    def s_gap(dt64):
        g = np.asarray(dt64, np.float64).astype(np.float32)
        return np.where(g <= dtw32, dtw32 / np.maximum(g, _W32_TINY), one32 + g * inv32)

    with np.errstate(over="ignore"):  # zero-gap overflow is clamped below
        w = (s_gap(t2 - t1) + s_gap(t3 - t2)).astype(np.float32)
    return np.minimum(w, _W32_CAP)


def generate_triplet_indices(
    epochs: np.ndarray,
    dt_min: float,
    dt_max: float,
    optimal_interval: float,
    max_obs: int,
    max_triplets: int,
) -> List[Tuple[int, int, int]]:
    """Best-K spacing-weighted feasible triplets (indices into the sorted
    ``epochs``, before downsampling), in ascending (w32, a, j, k) order."""
    n = len(epochs)
    keep = downsample_uniform_with_edges(n, max_obs)
    t = epochs[keep]
    m = len(t)
    if m < 3:
        return []
    a, j, k = np.meshgrid(np.arange(m), np.arange(m), np.arange(m), indexing="ij", sparse=True)
    span = t[k] - t[a]
    feasible = (a < j) & (j < k) & (span >= dt_min) & (span <= dt_max)
    ai, ji, ki = np.nonzero(feasible)
    if ai.size == 0:
        return []
    w = triplet_weight32(t[ai], t[ji], t[ki], optimal_interval)
    order = np.argsort(w.view(np.int32), kind="stable")[:max_triplets]
    ka, kj, kk = keep[ai[order]], keep[ji[order]], keep[ki[order]]
    return [(int(x), int(y), int(z)) for x, y, z in zip(ka, kj, kk)]


def generate_triplet_indices_batch(
    epochs_pad: np.ndarray,
    counts: np.ndarray,
    dt_min: float,
    dt_max: float,
    optimal_interval: float,
    max_obs: int,
    max_triplets: int,
    budget: int = 32_000_000,
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized :func:`generate_triplet_indices` over many trajectories:
    ``epochs_pad`` (T, n_max) sorted epochs, ``counts`` the valid lengths.
    Returns ``(trips (T, max_triplets, 3), ktrips (T,))``; ``budget`` caps
    the (chunk x combination) working set."""
    counts = np.asarray(counts, np.int64)
    T = counts.shape[0]
    trips = np.zeros((T, max_triplets, 3), np.int64)
    ktrips = np.zeros(T, np.int64)
    if T == 0:
        return trips, ktrips

    m_eff = np.where(counts <= max_obs, counts, 3 if max_obs <= 3 else max_obs)
    m_eff = np.minimum(m_eff, counts)
    m_cap = int(m_eff.max(initial=0))
    if m_cap < 3:
        return trips, ktrips

    i = np.arange(m_cap)
    nm1 = np.maximum(counts - 1, 0)[:, None]
    down = i[None, :] * nm1 // np.maximum(m_eff - 1, 1)[:, None]
    keep = np.where(counts[:, None] <= max_obs, np.minimum(i, nm1), down)
    if max_obs <= 3:
        special = np.stack([np.zeros(T, np.int64), counts // 2, nm1[:, 0]], axis=1)
        keep = np.where((counts[:, None] > max_obs), special[:, :m_cap], keep)
    keep = np.minimum(keep, nm1)

    td = np.take_along_axis(epochs_pad, np.minimum(keep, epochs_pad.shape[1] - 1), axis=1)

    a, j, k = np.meshgrid(
        np.arange(m_cap), np.arange(m_cap), np.arange(m_cap), indexing="ij", sparse=True
    )
    ai, ji, ki = np.nonzero((a < j) & (j < k))
    M = ai.size
    if M == 0:
        return trips, ktrips

    chunk = max(1, int(budget // max(M, 1)))
    for lo in range(0, T, chunk):
        sl = slice(lo, min(lo + chunk, T))
        tdc = td[sl]
        t1, t2, t3 = tdc[:, ai], tdc[:, ji], tdc[:, ki]
        span = t3 - t1
        feas = (ki[None, :] < m_eff[sl, None]) & (span >= dt_min) & (span <= dt_max)
        w = triplet_weight32(t1, t2, t3, optimal_interval)
        w = np.where(feas, w, np.float32(np.inf)).astype(np.float32)
        order = np.argsort(w.view(np.int32), axis=1, kind="stable")[:, :max_triplets]
        kc = np.minimum(feas.sum(axis=1), max_triplets)
        kp = keep[sl]
        pad_k = order.shape[1]
        if pad_k < max_triplets:
            order = np.pad(order, ((0, 0), (0, max_triplets - pad_k)))
        trips[sl, :, 0] = np.take_along_axis(kp, ai[order], axis=1)
        trips[sl, :, 1] = np.take_along_axis(kp, ji[order], axis=1)
        trips[sl, :, 2] = np.take_along_axis(kp, ki[order], axis=1)
        ktrips[sl] = kc
    return trips, ktrips


def generate_triplet_indices_device(
    epochs_pad, counts, dt_min: float, dt_max: float, optimal_interval: float, max_obs: int, max_triplets: int,
    m_cap: int = None,
):
    """:func:`generate_triplet_indices_batch` on the device of
    ``epochs_pad`` (T, n_max) with ``counts`` (T,) (numpy arrays are taken
    on the CPU): the same best-K set in the same order.  Returns (trips
    (T, K, 3), ktrips (T,)), int64 on that device."""
    epochs_pad = torch.as_tensor(epochs_pad, dtype=torch.float64)
    return _enum_device(
        epochs_pad,
        torch.as_tensor(counts, device=epochs_pad.device),
        dt_min=float(dt_min),
        dt_max=float(dt_max),
        dtw=float(optimal_interval),
        max_obs=int(max_obs),
        max_triplets=int(max_triplets),
        m_cap=None if m_cap is None else int(m_cap),
    )


def _enum_device(
    epochs_pad, counts, *, dt_min, dt_max, dtw, max_obs, max_triplets, m_cap=None,
    budget: int = 1 << 24,
):
    """Device triplet enumeration: for each row of ``epochs_pad`` (T, n_max)
    with ``counts`` (T,) valid epochs, the best ``max_triplets`` feasible
    triplets as local observation indices, ``(trips (T, K, 3) int64,
    ktrips (T,) int64)``.

    Same order as the JAX enumerator: ascending int32 bit pattern of the
    f32-quantised weight (monotonic for the non-negative weights and +inf),
    ties broken by the lower combination column, which is the (a, j, k)
    lexicographic order.  Here one ``topk`` of the exact int64 key
    ``(bits << 32) | column`` gives that order (keys are unique).  Entries
    past ``ktrips`` are the next (infeasible) columns in the same order and
    zeros past ``C(m_cap, 3)``, as the JAX argmin passes give them.  Rows
    are processed in chunks of at most ``budget`` grid entries, so a wide
    ``max_obs`` does not exhaust device memory.
    """
    T, n_max = epochs_pad.shape
    dev = epochs_pad.device
    cap = n_max if m_cap is None else min(m_cap, n_max)
    m_cap = min(cap, 3 if max_obs <= 3 else max_obs)
    trips = torch.zeros((T, max_triplets, 3), dtype=torch.int64, device=dev)
    if m_cap < 3:
        return trips, torch.zeros(T, dtype=torch.int64, device=dev)
    a, j, k = np.meshgrid(np.arange(m_cap), np.arange(m_cap), np.arange(m_cap), indexing="ij", sparse=True)
    combo = [torch.as_tensor(c, device=dev) for c in np.nonzero((a < j) & (j < k))]
    ai, ji, ki = combo
    C = ai.numel()
    k_eff = min(max_triplets, C)

    counts = counts.to(torch.int64)
    m_eff = torch.where(counts <= max_obs, counts, 3 if max_obs <= 3 else max_obs)
    m_eff = torch.minimum(m_eff, counts)
    i = torch.arange(m_cap, device=dev)
    nm1 = torch.clamp(counts - 1, min=0)[:, None]
    down = torch.div(i[None, :] * nm1, torch.clamp(m_eff - 1, min=1)[:, None], rounding_mode="floor")
    keep = torch.where(counts[:, None] <= max_obs, torch.minimum(i[None, :], nm1), down)
    if max_obs <= 3:
        special = torch.stack([torch.zeros_like(counts), counts // 2, nm1[:, 0]], dim=1)
        keep = torch.where(counts[:, None] > max_obs, special[:, :m_cap], keep)
    keep = torch.minimum(keep, nm1)
    td = torch.gather(epochs_pad, 1, torch.clamp(keep, max=n_max - 1))

    ktrips = torch.zeros(T, dtype=torch.int64, device=dev)
    dtw32 = torch.tensor(np.float32(dtw), device=dev)
    inv32 = torch.tensor(np.float32(1.0 / dtw), device=dev)
    one32 = torch.tensor(np.float32(1.0), device=dev)
    tiny32 = torch.tensor(_W32_TINY, device=dev)
    cap32 = torch.tensor(_W32_CAP, device=dev)
    inf32 = torch.tensor(np.float32(np.inf), device=dev)

    def s_gap(dt64):
        g = dt64.to(torch.float32)
        return torch.where(g <= dtw32, dtw32 / torch.maximum(g, tiny32), one32 + g * inv32)

    chunk = max(1, budget // C)
    for lo in range(0, T, chunk):
        sl = slice(lo, min(lo + chunk, T))
        tdc = td[sl]
        t1, t2, t3 = tdc[:, ai], tdc[:, ji], tdc[:, ki]
        span = t3 - t1
        feas = (ki[None, :] < m_eff[sl, None]) & (span >= dt_min) & (span <= dt_max)
        w32 = torch.minimum(s_gap(t2 - t1) + s_gap(t3 - t2), cap32)
        w32 = torch.where(feas, w32, inf32)
        key = (w32.view(torch.int32).to(torch.int64) << 32) | torch.arange(C, device=dev)
        sel = torch.topk(key, k_eff, dim=1, largest=False, sorted=True).indices
        kp = keep[sl]
        for c, idx in enumerate(combo):
            trips[sl, :k_eff, c] = torch.gather(kp, 1, idx[sel])
        ktrips[sl] = torch.clamp(feas.sum(dim=1), max=max_triplets)
    return trips, ktrips


def select_rms_interval(epochs: np.ndarray, idx1: int, idx3: int, extf: float, dtmax: float) -> Tuple[int, int]:
    """RMS-window [start, end] (inclusive) around a triplet: extf x the
    triplet span, or 10 x the full arc when extf < 0, floored at dtmax."""
    w0, w1 = select_rms_interval_batch(epochs, np.asarray([idx1]), np.asarray([idx3]), extf, dtmax)
    return int(w0[0]), int(w1[0])


def select_rms_interval_batch(
    epochs: np.ndarray, idx1: np.ndarray, idx3: np.ndarray, extf: float, dtmax: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized :func:`select_rms_interval` over many triplets at once."""
    epochs = np.asarray(epochs)
    idx1 = np.asarray(idx1)
    idx3 = np.asarray(idx3)
    if extf >= 0.0:
        dt = (epochs[idx3] - epochs[idx1]) * extf
    else:
        dt = np.full(idx1.shape, 10.0 * (epochs[-1] - epochs[0]))
    if dtmax >= 0.0:
        dt = np.maximum(dt, dtmax)
    i_start = np.searchsorted(epochs, epochs[idx1] - dt, side="left")
    i_end = np.searchsorted(epochs, epochs[idx3] + dt, side="right") - 1
    return i_start, np.maximum(i_end, idx3)
