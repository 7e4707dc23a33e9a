"""User-facing IOD API: Gauss initial orbit determination over a dataset.

Port of ``outfit_tpu/iod/api.py`` (both precisions).  Parity with the
reference's ``FitIOD`` trait (``obs_dataset_api.rs``) and
``estimate_best_orbit`` (``trajectory.rs:429-545``):

* prepare: error model -> batch RMS correction -> observer cache,
* per trajectory: the best ``max_triplets`` spacing-weighted triplets
  (enumerated on the device), each in ``1 + n_noise_realizations``
  Monte-Carlo lanes with deterministic per-trajectory noise
  (:mod:`outfit_tpu_torch.iod.noise`),
* Gauss candidates per lane, RMS scoring over the triplet's window, the
  per-lane best candidate (corrected first, then min RMS) and the
  per-trajectory best lane (min RMS, lowest lane on ties).

Every trajectory's lanes form one dense (trajectory x triplet x
realization) batch on ``device``; ``IODParams.batch_size`` splits it into
trajectory-aligned chunks of at most that many lanes.  ``device`` may name
several devices (the JAX package's ``mesh``): each fits a contiguous chunk
of the trajectories (:class:`_IodBatch`).  The JAX package's power-of-two
buckets, width groups, sync-free screen and fetch packing exist for XLA and
its relay and are left out: lanes are independent, so none of them changes
a result.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from outfit_tpu_torch import trace
from outfit_tpu_torch.constants import ROT_EQUMJ2000_TO_ECLMJ2000
from outfit_tpu_torch.elements.orb_elem import KIND_KEPLERIAN, ccek1
from outfit_tpu_torch.elements.types import (
    CometaryElements,
    EquinoctialElements,
    KeplerianElements,
    cometary_to_equinoctial,
    keplerian_to_equinoctial,
)
from outfit_tpu_torch.errors import NoFeasibleTriplets, NoViableOrbit
from outfit_tpu_torch.iod.gauss import GaussTriplets, candidates_to_elements, gauss_candidates, polish_selected
from outfit_tpu_torch.iod.noise import draw_noise, trajectory_keys
from outfit_tpu_torch.iod.params import IODParams
from outfit_tpu_torch.iod.scoring import rms_orbit_error
from outfit_tpu_torch.iod.triplets import _enum_device
from outfit_tpu_torch.observations.error_model import ErrorModel
from outfit_tpu_torch.observer.cache import ObserverCache
from outfit_tpu_torch.parallel.sharding import chunk_bounds, fit_devices, map_devices, split_bounds
from outfit_tpu_torch.time.scales import Ut1Provider
from outfit_tpu_torch.utils.linalg import rotate3
from outfit_tpu_torch.utils.tensors import resolve_device


@dataclass(slots=True)
class FitResult:
    """Per-trajectory IOD outcome (parity: FitOrbitResult::IODGauss)."""

    traj_id: str
    ok: bool
    error: Optional[str] = None
    rms: float = float("inf")
    corrected: bool = False
    epoch: float = 0.0
    kind: int = KIND_KEPLERIAN  # 0 = Keplerian, 1 = Cometary (ccek1 output)
    elements: Optional[np.ndarray] = None  # (6,) element set of ``kind``
    equinoctial: Optional[np.ndarray] = None  # (6,) a,h,k,p,q,lambda (ecliptic)

    @property
    def orbit_quality(self) -> float:
        """Scalar fit quality: the windowed IOD RMS (parity:
        ``FitOrbitResult::orbit_quality``, constants.rs:157-162)."""
        return self.rms

    @property
    def orbital_elements(self):
        """The ccek1 element set, Keplerian or Cometary per ``kind`` (parity:
        ``FitOrbitResult::orbital_elements``, constants.rs:169-174)."""
        if self.elements is None:
            return None
        cls = KeplerianElements if self.kind == KIND_KEPLERIAN else CometaryElements
        return cls(self.epoch, *self.elements[:6])

    @property
    def keplerian(self) -> Optional[KeplerianElements]:
        if self.elements is None or self.kind != KIND_KEPLERIAN:
            return None
        return KeplerianElements(self.epoch, *self.elements[:6])


def prepare_dataset(dataset, gap_max: float, error_model: Optional[ErrorModel]) -> None:
    """Apply ``error_model`` (then the batch RMS correction); datasets
    without sigmas get FCCT14."""
    if error_model is not None:
        dataset.apply_error_model(error_model)
        dataset.apply_batch_rms_correction(gap_max)
    if np.isnan(dataset.ra_error).any():
        dataset.apply_error_model(ErrorModel.fcct14())
        dataset.apply_batch_rms_correction(gap_max)


def _padded_layout(dataset):
    """``(valid, glob_idx)``, both (T_all, n_max): per trajectory (in
    ``traj_ids`` order) its observations' dataset rows, epoch-sorted and
    left-packed, and which slots are real.  One stable (trajectory, epoch)
    sort."""
    mjd, ti = dataset.mjd_tt, dataset.traj_index
    n = len(mjd)
    grouped = n == 0 or (
        (ti[1:] >= ti[:-1]).all() and ((mjd[1:] >= mjd[:-1]) | (ti[1:] != ti[:-1])).all()
    )
    order = np.arange(n) if grouped else np.lexsort((mjd, ti))
    ti_sorted = ti[order]
    counts = np.bincount(ti_sorted, minlength=dataset.n_trajectories)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(n) - starts[ti_sorted]
    n_max = int(counts.max(initial=1))
    valid = np.zeros((dataset.n_trajectories, n_max), dtype=bool)
    valid[ti_sorted, pos] = True
    glob_idx = np.zeros((dataset.n_trajectories, n_max), np.int64)
    glob_idx[ti_sorted, pos] = order
    return valid, glob_idx


def base_arrays(dataset, cache: ObserverCache, device):
    """Dataset-order observation columns on ``device``: (mjd, ra, dec,
    sigma_ra, sigma_dec, observer heliocentric position, bias_ra,
    bias_dec), the biases None when the dataset carries none."""
    f64 = dict(dtype=torch.float64, device=device)
    cols = (dataset.mjd_tt, dataset.ra, dataset.dec, dataset.ra_error, dataset.dec_error)
    bias = (dataset.bias_ra, dataset.bias_dec)
    return (
        tuple(torch.as_tensor(c, **f64) for c in cols)
        + (cache.helio_pos_pad.to(device),)
        + tuple(None if b is None else torch.as_tensor(b, **f64) for b in bias)
    )


def _gather_bias(base, glob_g, valid_g):
    """Padded per-trajectory bias tables (pad slots: 0), None where the
    dataset carries no bias.  The correction subtracts them; the IOD fits
    the observed (biased) angles, as the JAX package's does."""
    return tuple(None if b is None else torch.where(valid_g, b[glob_g], 0.0) for b in base[6:])


def _gather_obs_tables(base, glob_g, valid_g):
    """Padded per-trajectory observation tables (pad slots: 0 / sigma 1)."""
    mjd_b, ra_b, dec_b, sra_b, sdec_b, helio_b = base[:6]
    return (
        torch.where(valid_g, mjd_b[glob_g], 0.0),
        torch.where(valid_g, ra_b[glob_g], 0.0),
        torch.where(valid_g, dec_b[glob_g], 0.0),
        torch.where(valid_g, sra_b[glob_g], 1.0),
        torch.where(valid_g, sdec_b[glob_g], 1.0),
        torch.where(valid_g[..., None], helio_b[glob_g], 0.0),
    )


def _assemble_lanes(base, g3, z, tk_t, obs_mjd, valid_g, wlo_s, whi_s, params: IODParams):
    """(triplet x realization) lanes from per-triplet dataset-row indices
    ``g3`` (S, 3), draws ``z`` (S, n_real, 3, 2), trajectory row per triplet
    ``tk_t`` (S,) and RMS-window epoch bounds ``wlo_s``/``whi_s`` (S,).
    Returns (tri, lane_traj, window_mask)."""
    mjd_b, ra_b, dec_b, sra_b, sdec_b, helio_b = base[:6]
    n_real = params.n_noise_realizations + 1
    ns = params.noise_scale
    S = g3.shape[0]
    L = S * n_real
    lane_ra = (ra_b[g3][:, None, :] + z[..., 0] * sra_b[g3][:, None, :] * ns).reshape(L, 3)
    lane_dec = (dec_b[g3][:, None, :] + z[..., 1] * sdec_b[g3][:, None, :] * ns).reshape(L, 3)
    lane_t = torch.broadcast_to(mjd_b[g3][:, None, :], (S, n_real, 3)).reshape(L, 3)
    lane_pos = torch.broadcast_to(helio_b[g3][:, None, :, :], (S, n_real, 3, 3)).reshape(L, 3, 3)
    lane_traj = tk_t[:, None].expand(S, n_real).reshape(L)

    wmask_tri = (obs_mjd[tk_t] >= wlo_s[:, None]) & (obs_mjd[tk_t] <= whi_s[:, None]) & valid_g[tk_t]
    window_mask = wmask_tri[:, None, :].expand(S, n_real, wmask_tri.shape[1]).reshape(L, -1)
    return GaussTriplets(lane_ra, lane_dec, lane_t, lane_pos), lane_traj, window_mask


def _iod_kernel_dense(base, glob_g, valid_g, counts_g, z_g, trips, ktrips, params: IODParams):
    """IOD of one chunk as a dense (trajectory x max_triplets) lane grid.

    ``trips`` (Tb, K, 3) / ``ktrips`` (Tb,) come from the triplet
    enumerator; triplet slots past ``ktrips`` get an empty RMS window and
    score inf.  ``z_g``: the chunk's draws (Tb, K, n_real, 3, 2)."""
    K = params.max_triplets
    Tb = glob_g.shape[0]
    dev = glob_g.device
    obs_arrays = _gather_obs_tables(base, glob_g, valid_g)
    obs_mjd = obs_arrays[0]

    # RMS windows (select_rms_interval, epoch-interval form)
    te1 = torch.gather(obs_mjd, 1, trips[..., 0])  # (Tb, K)
    te3 = torch.gather(obs_mjd, 1, trips[..., 2])
    last = torch.clamp(counts_g - 1, min=0)[:, None]
    arc = torch.gather(obs_mjd, 1, last)[:, 0] - obs_mjd[:, 0]
    if params.extf >= 0.0:
        dt = (te3 - te1) * params.extf
    else:
        dt = 10.0 * arc[:, None] * torch.ones_like(te1)
    if params.dtmax >= 0.0:
        dt = torch.clamp(dt, min=params.dtmax)
    k_ok = torch.arange(K, device=dev)[None, :] < ktrips[:, None]
    wlo = torch.where(k_ok, te1 - dt, torch.inf)
    whi = torch.where(k_ok, te3 + dt, -torch.inf)

    S = Tb * K
    g_flat = torch.gather(glob_g, 1, trips.reshape(Tb, K * 3)).reshape(S, 3)
    tk_t = torch.arange(Tb, device=dev)[:, None].expand(Tb, K).reshape(S)
    z = z_g.reshape((S,) + z_g.shape[2:])
    tri, lane_traj, window_mask = _assemble_lanes(
        base, g_flat, z, tk_t, obs_mjd, valid_g, wlo.reshape(S), whi.reshape(S), params
    )
    return _iod_kernel(tri, obs_arrays, lane_traj, window_mask, params)


def _lane_select(rms, valid, corrected):
    """Per-lane candidate: corrected-preferred, then min RMS (first index on
    ties).  Parity: ``prelim_orbit`` (gauss.rs:1238-1247)."""
    finite = torch.isfinite(rms)
    corr_ok = corrected & valid & finite
    any_corr = torch.any(corr_ok, dim=-1, keepdim=True)
    eligible = torch.where(any_corr, corr_ok, valid & finite)
    score = torch.where(eligible, rms, torch.inf)
    best = torch.argmin(score, dim=-1)
    return best, torch.gather(score, -1, best[..., None])[..., 0]


def _to_equinoctial(kind, el, epoch):
    """Element-set-aware equinoctial conversion (Keplerian or hyperbolic
    Cometary) per lane.  Both branches are computed and selected by a
    ``where`` (the JAX package gates the cometary one behind a ``lax.cond``
    on a relevant cometary lane existing; Keplerian lanes are bitwise the
    same either way, cometary lanes within an ulp, and a Python ``if``
    here would cost a host sync)."""
    cols = el.unbind(-1)
    eq_k = keplerian_to_equinoctial(KeplerianElements(epoch, *cols))
    eq_c = cometary_to_equinoctial(CometaryElements(epoch, *cols))
    is_kep = kind == KIND_KEPLERIAN
    return EquinoctialElements(
        epoch,
        *(
            torch.where(is_kep, a, torch.where(torch.isfinite(b), b, 0.0))
            for a, b in zip(eq_k[1:], eq_c[1:])
        ),
    )


def _iod_kernel(tri: GaussTriplets, obs_arrays, lane_traj, window_mask, params: IODParams):
    """Candidates -> elements -> scores -> per-lane best -> per-trajectory
    best.  Returns per trajectory (rms, kind, elements, equinoctial vector,
    epoch, corrected).

    ``params.precision == "mixed"``: the roots, the f-g correction and the
    scoring run in float32 (the observer positions and angles are cast after
    the float64 observer cache; MJDs stay float64), the winner per
    trajectory is selected in float32, and :func:`polish_selected`, ccek1
    and a full-window rescore bring that one candidate back to float64."""
    mixed = params.precision == "mixed"
    cands = gauss_candidates(tri, params, work_dtype=torch.float32 if mixed else None)
    kind, el = candidates_to_elements(cands)  # (L, K), (L, K, 6)
    eq = _to_equinoctial(kind, el, cands.epoch)

    mjd, ra, dec, sra, sdec, helio = obs_arrays
    if mixed:
        ra, dec, sra, sdec, helio = (x.to(torch.float32) for x in (ra, dec, sra, sdec, helio))
    N = mjd.shape[1]
    S = int(params.selection_subsample)
    subsampled = 0 < S < N
    if subsampled:
        # selection-window subsample (see IODParams): a uniform-with-edges
        # pick over the contiguous window [wlo, wlo + cnt - 1]
        wlo = torch.argmax(window_mask.to(torch.uint8), dim=-1)  # (L,)
        cnt = torch.sum(window_mask, dim=-1)
        s_ar = torch.arange(S, device=mjd.device)[None, :]
        j = torch.where(
            cnt[:, None] <= S, s_ar,
            torch.div(s_ar * (cnt[:, None] - 1), S - 1, rounding_mode="floor"),
        )
        pos = wlo[:, None] + torch.minimum(j, torch.clamp(cnt[:, None] - 1, min=0))
        pos = torch.clamp(pos, max=N - 1)
        wmask = (s_ar < cnt[:, None])[:, None, :]

        def sub(x):
            return torch.gather(x[lane_traj], 1, pos)[:, None, :]

        obs_mjd, obs_ra, obs_dec, obs_sra, obs_sdec = (sub(x) for x in (mjd, ra, dec, sra, sdec))
        obs_helio = torch.gather(helio[lane_traj], 1, pos[..., None].expand(-1, -1, 3))[:, None]
    else:
        obs_mjd, obs_ra, obs_dec, obs_sra, obs_sdec = (
            x[lane_traj][:, None, :] for x in (mjd, ra, dec, sra, sdec)
        )
        obs_helio = helio[lane_traj][:, None, :, :]
        wmask = window_mask[:, None, :]

    rms = rms_orbit_error(eq, obs_mjd, obs_ra, obs_dec, obs_sra, obs_sdec, obs_helio, wmask)  # (L, K)
    best_cand, best_rms = _lane_select(rms, cands.valid, cands.corrected)

    # per-trajectory winner: segment argmin over the lane axis, lowest lane
    # index among equal scores
    L = best_rms.shape[0]
    T = mjd.shape[0]
    dev = best_rms.device
    seg_min = torch.full((T,), torch.inf, dtype=best_rms.dtype, device=dev).scatter_reduce(
        0, lane_traj, best_rms, "amin", include_self=True
    )
    is_best = torch.isfinite(best_rms) & (best_rms <= seg_min[lane_traj])
    lane_ids = torch.arange(L, device=dev)
    sel = torch.full((T,), L, dtype=torch.int64, device=dev).scatter_reduce(
        0, lane_traj, torch.where(is_best, lane_ids, L), "amin", include_self=True
    )
    has = sel < L  # the trajectory produced at least one finite-scored lane
    sel = torch.clamp(sel, max=L - 1)
    cand_sel = best_cand[sel]

    def gather(x):
        return x[sel, cand_sel]

    if mixed:
        ppos, pvel, pepoch, pcorr = polish_selected(
            GaussTriplets(*(f[sel] for f in tri)),
            *(gather(f) for f in (cands.r2, cands.pos, cands.vel, cands.epoch, cands.corrected,
                                  cands.chi1, cands.chi2)),
            params, params.polish_max_it,
        )
        kind64, el64 = ccek1(
            rotate3(ROT_EQUMJ2000_TO_ECLMJ2000, ppos[..., 1, :]), rotate3(ROT_EQUMJ2000_TO_ECLMJ2000, pvel)
        )
        eq64 = _to_equinoctial(kind64, el64, pepoch)
        rms64 = rms_orbit_error(eq64, *obs_arrays, window_mask[sel])
        best64 = torch.where(has & torch.isfinite(seg_min), rms64, torch.inf)
        return best64, kind64, el64, torch.stack(list(eq64[1:]), dim=-1), pepoch, pcorr & has

    rms_t = torch.where(has, seg_min, torch.inf)
    if subsampled:
        # the reported RMS is always full-window: rescore the winning lane
        eq_t = EquinoctialElements(*(gather(f) for f in eq))
        rms_full = rms_orbit_error(eq_t, mjd, ra, dec, sra, sdec, helio, window_mask[sel])
        rms_t = torch.where(has & torch.isfinite(rms_full), rms_full, torch.inf)
    eq_vec = torch.stack(list(eq[1:]), dim=-1)
    return (
        rms_t,
        gather(kind),
        gather(el),
        gather(eq_vec),
        gather(cands.epoch),
        gather(cands.corrected) & has,
    )


def _chunk_spans(n_traj: int, lanes_per_traj: int, batch_size: int):
    """Trajectory-aligned [start, end) chunks of at most ``batch_size``
    lanes (at least one trajectory each); one chunk when ``batch_size`` is 0."""
    if batch_size <= 0:
        return [(0, n_traj)]
    per = max(1, batch_size // lanes_per_traj)
    return [(s, min(s + per, n_traj)) for s in range(0, n_traj, per)]


class _IodBatch:
    """The IOD of one prepared dataset over a device list.  What sees the
    whole batch runs once here: the padded layout, the screen of
    unresolvable stations, the triplet enumeration (each device on a share
    of the rows; it is exact integer work) whose counts fix the kept rows,
    their lane chunks and the chunks' widths, and the chunks of the kept
    rows per device (:func:`chunk_bounds`).  :meth:`part` then fits one
    device's kept rows.  A row's lanes see the same chunk width, draws and
    alignment in their tensors on any split, so each row's result is the
    one a single device gives."""

    def __init__(self, dataset, params: IODParams, seed, layout, devices, draws=None, slim=False):
        self.dataset, self.params, self.seed, self.slim = dataset, params, seed, slim
        self.valid, self.glob = layout
        self.results: Dict[str, FitResult] = {}
        Tall = dataset.n_trajectories
        self.n_real = params.n_noise_realizations + 1

        def infeasible(arc, n_obs):
            return str(NoFeasibleTriplets(arc, n_obs, params.dt_min, params.dt_max_triplet))

        rows = np.zeros(0, np.int64)
        if len(dataset.mjd_tt) == 0 or Tall == 0:
            self.results = {tid: FitResult(tid, ok=False, error=infeasible(0.0, 0)) for tid in dataset.traj_ids}
        else:
            self.counts = self.valid.sum(axis=1)
            self.epochs_pad = np.where(self.valid, dataset.mjd_tt[self.glob], 0.0)
            arc = np.where(
                self.counts > 0,
                self.epochs_pad[np.arange(Tall), np.maximum(self.counts - 1, 0)] - self.epochs_pad[:, 0], 0.0,
            )
            # trajectories observed from an unresolvable station are errors,
            # not silently geocentric fits
            unk = np.fromiter((o.unknown for o in dataset.observers), bool, count=len(dataset.observers))
            bad_traj = np.zeros(Tall, bool)
            if unk.any():
                bad_obs = unk[dataset.observer_index]
                bad_traj = np.bincount(dataset.traj_index[bad_obs], minlength=Tall).astype(bool)
                for t in np.nonzero(bad_traj)[0]:
                    sel = (dataset.traj_index == t) & bad_obs
                    codes = sorted({dataset.observers[i].code or "?" for i in np.unique(dataset.observer_index[sel])})
                    tid = dataset.traj_ids[t]
                    self.results[tid] = FitResult(tid, ok=False, error=f"UnknownObservatory({', '.join(codes)})")
            rows = np.nonzero(~bad_traj)[0]

        # --- triplet enumeration, each device on a share of the rows --------
        shares = [rows[a:b] for a, b in split_bounds(rows.size, len(devices))]
        enum = map_devices(devices, self._enumerate, shares)
        kt = np.concatenate([k for _, _, k in enum])
        for t in rows[kt == 0]:
            tid = dataset.traj_ids[t]
            self.results[tid] = FitResult(tid, ok=False, error=infeasible(arc[t], int(self.counts[t])))
        self.kept = rows[kt > 0]
        self.kt = kt[kt > 0]
        # each share's (trips, ktrips) of its kept rows, on its device, and
        # where its rows start in the kept rows
        self.trips, starts = [], [0]
        for trips, ktrips, k in enum:
            if (k > 0).any():
                sel = torch.as_tensor(np.nonzero(k > 0)[0], device=trips.device)
                self.trips.append((trips[sel], ktrips[sel]))
                starts.append(starts[-1] + sel.numel())
        self.trips_start = starts
        # trajectory-aligned chunks of the kept rows, each at its own width
        # (left-packed: the longest row of the chunk)
        self.spans = [
            (s, e, int(self.counts[self.kept[s:e]].max()))
            for s, e in _chunk_spans(self.kept.size, params.max_triplets * self.n_real, params.batch_size)
        ] if self.kept.size else []
        self.chunks = chunk_bounds([(s, e) for s, e, _ in self.spans], len(devices))
        # Monte-Carlo draws: fixed shape (max_triplets, n_real, 3, 2) per
        # trajectory, the first ktrips rows used
        self.z = None
        if draws is not None and self.kept.size:
            self.z = np.asarray(draws([dataset.traj_ids[t] for t in self.kept]))

    def _enumerate(self, device, rows):
        if not rows.size:
            return None, None, np.zeros(0, np.int64)
        p = self.params
        trips, ktrips = _enum_device(
            torch.as_tensor(self.epochs_pad[rows], dtype=torch.float64, device=device),
            torch.as_tensor(self.counts[rows], dtype=torch.int64, device=device),
            dt_min=p.dt_min,
            dt_max=p.dt_max_triplet,
            dtw=p.optimal_interval_time,
            max_obs=p.max_obs_for_triplets,
            max_triplets=p.max_triplets,
        )
        return trips, ktrips, trace.sites.iod_enumerate.cpu(ktrips).numpy()

    def _kept_trips(self, ka, kb, device):
        """(trips, ktrips) of kept rows [ka, kb) on ``device``."""
        parts = []
        for (trips, ktrips), s, e in zip(self.trips, self.trips_start[:-1], self.trips_start[1:]):
            lo, hi = max(ka, s), min(kb, e)
            if lo < hi:
                parts.append((trips[lo - s:hi - s].to(device), ktrips[lo - s:hi - s].to(device)))
        if len(parts) == 1:
            return parts[0]
        return tuple(torch.cat(x) for x in zip(*parts))

    def part(self, device, i, base) -> Dict[str, FitResult]:
        """The results of device ``i``'s chunk of the kept rows, fitted on
        ``device``; ``base()`` gives :func:`base_arrays` there."""
        ka, kb = self.chunks[i]
        if ka >= kb:
            return {}
        i64 = dict(dtype=torch.int64, device=device)
        kept, kt = self.kept[ka:kb], self.kt[ka:kb]
        trips, ktrips = self._kept_trips(ka, kb, device)
        kept_tids = [self.dataset.traj_ids[t] for t in kept]
        if self.z is None:
            keys = torch.as_tensor(trajectory_keys(self.seed, kept_tids), **i64)
            z = draw_noise(keys, self.params.max_triplets, self.n_real)
        else:
            z = torch.as_tensor(self.z[ka:kb], dtype=torch.float64, device=device)

        outs = []
        for s, e, w in self.spans:
            lo, hi = max(s, ka) - ka, min(e, kb) - ka
            if lo >= hi:
                continue
            out = _iod_kernel_dense(
                base(),
                torch.as_tensor(self.glob[kept[lo:hi], :w], **i64),
                torch.as_tensor(self.valid[kept[lo:hi], :w], device=device),
                torch.as_tensor(self.counts[kept[lo:hi]], **i64),
                z[lo:hi],
                trips[lo:hi],
                ktrips[lo:hi],
                self.params,
            )
            if self.slim:
                out = (out[0].float(), out[1], out[2].float()) + tuple(out[3:])
            outs.append([trace.sites.iod_copyback.cpu(o).numpy() for o in out])
        rms, kind, el, eqv, epoch, corrected = (np.concatenate(c) for c in zip(*outs))
        rms, el = rms.astype(np.float64, copy=False), el.astype(np.float64, copy=False)

        results = {}
        finite_l = np.isfinite(rms).tolist()
        rms_l, corr_l, epoch_l, kind_l = rms.tolist(), corrected.tolist(), epoch.tolist(), kind.tolist()
        for j, tid in enumerate(kept_tids):
            if not finite_l[j]:
                results[tid] = FitResult(tid, ok=False, error=str(NoViableOrbit(int(kt[j]) * self.n_real)))
                continue
            results[tid] = FitResult(
                tid, ok=True, rms=rms_l[j], corrected=bool(corr_l[j]), epoch=epoch_l[j],
                kind=kind_l[j], elements=el[j], equinoctial=eqv[j],
            )
        return results

    def fit(self, devices, bases):
        """Every row's result, in dataset order: the kept rows fitted on
        ``devices`` (``bases(device)`` gives :func:`base_arrays` there)."""
        with trace.span("iod"):
            for part in map_devices(devices, lambda d, i: self.part(d, i, lambda: bases(d)), range(len(devices))):
                self.results.update(part)
            return {tid: self.results[tid] for tid in self.dataset.traj_ids}


def device_bases(dataset, cache):
    """``bases(device)``: :func:`base_arrays` of ``dataset`` on a device,
    uploaded once per device by whichever worker first asks."""
    made, lock = {}, threading.Lock()

    def bases(device):
        with lock:
            if device not in made:
                with trace.span("fit.prepare"):
                    made[device] = base_arrays(dataset, cache, device)
            return made[device]

    return bases


def _fit_full_iod(
    dataset, ephem, params, seed, ut1, error_model, cache, device, draws=None, slim=False,
) -> Dict[str, FitResult]:
    """:func:`fit_full_iod`, with ``draws`` optionally in place of the
    port's own noise generator: ``draws(kept_traj_ids)`` returns their
    (T, max_triplets, n_real, 3, 2) normals (the tests pass the JAX
    package's draws through it).  ``slim``: the RMS and the native-kind
    elements cross to the host as float32 (reporting grade; the
    equinoctial seed and the epoch stay float64), the JAX package's
    ``slim_fetch`` contract."""
    params = params.validated()
    devices = fit_devices(device)
    prepare_dataset(dataset, params.gap_max, error_model)
    if cache is None:
        cache = ObserverCache.build(dataset, ephem, ut1, device=devices[0])
    batch = _IodBatch(dataset, params, seed, _padded_layout(dataset), devices, draws, slim)
    return batch.fit(devices, device_bases(dataset, cache))


def fit_full_iod(
    dataset,
    ephem,
    params: IODParams = IODParams(),
    seed: int = 0,
    ut1: Optional[Ut1Provider] = None,
    error_model: Optional[ErrorModel] = None,
    cache: Optional[ObserverCache] = None,
    device=None,
) -> Dict[str, FitResult]:
    """Batch Gauss IOD over every trajectory of the dataset, in dataset order.

    Parity: ``fit_full_iod`` (obs_dataset_api.rs:145-172).  ``seed`` and the
    trajectory id fix each trajectory's Monte-Carlo noise, so results do
    not depend on the dataset's other trajectories, their order, or
    ``params.batch_size``.  ``device``: one device; a list of devices
    (names may repeat), each fitting a contiguous chunk of the trajectories
    in a worker thread of its own, the observer cache built once on the
    first, every result bitwise the single-device one; ``"auto"``, every
    visible CUDA card; None, ``"auto"`` when a card is present, else the
    CPU.  The parameters are the JAX package's, in its order, with
    ``device`` last in place of ``mesh``.
    """
    return _fit_full_iod(dataset, ephem, params, seed, ut1, error_model, cache, device)


def _fit_full_iod_stream(datasets, ephem, params, seed, ut1, error_model, device, draws=None):
    return ((ds, _fit_full_iod(ds, ephem, params, seed, ut1, error_model, None, device, draws)) for ds in datasets)


def fit_full_iod_stream(
    datasets,
    ephem,
    params: IODParams = IODParams(),
    seed: int = 0,
    ut1: Optional[Ut1Provider] = None,
    error_model: Optional[ErrorModel] = None,
    depth: int = 2,
    prefetch: bool = True,
    device=None,
):
    """IOD over a stream of datasets; yields ``(dataset, results)`` in input
    order, each dataset fitted when the caller asks for it.  Each dataset's
    results are exactly :func:`fit_full_iod`'s.  ``depth`` and
    ``prefetch`` are accepted and have no effect (see
    :func:`outfit_tpu_torch.lsq.api.fit_lsq_stream`)."""
    return _fit_full_iod_stream(datasets, ephem, params, seed, ut1, error_model, device)


def fit_full_iod_parallel(*args, **kwargs) -> Dict[str, FitResult]:
    """Alias of :func:`fit_full_iod` (parity: ``fit_full_iod_parallel``,
    obs_dataset_api.rs:174-207): the batched device kernel is the parallel
    path, and per-trajectory seeding makes results schedule-independent."""
    return fit_full_iod(*args, **kwargs)


def fit_iod(
    observations,
    ephem,
    params: IODParams = IODParams(),
    seed: int = 0,
    ut1=None,
    traj_id: str = "TRAJ",
    error_model=None,
    device=None,
) -> FitResult:
    """Single-trajectory IOD (parity: ``FitIOD::fit_iod``,
    obs_dataset_api.rs:41-127): a list of observation records (``mjd_tt``,
    ``ra``, ``dec``, ``ra_error``, ``dec_error``, ``observer``), or an
    ObsDataset and ``traj_id``."""
    from outfit_tpu_torch.observations.dataset import ObsDataset

    if isinstance(observations, ObsDataset):
        ds = observations.subset(observations.trajectory_obs_indices(traj_id))
    else:
        ds = ObsDataset()
        for o in observations:
            ds.push_observation(traj_id, o.mjd_tt, o.ra, o.dec, o.ra_error, o.dec_error, o.observer)
    return fit_full_iod(
        ds, ephem, params, seed=seed, ut1=ut1, error_model=error_model, device=resolve_device(device)
    )[traj_id]


#: Reference-name aliases (constants.rs:134-195, gauss_result.rs:98-216):
#: ``FitResult`` carries the Gauss outcome and is the value of the result map.
GaussResult = FitResult
FullOrbitResult = Dict[str, FitResult]
IODRMS = float
