"""Bulk ephemeris generation over whole fit-result sets, as one batch.

Port of ``outfit_tpu/ephemeris/batch.py``: when every trajectory shares one
request grid (the survey case: same observers, same epochs), the orbit
rows are stacked and all of them evaluated in one ``compute_apparent``
call over a ``(n_orbits, n_pairs)`` batch on the device, returning columnar
arrays.  ``compute_ephemerides_for_results`` (api.py) remains the
per-trajectory path.

Rows whose fit failed, whose orbit is non-elliptic, or whose observer is
unknown ride along as masked lanes (benign elements, ``ok=False``), so one
bad row never aborts the batch: the same errors-as-data posture as the
fits.

The JAX package pads (n_orbits, n_pairs) to power-of-two buckets to bound
its recompiles; PyTorch runs eagerly, so the batch here has the exact
shape.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from outfit_tpu_torch.elements.types import EquinoctialElements
from outfit_tpu_torch.ephemeris.api import EphemerisValue, _request_pairs
from outfit_tpu_torch.ephemeris.compute import ApparentPosition, BodyGeometry, compute_apparent
from outfit_tpu_torch.ephemeris.request import Combined, EphemerisRequest, Geometry, Position
from outfit_tpu_torch.ephemeris.result import EphemerisEntry, EphemerisResult
from outfit_tpu_torch.errors import InvalidOrbit
from outfit_tpu_torch.time.scales import Ut1Provider
from outfit_tpu_torch.utils.tensors import resolve_device

__all__ = ["EphemerisTable", "compute_ephemerides_batch"]

#: position/geometry column names, in NamedTuple field order
_POS_FIELDS = ("ra", "dec", "geocentric_distance", "heliocentric_distance")
_GEOM_FIELDS = (
    "phase_angle", "solar_elongation", "radial_velocity", "d_ra_dt",
    "d_dec_dt",
)


@dataclass
class EphemerisTable:
    """Columnar bulk-ephemeris results: every array is
    ``(n_trajectories, n_pairs)`` in (dataset order) x (request pair
    order).  ``result(tid)`` materializes one row as the
    ``EphemerisResult`` the per-orbit API returns; ``to_dataframe()`` is
    the survey-scale hand-off."""

    traj_ids: List[str]
    #: flattened request pairs, column order of every array
    epochs: np.ndarray  # (P,)
    observers: list  # (P,) Observer per pair
    ra: np.ndarray  # (T, P) radians
    dec: np.ndarray
    geocentric_distance: np.ndarray  # AU
    heliocentric_distance: np.ndarray
    phase_angle: np.ndarray  # radians
    solar_elongation: np.ndarray
    radial_velocity: np.ndarray  # AU/day
    d_ra_dt: np.ndarray  # radians/day
    d_dec_dt: np.ndarray
    ok: np.ndarray  # (T, P) bool
    #: per-trajectory error string for rows that never ran (failed fit /
    #: non-elliptic orbit); propagation failures are per-entry ``ok=False``
    row_errors: Dict[str, str] = field(default_factory=dict)
    #: per-pair unknown-observatory flag (those columns are errors on
    #: every row)
    unknown_observer: Optional[np.ndarray] = None
    #: the request's output kind (Position/Geometry/Combined), used by
    #: ``result`` materialization
    output: str = Combined
    #: lazily built {traj_id: row} map; never set directly
    _tid_index: Optional[Dict[str, int]] = field(
        default=None, repr=False, compare=False
    )

    def __len__(self) -> int:
        return len(self.traj_ids)

    @property
    def n_pairs(self) -> int:
        return len(self.epochs)

    def result(self, traj_id) -> EphemerisResult:
        """Materialize one row as the per-orbit API's EphemerisResult."""
        # O(1) through a lazily built id->row map: a list.index per lookup
        # would make a per-orbit loop over a survey catalog O(T^2)
        if self._tid_index is None:
            self._tid_index = {t: k for k, t in enumerate(self.traj_ids)}
        try:
            i = self._tid_index[traj_id]
        except KeyError:
            raise KeyError(traj_id) from None
        err = self.row_errors.get(traj_id)
        entries = []
        for j in range(self.n_pairs):
            o, t = self.observers[j], float(self.epochs[j])
            if err is not None:
                entries.append(EphemerisEntry(t, o, error=err))
            elif self.unknown_observer is not None and self.unknown_observer[j]:
                entries.append(
                    EphemerisEntry(t, o, error=f"UnknownObservatory({o.code})")
                )
            elif self.ok[i, j]:
                pos = ApparentPosition(
                    *(float(getattr(self, f)[i, j]) for f in _POS_FIELDS)
                )
                geom = BodyGeometry(
                    *(float(getattr(self, f)[i, j]) for f in _GEOM_FIELDS)
                )
                if self.output == Position:
                    val = pos
                elif self.output == Geometry:
                    val = geom
                else:
                    val = EphemerisValue(pos, geom)
                entries.append(EphemerisEntry(t, o, value=val))
            else:
                entries.append(
                    EphemerisEntry(
                        t, o, error="PropagationFailed or non-finite result"
                    )
                )
        return EphemerisResult(entries)

    def __getitem__(self, traj_id) -> EphemerisResult:
        return self.result(traj_id)

    def to_dataframe(self):
        """Long-format pandas DataFrame: one row per (trajectory, pair),
        scalar columns (traj_id, epoch, observer code, ok, every
        position/geometry field)."""
        import pandas as pd

        T, P = self.ok.shape
        codes = np.array(
            [getattr(o, "code", "") or "" for o in self.observers], object
        )
        data = {
            "traj_id": np.repeat(np.asarray(self.traj_ids, object), P),
            "epoch": np.tile(self.epochs, T),
            "observer": np.tile(codes, T),
            "ok": self.ok.ravel(),
        }
        for f in _POS_FIELDS + _GEOM_FIELDS:
            data[f] = getattr(self, f).ravel()
        return pd.DataFrame(data)


def _run_batch(config, ephem, ep_rows, eq_rows, epochs, obs_pos, obs_vel, device):
    """``compute_apparent`` over the (T orbits, P pairs) grid on ``device``.

    ``ep_rows`` (T,), ``eq_rows`` (T, 6) and ``epochs`` (P,) are host
    arrays; ``obs_pos``/``obs_vel`` (P, 3) tensors on ``device``.  Returns
    numpy ``(position, geometry, ok)``, each field (T, P); the nine fields
    cross to the host in one copy and ``ok`` in another."""
    f64 = dict(dtype=torch.float64, device=device)
    ep = torch.as_tensor(ep_rows, **f64)
    eqc = torch.as_tensor(eq_rows, **f64)
    T, P = ep.shape[0], len(epochs)
    eqb = EquinoctialElements(ep[:, None], *(eqc[:, j, None] for j in range(6)))
    out = compute_apparent(
        eqb,
        torch.as_tensor(epochs, **f64)[None, :].expand(T, P),
        obs_pos[None, :, :],
        obs_vel[None, :, :],
        propagator=config.propagator,
        aberration=config.aberration,
        ephem=ephem,
    )
    cols = torch.stack([*out.position, *out.geometry]).cpu().numpy()
    n_pos = len(_POS_FIELDS)
    return ApparentPosition(*cols[:n_pos]), BodyGeometry(*cols[n_pos:]), out.ok.cpu().numpy()


def _raw_elements_error(tid, what):
    return TypeError(
        f"results[{tid!r}]: raw-elements entry must be "
        f"(epoch, equinoctial_vector), got {what}"
    )


def compute_ephemerides_batch(
    results,
    request: EphemerisRequest,
    ephem,
    ut1: Optional[Ut1Provider] = None,
    device=None,
) -> EphemerisTable:
    """Bulk ephemeris generation as one batch on the device (module doc).

    ``results``: a ``{traj_id: LsqResult}`` map (the ``fit_lsq`` return),
    an :class:`~outfit_tpu_torch.lsq.table.LsqTable` (consumed column-wise,
    no per-row materialization), or a
    ``{traj_id: (epoch, equinoctial_vector)}`` map of raw elements.
    Every trajectory is evaluated on the same request grid.  ``device``:
    default ``"cuda"`` when a card is present, else ``"cpu"``.
    """
    if ut1 is None:
        ut1 = Ut1Provider()

    # ---- collect orbit rows (columnar fast path for LsqTable) -----------
    row_errors: Dict[str, str] = {}
    if hasattr(results, "traj_ids") and hasattr(results, "equinoctial"):
        tids = list(results.traj_ids)
        eq_rows = np.asarray(results.equinoctial, np.float64).copy()
        ep_rows = np.asarray(results.epoch, np.float64).copy()
        fit_ok = np.asarray(results.ok, bool).copy()
        for i in np.flatnonzero(~fit_ok):
            row_errors[tids[i]] = f"fit failed: {results.result(tids[i]).error}"
    else:
        tids, eqs, eps, oks = [], [], [], []
        for tid, r in results.items():
            tids.append(tid)
            # raw elements: any 2-sequence (epoch, equinoctial_vector):
            # tuple, list, or array pair
            if isinstance(r, (tuple, list)) or (
                isinstance(r, np.ndarray) and r.dtype == object
            ):
                if isinstance(r, np.ndarray) and r.ndim == 0:
                    raise _raw_elements_error(tid, "an unsized object array")
                if len(r) != 2:
                    raise _raw_elements_error(tid, f"length {len(r)}")
                ep_i, eq_i = r
                eqs.append(np.asarray(eq_i, np.float64))
                eps.append(float(ep_i))
                oks.append(True)
            elif not hasattr(r, "ok"):
                raise TypeError(
                    f"results[{tid!r}]: expected an LsqResult-like object "
                    "(with .ok/.equinoctial/.epoch) or a raw "
                    f"(epoch, equinoctial_vector) pair, got {type(r).__name__}"
                )
            elif getattr(r, "ok", False) and getattr(r, "equinoctial", None) is not None:
                eqs.append(np.asarray(r.equinoctial, np.float64))
                eps.append(float(r.epoch))
                oks.append(True)
            else:
                eqs.append(np.full(6, np.nan))
                eps.append(0.0)
                oks.append(False)
                row_errors[tid] = f"fit failed: {getattr(r, 'error', '?')}"
        eq_rows = np.asarray(eqs).reshape(len(tids), 6)
        ep_rows = np.asarray(eps)
        fit_ok = np.asarray(oks, bool)

    T = len(tids)

    # non-elliptic precheck, vectorized (mod.rs:223 parity).  A NaN
    # eccentricity is not flagged here: the per-orbit API's `ecc >= 1.0`
    # passes NaN through to the core, which reports PropagationFailed, and
    # the batch must classify identically.  Runs before the observer-state
    # device work so an all-dead batch does none
    with np.errstate(invalid="ignore"):
        ecc = np.hypot(eq_rows[:, 1], eq_rows[:, 2])
        bad_e = fit_ok & (ecc >= 1.0)
    for i in np.flatnonzero(bad_e):
        row_errors[tids[i]] = str(
            InvalidOrbit(f"InvalidOrbit(e={ecc[i]:.3f} >= 1)")
        )
    live = fit_ok & ~bad_e
    any_live = bool(live.any())
    output = getattr(request, "output", Combined)

    if any_live:
        device = resolve_device(device)
    flat = _request_pairs(request, ephem, ut1, with_states=any_live, device=device)
    if flat is None or T == 0:
        return EphemerisTable(
            traj_ids=tids, epochs=np.empty(0), observers=[],
            **{f: np.zeros((T, 0)) for f in _POS_FIELDS + _GEOM_FIELDS},
            ok=np.zeros((T, 0), bool), row_errors=row_errors,
            unknown_observer=np.zeros(0, bool), output=output,
        )
    pairs, epochs, obs_pos, obs_vel, unknown = flat
    P = len(pairs)

    if not any_live:
        # every row is a failed fit / non-elliptic orbit: all entries are
        # errors, so no orbit evaluation and no observer states (values
        # are unspecified where ok=False; NaN is the honest fill)
        return EphemerisTable(
            traj_ids=tids, epochs=epochs, observers=[o for o, _ in pairs],
            **{f: np.full((T, P), np.nan)
               for f in _POS_FIELDS + _GEOM_FIELDS},
            ok=np.zeros((T, P), bool), row_errors=row_errors,
            unknown_observer=unknown, output=output,
        )

    # dead lanes ride along on a benign circular orbit; live rows keep
    # their values verbatim (including NaN) for per-orbit parity
    benign = np.array([2.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    eq_safe = np.where(live[:, None], eq_rows, benign)
    ep_safe = np.where(live, ep_rows, 57000.0)

    pos, geom, ok_k = _run_batch(
        request.config, ephem, ep_safe, eq_safe, epochs, obs_pos, obs_vel, device
    )

    ok = ok_k & live[:, None] & ~unknown[None, :]
    cols = {f: getattr(pos, f) for f in _POS_FIELDS}
    cols.update({f: getattr(geom, f) for f in _GEOM_FIELDS})
    return EphemerisTable(
        traj_ids=tids,
        epochs=epochs,
        observers=[o for o, _ in pairs],
        **cols,
        ok=ok,
        row_errors=row_errors,
        unknown_observer=unknown,
        output=output,
    )
