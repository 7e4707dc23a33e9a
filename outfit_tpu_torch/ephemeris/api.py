"""Ephemeris generation entry point.

Port of ``outfit_tpu/ephemeris/api.py`` (parity: ``OrbitalElements::compute``,
``src/ephemeris/mod.rs:189-290``): convert to equinoctial once, e >= 1
precheck short-circuits every entry, per-observer fixed vectors, per-epoch
computation with errors collected per entry (never aborting).  All
(observer, epoch) pairs of a request are evaluated as one batch on the
device.
"""

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from outfit_tpu_torch.elements.types import EquinoctialElements, KeplerianElements, keplerian_to_equinoctial
from outfit_tpu_torch.ephemeris.compute import ApparentPosition, BodyGeometry
from outfit_tpu_torch.ephemeris.request import Combined, EphemerisRequest, Geometry, Position
from outfit_tpu_torch.ephemeris.result import EphemerisEntry, EphemerisResult
from outfit_tpu_torch.errors import InvalidOrbit
from outfit_tpu_torch.observer.geometry import (
    earth_fixed_position,
    earth_fixed_velocity,
    gast,
    helio_state,
    pvobs,
)
from outfit_tpu_torch.time.scales import Ut1Provider
from outfit_tpu_torch.utils.tensors import as_f64, resolve_device


@dataclass
class EphemerisValue:
    """Combined output value (Position + Geometry views)."""

    position: ApparentPosition
    geometry: BodyGeometry


def _request_pairs(request: EphemerisRequest, ephem, ut1, with_states=True, device=None):
    """Flatten a request into (observer, epoch) pairs + the observers'
    heliocentric states, tensors on ``device``.  The observer-fixed vectors
    are computed once per observer entry and broadcast over its epochs.
    Returns ``None`` for an empty request, else
    ``(pairs, epochs, obs_pos, obs_vel, unknown)``.

    ``with_states=False`` skips the observer-state device work (gast /
    pvobs / heliocentric states) and returns ``None`` states, for callers
    that only need the pair grid (every fit in a batch failed, so all
    entries are errors and no orbit will be evaluated)."""
    pairs = []
    fp_rows, fv_rows = [], []
    for entry in request.entries:
        o = entry.observer
        eps = list(entry.mode.epochs)
        if not eps:
            continue
        pairs.extend((o, t) for t in eps)
        if not with_states:
            continue
        fp_rows.append(np.broadcast_to(earth_fixed_position(o), (len(eps), 3)))
        fv_rows.append(np.broadcast_to(earth_fixed_velocity(o), (len(eps), 3)))
    if not pairs:
        return None

    # unknown observatory codes carry geocenter placeholder coordinates:
    # per-entry error, never a silent geocenter
    unknown = np.array([bool(getattr(o, "unknown", False)) for o, _ in pairs])

    epochs = np.array([t for _, t in pairs])
    if not with_states:
        return pairs, epochs, None, None, unknown
    device = resolve_device(device)
    f64 = dict(dtype=torch.float64, device=device)
    epochs_t = torch.as_tensor(epochs, **f64)
    geo_pos, geo_vel = pvobs(
        epochs_t,
        torch.as_tensor(np.concatenate(fp_rows, axis=0), **f64),
        torch.as_tensor(np.concatenate(fv_rows, axis=0), **f64),
        gast(epochs, ut1, device),
    )
    # one Earth-ephemeris evaluation serves position and velocity
    obs_pos, obs_vel = helio_state(ephem.to(device), epochs_t, geo_pos, geo_vel)
    return pairs, epochs, obs_pos, obs_vel, unknown


def _error_entries(request, error):
    return EphemerisResult(
        [EphemerisEntry(t, e.observer, error=error) for e in request.entries for t in e.mode.epochs]
    )


def compute_ephemeris(
    elements: Union[EquinoctialElements, KeplerianElements],
    request: EphemerisRequest,
    ephem,
    ut1: Optional[Ut1Provider] = None,
    _flat=None,
    device=None,
) -> EphemerisResult:
    """Compute apparent positions + geometry for every (observer, epoch).

    ``_flat``: precomputed :func:`_request_pairs` output (on ``device``): the
    bulk per-orbit loop shares one request's observer states across orbits.
    ``device``: where the batch runs; default ``"cuda"`` when a card is
    present, else ``"cpu"``."""
    if isinstance(elements, KeplerianElements):
        eq = keplerian_to_equinoctial(KeplerianElements(*(as_f64(f) for f in elements)))
    else:
        eq = elements
    if ut1 is None:
        ut1 = Ut1Provider()

    # precheck (mod.rs:223): non-elliptic orbits error every entry, before
    # the observer-state device work, which would be discarded
    ecc = float(np.hypot(float(eq.h), float(eq.k)))
    if ecc >= 1.0:
        return _error_entries(request, str(InvalidOrbit(f"InvalidOrbit(e={ecc:.3f} >= 1)")))

    device = resolve_device(device)
    flat = _request_pairs(request, ephem, ut1, device=device) if _flat is None else _flat
    if flat is None:
        return EphemerisResult([])
    pairs, epochs, obs_pos, obs_vel, unknown = flat

    from outfit_tpu_torch.ephemeris.batch import _run_batch

    ep1 = np.asarray([float(eq.reference_epoch)])
    eq1 = np.asarray(
        [[float(f) for f in (eq.semi_major_axis, eq.h, eq.k, eq.p, eq.q, eq.mean_longitude)]]
    )
    pos1, geom1, ok1 = _run_batch(request.config, ephem, ep1, eq1, epochs, obs_pos, obs_vel, device)

    # numpy already: the fields crossed to the host once, not once per entry
    ok = ok1[0]
    pos_np = [f[0] for f in pos1]
    geom_np = [f[0] for f in geom1]
    kind = getattr(request, "output", Combined)
    entries = []
    for i, (o, t) in enumerate(pairs):
        if unknown[i]:
            # same text the fit pipelines emit
            entries.append(EphemerisEntry(t, o, error=f"UnknownObservatory({o.code})"))
        elif ok[i]:
            if kind == Position:
                val = ApparentPosition(*[float(f[i]) for f in pos_np])
            elif kind == Geometry:
                val = BodyGeometry(*[float(f[i]) for f in geom_np])
            else:
                val = EphemerisValue(
                    ApparentPosition(*[float(f[i]) for f in pos_np]),
                    BodyGeometry(*[float(f[i]) for f in geom_np]),
                )
            entries.append(EphemerisEntry(t, o, value=val))
        else:
            entries.append(EphemerisEntry(t, o, error="PropagationFailed or non-finite result"))
    return EphemerisResult(entries)


def compute_ephemerides_for_results(
    results,
    request: EphemerisRequest,
    ephem,
    ut1: Optional[Ut1Provider] = None,
    device=None,
):
    """Bulk ephemeris generation over a fit-result map: one
    EphemerisResult per trajectory id; failed fits yield all-error entries
    (parity: ``FullOrbitResultExt``, ``src/ephemeris/batch.rs:73``).  For
    survey-scale catalogs prefer
    :func:`outfit_tpu_torch.ephemeris.batch.compute_ephemerides_batch` (one
    batch for all orbits).
    """
    if ut1 is None:
        ut1 = Ut1Provider()
    device = resolve_device(device)
    # the request's observer states do not depend on the orbit: computed
    # once, and not at all when every fit failed
    any_ok = any(
        getattr(r, "ok", False) and getattr(r, "equinoctial", None) is not None
        for r in results.values()
    )
    flat = _request_pairs(request, ephem, ut1, device=device) if any_ok else None
    out = {}
    for tid, r in results.items():
        eqv = getattr(r, "equinoctial", None)
        if not getattr(r, "ok", False) or eqv is None:
            out[tid] = _error_entries(request, f"fit failed: {getattr(r, 'error', '?')}")
            continue
        eq = EquinoctialElements(
            *(torch.as_tensor(x, dtype=torch.float64) for x in (r.epoch, *np.asarray(eqv)))
        )
        out[tid] = compute_ephemeris(eq, request, ephem, ut1, _flat=flat, device=device)
    return out


#: Reference-name alias (``FullOrbitResultExt::compute_ephemerides``,
#: batch.rs:73): the bulk-over-results entry point.
FullOrbitResultExt = compute_ephemerides_for_results
