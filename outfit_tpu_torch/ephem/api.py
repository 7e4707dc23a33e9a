"""Ephemeris facade: source resolution and batched heliocentric state queries.

Port of ``outfit_tpu/ephem/api.py``: the source strings
(``"analytic:builtin"``, ``"horizon:<name>"``, ``"naif:<name>"`` with a
local file; the port never downloads), ``_interp``, ``_sun``,
``_moon_embrel``, ``earth_ephemeris``, ``body_ephemeris`` and ``coverage``,
over tables from the analytic source, from a DE file, or handed over as
numpy arrays.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from outfit_tpu_torch.ephem.analytic import EMRAT, build_analytic_tables
from outfit_tpu_torch.ephem.bodies import Body
from outfit_tpu_torch.ephem.chebyshev import BodyTable, interpolate_body
from outfit_tpu_torch.errors import EphemerisBodyNotSupported, InvalidJPLStringFormat
from outfit_tpu_torch.utils.tensors import as_f64

#: default coverage for the analytic source (MJD): 1960-01-01 .. 2060-01-01
_ANALYTIC_SPAN = (36934.0, 73459.0)

#: NAIF (target, centre) segment of each body a DE SPK kernel carries
_NAIF_PAIRS = {
    Body.EMB: (3, 0),
    Body.SUN: (10, 0),
    Body.MOON: (301, 3),
    Body.EARTH: (399, 3),
    Body.MERCURY_BARY: (1, 0),
    Body.VENUS_BARY: (2, 0),
    Body.MARS_BARY: (4, 0),
    Body.JUPITER_BARY: (5, 0),
    Body.SATURN_BARY: (6, 0),
    Body.URANUS_BARY: (7, 0),
    Body.NEPTUNE_BARY: (8, 0),
    Body.PLUTO_BARY: (9, 0),
}


class JPLEphem:
    """Planetary ephemeris over Chebyshev tables.

    ``tables`` maps Body -> BodyTable (coefficients on one device).  Planet
    tables may be SSB-centered (DE files) or heliocentric (analytic source,
    no SUN table); queries return heliocentric states, subtracting the SUN
    table when present.
    """

    def __init__(
        self,
        tables="analytic:builtin",
        emrat: float = EMRAT,
        kind: str = "analytic",
        path: Optional[str] = None,
    ):
        """``tables``: a ``{Body: BodyTable}`` dict or a source string
        (``"analytic:builtin"``, ``"horizon:DE440"``, ``"naif:DE440"``),
        resolved by :meth:`new` with ``path``."""
        if isinstance(tables, str):
            resolved = JPLEphem.new(tables, path=path)
            tables, emrat, kind = resolved.tables, resolved.emrat, resolved.kind
        self.tables = tables
        self.emrat = float(emrat)
        self.kind = kind
        self._moved = {}  # device -> this ephemeris with its tables there

    @classmethod
    def new(cls, source: str = "analytic:builtin", path: Optional[str] = None) -> "JPLEphem":
        """Resolve an ephemeris source: ``"analytic:builtin"`` (the built-in
        analytic source) or ``"horizon:<name>"`` / ``"naif:<name>"``, read
        from ``path``, else from $OUTFIT_EPHEM_DIR, else from the OS cache
        path (:func:`outfit_tpu_torch.ephem.resolver.resolve_ephemeris_file`;
        a miss raises ``JPLFileNotFound``).  The tables are host tensors;
        :meth:`to` (which the fits call) copies them to a device."""
        scheme, _, name = source.partition(":")
        if scheme == "analytic":
            return cls.analytic()
        file_path = path or _resolve_local_file(scheme, name)
        if scheme == "horizon":
            from outfit_tpu_torch.ephem.horizon import HorizonEphemeris

            h = HorizonEphemeris(file_path)
            return cls(h.tables(), emrat=h.emrat, kind="horizon")
        if scheme == "naif":
            from outfit_tpu_torch.ephem.naif import NaifEphemeris

            n = NaifEphemeris(file_path)
            tables = {}
            for body, (t, c) in _NAIF_PAIRS.items():
                try:
                    tables[body] = n.segment_for(t, c).table
                except EphemerisBodyNotSupported:
                    pass
            return cls(tables, emrat=EMRAT, kind="naif")
        raise InvalidJPLStringFormat(
            f"unknown ephemeris source {source!r} (expected 'analytic:builtin', "
            f"'horizon:NAME' or 'naif:NAME')"
        )

    @classmethod
    def analytic(cls, t_start: float = _ANALYTIC_SPAN[0], t_end: float = _ANALYTIC_SPAN[1]) -> "JPLEphem":
        """Built-in analytic source: the JAX package's numpy fit, so the
        tables are bit-identical to ``outfit_tpu``'s."""
        return cls(build_analytic_tables(t_start, t_end), kind="analytic")

    @classmethod
    def from_jax_tables(cls, tables, emrat: float = EMRAT, kind: str = "analytic") -> "JPLEphem":
        """From ``{body: (t0, granule_days, coeffs ndarray (G, 3, C))}``, e.g.
        the JAX package's ``JPLEphem.tables`` converted to numpy, so both
        packages compute from the same coefficients."""
        return cls(
            {
                Body(int(b)): BodyTable(
                    float(t0), float(gran),
                    torch.from_numpy(np.ascontiguousarray(c, dtype=np.float64).copy()),
                )
                for b, (t0, gran, c) in tables.items()
            },
            emrat=emrat,
            kind=kind,
        )

    @property
    def coverage(self):
        """(first, last) MJD that every table covers."""
        t0 = max(t.t0 for t in self.tables.values())
        t1 = min(t.t_end for t in self.tables.values())
        return t0, t1

    @property
    def device(self) -> torch.device:
        """The device of the tables."""
        return next(iter(self.tables.values())).coeffs.device

    def to(self, device) -> "JPLEphem":
        """The same ephemeris with its tables on ``device``: uploaded on the
        first call for a device and kept, so a fit or a propagation that
        moves a host ephemeris to the card on every call uploads once."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            # a tensor's device carries its index: "cuda" is "cuda:<current>"
            device = torch.device("cuda", torch.cuda.current_device())
        if all(t.coeffs.device == device for t in self.tables.values()):
            return self
        moved = self._moved.get(device)
        if moved is None:
            moved = self._moved[device] = JPLEphem(
                {b: t.to(device) for b, t in self.tables.items()}, self.emrat, self.kind
            )
        return moved

    # -- queries (batched) ----------------------------------------------------

    def _interp(self, body: Body, mjd_tt, velocity=True):
        return interpolate_body(self.tables[body], mjd_tt, velocity)

    def _sun(self, mjd_tt, velocity=True):
        if Body.SUN in self.tables:
            return self._interp(Body.SUN, mjd_tt, velocity)
        return 0.0, (0.0 if velocity else None)

    def _moon_embrel(self, mjd_tt, velocity=True):
        """Moon state relative to the EMB: a NAIF segment (301 rel 3) is
        already Moon-rel-EMB; Horizon / analytic tables store the geocentric
        Moon (moon_rel_emb = moon_geo * (1 - f), f = 1/(1+EMRAT))."""
        moon_p, moon_v = self._interp(Body.MOON, mjd_tt, velocity)
        if self.kind == "naif":
            return moon_p, moon_v
        s = 1.0 - 1.0 / (1.0 + self.emrat)
        return moon_p * s, (moon_v * s if velocity else None)

    def earth_ephemeris(self, mjd_tt, velocity: bool = True):
        """True-Earth heliocentric state, equatorial J2000 (AU, AU/day):
        Earth = EMB - Moon/(1+EMRAT), minus Sun."""
        emb_p, emb_v = self._interp(Body.EMB, mjd_tt, velocity)
        sun_p, sun_v = self._sun(mjd_tt, velocity)
        if Body.EARTH in self.tables:  # NAIF Earth-rel-EMB segment
            off_p, off_v = self._interp(Body.EARTH, mjd_tt, velocity)
            pos = emb_p + off_p - sun_p
            vel = emb_v + off_v - sun_v if velocity else None
        else:
            moon_p, moon_v = self._moon_embrel(mjd_tt, velocity)
            pos = emb_p - moon_p / self.emrat - sun_p
            vel = emb_v - moon_v / self.emrat - sun_v if velocity else None
        return pos, vel

    def body_ephemeris(self, body: Body, mjd_tt):
        """Heliocentric state of a perturbing body (AU, AU/day), equatorial
        J2000: zeros for the Sun, EMB for the Earth-Moon barycenter, the
        true bodies for ``Body.EARTH`` and ``Body.MOON``."""
        body = Body(body)
        if body == Body.SUN:
            t = as_f64(mjd_tt, self.device)
            z = torch.zeros(t.shape + (3,), dtype=torch.float64, device=t.device)
            return z, z
        if body == Body.EARTH:
            return self.earth_ephemeris(mjd_tt, True)
        if body == Body.MOON:
            # heliocentric Moon = EMB + moon_rel_emb
            sun_p, sun_v = self._sun(mjd_tt, True)
            emb_p, emb_v = self._interp(Body.EMB, mjd_tt, True)
            moon_p, moon_v = self._moon_embrel(mjd_tt, True)
            return emb_p + moon_p - sun_p, emb_v + moon_v - sun_v
        pos, vel = self._interp(body, mjd_tt, True)
        if Body.SUN not in self.tables:  # heliocentric tables: minus 0.0
            return pos, vel
        sun_p, sun_v = self._sun(mjd_tt, True)
        return pos - sun_p, vel - sun_v


def _resolve_local_file(scheme: str, name: str) -> str:
    """Find a local ephemeris binary: $OUTFIT_EPHEM_DIR candidates first
    (``<dir>/<scheme>/<file>`` or ``<dir>/<file>``), then the OS cache path
    of :func:`outfit_tpu_torch.ephem.resolver.resolve_ephemeris_file`."""
    base = os.environ.get("OUTFIT_EPHEM_DIR", os.path.expanduser("~/.cache/outfit_tpu"))
    candidates = {
        ("horizon", "DE440"): ["linux_p1550p2650.440", "de440.bin", "DE440.bsp"],
        ("naif", "DE440"): ["de440.bsp", "de440s.bsp"],
    }.get((scheme, name), [name])
    for c in candidates:
        for p in (os.path.join(base, scheme, c), os.path.join(base, c)):
            if os.path.exists(p):
                return p
    from outfit_tpu_torch.ephem.resolver import resolve_ephemeris_file

    return resolve_ephemeris_file(f"{scheme}:{name}")
