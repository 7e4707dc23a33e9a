# Source: outfit_tpu/observations/debias.py (copied; imports retargeted to this package).
"""Star-catalog astrometric debiasing (Eggl/Farnocchia et al. 2020 tables).

The reference consumes per-observation astrometric biases through
``ObsFitData.bias_ra/bias_dec`` (obs_fit_data.rs:29-116) — the residuals
are computed against the DEBIASED observation
(single_iteration.rs:196-207) — but ships no table loader ("set 0.0
unless a catalogue or night-block debiasing step has produced non-zero
values").  This module is that debiasing step for the published
MPC-standard tables: "Star catalog position and proper motion
corrections in asteroid astrometry II" (Eggl, Farnocchia, Chamberlin &
Chesley 2020, Icarus 339), distributed by JPL/MPC as ``bias.dat`` inside
``debias_2018.tgz`` (and the earlier ``debias.tgz`` of
Farnocchia et al. 2015).

Table format (one file, plain text):

* comment lines start with ``!``; one names the HEALPix resolution
  (``... NSIDE= 64 ...``) and the LAST comment line lists the MPC
  catalog codes of the column blocks in order (single-character codes,
  MPC 80-col column 72 convention: ``a`` USNO-A1.0 ... ``t`` Tycho-2,
  ``U`` Gaia-DR1, ``V`` Gaia-DR2, ...);
* then ``12*nside^2`` data rows (HEALPix RING pixel order), each with
  4 numbers per catalog: Δα* = Δα·cosδ [arcsec], Δδ [arcsec],
  μα* [mas/yr], μδ [mas/yr] — the bias of that catalog's reference
  stars inside that sky pixel relative to Gaia.

Bias of one observation at epoch t (Julian years):

    Δα*(t) = Δα* + μα*·(t − J2000)/1000     [arcsec]
    Δδ(t)  = Δδ  + μδ ·(t − J2000)/1000     [arcsec]

converted to radians (the RA bias divided by cosδ: the dataset stores
true RA offsets, the table stores great-circle ones) and attached with
:meth:`ObsDataset.set_bias`.  Catalogs absent from the table (including
the Gaia catalogs the table is anchored to, when absent) contribute
zero bias — matching the published recommendation.

The loader never fetches: pass a path, or point ``$OUTFIT_DEBIAS`` at a
local copy of the published table.

This is host-side dataset preparation (numpy, once per dataset); the
correction consumes the resulting bias columns as tensors
(``lsq/iteration.py`` residuals).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from outfit_tpu_torch.constants import RADSEC

__all__ = ["DebiasTable", "ang2pix_ring"]

#: MJD (TT) of the J2000.0 reference epoch of the proper-motion terms
_MJD_J2000 = 51544.5


def ang2pix_ring(nside: int, ra, dec):
    """HEALPix RING-scheme pixel index for equatorial directions.

    Vectorized numpy implementation of the standard HEALPix ang2pix
    algorithm (Górski et al. 2005, ApJ 622, 759) — healpy is not a
    dependency.  ``ra``/``dec`` in radians; returns int64 indices in
    ``[0, 12*nside^2)``.  Self-consistency (pixel-center round trip,
    cap/belt boundaries, equal-area occupancy) is pinned by
    the JAX package's tests (test_observations.py::TestHealpix).
    """
    ra = np.asarray(ra, np.float64)
    dec = np.asarray(dec, np.float64)
    z = np.sin(dec)
    phi = np.mod(ra, 2.0 * np.pi)
    za = np.abs(z)
    tt = phi * (2.0 / np.pi)  # in [0, 4)

    # --- equatorial belt (|z| <= 2/3) ------------------------------------
    temp1 = nside * (0.5 + tt)
    temp2 = nside * (z * 0.75)
    jp = np.floor(temp1 - temp2).astype(np.int64)  # ascending-edge line
    jm = np.floor(temp1 + temp2).astype(np.int64)  # descending-edge line
    ir_eq = nside + 1 + jp - jm  # ring counter (1 .. 2*nside+1)
    kshift = 1 - (ir_eq & 1)
    ip_eq = (jp + jm - nside + kshift + 1) // 2
    ip_eq = np.mod(ip_eq, 4 * nside)
    pix_eq = 2 * nside * (nside - 1) + (ir_eq - 1) * 4 * nside + ip_eq

    # --- polar caps (|z| > 2/3) ------------------------------------------
    tp = tt - np.floor(tt)
    tmp = nside * np.sqrt(np.maximum(3.0 * (1.0 - za), 0.0))
    jp_c = np.floor(tp * tmp).astype(np.int64)
    jm_c = np.floor((1.0 - tp) * tmp).astype(np.int64)
    ir_c = jp_c + jm_c + 1  # ring from the pole (1 .. nside)
    ir_c = np.minimum(ir_c, nside)  # guard the |z|=2/3 float boundary
    ip_c = np.floor(tt * ir_c).astype(np.int64)
    ip_c = np.mod(ip_c, 4 * ir_c)
    pix_north = 2 * ir_c * (ir_c - 1) + ip_c
    pix_south = 12 * nside * nside - 2 * ir_c * (ir_c + 1) + ip_c
    pix_cap = np.where(z > 0, pix_north, pix_south)

    return np.where(za <= 2.0 / 3.0, pix_eq, pix_cap)


@dataclass
class DebiasTable:
    """Loaded star-catalog debiasing table (see module docstring)."""

    nside: int
    catalogs: List[str]  # column-block order
    dra: np.ndarray  # (npix, ncat) Δα·cosδ [arcsec]
    ddec: np.ndarray  # (npix, ncat) [arcsec]
    pmra: np.ndarray  # (npix, ncat) μα·cosδ [mas/yr]
    pmdec: np.ndarray  # (npix, ncat) [mas/yr]

    @property
    def npix(self) -> int:
        return 12 * self.nside * self.nside

    @classmethod
    def load(cls, path: Optional[str] = None) -> "DebiasTable":
        """Load a ``bias.dat``-format table from ``path`` or
        ``$OUTFIT_DEBIAS``.  Raises ``FileNotFoundError`` when neither
        resolves (callers wanting opportunistic behavior should check
        the env var themselves)."""
        if path is None:
            path = os.environ.get("OUTFIT_DEBIAS")
        if not path or not os.path.exists(path):
            raise FileNotFoundError(
                "no debiasing table: pass a path or set $OUTFIT_DEBIAS to "
                "a local copy of the published bias.dat (Eggl et al. 2020)"
            )
        nside = 64
        catalogs: Optional[List[str]] = None
        data_lines = []
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                s = line.strip()
                if not s:
                    continue
                if s.startswith(("!", "#")):
                    body = s.lstrip("!#").strip()
                    # FIRST integer after NSIDE= only: real headers carry
                    # trailing digits ("NSIDE= 64 (49152 pixels)")
                    m = re.search(r"NSIDE\s*=\s*(\d+)", body, re.IGNORECASE)
                    if m:
                        nside = int(m.group(1))
                    toks = body.split()
                    if (
                        len(toks) >= 2
                        and all(len(t) == 1 and t.isalpha() for t in toks)
                    ):
                        # the catalog-code column listing (last such line
                        # wins; MPC catalog codes are single LETTERS, so
                        # numeric ruler/flag comments never match)
                        catalogs = toks
                    continue
                data_lines.append(s)
        if catalogs is None:
            raise ValueError(
                f"{path}: no catalog-code header line found (expected a "
                "comment line listing single-character MPC catalog codes)"
            )
        npix = 12 * nside * nside
        flat = np.array(" ".join(data_lines).split(), np.float64)
        ncat = len(catalogs)
        if flat.size != npix * 4 * ncat:
            raise ValueError(
                f"{path}: expected {npix} rows x {4 * ncat} values "
                f"(NSIDE={nside}, {ncat} catalogs), got {flat.size} values"
            )
        grid = flat.reshape(npix, ncat, 4)
        return cls(
            nside=nside,
            catalogs=catalogs,
            dra=np.ascontiguousarray(grid[:, :, 0]),
            ddec=np.ascontiguousarray(grid[:, :, 1]),
            pmra=np.ascontiguousarray(grid[:, :, 2]),
            pmdec=np.ascontiguousarray(grid[:, :, 3]),
        )

    def bias_radians(self, ra, dec, mjd_tt, catalog):
        """Per-observation ``(bias_ra, bias_dec)`` in radians (true-RA
        offsets, i.e. the Δα·cosδ table values divided by cosδ).
        ``catalog`` is the per-observation MPC code array; codes absent
        from the table (or blank) get zero bias."""
        ra = np.asarray(ra, np.float64)
        dec = np.asarray(dec, np.float64)
        mjd_tt = np.asarray(mjd_tt, np.float64)
        cat = np.asarray(catalog, dtype="U1")
        col = np.full(ra.shape, -1, np.int64)
        for j, code in enumerate(self.catalogs):
            col[cat == code] = j
        known = col >= 0
        pix = ang2pix_ring(self.nside, ra, dec)
        jcol = np.where(known, col, 0)
        t_yr = (mjd_tt - _MJD_J2000) / 365.25
        dra = self.dra[pix, jcol] + self.pmra[pix, jcol] * (t_yr / 1000.0)
        ddec = self.ddec[pix, jcol] + self.pmdec[pix, jcol] * (t_yr / 1000.0)
        cosd = np.maximum(np.cos(dec), 1e-9)
        bias_ra = np.where(known, dra * RADSEC / cosd, 0.0)
        bias_dec = np.where(known, ddec * RADSEC, 0.0)
        return bias_ra, bias_dec

    def apply(self, dataset) -> "object":
        """Compute and attach the biases for every observation of an
        :class:`~outfit_tpu_torch.observations.dataset.ObsDataset` (requires
        its per-observation ``catalog`` column, present for MPC/ADES
        ingests).  Returns the dataset for chaining."""
        if len(dataset.catalog) != len(dataset.mjd_tt):
            raise ValueError(
                "dataset has no per-observation catalog codes; debiasing "
                "is keyed on MPC catalog (80-col column 72 / ADES astCat)"
            )
        bias_ra, bias_dec = self.bias_radians(
            dataset.ra, dataset.dec, dataset.mjd_tt, dataset.catalog
        )
        return dataset.set_bias(bias_ra, bias_dec)
