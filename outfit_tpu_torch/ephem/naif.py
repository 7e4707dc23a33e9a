# Source: outfit_tpu/ephem/naif.py (tables as native, contiguous, owned float64 tensors).
"""Parser for NAIF DAF/SPK ephemeris files (SPK data types 2 and 3).

DAF layout (1024-byte records):
  record 1: LOCIDW(8) 'DAF/SPK ', ND i32, NI i32, LOCIFN(60),
            FWARD i32, BWARD i32, FREE i32, LOCFMT(8) ('LTL-IEEE'/'BIG-IEEE')
  summary records: control f64x3 (NEXT, PREV, NSUM) then NSUM summaries of
            ND f64 + NI i32 (packed into (NI+1)//2 f64 words)
  SPK summary: ND=2 -> (et_start, et_end); NI=6 -> (target, center, frame,
            type, addr_initial, addr_final)  [addresses are 1-based f64 words]
  Type 2 segment: N records of RSIZE = 2 + 3*ncoeff  (MID, RADIUS, x, y, z
            coeffs), then trailer INIT, INTLEN, RSIZE, N (4 f64)
  Type 3: RSIZE = 2 + 6*ncoeff (position + velocity coefficient sets).

Output: per-(target, center) granule-uniform BodyTables in AU with epochs in
MJD (TDB).  Each table is a native-byte-order, contiguous float64 tensor
that owns its memory, whatever the file's byte order: the CUDA kernel takes
contiguous tensors only.  Type-3 velocity coefficient sets are parsed into
``vel_table``; interpolation differentiates the position polynomials (one
code path for both types).
"""

import numpy as np
import torch

from outfit_tpu_torch.constants import AU
from outfit_tpu_torch.ephem.chebyshev import BodyTable
from outfit_tpu_torch.errors import (
    EphemerisBodyNotSupported,
    InvalidJPLEphemFileVersion,
    InvalidSpkDataType,
)

_J2000_MJD = 51544.5  # ET epoch J2000 in MJD (TDB)


def owned_table(t0, granule_days, coeffs) -> BodyTable:
    """A BodyTable over a native-order, contiguous float64 copy of
    ``coeffs`` (a file's arrays may be big-endian or read-only views)."""
    c = np.array(coeffs, dtype=np.float64, order="C", copy=True)
    return BodyTable(float(t0), float(granule_days), torch.from_numpy(c))


class SpkSegment:
    def __init__(self, target, center, frame, dtype, et_start, et_end, table, vel_table=None):
        self.target = int(target)
        self.center = int(center)
        self.frame = int(frame)
        self.data_type = int(dtype)
        self.et_start = float(et_start)
        self.et_end = float(et_end)
        self.table = table  # BodyTable (MJD TDB epochs, AU)
        self.vel_table = vel_table  # Type-3 only: explicit velocity sets (AU/day)


class NaifEphemeris:
    """Parsed DAF/SPK file: list of segments, lookup by (target, center)."""

    def __init__(self, path: str):
        with open(path, "rb") as fh:
            raw = fh.read()

        locidw = raw[0:8].decode("ascii", "replace")
        if not locidw.startswith("DAF"):
            raise InvalidJPLEphemFileVersion(f"not a DAF file: id word {locidw!r}")
        locfmt = raw[88:96].decode("ascii", "replace")
        self._end = "<" if "LTL" in locfmt else ">"
        e = self._end
        self.nd = int(np.frombuffer(raw, e + "i4", 1, 8)[0])
        self.ni = int(np.frombuffer(raw, e + "i4", 1, 12)[0])
        fward = int(np.frombuffer(raw, e + "i4", 1, 76)[0])

        if self.nd != 2 or self.ni != 6:
            raise InvalidJPLEphemFileVersion(f"not an SPK DAF (ND={self.nd}, NI={self.ni})")

        self.segments = []
        self._skipped = []  # (target, center, dtype) of unsupported segments
        rec = fward
        ss = self.nd + (self.ni + 1) // 2  # summary size in f64 words
        while rec > 0:
            base = (rec - 1) * 1024
            ctrl = np.frombuffer(raw, e + "f8", 3, base)
            nxt, _prev, nsum = int(ctrl[0]), int(ctrl[1]), int(ctrl[2])
            for i in range(nsum):
                off = base + 24 + i * ss * 8
                dd = np.frombuffer(raw, e + "f8", self.nd, off)
                ii = np.frombuffer(raw, e + "i4", self.ni, off + self.nd * 8)
                seg = self._parse_segment(raw, dd, ii)
                if seg is not None:
                    self.segments.append(seg)
            rec = nxt

    def _parse_segment(self, raw, dd, ii):
        et_start, et_end = dd
        target, center, frame, dtype, a0, a1 = (int(x) for x in ii)
        if dtype not in (2, 3):
            self._skipped.append((target, center, dtype))
            return None
        e = self._end
        # trailer: INIT, INTLEN, RSIZE, N (last 4 words of the segment)
        init, intlen, rsize, n = np.frombuffer(raw, e + "f8", 4, (a1 - 4) * 8)
        rsize, n = int(rsize), int(n)
        ncoeff = (rsize - 2) // (3 if dtype == 2 else 6)
        recs = np.frombuffer(raw, e + "f8", rsize * n, (a0 - 1) * 8).reshape(n, rsize)
        coeffs = recs[:, 2 : 2 + 3 * ncoeff].reshape(n, 3, ncoeff) / AU
        t0_mjd = _J2000_MJD + init / 86400.0
        gran_days = intlen / 86400.0
        table = owned_table(t0_mjd, gran_days, coeffs)
        vel_table = None
        if dtype == 3:
            # explicit velocity sets (km/s -> AU/day); interpolation still
            # differentiates the position polynomials
            vc = recs[:, 2 + 3 * ncoeff : 2 + 6 * ncoeff].reshape(n, 3, ncoeff)
            vel_table = owned_table(t0_mjd, gran_days, vc / AU * 86400.0)
        return SpkSegment(target, center, frame, dtype, et_start, et_end, table, vel_table)

    def segment_for(self, target: int, center: int) -> SpkSegment:
        for s in self.segments:
            if s.target == target and s.center == center:
                return s
        for t, c, dtype in self._skipped:
            if t == target and c == center:
                raise InvalidSpkDataType(
                    f"SPK segment for target={target} center={center} has "
                    f"unsupported data type {dtype} (only Type 2/3)"
                )
        raise EphemerisBodyNotSupported(f"no SPK segment for target={target} center={center}")


def write_synthetic_spk(path, segments, endian="<"):
    """Write a minimal valid Type-2 / Type-3 SPK file.

    ``segments``: list of ``(target, center, BodyTable)`` (Type 2) or
    ``(target, center, BodyTable, vel_BodyTable)`` (Type 3, explicit
    velocity coefficient sets in AU/day); positions in AU are written in km,
    epochs in ET seconds.  The file holds one summary record, so at most
    25 segments.
    """
    e = endian
    nd, ni = 2, 6
    ss = nd + (ni + 1) // 2

    # data area starts at record 3
    chunks = []
    summaries = []
    next_addr = 2 * 128 + 1  # 1-based word address of first data word
    for seg in segments:
        if len(seg) == 3:
            target, center, table = seg
            vel, dtype = None, 2
        else:
            target, center, table, vel = seg
            dtype = 3
        coeffs = np.asarray(table.coeffs) * AU
        n, _, ncoeff = coeffs.shape
        rsize = 2 + (3 if dtype == 2 else 6) * ncoeff
        init = (table.t0 - _J2000_MJD) * 86400.0
        intlen = table.granule_days * 86400.0
        # per record: MID, RADIUS, position sets (, velocity sets in km/s)
        recs = np.empty((n, rsize))
        recs[:, 0] = init + (np.arange(n) + 0.5) * intlen
        recs[:, 1] = 0.5 * intlen
        recs[:, 2 : 2 + 3 * ncoeff] = coeffs.reshape(n, 3 * ncoeff)
        if dtype == 3:
            recs[:, 2 + 3 * ncoeff :] = (np.asarray(vel.coeffs) * AU / 86400.0).reshape(n, 3 * ncoeff)
        words = np.concatenate([recs.ravel(), [init, intlen, float(rsize), float(n)]])
        a0 = next_addr
        a1 = next_addr + len(words) - 1
        next_addr = a1 + 1
        chunks.append(words)
        summaries.append((init, init + n * intlen, target, center, 1, dtype, a0, a1))

    data_words = np.concatenate(chunks) if chunks else np.empty(0)
    nrec_total = 2 + (len(data_words) * 8 + 1023) // 1024
    buf = bytearray(nrec_total * 1024 + ((-len(data_words)) % 128) * 8)
    buf[0:8] = b"DAF/SPK "
    buf[8:12] = np.array([nd], e + "i4").tobytes()
    buf[12:16] = np.array([ni], e + "i4").tobytes()
    buf[16:76] = b"synthetic spk".ljust(60)
    buf[76:80] = np.array([2], e + "i4").tobytes()  # FWARD = record 2
    buf[80:84] = np.array([2], e + "i4").tobytes()  # BWARD
    buf[84:88] = np.array([next_addr], e + "i4").tobytes()  # FREE
    buf[88:96] = b"LTL-IEEE" if e == "<" else b"BIG-IEEE"

    # summary record (record 2)
    base = 1024
    buf[base : base + 24] = np.array([0.0, 0.0, float(len(summaries))], e + "f8").tobytes()
    for i, (et0, et1, tg, ct, fr, ty, a0, a1) in enumerate(summaries):
        off = base + 24 + i * ss * 8
        buf[off : off + 16] = np.array([et0, et1], e + "f8").tobytes()
        buf[off + 16 : off + 40] = np.array([tg, ct, fr, ty, a0, a1], e + "i4").tobytes()

    # data from record 3
    arr = data_words.astype(e + "f8").tobytes()
    buf[2048 : 2048 + len(arr)] = arr
    with open(path, "wb") as fh:
        fh.write(bytes(buf))
