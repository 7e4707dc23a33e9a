# Source: outfit_tpu/ephem/horizon.py (tables as native, contiguous, owned float64 tensors).
"""Parser for JPL legacy DE binary ephemeris files ("Horizon" format).

Classic layout (all little-endian):
  record 1: TTL 3x84 chars | CNAM 400x6 | SS[3] f64 (JD start, end, step)
            | NCON i32 | AU f64 | EMRAT f64 | IPT[0..11] 12x3 i32 | DENUM i32
            | IPT[12] 3 i32 | [extra CNAM (NCON-400)x6] | IPT[13..14]
  record 2: NCON constant values (f64)
  records 3..: data blocks [jd_start, jd_end, coefficients...]

The record size is derived from the IPT.  Output: granule-uniform per-body
``BodyTable``s in AU (see chebyshev.py), each over a contiguous float64
tensor that owns its memory.
"""

import numpy as np

from outfit_tpu_torch.constants import JDTOMJD
from outfit_tpu_torch.ephem.bodies import Body
from outfit_tpu_torch.ephem.naif import owned_table
from outfit_tpu_torch.errors import EphemerisBodyNotSupported

#: DE body-slot index -> Body (slots 0-10 of the IPT; 11=nutation, 12=libration)
_SLOT_TO_BODY = {
    0: Body.MERCURY_BARY,
    1: Body.VENUS_BARY,
    2: Body.EMB,
    3: Body.MARS_BARY,
    4: Body.JUPITER_BARY,
    5: Body.SATURN_BARY,
    6: Body.URANUS_BARY,
    7: Body.NEPTUNE_BARY,
    8: Body.PLUTO_BARY,
    9: Body.MOON,  # geocentric
    10: Body.SUN,
}


def _slot_dimension(slot: int) -> int:
    """Components per slot."""
    if slot == 11:
        return 2  # nutations
    if slot == 14:
        return 1  # TT-TDB
    return 3


class HorizonEphemeris:
    """Parsed legacy DE file: header metadata + per-body tables (AU)."""

    def __init__(self, path: str):
        with open(path, "rb") as fh:
            raw = fh.read()

        self.titles = [raw[i * 84 : (i + 1) * 84].decode("ascii", "replace").strip() for i in range(3)]
        ss = np.frombuffer(raw, dtype="<f8", count=3, offset=2652)
        self.jd_start, self.jd_end, self.block_days = (float(x) for x in ss)
        self.ncon = int(np.frombuffer(raw, "<i4", 1, 2676)[0])
        self.au_km = float(np.frombuffer(raw, "<f8", 1, 2680)[0])
        self.emrat = float(np.frombuffer(raw, "<f8", 1, 2688)[0])
        ipt = np.frombuffer(raw, "<i4", 36, 2696).reshape(12, 3).copy()
        self.denum = int(np.frombuffer(raw, "<i4", 1, 2840)[0])
        ipt12 = np.frombuffer(raw, "<i4", 3, 2844)
        self.ipt = np.vstack([ipt, ipt12])

        # IPT[13..14] live after any extra constant names (>400)
        extra = max(self.ncon - 400, 0)
        off_13 = 2856 + extra * 6
        ipt_13_14 = np.frombuffer(raw, "<i4", 6, off_13).reshape(2, 3)
        self.ipt = np.vstack([self.ipt, ipt_13_14])

        # record size in f64 words
        ncoeffs = 0
        for slot in range(15):
            off, nc, ns = self.ipt[slot]
            ncoeffs += _slot_dimension(slot) * int(nc) * int(ns)
        self.recsize_words = ncoeffs + 2  # + block jd_start, jd_end

        # some files pad the record; the IPT offsets (1-based words) are trusted
        nbytes = self.recsize_words * 8
        data = raw[2 * nbytes :]
        n_blocks = len(data) // nbytes
        self._blocks = np.frombuffer(data, "<f8", n_blocks * self.recsize_words).reshape(
            n_blocks, self.recsize_words
        )
        self.n_blocks = n_blocks

    def body_table(self, body: Body):
        """Flatten a body's per-block sub-interval coefficients into a
        granule-uniform BodyTable (positions converted km -> AU)."""
        slot = {v: k for k, v in _SLOT_TO_BODY.items()}[Body(body)]
        off, nc, ns = (int(x) for x in self.ipt[slot])
        if nc == 0:
            raise EphemerisBodyNotSupported(f"body {body!r} not present in this DE file")
        n_blocks = self._blocks.shape[0]
        # per block: ns sub-intervals x 3 components x nc coefficients,
        # stored component-major within each sub-interval (x[nc], y[nc], z[nc])
        base = off - 1  # fortran 1-based -> 0-based (relative to block start)
        seg = self._blocks[:, base : base + ns * 3 * nc]
        coeffs = seg.reshape(n_blocks * ns, 3, nc) / self.au_km
        return owned_table(self.jd_start - JDTOMJD, self.block_days / ns, coeffs)

    def tables(self):
        return {body: self.body_table(body) for slot, body in _SLOT_TO_BODY.items() if self.ipt[slot][1] > 0}


def write_synthetic_horizon(
    path,
    specs,
    au_km: float = 1.495978707e8,
    emrat: float = 81.3005682214972154,
    denum: int = 440,
    extra_constants: int = 0,
    titles=("SYNTHETIC DE", "", ""),
):
    """Write a minimal valid classic-layout DE binary (the counterpart of
    ``naif.write_synthetic_spk``).

    ``specs``: ``{slot: (BodyTable, ns)}``: granule-uniform tables (AU,
    MJD) sharing one start epoch and one block length
    ``ns * granule_days``.  ``extra_constants`` > 0 writes an NCON > 400
    file, whose IPT[13..14] follow the extra constant names.
    """
    slots = sorted(specs)
    t0s = {float(specs[s][0].t0) for s in slots}
    blocks_days = {float(specs[s][0].granule_days) * specs[s][1] for s in slots}
    if len(t0s) != 1 or len(blocks_days) != 1:
        raise ValueError("all tables must share t0 and ns*granule_days")
    t0 = t0s.pop()
    block_days = blocks_days.pop()
    n_blocks = {np.asarray(specs[s][0].coeffs).shape[0] // specs[s][1] for s in slots}
    if len(n_blocks) != 1:
        raise ValueError("all tables must cover the same number of blocks")
    n_blocks = n_blocks.pop()

    ipt = np.zeros((15, 3), np.int64)
    off = 3  # 1-based f64 word offset within a block (after jd0, jd1)
    for s in slots:
        tb, ns = specs[s]
        nc = np.asarray(tb.coeffs).shape[2]
        ipt[s] = (off, nc, ns)
        off += _slot_dimension(s) * nc * ns
    recsize = off - 1  # == sum(dim*nc*ns) + 2
    ncon = 400 + extra_constants
    header_bytes = 2856 + extra_constants * 6 + 24
    if recsize * 8 < header_bytes:
        raise ValueError(
            f"record size {recsize * 8} bytes too small for the header "
            f"({header_bytes}); use more coefficients"
        )

    jd_start = t0 + JDTOMJD
    jd_end = jd_start + n_blocks * block_days

    rec1 = bytearray(recsize * 8)
    for i, t in enumerate(titles[:3]):
        rec1[i * 84 : (i + 1) * 84] = t.encode("ascii")[:84].ljust(84)
    # CNAM 400x6 stays blank
    rec1[2652:2676] = np.array([jd_start, jd_end, block_days], "<f8").tobytes()
    rec1[2676:2680] = np.array([ncon], "<i4").tobytes()
    rec1[2680:2688] = np.array([au_km], "<f8").tobytes()
    rec1[2688:2696] = np.array([emrat], "<f8").tobytes()
    rec1[2696:2840] = ipt[:12].astype("<i4").tobytes()
    rec1[2840:2844] = np.array([denum], "<i4").tobytes()
    rec1[2844:2856] = ipt[12].astype("<i4").tobytes()
    off13 = 2856 + extra_constants * 6
    rec1[off13 : off13 + 24] = ipt[13:15].astype("<i4").tobytes()

    rec2 = np.zeros(recsize, "<f8").tobytes()  # constant values

    data = np.zeros((n_blocks, recsize))
    data[:, 0] = jd_start + np.arange(n_blocks) * block_days
    data[:, 1] = data[:, 0] + block_days
    for s in slots:
        tb, ns = specs[s]
        nc = np.asarray(tb.coeffs).shape[2]
        # (n_blocks*ns, 3, nc) AU -> per-block sub-interval-major km layout
        c = np.asarray(tb.coeffs).reshape(n_blocks, ns, 3, nc) * au_km
        base = int(ipt[s][0]) - 1
        data[:, base : base + ns * 3 * nc] = c.reshape(n_blocks, ns * 3 * nc)

    with open(path, "wb") as fh:
        fh.write(bytes(rec1))
        fh.write(rec2)
        fh.write(data.astype("<f8").tobytes())
