"""DE ephemeris files (NAIF SPK, legacy "Horizon" DE binaries) in the PyTorch
port against the JAX package.

* The same bytes parsed by both packages give bitwise equal ``t0``,
  ``granule_days`` and coefficient tables (both byte orders, Type 2 and
  Type 3, NCON > 400), the port's tables being native, contiguous, owned
  float64 tensors; the port's writers write the JAX writers' bytes.
* The byte-layout oracles of tests/test_ephem.py (hand-assembled files)
  through the port's parsers, against numpy's Chebyshev evaluation at rtol
  1e-13 (their bar).
* The facade over a parsed file (Earth, Moon, N-body with the Moon) at the
  bars of tests/test_ephem.py; port against JAX on the same file at 1e-15
  AU (positions of at most 1.1 AU; measured maxima printed with -s).
* The resolver's offline logic, and the same exceptions and messages.
* ``fit_lsq`` on 8467 from a Horizon file: bitwise equal to the port's
  analytic fit, and equal to the JAX package's fit from the same file at
  the bars of tests/test_torch_lsq.py.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from outfit_tpu.ephem import JPLEphem as JJPLEphem
from outfit_tpu.ephem import resolver as j_resolver
from outfit_tpu.ephem.chebyshev import BodyTable as JBodyTable
from outfit_tpu.ephem.horizon import HorizonEphemeris as JHorizonEphemeris
from outfit_tpu.ephem.horizon import write_synthetic_horizon as j_write_synthetic_horizon
from outfit_tpu.ephem.naif import NaifEphemeris as JNaifEphemeris
from outfit_tpu.ephem.naif import write_synthetic_spk as j_write_synthetic_spk
from outfit_tpu.iod.api import FitResult as JFitResult
from outfit_tpu.lsq import DifferentialCorrectionConfig as JConfig
from outfit_tpu.lsq import fit_lsq as j_fit_lsq
from outfit_tpu.observations import ErrorModel as JErrorModel
from outfit_tpu.observations import ObsDataset as JObsDataset
import outfit_tpu_torch.errors as terr
from outfit_tpu_torch import (
    DifferentialCorrectionConfig,
    ErrorModel,
    FitResult,
    IODParams,
    JPLEphem,
    ObsDataset,
    fit_lsq,
)
from outfit_tpu_torch.ephem import resolver
from outfit_tpu_torch.ephem.analytic import EMRAT, build_analytic_tables
from outfit_tpu_torch.ephem.bodies import Body
from outfit_tpu_torch.ephem.chebyshev import BodyTable, fit_body_table, interpolate_body
from outfit_tpu_torch.ephem.horizon import HorizonEphemeris, write_synthetic_horizon
from outfit_tpu_torch.ephem.naif import NaifEphemeris, write_synthetic_spk

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_ephem as jt  # noqa: E402  (the JAX suite's hand-assembled oracles)
import test_torch_lsq as tl  # noqa: E402

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
T0, T1 = 56016.0, 56016.0 + 128.0

pytestmark = pytest.mark.filterwarnings("ignore:observatory .* SOLVED")


@pytest.fixture(scope="module")
def teph():
    return JPLEphem.analytic(56000.0, 56400.0)


@pytest.fixture(scope="module")
def tabs(teph):
    """EMB and geocentric Moon refitted on 8-day granules at C = 16, and a
    zero SUN table (the analytic source is heliocentric)."""

    def tab(body):
        return fit_body_table(
            lambda t: interpolate_body(teph.tables[body], torch.as_tensor(t))[0].numpy(),
            T0, T1, granule_days=8.0, n_coeff=16,
        )

    emb = tab(Body.EMB)
    return emb, tab(Body.MOON), zero(emb)


def zero(tb):
    return BodyTable(tb.t0, tb.granule_days, torch.zeros_like(tb.coeffs))


def scaled(tb, s):
    return BodyTable(tb.t0, tb.granule_days, tb.coeffs * s)


def as_jax(tb):
    return JBodyTable(tb.t0, tb.granule_days, jnp.asarray(tb.coeffs.numpy()))


def assert_same_table(port, ref):
    """Bitwise equal, and a native, contiguous float64 tensor that owns its
    memory (what the CUDA kernel takes)."""
    assert port.t0 == float(ref.t0) and port.granule_days == float(ref.granule_days)
    c = port.coeffs
    assert isinstance(c, torch.Tensor) and c.dtype == torch.float64 and c.is_contiguous()
    assert c.numpy().flags.writeable and c.numpy().dtype.isnative
    np.testing.assert_array_equal(c.numpy(), np.asarray(ref.coeffs))


def interp(tb, t):
    p, v = interpolate_body(tb, torch.as_tensor(np.asarray(t, np.float64)))
    return p.numpy(), v.numpy()


# -- NAIF ---------------------------------------------------------------------


def _type3_tables(teph):
    emb = teph.tables[Body.EMB]
    t0, t1 = emb.t0 + 32.0, emb.t0 + 160.0
    ptab = fit_body_table(lambda t: interp(emb, t)[0], t0, t1, granule_days=16.0, n_coeff=12)
    vtab = fit_body_table(lambda t: interp(emb, t)[1], t0, t1, granule_days=16.0, n_coeff=12)
    return ptab, vtab


@pytest.mark.parametrize("endian", ["<", ">"])
@pytest.mark.parametrize("dtype", [2, 3])
def test_spk_write_and_parse_match_jax_bitwise(tmp_path, teph, tabs, endian, dtype):
    """Both writers write the same bytes; both parsers read the same tables."""
    emb, moon, sun = tabs
    if dtype == 2:
        segs = [(3, 0, emb), (10, 0, sun), (301, 3, scaled(moon, 1.0 - 1.0 / (1.0 + EMRAT)))]
    else:
        segs = [(3, 0, *_type3_tables(teph))]
    pt, pj = tmp_path / "port.bsp", tmp_path / "jax.bsp"
    write_synthetic_spk(str(pt), segs, endian=endian)
    j_write_synthetic_spk(str(pj), [(t, c, *map(as_jax, tbs)) for t, c, *tbs in segs], endian=endian)
    assert pt.read_bytes() == pj.read_bytes()
    port, ref = NaifEphemeris(str(pt)), JNaifEphemeris(str(pt))
    assert (port.nd, port.ni, port._end) == (ref.nd, ref.ni, ref._end) == (2, 6, endian)
    assert len(port.segments) == len(ref.segments) == len(segs)
    for a, b in zip(port.segments, ref.segments):
        assert (a.target, a.center, a.frame, a.data_type, a.et_start, a.et_end) == (
            b.target, b.center, b.frame, b.data_type, b.et_start, b.et_end)
        assert_same_table(a.table, b.table)
        if dtype == 3:
            assert_same_table(a.vel_table, b.vel_table)
        else:
            assert a.vel_table is None and b.vel_table is None


def test_synthetic_spk_interpolates_as_written(tmp_path, teph):
    """tests/test_ephem.py::TestNaifRoundTrip::test_synthetic_spk: 1e-12 AU."""
    path = str(tmp_path / "synthetic.bsp")
    emb = teph.tables[Body.EMB]
    write_synthetic_spk(path, [(3, 0, emb), (10, 0, zero(emb))])
    seg = NaifEphemeris(path).segment_for(3, 0)
    assert seg.data_type == 2
    t = np.linspace(emb.t0 + 1.0, emb.t_end - 1.0, 97)
    for a, b in zip(interp(seg.table, t), interp(emb, t)):
        np.testing.assert_allclose(a, b, atol=1e-12)


def test_type3_velocity_sets_consistent(tmp_path, teph):
    """TestNaifRoundTrip::test_type3_velocity_sets_parsed_and_consistent:
    parsed velocity sets equal the written ones (1e-14) and the derivative
    of the position polynomials (1e-9)."""
    ptab, vtab = _type3_tables(teph)
    path = str(tmp_path / "type3.bsp")
    write_synthetic_spk(path, [(3, 0, ptab, vtab)])
    seg = NaifEphemeris(path).segment_for(3, 0)
    assert seg.data_type == 3 and seg.vel_table is not None
    t = np.linspace(ptab.t0 + 1.0, ptab.t_end - 1.0, 64)
    pv = interp(seg.vel_table, t)[0]
    np.testing.assert_allclose(pv, interp(vtab, t)[0], atol=1e-14)
    np.testing.assert_allclose(pv, interp(seg.table, t)[1], atol=1e-9)


def test_spk_errors_match_jax(tmp_path, teph):
    """Unsupported segment type, absent body, not a DAF file, not an SPK
    DAF: the same exception classes (by name and bases) and messages."""
    path = str(tmp_path / "badtype.bsp")
    emb = teph.tables[Body.EMB]
    write_synthetic_spk(path, [(3, 0, emb)])
    port, ref = NaifEphemeris(path), JNaifEphemeris(path)
    port._skipped.append((9, 0, 13))
    ref._skipped.append((9, 0, 13))
    for t, c in ((9, 0), (5, 0)):
        with pytest.raises(Exception) as ej:
            ref.segment_for(t, c)
        with pytest.raises(Exception) as et:
            port.segment_for(t, c)
        _same_error(et.value, ej.value)
    bad = tmp_path / "bad.bsp"
    raw = bytearray((tmp_path / "badtype.bsp").read_bytes())
    for patch in ((0, b"XYZ/SPK "), (8, np.array([3], "<i4").tobytes())):
        buf = raw.copy()
        buf[patch[0] : patch[0] + len(patch[1])] = patch[1]
        bad.write_bytes(bytes(buf))
        with pytest.raises(Exception) as ej:
            JNaifEphemeris(str(bad))
        with pytest.raises(Exception) as et:
            NaifEphemeris(str(bad))
        _same_error(et.value, ej.value)


def _same_error(port_exc, jax_exc):
    assert type(port_exc).__name__ == type(jax_exc).__name__
    assert type(port_exc).__module__ == "outfit_tpu_torch.errors"
    assert [b.__name__ for b in type(port_exc).__mro__] == [b.__name__ for b in type(jax_exc).__mro__]
    assert str(port_exc) == str(jax_exc)


def test_naif_facade_matches_jax(tmp_path, tabs):
    """TestNaifRoundTrip::test_facade_from_naif_file and
    TestCrossFormatConsistency::test_naif_real_layout_moon_and_earth: the
    real DE layout (EMB, Sun, 301 and 399 rel 3) through the facade
    reproduces the analytic facade (1e-10 AU) and equals the JAX facade on
    the same file (1e-15 AU)."""
    emb, moon, sun = tabs
    f = 1.0 / (1.0 + EMRAT)
    path = str(tmp_path / "real_layout.bsp")
    write_synthetic_spk(path, [(3, 0, emb), (10, 0, sun), (301, 3, scaled(moon, 1.0 - f)), (399, 3, scaled(moon, -f))])
    en = JPLEphem.new("naif:SYN", path=path)
    assert en.kind == "naif" and set(en.tables) == {Body.EMB, Body.SUN, Body.MOON, Body.EARTH}
    ej = JJPLEphem.new("naif:SYN", path=path)
    t = np.linspace(T0 + 1.0, T1 - 1.0, 31)
    ref = JPLEphem({Body.EMB: emb, Body.MOON: moon}, kind="analytic")
    worst = 0.0
    for fn in (lambda e, tt: e.earth_ephemeris(tt), lambda e, tt: e.body_ephemeris(Body.MOON, tt)):
        got = [x.numpy() for x in fn(en, torch.as_tensor(t))]
        want = [x.numpy() for x in fn(ref, torch.as_tensor(t))]
        jax = [np.asarray(x) for x in fn(ej, jnp.asarray(t))]
        for g, w, j in zip(got, want, jax):
            np.testing.assert_allclose(g, w, atol=1e-10)
            np.testing.assert_allclose(g, j, rtol=0, atol=1e-15)
            worst = max(worst, float(np.abs(g - j).max()))
    print(f"NAIF facade port vs JAX: {worst!r}")


# -- Horizon ------------------------------------------------------------------


@pytest.mark.parametrize("extra", [0, 20])
def test_horizon_write_and_parse_match_jax_bitwise(tmp_path, tabs, extra):
    """Both writers write the same bytes; both parsers read the same header
    and tables (NCON > 400 shifts IPT[13..14])."""
    emb, moon, sun = tabs
    specs = {2: (emb, 4), 9: (moon, 4), 10: (sun, 4)}
    kw = dict(au_km=1.49e8, emrat=81.25, denum=441, extra_constants=extra, titles=("TITLE A", "TITLE B", "TITLE C"))
    pt, pj = tmp_path / "port.de", tmp_path / "jax.de"
    write_synthetic_horizon(str(pt), specs, **kw)
    j_write_synthetic_horizon(str(pj), {s: (as_jax(tb), ns) for s, (tb, ns) in specs.items()}, **kw)
    assert pt.read_bytes() == pj.read_bytes()
    port, ref = HorizonEphemeris(str(pt)), JHorizonEphemeris(str(pt))
    for f in ("titles", "jd_start", "jd_end", "block_days", "ncon", "au_km", "emrat", "denum", "recsize_words", "n_blocks"):
        assert getattr(port, f) == getattr(ref, f), f
    np.testing.assert_array_equal(port.ipt, ref.ipt)
    assert port.ncon == 400 + extra and (port.ipt[13:] == 0).all()
    pt_tabs, ref_tabs = port.tables(), ref.tables()
    assert list(pt_tabs) == list(ref_tabs) == [Body.EMB, Body.MOON, Body.SUN]
    for b in pt_tabs:
        assert_same_table(pt_tabs[b], ref_tabs[b])


def test_horizon_round_trip_and_facade(tmp_path, teph, tabs):
    """TestHorizonRoundTrip: parsed tables interpolate as written (1e-12 AU)
    and the facade's Earth matches the analytic one (5e-11 AU)."""
    emb, moon, sun = tabs
    path = str(tmp_path / "facade.de")
    write_synthetic_horizon(path, {2: (emb, 4), 9: (moon, 4), 10: (sun, 4)})
    h = HorizonEphemeris(path)
    t = np.linspace(T0 + 1.0, T1 - 1.0, 97)
    for body, tab in ((Body.EMB, emb), (Body.MOON, moon), (Body.SUN, sun)):
        for a, b in zip(interp(h.body_table(body), t), interp(tab, t)):
            np.testing.assert_allclose(a, b, atol=1e-12)
    eh = JPLEphem("horizon:whatever", path=path)
    assert eh.kind == "horizon" and eh.emrat == pytest.approx(81.3005682214972154)
    tt = torch.tensor([56050.0, 56100.0], dtype=torch.float64)
    for a, b in zip(eh.earth_ephemeris(tt), teph.earth_ephemeris(tt)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-11)


def test_horizon_and_naif_agree_through_facade(tmp_path, teph, tabs):
    """TestCrossFormatConsistency: the same tables through both formats
    give the same Earth and Moon (1e-10 AU) and the same N-body trajectory
    with the Moon as perturber (1e-11 AU, 1e-12 AU/day)."""
    from outfit_tpu_torch.elements.types import EquinoctialElements
    from outfit_tpu_torch.propagator import NBodyConfig, propagate_nbody

    emb, moon, sun = tabs
    f = 1.0 / (1.0 + EMRAT)
    hpath, npath = str(tmp_path / "cross.de"), str(tmp_path / "cross.bsp")
    write_synthetic_horizon(hpath, {2: (emb, 4), 9: (moon, 4), 10: (sun, 4)})
    write_synthetic_spk(npath, [(3, 0, emb), (10, 0, sun), (301, 3, scaled(moon, 1.0 - f)), (399, 3, scaled(moon, -f))])
    eh, en = JPLEphem.new("horizon:SYN", path=hpath), JPLEphem.new("naif:SYN", path=npath)
    t = torch.as_tensor(np.linspace(T0 + 1.0, T1 - 1.0, 61))
    for a, b in zip(en.earth_ephemeris(t), eh.earth_ephemeris(t)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-10)
    for a, b in zip(en.body_ephemeris(Body.MOON, t), eh.body_ephemeris(Body.MOON, t)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-10)
    eq = EquinoctialElements(*(torch.tensor(x, dtype=torch.float64) for x in (56020.0, 1.2, 0.05, 0.02, 0.01, 0.02, 1.0)))
    cfg = NBodyConfig(perturbing_bodies=(Body.MOON,))
    nh = propagate_nbody(eq, 56050.0, eh, cfg, device="cpu")
    nn = propagate_nbody(eq, 56050.0, en, cfg, device="cpu")
    assert int(nh.status) == 0 and int(nn.status) == 0
    np.testing.assert_allclose(nn.position.numpy(), nh.position.numpy(), atol=1e-11)
    np.testing.assert_allclose(nn.velocity.numpy(), nh.velocity.numpy(), atol=1e-12)


# -- byte-layout oracles (files assembled by hand, no writer) -----------------


@pytest.mark.parametrize("build", ["le", "be", "chain"])
def test_daf_byte_layout_oracle(tmp_path, build):
    """TestDafByteLayoutOracle through the port's parser: header fields,
    1-based addressing, both byte orders and a chained summary record; the
    tables bitwise the JAX parser's."""
    oracle = jt.TestDafByteLayoutOracle()
    path = tmp_path / f"oracle_{build}.bsp"
    path.write_bytes(oracle._build(">" if build == "be" else "<", chain=build == "chain"))
    port, ref = NaifEphemeris(str(path)), JNaifEphemeris(str(path))
    assert (port.nd, port.ni) == (2, 6)
    assert len(port.segments) == (2 if build == "chain" else 1)
    for (target, scale) in ((301, 1.0), (399, 2.0))[: len(port.segments)]:
        seg = port.segment_for(target, 3)
        assert_same_table(seg.table, ref.segment_for(target, 3).table)
        assert seg.data_type == 2 and seg.frame == 1 and seg.et_start == oracle.INIT
        assert seg.table.t0 == 56000.0 and seg.table.granule_days == 8.0
        assert tuple(seg.table.coeffs.shape) == (oracle.NGRAN, 3, oracle.NCOEFF)
        for mjd in (56001.25, 56007.9, 56011.0, 56015.5):
            p, v = interp(seg.table, mjd)
            pe, ve = oracle._expected(mjd, scale)
            np.testing.assert_allclose(p, pe, rtol=1e-13)
            np.testing.assert_allclose(v, ve, rtol=1e-13)


def test_horizon_byte_layout_oracle(tmp_path):
    """TestHorizonByteLayoutOracle through the port's parser."""
    oracle = jt.TestHorizonByteLayoutOracle()
    path = tmp_path / "oracle_hand.de"
    path.write_bytes(oracle._build())
    h, ref = HorizonEphemeris(str(path)), JHorizonEphemeris(str(path))
    assert h.titles[0] == "ORACLE TITLE 1" and h.jd_start == oracle.T0 + 2400000.5
    assert (h.block_days, h.ncon, h.au_km, h.emrat, h.denum) == (oracle.BLOCK_DAYS, 400, oracle.AU_KM, 81.25, 441)
    assert tuple(h.ipt[2]) == oracle.IPT2 and tuple(h.ipt[9]) == oracle.IPT9
    assert (h.recsize_words, h.n_blocks) == (oracle.RECSIZE, oracle.NB)
    for slot, body in ((2, Body.EMB), (9, Body.MOON)):
        tb = h.body_table(body)
        assert_same_table(tb, ref.body_table(body))
        assert tb.t0 == oracle.T0 and tb.granule_days == 8.0
        for mjd in (56001.25, 56007.9, 56011.0, 56017.5, 56028.75):
            p, v = interp(tb, mjd)
            pe, ve = oracle._expected(slot, mjd)
            np.testing.assert_allclose(p, pe, rtol=1e-13)
            np.testing.assert_allclose(v, ve, rtol=1e-13)
    with pytest.raises(terr.EphemerisBodyNotSupported) as et:
        h.body_table(Body.MARS_BARY)
    with pytest.raises(Exception) as ej:
        ref.body_table(Body.MARS_BARY)
    _same_error(et.value, ej.value)


# -- resolver and the facade's source strings ---------------------------------


def test_resolver_parse_urls_and_cache_layout(tmp_path):
    """TestResolver: URLs, filenames, cache paths, as the JAX package's."""
    for src in ("horizon:DE440", "naif:DE440", "NAIF:DE441_part-1", "horizon:DE430t", "naif:DE440s"):
        a, b = resolver.EphemFileSource.parse(src), j_resolver.EphemFileSource.parse(src)
        assert (a.scheme, a.version, a.url, a.cache_subdir, a.filename) == (
            b.scheme, b.version, b.url, b.cache_subdir, b.filename)
        assert a.cache_path(str(tmp_path)) == b.cache_path(str(tmp_path))
    assert resolver.EphemFileSource.parse("horizon:DE440").url == (
        "https://ssd.jpl.nasa.gov/ftp/eph/planets/Linux/de440/linux_p1550p2650.440")
    assert resolver.EphemFileSource.parse("horizon:DE440").cache_path(str(tmp_path)) == str(
        tmp_path / "outfit_cache" / "jpl_ephem" / "jpl_horizon" / "DE440.bsp")


@pytest.mark.parametrize("src", ["DE440", "a:b:c", "spice:DE440", "horizon:DE999", "naif:DE441"])
def test_resolver_parse_errors_match_jax(src):
    with pytest.raises(Exception) as ej:
        j_resolver.EphemFileSource.parse(src)
    with pytest.raises(Exception) as et:
        resolver.EphemFileSource.parse(src)
    _same_error(et.value, ej.value)


def test_os_cache_root_linux(monkeypatch):
    if sys.platform.startswith("linux"):
        monkeypatch.setenv("XDG_CACHE_HOME", "/tmp/xdgcache")
        assert resolver.os_cache_root() == "/tmp/xdgcache" == j_resolver.os_cache_root()
        monkeypatch.delenv("XDG_CACHE_HOME")
        assert resolver.os_cache_root() == os.path.expanduser("~/.cache") == j_resolver.os_cache_root()


def test_validate_ephemeris_bytes(tmp_path):
    small, naif, horizon = tmp_path / "small", tmp_path / "big.bsp", tmp_path / "big.de"
    small.write_bytes(b"DAF/SPK " + bytes(100))
    naif.write_bytes(b"DAF/SPK " + bytes(1 << 20))
    horizon.write_bytes(b"JPL Planetary Ephemeris DE440" + bytes(1 << 20))
    for p, scheme in ((small, "naif"), (naif, "naif"), (naif, "horizon"), (horizon, "horizon"), (tmp_path / "no", "naif")):
        assert resolver.validate_ephemeris_bytes(str(p), scheme) == j_resolver.validate_ephemeris_bytes(str(p), scheme)
    assert resolver.validate_ephemeris_bytes(str(naif), "naif") and resolver.validate_ephemeris_bytes(str(horizon), "horizon")


def test_resolve_hit_and_offline_miss(tmp_path, monkeypatch):
    """A cache hit returns the path; a miss raises JPLFileNotFound naming
    the path and the URL, the JAX package's message with downloads
    disabled, and the port never fetches (downloads left enabled here)."""
    p = tmp_path / "outfit_cache" / "jpl_ephem" / "naif" / "de440.bsp"
    p.parent.mkdir(parents=True)
    p.write_bytes(b"x")
    assert resolver.resolve_ephemeris_file("naif:DE440", cache_root=str(tmp_path)) == str(p)
    monkeypatch.delenv("OUTFIT_NO_DOWNLOAD", raising=False)
    import urllib.request

    monkeypatch.setattr(urllib.request, "urlopen", lambda *a, **k: pytest.fail("the port fetched"))
    with pytest.raises(terr.JPLFileNotFound) as et:
        resolver.resolve_ephemeris_file("naif:DE442", cache_root=str(tmp_path))
    monkeypatch.setenv("OUTFIT_NO_DOWNLOAD", "1")
    with pytest.raises(Exception) as ej:
        j_resolver.resolve_ephemeris_file("naif:DE442", cache_root=str(tmp_path))
    _same_error(et.value, ej.value)
    assert "de442.bsp" in str(et.value) and "naif.jpl.nasa.gov" in str(et.value)
    assert isinstance(et.value, FileNotFoundError)


def test_facade_missing_file_and_resolver_cache(tmp_path, monkeypatch):
    """TestNaifRoundTrip::test_missing_file_raises and
    TestResolver::test_facade_uses_resolver_cache: ``JPLEphem.new`` falls
    through $OUTFIT_EPHEM_DIR to the OS cache path."""
    monkeypatch.setenv("OUTFIT_EPHEM_DIR", str(tmp_path / "empty"))
    monkeypatch.setattr(resolver, "os_cache_root", lambda: str(tmp_path / "cacheroot"))
    with pytest.raises(terr.JPLFileNotFound):
        JPLEphem.new("horizon:DE440", path=None)
    with pytest.raises(FileNotFoundError):
        JPLEphem("naif:DE440")
    tables = build_analytic_tables(56000.0, 56400.0)
    emb, moon = tables[Body.EMB], tables[Body.MOON]
    dst = tmp_path / "cacheroot" / "outfit_cache" / "jpl_ephem" / "naif" / "de440.bsp"
    dst.parent.mkdir(parents=True)
    write_synthetic_spk(str(dst), [(3, 0, emb), (10, 0, zero(emb)), (301, 3, scaled(moon, 1.0 - 1.0 / (1.0 + EMRAT)))])
    eph = JPLEphem.new("naif:DE440")
    assert eph.kind == "naif"
    assert np.isfinite(eph.earth_ephemeris(torch.tensor(56100.0, dtype=torch.float64))[0].numpy()).all()
    # $OUTFIT_EPHEM_DIR comes first
    (tmp_path / "ephdir").mkdir()
    os.replace(dst, tmp_path / "ephdir" / "de440s.bsp")
    monkeypatch.setenv("OUTFIT_EPHEM_DIR", str(tmp_path / "ephdir"))
    assert JPLEphem("naif:DE440").kind == "naif"


def test_default_source_coverage_and_unknown_scheme(tmp_path):
    """``JPLEphem()`` and ``JPLEphem.new("analytic:builtin")`` are the
    analytic source over the JAX package's default span; ``coverage`` is the
    JAX package's; an unknown scheme raises the JAX package's error."""
    a, b = JPLEphem(), JPLEphem.new("analytic:builtin")
    assert a.kind == b.kind == "analytic" and a.coverage == b.coverage
    span = (53500.0, 61500.0)
    assert JPLEphem.analytic(*span).coverage == JJPLEphem.analytic(*span).coverage
    assert a.coverage[0] == 36934.0 and a.coverage[1] >= 73459.0
    path = tmp_path / "some.bsp"
    path.write_bytes(b"x")
    for kw in (dict(path=str(path)), {}):
        with pytest.raises(Exception) as ej:
            JJPLEphem.new("spice:DE440", **kw)
        with pytest.raises(terr.InvalidJPLStringFormat) as et:
            JPLEphem("spice:DE440", **kw)
        _same_error(et.value, ej.value)


@pytest.mark.skipif(not os.environ.get("OUTFIT_DE440_PATH"), reason="set $OUTFIT_DE440_PATH to a real de440(s).bsp to run")
class TestRealDE440:
    """tests/test_ephem.py::TestRealDE440 (self-skipping: no real file in
    the repository)."""

    def test_parse_and_physical_checks(self):
        eph = JPLEphem.new("naif:DE440", path=os.environ["OUTFIT_DE440_PATH"])
        mjd = torch.tensor([51544.5, 57000.0, 60000.0], dtype=torch.float64)
        pos, vel = (x.numpy() for x in eph.earth_ephemeris(mjd, velocity=True))
        assert (np.abs(np.linalg.norm(pos, axis=-1) - 1.0) < 0.02).all()
        assert (np.abs(np.linalg.norm(vel, axis=-1) - 0.0172) < 0.0006).all()
        pa, _ = JPLEphem.analytic(51000.0, 61000.0).earth_ephemeris(mjd)
        assert np.abs(pa.numpy() - pos).max() < 5e-4

    def test_cross_backend_if_horizon_present(self):
        hpath = os.environ.get("OUTFIT_DE440_HORIZON_PATH")
        if not hpath:
            pytest.skip("set $OUTFIT_DE440_HORIZON_PATH for the cross-check")
        mjd = torch.tensor([57000.0, 58000.0], dtype=torch.float64)
        pn, _ = JPLEphem.new("naif:DE440", path=os.environ["OUTFIT_DE440_PATH"]).earth_ephemeris(mjd)
        ph, _ = JPLEphem.new("horizon:DE440", path=hpath).earth_ephemeris(mjd)
        np.testing.assert_allclose(pn.numpy(), ph.numpy(), atol=1e-9)


# -- end to end: a fit from a file --------------------------------------------


def test_fit_lsq_from_horizon_file(tmp_path):
    """TestBinaryFileE2E::test_fit_lsq_from_horizon_file_bitwise in the
    port: the analytic tables written with au_km = 2^27 (the km round trip
    an exponent shift) and a zero SUN table parse back bitwise, and the
    port's IOD + LSQ fit of 8467 from the file is bitwise its fit from the
    tables in memory; the seeded fit from the file equals the JAX package's
    seeded fit from the same file at tests/test_torch_lsq.py's bars."""
    t0, t1 = 60640.0, 60736.0
    tables = build_analytic_tables(t0, t1)
    emb, moon = tables[Body.EMB], tables[Body.MOON]
    eph_a = JPLEphem({Body.EMB: emb, Body.MOON: moon}, kind="analytic")
    path = str(tmp_path / "pipeline.de")
    write_synthetic_horizon(path, {2: (emb, 2), 9: (moon, 8), 10: (zero(emb), 2)}, au_km=2.0**27)
    eph_h = JPLEphem.new("horizon:SYN", path=path)
    for body in (Body.EMB, Body.MOON):
        assert_same_table(eph_h.tables[body], tables[body])
    assert eph_h.emrat == eph_a.emrat

    obs = os.path.join(DATA, "8467.obs")
    params, cfg = IODParams(n_noise_realizations=2), DifferentialCorrectionConfig()
    r_a = fit_lsq(ObsDataset.from_mpc_80_col(obs), eph_a, params, cfg, seed=42, device="cpu")["8467"]
    r_h = fit_lsq(ObsDataset.from_mpc_80_col(obs), eph_h, params, cfg, seed=42, device="cpu")["8467"]
    assert r_a.ok and r_h.ok and r_h.status == r_a.status and not r_h.fell_back_to_iod
    assert r_h.normalised_rms == r_a.normalised_rms
    np.testing.assert_array_equal(r_h.equinoctial, r_a.equinoctial)
    np.testing.assert_array_equal(r_h.covariance, r_a.covariance)

    rt = fit_lsq(ObsDataset.from_mpc_80_col(obs), eph_h, config=cfg, error_model=ErrorModel.fcct14(),
                 initial_orbits=tl._seeds("8467", FitResult), device="cpu")["8467"]
    rj = j_fit_lsq(JObsDataset.from_mpc_80_col(obs), JJPLEphem.new("horizon:SYN", path=path), config=JConfig(),
                   error_model=JErrorModel.fcct14(), initial_orbits=tl._seeds("8467", JFitResult), mesh=None)["8467"]
    for f in ("ok", "fell_back_to_iod", "status", "n_active_obs", "total_newton_iterations", "error"):
        assert getattr(rt, f) == getattr(rj, f), f
    np.testing.assert_allclose(rt.equinoctial, np.asarray(rj.equinoctial), rtol=tl.RTOL, atol=tl.ATOL)
    np.testing.assert_allclose(rt.normalised_rms, rj.normalised_rms, rtol=1e-6)
    print(f"8467 from a Horizon file, port vs JAX: {np.abs(rt.equinoctial - np.asarray(rj.equinoctial)).max()!r}")
