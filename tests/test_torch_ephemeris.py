"""Ephemeris generation of the PyTorch port against the JAX package.

The same numpy elements, epochs and observers go through
``outfit_tpu.ephemeris`` and ``outfit_tpu_torch.ephemeris`` on the CPU in
float64; the ephemeris tables cross with ``JPLEphem.from_jax_tables``.
Tolerances: every field of ``compute_apparent`` and of the three entry
points at 1e-13 with the two-body propagator and 1e-10 with the N-body one
(absolute, in rad, AU, AU/day, rad/day), ``ok`` and every error string
equal.  Inside the port the batch against the per-orbit API is held at
1e-13, not bitwise (tests/test_ephemeris_api.py's bar: PyTorch's vector
and scalar transcendental paths differ in the last bit).

Run with ``-s`` to read the measured maxima (lines starting ``measured``).
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import outfit_tpu
import outfit_tpu.ephemeris as j_ephemeris
from outfit_tpu.elements.types import EquinoctialElements as JEq
from outfit_tpu.elements.types import KeplerianElements as JKep
from outfit_tpu.ephem import JPLEphem as JJPLEphem
from outfit_tpu.ephemeris.compute import compute_apparent as j_compute_apparent
from outfit_tpu.lsq.api import LsqResult as JLsqResult
from outfit_tpu.lsq.table import LsqTable as JLsqTable
from outfit_tpu.observations.observatories import Observer as JObserver
from outfit_tpu.observations.observatories import get_observatory as j_get_observatory
from outfit_tpu.propagator.config import NBodyConfig as JNBodyConfig
from outfit_tpu.propagator.config import PropagatorKind as JPropagatorKind
import outfit_tpu_torch
import outfit_tpu_torch.ephemeris as t_ephemeris
from outfit_tpu_torch import (
    AberrationOrder,
    EphemerisConfig,
    EphemerisMode,
    EphemerisRequest,
    JPLEphem,
    KeplerianElements,
    LsqResult,
    LsqTable,
    NBodyConfig,
    Observer,
    PropagatorKind,
    compute_ephemerides_batch,
    compute_ephemerides_for_results,
    compute_ephemeris,
    get_observatory,
)
from outfit_tpu_torch.elements.types import EquinoctialElements
from outfit_tpu_torch.ephem import chebyshev
from outfit_tpu_torch.ephemeris.batch import _GEOM_FIELDS, _POS_FIELDS
from outfit_tpu_torch.ephemeris.compute import compute_apparent

torch.set_num_threads(2)

pytestmark = [
    pytest.mark.filterwarnings("ignore:observatory .* SOLVED"),
    pytest.mark.filterwarnings("ignore:unknown MPC observatory code"),
]

SPAN = (56900.0, 57400.0)
KEP = (57000.0, 2.3, 0.15, 0.12, 1.1, 0.7, 0.3)
TOL = {"two_body": 1e-13, "n_body": 1e-10}


@pytest.fixture(scope="module")
def eph_pair():
    ej = JJPLEphem.analytic(*SPAN)
    return ej, JPLEphem.from_jax_tables(
        {b: (t.t0, t.granule_days, np.asarray(t.coeffs)) for b, t in ej.tables.items()},
        ej.emrat, ej.kind,
    )


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def _propagators(name):
    if name == "two_body":
        return JPropagatorKind.two_body(), PropagatorKind.two_body()
    return (JPropagatorKind.n_body(JNBodyConfig.with_planets()),
            PropagatorKind.n_body(NBodyConfig.with_planets()))


def _config_pair(prop="two_body", order=1):
    pj, pt = _propagators(prop)
    return (j_ephemeris.EphemerisConfig(propagator=pj, aberration=j_ephemeris.AberrationOrder(order)),
            EphemerisConfig(propagator=pt, aberration=AberrationOrder(order)))


def _requests(cfgs=None, output="combined", extra=()):
    """The same request in both packages: the geocenter on a 10-day grid and
    station 809 at two epochs, then ``extra`` ``(code, epochs)`` entries."""
    cj, ct = cfgs or _config_pair()
    rj = j_ephemeris.EphemerisRequest(cj, output=output)
    rt = EphemerisRequest(ct, output=output)
    rj.add(JObserver.geocenter(), j_ephemeris.EphemerisMode.range(57010.0, 57040.0, 10.0))
    rt.add(Observer.geocenter(), EphemerisMode.range(57010.0, 57040.0, 10.0))
    for code, eps in (("809", [57015.0, 57025.0]),) + tuple(extra):
        rj.add(j_get_observatory(code), j_ephemeris.EphemerisMode.at(eps))
        rt.add(get_observatory(code), EphemerisMode.at(eps))
    return rj, rt


def _values(v):
    """The floats of an entry value of any output kind."""
    if hasattr(v, "position"):
        return [*v.position, *v.geometry]
    return list(v)


def _assert_results_match(rt, rj, tol):
    assert len(rt) == len(rj)
    worst = 0.0
    for a, b in zip(rj, rt):
        assert (a.epoch, a.observer.code, a.ok, a.error) == (b.epoch, b.observer.code, b.ok, b.error)
        if a.ok:
            assert type(a.value).__name__ == type(b.value).__name__
            worst = max(worst, float(np.abs(np.array(_values(b.value)) - np.array(_values(a.value))).max()))
            np.testing.assert_allclose(_values(b.value), _values(a.value), atol=tol, rtol=0)
    print(f"measured entry values (bar {tol}):", worst)


# ---------------------------------------------------------------------------
# compute_apparent
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", [1, 2], ids=["first", "second"])
@pytest.mark.parametrize("prop", ["two_body", "n_body"])
def test_compute_apparent_matches_jax(eph_pair, prop, order):
    """(T, 1) elements against (T, P) epochs with per-pair observer states;
    one hyperbolic row and one NaN row ride along with ok False."""
    ej, et = eph_pair
    rng = np.random.default_rng(21)
    T, P = 6, 5
    e, w = rng.uniform(0.0, 0.35, T), rng.uniform(0, 2 * np.pi, T)
    cols = [np.full(T, 57000.0), rng.uniform(1.2, 3.5, T), e * np.sin(w), e * np.cos(w),
            rng.uniform(-0.15, 0.15, T), rng.uniform(-0.15, 0.15, T), rng.uniform(0, 2 * np.pi, T)]
    cols[2][4], cols[3][4] = 1.2, 0.3  # e > 1
    cols[1][5] = np.nan
    epochs = 57000.0 + np.sort(rng.uniform(-20.0, 30.0, P))
    earth_p, earth_v = ej.earth_ephemeris(jnp.asarray(epochs))
    obs_p = np.array(earth_p) + rng.normal(0, 3e-5, (P, 3))
    obs_v = np.array(earth_v) + rng.normal(0, 2e-4, (P, 3))
    pj, pt = _propagators(prop)
    oj = j_compute_apparent(
        JEq(*(jnp.asarray(c)[:, None] for c in cols)), jnp.broadcast_to(jnp.asarray(epochs), (T, P)),
        jnp.asarray(obs_p)[None], jnp.asarray(obs_v)[None], pj, j_ephemeris.AberrationOrder(order), ej,
    )
    ot = compute_apparent(
        EquinoctialElements(*(_t(c)[:, None] for c in cols)), _t(epochs).expand(T, P),
        _t(obs_p)[None], _t(obs_v)[None], pt, AberrationOrder(order), et,
    )
    okj = np.asarray(oj.ok)
    np.testing.assert_array_equal(ot.ok.numpy(), okj)
    assert okj[:4].all() and not okj[4:].any()
    print(f"measured compute_apparent {prop} order {order} port-JAX:", max(
        float(np.abs(ft.numpy()[okj] - np.asarray(fj)[okj]).max())
        for ft, fj in zip([*ot.position, *ot.geometry], [*oj.position, *oj.geometry])))
    for name, ft, fj in zip(_POS_FIELDS + _GEOM_FIELDS, [*ot.position, *ot.geometry], [*oj.position, *oj.geometry]):
        assert ft.shape == (T, P) and ft.dtype == torch.float64, name
        np.testing.assert_allclose(ft.numpy()[okj], np.asarray(fj)[okj], atol=TOL[prop], rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# compute_ephemeris
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["first", "second", "n_body", "position", "geometry", "unknown_observatory"])
def test_compute_ephemeris_matches_jax(eph_pair, case):
    ej, et = eph_pair
    cfgs = {"second": _config_pair(order=2), "n_body": _config_pair("n_body")}.get(case)
    output = case if case in ("position", "geometry") else "combined"
    extra = (("ZZ9", [57010.0, 57020.0]),) if case == "unknown_observatory" else ()
    rj, rt = _requests(cfgs, output, extra)
    resj = j_ephemeris.compute_ephemeris(JKep(*map(jnp.float64, KEP)), rj, ej)
    rest = compute_ephemeris(KeplerianElements(*map(_t, KEP)), rt, et, device="cpu")
    _assert_results_match(rest, resj, TOL["n_body" if case == "n_body" else "two_body"])
    assert rest.success_count() == 6 and rest.error_count() == len(rest) - 6
    if case == "unknown_observatory":
        assert [e.error for e in rest.errors()] == ["UnknownObservatory(ZZ9)"] * 2
    kind = {"position": "ApparentPosition", "geometry": "BodyGeometry"}.get(case, "EphemerisValue")
    assert all(type(e.value).__name__ == kind for e in rest.successes())


def test_compute_ephemeris_takes_plain_floats_and_equinoctial_elements(eph_pair):
    _, et = eph_pair
    _, rt = _requests()
    ref = compute_ephemeris(KeplerianElements(*map(_t, KEP)), rt, et, device="cpu")
    _assert_results_match(compute_ephemeris(KeplerianElements(*KEP), rt, et, device="cpu"), ref, 0.0)
    eq = outfit_tpu_torch.elements.types.keplerian_to_equinoctial(KeplerianElements(*map(_t, KEP)))
    _assert_results_match(compute_ephemeris(eq, rt, et, device="cpu"), ref, 0.0)


def test_hyperbolic_orbit_errors_every_entry_before_any_device_work():
    """e >= 1: the same error text on every entry, and no ephemeris query
    (``ephem=None`` would raise on one)."""
    rj, rt = _requests()
    hyp = (57000.0, 2.0, 1.2, 0.3, 0.0, 0.0, 1.0)
    resj = j_ephemeris.compute_ephemeris(JEq(*map(jnp.float64, hyp)), rj, None)
    rest = compute_ephemeris(EquinoctialElements(*map(_t, hyp)), rt, None, device="cpu")
    _assert_results_match(rest, resj, 0.0)
    assert rest.error_count() == 6 and {e.error for e in rest} == {"InvalidOrbit(e=1.237 >= 1)"}


def test_empty_request(eph_pair):
    ej, et = eph_pair
    rj = j_ephemeris.EphemerisRequest().add(JObserver.geocenter(), [])
    rt = EphemerisRequest().add(Observer.geocenter(), [])
    assert len(j_ephemeris.compute_ephemeris(JKep(*map(jnp.float64, KEP)), rj, ej)) == 0
    assert len(compute_ephemeris(KeplerianElements(*map(_t, KEP)), rt, et, device="cpu")) == 0
    assert len(compute_ephemeris(KeplerianElements(*map(_t, KEP)), EphemerisRequest(), et, device="cpu")) == 0
    table = compute_ephemerides_batch({"A": (57000.0, np.array([2.0, 0.05, 0.1, 0.01, 0.0, 1.0]))}, rt, et,
                                      device="cpu")
    assert table.ok.shape == (1, 0) and table.n_pairs == 0 and len(table.result("A")) == 0


def test_request_and_result_containers_match_jax():
    for kw in ({}, {"output": "position"}):
        assert dataclasses.asdict(EphemerisRequest(**kw)) == dataclasses.asdict(j_ephemeris.EphemerisRequest(**kw))
    with pytest.raises(ValueError, match="output must be one of"):
        EphemerisRequest(output="both")
    assert EphemerisMode.range(57010.0, 57040.0, 10.0) == EphemerisMode.at([57010.0, 57020.0, 57030.0, 57040.0])
    assert EphemerisMode.single(5.0).epochs == j_ephemeris.EphemerisMode.single(5.0).epochs
    assert [int(o) for o in AberrationOrder] == [int(o) for o in j_ephemeris.AberrationOrder]


def test_one_earth_evaluation_per_request(eph_pair, monkeypatch):
    """The observers' heliocentric states take one Earth-ephemeris
    evaluation per request: two table lookups (EMB and Moon), not four."""
    _, et = eph_pair
    calls = []
    real = chebyshev.interpolate_body

    def counting(table, mjd, velocity=True):
        calls.append(tuple(mjd.shape))
        return real(table, mjd, velocity)

    monkeypatch.setattr(outfit_tpu_torch.ephem.api, "interpolate_body", counting)
    _, rt = _requests()
    compute_ephemeris(KeplerianElements(*map(_t, KEP)), rt, et, device="cpu")
    assert calls == [(6,), (6,)]


def test_device_defaults_through_resolve_device(eph_pair, monkeypatch):
    _, et = eph_pair
    seen = []

    def resolve(device=None):
        seen.append(device)
        return torch.device("cpu")

    monkeypatch.setattr(outfit_tpu_torch.ephemeris.api, "resolve_device", resolve)
    monkeypatch.setattr(outfit_tpu_torch.ephemeris.batch, "resolve_device", resolve)
    _, rt = _requests()
    compute_ephemeris(KeplerianElements(*map(_t, KEP)), rt, et)
    compute_ephemerides_batch({"A": (57000.0, np.array([2.0, 0.05, 0.1, 0.01, 0.0, 1.0]))}, rt, et)
    compute_ephemerides_for_results({"A": LsqResult("A", ok=True, epoch=57000.0,
                                                    equinoctial=np.array([2.0, 0.05, 0.1, 0.01, 0.0, 1.0]))}, rt, et)
    assert seen and seen[0] is None


# ---------------------------------------------------------------------------
# bulk entry points
# ---------------------------------------------------------------------------


def _fit_results(cls):
    """tests/test_ephemeris_api.py::TestBatchEphemerides._results, with a
    NaN row: three good fits, a failed fit, a hyperbolic orbit."""
    out = {}
    for k in range(3):
        eqv = np.array([2.0 + 0.3 * k, 0.05 * k, 0.1, 0.01, 0.02 * k, 1.0 + k])
        out[f"T{k}"] = cls(f"T{k}", ok=True, epoch=57000.0 + k, equinoctial=eqv, normalised_rms=1.0, status=1)
    out["BAD"] = cls("BAD", ok=False, error="NoViableOrbit(8)")
    out["HYP"] = cls("HYP", ok=True, epoch=57000.0, equinoctial=np.array([2.0, 1.2, 0.3, 0.0, 0.0, 0.0]),
                     normalised_rms=1.0, status=1)
    out["NAN"] = cls("NAN", ok=True, epoch=57000.0, equinoctial=np.array([2.0, np.nan, 0.3, 0.0, 0.0, 0.0]),
                     normalised_rms=1.0, status=1)
    return out


def _assert_tables_match(tt, tj, tol):
    assert tt.traj_ids == tj.traj_ids and tt.row_errors == tj.row_errors and tt.output == tj.output
    np.testing.assert_array_equal(tt.epochs, tj.epochs)
    assert [o.code for o in tt.observers] == [o.code for o in tj.observers]
    np.testing.assert_array_equal(tt.ok, tj.ok)
    np.testing.assert_array_equal(tt.unknown_observer, tj.unknown_observer)
    print(f"measured table columns port-JAX (bar {tol}):", max(
        [float(np.abs(getattr(tt, f)[tt.ok] - getattr(tj, f)[tt.ok]).max()) for f in _POS_FIELDS + _GEOM_FIELDS
         if tt.ok.any()], default=0.0))
    for f in _POS_FIELDS + _GEOM_FIELDS:
        a, b = getattr(tt, f), getattr(tj, f)
        assert a.shape == b.shape == tt.ok.shape, f
        np.testing.assert_allclose(a[tt.ok], b[tt.ok], atol=tol, rtol=0, err_msg=f)


@pytest.mark.parametrize("prop", ["two_body", "n_body"])
def test_compute_ephemerides_for_results_matches_jax(eph_pair, prop):
    ej, et = eph_pair
    rj, rt = _requests(_config_pair(prop), extra=(("ZZ9", [57010.0]),))
    outj = j_ephemeris.compute_ephemerides_for_results(_fit_results(JLsqResult), rj, ej)
    outt = compute_ephemerides_for_results(_fit_results(LsqResult), rt, et, device="cpu")
    assert list(outt) == list(outj)
    for tid in outj:
        _assert_results_match(outt[tid], outj[tid], TOL[prop])
    assert {e.error for e in outt["BAD"]} == {"fit failed: NoViableOrbit(8)"}
    assert {e.error for e in outt["HYP"]} == {"InvalidOrbit(e=1.237 >= 1)"}
    assert {e.error for e in outt["NAN"]} == {"PropagationFailed or non-finite result", "UnknownObservatory(ZZ9)"}
    assert outfit_tpu_torch.FullOrbitResultExt is compute_ephemerides_for_results


@pytest.mark.parametrize("form", ["results", "table", "raw"])
@pytest.mark.parametrize("order", [1, 2], ids=["first", "second"])
def test_compute_ephemerides_batch_matches_jax(eph_pair, form, order):
    """The three input forms: a result map, an ``LsqTable`` taken
    column-wise, and raw ``(epoch, equinoctial)`` pairs (tuples and lists)."""
    ej, et = eph_pair
    rj, rt = _requests(_config_pair(order=order), extra=(("ZZ9", [57010.0]),))
    resj, rest = _fit_results(JLsqResult), _fit_results(LsqResult)
    if form == "table":
        resj, rest = JLsqTable.from_results(list(resj), resj), LsqTable.from_results(list(rest), rest)
    elif form == "raw":
        raw = {t: r for t, r in resj.items() if r.equinoctial is not None}
        resj = {t: (r.epoch, r.equinoctial) if k % 2 else [r.epoch, r.equinoctial] for k, (t, r) in enumerate(raw.items())}
        rest = dict(resj)
    tj = j_ephemeris.compute_ephemerides_batch(resj, rj, ej)
    tt = compute_ephemerides_batch(rest, rt, et, device="cpu")
    _assert_tables_match(tt, tj, TOL["two_body"])
    i = tt.traj_ids.index("T0")
    assert tt.ok[i, :6].all() and not tt.ok[i, 6] and not tt.ok[tt.traj_ids.index("HYP")].any()
    assert not tt.ok[tt.traj_ids.index("NAN")].any() and "NAN" not in tt.row_errors
    assert tt.row_errors["HYP"] == "InvalidOrbit(e=1.237 >= 1)"
    if form == "results":  # a table row carries its IOD failure's text
        assert tt.row_errors["BAD"] == "fit failed: NoViableOrbit(8)"


def test_compute_ephemerides_batch_nbody_matches_jax(eph_pair):
    ej, et = eph_pair
    rj, rt = _requests(_config_pair("n_body"))
    tj = j_ephemeris.compute_ephemerides_batch(_fit_results(JLsqResult), rj, ej)
    tt = compute_ephemerides_batch(_fit_results(LsqResult), rt, et, device="cpu")
    _assert_tables_match(tt, tj, TOL["n_body"])


@pytest.mark.parametrize("output", ["combined", "position", "geometry"])
def test_table_rows_match_the_per_orbit_api(eph_pair, output):
    """``EphemerisTable.result`` against ``compute_ephemerides_for_results``
    inside the port: the same entries, errors letter for letter, values at
    1e-13 (tests/test_ephemeris_api.py::test_matches_per_orbit_api's bar)."""
    _, et = eph_pair
    _, rt = _requests(output=output, extra=(("ZZ9", [57010.0]),))
    results = _fit_results(LsqResult)
    per_orbit = compute_ephemerides_for_results(results, rt, et, device="cpu")
    table = compute_ephemerides_batch(results, rt, et, device="cpu")
    assert len(table) == len(results) and table.n_pairs == len(rt)
    for tid in results:
        _assert_results_match(table[tid], per_orbit[tid], 1e-13)
    with pytest.raises(KeyError):
        table.result("nope")


def test_all_failed_batch_does_no_device_work(monkeypatch):
    """Every row a failed fit or a hyperbolic orbit: error rows with no
    table lookup (counted, and ``ephem=None`` would raise on one) and no
    device resolved."""
    calls = []
    monkeypatch.setattr(outfit_tpu_torch.ephem.api, "interpolate_body", lambda *a, **k: calls.append(a))
    monkeypatch.setattr(outfit_tpu_torch.ephemeris.batch, "resolve_device", lambda d=None: calls.append(d))
    rj, rt = _requests()
    mk = lambda cls: {
        "A": cls("A", ok=False, error="NoViableOrbit(3)"),
        "B": cls("B", ok=False, error="NoFeasibleTriplets"),
        "H": cls("H", ok=True, epoch=57000.0, equinoctial=np.array([2.0, 1.2, 0.3, 0.0, 0.0, 0.0])),
    }
    tj = j_ephemeris.compute_ephemerides_batch(mk(JLsqResult), rj, None)
    tt = compute_ephemerides_batch(mk(LsqResult), rt, None)
    assert not calls
    assert tt.row_errors == tj.row_errors and set(tt.row_errors) == {"A", "B", "H"}
    assert tt.ok.shape == (3, 6) and not tt.ok.any() and np.isnan(tt.ra).all()
    assert [e.error for e in tt.result("A")] == [e.error for e in tj.result("A")] == ["fit failed: NoViableOrbit(3)"] * 6
    failed = {t: r for t, r in mk(LsqResult).items() if not r.ok}
    per_orbit = compute_ephemerides_for_results(failed, rt, None, device="cpu")
    assert {e.error for e in per_orbit["B"]} == {"fit failed: NoFeasibleTriplets"} and not calls


def test_unrecognized_entries_raise(eph_pair):
    """The JAX package's messages; an unsized object array, where the JAX
    package raises Python's bare "len() of unsized object", raises the
    intended raw-elements message in the port."""
    ej, et = eph_pair
    rj, rt = _requests()
    for bad, match in (((57000.0, np.zeros(6), "extra"), "raw-elements entry"), (57000.0, "LsqResult-like")):
        with pytest.raises(TypeError, match=match) as ej_info:
            j_ephemeris.compute_ephemerides_batch({"A": bad}, rj, ej)
        with pytest.raises(TypeError, match=match) as et_info:
            compute_ephemerides_batch({"A": bad}, rt, et, device="cpu")
        assert str(et_info.value) == str(ej_info.value)
    unsized = np.array(None, dtype=object)
    with pytest.raises(TypeError, match="unsized object"):
        j_ephemeris.compute_ephemerides_batch({"A": unsized}, rj, ej)
    with pytest.raises(TypeError, match=r"results\['A'\]: raw-elements entry must be"):
        compute_ephemerides_batch({"A": unsized}, rt, et, device="cpu")


def test_to_dataframe(eph_pair):
    pytest.importorskip("pandas")
    ej, et = eph_pair
    rj, rt = _requests()
    dj = j_ephemeris.compute_ephemerides_batch(_fit_results(JLsqResult), rj, ej).to_dataframe()
    table = compute_ephemerides_batch(_fit_results(LsqResult), rt, et, device="cpu")
    dt = table.to_dataframe()
    assert list(dt.columns) == list(dj.columns) and len(dt) == len(table) * table.n_pairs
    assert (dt["traj_id"] == dj["traj_id"]).all() and (dt["ok"] == dj["ok"]).all() and (dt["observer"] == dj["observer"]).all()
    ok = dt["ok"].to_numpy()
    np.testing.assert_allclose(dt["ra"].to_numpy()[ok], dj["ra"].to_numpy()[ok], atol=1e-13, rtol=0)


# ---------------------------------------------------------------------------
# facade
# ---------------------------------------------------------------------------


def test_facade_exports_the_jax_names():
    for name in ("AberrationOrder", "EphemerisConfig", "ApparentPosition", "BodyGeometry", "EphemerisEntry",
                 "EphemerisResult", "EphemerisMode", "EphemerisRequest", "ObserverRequest", "Position", "Geometry",
                 "Combined", "compute_ephemeris", "FullOrbitResultExt"):
        assert getattr(outfit_tpu, name) is not None and hasattr(outfit_tpu_torch, name), name
        assert name in outfit_tpu_torch.__all__, name
    public = [n for n in vars(j_ephemeris) if not n.startswith("_") and not inspect.ismodule(getattr(j_ephemeris, n))]
    assert len(public) >= 14
    for name in public:
        assert hasattr(t_ephemeris, name), name
    assert (outfit_tpu_torch.Position, outfit_tpu_torch.Geometry, outfit_tpu_torch.Combined) == (
        outfit_tpu.Position, outfit_tpu.Geometry, outfit_tpu.Combined)


@pytest.mark.parametrize("name", ["compute_ephemeris", "compute_ephemerides_for_results", "compute_ephemerides_batch"])
def test_entry_points_take_the_jax_parameters_then_device(name):
    pj = list(inspect.signature(getattr(j_ephemeris, name)).parameters)
    pt = list(inspect.signature(getattr(t_ephemeris, name)).parameters)
    assert pt == pj + ["device"]
