"""``LsqTable``, ``as_table=True`` and the result properties of the PyTorch
port against the JAX package.

* The table from hand-built rows (tests/test_lsq.py::TestLsqTable,
  ::TestPatchRow, ::TestTableStatusConvention): every column bitwise equal
  to the JAX table's on the same rows, and rows materialize as the JAX
  table materializes them, except where the two packages differ on
  purpose: a row stored with ``ok=False`` whose IOD succeeded stays
  ``ok=False`` on the port (the JAX table returns it as ``ok=True``,
  ``outfit_tpu/lsq/table.py:161``).
* ``fit_lsq(..., as_table=True)`` materializes exactly its dict results,
  and agrees with the JAX package's table at the fixture bars of
  tests/test_torch_lsq.py.
* ``LsqResult``/``FitResult`` properties against the JAX ones on the same
  values: rtol 1e-12 (the covariance at its matrix scale).
"""

import dataclasses
import os
import typing

import numpy as np
import pytest
import torch

from outfit_tpu.ephem import JPLEphem as JJPLEphem
from outfit_tpu.iod import IODParams as JIODParams
from outfit_tpu.iod.api import FitResult as JFitResult
from outfit_tpu.lsq import DifferentialCorrectionConfig as JConfig
from outfit_tpu.lsq import fit_lsq as j_fit_lsq
from outfit_tpu.lsq.api import LsqResult as JLsqResult
from outfit_tpu.lsq.table import LsqTable as JLsqTable
from outfit_tpu.observations import ErrorModel as JErrorModel
from outfit_tpu.observations import ObsDataset as JObsDataset
from outfit_tpu.observations.observatories import Observer as JObserver
import outfit_tpu_torch
from outfit_tpu_torch import (
    DifferentialCorrectionConfig,
    ErrorModel,
    FitResult,
    IODParams,
    JPLEphem,
    LsqResult,
    LsqTable,
    ObsDataset,
    fit_lsq,
)
from outfit_tpu_torch.lsq.api import _fit_lsq
from outfit_tpu_torch.lsq.table import IOD_HOST_SCREENED, IOD_OK
from outfit_tpu_torch.observations.observatories import Observer

from test_torch_iod import jax_draws

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SPAN = (53500.0, 61500.0)
SMALL = dict(n_noise_realizations=3, max_triplets=4)

pytestmark = pytest.mark.filterwarnings("ignore:observatory .* SOLVED")

#: rows whose materialization differs between the packages on purpose
DIFFERS = ("REFIT", "SEEDNF")


def _rows(fit_cls, lsq_cls):
    """Hand-built rows covering every branch of the table (identical values
    for both packages)."""
    rng = np.random.default_rng(1)
    a = rng.normal(size=(6, 6))
    cov = a @ a.T * 1e-12

    def iod(tid, **kw):
        d = dict(ok=True, rms=0.7, corrected=True, epoch=57000.25, kind=0, elements=np.arange(1.0, 7.0),
                 equinoctial=np.linspace(2.0, 3.0, 6))
        d.update(kw)
        return fit_cls(tid, **d)

    return {
        "CONV": lsq_cls("CONV", ok=True, status=1, normalised_rms=0.5, epoch=57000.25, equinoctial=np.arange(6.0),
                        covariance=cov, uncertainties=np.sqrt(np.diag(cov)), n_active_obs=10,
                        total_newton_iterations=4, iod=iod("CONV")),
        "FELL": lsq_cls("FELL", ok=True, error="BizarreOrbit", status=2, fell_back_to_iod=True, normalised_rms=0.7,
                        epoch=57000.25, equinoctial=np.linspace(2.0, 3.0, 6), n_active_obs=12,
                        iod=iod("FELL", kind=1, corrected=False)),
        "DIVG": lsq_cls("DIVG", ok=True, error="DifferentialCorrectionDiverged", fell_back_to_iod=True,
                        normalised_rms=2.0, epoch=57000.0, equinoctial=np.ones(6)),
        "DEAD": lsq_cls("DEAD", ok=False, error="IOD failed: NoViableOrbit(16)",
                        iod=fit_cls("DEAD", ok=False, error="NoViableOrbit(16)")),
        "BARE": lsq_cls("BARE", ok=False, error="IOD failed: x"),
        "SEEDNF": lsq_cls("SEEDNF", ok=False, error="IOD seed not finite",
                          iod=iod("SEEDNF", equinoctial=np.array([2.0, np.nan, 0, 0, 0, 1.0]))),
        "REFIT": lsq_cls("REFIT", ok=False, error="refit failed", iod=iod("REFIT")),
    }


def _columns(table):
    return [f.name for f in dataclasses.fields(table) if f.name not in ("host_errors", "_tid_index")]


def _same(x, y):
    if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        return True
    return x == y or (x != x and y != y)


def _assert_result_equal(a, b, tid):
    for f in ("ok", "error", "status", "fell_back_to_iod", "normalised_rms", "epoch", "n_active_obs",
              "total_newton_iterations"):
        assert _same(getattr(a, f), getattr(b, f)), (tid, f, getattr(a, f), getattr(b, f))
    for f in ("equinoctial", "covariance", "uncertainties"):
        va, vb = getattr(a, f), getattr(b, f)
        assert (va is None) == (vb is None), (tid, f)
        if va is not None:
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb), err_msg=f"{tid}.{f}")
    assert (a.iod is None) == (b.iod is None), tid
    if a.iod is not None:
        for f in ("ok", "error", "rms", "corrected", "epoch", "kind", "elements", "equinoctial"):
            va, vb = getattr(a.iod, f), getattr(b.iod, f)
            assert (va is None) == (vb is None), (tid, "iod." + f)
            if va is not None:
                assert _same(va, vb), (tid, "iod." + f)


def test_table_from_results_matches_jax():
    rt, rj = _rows(FitResult, LsqResult), _rows(JFitResult, JLsqResult)
    tt, tj = LsqTable.from_results(list(rt), rt), JLsqTable.from_results(list(rj), rj)
    assert _columns(tt) == _columns(tj)
    for name in _columns(tt):
        a, b = getattr(tt, name), getattr(tj, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, name
        assert _same(a, b), name
    np.testing.assert_array_equal(tt.covariance, tj.covariance)
    for tid in rt:
        a, b = tt.result(tid), tj.result(tid)
        if tid in DIFFERS:
            # the port keeps the stored ok flag and the row's error text;
            # the JAX table returns the kept row with a good IOD as ok=True
            assert (a.ok, a.error, b.ok) == (False, rt[tid].error, True), tid
            assert a.iod.ok and b.iod.ok
            continue
        _assert_result_equal(a, b, tid)
    # round trip of every row that has an IOD stage
    back = tt.to_results()
    assert list(back) == list(rt)
    for tid, r in rt.items():
        if r.iod is not None:
            _assert_result_equal(back[tid], r, tid)


def test_table_status_convention():
    """tests/test_lsq.py::TestTableStatusConvention on the port."""
    t = LsqTable.from_results(*(lambda r: (list(r), r))(_rows(FitResult, LsqResult)))
    get = {tid: int(t.status[i]) for i, tid in enumerate(t.traj_ids)}
    assert (get["CONV"], get["FELL"], get["DIVG"], get["DEAD"], get["REFIT"]) == (1, 2, 3, -1, -1)


def test_patch_row_clears_stale_columns_and_keeps_lookup():
    """tests/test_lsq.py::TestPatchRow on the port, against the JAX table
    patched the same way."""
    rt, rj = _rows(FitResult, LsqResult), _rows(JFitResult, JLsqResult)
    tt, tj = LsqTable.from_results(list(rt), rt), JLsqTable.from_results(list(rj), rj)
    assert tt.iod_ok[0] and tt.iod_error_code[0] == IOD_OK and tt.kept[0]
    with pytest.raises(KeyError):
        tt.result("NOPE")
    tt.patch_row("CONV", LsqResult("CONV", ok=False, error="refit failed"))
    tj.patch_row("CONV", JLsqResult("CONV", ok=False, error="refit failed"))
    tt.patch_row("DEAD", rt["FELL"])
    tj.patch_row("DEAD", rj["FELL"])
    i = tt.traj_ids.index("CONV")
    assert not tt.iod_ok[i] and tt.iod_error_code[i] == IOD_HOST_SCREENED and not tt.kept[i]
    assert np.isnan(tt.iod_rms[i]) and np.isnan(tt.iod_elements[i]).all() and np.isnan(tt.iod_equinoctial[i]).all()
    assert tt.iod_kind[i] == -1 and not tt.iod_corrected[i] and not tt.result("CONV").ok
    for name in _columns(tt):
        assert _same(getattr(tt, name), getattr(tj, name)), name
    for tid in ("CONV", "DEAD", "FELL", "DIVG"):
        _assert_result_equal(tt.result(tid), tj.result(tid), tid)
    with pytest.raises(KeyError):
        tt.result("NOPE")


def _mixed_dataset(ds_cls, obs_cls):
    """tests/test_lsq.py::TestLsqTable._mixed_dataset: a real arc, a 2-obs
    trajectory (no feasible triplet) and a nonsense one (no viable orbit)."""
    ds = ds_cls.from_mpc_80_col(os.path.join(DATA, "8467.obs"))
    geo = obs_cls.geocenter()
    for t in (57000.0, 57000.01):
        ds.push_observation("SHORT", t, 1.0, 0.2, 1e-6, 1e-6, geo)
    for t in np.linspace(0, 30, 8):
        ds.push_observation("ZERO", 57000.0 + t, 0.0, 0.0, 1e-6, 1e-6, geo)
    return ds


def test_fit_lsq_as_table_matches_dict_and_jax():
    teph, jeph = JPLEphem.analytic(*SPAN), JJPLEphem.analytic(*SPAN)
    p = IODParams(**SMALL)
    args = (teph, p, DifferentialCorrectionConfig(), 42, None, ErrorModel.fcct14(), None, None, "cpu",
            jax_draws(42, p))
    ref = _fit_lsq(_mixed_dataset(ObsDataset, Observer), *args)
    tab = _fit_lsq(_mixed_dataset(ObsDataset, Observer), *args, as_table=True)
    assert isinstance(tab, LsqTable) and tab.traj_ids == ["8467", "SHORT", "ZERO"]
    assert not ref["SHORT"].ok and "NoFeasibleTriplets" in ref["SHORT"].error
    assert not tab.kept[1] and tab.converged[0]
    back = tab.to_results()
    for tid in ref:
        _assert_result_equal(back[tid], ref[tid], tid)
    np.testing.assert_array_equal(tab.covariance[0], ref["8467"].covariance)
    df = tab.to_dataframe()
    assert len(df) == 3 and bool(df.converged[0]) and np.isnan(df.eq_a[1])

    tj = j_fit_lsq(_mixed_dataset(JObsDataset, JObserver), jeph, JIODParams(**SMALL), JConfig(), 42,
                   error_model=JErrorModel.fcct14(), mesh=None, as_table=True)
    assert tj.traj_ids == tab.traj_ids
    # the JAX fused table runs a row whose IOD failed through the kernel
    # with an inert seed (kept, a status and counts); the port's, built by
    # from_results, leaves it at the inert fill: rows are compared where
    # the IOD succeeded
    good = tj.iod_ok
    np.testing.assert_array_equal(tab.iod_ok, good)
    np.testing.assert_array_equal(tab.ok, tj.ok)
    for name in ("kept", "converged", "fell_back_to_iod", "status", "n_active_obs",
                 "total_newton_iterations", "iod_kind", "iod_corrected", "iod_epoch"):
        np.testing.assert_array_equal(getattr(tab, name)[good], getattr(tj, name)[good], err_msg=name)
    for name, rtol in (("equinoctial", 1e-6), ("iod_equinoctial", 1e-9), ("iod_rms", 2e-9),
                       ("normalised_rms", 1e-6), ("covariance_tri", 1e-5)):
        np.testing.assert_allclose(getattr(tab, name)[good], getattr(tj, name)[good], rtol=rtol, atol=0, err_msg=name)
    for tid in tab.traj_ids:  # the same error texts, whatever the code column says
        assert tab.result(tid).error == tj.result(tid).error, tid

    # keplerian_covariance of the fixture fit: the JAX fit's values through
    # the port's property at rtol 1e-12 (the transform), and the two fits'
    # properties at the covariance's own bar
    rj = tj.result("8467")
    kcj = np.asarray(rj.keplerian_covariance)
    same = LsqResult("8467", ok=True, status=1, epoch=rj.epoch, equinoctial=np.asarray(rj.equinoctial),
                     covariance=np.asarray(rj.covariance))
    np.testing.assert_allclose(same.keplerian_covariance, kcj, rtol=1e-12, atol=1e-12 * np.abs(kcj).max())
    np.testing.assert_allclose(ref["8467"].keplerian_covariance, kcj, rtol=1e-5, atol=1e-5 * np.abs(kcj).max())


def test_result_properties_match_jax():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(6, 6))
    cov = a @ a.T * 1e-12
    eq = np.array([2.4, 0.05, -0.12, 0.03, 0.08, 1.9])
    kw = dict(ok=True, status=1, normalised_rms=0.6, epoch=57010.5, equinoctial=eq, covariance=cov,
              uncertainties=np.sqrt(np.diag(cov)))
    rt, rj = LsqResult("X", **kw), JLsqResult("X", **kw)
    assert rt.orbit_quality == rj.orbit_quality == 0.6
    for ft, fj in zip(rt.keplerian, rj.keplerian):
        np.testing.assert_allclose(float(ft), float(fj), rtol=1e-12)
    for ft, fj in zip(rt.orbital_elements, rj.orbital_elements):
        assert float(ft) == float(fj)
    kc, kcj = rt.keplerian_covariance, rj.keplerian_covariance
    assert kc.shape == (6, 6)
    np.testing.assert_allclose(kc, kcj, rtol=1e-12, atol=1e-12 * np.abs(kcj).max())
    np.testing.assert_allclose(rt.keplerian_uncertainties, rj.keplerian_uncertainties, rtol=1e-12)

    iod_kw = dict(ok=True, rms=1.5, epoch=57010.0, elements=np.array([0.9, 1.3, 0.2, 1.0, 2.0, 0.4]))
    fell = dict(ok=True, fell_back_to_iod=True, normalised_rms=1.5, epoch=57010.0, equinoctial=eq)
    assert (LsqResult("F", **fell, iod=FitResult("F", **iod_kw)).orbit_quality
            == JLsqResult("F", **fell, iod=JFitResult("F", **iod_kw)).orbit_quality == 1.5)
    assert LsqResult("N", ok=False).keplerian_covariance is None
    for kind in (0, 1):
        ft, fj = FitResult("I", kind=kind, **iod_kw), JFitResult("I", kind=kind, **iod_kw)
        assert ft.orbit_quality == fj.orbit_quality == 1.5
        assert type(ft.orbital_elements).__name__ == type(fj.orbital_elements).__name__
        np.testing.assert_array_equal(np.array(ft.orbital_elements, float), np.array(fj.orbital_elements, float))
        assert (ft.keplerian is None) == (fj.keplerian is None) == (kind == 1)


def test_facade_aliases():
    import outfit_tpu.iod.api as jiod

    assert outfit_tpu_torch.GaussResult is FitResult and outfit_tpu_torch.DifferentialCorrectionOutput is LsqResult
    assert outfit_tpu_torch.IODRMS is jiod.IODRMS is float
    assert typing.get_args(outfit_tpu_torch.FullOrbitResult) == (str, FitResult)
    assert outfit_tpu_torch.LsqTable is LsqTable and outfit_tpu_torch.fit_lsq is fit_lsq
    ds = ObsDataset.from_mpc_80_col(os.path.join(DATA, "8467.obs"))
    kw = dict(seed=3, error_model=ErrorModel.fcct14(), device="cpu")
    a = outfit_tpu_torch.fit_full_iod_parallel(ds, JPLEphem.analytic(*SPAN), IODParams(n_noise_realizations=1), **kw)
    b = outfit_tpu_torch.fit_full_iod(ds, JPLEphem.analytic(*SPAN), IODParams(n_noise_realizations=1), **kw)
    assert a["8467"].rms == b["8467"].rms
