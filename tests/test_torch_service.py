"""The service modes of the PyTorch port: ``fit_lsq_stream``,
``fit_full_iod_stream``, ``fit_lsq_escalating`` and
``fit_lsq_stream_escalating``, and the ``ObsDataset`` methods they use.

* The streams are scheduling only: each dataset's results are bitwise those
  of a sequential fit (tests/test_lsq.py::TestStreamPipeline,
  tests/test_iod.py::TestIodStream); ``slim_fetch`` gives the float32
  rounding of the covariance, the 1-sigma values and the IOD reporting
  values, with LSQ elements, RMS and status exact; ``minimal_fetch`` needs
  ``as_table`` and blanks only the converged rows' IOD element columns.
* Escalation (tests/test_lsq.py::TestEscalation) against the JAX package
  with its draws injected, including the ``"<k>|<tid>"`` noise ids of
  escalated rows, at the fixture bars of tests/test_torch_lsq.py (elements
  rtol 1e-6 / atol 1e-9, IOD RMS rtol 2e-9); port-only properties bitwise.
* The dataset methods against the JAX ones: identical arrays.
"""

import copy
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from outfit_tpu.elements.types import KeplerianElements as JKep
from outfit_tpu.ephem import JPLEphem as JJPLEphem
from outfit_tpu.iod import IODParams as JIODParams
from outfit_tpu.lsq import DifferentialCorrectionConfig as JConfig
from outfit_tpu.lsq.api import fit_lsq_escalating as j_fit_lsq_escalating
from outfit_tpu.lsq.api import fit_lsq_stream_escalating as j_fit_lsq_stream_escalating
from outfit_tpu.observations import ObsDataset as JObsDataset
from outfit_tpu_torch import (
    DifferentialCorrectionConfig,
    ErrorModel,
    IODParams,
    JPLEphem,
    LsqTable,
    ObsDataset,
    fit_full_iod,
    fit_full_iod_stream,
    fit_lsq,
    fit_lsq_escalating,
    fit_lsq_stream,
    fit_lsq_stream_escalating,
    trace,
)
from outfit_tpu_torch.lsq.api import _fit_lsq, _fit_lsq_escalating, _fit_lsq_stream_escalating
from outfit_tpu_torch.observations.observatories import Observer

from test_lsq import _EPOCHS, _KEP_TRUE, _synth_dataset
from test_torch_iod import jax_draws
from test_torch_table import _assert_result_equal, _columns

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SPAN = (53500.0, 61500.0)
NAMES = ("2015AB", "8467", "33803")
SMALL = dict(n_noise_realizations=2, max_triplets=3)

pytestmark = pytest.mark.filterwarnings("ignore:observatory .* SOLVED")


@pytest.fixture(scope="module")
def teph():
    return JPLEphem.analytic(*SPAN)


@pytest.fixture(scope="module")
def jeph():
    return JJPLEphem.analytic(*SPAN)


def _fixture(name, cls=ObsDataset):
    return cls.from_mpc_80_col(os.path.join(DATA, f"{name}.obs"))


# ---------------------------------------------------------------------------
# dataset methods
# ---------------------------------------------------------------------------


def test_dataset_concat_and_groups_match_jax():
    """tests/test_observations.py::TestConcatAndCompact and
    ::TestSubsetAndCacheInvalidation on the port, against the JAX methods."""
    tp = [_fixture(n) for n in ("8467", "8467", "2015AB")]
    jp = [_fixture(n, JObsDataset) for n in ("8467", "8467", "2015AB")]
    m = ObsDataset.concat(tp, rename=lambda k, t: f"{k}|{t}")
    mj = JObsDataset.concat(jp, rename=lambda k, t: f"{k}|{t}")
    assert m.traj_ids == mj.traj_ids == ["0|8467", "1|8467", "2|K09R05F"]
    for f in ("mjd_tt", "ra", "dec", "ra_error", "dec_error", "traj_index", "observer_index", "mag", "catalog"):
        np.testing.assert_array_equal(getattr(m, f), getattr(mj, f), err_msg=f)
    assert [o.code for o in m.observers] == [o.code for o in mj.observers]
    assert len(set(map(id, m.observers))) == len(m.observers) < sum(len(d.observers) for d in tp)
    for (ta, ga), (tb, gb) in zip(m.trajectory_groups(), mj.trajectory_groups()):
        assert ta == tb
        np.testing.assert_array_equal(ga, gb)
    assert [m.len_trajectory(t) for t in m.traj_ids] == [mj.len_trajectory(t) for t in mj.traj_ids]
    assert ObsDataset.concat([]).traj_ids == [] and m.invalidate_caches() is m
    # subset keeps every column; compact_observers keeps the referenced ones
    idx = m.trajectory_obs_indices("2|K09R05F")[2:5]
    sub, subj = m.subset(idx), mj.subset(idx)
    np.testing.assert_array_equal(sub.catalog, m.catalog[idx])
    c, cj = sub.compact_observers(), subj.compact_observers()
    np.testing.assert_array_equal(c.observer_index, cj.observer_index)
    assert [o.code for o in c.observers] == [o.code for o in cj.observers]
    assert {int(i) for i in c.observer_index} == set(range(len(c.observers)))
    for j in range(len(sub)):
        assert c.observers[c.observer_index[j]] == sub.observers[sub.observer_index[j]]
    empty = ObsDataset()
    empty.traj_ids = ["E"]
    assert [(t, g.size) for t, g in empty.trajectory_groups()] == [("E", 0)]


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sequential(teph):
    p, cfg = IODParams(**SMALL), DifferentialCorrectionConfig()
    return {n: fit_lsq(_fixture(n), teph, p, cfg, 42, error_model=ErrorModel.fcct14(), device="cpu") for n in NAMES}


@pytest.mark.parametrize("mode", [dict(depth=2), dict(depth=1), dict(depth=3, prefetch=False)])
def test_stream_equals_sequential(teph, sequential, mode):
    datasets = [_fixture(n) for n in NAMES]
    out = list(fit_lsq_stream(iter(datasets), teph, IODParams(**SMALL), DifferentialCorrectionConfig(), 42,
                              error_model=ErrorModel.fcct14(), device="cpu", **mode))
    assert [id(d) for d, _ in out] == [id(d) for d in datasets]
    for (_, res), name in zip(out, NAMES):
        ref = sequential[name]
        assert list(res) == list(ref)
        for tid in res:
            _assert_result_equal(res[tid], ref[tid], tid)


def test_stream_slim_and_minimal_contracts(teph, sequential):
    p, cfg = IODParams(**SMALL), DifferentialCorrectionConfig()
    kw = dict(error_model=ErrorModel.fcct14(), device="cpu")
    with pytest.raises(ValueError, match="as_table"):
        fit_lsq_stream([_fixture("8467")], teph, p, cfg, 42, minimal_fetch=True, **kw)
    ((_, slim),) = fit_lsq_stream([_fixture("8467")], teph, p, cfg, 42, slim_fetch=True, **kw)
    ref = sequential["8467"]
    for tid, a in slim.items():
        b = ref[tid]
        assert (a.ok, a.fell_back_to_iod, a.error, a.status) == (b.ok, b.fell_back_to_iod, b.error, b.status)
        np.testing.assert_array_equal(a.equinoctial, b.equinoctial)
        assert a.normalised_rms == b.normalised_rms and a.covariance.dtype == np.float64
        np.testing.assert_array_equal(a.covariance, b.covariance.astype(np.float32).astype(np.float64))
        np.testing.assert_allclose(a.uncertainties, b.uncertainties, rtol=2e-7)
        assert a.iod.rms == np.float32(b.iod.rms) and a.iod.epoch == b.iod.epoch
        np.testing.assert_array_equal(a.iod.elements, b.iod.elements.astype(np.float32).astype(np.float64))
        np.testing.assert_array_equal(a.iod.equinoctial, b.iod.equinoctial)

    datasets = [_fixture(n) for n in NAMES]
    full = [t for _, t in fit_lsq_stream(datasets, teph, p, cfg, 42, as_table=True, **kw)]
    mini = [t for _, t in fit_lsq_stream([_fixture(n) for n in NAMES], teph, p, cfg, 42, as_table=True,
                                         minimal_fetch=True, **kw)]
    for f, m, name in zip(full, mini, NAMES):
        assert isinstance(m, LsqTable) and m.traj_ids == f.traj_ids
        for res_tid in f.traj_ids:
            _assert_result_equal(f.result(res_tid), sequential[name][res_tid], res_tid)
        for col in ("kept", "iod_ok", "iod_rms", "ok", "converged", "status", "normalised_rms", "equinoctial",
                    "covariance_tri", "uncertainties", "n_active_obs"):
            np.testing.assert_array_equal(getattr(f, col), getattr(m, col), err_msg=col)
        used = m.iod_ok & ~m.converged
        np.testing.assert_array_equal(f.iod_equinoctial[used], m.iod_equinoctial[used])
        assert np.isnan(m.iod_equinoctial[m.converged]).all() and np.isnan(m.iod_elements[m.converged]).all()


def test_seeded_fit_keeps_the_callers_seeds_and_its_table_is_its_dict(teph):
    """A seeded fit's rows carry the caller's own FitResult objects (None
    where it gave no seed), and its table is ``LsqTable.from_results`` of
    its dict, column for column, error texts included."""
    def dataset():
        return ObsDataset.concat([_fixture(n) for n in NAMES])

    kw = dict(error_model=ErrorModel.fcct14(), device="cpu")
    seeds = fit_full_iod(dataset(), teph, IODParams(**SMALL), 42, **kw)
    tids = list(seeds)
    del seeds[tids[0]]  # no seed
    seeds[tids[1]].equinoctial = np.where(np.arange(6) == 2, np.nan, seeds[tids[1]].equinoctial)  # not finite
    res = fit_lsq(dataset(), teph, initial_orbits=seeds, **kw)
    assert sorted(res) == sorted(tids) and list(res)[:2] == tids[:2]
    assert all(res[tid].iod is seeds.get(tid) for tid in tids)
    assert res[tids[0]].error == "IOD failed: no IOD seed" and res[tids[1]].error == "IOD seed not finite"
    assert res[tids[2]].ok
    tab = fit_lsq(dataset(), teph, initial_orbits=seeds, as_table=True, **kw)
    ref = LsqTable.from_results(tab.traj_ids, res)
    for name in _columns(tab) + ["host_errors"]:
        x, y = getattr(tab, name), getattr(ref, name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name
        else:
            assert x == y, name


def test_iod_stream_equals_sequential(teph):
    p = IODParams(**SMALL)
    datasets = [_fixture(n) for n in NAMES]
    out = list(fit_full_iod_stream(iter(datasets), teph, p, 5, error_model=ErrorModel.fcct14(), device="cpu"))
    assert [id(d) for d, _ in out] == [id(d) for d in datasets]
    for ds, res in out:
        ref = fit_full_iod(_fixture(NAMES[[id(d) for d in datasets].index(id(ds))]), teph, p, 5,
                           error_model=ErrorModel.fcct14(), device="cpu")
        assert list(res) == list(ref)
        for tid in res:
            a, b = res[tid], ref[tid]
            assert (a.ok, a.error, a.rms, a.kind, a.epoch) == (b.ok, b.error, b.rms, b.kind, b.epoch)
            np.testing.assert_array_equal(a.equinoctial, b.equinoctial)


# ---------------------------------------------------------------------------
# escalation
# ---------------------------------------------------------------------------


def _to_port(jds):
    """A JAX-package dataset as a port dataset (same columns)."""
    ds = ObsDataset()
    for f in ("mjd_tt", "ra", "dec", "ra_error", "dec_error", "traj_index", "observer_index", "mag", "catalog"):
        setattr(ds, f, np.array(getattr(jds, f)))
    ds.traj_ids = list(jds.traj_ids)
    ds.observers = [Observer(**dataclasses.asdict(o)) for o in jds.observers]
    return ds


@functools.lru_cache(maxsize=None)
def _two_traj_built(shift):
    jeph = JJPLEphem.analytic(*SPAN)
    ds = _synth_dataset(jeph, JKep(*map(jnp.float64, _KEP_TRUE)), _EPOCHS + shift,
                        noise=int(5 + shift * 100), tid="A")
    kep_b = JKep(*map(jnp.float64, (57000.0, 1.7, 0.25, 0.3, 2.2, 0.4, 1.5)))
    return _synth_dataset(jeph, kep_b, _EPOCHS + 0.37 + shift, noise=int(9 + shift * 100), tid="B", ds=ds)


def _two_traj(jeph, shift=0.0):
    """tests/test_lsq.py::TestEscalation: A (q ~ 1.96 AU) and B (q ~ 1.28 AU),
    a fresh copy (the fits set the sigmas in place)."""
    return copy.deepcopy(_two_traj_built(shift))


#: stage 0 rejects A at the perihelion cap; both stages draw alike, so one
#: injected JAX draw source serves both
ESC = dict(n_noise_realizations=2, max_triplets=3)


def _assert_lsq_close(b, a, tid):
    for f in ("ok", "fell_back_to_iod", "status", "error", "n_active_obs"):
        assert getattr(b, f) == getattr(a, f), (tid, f, getattr(b, f), getattr(a, f))
    if a.ok:
        np.testing.assert_allclose(b.equinoctial, np.asarray(a.equinoctial), rtol=1e-6, atol=1e-9, err_msg=tid)
        np.testing.assert_allclose(b.iod.rms, a.iod.rms, rtol=2e-9, err_msg=tid)


def test_escalating_matches_jax_and_its_stages(jeph, teph):
    stages_t = [(IODParams(**ESC, max_perihelion_au=1.6), DifferentialCorrectionConfig()),
                (IODParams(**ESC), DifferentialCorrectionConfig())]
    stages_j = [(JIODParams(**ESC, max_perihelion_au=1.6), JConfig()), (JIODParams(**ESC), JConfig())]
    draws = jax_draws(42, stages_t[1][0])
    res = _fit_lsq_escalating(_to_port(_two_traj(jeph)), teph, stages_t, 42, None, None, None, "cpu", draws)
    ref = j_fit_lsq_escalating(_two_traj(jeph), jeph, stages_j, seed=42, mesh=None)
    assert list(res) == list(ref) == ["A", "B"] and res["A"].ok and res["B"].ok
    for tid in ref:
        _assert_lsq_close(res[tid], ref[tid], tid)
    # per row, what the stages give when called by hand (batch isolation)
    ds = _to_port(_two_traj(jeph))
    lean = _fit_lsq(_to_port(_two_traj(jeph)), teph, *stages_t[0], 42, None, None, None, None, "cpu", draws)
    assert not lean["A"].ok
    rich_a = _fit_lsq(ds.subset(ds.trajectory_obs_indices("A")), teph, *stages_t[1], 42, None, None, None, None,
                      "cpu", draws)
    _assert_result_equal(res["A"], rich_a["A"], "A")
    _assert_result_equal(res["B"], lean["B"], "B")
    single = fit_lsq_escalating(_to_port(_two_traj(jeph)), teph, stages_t[1:], 42, device="cpu")
    plain = fit_lsq(_to_port(_two_traj(jeph)), teph, *stages_t[1], 42, device="cpu")
    for tid in ("A", "B"):
        _assert_result_equal(single[tid], plain[tid], tid)


def test_stream_escalating_matches_jax(jeph, teph):
    """Two datasets, one flush: A fails the lean stage in both and is refitted
    under the ids "0|A" and "1|A", whose JAX draws the port must use."""
    stages_t = [(IODParams(**ESC, max_perihelion_au=1.6), DifferentialCorrectionConfig()),
                (IODParams(**ESC), DifferentialCorrectionConfig())]
    stages_j = [(JIODParams(**ESC, max_perihelion_au=1.6), JConfig()), (JIODParams(**ESC), JConfig())]
    draws = jax_draws(42, stages_t[1][0])
    shifts = (0.0, 0.05)
    out = list(_fit_lsq_stream_escalating([_to_port(_two_traj(jeph, s)) for s in shifts], teph, stages_t, 42, None,
                                          None, None, 2, "cpu", draws))
    ref = list(j_fit_lsq_stream_escalating([_two_traj(jeph, s) for s in shifts], jeph, stages_j, seed=42, mesh=None,
                                           flush_every=2))
    assert len(out) == len(ref) == 2
    for (_, tab), (_, tj) in zip(out, ref):
        assert isinstance(tab, LsqTable) and tab.traj_ids == tj.traj_ids == ["A", "B"]
        for tid in tab.traj_ids:
            _assert_lsq_close(tab.result(tid), tj.result(tid), tid)
        assert tab.result("A").ok and tab.result("B").ok


def test_stream_escalating_dicts_are_its_tables_and_rows_the_rich_stage(jeph, teph):
    """Three held datasets sharing the ids A and B, their observations out
    of epoch order, flushed two then one; A fails the lean stage in each.
    ``as_table=False`` yields exactly the tables' ``to_results()``, and each
    escalated row is bitwise ``fit_lsq`` of its flush's renamed failures
    under the rich stage."""
    stages = [(IODParams(**ESC, max_perihelion_au=1.6), DifferentialCorrectionConfig()),
              (IODParams(**ESC), DifferentialCorrectionConfig())]
    shifts = (0.0, 0.05, 0.11)

    def datasets():
        out = []
        for s in shifts:
            ds = _to_port(_two_traj(jeph, s))
            out.append(ds.subset(np.random.default_rng(int(s * 100) + 1).permutation(len(ds))))
        assert not all((np.diff(d.mjd_tt) >= 0).all() for d in out)
        return out

    kw = dict(device="cpu", flush_every=2)
    lean = [t for _, t in fit_lsq_stream(datasets(), teph, *stages[0], 42, as_table=True, device="cpu")]
    failed = [[tid for tid, c in zip(t.traj_ids, t.converged) if not c] for t in lean]
    assert all("A" in f for f in failed)
    before = trace.escalation.rows
    tables = list(fit_lsq_stream_escalating(datasets(), teph, stages, 42, **kw))
    assert trace.escalation.rows - before == sum(map(len, failed))
    dicts = list(fit_lsq_stream_escalating(datasets(), teph, stages, 42, as_table=False, **kw))
    for (_, tab), (_, res) in zip(tables, dicts):
        assert isinstance(tab, LsqTable) and isinstance(res, dict)
        ref = tab.to_results()
        assert list(res) == list(ref) == ["A", "B"]
        for tid in ref:
            _assert_result_equal(res[tid], ref[tid], tid)
            assert res[tid].traj_id == tid and res[tid].iod.traj_id == tid
    for group in ((0, 1), (2,)):
        held = [datasets()[j] for j in group]
        cur = ObsDataset.concat(
            [d.subset(np.concatenate([d.trajectory_obs_indices(t) for t in failed[j]])) for d, j in zip(held, group)],
            rename=lambda k, tid: f"{k}|{tid}")
        rich = fit_lsq(cur, teph, *stages[1], 42, device="cpu")
        for k, j in enumerate(group):
            for tid in failed[j]:
                _assert_result_equal(tables[j][1].result(tid), rich[f"{k}|{tid}"], (j, tid))
    assert all(t.result("A").ok for _, t in tables)


def test_stream_escalating_refit_fill_and_retry_predicates(jeph, teph):
    """refit_fill changes nothing on the port; a user retry_if sees every
    row (converged ones included) under its clean id, through three stages
    (tests/test_lsq.py::TestEscalation's two retry_if tests)."""
    lean = IODParams(n_noise_realizations=0)
    reject_a = IODParams(n_noise_realizations=0, max_perihelion_au=1.6)
    rich = IODParams(n_noise_realizations=0, max_triplets=12)
    cfg = DifferentialCorrectionConfig()
    kw = dict(device="cpu", flush_every=2)
    datasets = lambda: [_to_port(_two_traj(jeph, s)) for s in (0.0, 0.05, 0.11)]  # noqa: E731
    stages = [(reject_a, cfg), (lean, cfg)]
    a = list(fit_lsq_stream_escalating(datasets(), teph, stages, 42, **kw))
    b = list(fit_lsq_stream_escalating(datasets(), teph, stages, 42, refit_fill=0, **kw))
    assert len(a) == 3
    for (_, ta), (_, tb) in zip(a, b):
        for tid in ("A", "B"):
            _assert_result_equal(ta.result(tid), tb.result(tid), tid)
        assert ta.result("A").ok

    seen = []

    def retry(r):
        seen.append(r.traj_id)
        return r.traj_id == "A"

    ((_, res),) = fit_lsq_stream_escalating([_to_port(_two_traj(jeph))], teph, [(lean, cfg), (reject_a, cfg)], 42,
                                           retry_if=retry, device="cpu")
    assert set(seen) == {"A", "B"}
    i = res.traj_ids.index("A")
    assert not res.result("A").ok and not res.iod_ok[i] and not res.kept[i]
    assert np.isnan(res.iod_elements[i]).all() and res.result("B").ok

    ((_, res3),) = fit_lsq_stream_escalating([_to_port(_two_traj(jeph))], teph,
                                            [(lean, cfg), (reject_a, cfg), (rich, cfg)], 42,
                                            retry_if=lambda r: r.traj_id == "A", device="cpu")
    ds = _to_port(_two_traj(jeph))
    solo = fit_lsq(ds.subset(ds.trajectory_obs_indices("A")), teph, rich, cfg, 42, device="cpu")["A"]
    assert res3.result("A").ok
    np.testing.assert_array_equal(res3.result("A").equinoctial, solo.equinoctial)


def test_device_constant_upload_is_shared_across_threads():
    """16 threads (more than the cores) ask for the same new constant with a
    short switch interval: one upload, one tensor for all."""
    import sys
    import threading

    from outfit_tpu_torch.utils import tensors

    const = np.linspace(0.0, 1.0, 5)
    barrier = threading.Barrier(16)
    got = []

    def work():
        barrier.wait(timeout=60)
        got.append(tensors.device_constant(const, "cpu", torch.float32))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and len(got) == 16
    assert all(g is got[0] for g in got) and got[0].dtype == torch.float32
