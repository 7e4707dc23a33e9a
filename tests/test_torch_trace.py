"""Spans and counters of ``outfit_tpu_torch.trace`` on the CPU.

* A fit's spans nest under its ``fit`` span, each inside its parent's
  interval, and share the ``fit`` span's id as their call id; the workers
  of a device split open theirs under the same ``fit``.
* Outside ``trace.recording()`` no span is kept; the counters count anyway.
* Results are bitwise the same with recording on and off: a seeded fit, an
  unseeded fit and a 32-lane ``propagate_nbody``.
* The DOP853 site counts the loop's trips (right-hand sides / 13), one exit
  read more, and a live-lane sum within lanes x trips.
* A split over ``["cpu", "cpu"]`` adds up to one device where a lane's
  count does not hang on its batch: the live lanes of the loops whose lanes
  each stop on their own test, the fit and its reads.  Each chunk's loop
  runs to its own slowest lane, so reads and trips are not additive.
* The counters lose no update when many threads read and nest spans.
"""

import contextvars
import dataclasses
import os
import sys
import threading

import numpy as np
import pytest
import torch

from outfit_tpu_torch import (
    DifferentialCorrectionConfig,
    ErrorModel,
    IODParams,
    JPLEphem,
    NBodyConfig,
    ObsDataset,
    fit_full_iod,
    fit_lsq,
    propagate_nbody,
    trace,
)
from outfit_tpu_torch.elements.types import EquinoctialElements
from outfit_tpu_torch.propagator import dop853_integrate

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SMALL = dict(n_noise_realizations=2, max_triplets=3)

pytestmark = pytest.mark.filterwarnings("ignore:observatory .* SOLVED")


@pytest.fixture(scope="module")
def eph():
    return JPLEphem.analytic(53500.0, 61500.0)


@pytest.fixture(scope="module")
def seeds(eph):
    """The float64 IOD of ``_tiled(n)``, the seeds of the seeded fits, by ``n``."""
    em = ErrorModel.fcct14()
    return {n: fit_full_iod(_tiled(n), eph, IODParams(**SMALL), 42, error_model=em, device="cpu") for n in (1, 32)}


def _tiled(n):
    """``n`` trajectories of 8467, copy j without its first j observations."""
    base = ObsDataset.from_mpc_80_col(os.path.join(DATA, "8467.obs"))
    parts = [base.subset(np.arange(j % 8, len(base))) for j in range(n)]
    return ObsDataset.concat(parts, rename=lambda k, t: f"{k}|{t}")


def _fit(eph, seeds, kind, device="cpu", n=1):
    em = ErrorModel.fcct14()
    if kind == "seeded":
        return fit_lsq(_tiled(n), eph, IODParams(**SMALL), DifferentialCorrectionConfig(), error_model=em,
                       initial_orbits=seeds[n], device=device)
    mixed = dict(precision="mixed")
    return fit_lsq(_tiled(n), eph, IODParams(**SMALL, **mixed), DifferentialCorrectionConfig(**mixed), 42,
                   error_model=em, device=device)


def _lanes(n):
    rng = np.random.default_rng(3)
    e, w = rng.uniform(0.0, 0.35, n), rng.uniform(0, 2 * np.pi, n)
    cols = [np.full(n, 57000.0), rng.uniform(1.2, 3.5, n), e * np.sin(w), e * np.cos(w),
            rng.uniform(-0.15, 0.15, n), rng.uniform(-0.15, 0.15, n), rng.uniform(0, 2 * np.pi, n)]
    return EquinoctialElements(*(torch.as_tensor(c) for c in cols)), torch.as_tensor(57000.0 + rng.uniform(-30, 30, n))


def _propagate(eph):
    eq, t1 = _lanes(32)
    return propagate_nbody(eq, t1, eph, NBodyConfig.with_planets(), device="cpu")


def _delta(before, after):
    return {kind: {name: {k: after[kind][name][k] - v for k, v in c.items()} for name, c in group.items()}
            for kind, group in before.items()}


def _counted(fn):
    """(fn(), the counters' change over it)."""
    before = trace.counters()
    out = fn()
    return out, _delta(before, trace.counters())


def _same(a, b):
    """Bitwise equality of results (dicts, dataclasses, arrays, tensors)."""
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if dataclasses.is_dataclass(a):
        return type(a) is type(b) and all(_same(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a))
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, (np.ndarray, torch.Tensor)):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    if isinstance(a, float):
        return np.float64(a).tobytes() == np.float64(b).tobytes()
    return a == b


@pytest.mark.parametrize("kind", ["unseeded", "seeded"])
def test_spans_nest_under_one_fit(eph, seeds, kind):
    with trace.recording() as records:
        _fit(eph, seeds, kind)
    by_id = {r.id: r for r in records}
    (top,) = [r for r in records if r.parent is None]
    assert top.name == "fit" and len(by_id) == len(records)
    assert all(r.call == top.id for r in records)
    for r in records:
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns, (r, p)
    names = {r.name for r in records}
    parents = {(r.name, by_id[r.parent].name) for r in records if r.parent is not None}
    assert {("observer_cache", "fit"), ("correct", "fit"), ("fit.assemble", "fit"), ("fit.prepare", "fit")} <= parents
    if kind == "unseeded":
        assert {("iod", "fit"), ("iod.fg_correction", "iod")} <= parents
    else:
        assert not names & {"iod", "iod.fg_correction"}
    assert names <= set(trace.SPAN_NAMES) and "propagate" not in names


def test_recording_off_keeps_nothing_and_counts_all_the_same(eph, seeds):
    with trace.recording() as before:
        pass
    _, d = _counted(lambda: _fit(eph, seeds, "seeded"))
    with trace.recording() as inner_done:
        with trace.recording() as inner:
            with trace.span("fit"):
                pass
    assert before == [] and inner_done == [] and [r.name for r in inner] == ["fit"]
    assert d["spans"]["fit"]["calls"] == 1 and d["spans"]["correct"]["calls"] == 1
    assert d["spans"]["fit"]["reads"] == sum(s["reads"] for s in d["sites"].values()) > 0
    assert d["sites"]["lsq_newton"]["trips"] > 0 and d["sites"]["lsq_copyback"]["reads"] == 6


@pytest.mark.parametrize("kind", ["seeded", "unseeded", "propagate"])
def test_results_are_bitwise_the_same_with_recording_on(eph, seeds, kind):
    run = (lambda: _propagate(eph)) if kind == "propagate" else (lambda: _fit(eph, seeds, kind))
    off = run()
    with trace.recording() as records:
        on = run()
    assert records and _same(off, on)


def test_dop853_site_counts_the_loops_trips():
    calls = []

    def rhs(t, y):
        calls.append(1)
        return torch.stack([y[..., 1], -y[..., 0]], dim=-1)

    n = 32
    y0 = torch.stack([torch.ones(n, dtype=torch.float64), torch.zeros(n, dtype=torch.float64)], dim=-1)
    t1 = torch.linspace(0.5, 20.0, n, dtype=torch.float64)
    res, d = _counted(lambda: dop853_integrate(rhs, y0, 0.0, t1, rtol=1e-10, atol=1e-10))
    site, span = d["sites"]["dop853"], d["spans"]["dop853"]
    trips = len(calls) // 13
    assert len(calls) == 13 * trips and trips >= int(res.n_steps.max())
    assert site["trips"] == trips and site["reads"] == trips + 1
    assert site["lanes"] == n * trips and 0 < site["live"] <= site["lanes"]
    assert span["calls"] == 1 and span["reads"] == site["reads"] and span["blocked_ns"] == site["blocked_ns"]


def test_propagate_counts_trips_and_nests_dop853(eph, monkeypatch):
    from outfit_tpu_torch.propagator import nbody

    calls = []
    orig = nbody._acceleration_and_gradient

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(nbody, "_acceleration_and_gradient", counted)
    with trace.recording() as records:
        _, d = _counted(lambda: _propagate(eph))
    site = d["sites"]["dop853"]
    assert len(calls) == 13 * site["trips"] and site["lanes"] == 32 * site["trips"]
    assert 0 < site["live"] / site["lanes"] <= 1
    (prop,) = [r for r in records if r.name == "propagate"]
    (dop,) = [r for r in records if r.name == "dop853"]
    assert prop.parent is None and dop.parent == prop.id and dop.call == prop.id
    assert d["spans"]["propagate"]["reads"] >= d["spans"]["dop853"]["reads"] == site["reads"]


#: exit tests whose lanes each stop on their own test, in a loop entered
#: once per call: a lane's live trips do not hang on its batch
LANE_LOCAL = ("lsq_prewarm", "lsq_newton", "lsq_outlier", "lsq_passes", "iod_aberth", "iod_fg")


@pytest.mark.parametrize("kind", ["unseeded", "seeded"])
def test_a_split_adds_up_to_one_device(eph, seeds, kind):
    one, d1 = _counted(lambda: _fit(eph, seeds, kind, "cpu", n=32))
    with trace.recording() as records:
        two, d2 = _counted(lambda: _fit(eph, seeds, kind, ["cpu", "cpu"], n=32))
    assert _same(one, two)
    for site in LANE_LOCAL:
        assert d1["sites"][site]["live"] == d2["sites"][site]["live"], site
    assert d1["sites"]["lsq_newton"]["live"] > 0
    assert d1["spans"]["fit"]["calls"] == d2["spans"]["fit"]["calls"] == 1
    assert (d1["spans"]["correct"]["calls"], d2["spans"]["correct"]["calls"]) == (1, 2)
    for d in (d1, d2):
        assert d["spans"]["fit"]["reads"] == sum(s["reads"] for s in d["sites"].values())
    (top,) = [r for r in records if r.name == "fit"]
    workers = [r for r in records if r.name == "correct"]
    assert len(workers) == 2 and all(r.parent == top.id and r.call == top.id for r in workers)
    assert {r.thread for r in workers} != {top.thread}


def test_threads_lose_no_count():
    site, n_threads, n_reads = trace.sites.stumpff_kmax, 12, 300
    x = torch.tensor(3)
    before = trace.counters()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.span("fit"):

            def work():
                for _ in range(n_reads):
                    with trace.span("correct"):
                        assert site.item(x) == 3

            threads = [threading.Thread(target=contextvars.copy_context().run, args=(work,)) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    d = _delta(before, trace.counters())
    total = n_threads * n_reads
    assert d["sites"]["stumpff_kmax"]["reads"] == total
    assert d["spans"]["correct"]["calls"] == d["spans"]["correct"]["reads"] == total
    assert d["spans"]["fit"]["calls"] == 1 and d["spans"]["fit"]["reads"] == total
