"""``fit_lsq_stream_escalating`` at real cadence on the CPU: its flush's span
and counts, the IOD scoring's span, and the benchmark's plain reference
pipeline (``portbench/iod_check.py``: Gauss's method, then the
correction) against its converged rows.

* ``escalation.rows`` counts the rows the default predicate retries after
  the lean stage, 0 when none fails; ``escalation.recovered`` those of them
  the rich stage converges; ``escalation.flushes`` each flush of held
  datasets.
* The span ``escalate`` encloses the refit's fits; the span ``iod.scoring``
  opens inside ``iod`` once per scoring (twice per mixed IOD chunk: the
  candidates, then the polished winners; once in float64).
* Results are bitwise the same inside ``trace.recording()`` and outside.
* On a 48-row tiling of the real arcs with the benchmark's two stages, the
  reference pipeline fits every row and lands where the program's
  converged rows land, within a hundredth of their standard deviation.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from outfit_tpu_torch import (  # noqa: E402
    DifferentialCorrectionConfig,
    ErrorModel,
    IODParams,
    JPLEphem,
    ObsDataset,
    Observer,
    fit_full_iod,
    fit_lsq_stream,
    fit_lsq_stream_escalating,
    trace,
)
from outfit_tpu_torch.lsq.api import _default_retry  # noqa: E402
from portbench import iod_check  # noqa: E402
from portbench.drivers import common  # noqa: E402
from portbench.drivers.seeded import _dataset  # noqa: E402
from portbench.traffic import mpc  # noqa: E402

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
with open(os.path.join(ROOT, "portbench", "configs", "mpcarc_unseeded.json"), encoding="utf-8") as fh:
    CONFIG = json.load(fh)
#: the benchmark's lean and rich stages
STAGES = [common.settings(s) for s in [CONFIG] + CONFIG["escalation"]["stages"]]
MIXED = dict(precision="mixed")
SMALL = [(IODParams(n_noise_realizations=0, max_triplets=2, **MIXED), DifferentialCorrectionConfig(**MIXED)),
         (IODParams(n_noise_realizations=0, max_triplets=4, **MIXED), DifferentialCorrectionConfig(**MIXED))]
#: a lean IOD that forms no triplet (its one candidate, the first, middle
#: and last observations, spans more than a day): every row fails it
NO_TRIPLET = IODParams(n_noise_realizations=0, max_obs_for_triplets=3, dt_max_triplet=1.0, **MIXED)

pytestmark = pytest.mark.filterwarnings("ignore:observatory .* SOLVED")


@pytest.fixture(scope="module")
def eph():
    return JPLEphem.analytic(53500.0, 61500.0)


def _arcs(n, short=0):
    """``n`` trajectories of 8467, copy j without its first j % 8
    observations, then ``short`` copies of its first two observations (no
    triplet: they fail every stage); FCCT14 sigmas."""
    base = ObsDataset.from_mpc_80_col(os.path.join(DATA, "8467.obs"))
    parts = [base.subset(np.arange(j % 8, len(base))) for j in range(n)]
    parts += [base.subset(np.arange(2)) for _ in range(short)]
    ds = ObsDataset.concat(parts, rename=lambda k, t: f"{k}|{t}")
    ds.apply_error_model(ErrorModel.fcct14())
    return ds


def _stream(eph, datasets, stages, **kw):
    return list(fit_lsq_stream_escalating(datasets, eph, stages, 42, flush_every=2, device="cpu",
                                          **dict(dict(slim_fetch=True, minimal_fetch=True), **kw)))


def _counted(fn):
    """(fn(), the change of ``trace.escalation``'s counts over it)."""
    names = trace.escalation.fields
    before = [getattr(trace.escalation, f) for f in names]
    out = fn()
    return out, {f: getattr(trace.escalation, f) - b for f, b in zip(names, before)}


def _same(a, b):
    for name in ("traj_ids", "status", "converged", "equinoctial", "covariance", "normalised_rms", "epoch"):
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert x.shape == y.shape and (np.array_equal(x, y) or np.array_equal(x, y, equal_nan=True)), name


def test_escalated_rows_are_the_rows_the_default_predicate_retries(eph):
    """Two datasets, each with two rows no stage can fit: one flush, the
    four rows handed to the rich stage, none recovered."""
    lean = list(fit_lsq_stream([_arcs(4, 2), _arcs(3, 2)], eph, *SMALL[0], 42, slim_fetch=True, as_table=True,
                               minimal_fetch=True, device="cpu"))
    retried = sum(_default_retry(t.result(tid)) for _, t in lean for tid in t.traj_ids)
    out, d = _counted(lambda: _stream(eph, [_arcs(4, 2), _arcs(3, 2)], SMALL))
    assert retried == 4 and d == {"flushes": 1, "rows": 4, "recovered": 0}
    assert [int((~np.asarray(t.converged)).sum()) for _, t in out] == [2, 2]


def test_nothing_escalates_when_nothing_fails(eph):
    out, d = _counted(lambda: _stream(eph, [_arcs(3), _arcs(2), _arcs(2)], SMALL))
    assert d == {"flushes": 2, "rows": 0, "recovered": 0}
    assert all(np.asarray(t.converged).all() for _, t in out)


def test_a_forced_failure_the_rich_stage_converges_is_recovered(eph):
    """A lean IOD that forms no triplet fails every row; the rich stage
    fits them all but the two short ones."""
    stages = [(NO_TRIPLET, SMALL[0][1]), SMALL[1]]
    out, d = _counted(lambda: _stream(eph, [_arcs(3, 1), _arcs(2, 1)], stages))
    converged = sum(int(np.asarray(t.converged).sum()) for _, t in out)
    assert converged == 5 and d == {"flushes": 1, "rows": 7, "recovered": 5}


def test_the_escalate_span_encloses_the_refits_fits(eph):
    stages = [(NO_TRIPLET, SMALL[0][1]), SMALL[1]]
    with trace.recording() as rec:
        _stream(eph, [_arcs(2)], stages)
    by_id = {r.id: r for r in rec}
    (esc,) = [r for r in rec if r.name == "escalate"]
    fits = [r for r in rec if r.name == "fit"]
    assert len(fits) == 2 and esc.parent is None
    inner = [f for f in fits if f.parent == esc.id]
    assert len(inner) == 1 and esc.start_ns <= inner[0].start_ns <= inner[0].end_ns <= esc.end_ns
    assert all(by_id[r.parent].name == "iod" for r in rec if r.name == "iod.scoring")


@pytest.mark.parametrize("precision,per_chunk", [("mixed", 2), ("f64", 1)])
def test_iod_scoring_opens_inside_the_iod_span_per_scoring(eph, precision, per_chunk):
    params = IODParams(n_noise_realizations=1, max_triplets=2, precision=precision)
    with trace.recording() as rec:
        fit_full_iod(_arcs(3), eph, params, 42, device="cpu")
    (iod,) = [r for r in rec if r.name == "iod"]
    scoring = [r for r in rec if r.name == "iod.scoring"]
    assert len(scoring) == per_chunk and all(r.parent == iod.id for r in scoring)


def test_results_are_bitwise_with_and_without_recording(eph):
    stages = [(NO_TRIPLET, SMALL[0][1]), SMALL[1]]
    plain = _stream(eph, [_arcs(3, 1), _arcs(2)], stages)
    with trace.recording():
        kept = _stream(eph, [_arcs(3, 1), _arcs(2)], stages)
    for (_, a), (_, b) in zip(plain, kept):
        _same(a, b)


def test_the_reference_pipeline_agrees_with_the_escalating_stream(eph):
    """48 rows of the benchmark's real-arc tiling, its lean and rich stages,
    its analytic ephemeris span: the reference's Gauss then correction on
    every row, against the program's converged rows (the gap's largest
    over the rows, not a quantile)."""
    d = mpc.tiling(2**31 + 7, 0, CONFIG["observations"]["fixtures"], 48, 0)
    st = d["stations"]
    d["observers"] = [Observer.from_parallax(st["longitude"][k], st["rho_cos_phi"][k], st["rho_sin_phi"][k], code=c)
                      for k, c in enumerate(st["codes"])]
    d["traj_ids"] = [f"U{t:06d}" for t in range(48)]
    eph_bench = JPLEphem.analytic(*CONFIG["ephemeris"]["span_mjd"])
    ((_, table),) = list(fit_lsq_stream_escalating([_dataset(d)], eph_bench, STAGES, CONFIG["fit_seed"],
                                                   flush_every=3, device="cpu", **CONFIG["stream"]))
    rows = common.rows_from_table(table)
    assert rows["converged"].all()
    lean = CONFIG["correction"]
    limits = {"ref_iod_lost": 0.0, "ref_iod_gap_sigma": 0.01}
    run = types.SimpleNamespace(seed=1, config={"correction": lean}, traffic={"check": {
        "rms_max": 3.0, "quantile": 1.0, "iod": {"sample": 48, "limits": limits}}})
    numbers = {n["name"]: n for n in iod_check.check(run, [(rows, d)])}
    assert all(n["ok"] for n in numbers.values()), numbers
    # every row's reference pipeline fitted: the largest gap is finite
    assert np.isfinite(numbers["ref_iod_gap_sigma"]["value"])


def test_the_reference_triplet_stays_inside_the_iods_widest_span():
    """2015AB's 1,981 days: the widest triplet of its downsample within
    150 days; 8467's 40 days: first, middle and last."""
    bases = mpc.fixtures(["2015AB", "8467"])
    for b, n in zip(bases, (37, 61)):
        assert len(b["mjd"]) == n
    width = 61
    mjd = np.stack([np.pad(b["mjd"], (0, width - len(b["mjd"])), mode="edge") for b in bases])
    (i, j, k), (a, m, z) = iod_check.triplet(mjd, [37, 61])
    t = bases[0]["mjd"]
    assert 0 < t[k] - t[i] <= 150 and t[i] < t[j] < t[k] and t[k] - t[i] > 40
    assert (a, z) == (0, 60) and 0 < m < 60
    assert IODParams().dt_max_triplet == iod_check.SPAN_MAX
