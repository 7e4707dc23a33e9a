"""The cell ``mpcarc.escalating`` on the CPU at a small size: a sound run is
correct, the float32 control fails it, a traced run reads the escalation
flush's and the IOD scoring's metrics and checks every escalated row, the
work does not hang on the seed, and a stream that leaves its lean results
unpatched fails the escalated rows' check."""

import json
import os

import pytest
from conftest import ROOT

CELL = "mpcarc.escalating"
#: the traffic file's check with a sample as large as the small run
SAMPLE = 48
NEW_METRICS = ("escalated_share", "escalate_ms_per_kfit", "iod_scoring_ms_per_kfit")
ESCALATED = ("escalated_lost_convergence", "escalated_orbit_gap_sigma", "escalated_sigma_gap_rel",
             "escalated_rms_gap_rel")


def _overrides():
    with open(os.path.join(ROOT, "portbench", "workloads", f"{CELL}.json"), encoding="utf-8") as fh:
        traffic = json.load(fh)
    ck = traffic["check"]
    return {"sizes": {"n_traj": 16}, "check": dict(ck, sample=SAMPLE, iod=dict(ck["iod"], sample=SAMPLE))}


def _run(seed, trace=False):
    from portbench import harness

    return harness.run_cell(CELL, seed, 0.5, trace, devices=["cpu"], traffic_overrides=_overrides())


def _limits(over):
    ck = over["check"]
    return dict(ck["limits"], **ck["iod"]["limits"], **ck["escalated"]["limits"])


@pytest.fixture
def lean_fails(monkeypatch):
    """A lean IOD whose one triplet per arc spans the whole arc and may
    span at most 45 days: the rows of 2015AB and 33803 fail the lean stage
    and escalate, whichever seed orders them."""
    from portbench import harness

    resolve = harness.resolve

    def resolve_lean_fails(bench, cell):
        wl, config, traffic, driver = resolve(bench, cell)
        return wl, dict(config, iod=dict(config["iod"], max_obs_for_triplets=3, dt_max_triplet=45.0)), traffic, driver

    monkeypatch.setattr(harness, "resolve", resolve_lean_fails)


def test_a_sound_run_is_correct():
    result, numbers = _run(2**31 + 11)
    assert result["correct"], {n["name"]: (n["value"], n["limit"]) for n in numbers}
    assert result["failed"] == 0 and result["attempted"] == 3 * 16
    assert {"fits_per_s", "converged_frac", "setup_s"} <= set(result["metrics"])
    assert {"ref_iod_lost", "ref_iod_gap_sigma", "orbit_gap_sigma"} <= set(result["checks"])


def test_the_float32_control_fails_the_check():
    from portbench import control

    over = _overrides()
    got = control.readings(CELL, 2**31 + 12, 0.5, devices=["cpu"], overrides=over)
    limits = _limits(over)
    assert all(got["program"][k] <= v for k, v in limits.items() if k in got["program"]), got["program"]
    numbers = got["controls"]["reference.float32"]
    assert any(not numbers[k] <= v for k, v in limits.items() if k in numbers), numbers
    assert not numbers["ref_iod_gap_sigma"] <= limits["ref_iod_gap_sigma"]


def test_a_traced_run_reads_the_new_metrics_and_the_work_does_not_hang_on_the_seed(lean_fails):
    """With the lean stage of :func:`lean_fails`, every escalated row of
    the window is checked and passes."""
    a, _ = _run(2**31 + 13, trace=True)
    b, _ = _run(2**33 + 5, trace=True)
    for r in (a, b):
        assert r["correct"], r["checks"]
        assert set(ESCALATED) <= set(r["checks"]), r["checks"]
        for name in NEW_METRICS:
            value = r["metrics"][name]["value"]
            assert value is not None and value > 0, (name, value)
    # a third and more of the rows escalate (2015AB and 33803 are 2 of 3)
    assert a["metrics"]["escalated_share"]["value"] > 0.5
    # the same rows escalate and the same Newton steps run whatever the seed
    for name in ("newton_iters_per_fit", "escalated_share"):
        assert a["metrics"][name]["value"] == b["metrics"][name]["value"], name


def test_the_unpatched_control_fails_the_escalated_rows(lean_fails):
    """The program with no richer stage leaves the lean results of the
    escalated rows in place: the escalated rows' check fails it, where the
    sound run passes."""
    from portbench import control

    over = _overrides()
    got = control.readings(CELL, 2**31 + 14, 0.5, devices=["cpu"], overrides=over)
    limits = {k: v for k, v in _limits(over).items() if k in ESCALATED}
    assert all(got["program"][k] <= v for k, v in limits.items()), got["program"]
    numbers = got["controls"]["program.[]"]
    assert numbers["escalated_lost_convergence"] > limits["escalated_lost_convergence"], numbers
