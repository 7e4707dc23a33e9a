"""Whole runs of the cells on the CPU at small sizes: the result line, the
refusal without a card, the import check, the controls and the faults
that the check has to catch (no cell spans chips, so no exchange between
them can be left out)."""

import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest

from conftest import ROOT, run_small, small_overrides

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
CELLS = ["shortarc.stream", "shortarc.propagate", "mpcarc.seeded"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct_with_the_contract_keys(cell):
    result, numbers = run_small(cell)
    assert set(result) == KEYS and list(result)[-1] == "checks"
    assert result["correct"], {n["name"]: (n["value"], n["limit"]) for n in numbers}
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) >= {"setup_s"} and len(result["metrics"]) >= 2
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("cell", ["shortarc.propagate", "mpcarc.seeded"])
def test_a_traced_run_reports_layer_metrics_and_a_breakdown(cell):
    result, _ = run_small(cell, trace=True)
    assert set(result) == KEYS | {"breakdown"} and list(result)[-1] == "checks"
    assert "setup_s" not in result["metrics"] and result["metrics"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_without_a_card_the_run_fails_and_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "mpcarc.seeded", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True)
    assert p.returncode != 0 and '"correct"' not in p.stdout


def test_outside_a_checkout_the_run_fails(tmp_path):
    import shutil

    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "mpcarc.seeded", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path, env=env, capture_output=True, text=True)
    assert p.returncode != 0 and '"correct"' not in p.stdout


def test_import_check_compares_whole_top_level_names(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "outfit_tpu_torch_extra", sys)
    assert "outfit_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "outfit_tpu.constants", sys)
    assert harness.forbidden_modules() == ["outfit_tpu"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    over = json.dumps(small_overrides("mpcarc.seeded"))
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "from portbench import harness\n"
            "r, _ = harness.run_cell('mpcarc.seeded', 3, 0.5, False, devices=['cpu'], traffic_overrides=json.loads(%r))\n"
            "print(harness.forbidden_modules(), r['correct'])" % (ROOT, over))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True).stdout
    assert out.strip().splitlines()[-1] == "[] True"


@pytest.mark.parametrize("cell", ["shortarc.stream", "shortarc.propagate", "mpcarc.seeded"])
def test_the_control_fails_the_check(cell):
    """Each lower-precision control (the reference in float32, the
    program's mixed path) fails at least one number that the program's own
    run passes."""
    from portbench import control

    over = small_overrides(cell)
    got = control.readings(cell, 20260202, 0.5, devices=["cpu"], overrides=over)
    limits = over["check"]["limits"]
    assert all(got["program"][k] <= v for k, v in limits.items() if k in got["program"]), got["program"]
    assert len(got["controls"]) == len(over["check"]["controls"])
    for name, numbers in got["controls"].items():
        assert any(not numbers[k] <= v for k, v in limits.items() if k in numbers), (name, numbers)


# -- faults planted underneath a run -------------------------------------------


def _unchanged_step(monkeypatch):
    from outfit_tpu_torch.lsq import loop

    orig = loop.single_iteration

    def stuck(elements_vec, *a, **k):
        res = orig(elements_vec, *a, **k)
        return res._replace(corrected=elements_vec)

    monkeypatch.setattr(loop, "single_iteration", stuck)


def _unchanged_integration(monkeypatch):
    from outfit_tpu_torch.propagator import nbody

    orig = nbody.dop853_integrate

    def stuck(rhs, y0, t0, t1, **k):
        res = orig(rhs, y0, t0, t1, **k)
        return res._replace(y=y0)

    monkeypatch.setattr(nbody, "dop853_integrate", stuck)


def _half_the_batch(monkeypatch):
    """Only the first half of the rows is fitted; the second half carries
    the first half's fits."""
    from outfit_tpu_torch.lsq import api

    orig = api._add_results

    def half(results, rows, parts, valid_all, row_of):
        orig(results, rows, parts, valid_all, row_of)
        n = len(rows) // 2
        for (tid, _), (src, _) in zip(rows[n:], rows[:n]):
            results[tid] = api.dataclasses.replace(results[src], traj_id=tid)

    monkeypatch.setattr(api, "_add_results", half)


def _half_the_lanes(monkeypatch):
    from outfit_tpu_torch.propagator import nbody

    orig = nbody.propagate_nbody

    def half(eq, t1, *a, **k):
        res = orig(eq, t1, *a, **k)
        n = res.status.shape[0] // 2
        status = res.status.clone()
        status[n:] = 1
        return res._replace(status=status)

    import portbench.drivers.propagate  # noqa: F401
    import outfit_tpu_torch

    monkeypatch.setattr(outfit_tpu_torch, "propagate_nbody", half)


def _altered_answer(monkeypatch):
    from outfit_tpu_torch.lsq import api

    orig = api._correct

    def altered(*a, **k):
        arrays, prewarm = orig(*a, **k)
        arrays[1] = arrays[1] * (1 + 1e-6)
        return arrays, prewarm

    monkeypatch.setattr(api, "_correct", altered)


def _altered_position(monkeypatch):
    from outfit_tpu_torch.propagator import nbody

    orig = nbody.dop853_integrate

    def altered(*a, **k):
        res = orig(*a, **k)
        return res._replace(y=res.y * (1 + 1e-7))

    monkeypatch.setattr(nbody, "dop853_integrate", altered)


def _altered_velocity_partials(monkeypatch):
    """The velocity half of the state transition matrix altered."""
    import outfit_tpu_torch

    orig = outfit_tpu_torch.propagate_nbody

    def altered(*a, **k):
        res = orig(*a, **k)
        return res._replace(dvel_delem=res.dvel_delem * (1 + 1e-6))

    monkeypatch.setattr(outfit_tpu_torch, "propagate_nbody", altered)


FAULTS = [
    ("shortarc.stream", _unchanged_step), ("shortarc.stream", _half_the_batch), ("shortarc.stream", _altered_answer),
    ("mpcarc.seeded", _unchanged_step), ("mpcarc.seeded", _half_the_batch), ("mpcarc.seeded", _altered_answer),
    ("shortarc.propagate", _unchanged_integration), ("shortarc.propagate", _half_the_lanes),
    ("shortarc.propagate", _altered_position), ("shortarc.propagate", _altered_velocity_partials),
]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__.strip('_')}" for c, f in FAULTS])
def test_a_planted_fault_makes_the_run_incorrect(cell, fault, monkeypatch):
    fault(monkeypatch)
    result, numbers = run_small(cell)
    assert not result["correct"], {n["name"]: (n["value"], n["limit"]) for n in numbers}


def test_sample_is_drawn_from_the_seed():
    from portbench import checks

    class R:
        seed = 5

    a = checks.sample_rows(R, [10, 20, 30], 12)
    assert a == checks.sample_rows(R, [10, 20, 30], 12) and len(set(a)) == 12
    R.seed = 6
    assert a != checks.sample_rows(R, [10, 20, 30], 12)
    assert all(0 <= i < [10, 20, 30][b] for b, i in a) and np.all(np.diff([b * 100 + i for b, i in a]) > 0)


def test_the_stream_window_holds_whole_passes_in_the_seeds_order(monkeypatch):
    from portbench.drivers import stream

    handed = []

    def slow(run, feed):
        for ds in feed:
            time.sleep(0.003)
            handed.append(ds)
            yield ds, None

    # a dataset is named by its place in the pool, whatever its place in
    # the window: the same names, so the same IOD noise draws, every pass
    monkeypatch.setattr(stream, "_dataset", lambda d, k: k)
    monkeypatch.setattr(stream, "_stream", slow)
    pool = [{"mjd": np.zeros((2, 3))} for _ in range(3)]
    run = types.SimpleNamespace(state=dict(pool=pool, order=[2, 0, 1]))
    records = stream.window(run, time.perf_counter() + 0.004)
    assert [r["index"] for r in records] == handed == [2, 0, 1]
    handed.clear()
    records = stream.window(run, time.perf_counter() + 0.011)
    assert [r["index"] for r in records] == handed == [2, 0, 1] * 2


def test_the_seed_orders_the_stream_pool_and_keeps_its_datasets():
    from portbench import harness
    from portbench.drivers import stream

    bench = harness.load_benchmark()
    wl, config, traffic, _ = harness.resolve(bench, "shortarc.stream")
    traffic = dict(traffic, pool=6, sizes={"n_traj": 3})
    states = [stream.setup(harness.Run("shortarc.stream", s, 1.0, False, bench, wl, config, traffic, ["cpu"]))
              for s in (2**31 + 5, 2**31 + 5, 2**31 + 6)]
    assert states[0]["order"] == states[1]["order"] != states[2]["order"]
    assert sorted(states[0]["order"]) == sorted(states[2]["order"]) == list(range(6))
    for a, c in zip(states[0]["pool"], states[2]["pool"]):
        np.testing.assert_array_equal(a["ra"], c["ra"])


def test_a_seeded_fit_over_every_device_is_correct():
    """``"devices": "all"`` hands the program ``device=None``, its default
    (here the CPU; on a node, every card)."""
    from portbench import harness

    over = dict(small_overrides("mpcarc.seeded"), devices="all")
    result, numbers = harness.run_cell("mpcarc.seeded", 20260303, 0.5, False, devices=["cpu"],
                                       traffic_overrides=over)
    assert result["correct"], {n["name"]: (n["value"], n["limit"]) for n in numbers}


def test_split_serial_share_reads_the_wall_outside_the_workers():
    from portbench import harness

    mod = harness.module("metrics", "split_serial_share")
    run = types.SimpleNamespace(spans={mod.HOOKS[0][1]: [0.25, 0.5]}, t_start=0.0, t_end=1.0, window_s=1.0)
    assert mod.read(run) == pytest.approx(0.25)
    assert mod.read(types.SimpleNamespace(spans={}, window_s=1.0)) is None
