"""Traced runs of the cells on the CPU at small sizes: the metrics read
from the program's own spans and counters (``outfit_tpu_torch.trace``),
and their readers' silence where the program has no such module."""

import types

import numpy as np
import pytest

from conftest import run_small

CELLS = ["shortarc.stream", "shortarc.propagate", "mpcarc.seeded"]

#: the metrics read from the program's own spans and counters
#: (``outfit_tpu_torch.trace``), per cell
PROGRAM_METRICS = {
    "shortarc.stream": ["prep_ms_per_kfit", "assembly_ms_per_kfit", "syncs_per_kfit", "fg_dispatch_ms_per_kfit",
                        "fg_live_share", "lsq_dispatch_ms_per_kfit"],
    "mpcarc.seeded": ["prep_ms_per_kfit", "assembly_ms_per_kfit", "syncs_per_kfit", "lsq_dispatch_ms_per_kfit"],
    "shortarc.propagate": ["dop853_live_share", "dop853_dispatch_ms_per_trip"],
}


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_the_programs_spans_and_counters(cell):
    from portbench import harness

    bench = harness.load_benchmark()
    listed = [m["name"] for m in bench["per_layer"] if m["name"] in sum(PROGRAM_METRICS.values(), [])
              and cell in m["workloads"]]
    assert sorted(listed) == sorted(PROGRAM_METRICS[cell])
    result, _ = run_small(cell, trace=True)
    assert result["correct"]
    for name in PROGRAM_METRICS[cell]:
        value = result["metrics"][name]["value"]
        assert value is not None and np.isfinite(value), name
        if name.endswith("_live_share"):
            assert 0 < value <= 1, (name, value)
        else:
            assert value > 0, (name, value)


def test_without_the_programs_trace_module_the_readers_hook_nothing(monkeypatch):
    """The parent of the change that added ``outfit_tpu_torch.trace`` runs
    the same metric files: they declare no hooks and read None there."""
    from portbench import program_counters

    monkeypatch.setattr(program_counters, "MODULE", "outfit_tpu_torch.no_such_module")
    assert program_counters.hooks("spans.fit.reads") == []
    run = types.SimpleNamespace(counts={}, records=[{"n": 10}])
    assert program_counters.deltas(run, []) is None
    monkeypatch.undo()
    assert program_counters.hooks("spans.fit.no_such_counter") == []
    assert program_counters.hooks("spans.fit.reads") == [("counter", "outfit_tpu_torch.trace:spans.fit.reads")]
