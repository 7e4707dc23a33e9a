"""Shared helpers of the benchmark's own tests (run on the CPU at small
sizes: ``python -m pytest portbench/tests -q``)."""

import copy
import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ.setdefault("OUTFIT_NO_DOWNLOAD", "1")

#: small sizes of each cell's traffic for a CPU run, and its devices
SMALL = {
    "shortarc.stream": ({"pool": 1, "sizes": {"n_traj": 64}}, 64, ["cpu"]),
    "shortarc.propagate": ({"lanes": {"n_lanes": 32, "t_min_days": 25.0, "t_max_days": 30.0, "population_seed": 3}}, 16, ["cpu"]),
    "mpcarc.seeded": ({"pool": 1, "sizes": {"n_traj": 48}}, 48, ["cpu"]),
}


def small_overrides(cell, **check):
    """The cell's traffic file with the small sizes and ``check`` keys
    replaced (the limits stay the file's)."""
    with open(os.path.join(ROOT, "portbench", "workloads", f"{cell}.json"), encoding="utf-8") as fh:
        traffic = json.load(fh)
    over, sample, _ = SMALL[cell]
    over = copy.deepcopy(over)
    over["check"] = dict(traffic["check"], sample=sample, **check)
    return over


def run_small(cell, seed=20260101, seconds=0.5, trace=False, **check):
    """One run of ``cell`` on the CPU at its small size: (result, numbers)."""
    from portbench import harness

    return harness.run_cell(cell, seed, seconds, trace, devices=SMALL[cell][2],
                            traffic_overrides=small_overrides(cell, **check))


@pytest.fixture
def cuda_device():
    """Skips the test without a CUDA card (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
