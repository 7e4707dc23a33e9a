"""The metric ``fg_kernel_share``: the f-g correction kernel's launches over
the calls of the program's span ``iod.fg_correction``, and its silence on a
program without the kernel's launch counter."""

import types

import pytest

from conftest import run_small


def _metric():
    from portbench import harness

    return harness.module("metrics", "fg_kernel_share")


@pytest.mark.parametrize("kernel", ["outfit_tpu_torch.iod.no_such_module", "outfit_tpu_torch.trace"])
def test_without_the_kernels_counter_it_hooks_nothing_and_reads_none(kernel, monkeypatch):
    """No such module, or a module without ``launches``: no hooks, None."""
    m = _metric()
    assert m.hooks(kernel) == []
    monkeypatch.setattr(m, "HOOKS", m.hooks(kernel))
    assert m.read(types.SimpleNamespace(counts={}, records=[{"n": 10}])) is None


def test_it_reads_launches_over_the_spans_calls():
    m = _metric()
    assert m.HOOKS == [("counter", "outfit_tpu_torch.iod.fg_correction_cuda:launches"),
                       ("counter", "outfit_tpu_torch.trace:spans.iod_fg_correction.calls")]
    counts = {m.HOOKS[0][1]: 6, m.HOOKS[1][1]: 8}
    assert m.read(types.SimpleNamespace(counts=counts, records=[])) == 0.75
    counts[m.HOOKS[1][1]] = 0
    assert m.read(types.SimpleNamespace(counts=counts, records=[])) is None


def test_a_traced_stream_run_on_the_cpu_reads_no_launch():
    """On the CPU every call takes the plain loop: 0 launches a call."""
    result, _ = run_small("shortarc.stream", trace=True)
    assert result["correct"]
    assert result["metrics"]["fg_kernel_share"]["value"] == 0.0
