"""The metric ``lsq_kernel_share``: the two-body step kernel's launches over
the program's count of two-body Newton steps, and its silence on a program
without the kernel's launch counter or without the count."""

import types

import pytest

from conftest import run_small


def _metric():
    from portbench import harness

    return harness.module("metrics", "lsq_kernel_share")


@pytest.mark.parametrize("kernel", ["outfit_tpu_torch.lsq.no_such_module", "outfit_tpu_torch.trace"])
def test_without_the_kernels_counter_it_hooks_nothing_and_reads_none(kernel, monkeypatch):
    """No such module, or a module without ``launches``: no hooks, None."""
    m = _metric()
    assert m.hooks(kernel) == []
    monkeypatch.setattr(m, "HOOKS", m.hooks(kernel))
    assert m.read(types.SimpleNamespace(counts={}, records=[{"n": 10}])) is None


def test_without_the_step_count_it_hooks_nothing(monkeypatch):
    """A program whose trace module lacks ``lsq_step`` (the parent's): no
    hooks, None."""
    from outfit_tpu_torch import trace

    m = _metric()
    monkeypatch.delattr(trace, "lsq_step")
    assert m.hooks() == []
    monkeypatch.setattr(m, "HOOKS", m.hooks())
    assert m.read(types.SimpleNamespace(counts={}, records=[])) is None


def test_it_reads_launches_over_the_two_body_steps():
    m = _metric()
    assert m.HOOKS == [("counter", "outfit_tpu_torch.lsq.step_cuda:launches"),
                       ("counter", "outfit_tpu_torch.trace:lsq_step.two_body")]
    counts = {m.HOOKS[0][1]: 14, m.HOOKS[1][1]: 14}
    assert m.read(types.SimpleNamespace(counts=counts, records=[])) == 1.0
    counts[m.HOOKS[0][1]] = 7
    assert m.read(types.SimpleNamespace(counts=counts, records=[])) == 0.5
    counts[m.HOOKS[1][1]] = 0
    assert m.read(types.SimpleNamespace(counts=counts, records=[])) is None


def test_a_traced_seeded_run_on_the_cpu_reads_no_launch():
    """On the CPU every step takes the plain path: 0 launches a step."""
    result, _ = run_small("mpcarc.seeded", trace=True)
    assert result["correct"]
    assert result["metrics"]["lsq_kernel_share"]["value"] == 0.0
