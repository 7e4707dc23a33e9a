"""The correction's two-body Newton step on the CPU: CPU tensors take the
plain step, launch nothing and count as two-body steps; an N-body step
neither counts nor reaches the kernel; the kernel's inputs as the wrapper
lays them out for its three pairs of working types at the stream's and a
catalogue arc's width, a pure function of the step's arguments; and the
kernel's entry point refuses CPU tensors.  The kernel itself runs only on
a card (tests/test_torch_gpu.py)."""

import numpy as np
import pytest
import torch

from outfit_tpu_torch import DifferentialCorrectionConfig, IODParams, JPLEphem, fit_lsq, trace
from outfit_tpu_torch.lsq import iteration, loop, step_cuda
from outfit_tpu_torch.lsq.iteration import ObsArrays
from outfit_tpu_torch.propagator.config import PropagatorKind

from short_arcs import short_arcs

SPAN = (53500.0, 61500.0)
KINDS = {"f32": (torch.float32, None), "f64_f32": (torch.float64, torch.float32), "f64": (torch.float64, None)}


def _same(x, y):
    return x.dtype == y.dtype and x.shape == y.shape and bool(((x == y) | (torch.isnan(x) & torch.isnan(y))).all())


@pytest.fixture(scope="module")
def eph():
    return JPLEphem.analytic(*SPAN)


@pytest.fixture(scope="module")
def steps(eph):
    """The calls of ``single_iteration`` in a mixed and a float64 fit of 16
    short arcs of the stream's profile on the CPU, by precision."""
    ds = short_arcs(16, 12, eph, seed=3)
    calls, si = {}, loop.single_iteration
    for prec in ("mixed", "f64"):
        calls[prec] = []

        def record(*a, **k):
            calls[prec].append((a, k))
            return si(*a, **k)

        loop.single_iteration = record
        try:
            fit_lsq(ds, eph, IODParams(n_noise_realizations=3, precision=prec, max_triplets=2),
                    DifferentialCorrectionConfig(precision=prec, prewarm_max_iterations=16), 7, device="cpu")
        finally:
            loop.single_iteration = si
    return calls


@pytest.mark.parametrize("prec", ["mixed", "f64"])
def test_cpu_tensors_take_the_plain_step(steps, prec):
    """Every step is bitwise the plain step, launches no kernel and counts
    once in ``trace.lsq_step.two_body``."""
    kinds = set()
    for a, k in steps[prec]:
        launches, before = dict(step_cuda.launches), trace.lsq_step.two_body
        got = iteration.single_iteration(*a, **k)
        assert trace.lsq_step.two_body - before == 1 and step_cuda.launches == launches
        ref = iteration._single_iteration_plain(*a, **k)
        assert all(_same(x, y) for x, y in zip(got, ref))
        kinds.add((a[0].dtype, a[7] if len(a) > 7 else None))
    want = {(torch.float32, None), (torch.float64, torch.float32), (torch.float64, None)} if prec == "mixed" else {
        (torch.float64, None)}
    assert kinds == want


def test_an_nbody_step_is_not_a_two_body_step(steps, eph, monkeypatch):
    """An N-body step takes the plain path, with ``propagate_nbody`` (its
    Kepler state NaN): it neither counts as a two-body step nor reaches the
    kernel."""
    seen = []
    monkeypatch.setattr(step_cuda, "step", lambda *a, **k: seen.append(a))
    a, _ = steps["f64"][0]
    before = trace.lsq_step.two_body
    res = iteration.single_iteration(a[0][:1], a[1][:1], a[2][:1], ObsArrays(*(
        None if x is None else x[:1] for x in a[3])), a[4], PropagatorKind.n_body(), eph)
    assert trace.lsq_step.two_body == before and not seen
    assert res.kepler.isnan().all() and res.residual_ra.shape == a[3].mjd[:1].shape


def _inputs(kind, n_obs, seed=0, bias=True, warm=True):
    """A step's arguments on the CPU with ``n_obs`` padded observations (the
    last third of them padding), in ``kind``'s working types."""
    work, jac = KINDS[kind]
    rng = np.random.default_rng(seed)
    T = 5
    el = torch.as_tensor(np.c_[rng.uniform(1.5, 3, T), rng.normal(0, 0.1, (T, 4)), rng.uniform(0, 6, T)], dtype=work)
    epoch = torch.full((T,), 57000.0, dtype=torch.float64)
    valid = torch.as_tensor(np.arange(n_obs)[None] < (2 * n_obs) // 3).expand(T, n_obs).clone()
    sel = torch.where(valid, 0, 2).to(torch.int64)
    f = dict(dtype=work)
    obs = ObsArrays(
        torch.as_tensor(57000.0 + rng.uniform(0, 40, (T, n_obs))), torch.as_tensor(rng.uniform(0, 6, (T, n_obs)), **f),
        torch.as_tensor(rng.uniform(-1, 1, (T, n_obs)), **f), torch.full((T, n_obs), 2.4e-6, **f),
        torch.full((T, n_obs), 2.4e-6, **f), torch.as_tensor(rng.normal(0, 1, (T, n_obs, 3)), **f), valid,
        *((torch.full((T, n_obs), 1e-7, **f),) * 2 if bias else (None, None)),
    )
    kep = torch.as_tensor(rng.normal(0, 1, (T, n_obs, 3)), **f)
    return (el, epoch, sel, obs, (True,) * 5 + (False,)), jac, ((kep[..., 0], kep[..., 1], kep[..., 2]) if warm
                                                               else None)


@pytest.mark.parametrize("n_obs", [12, 129])
@pytest.mark.parametrize("kind", list(KINDS))
def test_kernel_inputs_are_a_pure_layout_of_the_step(kind, n_obs):
    """The wrapper's layout: the step's tensors contiguous in the kernel's
    types (float64 epochs and MJDs, int32 selections, the free elements a
    bool tensor), the warm start's three views as given, the Jacobians'
    type the working type unless float32 is asked for; the arguments
    untouched, and the same layout from the same arguments."""
    (el, epoch, sel, obs, free), jac, warm = _inputs(kind, n_obs)
    kept = [x.clone() for x in (el, epoch, sel, *obs[:7])]
    args, kw = iteration._step_kernel_inputs(el, epoch, sel, obs, free, jac, warm)
    work = el.dtype
    T = el.shape[0]
    assert [None if x is None else (tuple(x.shape), x.dtype) for x in args] == [
        ((T, 6), work), ((T,), torch.float64), ((T, n_obs), torch.int32), ((T, n_obs), torch.float64),
        *[((T, n_obs), work)] * 4, ((T, n_obs, 3), work), ((T, n_obs), torch.bool), *[((T, n_obs), work)] * 5,
        ((6,), torch.bool)]
    assert all(x.is_contiguous() for x in args[:12]) and all(x is w for x, w in zip(args[12:15], warm))
    assert kw == dict(jacobian_dtype=jac or work) and (work, kw["jacobian_dtype"]) in step_cuda.KINDS
    assert args[15].tolist() == list(free) and torch.equal(args[2], sel.to(torch.int32))
    assert all(torch.equal(x, y) for x, y in zip(kept, (el, epoch, sel, *obs[:7])))
    again, kw2 = iteration._step_kernel_inputs(el, epoch, sel, obs, free, jac, warm)
    assert kw2 == kw and all((x is None and y is None) or torch.equal(x, y) for x, y in zip(args, again))
    (_, _, _, obs0, _), _, _ = _inputs(kind, n_obs, bias=False, warm=False)
    none, _ = iteration._step_kernel_inputs(el, epoch, sel, obs0, free, jac, None)
    assert none[10:15] == (None,) * 5


@pytest.mark.parametrize("kind", list(KINDS))
def test_kernel_entry_point_raises_for_cpu_tensors(kind):
    (el, epoch, sel, obs, free), jac, warm = _inputs(kind, 12)
    args, kw = iteration._step_kernel_inputs(el, epoch, sel, obs, free, jac, warm)
    launches = dict(step_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        step_cuda.step(*args, **kw)
    assert step_cuda.launches == launches
