"""The IOD's f-g correction on the CPU: the wrapper takes the plain loop
there and launches nothing; the kernel's inputs as the wrapper lays them
out for both call shapes; the kernel's entry point refuses CPU tensors;
and ``Site.lane_trips`` counts what the plain loop's exit tests count.
The kernel itself runs only on a card (tests/test_torch_gpu.py)."""

import numpy as np
import pytest
import torch

from outfit_tpu_torch import IODParams, JPLEphem, trace
from outfit_tpu_torch.iod import fg_correction_cuda, gauss
from outfit_tpu_torch.iod.api import fit_full_iod
from outfit_tpu_torch.trace import Site

from short_arcs import short_arcs

SPAN = (53500.0, 61500.0)


@pytest.fixture(scope="module")
def fg_calls():
    """The calls of ``_fg_correction`` in a mixed and a float64 IOD of the
    stream's profile over 16 short arcs on the CPU, by precision."""
    eph = JPLEphem.analytic(*SPAN)
    ds = short_arcs(16, 12, eph, seed=3)
    calls = {}
    fg = gauss._fg_correction
    for prec in ("mixed", "f64"):
        calls[prec] = []

        def record(*a, **k):
            calls[prec].append((a, k))
            return fg(*a, **k)

        gauss._fg_correction = record
        try:
            fit_full_iod(ds, eph, IODParams(n_noise_realizations=3, precision=prec, newton_max_it=20, max_triplets=2),
                         7, device="cpu")
        finally:
            gauss._fg_correction = fg
    return calls


def _site_delta(fn):
    site = trace.sites.iod_fg
    before = (site.reads, site.trips, site.live, site.lanes)
    out = fn()
    return out, tuple(b - a for a, b in zip(before, (site.reads, site.trips, site.live, site.lanes)))


@pytest.mark.parametrize("prec", ["mixed", "f64"])
def test_cpu_tensors_take_the_plain_loop(fg_calls, prec):
    """Every call is bitwise the plain loop, reads once a trip (one more
    read that ends the loop), and launches no kernel."""
    shapes = []
    for a, k in fg_calls[prec]:
        launches = dict(fg_correction_cuda.launches)
        got, d_got = _site_delta(lambda: gauss._fg_correction(*a, **k))
        ref, d_ref = _site_delta(lambda: gauss._fg_correction_plain(*a, **k))
        assert fg_correction_cuda.launches == launches
        assert d_got == d_ref and d_got[1] > 0 and d_got[0] in (d_got[1], d_got[1] + 1)
        for x, y in zip(got, ref):
            assert torch.equal(x, y) or torch.equal(torch.isnan(x), torch.isnan(y)) and torch.equal(
                x[~torch.isnan(x)], y[~torch.isnan(y)])
        shapes.append((a[5].dtype, a[8].dim()))
    want = [(torch.float32, 2), (torch.float64, 1)] if prec == "mixed" else [(torch.float64, 2)]
    assert shapes == want


@pytest.mark.parametrize("prec", ["mixed", "f64"])
def test_kernel_inputs_for_both_call_shapes(fg_calls, prec):
    """The wrapper's layout: the triplet tensors flat over their batch (L or
    T rows), the candidates flat (L x K or T), consecutive candidates of
    one triplet together, and the plain loop's tolerances."""
    for a, k in fg_calls[prec]:
        args, kw = gauss._fg_kernel_inputs(*a, **k)
        obs_pos, s_inv, u, time, dt01, dt21, pos, vel, epoch, chi1, chi2, alive = args
        shape = a[8].shape
        n, m = int(np.prod(shape)), obs_pos.shape[0]
        per = shape[-1] if a[8].dim() == 2 else 1
        assert m * per == n
        assert [tuple(t.shape) for t in args] == [(m, 3, 3), (m, 3, 3), (m, 3, 3), (m, 3), (m,), (m,), (n, 3, 3),
                                                   (n, 3), (n,), (n,), (n,), (n,)]
        assert all(t.is_contiguous() for t in args)
        work = a[5].dtype
        assert [t.dtype for t in args] == [work] * 3 + [torch.float64] * 3 + [work] * 2 + [torch.float64] + [work] * 2 \
            + [torch.bool]
        assert torch.equal(pos.view(*shape, 3, 3), torch.broadcast_to(a[5], (*shape, 3, 3)))
        assert torch.equal(obs_pos, a[0].obs_pos.reshape(m, 3, 3))
        assert torch.equal(dt21, torch.broadcast_to(a[4], a[0].time.shape[:-1]).reshape(m))
        eps = torch.finfo(work).eps
        p = a[11]
        assert kw == dict(max_it=a[12], max_newton=50, conv=max(p.kepler_eps, 100.0 * eps),
                          done_eps=max(p.newton_eps, 10.0 * eps), peri_max=p.max_perihelion_au, ecc_max=p.max_ecc,
                          min_rho2=p.min_rho2_au)


def test_kernel_inputs_refuse_candidates_off_the_triplets_batch(fg_calls):
    a, k = fg_calls["f64"][0]
    a = list(a)
    a[8] = a[8][:-1]  # one lane fewer candidates than triplets
    with pytest.raises(ValueError, match="triplets' batch"):
        gauss._fg_kernel_inputs(*a, **k)


def test_kernel_entry_point_raises_for_cpu_tensors(fg_calls):
    a, k = fg_calls["f64"][0]
    args, kw = gauss._fg_kernel_inputs(*a, **k)
    launches = dict(fg_correction_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        fg_correction_cuda.correct(*args, **kw)
    assert fg_correction_cuda.launches == launches


@pytest.mark.parametrize("case", ["none_live", "typical", "some_run_out", "empty"])
def test_lane_trips_counts_as_the_loops_exit_tests(case):
    """A loop of at most ``max_it`` trips whose lane i is live at its first
    n_i trips: ``lane_trips`` of [max n_i, sum n_i] adds the trips, live
    and lanes that one exit test a trip adds, in one read."""
    max_it = 20
    rng = np.random.default_rng(5)
    n = {"none_live": np.zeros(300, np.int64), "typical": rng.integers(0, 9, 300),
         "some_run_out": np.minimum(rng.integers(0, 40, 300), max_it), "empty": np.zeros(0, np.int64)}[case]
    n_i = torch.as_tensor(n)
    batched, kernel = Site("batched"), Site("kernel")
    for it in range(max_it):
        if not batched.live_lanes(n_i > it):
            break
    lanes = n_i.numel()
    summary = torch.stack([n_i.max() if lanes else torch.tensor(0), n_i.sum()])
    assert kernel.lane_trips(summary, lanes) == [int(n.max(initial=0)), int(n.sum())]
    assert (kernel.trips, kernel.live, kernel.lanes) == (batched.trips, batched.live, batched.lanes)
    assert kernel.reads == 1 and batched.reads == batched.trips + (batched.trips < max_it)
