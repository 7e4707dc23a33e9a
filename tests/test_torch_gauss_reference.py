"""The benchmark's plain Gauss IOD (``portbench/reference/iod.py``) against
the port's (``iod/gauss.py``) on the CPU.

Noise-free triplets of random two-body orbits, seen from ground stations
(the benchmark's own two-body motion, analytic Earth and station model):

* float64: the port's ``gauss_candidates`` and the reference keep the same
  roots, accept and refine the same ones, and their refined central states
  and epochs agree within ``REL``;
* mixed precision: the port's float32 candidates brought back by
  ``polish_selected`` agree with the float64 reference within the same bar
  on the typical candidate (the median; see that test);
* the reference computed in float32 misses that bar: the bar tells the
  two precisions apart;
* the reference's equinoctial elements invert its two-body motion.

Why ``REL`` = 1e-8: both refinements stop once a trip moves the positions
by at most 1e-10 of their size (``IODParams.newton_eps``,
``NEWTON_EPS`` there), and the f-g iteration converges linearly, so two exact
implementations may stop a few such steps apart (measured: up to 3e-10);
float32 arithmetic leaves errors of 1e-7 and more.
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from outfit_tpu_torch.iod.gauss import GaussTriplets, gauss_candidates, polish_selected  # noqa: E402
from outfit_tpu_torch.iod.params import IODParams  # noqa: E402
from portbench.reference import iod, observers, twobody  # noqa: E402
from portbench.traffic import mpc, synthetic  # noqa: E402

torch.set_num_threads(2)

REL = 1e-8
POP = dict(a_min=1.2, a_max=3.5, e_max=0.35, i_max=0.6)


def _triplets(seed, n=48):
    """``n`` noise-free triplets (times, RA, Dec, observer positions) of
    random orbits at MJD 57000, each seen from one of the fixtures'
    stations over 2-30 days on each side."""
    gen = np.random.default_rng(seed)
    x = synthetic.population(gen, n, POP)
    t2 = 57000.0 + gen.uniform(-20, 20, n)
    time = np.stack([t2 - gen.uniform(2, 30, n), t2, t2 + gen.uniform(2, 30, n)], 1)
    stations = mpc.tiling(seed, 0, ["8467", "33803"], 2, 0)["stations"]
    st = torch.as_tensor(gen.integers(0, len(stations["codes"]), (n, 3)))
    t = torch.as_tensor(time)
    pos = observers.heliocentric(t, st, stations)
    ra, dec = twobody.radec(x, torch.full((n,), 57000.0, dtype=torch.float64), t, pos)
    return t, ra, dec, pos


def _rel(a, b):
    return ((a - b).norm(dim=-1) / b.norm(dim=-1)).max().item()


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_float64_port_and_reference_agree(seed):
    t, ra, dec, pos = _triplets(seed)
    ref = iod.gauss(t, ra, dec, pos)
    port = gauss_candidates(GaussTriplets(ra, dec, t, pos), IODParams())
    assert torch.equal(port.valid, ref.valid) and torch.equal(port.corrected, ref.corrected)
    assert ref.corrected.sum() > 20
    assert (port.r2 - ref.r2).abs()[ref.valid].max() < 1e-9
    c = ref.corrected
    assert _rel(port.pos[c], ref.pos[c]) < REL
    assert _rel(port.vel[c], ref.vel[c]) < REL
    assert (port.epoch - ref.epoch)[c].abs().max() < 1e-9


def _polished(t, ra, dec, pos, params):
    """The port's mixed candidates, each polished in float64 as the IOD
    polishes the winners: (positions, velocities, epochs, corrected)."""
    tri = GaussTriplets(ra, dec, t, pos)
    c = gauss_candidates(tri, params, work_dtype=torch.float32)
    L, K = c.r2.shape
    flat = GaussTriplets(*(f.repeat_interleave(K, 0) for f in tri))
    out = polish_selected(flat, *(f.reshape((L * K,) + f.shape[2:]) for f in
                                  (c.r2, c.pos, c.vel, c.epoch, c.corrected, c.chi1, c.chi2)), params)
    return [o.reshape((L, K) + o.shape[1:]) for o in out], c


@pytest.mark.parametrize("seed", [21, 22])
def test_mixed_port_after_its_polish_agrees_with_the_float64_reference(seed):
    """Each float32 candidate polished in float64 as the IOD polishes its
    winners (at most ``polish_max_it`` = 12 trips from the float32 fixed
    point): the typical candidate reaches the float64 fixed point within
    ``REL``.  Not every one: a candidate whose float32 pass stopped far from
    it (spurious roots near the observer, slow f-g convergence) stays apart
    after 12 trips, which the IOD allows, since the correction refines the
    winner.  The float32 reference's typical candidate misses by 1e-5."""
    t, ra, dec, pos = _triplets(seed)
    ref = iod.gauss(t, ra, dec, pos)
    low = iod.gauss(t, ra.float(), dec.float(), pos.float())
    (ppos, pvel, pepoch, pcorr), cands = _polished(t, ra, dec, pos, IODParams(precision="mixed"))
    # the same roots (float32, so matched by value), refined by both
    both = pcorr & ref.corrected & ((cands.r2.double() - ref.r2).abs() < 1e-4 * ref.r2)
    assert both.sum() > 20

    def median_rel(a, b):
        return ((a - b).norm(dim=-1) / b.norm(dim=-1)).median().item()

    assert median_rel(ppos[both][..., 1, :], ref.pos[both][..., 1, :]) < REL
    assert median_rel(pvel[both], ref.vel[both]) < REL
    assert (pepoch - ref.epoch)[both].abs().median() < 1e-9
    both32 = low.corrected & ref.corrected
    assert median_rel(low.pos[both32][..., 1, :].double(), ref.pos[both32][..., 1, :]) > 100 * REL


def test_the_float32_reference_misses_the_bar():
    t, ra, dec, pos = _triplets(11)
    ref = iod.gauss(t, ra, dec, pos)
    low = iod.gauss(t, ra.float(), dec.float(), pos.float())
    both = low.corrected & ref.corrected
    assert both.sum() > 20
    assert _rel(low.pos[both][..., 1, :].double(), ref.pos[both][..., 1, :]) > 100 * REL
    assert _rel(low.vel[both].double(), ref.vel[both]) > 100 * REL


def test_equinoctial_elements_invert_two_body_motion():
    gen = np.random.default_rng(5)
    x = synthetic.population(gen, 64, POP)
    dt = torch.as_tensor(gen.uniform(-400, 400, 64))
    back = iod.equinoctial(*twobody.state(x, dt))
    moved = torch.remainder(x[:, 5] + torch.sqrt(twobody.MU / x[:, 0] ** 3) * dt, 2 * math.pi)
    assert (back[:, :5] - x[:, :5]).abs().max() < 1e-12
    gap = torch.remainder(back[:, 5] - moved + math.pi, 2 * math.pi) - math.pi
    assert gap.abs().max() < 1e-10


def test_companion_roots_are_the_polynomials_roots():
    t, ra, dec, pos = _triplets(31, 16)
    dt = t - t[:, 1:2]
    k = math.sqrt(twobody.MU)
    u = iod.unit_vectors(ra, dec)
    s = u.transpose(-1, -2)
    _, _, c0, c3, c6 = iod.polynomial(k * dt[:, 0], k * dt[:, 2], torch.linalg.inv(s), s, pos)
    x, has = iod.roots(c0, c3, c6)
    value = x**8 + c6[:, None] * x**6 + c3[:, None] * x**3 + c0[:, None]
    scale = x**8 + c6[:, None].abs() * x**6 + c3[:, None].abs() * x**3 + c0[:, None].abs()
    assert has.any(-1).all() and (value.abs() / scale)[has].max() < 1e-12


def test_the_reference_settings_are_the_iods_defaults():
    """Each setting of the plain Gauss IOD and of its check is the
    ``IODParams`` default it is named after (Outfit's)."""
    from portbench import iod_check

    p = IODParams()
    assert (iod.MAX_TESTED_SOLUTIONS, iod.R2_MIN_AU, iod.R2_MAX_AU, iod.MIN_RHO2_AU) == (
        p.max_tested_solutions, p.r2_min_au, p.r2_max_au, p.min_rho2_au)
    assert (iod.MAX_ECC, iod.MAX_PERIHELION_AU, iod.NEWTON_MAX_IT, iod.NEWTON_EPS, iod.ROOT_IMAG_EPS) == (
        p.max_ecc, p.max_perihelion_au, p.newton_max_it, p.newton_eps, p.root_imag_eps)
    assert iod_check.SPAN_MAX == p.dt_max_triplet
