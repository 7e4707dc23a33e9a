"""The yardstick: traffic from the seed, K1's bytes and operations, and
the plain reference against the port at small sizes on the CPU."""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT

from portbench import roofline
from portbench.traffic import mpc, synthetic

POP = dict(epoch=57000.0, a_min=1.2, a_max=3.5, e_max=0.35, i_max=0.6)
BIG_SEED = 2**31 + 12345678901


@pytest.mark.parametrize("make", [
    lambda s: synthetic.lanes(s, dict(POP, n_lanes=16, t_min_days=25.0, t_max_days=30.0, population_seed=3)),
    lambda s: {k: v for k, v in mpc.tiling(s, 1, ["2015AB", "8467", "33803"], 6, 9).items() if k != "stations"},
], ids=["lanes", "mpcarc"])
def test_traffic_repeats_from_the_seed_and_differs_across_seeds(make):
    a, b, c = make(BIG_SEED), make(BIG_SEED), make(BIG_SEED + 1)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert any(not np.array_equal(a[k], c[k]) for k in a if np.asarray(a[k]).dtype.kind == "f")
    # another seed orders the same trajectories anew: the same work
    for k in a:
        if np.ndim(a[k]) >= 1 and len(a[k]) == len(c[k]):
            np.testing.assert_array_equal(np.sort(np.asarray(a[k]), axis=0), np.sort(np.asarray(c[k]), axis=0))


def test_the_stream_pool_repeats_from_its_population_seed():
    p = dict(POP, n_traj=4, n_obs=12, arc_days=40.0, sigma=2.4e-6, population_seed=1)
    a, b = synthetic.observations(0, p), synthetic.observations(0, p)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["ra"], synthetic.observations(1, p)["ra"])
    assert not np.array_equal(a["ra"], synthetic.observations(0, dict(p, population_seed=2))["ra"])


def test_k1_counts_by_hand():
    # one body query, C = 3 coefficients, 3 channels with the derivative:
    # x, tau 5; T_2 3 + dT_2 5; contraction 3 x 3 x 2 x 2 = 36; scale 3
    assert roofline.k1_flops(3, 3, True) == 5 + 8 + 36 + 3
    # frame query without the derivative, C = 4, 10 channels
    assert roofline.k1_flops(4, 10, False) == 5 + 2 * 3 + 4 * 10 * 2
    # 2 epochs in one granule of a 4-granule table, and one past its end
    assert roofline.touched_rows([0.5, 0.7, 9.0], 0.0, 1.0, 4) == 2
    n, g, ch, c, rows = 1024, 100, 3, 14, 5
    nbytes = 8 * (n + 2 * n * ch + rows * ch * c)
    ops = n * roofline.k1_flops(c, ch, True)
    assert roofline.k1_bound_s(n, (g, ch, c), True, rows) == max(nbytes / 3.35e12, ops / 34e12)


def test_observer_positions_match_the_port():
    from outfit_tpu_torch import JPLEphem, ObsDataset, Observer
    from outfit_tpu_torch.observer.cache import ObserverCache

    from portbench.reference import observers

    d = mpc.tiling(5, 0, ["2015AB", "8467", "33803"], 3, 5)
    st = d["stations"]
    v = d["valid"]
    ds = ObsDataset()
    ds.mjd_tt, ds.observer_index = d["mjd"][v], d["station"][v]
    ds.observers = [Observer.from_parallax(st["longitude"][i], st["rho_cos_phi"][i], st["rho_sin_phi"][i], code=c)
                    for i, c in enumerate(st["codes"])]
    cache = ObserverCache.build(ds, JPLEphem.analytic(), device="cpu")
    ref = observers.heliocentric(torch.as_tensor(ds.mjd_tt), torch.as_tensor(ds.observer_index), st)
    assert np.abs(cache.helio_pos_equ.numpy() - ref.numpy()).max() < 1e-11


def test_apparent_positions_and_partials_match_the_port():
    from outfit_tpu_torch import JPLEphem
    from outfit_tpu_torch.lsq.iteration import ObsArrays, observation_partials

    from portbench.reference import ephem, twobody

    p = dict(POP, n_traj=8, n_obs=12, arc_days=40.0, sigma=2.4e-6, population_seed=3)
    d = synthetic.observations(0, p)
    mjd = torch.as_tensor(d["mjd"])
    helio, _ = JPLEphem.analytic().earth_ephemeris(mjd.reshape(-1))
    obs = ObsArrays(mjd, *(torch.as_tensor(d[k]) for k in ("ra", "dec", "sigma", "sigma")),
                    helio.reshape(8, 12, 3), torch.ones(8, 12, dtype=torch.bool))
    x = torch.as_tensor(d["elements"])
    ra, dec, dra, ddec, _, _ = observation_partials(x, torch.as_tensor(d["epoch"]), obs)
    rra, rdec, rdra, rddec = twobody.radec_and_partials(x, torch.as_tensor(d["epoch"]), mjd,
                                                        ephem.earth_equatorial(mjd))
    assert (ra - rra).abs().max() < 1e-11 and (dec - rdec).abs().max() < 1e-11
    assert (dra - rdra).abs().max() / dra.abs().max() < 1e-9
    assert (ddec - rddec).abs().max() / ddec.abs().max() < 1e-9


def test_nbody_matches_the_port():
    from outfit_tpu_torch import JPLEphem, NBodyConfig, propagate_nbody
    from outfit_tpu_torch.elements.types import EquinoctialElements

    from portbench.reference import nbody

    lanes = synthetic.lanes(11, dict(POP, n_lanes=6, t_min_days=25.0, t_max_days=30.0, population_seed=11))
    el = torch.as_tensor(lanes["elements"])
    eq = EquinoctialElements(torch.as_tensor(lanes["epoch"]), *el.unbind(-1))
    planets = NBodyConfig.with_planets()
    res = propagate_nbody(eq, torch.as_tensor(lanes["t1"]), JPLEphem.analytic(),
                          NBodyConfig(perturbing_bodies=planets.perturbing_bodies, frozen_perturbers=False),
                          device="cpu")
    bodies = ["sun", "mercury", "venus", "emb", "mars", "jupiter", "saturn", "uranus", "neptune", "pluto"]
    pos, vel, dpos, dvel, _, done = nbody.propagate(el, torch.as_tensor(lanes["epoch"]),
                                                    torch.as_tensor(lanes["t1"]), bodies)
    assert bool(done.all()) and (res.status == 0).all()
    assert (res.position - pos).abs().max() < 1e-10
    assert (res.dpos_delem - dpos).abs().max() / dpos.abs().max() < 1e-9
    assert (res.dvel_delem - dvel).abs().max() / dvel.abs().max() < 1e-9


def test_reference_correction_matches_a_seeded_fit():
    from portbench import checks
    from portbench.reference import lsq
    from conftest import run_small

    result, numbers = run_small("mpcarc.seeded", seed=BIG_SEED)
    values = {n["name"]: n for n in numbers}
    assert values["orbit_gap_sigma"]["value"] < 1e-3 and values["missing_rows"]["value"] == 0
    assert checks.number("x", 1.0, 2.0)["ok"] and not checks.number("x", math.nan, 2.0)["ok"]
    assert lsq.OK == 1


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference.ephem, portbench.reference.twobody, portbench.reference.lsq\n"
            "import portbench.reference.nbody, portbench.reference.frames, portbench.reference.observers\n"
            "import portbench.traffic.synthetic, portbench.traffic.mpc, portbench.checks, portbench.roofline\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'outfit_tpu_torch', 'outfit_tpu', 'jax'}))"
            % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True).stdout
    assert out.strip() == "[]"
