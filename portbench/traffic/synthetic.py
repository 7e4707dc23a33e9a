"""The short-arc survey population and its observations.

Orbits: main-belt-like bound orbits (``a`` ~ U[a_min, a_max] AU, ``e`` ~
U[0, e_max], ``i`` ~ U[0, i_max] rad, node, argument of perihelion and mean
anomaly uniform) at one epoch; each observed ``n_obs`` times from the
geocenter at epochs uniform over ``arc_days``, its apparent (RA, Dec) with
first-order aberration from the benchmark's own two-body motion and
analytic Earth, plus Gaussian noise of ``sigma`` rad.  Every number comes
from the traffic file; the draws from ``numpy``'s PCG64 seeded with
``(seed, stream, index)``, so one seed gives one dataset whatever else runs.
"""

import math

import numpy as np
import torch

from portbench.reference.ephem import earth_equatorial
from portbench.reference.twobody import kepler_to_equinoctial, radec


def rng(seed, stream, index=0):
    return np.random.default_rng([int(seed) & (2**63 - 1), int(seed) >> 63, stream, index])


def population(gen, n, p):
    """(n, 6) equinoctial elements of the population described by ``p``."""
    cols = [gen.uniform(p["a_min"], p["a_max"], n), gen.uniform(0.0, p["e_max"], n),
            gen.uniform(0.0, p["i_max"], n), gen.uniform(0, 2 * math.pi, n), gen.uniform(0, 2 * math.pi, n),
            gen.uniform(0, 2 * math.pi, n)]
    return kepler_to_equinoctial(*(torch.as_tensor(c, dtype=torch.float64) for c in cols))


def observations(index, p):
    """Dataset ``index`` of the pool: a dict of float64 arrays, trajectory
    by trajectory (``mjd``, ``ra``, ``dec`` and ``sigma`` of shape (T,
    n_obs)), the truth (``elements`` (T, 6), ``epoch`` (T,)), drawn from
    the traffic file's ``population_seed``.  Not from the run's seed: a
    dataset costs as much as its slowest trajectory's loops (datasets drawn
    anew from each seed took 1.9 to 4.5 s each), and even a new order of
    the same trajectories hands each another IOD noise draw, so the seed
    would change the work."""
    gen = rng(p["population_seed"], 1, index)
    T, n_obs = p["n_traj"], p["n_obs"]
    el = population(gen, T, p)
    epoch = np.full(T, p["epoch"])
    mjd = p["epoch"] + np.sort(gen.uniform(0.0, p["arc_days"], (T, n_obs)), axis=1)
    mjd_t = torch.as_tensor(mjd)
    ra, dec = radec(el, torch.as_tensor(epoch), mjd_t, earth_equatorial(mjd_t))
    ra = np.remainder(ra.numpy() + gen.normal(0.0, p["sigma"], (T, n_obs)), 2 * math.pi)
    dec = dec.numpy() + gen.normal(0.0, p["sigma"], (T, n_obs))
    return dict(mjd=mjd, ra=ra, dec=dec, sigma=np.full((T, n_obs), p["sigma"]), elements=el.numpy(), epoch=epoch)


def lanes(seed, p):
    """Orbits to propagate: the population's (n, 6) elements at ``epoch``
    and end epochs ``epoch`` + U[t_min, t_max] days, drawn from the
    traffic file's ``population_seed`` and put in an order drawn from
    ``seed``.  One set of lanes for every seed: the integrator's loop runs
    until its slowest lane ends, so a set drawn anew from each seed would
    change the work with the seed."""
    gen = rng(p["population_seed"], 2)
    n = p["n_lanes"]
    el = population(gen, n, p).numpy()
    t1 = p["epoch"] + gen.uniform(p["t_min_days"], p["t_max_days"], n)
    order = rng(seed, 4).permutation(n)
    return dict(elements=el[order], epoch=np.full(n, p["epoch"]), t1=t1[order])
