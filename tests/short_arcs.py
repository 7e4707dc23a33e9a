"""Short arcs of the stream's profile for the port's tests: random bound
orbits (a U[1.2, 3.5] AU, e U[0, 0.35], i U[0, 0.6] rad, angles uniform,
MJD 57000) observed from the geocenter ``n_obs`` times over 40 days with
the ephemeris the fit uses, re-noised at 2.4e-6 rad (the JAX bench's
synthetic workload, ``bench.py:406-470``)."""

import numpy as np
import torch

from outfit_tpu_torch import ObsDataset
from outfit_tpu_torch.constants import ROT_ECLMJ2000_TO_EQUMJ2000
from outfit_tpu_torch.elements.twobody import propagate_twobody
from outfit_tpu_torch.elements.types import EquinoctialElements, KeplerianElements, keplerian_to_equinoctial
from outfit_tpu_torch.iod.scoring import apparent_radec
from outfit_tpu_torch.observations.observatories import Observer
from outfit_tpu_torch.utils.linalg import rotate3

SIGMA = 2.4e-6


def short_arcs(n_traj, n_obs, eph, seed=0):
    rng = np.random.default_rng(seed)
    T = n_traj
    kep = KeplerianElements(*(torch.as_tensor(x, dtype=torch.float64) for x in (
        np.full(T, 57000.0), rng.uniform(1.2, 3.5, T), rng.uniform(0.0, 0.35, T), rng.uniform(0.0, 0.6, T),
        rng.uniform(0, 2 * np.pi, T), rng.uniform(0, 2 * np.pi, T), rng.uniform(0, 2 * np.pi, T),
    )))
    omjd = 57000.0 + np.sort(rng.uniform(0, 40, (T, n_obs)), axis=1)
    eq = keplerian_to_equinoctial(kep)
    st = propagate_twobody(
        EquinoctialElements(*(f[:, None] for f in eq)), 57000.0, torch.as_tensor(omjd), compute_derivatives=False
    )
    helio, _ = eph.earth_ephemeris(torch.as_tensor(omjd.ravel()))
    ra, dec = apparent_radec(
        rotate3(ROT_ECLMJ2000_TO_EQUMJ2000, st.position), rotate3(ROT_ECLMJ2000_TO_EQUMJ2000, st.velocity),
        helio.reshape(T, n_obs, 3),
    )
    ra = ra.numpy() + rng.normal(0, SIGMA, (T, n_obs))
    dec = dec.numpy() + rng.normal(0, SIGMA, (T, n_obs))

    ds = ObsDataset()
    ds.mjd_tt = omjd.ravel()
    ds.ra = ra.ravel()
    ds.dec = dec.ravel()
    ds.ra_error = np.full(T * n_obs, SIGMA)
    ds.dec_error = np.full(T * n_obs, SIGMA)
    ds.traj_index = np.repeat(np.arange(T, dtype=np.int64), n_obs)
    ds.observer_index = np.zeros(T * n_obs, np.int64)
    ds.traj_ids = [f"S{i:06d}" for i in range(T)]
    ds.observers = [Observer.geocenter()]
    ds.mag = np.full(T * n_obs, np.nan)
    ds.catalog = np.full(T * n_obs, " ", dtype="U1")
    return ds
