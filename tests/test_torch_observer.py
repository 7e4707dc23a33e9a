"""Host layer and observer cache of the PyTorch port against the JAX package.

* Host copies: the four MPC fixtures parse to the same arrays through both
  packages (the JAX side through its default parser), before and after the
  error model and the batch RMS correction.
* Observer cache: the frame table's granule choice is the JAX package's
  exactly, the table and its evaluation agree, and the heliocentric
  observer position (AU) and velocity (AU/day) agree to 1e-14.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from outfit_tpu.ephem import JPLEphem as JJPLEphem
from outfit_tpu.iod import IODParams as JIODParams
from outfit_tpu.observations import ErrorModel as JErrorModel
from outfit_tpu.observations import ObsDataset as JObsDataset
from outfit_tpu.observer.cache import ObserverCache as JObserverCache
from outfit_tpu.observer.cache import _frame_interp as j_frame_interp
from outfit_tpu.observer.cache import _frame_table as j_frame_table
from outfit_tpu_torch import ErrorModel, JPLEphem, ObsDataset
from outfit_tpu_torch.iod.params import IODParams
from outfit_tpu_torch.observer.cache import (
    ObserverCache,
    _frame_interp,
    _frame_table,
    frame_granules,
)

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")
FIXTURES = ["2015AB", "8467", "33803", "K25D50B"]
HELIO_ATOL = 1e-14

pytestmark = pytest.mark.filterwarnings("ignore:observatory .* SOLVED")


@pytest.fixture(scope="module")
def eph_pair():
    return JJPLEphem.analytic(53500.0, 61500.0), JPLEphem.analytic(53500.0, 61500.0)


def _pair(name):
    path = os.path.join(DATA, f"{name}.obs")
    return JObsDataset.from_mpc_80_col(path), ObsDataset.from_mpc_80_col(path)


_COLUMNS = ["mjd_tt", "ra", "dec", "ra_error", "dec_error", "observer_index", "traj_index"]


@pytest.mark.parametrize("name", FIXTURES)
@pytest.mark.parametrize("model", ["raw", "fcct14", "vfcc17"])
def test_host_copies_parse_identically(name, model):
    dj, dt = _pair(name)
    if model != "raw":
        dj.apply_error_model(JErrorModel.from_name(model))
        dj.apply_batch_rms_correction(JIODParams().gap_max)
        dt.apply_error_model(ErrorModel.from_name(model))
        dt.apply_batch_rms_correction(IODParams().gap_max)
    for col in _COLUMNS:
        np.testing.assert_array_equal(getattr(dt, col), getattr(dj, col), err_msg=col)
    np.testing.assert_array_equal(dt.catalog, dj.catalog)
    assert dt.traj_ids == dj.traj_ids
    assert [(o.longitude, o.rho_cos_phi, o.rho_sin_phi, o.code) for o in dt.observers] == [
        (o.longitude, o.rho_cos_phi, o.rho_sin_phi, o.code) for o in dj.observers
    ]


@pytest.mark.parametrize("name", FIXTURES)
def test_frame_granules_match_jax(name):
    """``n_gran``/``gran``/``t0`` as ``cache.py:213-218`` computes them."""
    _, dt = _pair(name)
    span = float(dt.mjd_tt.max() - dt.mjd_tt.min())
    n_gran = 8
    while n_gran * 8.0 < span and n_gran < 4096:
        n_gran *= 2
    assert frame_granules(dt.mjd_tt) == (
        n_gran, max(span / n_gran, 1e-3) * (1.0 + 1e-9), float(dt.mjd_tt.min())
    )


@pytest.mark.parametrize("name", ["2015AB", "8467"])
def test_frame_table_and_evaluation_match_jax(name):
    _, dt = _pair(name)
    n_gran, gran, t0 = frame_granules(dt.mjd_tt)
    cj = np.array(j_frame_table(jnp.float64(t0), jnp.float64(gran), n_gran))
    ct = _frame_table(t0, gran, n_gran, torch.device("cpu"))
    assert ct.shape == cj.shape == (n_gran, 10, 14) and ct.is_contiguous()
    np.testing.assert_allclose(ct.numpy(), cj, rtol=0, atol=1e-13)
    mjd = np.concatenate([dt.mjd_tt, np.random.default_rng(3).uniform(t0, t0 + n_gran * gran, 37)])
    mj, ej = j_frame_interp(jnp.asarray(cj), jnp.asarray(mjd), t0, gran)
    mt, et = _frame_interp(torch.as_tensor(cj), torch.as_tensor(mjd), t0, gran)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=0, atol=1e-15)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=0, atol=1e-15)


@pytest.mark.parametrize("name", FIXTURES)
def test_observer_cache_matches_jax(eph_pair, name):
    ej, et = eph_pair
    dj, dt = _pair(name)
    cj = JObserverCache.build(dj, ej)
    ct = ObserverCache.build(dt, et, device="cpu")
    assert ct.n == cj.n and ct.helio_pos_pad.shape == cj.helio_pos_pad.shape
    assert ct.helio_pos_pad.dtype == torch.float64
    for field in ("helio_pos_pad", "helio_vel_pad"):
        np.testing.assert_allclose(
            getattr(ct, field).numpy(), np.asarray(getattr(cj, field)),
            rtol=0, atol=HELIO_ATOL, err_msg=field,
        )
    for field in ("geo_pos_pad", "geo_vel_pad"):
        np.testing.assert_allclose(
            getattr(ct, field).numpy(), np.asarray(getattr(cj, field)),
            rtol=0, atol=1e-16, err_msg=field,
        )
    # padded rows repeat the first epoch, so they hold its state
    if ct.helio_pos_pad.shape[0] > ct.n:
        assert torch.equal(ct.helio_pos_pad[ct.n], ct.helio_pos_pad[0])
