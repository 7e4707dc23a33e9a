"""Mixed precision of the PyTorch port (``IODParams(precision="mixed")`` and
``DifferentialCorrectionConfig(precision="mixed")``) against the JAX
package, and against the port's own float64 path, on the same numpy inputs
on the CPU.

The float32 stages round differently under XLA (which contracts ``a*b+c``
into fused multiply-adds) and under PyTorch, so a near-tied candidate or
Monte-Carlo lane can win on one side and not the other.  The bars are
therefore the JAX suite's seed-grade ones, each stated at its assert:

* mixed IOD: identical success sets; RMS ratio median < 1.001, 90th
  percentile < 1.2, max < 2; polished elements with median relative
  difference < 1e-8 (tests/test_iod.py::TestMixedPrecision);
* mixed LSQ: the same statuses and the same-basin criterion on the
  normalised RMS, |d nRMS| < 1e-6 (1 + nRMS) (tests/test_lsq.py:206-209);
  elements at the mixed batch-isolation bar rtol 3e-5 / atol 1e-8;
* ``polish_selected`` on identical float32 candidates: rtol 1e-10.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from outfit_tpu.ephem import JPLEphem as JJPLEphem
from outfit_tpu.iod import IODParams as JIODParams
from outfit_tpu.iod.api import fit_full_iod as j_fit_full_iod
from outfit_tpu.iod.gauss import GaussTriplets as JTri
from outfit_tpu.iod.gauss import gauss_candidates as j_gauss_candidates
from outfit_tpu.iod.gauss import polish_selected as j_polish_selected
from outfit_tpu.lsq import DifferentialCorrectionConfig as JConfig
from outfit_tpu.lsq import fit_lsq as j_fit_lsq
from outfit_tpu.observations import ErrorModel as JErrorModel
from outfit_tpu.observations import ObsDataset as JObsDataset
from outfit_tpu_torch import DifferentialCorrectionConfig, ErrorModel, IODParams, JPLEphem, ObsDataset
from outfit_tpu_torch.iod.api import _fit_full_iod, _iod_kernel
from outfit_tpu_torch.iod.gauss import GaussTriplets, polish_selected
from outfit_tpu_torch.lsq.api import _fit_lsq
from outfit_tpu_torch.lsq.iteration import ObsArrays
from outfit_tpu_torch.lsq.loop import run_differential_correction

from test_torch_iod import jax_draws, triplets  # noqa: F401  (module fixture)
from test_torch_lsq import batch  # noqa: F401  (module fixture)

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
NAMES = ["2015AB", "8467", "33803"]
SPAN = (53500.0, 61500.0)
MIXED_IOD = dict(n_noise_realizations=3, max_triplets=4, precision="mixed")
#: the JAX bench's headline correction profile (bench.py:509-516)
MIXED_CFG = dict(precision="mixed", prewarm_max_iterations=16, divergence_grace_iterations=2)

pytestmark = pytest.mark.filterwarnings("ignore:observatory .* SOLVED")


@pytest.fixture(scope="module")
def jeph():
    return JJPLEphem.analytic(*SPAN)


@pytest.fixture(scope="module")
def teph():
    return JPLEphem.analytic(*SPAN)


def _paths():
    return [os.path.join(DATA, f"{n}.obs") for n in NAMES]


def _assert_seed_grade(rms_port, rms_ref, el_port, el_ref):
    """tests/test_iod.py::TestMixedPrecision::test_kernel_batch_parity's bars."""
    ok = np.isfinite(rms_ref)
    np.testing.assert_array_equal(np.isfinite(rms_port), ok)  # identical success sets
    assert ok.any()
    ratio = rms_port[ok] / rms_ref[ok]
    assert np.median(ratio) < 1.001 and np.percentile(ratio, 90) < 1.2 and ratio.max() < 2.0, ratio
    rel = np.abs(el_port[ok] - el_ref[ok]) / (1.0 + np.abs(el_ref[ok]))
    assert np.median(rel) < 1e-8, rel
    return float(np.abs(ratio - 1.0).max()), float(np.median(rel))


@pytest.fixture(scope="module")
def jax_mixed(jeph):
    """The JAX mixed IOD and IOD+LSQ of the three fixtures (one dataset)."""
    p = JIODParams(**MIXED_IOD)
    iod = j_fit_full_iod(JObsDataset.from_mpc_80_col_files(_paths()), jeph, p, seed=42,
                         error_model=JErrorModel.fcct14(), mesh=None)
    lsq = j_fit_lsq(JObsDataset.from_mpc_80_col_files(_paths()), jeph, p, JConfig(**MIXED_CFG), 42,
                    error_model=JErrorModel.fcct14(), mesh=None)
    return iod, lsq


def test_mixed_iod_matches_jax_at_seed_grade(teph, jax_mixed):
    p = IODParams(**MIXED_IOD)
    res = _fit_full_iod(ObsDataset.from_mpc_80_col_files(_paths()), teph, p, 42, None, ErrorModel.fcct14(),
                        None, "cpu", jax_draws(42, p))
    ref = jax_mixed[0]
    assert list(res) == list(ref)
    tids = list(ref)
    for tid in tids:
        assert res[tid].ok == ref[tid].ok
        assert isinstance(res[tid].rms, float) and res[tid].equinoctial.dtype == np.float64
    _assert_seed_grade(
        np.array([res[t].rms for t in tids]), np.array([ref[t].rms for t in tids]),
        np.stack([res[t].equinoctial for t in tids]), np.stack([np.asarray(ref[t].equinoctial) for t in tids]),
    )


def test_mixed_lsq_matches_jax_same_basin(teph, jax_mixed):
    p = IODParams(**MIXED_IOD)
    res = _fit_lsq(ObsDataset.from_mpc_80_col_files(_paths()), teph, p, DifferentialCorrectionConfig(**MIXED_CFG),
                   42, None, ErrorModel.fcct14(), None, None, "cpu", jax_draws(42, p))
    ref = jax_mixed[1]
    assert list(res) == list(ref)
    for tid, a in ref.items():
        b = res[tid]
        # total_newton_iterations is exempt: the pre-warm's trip count is
        # the batch's, and float32 rounding can move its plateau by a trip
        for f in ("ok", "fell_back_to_iod", "status", "n_active_obs", "error"):
            assert getattr(b, f) == getattr(a, f), (tid, f)
        assert not b.fell_back_to_iod
        assert abs(b.normalised_rms - a.normalised_rms) < 1e-6 * (1.0 + abs(a.normalised_rms)), tid
        np.testing.assert_allclose(b.equinoctial, np.asarray(a.equinoctial), rtol=3e-5, atol=1e-8, err_msg=tid)


def _synthetic_lanes():
    from __graft_entry__ import _synthetic_batch

    tri, obs_arrays, lane_traj, window = _synthetic_batch(32, 8, 12, seed=3)
    return [np.array(x) for x in tri], [np.array(x) for x in obs_arrays], np.array(lane_traj), np.array(window)


def _port_kernel(lanes, params):
    tri, obs, lane_traj, window = lanes
    return [
        o.numpy() for o in _iod_kernel(
            GaussTriplets(*map(torch.as_tensor, tri)), tuple(map(torch.as_tensor, obs)),
            torch.as_tensor(lane_traj), torch.as_tensor(window), params.validated(),
        )
    ]


def test_mixed_kernel_against_port_f64():
    """tests/test_iod.py::TestMixedPrecision::test_kernel_batch_parity on the
    port: its mixed kernel against its float64 kernel, 32 trajectories x 8
    lanes x 12 observations."""
    lanes = _synthetic_lanes()
    o64 = _port_kernel(lanes, IODParams())
    omx = _port_kernel(lanes, IODParams(precision="mixed"))
    assert o64[0].shape == (32,) and o64[0].dtype == omx[0].dtype == np.float64
    _assert_seed_grade(omx[0], o64[0], omx[2], o64[2])


def test_polish_selected_matches_jax(triplets):  # noqa: F811
    """Identical float32 candidates (the JAX package's, for the first valid
    root of each lane) through both packages' float64 polish: rtol 1e-10."""
    jp = JIODParams()
    cands = jax.jit(j_gauss_candidates, static_argnums=(1, 2))(JTri(*map(jnp.asarray, triplets)), jp, jnp.float32)
    valid = np.asarray(cands.valid)
    lanes = np.nonzero(valid.any(axis=1))[0]
    assert lanes.size >= 4 and np.asarray(cands.corrected).any()
    k = valid[lanes].argmax(axis=1)
    pick = [np.asarray(f)[lanes, k] for f in (cands.r2, cands.pos, cands.vel, cands.epoch, cands.corrected,
                                              cands.chi1, cands.chi2)]
    assert pick[1].dtype == np.float32 and pick[3].dtype == np.float64
    tri = [np.asarray(x)[lanes] for x in triplets]
    rj = jax.jit(j_polish_selected, static_argnums=(8, 9))(
        JTri(*map(jnp.asarray, tri)), *map(jnp.asarray, pick), jp, jp.polish_max_it
    )
    rt = polish_selected(GaussTriplets(*map(torch.as_tensor, tri)), *map(torch.as_tensor, pick),
                         IODParams(), IODParams().polish_max_it)
    np.testing.assert_array_equal(rt[3].numpy(), np.asarray(rj[3]))
    for a, b, name in zip(rt[:3], rj[:3], ("pos", "vel", "epoch")):
        assert a.dtype == torch.float64
        # rtol 1e-10, at the scale of the whole array for near-zero entries
        # (XLA's fused multiply-adds move a 1e-3 component by ~1e-12)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-10 * np.abs(b).max(), err_msg=name)


def _tobs(obs, sl=slice(None)):
    return ObsArrays(*(torch.as_tensor(np.asarray(a)[sl]) for a in obs))


def test_mixed_correction_batch_isolation(batch):  # noqa: F811
    """tests/test_lsq.py::TestLsqBatchIsolation (mixed) on the port: a lane
    alone and in the batch give the same statuses, selections and
    measurement counts, and bitwise the same floats; only
    total_newton_iterations may differ (the pre-warm's trip count is the
    batch's, as in the JAX package)."""
    el, ep, obs = batch
    cfg = DifferentialCorrectionConfig(precision="mixed")
    full = run_differential_correction(torch.as_tensor(el), torch.as_tensor(ep), _tobs(obs), cfg)
    assert len(set(full.status.tolist())) > 1
    for i in range(el.shape[0]):
        sl = slice(i, i + 1)
        alone = run_differential_correction(torch.as_tensor(el[sl]), torch.as_tensor(ep[sl]), _tobs(obs, sl), cfg)
        for name in full._fields:
            if name == "total_newton_iterations":
                continue
            torch.testing.assert_close(
                getattr(alone, name), getattr(full, name)[sl], rtol=0, atol=0, equal_nan=True,
                msg=f"lane {i}, {name}",
            )
