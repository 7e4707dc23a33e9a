"""The PyTorch port's public surface against the JAX package's.

* Every public name of each JAX subpackage is importable from the port's
  subpackage of the same name, but for the names listed in
  ``NOT_PORTED`` (each with where it stands).
* The top-level facade: every name of ``outfit_tpu.__all__`` is in the
  port's ``__all__``, the constants equal.
* ``from_mpc_80_col_files(paths, False)`` reads ``native=False`` as the
  JAX package does; ``JPLEphem``'s constructors take the JAX parameters;
  ``ObsDataset``'s accessors and aliases return what the JAX package's
  return on the fixtures.
"""

import dataclasses
import importlib
import inspect
import os
import types

import numpy as np
import pytest

import outfit_tpu
import outfit_tpu_torch
from outfit_tpu.observations import ErrorModel as JErrorModel
from outfit_tpu.observations import ObsDataset as JObsDataset
from outfit_tpu.observations.mpc80 import parse_file as j_parse_file
from outfit_tpu_torch import ErrorModel, ObsDataset
from outfit_tpu_torch.observations.mpc80 import parse_file

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
FIXTURES = ["2015AB", "8467", "33803", "K25D50B"]

pytestmark = pytest.mark.filterwarnings("ignore:observatory .* SOLVED")

#: public names of the JAX subpackages that the port does not have, and why
NOT_PORTED = {
    # XLA:CPU executable bookkeeping: deliberately not ported
    "utils": {"clear_executables_if_crowded", "memory_map_count"},
}
#: JAX subpackages without a port
NOT_PORTED_PACKAGES = set()
SUBPACKAGES = ["elements", "ephem", "ephemeris", "frames", "iod", "kepler", "lsq", "observations", "observer",
               "parallel", "propagator", "time", "utils"]


def _public(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in dir(mod) if not n.startswith("_") and not isinstance(getattr(mod, n), types.ModuleType)]
    return sorted(names)


def test_every_jax_subpackage_is_listed():
    pkg = os.path.dirname(outfit_tpu.__file__)
    subs = {d for d in os.listdir(pkg) if os.path.exists(os.path.join(pkg, d, "__init__.py"))}
    assert subs == set(SUBPACKAGES) | NOT_PORTED_PACKAGES | {"native"}  # native: observations/native.py


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports(sub):
    jmod = importlib.import_module(f"outfit_tpu.{sub}")
    tmod = importlib.import_module(f"outfit_tpu_torch.{sub}")
    skip = NOT_PORTED.get(sub, set())
    want = [n for n in _public(jmod) if n not in skip]
    assert skip <= set(_public(jmod)), "a listed name is no longer in the JAX package"
    missing = [n for n in want if not hasattr(tmod, n)]
    assert not missing, missing
    exported = _public(tmod)
    assert set(want) <= set(exported), sorted(set(want) - set(exported))
    for n in skip:
        assert not hasattr(tmod, n), f"{n} is ported now: drop it from NOT_PORTED"
    for n in want:  # a class or function of the port, never the JAX package's
        obj = getattr(tmod, n)
        if isinstance(obj, (type, types.FunctionType)):
            assert obj.__module__.startswith("outfit_tpu_torch."), (n, obj.__module__)


def test_facade_matches_jax():
    missing = sorted(set(outfit_tpu.__all__) - set(outfit_tpu_torch.__all__))
    assert not missing, missing
    assert all(hasattr(outfit_tpu_torch, n) for n in outfit_tpu_torch.__all__)
    for n in ("AU", "GAUSS_GRAV", "GAUSS_GRAV_SQUARED", "RADEG", "RADH", "RADSEC", "SECONDS_PER_DAY", "T2000",
              "VLIGHT_AU"):
        assert getattr(outfit_tpu_torch, n) == getattr(outfit_tpu, n), n
    assert outfit_tpu_torch.constants.__name__ == "outfit_tpu_torch.constants"
    assert outfit_tpu_torch.__version__ == outfit_tpu.__version__


def test_from_mpc_80_col_files_takes_native_second():
    """``from_mpc_80_col_files(paths, False)`` means ``native=False``, as in
    the JAX package: 2015AB.obs is one trajectory, K09R05F."""
    path = os.path.join(DATA, "2015AB.obs")
    ds = ObsDataset.from_mpc_80_col_files([path], False)
    assert ds.traj_ids == JObsDataset.from_mpc_80_col_files([path], False).traj_ids == ["K09R05F"]
    per_designation = ObsDataset.from_mpc_80_col_files([path], False, False)
    assert per_designation.traj_ids == ["K09R05F", "K15A00B"]
    assert ObsDataset.from_mpc_80_col_files([path], native=False, trajectory_per_file=True).traj_ids == ["K09R05F"]


def test_ephemeris_constructors_and_dataset_fields_match_jax():
    """``JPLEphem(tables, emrat, kind, path)``, ``JPLEphem.new(source,
    path)`` and the ``ObsDataset`` columns, as in the JAX package (the
    ``ObsDataset`` constructors are in tests/test_torch_iod.py::
    test_entry_points_take_the_jax_parameters_in_order)."""
    from outfit_tpu.ephem import JPLEphem as JJPLEphem
    from outfit_tpu_torch import JPLEphem

    for name in ("__init__", "new", "analytic"):
        a, b = inspect.signature(getattr(JPLEphem, name)), inspect.signature(getattr(JJPLEphem, name))
        assert list(a.parameters) == list(b.parameters), name
        assert [p.default for p in a.parameters.values()] == [p.default for p in b.parameters.values()], name
    assert [f.name for f in dataclasses.fields(ObsDataset)] == [f.name for f in dataclasses.fields(JObsDataset)]


@pytest.mark.parametrize("name", FIXTURES)
def test_dataset_accessors_match_jax(name):
    path = os.path.join(DATA, f"{name}.obs")
    ds = ObsDataset.from_records(parse_file(path))
    jds = JObsDataset.from_records(j_parse_file(path))
    assert ds.traj_ids == jds.traj_ids and len(ds) == len(jds)
    np.testing.assert_array_equal(ds.mjd_tt, jds.mjd_tt)
    ds.with_error_model(ErrorModel.fcct14())
    jds.with_error_model(JErrorModel.fcct14())
    np.testing.assert_array_equal(ds.ra_error, jds.ra_error)
    assert ObsDataset.with_error_model is ObsDataset.apply_model_errors is ObsDataset.apply_error_model
    ds.apply_model_errors(ErrorModel.vfcc17())
    jds.apply_model_errors(JErrorModel.vfcc17())
    np.testing.assert_array_equal(ds.dec_error, jds.dec_error)
    assert list(ds.par_iter_traj_id()) == list(jds.par_iter_traj_id()) == list(ds.iter_traj_id())
    assert [vars(o) for o in ds.iter_observer()] == [vars(o) for o in jds.iter_observer()]
    assert vars(ds.get_observer(0)) == vars(jds.get_observer(0))

    def same(a, b):
        assert type(a).__name__ == type(b).__name__ == "Observation"
        va, vb = dict(vars(a)), dict(vars(b))
        assert vars(va.pop("observer")) == vars(vb.pop("observer"))
        assert va == vb

    obs = list(ds.iter_observations())
    assert len(obs) == len(ds)
    for a, b in zip(obs, jds.iter_observations()):
        same(a, b)
    for tid in ds.traj_ids:
        mat, jmat = ds.materialize_trajectory(tid), jds.materialize_trajectory(tid)
        assert len(mat) == len(jmat) == ds.len_trajectory(tid)
        for a, b in zip(mat, jmat):
            same(a, b)
        assert [o.mjd_tt for o in mat] == sorted(o.mjd_tt for o in mat)
    assert outfit_tpu_torch.observations.Observation is type(obs[0])
