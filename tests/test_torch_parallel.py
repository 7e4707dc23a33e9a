"""Fits split over a device list (the port's counterpart of ``mesh=``), and
``fit_lsq_dispatch`` / ``fit_lsq_finalize``.

* ``outfit_tpu_torch.parallel`` against ``outfit_tpu.parallel``:
  ``pad_to_multiple`` equal on a grid, ``resolve_mesh``'s error the same
  text, ``shard_batch`` giving the JAX mesh's shards where the length
  divides.
* A split over ``["cpu", "cpu"]`` and ``["cpu"] * 3`` is bitwise the
  single-device fit, every field of every row (the pre-warm's trip count in
  ``total_newton_iterations`` included), for ``fit_full_iod``, ``fit_lsq``
  seeded and unseeded in float64 and mixed precision, ``fit_lsq_stream``
  (dicts and tables), ``fit_lsq_escalating`` and
  ``fit_lsq_stream_escalating``: the three MPC fixtures tiled in blocks to
  48 trajectories of 22 to 129 observations, so the chunks (16 rows and
  up, the least a split gives) have other widths and other pre-warm trip
  counts than the whole batch.
* The port's split against the JAX package's single-device fit at
  tests/test_parallel.py::TestUserApiSharded's bars (IOD elements rtol
  1e-9, LSQ RMS and elements rtol 1e-8), the JAX draws injected, on that
  test's three fixtures, whole, tiled to 48 trajectories; the IOD RMS at
  5e-9 (XLA's fused multiply-adds, at the assert).  The split itself adds
  nothing: it is bitwise one device.
* ``fit_lsq_finalize(fit_lsq_dispatch(...))`` is ``fit_lsq(...)``, bitwise,
  as a dict and as a table.
"""

import os

import numpy as np
import pytest
import torch

from outfit_tpu.ephem import JPLEphem as JJPLEphem
from outfit_tpu.iod import IODParams as JIODParams
from outfit_tpu.iod.api import fit_full_iod as j_fit_full_iod
from outfit_tpu.lsq import fit_lsq as j_fit_lsq
from outfit_tpu.observations import ObsDataset as JObsDataset
from outfit_tpu.parallel import data_mesh as j_data_mesh
from outfit_tpu.parallel import pad_to_multiple as j_pad_to_multiple
from outfit_tpu.parallel import resolve_mesh as j_resolve_mesh
from outfit_tpu.parallel import shard_batch as j_shard_batch
from outfit_tpu_torch import (
    DifferentialCorrectionConfig,
    ErrorModel,
    IODParams,
    JPLEphem,
    ObsDataset,
    fit_full_iod,
    fit_lsq,
    fit_lsq_escalating,
    fit_lsq_stream,
    fit_lsq_stream_escalating,
)
from outfit_tpu_torch.iod.api import _fit_full_iod
from outfit_tpu_torch.lsq import fit_lsq_dispatch, fit_lsq_finalize
from outfit_tpu_torch.lsq.api import _fit_lsq
from outfit_tpu_torch.parallel import auto_mesh, data_mesh, pad_to_multiple, replicate, resolve_mesh, shard_batch
from outfit_tpu_torch.parallel.sharding import chunk_bounds, fit_devices, split_bounds

from test_torch_iod import jax_draws
from test_torch_table import _assert_result_equal, _columns, _same

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SPAN = (53500.0, 61500.0)
NAMES = ("2015AB", "8467", "33803")
SMALL = dict(n_noise_realizations=2, max_triplets=3)
SPLITS = [["cpu", "cpu"], ["cpu"] * 3]

pytestmark = pytest.mark.filterwarnings("ignore:observatory .* SOLVED")


@pytest.fixture(scope="module")
def teph():
    return JPLEphem.analytic(*SPAN)


def _tiled(n=48, drop=1, cls=ObsDataset):
    """The three fixtures tiled to ``n`` trajectories in three blocks
    (2015AB, 8467, 33803 copies), copy j of a block keeping the last ``len -
    drop * j`` observations: so the chunks of a split differ in width and
    in their pre-warm trip counts from the whole batch.  48 rows: a split's
    chunks hold at least 16."""
    bases = [cls.from_mpc_80_col(os.path.join(DATA, f"{m}.obs")) for m in NAMES]
    parts = []
    for k in range(n):
        b, j = bases[3 * k // n], k - (3 * k // n) * n // 3
        keep = len(b) - drop * j
        parts.append(b.subset(np.arange(len(b) - keep, len(b))))
    return cls.concat(parts, rename=lambda k, t: f"{k}|{t}")


# ---------------------------------------------------------------------------
# outfit_tpu_torch.parallel against outfit_tpu.parallel
# ---------------------------------------------------------------------------


def test_pad_to_multiple_matches_jax():
    for n in range(0, 70):
        for k in range(1, 9):
            assert pad_to_multiple(n, k) == j_pad_to_multiple(n, k), (n, k)


def test_resolve_and_data_mesh():
    for m in (None, False):
        assert resolve_mesh(m) is None and j_resolve_mesh(m) is None
    for bad in ("cuda", "", "Auto"):
        with pytest.raises(ValueError) as port:
            resolve_mesh(bad)
        with pytest.raises(ValueError) as ref:
            j_resolve_mesh(bad)
        assert str(port.value) == str(ref.value)
    cpu = torch.device("cpu")
    assert resolve_mesh(["cpu", "cpu"]) == data_mesh(("cpu", cpu)) == (cpu, cpu)
    cards = tuple(torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count()))
    assert data_mesh() == cards
    assert auto_mesh() == (cards if len(cards) > 1 else None) == resolve_mesh("auto")


def test_fit_devices():
    cpu = torch.device("cpu")
    assert fit_devices("cpu") == fit_devices(cpu) == (cpu,)
    assert fit_devices(["cpu"] * 3) == (cpu,) * 3
    with pytest.raises(ValueError):
        fit_devices([])
    if torch.cuda.is_available():
        assert fit_devices(None) == fit_devices("auto") == data_mesh()
    else:
        assert fit_devices(None) == (cpu,)
        with pytest.raises(RuntimeError):
            fit_devices("auto")


@pytest.mark.parametrize("n", [0, 1, 2, 7, 12, 4096])
@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_split_bounds_are_array_split(n, k):
    want = [(int(c[0]), int(c[-1]) + 1) if c.size else None for c in np.array_split(np.arange(n), k)]
    got = split_bounds(n, k)
    assert [b if b[0] < b[1] else None for b in got] == want
    assert got[0][0] == 0 and got[-1][1] == n and all(a[1] == b[0] for a, b in zip(got, got[1:]))


def test_shard_batch_matches_jax_shards():
    import jax

    x = np.arange(48.0).reshape(16, 3)
    for k in (2, 4, 8):
        ref = j_shard_batch(j_data_mesh(jax.devices()[:k]), x)
        shards = sorted(ref.addressable_shards, key=lambda s: s.index[0].start)
        got = shard_batch(data_mesh(["cpu"] * k), torch.as_tensor(x))
        assert len(got) == k
        for a, s in zip(got, shards):
            np.testing.assert_array_equal(a.numpy(), np.asarray(s.data))


def test_shard_batch_and_replicate_nested():
    from typing import NamedTuple

    class Pair(NamedTuple):
        a: torch.Tensor
        b: object

    rng = np.random.default_rng(5)
    x = (torch.as_tensor(rng.normal(size=10)), Pair(rng.normal(size=(10, 2)), None), [torch.ones(10, 3)])
    mesh = data_mesh(["cpu"] * 3)
    parts = shard_batch(mesh, x)
    assert [p[0].shape[0] for p in parts] == [4, 3, 3]
    assert all(isinstance(p[1], Pair) and p[1].b is None and isinstance(p[2], list) for p in parts)
    np.testing.assert_array_equal(torch.cat([p[0] for p in parts]).numpy(), x[0].numpy())
    np.testing.assert_array_equal(torch.cat([p[1].a for p in parts]).numpy(), x[1].a)
    reps = replicate(mesh, x)
    assert len(reps) == 3
    for r in reps:
        assert torch.equal(r[0], x[0]) and isinstance(r[1], Pair) and r[1].b is None
        np.testing.assert_array_equal(r[1].a.numpy(), x[1].a)
    with pytest.raises(TypeError):
        shard_batch(mesh, (1.0,))


def test_device_bases_upload_once_from_many_threads(monkeypatch):
    """``device_bases`` shares one upload per device between the workers:
    32 threads asking at once get the same tensors, made once per device."""
    import sys
    import threading

    import outfit_tpu_torch.iod.api as iod_api

    calls = []

    def fake(dataset, cache, device):
        calls.append(device)
        return (torch.zeros(1, device=device),)

    monkeypatch.setattr(iod_api, "base_arrays", fake)
    bases = iod_api.device_bases(None, None)
    got, saved = [], sys.getswitchinterval()
    devices = [torch.device("cpu"), torch.device("meta")]
    threads = [threading.Thread(target=lambda i=i: got.append((i % 2, bases(devices[i % 2])))) for i in range(32)]
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads) and len(got) == 32
    assert sorted(map(str, calls)) == ["cpu", "meta"]
    for k in (0, 1):
        assert len({id(b) for i, b in got if i == k}) == 1


def test_mesh_keyword_is_refused(teph):
    ds = _tiled(3)
    for fn in (fit_lsq, fit_full_iod):
        with pytest.raises(TypeError):
            fn(ds, teph, mesh=None)


# ---------------------------------------------------------------------------
# a split is bitwise one device
# ---------------------------------------------------------------------------


def _assert_iod_same(a, b):
    assert list(a) == list(b)
    for tid in a:
        x, y = a[tid], b[tid]
        assert (x.ok, x.error, x.kind, x.corrected, x.rms, x.epoch) == (y.ok, y.error, y.kind, y.corrected, y.rms,
                                                                        y.epoch), tid
        for f in ("elements", "equinoctial"):
            assert (getattr(x, f) is None) == (getattr(y, f) is None), (tid, f)
            if getattr(x, f) is not None:
                np.testing.assert_array_equal(getattr(x, f), getattr(y, f), err_msg=f"{tid}.{f}")


def _assert_lsq_same(a, b):
    assert list(a) == list(b)
    for tid in a:
        _assert_result_equal(a[tid], b[tid], tid)


def _assert_table_same(a, b):
    assert a.traj_ids == b.traj_ids and a.host_errors == b.host_errors
    for name in _columns(a):
        assert _same(getattr(a, name), getattr(b, name)), name


def _assert_same_output(a, b):
    if isinstance(a, dict):
        first = next(iter(a.values()), None)
        (_assert_lsq_same if hasattr(first, "fell_back_to_iod") else _assert_iod_same)(a, b)
    elif isinstance(a, list):
        assert len(a) == len(b)
        for (da, ra), (db, rb) in zip(a, b):
            assert da.traj_ids == db.traj_ids
            _assert_same_output(ra, rb)
    else:
        _assert_table_same(a, b)


def _seeds(teph):
    """Per-trajectory seeds: the float64 IOD of the tiled dataset."""
    return fit_full_iod(_tiled(), teph, IODParams(**SMALL), 42, error_model=ErrorModel.fcct14(), device="cpu")


def _run(path, teph, device):
    """One fit of the tiled dataset along ``path`` on ``device``."""
    em = ErrorModel.fcct14()
    f64, mixed = IODParams(**SMALL), IODParams(**SMALL, precision="mixed")
    cfg, mcfg = DifferentialCorrectionConfig(), DifferentialCorrectionConfig(precision="mixed")
    if path == "iod":
        return fit_full_iod(_tiled(), teph, f64, 42, error_model=em, device=device)
    if path == "lsq f64":
        return fit_lsq(_tiled(), teph, f64, cfg, 42, error_model=em, device=device)
    if path == "lsq mixed":
        return fit_lsq(_tiled(), teph, mixed, mcfg, 42, error_model=em, device=device)
    if path.startswith("seeded"):
        c = mcfg if path.endswith("mixed") else cfg
        return fit_lsq(_tiled(), teph, f64, c, error_model=em, initial_orbits=_seeds(teph), device=device)
    datasets = [_tiled(), _tiled(36, drop=2)]
    if path.startswith("stream"):
        table = path.endswith("table")
        return list(fit_lsq_stream(datasets, teph, mixed, mcfg, 42, error_model=em, as_table=table,
                                   minimal_fetch=table, device=device))
    # a lean stage, then the small profile; besides the lean failures, the
    # 8467 and 33803 copies are refitted, so the refits split too
    lean = (IODParams(n_noise_realizations=0, max_triplets=2),
            DifferentialCorrectionConfig(max_newton_iterations=3, divergence_grace_iterations=0))
    stages = [lean, (f64, cfg)]

    def retry(r):
        return not r.ok or r.fell_back_to_iod or int(r.traj_id.split("|")[0]) % 3 != 0

    if path == "escalating":
        return fit_lsq_escalating(_tiled(), teph, stages, 42, error_model=em, retry_if=retry, device=device)
    return list(fit_lsq_stream_escalating(datasets, teph, stages, 42, error_model=em, retry_if=retry,
                                          flush_every=2, device=device))


PATHS = ["iod", "lsq f64", "lsq mixed", "seeded f64", "seeded mixed", "stream dict", "stream table", "escalating",
         "stream escalating"]


@pytest.fixture(scope="module")
def single():
    """The single-device fits, per path, made when first asked for."""
    return {}


@pytest.mark.parametrize("devices", SPLITS, ids=["x2", "x3"])
@pytest.mark.parametrize("path", PATHS)
def test_split_equals_one_device(teph, single, path, devices):
    if path not in single:
        single[path] = _run(path, teph, "cpu")
    ref = single[path]
    got = _run(path, teph, devices)
    _assert_same_output(ref, got)


def test_split_tiled_dataset_is_what_the_tests_say(teph):
    """The tiled dataset's chunks: 16 rows each in the three-way split, the
    first two narrower than the dataset; in mixed precision the chunks'
    pre-warm trip counts differ (so the single-device count is really
    restored), and rows converge."""
    import outfit_tpu_torch.lsq.api as api

    ds = _tiled()
    lens = [ds.len_trajectory(t) for t in ds.traj_ids]
    chunks = chunk_bounds([(0, len(lens))], 3)
    assert chunks == [(0, 16), (16, 32), (32, 48)]
    assert [max(lens[a:b]) for a, b in chunks] == [37, 61, 129]
    counts = []
    real = api._correct

    def spy(*a, **k):
        out = real(*a, **k)
        counts.append(out[1])
        return out

    try:
        api._correct = spy
        res = _run("lsq mixed", teph, ["cpu"] * 3)
    finally:
        api._correct = real
    assert len(counts) == 3 and len(set(counts)) > 1, counts
    assert sum(r.ok and not r.fell_back_to_iod for r in res.values()) >= 40


def test_chunk_bounds():
    """Boundaries at span edges or 16k rows into a span with 16 rows after
    them, near an even split; short batches are not split."""
    assert chunk_bounds([(0, 4096)], 2) == [(0, 2048), (2048, 4096)]
    assert chunk_bounds([(0, 4096)], 3) == [(0, 1360), (1360, 2736), (2736, 4096)]
    assert chunk_bounds([(0, 31)], 2) == [(0, 0), (0, 31)]
    assert chunk_bounds([(0, 10), (10, 50), (50, 53)], 2) == [(0, 26), (26, 53)]
    assert chunk_bounds([], 2) == [(0, 0), (0, 0)]
    rng = np.random.default_rng(9)
    for _ in range(200):
        ends = np.cumsum(rng.integers(1, 80, rng.integers(1, 6)))
        spans = list(zip([0] + ends[:-1].tolist(), ends.tolist()))
        k = int(rng.integers(1, 5))
        got = chunk_bounds(spans, k)
        assert len(got) == k and got[0][0] == 0 and got[-1][1] == ends[-1]
        assert all(a[1] == b[0] and a[0] <= a[1] for a, b in zip(got, got[1:]))
        for s, e in spans:  # every piece a whole span or 16k rows at 16k into it
            for a, b in got:
                lo, hi = max(a, s), min(b, e)
                if lo < hi and (lo, hi) != (s, e):
                    assert (lo - s) % 16 == 0 and hi - lo >= 16


# ---------------------------------------------------------------------------
# the port's split against the JAX package's single device
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_single():
    """tests/test_parallel.py::TestUserApiSharded's single-device fits, on
    its three fixtures, whole, tiled to 48 trajectories (so the port's fit
    splits)."""
    jeph = JJPLEphem.analytic(*SPAN)
    p = JIODParams(n_noise_realizations=5)
    iod = j_fit_full_iod(_tiled(drop=0, cls=JObsDataset), jeph, p, seed=42, mesh=None)
    lsq = j_fit_lsq(_tiled(drop=0, cls=JObsDataset), jeph, p, seed=42, mesh=None)
    return iod, lsq


@pytest.mark.parametrize("devices", SPLITS, ids=["x2", "x3"])
def test_split_matches_jax_single_device(teph, jax_single, devices):
    jiod, jlsq = jax_single
    p = IODParams(n_noise_realizations=5)
    draws = jax_draws(42, p)
    iod = _fit_full_iod(_tiled(drop=0), teph, p, 42, None, None, None, devices, draws)
    assert list(iod) == list(jiod) and len(iod) == 48
    worst = {"iod rms": 0.0, "iod elements": 0.0, "lsq rms": 0.0, "lsq elements": 0.0}
    for tid, a in iod.items():
        s = jiod[tid]
        assert a.ok and s.ok
        assert a.kind == s.kind and a.corrected == s.corrected
        # the IOD RMS is the one quantity the JAX bar does not fit: XLA
        # contracts a*b+c into fused multiply-adds on the CPU, PyTorch rounds
        # each product, and the Gauss chain amplifies that last ulp into the
        # windowed RMS (tests/test_torch_iod.py holds the untiled fixtures at
        # 2e-9; these 48 rows' draws reach 2.1e-9), while the elements agree
        # to 1e-11; the split adds nothing, it is bitwise one device
        np.testing.assert_allclose(a.rms, s.rms, rtol=5e-9)
        np.testing.assert_allclose(a.elements, np.asarray(s.elements), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(a.epoch, s.epoch, rtol=0, atol=1e-9)
        worst["iod rms"] = max(worst["iod rms"], abs(a.rms - s.rms) / abs(s.rms))
        worst["iod elements"] = max(worst["iod elements"], float(np.max(
            np.abs(a.elements - np.asarray(s.elements)) / np.maximum(np.abs(np.asarray(s.elements)), 1e-300))))
    lsq = _fit_lsq(_tiled(drop=0), teph, p, DifferentialCorrectionConfig(), 42, None, None, None, None, devices,
                   draws)
    assert list(lsq) == list(jlsq)
    for tid, a in lsq.items():
        s = jlsq[tid]
        assert a.ok and s.ok
        assert a.fell_back_to_iod == s.fell_back_to_iod
        np.testing.assert_allclose(a.normalised_rms, s.normalised_rms, rtol=1e-8)
        np.testing.assert_allclose(a.equinoctial, np.asarray(s.equinoctial), rtol=1e-8, atol=1e-12)
        worst["lsq rms"] = max(worst["lsq rms"], abs(a.normalised_rms - s.normalised_rms) / abs(s.normalised_rms))
        worst["lsq elements"] = max(worst["lsq elements"], float(np.max(
            np.abs(a.equinoctial - np.asarray(s.equinoctial)) / np.abs(np.asarray(s.equinoctial)))))
    print(f"split {len(devices)} vs JAX single device, largest relative deviation: {worst}")


# ---------------------------------------------------------------------------
# dispatch / finalize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("as_table", [False, True], ids=["dict", "table"])
@pytest.mark.parametrize("device", ["cpu", ["cpu", "cpu"]], ids=["one", "x2"])
def test_finalize_of_dispatch_is_fit_lsq(teph, as_table, device):
    p, cfg, em = IODParams(**SMALL, precision="mixed"), DifferentialCorrectionConfig(precision="mixed"), \
        ErrorModel.fcct14()
    ref = fit_lsq(_tiled(32), teph, p, cfg, 42, error_model=em, as_table=as_table, device="cpu")
    pending = fit_lsq_dispatch(_tiled(32), teph, p, cfg, 42, error_model=em, as_table=as_table, device=device)
    got = fit_lsq_finalize(pending)
    _assert_same_output(ref, got)
    assert fit_lsq_finalize(pending) is got


def test_dispatch_fetch_modes(teph):
    with pytest.raises(ValueError, match="minimal_fetch=True requires as_table=True"):
        fit_lsq_dispatch(_tiled(3), teph, minimal_fetch=True, device="cpu")
    p, em = IODParams(**SMALL), ErrorModel.fcct14()
    ds = _tiled(6)
    slim = fit_lsq_finalize(fit_lsq_dispatch(ds, teph, p, seed=42, error_model=em, slim_fetch=True, as_table=True,
                                             minimal_fetch=True, device="cpu"))
    ref = next(iter(fit_lsq_stream([_tiled(6)], teph, p, seed=42, error_model=em, slim_fetch=True, as_table=True,
                                   minimal_fetch=True, device="cpu")))[1]
    _assert_table_same(ref, slim)
