"""The port's CUDA kernel on the card: each test is marked ``gpu`` and skips
without a CUDA device.

This file imports no JAX, so it runs on a machine that has none.  There,
skip tests/conftest.py (it sets up JAX):

    python -m pytest tests/test_torch_gpu.py --noconftest -q -p no:cacheprovider

Bars: the JAX package's own for its Pallas kernel (tests/test_ephem.py:
atol 1e-15 AU on position, 1e-16 AU/day on velocity); the frame table's
entries (rotation-matrix entries and the equation of the equinoxes) at 1e-15.
The IOD on the card against the CPU: the noise draws and triplet indices
identical, outcomes and flags identical, elements and RMS at rtol 1e-8.
Mixed precision on the card against the CPU at the seed-grade bars of
tests/test_torch_mixed.py (float32 rounds differently on the two); mixed
results identical whether TF32 matmuls are allowed or not; the stream on
the card bitwise equal to sequential fits; the kernel's first build and
launch counts, and the shared device constants, safe from two threads.
The kernel against its plain version through every planet table of the
N-body path (8 to 14 coefficients) at the table's scale (1e-15 AU and 1e-16
AU/day times max(1, largest distance in AU)); a fit split over the card
named twice bitwise the single-device fit with one observer cache build;
``propagate_nbody`` on the
card against the CPU at 1e-10 AU with its exact launch count, and
``compute_apparent`` at 1e-12.  The kernel on tables parsed from NAIF and
Horizon files at DE440's coefficient counts (6, 7, 11, 13) at the same
scaled bar, and a fit from such a file with three body launches and one
frame launch per cache build, card against CPU at rtol 1e-6 / atol 1e-9.
A span of ``outfit_tpu_torch.trace`` holds the interval of a kernel it
waited for in a torch.profiler trace, on the same clock.
The IOD's f-g correction kernel against its plain loop on short arcs of
the stream's profile (``tests/short_arcs.py``): flags identical,
positions, velocities, epochs and warm starts bitwise, the same trips, live
and lanes at the site ``iod_fg``, in the float32 (L, K), float64 (L, K) and
float64 polish (T,) call shapes; a candidate bitwise the same in a
sub-batch; two launches a mixed IOD chunk and one a float64 chunk; the
wrapper's refusals.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from outfit_tpu_torch import (
    DifferentialCorrectionConfig,
    ErrorModel,
    FitResult,
    IODParams,
    JPLEphem,
    ObsDataset,
    fit_full_iod,
    fit_lsq,
    fit_lsq_stream,
)
from outfit_tpu_torch.ephem import chebyshev_cuda
from outfit_tpu_torch.ephem.bodies import Body
from outfit_tpu_torch.ephem.chebyshev import interpolate_body, interpolate_body_plain
from outfit_tpu_torch.iod.noise import draw_noise, trajectory_keys
from outfit_tpu_torch.iod.triplets import _enum_device
from outfit_tpu_torch.observer.cache import _frame_interp, _frame_interp_plain, _frame_table, frame_granules

pytestmark = [pytest.mark.gpu, pytest.mark.filterwarnings("ignore:observatory .* SOLVED")]

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SPAN = (53500.0, 61500.0)
FIXTURES = ("2015AB", "8467", "33803", "K25D50B")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def eph():
    return JPLEphem.analytic(*SPAN)


def _epochs(seed, n, lo=SPAN[0] + 50.0, hi=SPAN[1] - 50.0):
    return np.random.default_rng(seed).uniform(lo, hi, n)


@pytest.mark.parametrize("body", [Body.EMB, Body.MOON])
@pytest.mark.parametrize("n", [37, 4096])
def test_body_kernel_matches_plain(eph, cuda, body, n):
    table = eph.to(cuda).tables[body]
    mjd = torch.as_tensor(_epochs(11, n), device=cuda)
    before = chebyshev_cuda.launches["body"]
    p, v = interpolate_body(table, mjd)
    p0, v0 = interpolate_body_plain(table, mjd)
    torch.cuda.synchronize()
    assert chebyshev_cuda.launches["body"] == before + 1
    np.testing.assert_allclose(p.cpu().numpy(), p0.cpu().numpy(), rtol=0, atol=1e-15)
    np.testing.assert_allclose(v.cpu().numpy(), v0.cpu().numpy(), rtol=0, atol=1e-16)


@pytest.mark.parametrize("n", [37, 4096])
def test_frame_kernel_matches_plain(cuda, n):
    mjd_np = _epochs(12, n, 57000.0, 57160.0)
    n_gran, gran, t0 = frame_granules(mjd_np)
    coeffs = _frame_table(t0, gran, n_gran, cuda)
    mjd = torch.as_tensor(mjd_np, device=cuda)
    before = chebyshev_cuda.launches["frame"]
    m, e = _frame_interp(coeffs, mjd, t0, gran)
    m0, e0 = _frame_interp_plain(coeffs, mjd, t0, gran)
    torch.cuda.synchronize()
    assert chebyshev_cuda.launches["frame"] == before + 1
    assert m.shape == (n, 3, 3) and e.shape == (n,)
    np.testing.assert_allclose(m.cpu().numpy(), m0.cpu().numpy(), rtol=0, atol=1e-15)
    np.testing.assert_allclose(e.cpu().numpy(), e0.cpu().numpy(), rtol=0, atol=1e-15)


#: queries of the kernel's tile (kTile in outfit_tpu_torch/csrc/chebyshev.cuh)
TILE = 128
#: query orders and sizes: one row to one row per query in a tile, more
#: distinct rows than one round of shared memory holds, ragged last tiles,
#: epochs clamped to the table's ends
ORDERS = ["path", "shuffled", "one_granule", "own_granule", "many_rows", "n1", "n37",
          "tile_minus_1", "tile_plus_1", "clamped"]


def _order_epochs(order, t0, gran, n_gran, seed=21):
    """Epochs over a table of ``n_gran`` granules from ``t0``, in the named
    order: ``path`` 32 time-sorted trajectories of 128 epochs over 40 days,
    ``shuffled`` the same permuted, ``one_granule`` 4096 epochs in one,
    ``own_granule`` each epoch in a granule of its own (within a tile),
    ``many_rows`` 150 granules over every 150 epochs (at least 120 distinct
    rows a tile, more than one round holds), ``n*`` / ``tile_*`` random
    epochs at those counts, ``clamped`` epochs up to a tenth of a granule
    outside coverage on both sides among epochs inside."""
    rng = np.random.default_rng(seed)
    span = n_gran * gran
    if order in ("path", "shuffled"):
        start = rng.uniform(t0, t0 + span - 40.0, 32)
        q = np.concatenate([s + np.sort(rng.uniform(0.0, 40.0, 128)) for s in start])
        return q if order == "path" else rng.permutation(q)
    if order == "one_granule":
        return t0 + (n_gran // 2 + rng.uniform(0.05, 0.95, 4096)) * gran
    if order in ("own_granule", "many_rows"):
        j = np.arange(4096)
        k = TILE if order == "own_granule" else 150
        g = j % k * n_gran // k
        return t0 + (g + rng.uniform(0.05, 0.95, 4096)) * gran
    if order == "clamped":
        out = np.concatenate([t0 - rng.uniform(0, 0.1, 100) * gran, t0 + span + rng.uniform(0, 0.1, 100) * gran])
        return rng.permutation(np.concatenate([out, rng.uniform(t0, t0 + span, 300)]))
    n = {"n1": 1, "n37": 37, "tile_minus_1": TILE - 1, "tile_plus_1": TILE + 1}[order]
    return rng.uniform(t0, t0 + span, n)


def _body_against_plain(table, mjd_np, cuda):
    mjd = torch.as_tensor(mjd_np, device=cuda)
    before = chebyshev_cuda.launches["body"]
    p, v = interpolate_body(table, mjd)
    p0, v0 = interpolate_body_plain(table, mjd)
    torch.cuda.synchronize()
    assert chebyshev_cuda.launches["body"] == before + 1
    assert p.shape == v.shape == (len(mjd_np), 3)
    np.testing.assert_allclose(p.cpu().numpy(), p0.cpu().numpy(), rtol=0, atol=1e-15)
    np.testing.assert_allclose(v.cpu().numpy(), v0.cpu().numpy(), rtol=0, atol=1e-16)


def _frame_against_plain(coeffs, mjd_np, t0, gran, cuda):
    mjd = torch.as_tensor(mjd_np, device=cuda)
    before = chebyshev_cuda.launches["frame"]
    m, e = _frame_interp(coeffs, mjd, t0, gran)
    m0, e0 = _frame_interp_plain(coeffs, mjd, t0, gran)
    torch.cuda.synchronize()
    assert chebyshev_cuda.launches["frame"] == before + 1
    assert m.shape == (len(mjd_np), 3, 3) and e.shape == (len(mjd_np),)
    np.testing.assert_allclose(m.cpu().numpy(), m0.cpu().numpy(), rtol=0, atol=1e-15)
    np.testing.assert_allclose(e.cpu().numpy(), e0.cpu().numpy(), rtol=0, atol=1e-15)


@pytest.mark.parametrize("order", ORDERS)
def test_body_kernel_matches_plain_in_every_order(eph, cuda, order):
    """The EMB table (500 granules of 16 days, 14 coefficients)."""
    table = eph.to(cuda).tables[Body.EMB]
    n_gran = table.coeffs.shape[0]
    _body_against_plain(table, _order_epochs(order, table.t0, table.granule_days, n_gran), cuda)


@pytest.mark.parametrize("order", ORDERS)
def test_frame_kernel_matches_plain_in_every_order(cuda, order):
    """A frame table of 512 granules of 8 days (14 coefficients)."""
    n_gran, gran, t0 = frame_granules(np.array([57000.0, 57000.0 + 8.0 * 512]))
    coeffs = _frame_table(t0, gran, n_gran, cuda)
    _frame_against_plain(coeffs, _order_epochs(order, t0, gran, n_gran), t0, gran, cuda)


#: the analytic tables' coefficient counts and the launcher's two ends
N_COEFFS = [2, 8, 10, 12, 13, 14, 32]


def _unit_table(n_chan, n_coeff, scale, seed):
    """A (256, n_chan, n_coeff) table of decaying random coefficients,
    values of order ``scale`` (below 1, where the bars of 1e-15 and 1e-16
    hold a few ulps of summation order)."""
    rng = np.random.default_rng(seed)
    c = rng.normal(0.0, 1.0, (256, n_chan, n_coeff)) * 0.3 ** np.arange(n_coeff) * scale
    return torch.as_tensor(c)


@pytest.mark.parametrize("n_coeff", N_COEFFS)
def test_body_kernel_matches_plain_at_every_coefficient_count(eph, cuda, n_coeff):
    """The analytic body with that count (an outer planet scaled down to
    1 AU, where the JAX bar applies), or a random table at the launcher's
    ends."""
    from outfit_tpu_torch.ephem.chebyshev import BodyTable

    bodies = [b for b, t in eph.tables.items() if t.coeffs.shape[2] == n_coeff]
    if bodies:
        src = eph.tables[bodies[0]]
        coeffs = src.coeffs / max(1.0, float(src.coeffs[:, :, 0].abs().max()))
        table = BodyTable(src.t0, src.granule_days, coeffs.contiguous().to(cuda))
    else:
        table = BodyTable(57000.0, 16.0, _unit_table(3, n_coeff, 0.1, n_coeff).to(cuda))
    n_gran = table.coeffs.shape[0]
    for order in ("path", "own_granule"):
        _body_against_plain(table, _order_epochs(order, table.t0, table.granule_days, n_gran), cuda)


@pytest.mark.parametrize("n_coeff", N_COEFFS)
def test_frame_kernel_matches_plain_at_every_coefficient_count(cuda, n_coeff):
    coeffs = _unit_table(10, n_coeff, 0.1, 100 + n_coeff).to(cuda)
    for order in ("path", "own_granule"):
        _frame_against_plain(coeffs, _order_epochs(order, 57000.0, 8.0, 256), 57000.0, 8.0, cuda)


@pytest.mark.parametrize("offset", [0, 1])
def test_odd_width_rows_at_either_alignment(eph, cuda, offset):
    """The Moon's 3 x 13 rows (312 bytes) start 16-byte aligned or 8 bytes
    past; the table itself may too.  Each row is copied as its aligned part
    and one element alone, from either end."""
    from outfit_tpu_torch.ephem.chebyshev import BodyTable

    src = eph.tables[Body.MOON]
    assert src.coeffs.shape[1:] == (3, 13)
    flat = torch.zeros(src.coeffs.numel() + 1, dtype=torch.float64, device=cuda)
    coeffs = flat[offset:offset + src.coeffs.numel()].view(src.coeffs.shape)
    coeffs.copy_(src.coeffs)
    assert coeffs.data_ptr() % 16 == 8 * offset
    table = BodyTable(src.t0, src.granule_days, coeffs)
    for order in ("path", "own_granule", "many_rows"):
        _body_against_plain(table, _order_epochs(order, table.t0, table.granule_days, coeffs.shape[0]), cuda)


@pytest.mark.parametrize("bad", ["float32", "noncontiguous", "too_many_coeffs", "wrong_channels", "misaligned"])
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda, bad):
    coeffs = torch.zeros((4, 3, 14), dtype=torch.float64, device=cuda)
    mjd = torch.zeros(8, dtype=torch.float64, device=cuda)
    if bad == "float32":
        mjd = mjd.float()
    elif bad == "noncontiguous":
        mjd = torch.zeros(16, dtype=torch.float64, device=cuda)[::2]
    elif bad == "misaligned":  # contiguous, 8 bytes past a 16-byte boundary
        coeffs = torch.zeros(4 * 3 * 14 + 1, dtype=torch.float64, device=cuda)[1:].view(4, 3, 14)
    elif bad == "too_many_coeffs":
        coeffs = torch.zeros((4, 3, 40), dtype=torch.float64, device=cuda)
    else:
        coeffs = torch.zeros((4, 10, 14), dtype=torch.float64, device=cuda)
    before = dict(chebyshev_cuda.launches)
    with pytest.raises((TypeError, ValueError)):
        chebyshev_cuda.evaluate(coeffs, mjd, 0.0, 1.0, "body")
    assert chebyshev_cuda.launches == before


def test_fit_lsq_on_card_matches_cpu(eph, cuda):
    """The seeded slice on one fixture: card and CPU give the same status
    and elements at the repo's float64 lane bar (rtol 1e-6 / atol 1e-9)."""
    import json

    with open(os.path.join(DATA, "iod_seeds_analytic.json"), encoding="utf-8") as fh:
        rows = json.load(fh)["33803"]
    seeds = {
        tid: FitResult(**{k: (np.array(v) if isinstance(v, list) else v) for k, v in d.items()})
        for tid, d in rows.items()
    }
    out = {}
    for dev in ("cpu", "cuda"):
        ds = ObsDataset.from_mpc_80_col(os.path.join(DATA, "33803.obs"))
        chebyshev_cuda.reset_launch_counts()
        out[dev] = fit_lsq(
            ds, eph, config=DifferentialCorrectionConfig(), error_model=ErrorModel.fcct14(),
            initial_orbits=seeds, device=dev,
        )["33803"]
        if dev == "cuda":
            assert chebyshev_cuda.launches["body"] > 0 and chebyshev_cuda.launches["frame"] > 0
    a, b = out["cpu"], out["cuda"]
    assert (a.status, a.n_active_obs, a.fell_back_to_iod) == (b.status, b.n_active_obs, b.fell_back_to_iod)
    np.testing.assert_allclose(b.equinoctial, a.equinoctial, rtol=1e-6, atol=1e-9)


def test_noise_draws_same_on_card_and_cpu(cuda):
    keys = trajectory_keys(42, [f"T{i}" for i in range(300)] + ["8467", "K09R05F"])
    z_cpu = draw_noise(torch.as_tensor(keys), 10, 21)
    z_gpu = draw_noise(torch.as_tensor(keys, device=cuda), 10, 21)
    torch.testing.assert_close(z_gpu.cpu(), z_cpu, rtol=0, atol=0)


def test_enum_device_same_on_card_and_cpu(cuda):
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 90, 64)
    epochs = np.zeros((64, int(counts.max())))
    for t, c in enumerate(counts):
        epochs[t, :c] = np.sort(np.round(rng.uniform(0, 120, c), 1))  # ties and zero gaps
    kw = dict(dt_min=0.03, dt_max=150.0, dtw=20.0, max_obs=48, max_triplets=16)
    tc, kc = _enum_device(torch.as_tensor(epochs), torch.as_tensor(counts), **kw)
    tg, kg = _enum_device(torch.as_tensor(epochs, device=cuda), torch.as_tensor(counts, device=cuda), **kw)
    np.testing.assert_array_equal(kg.cpu().numpy(), kc.numpy())
    np.testing.assert_array_equal(tg.cpu().numpy(), tc.numpy())


@pytest.mark.parametrize("name", FIXTURES)
def test_fit_full_iod_on_card_matches_cpu(eph, cuda, name):
    """The stored-seed configuration (default IODParams, seed 42, FCCT14)
    with the port's own draws: card and CPU agree."""
    out = {}
    for dev in ("cpu", "cuda"):
        ds = ObsDataset.from_mpc_80_col(os.path.join(DATA, f"{name}.obs"))
        chebyshev_cuda.reset_launch_counts()
        out[dev] = fit_full_iod(ds, eph, IODParams(), 42, error_model=ErrorModel.fcct14(), device=dev)
        if dev == "cuda":
            assert chebyshev_cuda.launches["body"] > 0 and chebyshev_cuda.launches["frame"] > 0
    for tid, a in out["cpu"].items():
        b = out["cuda"][tid]
        assert (a.ok, a.error, a.kind, a.corrected) == (b.ok, b.error, b.kind, b.corrected), tid
        assert a.ok
        np.testing.assert_allclose(b.equinoctial, a.equinoctial, rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(b.rms, a.rms, rtol=1e-8)
        np.testing.assert_allclose(b.epoch, a.epoch, rtol=1e-14)


def test_unseeded_fit_lsq_on_card_matches_cpu(eph, cuda):
    params = IODParams(n_noise_realizations=3, max_triplets=4)
    out = {}
    for dev in ("cpu", "cuda"):
        ds = ObsDataset.from_mpc_80_col_files([os.path.join(DATA, f"{n}.obs") for n in FIXTURES])
        out[dev] = fit_lsq(ds, eph, params, DifferentialCorrectionConfig(), 42,
                           error_model=ErrorModel.fcct14(), device=dev)
    assert list(out["cuda"]) == list(out["cpu"])
    for tid, a in out["cpu"].items():
        b = out["cuda"][tid]
        assert (a.ok, a.status, a.fell_back_to_iod, a.n_active_obs) == (b.ok, b.status, b.fell_back_to_iod, b.n_active_obs)
        np.testing.assert_allclose(b.iod.equinoctial, a.iod.equinoctial, rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(b.equinoctial, a.equinoctial, rtol=1e-6, atol=1e-9)


MIXED_IOD = dict(n_noise_realizations=3, max_triplets=4, precision="mixed")
MIXED_CFG = dict(precision="mixed", prewarm_max_iterations=16, divergence_grace_iterations=2)


def _mixed_fit(eph, dev):
    ds = ObsDataset.from_mpc_80_col_files([os.path.join(DATA, f"{n}.obs") for n in FIXTURES])
    return fit_lsq(ds, eph, IODParams(**MIXED_IOD), DifferentialCorrectionConfig(**MIXED_CFG), 42,
                   error_model=ErrorModel.fcct14(), device=dev)


def test_mixed_fit_on_card_matches_cpu_at_seed_grade(eph, cuda):
    """IOD: identical success sets, RMS ratio median < 1.001, max < 2,
    elements median rel < 1e-8; LSQ: the same statuses and the same-basin
    criterion |d nRMS| < 1e-6 (1 + nRMS)."""
    cpu, card = _mixed_fit(eph, "cpu"), _mixed_fit(eph, cuda)
    assert list(card) == list(cpu)
    ratio, rel = [], []
    for tid, a in cpu.items():
        b = card[tid]
        assert a.iod.ok == b.iod.ok and (a.ok, a.status, a.fell_back_to_iod) == (b.ok, b.status, b.fell_back_to_iod)
        if a.iod.ok:
            ratio.append(b.iod.rms / a.iod.rms)
            rel.append(np.max(np.abs(b.iod.equinoctial - a.iod.equinoctial) / (1 + np.abs(a.iod.equinoctial))))
        if a.ok and not a.fell_back_to_iod:
            assert abs(b.normalised_rms - a.normalised_rms) < 1e-6 * (1 + a.normalised_rms), tid
    assert np.median(ratio) < 1.001 and max(ratio) < 2.0 and np.median(rel) < 1e-8


def test_mixed_fit_independent_of_tf32(eph, cuda):
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        off = _mixed_fit(eph, cuda)
        torch.backends.cuda.matmul.allow_tf32 = True
        on = _mixed_fit(eph, cuda)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    for tid, a in off.items():
        b = on[tid]
        assert (a.ok, a.status, a.iod.rms, a.normalised_rms) == (b.ok, b.status, b.iod.rms, b.normalised_rms), tid
        np.testing.assert_array_equal(a.equinoctial, b.equinoctial)


def test_stream_on_card_equals_sequential(eph, cuda):
    params, cfg = IODParams(**MIXED_IOD), DifferentialCorrectionConfig(**MIXED_CFG)
    names = FIXTURES[:3]
    kw = dict(error_model=ErrorModel.fcct14(), device=cuda)
    ref = [fit_lsq(ObsDataset.from_mpc_80_col(os.path.join(DATA, f"{n}.obs")), eph, params, cfg, 42, **kw)
           for n in names]
    out = list(fit_lsq_stream([ObsDataset.from_mpc_80_col(os.path.join(DATA, f"{n}.obs")) for n in names],
                              eph, params, cfg, 42, depth=3, **kw))
    for (_, res), r in zip(out, ref):
        assert list(res) == list(r)
        for tid in res:
            a, b = res[tid], r[tid]
            assert (a.ok, a.status, a.iod.rms, a.normalised_rms) == (b.ok, b.status, b.iod.rms, b.normalised_rms)
            np.testing.assert_array_equal(a.equinoctial, b.equinoctial)
            if a.covariance is not None:
                np.testing.assert_array_equal(a.covariance, b.covariance)


def _same_row(a, b):
    import dataclasses

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "iod" and x is not None and y is not None:
            _same_row(x, y)
        elif isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y or (x != x and y != y), (f.name, x, y)


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_split_on_the_card_named_twice_is_one_device(eph, cuda, precision):
    """A two-way split over the card named twice is bitwise the single-device
    fit on every field of every row (the pre-warm's trip count included),
    and each fit builds one observer cache: 2 body + 1 frame launches."""
    card = f"cuda:{torch.cuda.current_device()}"
    mixed = precision == "mixed"
    params = IODParams(**MIXED_IOD) if mixed else IODParams(n_noise_realizations=3, max_triplets=4)
    cfg = DifferentialCorrectionConfig(**MIXED_CFG) if mixed else DifferentialCorrectionConfig()

    def tiled():  # 48 trajectories, 16 copies of each fixture: 16 + 32 rows split two ways
        parts = [ObsDataset.from_mpc_80_col(os.path.join(DATA, f"{n}.obs")) for n in FIXTURES[:3] for _ in range(16)]
        return ObsDataset.concat(parts, rename=lambda k, t: f"{k}|{t}")

    out = {}
    for devices in (card, [card, card]):
        chebyshev_cuda.reset_launch_counts()
        out[str(devices)] = fit_lsq(tiled(), eph, params, cfg, 42, error_model=ErrorModel.fcct14(), device=devices)
        assert chebyshev_cuda.launches == {"body": 2, "frame": 1}, devices
    one, split = out.values()
    assert list(split) == list(one)
    for tid, r in one.items():
        _same_row(r, split[tid])


def test_first_kernel_use_and_constants_from_two_threads(eph, cuda, tmp_path, monkeypatch):
    """Two threads build and load the kernel into an empty build directory
    at once, upload the same device constant, and launch; the library is
    built once, both get the same constant tensor, and no launch is lost
    from the count."""
    from outfit_tpu_torch.utils import tensors

    monkeypatch.setattr(chebyshev_cuda, "_BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(chebyshev_cuda, "_lib", None)
    const = np.arange(7.0)
    table = eph.to(cuda).tables[Body.EMB]
    mjd = torch.as_tensor(_epochs(13, 4096), device=cuda)
    chebyshev_cuda.reset_launch_counts()
    barrier = threading.Barrier(2)
    got, errors = [], []

    def work():
        try:
            barrier.wait(timeout=60)
            got.append(tensors.device_constant(const, cuda))
            for _ in range(50):
                interpolate_body(table, mjd)
            torch.cuda.synchronize()
        except Exception as exc:  # reported below, on the test's thread
            errors.append(exc)

    threads = [threading.Thread(target=work) for _ in range(2)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert got[0] is got[1]
    assert chebyshev_cuda.launches["body"] == 100
    assert len(list(tmp_path.iterdir())) == 1


PLANETS = [Body(b) for b in range(1, 10)]


@pytest.mark.parametrize("body", PLANETS, ids=lambda b: b.name)
@pytest.mark.parametrize("n", [37, 4096])
def test_body_kernel_matches_plain_at_every_planet_table(eph, cuda, body, n):
    """Mercury to Pluto: 8, 10, 12 and 14 coefficients, at stage epochs of
    one 30-day window in lane order (unsorted, nearly equal)."""
    table = eph.to(cuda).tables[body]
    rng = np.random.default_rng(int(body))
    mjd = torch.as_tensor(57000.0 + rng.uniform(0.0, 30.0, n), device=cuda)
    p, v = interpolate_body(table, mjd)
    p0, v0 = interpolate_body_plain(table, mjd)
    scale = max(1.0, float(p0.norm(dim=-1).max()))
    assert float((p - p0).abs().max()) <= 1e-15 * scale
    assert float((v - v0).abs().max()) <= 1e-16 * scale


def _nbody_lanes(n, dev):
    from outfit_tpu_torch.elements.types import EquinoctialElements

    rng = np.random.default_rng(3)
    e, w = rng.uniform(0.0, 0.35, n), rng.uniform(0, 2 * np.pi, n)
    cols = [np.full(n, 57000.0), rng.uniform(1.2, 3.5, n), e * np.sin(w), e * np.cos(w),
            rng.uniform(-0.15, 0.15, n), rng.uniform(-0.15, 0.15, n), rng.uniform(0, 2 * np.pi, n)]
    t1 = 57000.0 + rng.uniform(-30.0, 30.0, n)
    return (EquinoctialElements(*(torch.as_tensor(c, device=dev) for c in cols)), torch.as_tensor(t1, device=dev))


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen", "moving"])
def test_propagate_nbody_on_card_matches_cpu(eph, cuda, frozen):
    from outfit_tpu_torch import NBodyConfig, propagate_nbody

    cfg = NBodyConfig(perturbing_bodies=NBodyConfig.with_planets().perturbing_bodies, frozen_perturbers=frozen)
    chebyshev_cuda.reset_launch_counts()
    rg = propagate_nbody(*_nbody_lanes(64, cuda), eph, cfg)
    launches = chebyshev_cuda.launches["body"]
    rc = propagate_nbody(*_nbody_lanes(64, "cpu"), eph, cfg, device="cpu")
    assert rg.position.device.type == "cuda" and (rg.status == 0).all() and (rc.status == 0).all()
    # nine planet tables per perturber evaluation: one at t0, or thirteen
    # per loop trip
    assert launches == 9 if frozen else (launches > 0 and launches % (9 * 13) == 0)
    np.testing.assert_allclose(rg.position.cpu().numpy(), rc.position.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(rg.velocity.cpu().numpy(), rc.velocity.numpy(), rtol=0, atol=1e-11)
    np.testing.assert_allclose(rg.dpos_delem.cpu().numpy(), rc.dpos_delem.numpy(), rtol=0, atol=1e-8)
    assert (rg.n_steps.cpu() - rc.n_steps).abs().max() <= 2


@pytest.mark.parametrize("kind", ["numpy", "cpu_tensor"])
def test_host_inputs_run_on_the_card_by_default(eph, cuda, kind):
    """``propagate_nbody``, ``dop853_integrate`` and ``gast`` with host
    inputs and no device named run on the card; ``device="cpu"`` asks for
    the CPU."""
    from outfit_tpu_torch import NBodyConfig, Ut1Provider, dop853_integrate, propagate_nbody
    from outfit_tpu_torch.observer.geometry import gast

    eq, t1 = _nbody_lanes(4, "cpu")
    if kind == "numpy":
        eq, t1 = type(eq)(*(f.numpy() for f in eq)), t1.numpy()
    chebyshev_cuda.reset_launch_counts()
    nb = propagate_nbody(eq, t1, eph, NBodyConfig.with_planets())
    assert nb.position.is_cuda and chebyshev_cuda.launches["body"] == 9 and (nb.status == 0).all()
    on_cpu = propagate_nbody(eq, t1, eph, NBodyConfig.with_planets(), device="cpu")
    assert on_cpu.position.device.type == "cpu"
    np.testing.assert_allclose(nb.position.cpu().numpy(), on_cpu.position.numpy(), rtol=0, atol=1e-10)
    y0 = np.ones((4, 1)) if kind == "numpy" else torch.ones((4, 1), dtype=torch.float64)
    assert dop853_integrate(lambda t, y: -y, y0, 0.0, 1.0).y.is_cuda
    assert dop853_integrate(lambda t, y: -y, y0, 0.0, 1.0, device="cpu").y.device.type == "cpu"
    assert gast(t1, Ut1Provider()).is_cuda and gast(t1, Ut1Provider(), "cpu").device.type == "cpu"


@pytest.mark.parametrize("order", [1, 2], ids=["first", "second"])
@pytest.mark.parametrize("nbody", [False, True], ids=["two_body", "n_body"])
def test_compute_apparent_on_card_matches_cpu(eph, cuda, nbody, order):
    from outfit_tpu_torch import AberrationOrder, NBodyConfig, PropagatorKind
    from outfit_tpu_torch.elements.types import EquinoctialElements
    from outfit_tpu_torch.ephemeris.compute import compute_apparent

    prop = PropagatorKind.n_body(NBodyConfig.with_planets()) if nbody else PropagatorKind.two_body()
    out = {}
    for dev in (cuda, torch.device("cpu")):
        eq, _ = _nbody_lanes(32, dev)
        epochs = torch.as_tensor(57000.0 + np.arange(1.0, 9.0), device=dev)
        obs_p, obs_v = eph.to(dev).earth_ephemeris(epochs)
        out[dev.type] = compute_apparent(
            EquinoctialElements(*(f[:, None] for f in eq)), epochs.expand(32, 8), obs_p[None], obs_v[None],
            prop, AberrationOrder(order), eph.to(dev),
        )
    g, c = out["cuda"], out["cpu"]
    assert g.ok.all() and c.ok.all()
    for fg, fc in zip([*g.position, *g.geometry], [*c.position, *c.geometry]):
        np.testing.assert_allclose(fg.cpu().numpy(), fc.numpy(), rtol=0, atol=1e-12)


#: DE440's (subintervals per 32-day block, coefficients) of the bodies whose
#: coefficient counts K1 meets only in DE files: Mars 11, Saturn 7, Uranus 6
#: (with EMB and Moon at 13 and a zero 11-coefficient Sun, as DE440 has them)
DE_FILE_BODIES = {Body.MARS_BARY: (1, 11), Body.SATURN_BARY: (1, 7), Body.URANUS_BARY: (1, 6),
                  Body.EMB: (2, 13), Body.MOON: (8, 13), Body.SUN: (2, 11)}
DE_SLOTS = {Body.MARS_BARY: 3, Body.SATURN_BARY: 5, Body.URANUS_BARY: 6, Body.EMB: 2, Body.MOON: 9, Body.SUN: 10}


def _de_file(tmp_path, fmt, t0=60608.0, blocks=4):
    """A synthetic DE file of format ``fmt`` over ``blocks`` 32-day blocks
    from ``t0``: the analytic source refitted at DE440's layout."""
    from outfit_tpu_torch.ephem import analytic
    from outfit_tpu_torch.ephem.analytic import EMRAT
    from outfit_tpu_torch.ephem.chebyshev import BodyTable, fit_body_table
    from outfit_tpu_torch.ephem.horizon import write_synthetic_horizon
    from outfit_tpu_torch.ephem.naif import write_synthetic_spk

    t1 = t0 + 32.0 * blocks
    tables = {}
    for b, (ns, c) in DE_FILE_BODIES.items():
        gran = 32.0 / ns
        if b == Body.SUN:
            tables[b] = BodyTable(t0, gran, torch.zeros(blocks * ns, 3, c, dtype=torch.float64))
        elif b == Body.MOON:
            tables[b] = fit_body_table(lambda m: analytic._ecl_to_equ(analytic.moon_geocentric_ecliptic(m)),
                                       t0, t1, gran, c)
        else:
            tables[b] = fit_body_table(lambda m, b=b: analytic._ecl_to_equ(analytic.planet_position_ecliptic(b, m)),
                                       t0, t1, gran, c)
    path = str(tmp_path / f"de.{fmt}")
    if fmt == "horizon":
        write_synthetic_horizon(path, {DE_SLOTS[b]: (tb, DE_FILE_BODIES[b][0]) for b, tb in tables.items()})
    else:
        f, moon = 1.0 / (1.0 + EMRAT), tables[Body.MOON]
        segs = [(int(b), 0, tb) for b, tb in tables.items() if b != Body.MOON]
        segs += [(301, 3, BodyTable(moon.t0, moon.granule_days, moon.coeffs * (1.0 - f))),
                 (399, 3, BodyTable(moon.t0, moon.granule_days, moon.coeffs * -f))]
        write_synthetic_spk(path, segs)
    return JPLEphem(f"{fmt}:DE440", path=path)


@pytest.mark.parametrize("fmt", ["naif", "horizon"])
@pytest.mark.parametrize("n", [37, 4096])
def test_body_kernel_matches_plain_on_parsed_files(cuda, tmp_path, fmt, n):
    """K1 on every table parsed from a DE file of each format, C = 6, 7, 11
    and 13 among them, at the table's scale (1e-15 AU and 1e-16 AU/day times
    max(1, largest distance in AU))."""
    eph = _de_file(tmp_path, fmt).to(cuda)
    counts = {int(tb.coeffs.shape[2]) for tb in eph.tables.values()}
    assert {6, 7, 11, 13} <= counts
    mjd = torch.as_tensor(np.random.default_rng(n).uniform(*eph.coverage, n), device=cuda)
    for body, table in eph.tables.items():
        before = chebyshev_cuda.launches["body"]
        p, v = interpolate_body(table, mjd)
        assert chebyshev_cuda.launches["body"] == before + 1
        p0, v0 = interpolate_body_plain(table, mjd)
        scale = max(1.0, float(p0.norm(dim=-1).max()))
        assert float((p - p0).abs().max()) <= 1e-15 * scale, body
        assert float((v - v0).abs().max()) <= 1e-16 * scale, body


@pytest.mark.parametrize("fmt", ["naif", "horizon"])
def test_fit_lsq_from_a_de_file_on_card_matches_cpu(cuda, tmp_path, fmt):
    """The seeded fit of 8467 from a parsed DE file: one cache build
    launches K1 three times at the body site (EMB, Moon or Earth, Sun) and
    once at the frame site; card and CPU agree at rtol 1e-6 / atol 1e-9."""
    import json

    eph = _de_file(tmp_path, fmt)
    with open(os.path.join(DATA, "iod_seeds_analytic.json"), encoding="utf-8") as fh:
        rows = json.load(fh)["8467"]
    seeds = {tid: FitResult(**{k: (np.array(v) if isinstance(v, list) else v) for k, v in d.items()})
             for tid, d in rows.items()}
    out = {}
    for dev in ("cpu", "cuda"):
        chebyshev_cuda.reset_launch_counts()
        out[dev] = fit_lsq(ObsDataset.from_mpc_80_col(os.path.join(DATA, "8467.obs")), eph,
                           config=DifferentialCorrectionConfig(), error_model=ErrorModel.fcct14(),
                           initial_orbits=seeds, device=dev)["8467"]
        assert chebyshev_cuda.launches == ({"body": 3, "frame": 1} if dev == "cuda" else {"body": 0, "frame": 0})
    a, b = out["cpu"], out["cuda"]
    assert a.ok and not a.fell_back_to_iod
    assert (a.status, a.n_active_obs, a.fell_back_to_iod) == (b.status, b.n_active_obs, b.fell_back_to_iod)
    np.testing.assert_allclose(b.equinoctial, a.equinoctial, rtol=1e-6, atol=1e-9)


def test_a_span_holds_its_kernel_on_the_profilers_clock(cuda):
    """A span around a sleep kernel and its synchronize holds the kernel's
    interval in a torch.profiler trace, 100 µs of slack either side: the
    records' ``time.time_ns()`` clock is the one of Kineto's events."""
    from torch.profiler import ProfilerActivity, profile

    from outfit_tpu_torch import trace

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with trace.recording() as records:
            with trace.span("fit"):
                torch.cuda._sleep(20_000_000)  # cycles: about 10 ms
                torch.cuda.synchronize()
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type().name == "CUDA" and e.duration_ns() > 1_000_000]
    (rec,) = records
    assert len(kernels) == 1, [e.name() for e in kernels]
    k = kernels[0]
    slack = 100_000
    assert rec.start_ns - slack <= k.start_ns() and k.start_ns() + k.duration_ns() <= rec.end_ns + slack, (
        rec, k.start_ns(), k.duration_ns())


def _fg_calls(eph, dev, precision, n_traj=512):
    """The calls of ``_fg_correction`` in one IOD of the short-arc stream's
    profile (12 geocentric observations over 40 days, three noise draws, two
    triplets) over ``n_traj`` arcs on ``dev``: (args, kwargs) each."""
    from short_arcs import short_arcs
    from outfit_tpu_torch.iod import gauss

    ds = short_arcs(n_traj, 12, eph, seed=11)
    calls, fg = [], gauss._fg_correction

    def record(*a, **k):
        calls.append((a, k))
        return fg(*a, **k)

    gauss._fg_correction = record
    try:
        fit_full_iod(ds, eph, IODParams(n_noise_realizations=3, precision=precision, newton_max_it=20, max_triplets=2),
                     7, device=dev)
    finally:
        gauss._fg_correction = fg
    return calls


def _same_bits(x, y):
    """Equal, NaN where NaN."""
    return x.shape == y.shape and bool(((x == y) | (torch.isnan(x) & torch.isnan(y))).all())


def _iod_fg_counts(fn):
    from outfit_tpu_torch import trace

    site = trace.sites.iod_fg
    before = (site.trips, site.live, site.lanes)
    out = fn()
    return out, tuple(b - a for a, b in zip(before, (site.trips, site.live, site.lanes)))


@pytest.mark.parametrize("precision", ["mixed", "f64"])
def test_fg_kernel_matches_plain_on_the_card(eph, cuda, precision):
    """The f-g correction kernel against ``_fg_correction_plain`` on the
    card, on the same inputs: the float32 candidate pass (L, K) and the
    float64 polish (T,) of a mixed IOD, the float64 candidate pass of a
    float64 IOD.  Flags identical; positions, velocities, epochs and warm
    starts bitwise (the kernel mirrors PyTorch's rounding and summation
    order on the card); the trips, live and lanes of the site ``iod_fg``
    equal."""
    from outfit_tpu_torch.iod import gauss

    calls = _fg_calls(eph, cuda, precision)
    assert [(a[5].dtype, a[8].dim()) for a, _ in calls] == (
        [(torch.float32, 2), (torch.float64, 1)] if precision == "mixed" else [(torch.float64, 2)])
    for a, k in calls:
        got, n_got = _iod_fg_counts(lambda: gauss._fg_correction(*a, **k))
        ref, n_ref = _iod_fg_counts(lambda: gauss._fg_correction_plain(*a, **k))
        assert n_got == n_ref and n_got[0] > 0
        for name, x, y in zip(("pos", "vel", "epoch", "chi1", "chi2", "alive", "committed"), got, ref):
            assert x.dtype == y.dtype and _same_bits(x, y), (name, a[5].dtype, tuple(a[8].shape))
        assert got[6].any() and not got[6].all()


def test_fg_kernel_candidate_independent_of_its_batch(eph, cuda):
    """A candidate's result is bitwise the same when its triplets are run
    alone as a sub-batch (rows 100 to 163, in both call shapes)."""
    from outfit_tpu_torch.iod import gauss

    rows = slice(100, 164)
    for a, k in _fg_calls(eph, cuda, "mixed", n_traj=256):
        full = gauss._fg_correction(*a, **k)
        tri, s_inv, u, dt01, dt21, *cand = a[:11]
        sub = gauss._fg_correction(
            type(tri)(*(f[rows] for f in tri)), s_inv[rows], u[rows], dt01[rows], dt21[rows],
            *(c[rows] for c in cand), *a[11:], **k)
        for x, y in zip(sub, full):
            assert _same_bits(x, y[rows])


@pytest.mark.parametrize("precision", ["mixed", "f64"])
def test_fg_kernel_launches_per_iod_chunk(eph, cuda, precision):
    """Two launches a mixed IOD chunk (the float32 candidate pass, the
    float64 polish), one a float64 chunk; one read each."""
    from outfit_tpu_torch import trace
    from outfit_tpu_torch.iod import api, fg_correction_cuda

    fg_correction_cuda.reset_launch_counts()
    chunks, cands = [], api.gauss_candidates

    def count(*a, **k):
        chunks.append(1)
        return cands(*a, **k)

    reads = trace.sites.iod_fg.reads
    api.gauss_candidates = count
    try:
        _fg_calls(eph, cuda, precision, n_traj=64)
    finally:
        api.gauss_candidates = cands
    n = len(chunks)
    assert n >= 1
    want = {"float32": n, "float64": n} if precision == "mixed" else {"float32": 0, "float64": n}
    assert fg_correction_cuda.launches == want
    assert trace.sites.iod_fg.reads - reads == sum(want.values())


@pytest.mark.parametrize("bad", ["cpu_tensor", "float16", "float32_epoch", "int_mask", "noncontiguous", "not_multiple"])
def test_fg_kernel_wrapper_refuses_what_the_kernel_does_not_take(eph, cuda, bad):
    from outfit_tpu_torch.iod import fg_correction_cuda, gauss

    (a, k), = _fg_calls(eph, cuda, "f64", n_traj=8)
    args, kw = gauss._fg_kernel_inputs(*a, **k)
    args = list(args)
    if bad == "cpu_tensor":
        args[4] = args[4].cpu()
    elif bad == "float16":
        args[6], args[7], args[9], args[10] = (x.half() for x in (args[6], args[7], args[9], args[10]))
        args[0], args[1], args[2] = (x.half() for x in args[:3])
    elif bad == "float32_epoch":
        args[8] = args[8].float()
    elif bad == "int_mask":
        args[11] = args[11].to(torch.int8)
    elif bad == "noncontiguous":
        args[7] = torch.empty((args[7].shape[0], 6), dtype=args[7].dtype, device=cuda)[:, ::2]
    else:
        args[6:12] = [x[:-1] for x in args[6:12]]
    before = dict(fg_correction_cuda.launches)
    with pytest.raises((TypeError, ValueError)):
        fg_correction_cuda.correct(*args, **kw)
    assert fg_correction_cuda.launches == before
