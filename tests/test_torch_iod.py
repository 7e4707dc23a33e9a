"""Gauss IOD of the PyTorch port against the JAX package, on the same numpy
inputs in f64 on the CPU.

Bars, each stated at its assert:
* roots at rtol 1e-9 (tests/test_iod.py's oracle bar), Descartes counts exact;
* the reference oracles of tests/test_iod.py::TestReferenceOracles at their
  own tolerances;
* ``gauss_candidates``: flags exact, states at rtol 1e-9;
* the device triplet enumerator: identical indices;
* ``rms_orbit_error``: rtol 1e-12;
* ``fit_full_iod`` on the MPC fixtures with the JAX draws injected: the same
  ok/error/kind/corrected and epoch, elements at rtol 1e-9, RMS at rtol
  2e-9 (measured 1.3e-9 on 33803: XLA contracts a*b+c into fused
  multiply-adds on the CPU and PyTorch rounds each product, and the Gauss
  chain amplifies those last-ulp differences; the elements agree to 7e-12);
* the unseeded ``fit_lsq`` against the JAX ``fit_lsq(..., mesh=None)`` at
  the bars of tests/test_torch_lsq.py::test_fit_lsq_seeded_matches_jax.
Port-only properties (batch isolation, order, chunking, seeds) are bitwise.
"""

import inspect
import json
import os
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from outfit_tpu.constants import ROT_ECLMJ2000_TO_EQUMJ2000
from outfit_tpu.elements.twobody import propagate_twobody as j_propagate_twobody
from outfit_tpu.elements.types import EquinoctialElements as JEq
from outfit_tpu.elements.types import KeplerianElements as JKep
from outfit_tpu.elements.types import keplerian_to_equinoctial as j_kep2eq
from outfit_tpu.ephem import JPLEphem as JJPLEphem
from outfit_tpu.iod import IODParams as JIODParams
from outfit_tpu.iod.api import _draw_noise
from outfit_tpu.iod.api import fit_full_iod as j_fit_full_iod
from outfit_tpu.iod.api import fit_iod as j_fit_iod
from outfit_tpu.iod.gauss import GaussTriplets as JTri
from outfit_tpu.iod.gauss import gauss_candidates as j_gauss_candidates
from outfit_tpu.iod.roots import aberth_deg8 as j_aberth
from outfit_tpu.iod.roots import descartes_upper_bound as j_descartes
from outfit_tpu.iod.scoring import apparent_radec as j_apparent_radec
from outfit_tpu.iod.scoring import rms_orbit_error as j_rms
from outfit_tpu.iod.triplets import _enum_device_jit
from outfit_tpu.lsq import DifferentialCorrectionConfig as JConfig
from outfit_tpu.lsq import fit_lsq as j_fit_lsq
from outfit_tpu.observations import ErrorModel as JErrorModel
from outfit_tpu.observations import ObsDataset as JObsDataset
from outfit_tpu.observations.observatories import Observer as JObserver
from outfit_tpu_torch import (
    DifferentialCorrectionConfig,
    ErrorModel,
    IODParams,
    JPLEphem,
    ObsDataset,
    fit_full_iod,
    fit_iod,
    fit_lsq,
)
from outfit_tpu_torch.elements.types import EquinoctialElements
from outfit_tpu_torch.iod.api import _fit_full_iod
from outfit_tpu_torch.iod.gauss import (
    GaussTriplets,
    _positions_from_cvec,
    coeff_eight_poly,
    gauss_candidates,
    gauss_prelim,
    gibbs_velocity,
)
from outfit_tpu_torch.iod.noise import draw_noise, trajectory_keys
from outfit_tpu_torch.iod.roots import aberth_deg8, descartes_upper_bound
from outfit_tpu_torch.iod.scoring import rms_orbit_error
from outfit_tpu_torch.iod.triplets import _enum_device
from outfit_tpu_torch.lsq.api import _fit_lsq
from outfit_tpu_torch.observations.observatories import Observer

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
FIXTURES = ["2015AB", "8467", "33803", "K25D50B"]
SPAN = (53500.0, 61500.0)
#: a small IOD profile (a few lanes per trajectory) for the fixture runs
SMALL = dict(n_noise_realizations=3, max_triplets=4)

pytestmark = pytest.mark.filterwarnings("ignore:observatory .* SOLVED")


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def jax_draws(seed, params):
    """The JAX package's Monte-Carlo draws (``iod/api.py:_draw_noise``) as
    the port's ``(T, max_triplets, n_real, 3, 2)`` tensor, for injection."""

    def draws(traj_ids):
        hashes = np.array([zlib.crc32(t.encode("utf-8")) for t in traj_ids], np.uint32)
        z = _draw_noise(
            jax.random.PRNGKey(seed), jnp.asarray(hashes), params.max_triplets,
            params.n_noise_realizations + 1,
        )
        return np.array(z)

    return draws


@pytest.fixture(scope="module")
def jeph():
    return JJPLEphem.analytic(*SPAN)


@pytest.fixture(scope="module")
def teph():
    return JPLEphem.analytic(*SPAN)


# ---------------------------------------------------------------------------
# roots, oracles, candidates
# ---------------------------------------------------------------------------


def test_descartes_and_aberth_match_jax():
    rng = np.random.default_rng(3)
    n = 400
    c6 = -(10.0 ** rng.uniform(-1, 1.5, n)) * rng.choice([1, -1], n, p=[0.9, 0.1])
    c3 = rng.normal(size=n) * 10.0 ** rng.uniform(-2, 1, n)
    c0 = -(10.0 ** rng.uniform(-3, 0.5, n))
    c0[:5], c3[5:10] = 0.0, 0.0
    np.testing.assert_array_equal(
        descartes_upper_bound(_t(c0), _t(c3), _t(c6)).numpy(),
        np.asarray(j_descartes(jnp.asarray(c0), jnp.asarray(c3), jnp.asarray(c6))),
    )
    rt = aberth_deg8(_t(c0), _t(c3), _t(c6))
    rj = j_aberth(jnp.asarray(c0), jnp.asarray(c3), jnp.asarray(c6))
    zt = rt.real.numpy() + 1j * rt.imag.numpy()
    zj = np.asarray(rj.real) + 1j * np.asarray(rj.imag)
    # both sort by real part; a conjugate pair's order is a rounding tie, so
    # each root is matched to the nearest root of the other package.  Bar:
    # the oracle rtol 1e-9 of tests/test_iod.py, relative to |z|
    dist = np.abs(zt[:, :, None] - zj[:, None, :]).min(axis=-1)
    assert (dist <= 1e-9 * (1.0 + np.abs(zt))).all(), dist.max()
    np.testing.assert_allclose(np.sort(zt.real, -1), np.sort(zj.real, -1), rtol=1e-9, atol=1e-9)


class TestReferenceOracles:
    """tests/test_iod.py::TestReferenceOracles (gauss.rs:1428-1703) on the port."""

    RA = np.array([1.6893715963476696, 1.6898894500811472, 1.7527345385664372])
    DEC = np.array([1.082468037385525, 0.9435805047946216, 0.8273762407899986])
    TIME = np.array([57028.479297592596, 57049.24514759259, 57063.97711759259])
    OBS_POS = np.array([
        [-0.26456661713915464, 0.868935164369495, 0.3766996211091922],
        [-0.5891631852174127, 0.7238872516794777, 0.3138186516524585],
        [-0.7743874437969596, 0.5612884709261164, 0.24334971075289916],
    ])
    AST_POS = np.array([
        [-0.28811969067349597, 1.06663729794052, 0.7514815481797275],
        [-0.6235500510031637, 1.0112601855976917, 0.713100363506241],
        [-0.8445850475187664, 0.9428539454255418, 0.6653391541170498],
    ])

    def _tri(self, obs_pos=None):
        op = self.OBS_POS if obs_pos is None else obs_pos
        return GaussTriplets(*(_t(x)[None] for x in (self.RA, self.DEC, self.TIME, op)))

    def test_gauss_prelim_oracle(self):
        tau1, tau3, s_mat, s_inv, a, b, u, nonsing = gauss_prelim(self._tri(np.zeros((3, 3))))
        np.testing.assert_allclose(float(tau1[0]), -0.35721620648079105, rtol=1e-14)
        np.testing.assert_allclose(float(tau3[0]), 0.25342080566844405, rtol=1e-14)
        ref_s = np.array([
            [-0.05549934652247514, 0.46585594034226024, 0.8831183756345503],
            [-0.06972979004485365, 0.5827357012279389, 0.8096646582966821],
            [-0.12245931009139571, 0.6656387438390606, 0.7361581216507068],
        ]).T
        np.testing.assert_allclose(s_mat[0].numpy(), ref_s, rtol=1e-12)
        ref_sinv = np.array([
            [-18.774792915974594, 41.814279122702025, -23.466669573973437],
            [-8.16479071034311, 11.489343729350427, -2.8418335594428186],
            [4.259482782736117, -3.432964304649723, 0.024345794753282718],
        ]).T
        np.testing.assert_allclose(s_inv[0].numpy(), ref_sinv, rtol=1e-10)
        np.testing.assert_allclose(a[0].numpy(), [0.41501055557783634, -1.0, 0.5849894444221637], rtol=1e-13)
        np.testing.assert_allclose(
            b[0].numpy(), [0.021349212036493866, 0.0, 0.023913797385599792], rtol=1e-12, atol=1e-16
        )
        assert bool(nonsing[0])

    def test_coeff_8poly_oracle(self):
        tri = self._tri()
        _, _, s_mat, s_inv, a, b, _, _ = gauss_prelim(tri)
        c0, c3, c6 = coeff_eight_poly(tri, s_mat, s_inv, a, b)
        np.testing.assert_allclose(float(c6[0]), -2.615803718759013, rtol=1e-12)
        np.testing.assert_allclose(float(c3[0]), 2.0305173353541064, rtol=1e-12)
        np.testing.assert_allclose(float(c0[0]), -0.4771346939201045, rtol=1e-12)

    def test_solving_polynom_oracle(self):
        roots = aberth_deg8(_t([-0.4771346939201048]), _t([2.0305173353541064]), _t([-2.615803718759011]))
        re, im = roots.real[0].numpy(), roots.imag[0].numpy()
        real_pos = np.sort(re[(np.abs(im) < 1e-6) & (re > 0)])
        np.testing.assert_allclose(
            real_pos, [0.7328107254669438, 0.9540135094917113, 1.3856312487504954], rtol=1e-9
        )

    def test_asteroid_position_oracle(self):
        tri = self._tri()
        _, _, _, s_inv, a, b, u, _ = gauss_prelim(tri)
        p = IODParams()

        def cvec(root):
            r2m3 = 1.0 / root**3
            return _t([float(a[0, 0]) + float(b[0, 0]) * r2m3, -1.0, float(a[0, 2]) + float(b[0, 2]) * r2m3])[None]

        _, _, ok_bad = _positions_from_cvec(tri, s_inv, u, cvec(0.7328107254669437), p.min_rho2_au)
        assert not bool(ok_bad[0])  # spurious root: rejected by the min-rho2 gate
        pos, epoch, ok = _positions_from_cvec(tri, s_inv, u, cvec(1.3856312487504951), p.min_rho2_au)
        assert bool(ok[0])
        np.testing.assert_allclose(pos[0].numpy(), self.AST_POS, rtol=1e-10)
        np.testing.assert_allclose(float(epoch[0]), 57049.24229942721, rtol=1e-13)

    def test_gibbs_correction_oracle(self):
        tau1, tau3, *_ = gauss_prelim(self._tri(np.zeros((3, 3))))
        vel = gibbs_velocity(_t(self.AST_POS)[None], tau1, tau3)
        np.testing.assert_allclose(
            vel[0].numpy(), [-0.015549845137774663, -0.003876936109837664, -0.0027014074002979886], rtol=1e-12
        )


@pytest.fixture(scope="module")
def triplets(jeph):
    """tests/test_iod.py::TestBatchIsolation._triplets as numpy arrays:
    triplets of varying difficulty (tight to wide spans, clean to noisy)."""
    rng = np.random.default_rng(7)
    rot = jnp.asarray(ROT_ECLMJ2000_TO_EQUMJ2000)
    ras, decs, times, opos = [], [], [], []
    for i in range(8):
        kep = JKep(*map(jnp.float64, (
            57000.0, float(rng.uniform(1.1, 3.5)), float(rng.uniform(0.0, 0.6)),
            float(rng.uniform(0.0, 0.5)), float(rng.uniform(0, 2 * np.pi)),
            float(rng.uniform(0, 2 * np.pi)), float(rng.uniform(0, 2 * np.pi)),
        )))
        eq = j_kep2eq(kep)
        span = float(rng.uniform(2.0, 40.0))
        t = 57000.0 + np.array([0.0, span / 2, span])
        st = j_propagate_twobody(
            JEq(*[jnp.broadcast_to(f, (3,)) for f in eq]), 57000.0, jnp.asarray(t), compute_derivatives=False
        )
        earth, _ = jeph.earth_ephemeris(jnp.asarray(t))
        ra, dec = j_apparent_radec(
            jnp.einsum("ij,...j->...i", rot, st.position), jnp.einsum("ij,...j->...i", rot, st.velocity), earth
        )
        noise = [0.0, 0.0, 5e-5, 5e-4, 2e-3, 1e-2][i % 6]
        ras.append(np.asarray(ra) + rng.normal(0, noise, 3))
        decs.append(np.asarray(dec) + rng.normal(0, noise, 3))
        times.append(t)
        opos.append(np.asarray(earth))
    return [np.stack(x) for x in (ras, decs, times, opos)]


def test_gauss_candidates_match_jax(triplets):
    rt = gauss_candidates(GaussTriplets(*map(_t, triplets)), IODParams())
    rj = j_gauss_candidates(JTri(*map(jnp.asarray, triplets)), JIODParams())
    for name in ("valid", "corrected"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(), np.asarray(getattr(rj, name)), err_msg=name)
    assert rt.valid.any() and rt.corrected.any()
    ok = rt.valid.numpy()
    for name in ("pos", "vel", "epoch", "r2", "chi1", "chi2"):
        a, b = getattr(rt, name).numpy()[ok], np.asarray(getattr(rj, name))[ok]
        # bar: rtol 1e-9 on the accepted candidates' states
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12, err_msg=name)


def test_gauss_candidates_lane_isolation_is_bitwise(triplets):
    full = gauss_candidates(GaussTriplets(*map(_t, triplets)), IODParams())
    for i in range(triplets[0].shape[0]):
        alone = gauss_candidates(GaussTriplets(*(_t(x[i:i + 1]) for x in triplets)), IODParams())
        for name in full._fields:
            torch.testing.assert_close(
                getattr(alone, name)[0], getattr(full, name)[i], rtol=0, atol=0, equal_nan=True,
                msg=f"lane {i}, {name}",
            )


# ---------------------------------------------------------------------------
# triplet enumeration and scoring
# ---------------------------------------------------------------------------


def _epoch_grid(rng, T, lo, hi, dup):
    counts = rng.integers(lo, hi, T)
    counts[0] = 0
    epochs = np.zeros((T, int(counts.max())))
    for t in range(T):
        e = np.sort(rng.uniform(0, rng.uniform(1, 150), counts[t]))
        if dup and counts[t] > 3:
            e[1::3] = e[0::3][: len(e[1::3])]  # duplicate epochs: zero gaps
            e = np.sort(e)
        epochs[t, : counts[t]] = e
    return epochs, counts


@pytest.mark.parametrize("case", ["narrow", "downsampled", "ties"])
def test_enum_device_identical_to_jax(case):
    rng = np.random.default_rng({"narrow": 1, "downsampled": 2, "ties": 3}[case])
    if case == "ties":
        # uniform cadence: many triplets share the same quantised weight
        counts = np.array([9, 12, 12, 20, 2])
        epochs = np.zeros((5, 20))
        for t, c in enumerate(counts):
            epochs[t, :c] = 57000.0 + 0.5 * np.arange(c) * (1 + t % 2)
        max_obs, kmax = 100, 11
    else:
        lo, hi, max_obs = (3, 24, 100) if case == "narrow" else (20, 60, 17)
        epochs, counts = _epoch_grid(rng, 14, lo, hi, dup=True)
        kmax = 9
    kw = dict(dt_min=0.03, dt_max=150.0, dtw=20.0, max_obs=max_obs, max_triplets=kmax)
    tj, kj = _enum_device_jit(jnp.asarray(epochs), jnp.asarray(counts.astype(np.int32)), **kw)
    tt, kt = _enum_device(_t(epochs), torch.as_tensor(counts), **kw, budget=97)  # several chunks
    if case == "downsampled":
        assert (counts > max_obs).any()
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))


def test_host_triplet_helpers_match_jax_and_device_enumerator():
    """The copied numpy helpers: the batch enumerator equals the JAX one and
    the port's device enumerator on the realized triplets; the RMS windows
    equal the JAX ones."""
    from outfit_tpu.iod.triplets import generate_triplet_indices_batch as j_batch
    from outfit_tpu.iod.triplets import select_rms_interval_batch as j_window
    from outfit_tpu_torch.iod.triplets import generate_triplet_indices_batch, select_rms_interval_batch

    rng = np.random.default_rng(6)
    epochs, counts = _epoch_grid(rng, 12, 3, 40, dup=True)
    args = (epochs, counts, 0.03, 150.0, 20.0, 25, 7)
    want_t, want_k = j_batch(*args)
    got_t, got_k = generate_triplet_indices_batch(*args, budget=300)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_t, want_t)
    dev_t, dev_k = _enum_device(_t(epochs), torch.as_tensor(counts), dt_min=0.03, dt_max=150.0, dtw=20.0,
                                max_obs=25, max_triplets=7)
    np.testing.assert_array_equal(dev_k.numpy(), got_k)
    for t in range(12):
        np.testing.assert_array_equal(dev_t.numpy()[t, : got_k[t]], got_t[t, : got_k[t]])
    ep = np.sort(rng.uniform(0, 100, 30))
    i1, i3 = rng.integers(0, 10, 20), rng.integers(12, 30, 20)
    for extf, dtmax in ((-1.0, 30.0), (0.5, 10.0), (2.0, -1.0)):
        for a, b in zip(select_rms_interval_batch(ep, i1, i3, extf, dtmax), j_window(ep, i1, i3, extf, dtmax)):
            np.testing.assert_array_equal(a, b)


def test_rms_orbit_error_matches_jax():
    rng = np.random.default_rng(4)
    T, K, N = 5, 3, 17
    kep = [np.full((T, K), 57010.0), rng.uniform(1.2, 3.0, (T, K)), rng.uniform(0, 0.4, (T, K)),
           rng.uniform(0, 0.5, (T, K)), rng.uniform(0, 6, (T, K)), rng.uniform(0, 6, (T, K)), rng.uniform(0, 6, (T, K))]
    eq = [np.array(f) for f in j_kep2eq(JKep(*map(jnp.asarray, kep)))]
    eq[2][0, 0], eq[3][0, 0] = 0.99, 0.5  # e > 1: scores inf
    mjd = 57000.0 + np.sort(rng.uniform(0, 30, (T, 1, N)), axis=-1)
    ra, dec = rng.uniform(0, 6, (T, 1, N)), rng.uniform(-1, 1, (T, 1, N))
    sig = np.full((T, 1, N), 2e-6)
    helio = rng.normal(size=(T, 1, N, 3))
    mask = rng.uniform(size=(T, 1, N)) < 0.8
    mask[1] = False
    rt = rms_orbit_error(EquinoctialElements(*map(_t, eq)), *map(_t, (mjd, ra, dec, sig, sig, helio)), torch.as_tensor(mask))
    rj = j_rms(JEq(*map(jnp.asarray, eq)), *map(jnp.asarray, (mjd, ra, dec, sig, sig, helio, mask)))
    np.testing.assert_array_equal(np.isfinite(rt.numpy()), np.isfinite(np.asarray(rj)))
    assert not np.isfinite(rt.numpy()).all()
    # bar: rtol 1e-12
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-12)


# ---------------------------------------------------------------------------
# the IOD and the unseeded fit on the MPC fixtures
# ---------------------------------------------------------------------------


def _paths():
    return [os.path.join(DATA, f"{n}.obs") for n in FIXTURES]


@pytest.fixture(scope="module")
def jax_fits(jeph):
    """JAX ``fit_full_iod`` and unseeded ``fit_lsq`` of the four fixtures
    (one dataset, the small IOD profile, seed 42, FCCT14)."""
    p = JIODParams(**SMALL)
    iod = j_fit_full_iod(JObsDataset.from_mpc_80_col_files(_paths()), jeph, p, seed=42,
                         error_model=JErrorModel.fcct14(), mesh=None)
    lsq = j_fit_lsq(JObsDataset.from_mpc_80_col_files(_paths()), jeph, p, JConfig(), 42,
                    error_model=JErrorModel.fcct14(), mesh=None)
    return iod, lsq


def _assert_iod_equal(a, b, tid):
    """Port result ``a`` against JAX result ``b``."""
    for f in ("ok", "error", "kind", "corrected", "epoch"):
        assert getattr(a, f) == getattr(b, f), (tid, f)
    if a.ok:
        np.testing.assert_allclose(a.equinoctial, np.asarray(b.equinoctial), rtol=1e-9, err_msg=tid)
        np.testing.assert_allclose(a.elements, np.asarray(b.elements), rtol=1e-9, err_msg=tid)
        np.testing.assert_allclose(a.rms, b.rms, rtol=2e-9, err_msg=tid)


def test_fit_full_iod_matches_jax(teph, jax_fits):
    p = IODParams(**SMALL)
    res = _fit_full_iod(ObsDataset.from_mpc_80_col_files(_paths()), teph, p, 42, None, ErrorModel.fcct14(),
                        None, "cpu", jax_draws(42, p))
    ref = jax_fits[0]
    assert list(res) == ["K09R05F", "8467", "33803", "K25D50B"] and set(res) == set(ref)
    for tid, r in res.items():
        assert r.ok, (tid, r.error)
        _assert_iod_equal(r, ref[tid], tid)


def test_fit_full_iod_selection_subsample_matches_jax(jeph, teph):
    """The opt-in subsampled selection window (IODParams.selection_subsample)
    with the full-window rescore of the winner, on the two longer arcs."""
    names = ["8467", "33803"]
    paths = [os.path.join(DATA, f"{n}.obs") for n in names]
    kw = dict(SMALL, selection_subsample=8)
    ref = j_fit_full_iod(JObsDataset.from_mpc_80_col_files(paths), jeph, JIODParams(**kw), seed=42,
                         error_model=JErrorModel.fcct14(), mesh=None)
    p = IODParams(**kw)
    res = _fit_full_iod(ObsDataset.from_mpc_80_col_files(paths), teph, p, 42, None, ErrorModel.fcct14(),
                        None, "cpu", jax_draws(42, p))
    assert set(res) == set(ref) == set(names)
    for tid, r in res.items():
        assert r.ok, (tid, r.error)
        _assert_iod_equal(r, ref[tid], tid)


#: covariance rtol per fixture, tests/test_torch_lsq.py's
_COV_RTOL = {"K09R05F": 1e-5, "8467": 1e-5, "33803": 1e-5, "K25D50B": 1e-3}


def test_unseeded_fit_lsq_matches_jax(teph, jax_fits):
    p = IODParams(**SMALL)
    res = _fit_lsq(ObsDataset.from_mpc_80_col_files(_paths()), teph, p, DifferentialCorrectionConfig(), 42,
                   None, ErrorModel.fcct14(), None, None, "cpu", jax_draws(42, p))
    ref = jax_fits[1]
    assert list(res) == ["K09R05F", "8467", "33803", "K25D50B"] and set(res) == set(ref)
    for tid, b in res.items():
        a = ref[tid]
        for f in ("ok", "fell_back_to_iod", "status", "n_active_obs", "total_newton_iterations", "error"):
            assert getattr(b, f) == getattr(a, f), (tid, f)
        _assert_iod_equal(b.iod, a.iod, tid)
        np.testing.assert_allclose(b.equinoctial, np.asarray(a.equinoctial), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(b.normalised_rms, a.normalised_rms, rtol=1e-6)
        if not b.fell_back_to_iod:
            np.testing.assert_allclose(b.covariance, a.covariance, rtol=_COV_RTOL[tid], atol=0)
            np.testing.assert_allclose(b.uncertainties, a.uncertainties, rtol=_COV_RTOL[tid])
    assert sum(not r.fell_back_to_iod for r in res.values()) >= 3


@pytest.mark.parametrize("name", FIXTURES)
def test_stored_iod_seeds_reproduced(teph, name):
    """tests/data/iod_seeds_analytic.json (the JAX fit_full_iod, default
    IODParams, seed 42, FCCT14) from the port with the JAX draws injected:
    ok, kind and epoch exact, elements at rtol 1e-9, RMS at rtol 2e-9."""
    with open(os.path.join(DATA, "iod_seeds_analytic.json"), encoding="utf-8") as fh:
        stored = json.load(fh)[name]
    p = IODParams()
    res = _fit_full_iod(ObsDataset.from_mpc_80_col(os.path.join(DATA, f"{name}.obs")), teph, p, 42, None,
                        ErrorModel.fcct14(), None, "cpu", jax_draws(42, p))
    assert set(res) == set(stored)
    for tid, row in stored.items():
        r = res[tid]
        assert (r.ok, r.kind, r.epoch) == (row["ok"], row["kind"], row["epoch"]), tid
        np.testing.assert_allclose(r.equinoctial, row["equinoctial"], rtol=1e-9, err_msg=tid)
        np.testing.assert_allclose(r.elements, row["elements"], rtol=1e-9, err_msg=tid)
        np.testing.assert_allclose(r.rms, row["rms"], rtol=2e-9, err_msg=tid)


# ---------------------------------------------------------------------------
# port-only properties
# ---------------------------------------------------------------------------


def _fixture_ds(order=FIXTURES):
    return ObsDataset.from_mpc_80_col_files([os.path.join(DATA, f"{n}.obs") for n in order])


QUICK = dict(n_noise_realizations=2, max_triplets=3)


@pytest.fixture(scope="module")
def quick_fit(teph):
    return fit_full_iod(_fixture_ds(), teph, IODParams(**QUICK), seed=5, error_model=ErrorModel.fcct14(), device="cpu")


def _assert_same(a, b):
    assert set(a) == set(b)
    for tid in a:
        x, y = a[tid], b[tid]
        assert (x.ok, x.error, x.kind, x.corrected, x.rms, x.epoch) == (y.ok, y.error, y.kind, y.corrected, y.rms, y.epoch)
        np.testing.assert_array_equal(x.equinoctial, y.equinoctial)


def _interleaved(ds):
    """The same observations with their storage rows shuffled (trajectories
    interleaved, epochs out of order): the layout's lexsort branch."""
    perm = np.random.default_rng(8).permutation(len(ds))
    for f in ("mjd_tt", "ra", "dec", "ra_error", "dec_error", "traj_index", "observer_index", "mag", "catalog"):
        setattr(ds, f, getattr(ds, f)[perm])
    return ds


@pytest.mark.parametrize("variant", ["permuted", "interleaved", "batch_size", "same_seed"])
def test_iod_independent_of_order_chunking_and_rerun(teph, quick_fit, variant):
    order = FIXTURES[::-1] if variant == "permuted" else FIXTURES
    p = IODParams(**QUICK, batch_size=5) if variant == "batch_size" else IODParams(**QUICK)
    ds = _interleaved(_fixture_ds()) if variant == "interleaved" else _fixture_ds(order)
    res = fit_full_iod(ds, teph, p, seed=5, error_model=ErrorModel.fcct14(), device="cpu")
    if variant == "permuted":
        assert list(res)[0] == "K25D50B"  # dataset order
    _assert_same(res, quick_fit)


def test_noise_draws_contract():
    tids = ["8467", "K09R05F", "33803", "A", "B"]
    z = draw_noise(torch.as_tensor(trajectory_keys(5, tids)), 4, 3)
    assert z.shape == (5, 4, 3, 3, 2) and z.dtype == torch.float64
    assert not z[:, :, 0].any()  # realization 0 is the exact triplet
    # per trajectory: independent of the batch, its order, and the shape
    sub = draw_noise(torch.as_tensor(trajectory_keys(5, tids[2:0:-1])), 2, 2)
    torch.testing.assert_close(sub[0], z[2, :2, :2], rtol=0, atol=0)
    torch.testing.assert_close(sub[1], z[1, :2, :2], rtol=0, atol=0)
    # a different seed draws differently
    other = draw_noise(torch.as_tensor(trajectory_keys(6, tids)), 4, 3)
    assert (other[:, :, 1:] != z[:, :, 1:]).all()
    # standard normals
    big = draw_noise(torch.as_tensor(trajectory_keys(0, [f"T{i}" for i in range(2000)])), 10, 6)[:, :, 1:]
    assert abs(float(big.mean())) < 0.01 and abs(float(big.std()) - 1.0) < 0.01


def test_different_seeds_change_the_fit(teph, quick_fit):
    res = fit_full_iod(_fixture_ds(), teph, IODParams(**QUICK), seed=6, error_model=ErrorModel.fcct14(), device="cpu")
    assert any(res[t].rms != quick_fit[t].rms for t in res)


def test_error_rows_match_jax(jeph, teph):
    """No feasible triplet (two observations) and an unknown observatory."""

    def build(ds_cls, obs_cls, eph):
        ds = ds_cls()
        geo = obs_cls.geocenter()
        unknown = obs_cls(0.0, 0.0, 0.0, "UNKNOWN(ZZZ)", "ZZZ", unknown=True)
        for i, t in enumerate((57000.0, 57000.001)):
            ds.push_observation("SHORT", t, 1.0 + 1e-4 * i, 0.3, 2e-6, 2e-6, geo)
        for i in range(6):
            ds.push_observation("FAR", 57000.0 + 3 * i, 1.0 + 0.01 * i, 0.3, 2e-6, 2e-6, unknown if i == 2 else geo)
        return ds

    rj = j_fit_full_iod(build(JObsDataset, JObserver, jeph), jeph, JIODParams(n_noise_realizations=1), seed=1, mesh=None)
    rt = fit_full_iod(build(ObsDataset, Observer, teph), teph, IODParams(n_noise_realizations=1), seed=1, device="cpu")
    assert list(rt) == ["SHORT", "FAR"]
    for tid in rt:
        assert not rt[tid].ok and rt[tid].error == rj[tid].error, (rt[tid].error, rj[tid].error)
    assert rt["SHORT"].error.startswith("NoFeasibleTriplets(") and rt["FAR"].error == "UnknownObservatory(ZZZ)"


def test_fit_iod_dataset_form_matches_batch(teph, quick_fit):
    r = fit_iod(_fixture_ds(), teph, IODParams(**QUICK), seed=5, traj_id="8467",
                error_model=ErrorModel.fcct14(), device="cpu")
    _assert_same({"8467": r}, {"8467": quick_fit["8467"]})


def test_entry_points_take_the_jax_parameters_in_order():
    """Every entry point takes the JAX package's parameters in its
    positional order; the one stated difference is ``device``, last (before
    a ``**`` catch-all), in place of ``mesh``, which stays refused: no entry
    point takes a ``mesh`` parameter or a ``**`` catch-all that would
    swallow it (``fit_lsq_stream_escalating``'s passes its keywords to
    ``fit_lsq_stream``, which takes none of that name).  The ``ObsDataset``
    constructors take them with the same defaults, and no ``device``."""
    import outfit_tpu.iod.api as jiod
    import outfit_tpu.lsq.api as jlsq
    import outfit_tpu_torch.iod.api as tiod
    import outfit_tpu_torch.lsq.api as tlsq

    for name in ("from_mpc_80_col_files", "from_mpc_80_col", "from_records", "from_ades", "from_parquet",
                 "from_dataframe", "concat"):
        port, ref = (inspect.signature(getattr(c, name)).parameters.values() for c in (ObsDataset, JObsDataset))
        assert [(p.name, p.kind, p.default) for p in port] == [(p.name, p.kind, p.default) for p in ref], name

    pairs = [(getattr(tiod, n), getattr(jiod, n)) for n in ("fit_full_iod", "fit_iod", "fit_full_iod_stream")]
    pairs += [
        (getattr(tlsq, n), getattr(jlsq, n))
        for n in ("fit_lsq", "fit_lsq_stream", "fit_lsq_escalating", "fit_lsq_stream_escalating", "fit_lsq_dispatch",
                  "fit_lsq_finalize")
    ]
    for port, ref in pairs:
        params = inspect.signature(ref).parameters
        want = [n for n in params if n != "mesh"]
        var_kw = [n for n, p in params.items() if p.kind is inspect.Parameter.VAR_KEYWORD]
        if ref is not jlsq.fit_lsq_finalize:  # finalize takes the pending fit alone, in both
            want.insert(want.index(var_kw[0]) if var_kw else len(want), "device")
        assert list(inspect.signature(port).parameters) == want, port.__name__
        assert "mesh" not in inspect.signature(port).parameters
    ds = ObsDataset.from_mpc_80_col(os.path.join(DATA, "8467.obs"))
    for fn in (tiod.fit_full_iod, tlsq.fit_lsq, tlsq.fit_lsq_dispatch):
        with pytest.raises(TypeError, match="mesh"):
            fn(ds, None, mesh=None)
    with pytest.raises(TypeError, match="mesh"):
        next(tlsq.fit_lsq_stream_escalating([ds], None, [(IODParams(), DifferentialCorrectionConfig())],
                                            mesh="auto"))


def test_fit_lsq_seed_is_positional_after_config(teph):
    """``fit_lsq(ds, eph, params, cfg, 7)`` passes seed 7 (not ``ut1``)."""
    p = IODParams(**QUICK)
    ds = ObsDataset.from_mpc_80_col(os.path.join(DATA, "8467.obs"))
    a = fit_lsq(ds, teph, p, DifferentialCorrectionConfig(), 7, error_model=ErrorModel.fcct14(), device="cpu")
    ds = ObsDataset.from_mpc_80_col(os.path.join(DATA, "8467.obs"))
    b = fit_lsq(ds, teph, p, DifferentialCorrectionConfig(), seed=7, error_model=ErrorModel.fcct14(), device="cpu")
    assert a["8467"].ok and a["8467"].iod.rms == b["8467"].iod.rms
    np.testing.assert_array_equal(a["8467"].equinoctial, b["8467"].equinoctial)
