"""The rest of the PyTorch port's host surface against the JAX package's, on
the same inputs, on the CPU.

Bars: strings equal character for character; floats bitwise (the port's
copies run the same numpy or ``math`` expressions, and ``angle_diff`` the
same elementwise operations), the JAX suite's own tolerances where they are
looser (tests/test_conversion_ades.py); the device triplet enumerator's
indices identical.  Each port example runs at a small size on the CPU and
imports no JAX.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import outfit_tpu.conversion as jconv
import outfit_tpu.time.scales as jscales
from outfit_tpu.elements.types import CometaryElements as JCom
from outfit_tpu.elements.types import EquinoctialElements as JEq
from outfit_tpu.elements.types import KeplerianElements as JKep
from outfit_tpu.iod.roots import aberth_deg8 as j_aberth
from outfit_tpu.iod.triplets import generate_triplet_indices_device as j_generate_device
from outfit_tpu.iod.triplets import triplet_weight as j_triplet_weight
from outfit_tpu.kepler.angles import angle_diff as j_angle_diff
from outfit_tpu.observations.observatories import Observer as JObserver
import outfit_tpu_torch.conversion as conv
import outfit_tpu_torch.time.scales as scales
from outfit_tpu_torch.elements.types import CometaryElements, EquinoctialElements, KeplerianElements
from outfit_tpu_torch.iod.roots import aberth_deg8
from outfit_tpu_torch.iod.triplets import generate_triplet_indices_device, triplet_weight
from outfit_tpu_torch.kepler import angle_diff
from outfit_tpu_torch.observations.observatories import Observer

from test_torch_iod import _epoch_grid

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------


def test_conversion_matches_jax():
    rng = np.random.default_rng(1)
    for x in np.concatenate([rng.uniform(-1e6, 1e6, 200), [0.0, 3600.0, -1e-300]]):
        assert conv.arcsec_to_rad(x) == jconv.arcsec_to_rad(x)
        assert conv.rad_to_arcsec(x) == jconv.rad_to_arcsec(x)
    texts = ["12 30 45.67", "00 00 00", "23 59 59.999", "12 30", "ab cd ef", "1 2 3 4", "-23 26 45.1",
             "+10 15 30", "-00 00 01.25", "+89 59 59.9999", "+10 xx 30"]
    for t in texts:
        assert conv.parse_ra_to_deg(t) == jconv.parse_ra_to_deg(t), t
        assert conv.parse_dec_to_deg(t) == jconv.parse_dec_to_deg(t), t
    angles = np.concatenate([
        rng.uniform(-2 * math.pi, 2 * math.pi, 300),
        [0.0, math.radians(10 + 59 / 60 + 59.9999 / 3600), -math.radians(10 + 59 / 60 + 59.9999 / 3600),
         (23 + 59 / 60 + 59.99999 / 3600) * math.pi / 12, 2 * math.pi - 1e-12],
    ])
    for a in angles:
        for prec in (0, 1, 2, 3):
            assert conv.ra_hms_prec(a, prec) == jconv.ra_hms_prec(a, prec), (a, prec)
            assert conv.dec_sdms_prec(a, prec) == jconv.dec_sdms_prec(a, prec), (a, prec)
    for s in (0.0, 9.99951, 59.9996, 59.99949, 12.345, 5.5e-4):
        for prec in (0, 1, 3, 6):
            assert conv.fmt_ss(s, prec) == jconv.fmt_ss(s, prec), (s, prec)
    for v in rng.normal(size=(50, 3)) * 10.0 ** rng.uniform(-3, 3, (50, 1)):
        for prec in (3, 9):
            assert conv.fmt_vec3_au(v, prec) == jconv.fmt_vec3_au(v, prec)
        assert conv.cartesian_to_radec(v) == jconv.cartesian_to_radec(v)
    for v in ([0.0, 0.0, 0.0], [0.0, 0.0, 2.0], [0.0, 1.0, 0.0], [-1.0, -1e-300, 0.5]):
        assert conv.cartesian_to_radec(v) == jconv.cartesian_to_radec(v), v


# ---------------------------------------------------------------------------
# time scales
# ---------------------------------------------------------------------------


def test_time_functions_match_jax():
    rng = np.random.default_rng(2)
    mjd = np.concatenate([rng.uniform(40000.0, 70000.0, 500), [41317.0, 57754.0 - 1e-9, 57754.0, 51544.5]])
    for name in ("mjd_to_jd", "jd_to_mjd"):
        np.testing.assert_array_equal(getattr(scales, name)(mjd), getattr(jscales, name)(mjd))
        assert getattr(scales, name)(51544.5) == getattr(jscales, name)(51544.5)
    jd = mjd + 2400000.5
    np.testing.assert_array_equal(scales.utc_jd_to_tt_mjd(jd), jscales.utc_jd_to_tt_mjd(jd))
    dates = ["2015-01-06T11:29:43", "1999-12-31T23:59:59", "2020-02-29T00:00:00", "1972-07-01T00:00:00.500000",
             "2017-01-01"]
    np.testing.assert_array_equal(scales.date_to_mjd(dates), jscales.date_to_mjd(dates))
    # seconds that round up to the next minute, hour and day
    edges = [57000.0 + (86400.0 - 0.0004) / 86400.0, 57000.0 + (3600.0 - 0.0004) / 86400.0, 57754.0 + 37.0 / 86400.0]
    for m in np.concatenate([mjd[:100], edges]):
        for prec in (0, 3, 6):
            assert scales.iso_tt_from_mjd(m, prec) == jscales.iso_tt_from_mjd(m, prec), (m, prec)
            assert scales.iso_utc_from_mjd_tt(m, prec) == jscales.iso_utc_from_mjd_tt(m, prec), (m, prec)
    assert scales.iso_tt_from_mjd(np.float64(57000.5)) == jscales.iso_tt_from_mjd(np.float64(57000.5))
    assert scales._fmt_ss(59.9996, 3) == jscales._fmt_ss(59.9996, 3) == "60.000"


# ---------------------------------------------------------------------------
# element sets, observers, angles, triplets, roots
# ---------------------------------------------------------------------------


PAIRS = [(KeplerianElements, JKep), (EquinoctialElements, JEq), (CometaryElements, JCom)]


@pytest.mark.parametrize("cls,jcls", PAIRS, ids=lambda c: getattr(c, "__name__", ""))
def test_element_vector_and_str_match_jax(cls, jcls):
    rng = np.random.default_rng(3)
    cols = [rng.uniform(50000.0, 60000.0, 7)] + [rng.normal(size=7) for _ in range(6)]
    port, ref = cls(*(torch.as_tensor(c) for c in cols)), jcls(*(jnp.asarray(c) for c in cols))
    np.testing.assert_array_equal(port.vector.numpy(), np.asarray(ref.vector))
    assert str(port) == str(ref)  # "<batch (7,)>" fields
    for i in range(3):
        row = [c[i] for c in cols]
        for make in (lambda r: cls(*r), lambda r: cls(*map(torch.as_tensor, r))):
            p = make(row)
            assert str(p) == str(jcls(*row))
            np.testing.assert_array_equal(p.vector.numpy(), np.asarray(jcls(*row).vector))
    if cls is EquinoctialElements:
        vec = rng.normal(size=(5, 6))
        p, j = EquinoctialElements.from_vector(torch.as_tensor(cols[0][:5]), torch.as_tensor(vec)), \
            JEq.from_vector(jnp.asarray(cols[0][:5]), jnp.asarray(vec))
        for a, b in zip(p, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(p.vector.numpy(), vec)


def test_observer_from_parallax_matches_jax():
    for args in [(1.2, 0.8, 0.6), (np.float64(0.5), np.float32(0.25), 1), (0.1, 0.2, 0.3, "Site", "X01")]:
        assert vars(Observer.from_parallax(*args)) == vars(JObserver.from_parallax(*args))
    assert Observer.from_parallax(0.0, 0.0, 0.0, "Geocenter", "500") == Observer.geocenter()


def test_angle_diff_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.uniform(-20.0, 20.0, 2000)
    b = np.concatenate([rng.uniform(-20.0, 20.0, 1000), a[1000:] + math.pi, ])
    b[:3] = a[:3] + np.array([math.pi, -math.pi, 0.0])
    got = angle_diff(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_angle_diff(jnp.asarray(a), jnp.asarray(b))))
    assert ((got > -math.pi) & (got <= math.pi)).all()
    assert float(angle_diff(0.5, 0.25)) == float(j_angle_diff(0.5, 0.25))


def test_triplet_weight_matches_jax():
    rng = np.random.default_rng(5)
    t = np.sort(rng.uniform(0.0, 100.0, (3, 5000)), axis=0)
    t[:, :50] = t[0, :50]  # zero gaps
    for dtw in (0.5, 20.0, 1e3):
        np.testing.assert_array_equal(triplet_weight(*t, dtw), j_triplet_weight(*t, dtw))


@pytest.mark.parametrize("m_cap", [None, 12])
def test_generate_triplet_indices_device_matches_jax(m_cap):
    epochs, counts = _epoch_grid(np.random.default_rng(6), 14, 3, 30, dup=True)
    kw = dict(dt_min=0.03, dt_max=150.0, optimal_interval=20.0, max_obs=25, max_triplets=9, m_cap=m_cap)
    tj, kj = j_generate_device(jnp.asarray(epochs), jnp.asarray(counts.astype(np.int32)), **kw)
    for e, c in ((epochs, counts), (torch.as_tensor(epochs), torch.as_tensor(counts))):
        tt, kt = generate_triplet_indices_device(e, c, **kw)
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))


def test_complex_roots_shape_matches_jax():
    rng = np.random.default_rng(7)
    c = [-(10.0 ** rng.uniform(-1, 1, (4, 3))) for _ in range(3)]
    rt = aberth_deg8(*(torch.as_tensor(x) for x in c))
    rj = j_aberth(*(jnp.asarray(x) for x in c))
    assert tuple(rt.shape) == tuple(rj.shape) == (4, 3, 8)


# ---------------------------------------------------------------------------
# the port's examples
# ---------------------------------------------------------------------------


EXAMPLES = {
    "torch_run_full_iod": (["tests/data/8467.obs", "tests/data/2015AB.obs", "--lsq", "--realizations", "2",
                            "--device", "cpu,cpu"], "outcomes: {'LSQ': 2}"),
    "torch_generate_ephemeris": (["--days", "10", "--step", "5", "--device", "cpu"], "K09R05F  (a="),
    "torch_run_stream_service": (["--batches", "2", "--traj-per-batch", "8", "--escalate", "--device", "cpu"],
                                 "batch 1: 8 trajectories"),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_small_without_jax(name):
    args, expect = EXAMPLES[name]
    code = (
        "import runpy, sys, torch\n"
        "torch.set_num_threads(2)\n"
        f"sys.argv = [{name!r}] + {args!r}\n"
        f"runpy.run_path('examples/{name}.py', run_name='__main__')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'outfit_tpu.')) or m == 'outfit_tpu']\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, timeout=300,
                         env=dict(os.environ, OUTFIT_NO_DOWNLOAD="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert expect in out.stdout, out.stdout[-3000:]
