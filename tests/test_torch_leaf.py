"""Leaf modules of the PyTorch port against the JAX package.

The same inputs, drawn with numpy from a seed, go through the JAX function
(on the CPU in float64) and its port (on the CPU in float64).  Bounds: the
frame and time functions to 1e-13 absolute in radians or rotation-matrix
entries.  ``nutn80`` returns arcseconds and is compared after conversion to
radians: its series takes sines of arguments up to ~4e3 rad, where XLA's
and PyTorch's different summation orders of the 5-term argument and the
106-term series leave up to 6e-13 arcsec (3e-18 rad) between them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from outfit_tpu.constants import RADSEC
from outfit_tpu.frames import RefEpoch as JRefEpoch
from outfit_tpu.frames import RefSystem as JRefSystem
from outfit_tpu.frames import equequ as j_equequ
from outfit_tpu.frames import nutn80 as j_nutn80
from outfit_tpu.frames import obleq as j_obleq
from outfit_tpu.frames import prec as j_prec
from outfit_tpu.frames import rnut80 as j_rnut80
from outfit_tpu.frames import rotmt as j_rotmt
from outfit_tpu.frames import rotpn as j_rotpn
from outfit_tpu.kepler.angles import principal_angle as j_principal_angle
from outfit_tpu.time import gmst as j_gmst
from outfit_tpu.utils.linalg import cholesky_inverse6 as j_cholesky_inverse6
from outfit_tpu.utils.linalg import cholesky6 as j_cholesky6
from outfit_tpu.utils.linalg import matmul_small as j_matmul_small
from outfit_tpu_torch.frames import RefEpoch, RefSystem, equequ, nutn80, obleq, prec, rnut80, rotmt, rotpn
from outfit_tpu_torch.kepler.angles import principal_angle
from outfit_tpu_torch.time import gmst
from outfit_tpu_torch.utils.linalg import cholesky6, cholesky_inverse6, matmul_small

torch.set_num_threads(2)

ABS_FRAMES = 1e-13


def _epochs(seed, n=257):
    return np.random.default_rng(seed).uniform(45000.0, 65000.0, n)


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


@pytest.mark.parametrize("name", ["gmst", "obleq", "equequ", "nutn80_dpsi", "nutn80_deps"])
def test_scalar_series_match_jax(name):
    mjd = _epochs(1)
    j = {
        "gmst": lambda m: j_gmst(m),
        "obleq": lambda m: j_obleq(m),
        "equequ": lambda m: j_equequ(m),
        "nutn80_dpsi": lambda m: j_nutn80(m)[0] * RADSEC,
        "nutn80_deps": lambda m: j_nutn80(m)[1] * RADSEC,
    }[name](jnp.asarray(mjd))
    t = {
        "gmst": lambda m: gmst(m),
        "obleq": lambda m: obleq(m),
        "equequ": lambda m: equequ(m),
        "nutn80_dpsi": lambda m: nutn80(m)[0] * RADSEC,
        "nutn80_deps": lambda m: nutn80(m)[1] * RADSEC,
    }[name](_t(mjd))
    assert t.dtype == torch.float64
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ABS_FRAMES)


@pytest.mark.parametrize("name", ["rnut80", "prec", "rotmt0", "rotmt1", "rotmt2"])
def test_rotation_matrices_match_jax(name):
    mjd = _epochs(2, 64)
    ang = np.random.default_rng(3).uniform(-7.0, 7.0, 64)
    if name == "rnut80":
        j, t = j_rnut80(jnp.asarray(mjd)), rnut80(_t(mjd))
    elif name == "prec":
        j, t = j_prec(jnp.asarray(mjd)), prec(_t(mjd))
    else:
        k = int(name[-1])
        j, t = j_rotmt(jnp.asarray(ang), k), rotmt(_t(ang), k)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ABS_FRAMES)


_FRAME_PAIRS = [
    ("equt", "date", "eclm", None),  # the observer-cache chain
    ("equm", None, "eclm", None),
    ("equt", "date", "equm", "date2"),
    ("eclm", "date", "equm", "date2"),
    ("equm", "date", "equt", None),
]


@pytest.mark.parametrize("pair", _FRAME_PAIRS, ids=lambda p: f"{p[0]}-{p[2]}-{p[3]}")
def test_rotpn_matches_jax(pair):
    skind, sdate, dkind, ddate = pair
    mjd = _epochs(4, 33)
    mjd2 = mjd + 5.0

    def mk(mod, sys_cls, ep_cls, kind, date, conv):
        if date is None:
            ep = ep_cls.j2000()
        else:
            ep = ep_cls.of_date(conv(mjd if date == "date" else mjd2))
        return getattr(sys_cls, kind)(ep)

    j = j_rotpn(
        mk("j", JRefSystem, JRefEpoch, skind, sdate, jnp.asarray),
        mk("j", JRefSystem, JRefEpoch, dkind, ddate, jnp.asarray),
    )
    t = rotpn(
        mk("t", RefSystem, RefEpoch, skind, sdate, _t),
        mk("t", RefSystem, RefEpoch, dkind, ddate, _t),
    )
    np.testing.assert_allclose(t.numpy(), np.broadcast_to(np.asarray(j), t.shape), rtol=0, atol=ABS_FRAMES)


def test_principal_angle_matches_jax():
    a = np.random.default_rng(5).uniform(-40.0, 40.0, 1000)
    np.testing.assert_array_equal(principal_angle(_t(a)).numpy(), np.asarray(j_principal_angle(jnp.asarray(a))))


def _spd_batch(seed, n=64):
    """SPD 6x6 matrices with condition numbers up to ~1e6 (an inverse is
    good to cond * eps relative, and rtol 1e-12 is the bar), plus non-SPD
    ones that Cholesky must flag."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(n, 6, 6))
    scale = 10.0 ** rng.uniform(-1, 1, size=(n, 1, 6))
    a = (g * scale) @ np.swapaxes(g * scale, -1, -2) + 1e-3 * np.eye(6)
    a[::7] = -a[::7]  # negative definite: Cholesky must flag them
    a[3, 2, 2] = np.nan
    return a


def test_cholesky6_matches_jax():
    a = _spd_batch(6)
    lj, okj = j_cholesky6(jnp.asarray(a))
    lt, okt = cholesky6(_t(a))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    ok = np.asarray(okj)
    np.testing.assert_allclose(lt.numpy()[ok], np.asarray(lj)[ok], rtol=1e-12)


def test_cholesky_inverse6_matches_jax():
    a = _spd_batch(7)
    ij, okj = j_cholesky_inverse6(jnp.asarray(a))
    it, okt = cholesky_inverse6(_t(a))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    ok = np.asarray(okj)
    assert ok.sum() > 40
    np.testing.assert_allclose(it.numpy()[ok], np.asarray(ij)[ok], rtol=1e-12, atol=0)


def test_matmul_small_matches_jax():
    rng = np.random.default_rng(8)
    a, b = rng.normal(size=(50, 3, 3)), rng.normal(size=(50, 3, 3))
    np.testing.assert_allclose(
        matmul_small(_t(a), _t(b)).numpy(), np.asarray(j_matmul_small(jnp.asarray(a), jnp.asarray(b))),
        rtol=0, atol=1e-15,
    )
