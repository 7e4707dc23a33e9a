"""Universal Kepler solver, state -> elements and cometary conversions of
the PyTorch port against the JAX package, on the same numpy inputs in f64.

Bars: the JAX suite's (tests/test_kepler.py): rtol 5e-12 / atol 1e-12 on
Stumpff values, universal anomalies and propagated states; status and
convergence flags exact.  Element conversions at rtol 1e-12 / atol 1e-14.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from outfit_tpu.constants import GAUSS_GRAV_SQUARED
from outfit_tpu.elements.orb_elem import ccek1 as j_ccek1
from outfit_tpu.elements.orb_elem import eccentricity_control as j_ecc_control
from outfit_tpu.elements.types import CometaryElements as JCom
from outfit_tpu.elements.types import cometary_to_equinoctial as j_com2eq
from outfit_tpu.elements.types import cometary_to_keplerian as j_com2kep
from outfit_tpu.kepler.stumpff import s_funct as j_s_funct
from outfit_tpu.kepler.universal import KeplerParams as JKP
from outfit_tpu.kepler.universal import SolverConfig as JCfg
from outfit_tpu.kepler.universal import prelim_kepuni as j_prelim
from outfit_tpu.kepler.universal import propagate_universal as j_propagate
from outfit_tpu.kepler.universal import solve_kepuni as j_solve
from outfit_tpu.kepler.universal import velocity_correction as j_vcorr
from outfit_tpu_torch.elements.orb_elem import ccek1, eccentricity_control
from outfit_tpu_torch.elements.types import CometaryElements, cometary_to_equinoctial, cometary_to_keplerian
from outfit_tpu_torch.kepler.stumpff import s_funct
from outfit_tpu_torch.kepler.universal import (
    KeplerParams,
    SolverConfig,
    _newton,
    prelim_kepuni,
    propagate_universal,
    solve_kepuni,
    velocity_correction,
)

torch.set_num_threads(2)

RTOL, ATOL = 5e-12, 1e-12
MU = GAUSS_GRAV_SQUARED


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def _close(port, ref, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=rtol, atol=atol, err_msg=msg)


def test_s_funct_matches_jax():
    rng = np.random.default_rng(1)
    psi = np.concatenate([rng.uniform(-80, 80, 3000), [0.0, 1e-8, -3.0]])
    alpha = np.concatenate([
        -(10.0 ** rng.uniform(-6, 0.5, 1500)), 10.0 ** rng.uniform(-6, -0.5, 1500), [0.0, 0.3, -0.2],
    ])
    assert (np.abs(alpha * psi * psi) > 4.0**6).any()  # lanes that halve many times
    for a, b, name in zip(s_funct(_t(psi), _t(alpha)), j_s_funct(jnp.asarray(psi), jnp.asarray(alpha)), "s0 s1 s2 s3".split()):
        _close(a, b, msg=name)


def _kepler_params(seed, n):
    rng = np.random.default_rng(seed)
    r0 = rng.uniform(0.1, 10.0, n)
    sig0 = rng.uniform(-0.05, 0.05, n)
    third = n // 3
    alpha = np.concatenate([
        -(10.0 ** rng.uniform(-4, 0.3, third)), 10.0 ** rng.uniform(-4, -0.5, third), np.zeros(n - 2 * third),
    ])
    e0 = np.sqrt(np.maximum(1.0 + alpha * rng.uniform(0.001, 4.0, n) / MU, 0.0))
    e0[2 * third:] = 1.0
    dt = rng.uniform(-400, 400, n)
    return [dt, r0, sig0, np.full(n, MU), alpha, e0]


def test_prelim_kepuni_three_regimes_match_jax():
    arrs = _kepler_params(2, 300)
    assert (arrs[4] < 0).any() and (arrs[4] > 0).any() and (arrs[4] == 0).any()
    _close(prelim_kepuni(KeplerParams(*map(_t, arrs))), j_prelim(JKP(*map(jnp.asarray, arrs))))


@pytest.mark.parametrize("max_newton", [50, 3])
def test_solve_kepuni_matches_jax(max_newton):
    """``max_newton=3`` leaves lanes unconverged, so the bisection fallback
    runs on them."""
    arrs = _kepler_params(3, 200)
    if max_newton == 3:
        p, cfg = KeplerParams(*map(_t, arrs)), SolverConfig(max_newton=3)
        assert not _newton(prelim_kepuni(p, cfg), p, cfg)[1].all()
    rt = solve_kepuni(KeplerParams(*map(_t, arrs)), SolverConfig(max_newton=max_newton))
    rj = j_solve(JKP(*map(jnp.asarray, arrs)), JCfg(max_newton=max_newton))
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    assert rt.converged.float().mean() > 0.9
    for name in ("psi", "s0", "s1", "s2", "s3"):
        _close(getattr(rt, name), getattr(rj, name), msg=name)


def _states(seed, n):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)) * rng.uniform(0.5, 4.0, (n, 1))
    r = np.linalg.norm(pos, axis=1, keepdims=True)
    v_circ = np.sqrt(MU / r)
    vel = rng.normal(size=(n, 3)) * v_circ * rng.uniform(0.3, 0.9, (n, 1))
    vel[: n // 8] *= 2.5  # hyperbolic lanes
    return pos, vel


def test_propagate_universal_matches_jax():
    pos, vel = _states(4, 120)
    dt = np.random.default_rng(5).uniform(-300, 300, 120)
    rt = propagate_universal(_t(pos), _t(vel), 0.0, _t(dt))
    rj = j_propagate(jnp.asarray(pos), jnp.asarray(vel), 0.0, jnp.asarray(dt))
    np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rj.status))
    for name in ("r1", "v1", "f_lag", "g_lag", "f_dot", "g_dot", "psi"):
        _close(getattr(rt, name), getattr(rj, name), msg=name)


def test_velocity_correction_matches_jax():
    pos, vel = _states(6, 90)
    rng = np.random.default_rng(7)
    dt = rng.uniform(-30, 30, 90)
    x1 = np.asarray(j_propagate(jnp.asarray(pos), jnp.asarray(vel), 0.0, jnp.asarray(dt)).r1)
    v2 = vel * (1.0 + 1e-3 * rng.normal(size=vel.shape))
    chi = np.where(rng.uniform(size=90) < 0.5, 0.0, rng.normal(size=90) * 0.1)
    cfg_t, cfg_j = SolverConfig(convergency=1e-13, auto_fallback=False), JCfg(convergency=1e-13, auto_fallback=False)
    rt = velocity_correction(_t(x1), _t(pos), _t(v2), _t(dt), 1e3, 5.0, chi_guess=_t(chi), cfg=cfg_t)
    rj = j_vcorr(jnp.asarray(x1), jnp.asarray(pos), jnp.asarray(v2), jnp.asarray(dt), 1e3, 5.0,
                 chi_guess=jnp.asarray(chi), cfg=cfg_j)
    np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rj.status))
    for name in ("v2_corrected", "f", "g", "psi"):
        _close(getattr(rt, name), getattr(rj, name), msg=name)


def test_velocity_correction_oracle():
    """tests/test_kepler.py::TestVelocityCorrectionOracle on the port."""
    res = velocity_correction(
        _t([-0.8435611261296833, 0.9372883273707728, 0.6591839010297766]),
        _t([-0.623121622917384, 1.0076797884556383, 0.7081256879844245]),
        _t([-1.5524310368624056e-2, -3.984104176604068e-3, -2.7640154361637183e-3]),
        14.731970000000729, peri_max=1.0, ecc_max=1.0,
    )
    assert int(res.status) == 0
    np.testing.assert_allclose(float(res.f), 0.9881648770972906, rtol=1e-12)
    np.testing.assert_allclose(float(res.g), 14.674676076120734, rtol=1e-12)
    np.testing.assert_allclose(
        res.v2_corrected.numpy(),
        [-0.015524310248562921, -0.003984104769239458, -0.0027640155187336176], rtol=1e-11,
    )


def test_ccek1_and_eccentricity_control_match_jax():
    pos, vel = _states(8, 200)
    pos[6, 2], vel[6, 2] = 0.0, 0.0  # equatorial
    rt, rj = ccek1(_t(pos), _t(vel)), j_ccek1(jnp.asarray(pos), jnp.asarray(vel))
    np.testing.assert_array_equal(rt.kind.numpy(), np.asarray(rj.kind))
    assert set(rt.kind.tolist()) == {0, 1}
    _close(rt.elements, rj.elements, rtol=1e-12, atol=1e-14)
    et = eccentricity_control(_t(pos), _t(vel), 1.0, 0.9)
    ej = j_ecc_control(jnp.asarray(pos), jnp.asarray(vel), 1.0, 0.9)
    np.testing.assert_array_equal(et[0].numpy(), np.asarray(ej[0]))
    assert 0 < int(et[0].sum()) < 200
    for a, b in zip(et[1:], ej[1:]):
        _close(a, b, rtol=1e-12, atol=1e-14)


def test_cometary_conversions_match_jax():
    rng = np.random.default_rng(9)
    n = 200
    e = np.concatenate([rng.uniform(1.01, 3.0, n // 2), rng.uniform(0.0, 0.95, n // 2)])
    arrs = [np.full(n, 59000.0), rng.uniform(0.2, 5.0, n), e, rng.uniform(0, 3.0, n),
            rng.uniform(0, 6.2, n), rng.uniform(0, 6.2, n), rng.uniform(-1.5, 1.5, n)]
    for fn_t, fn_j in ((cometary_to_keplerian, j_com2kep), (cometary_to_equinoctial, j_com2eq)):
        rt = fn_t(CometaryElements(*map(_t, arrs)))
        rj = fn_j(JCom(*map(jnp.asarray, arrs)))
        for a, b in zip(rt, rj):
            _close(a, b, rtol=1e-12, atol=1e-14)
