"""Element conversions and two-body propagation of the PyTorch port against
the JAX package: positions at rtol 1e-12, partials at rtol 1e-10 (their
entries mix terms of very different size, so they cancel more)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from outfit_tpu.elements.twobody import propagate_twobody as j_propagate_twobody
from outfit_tpu.elements.twobody import solve_generalized_kepler as j_solve
from outfit_tpu.elements.types import EquinoctialElements as JEq
from outfit_tpu.elements.types import EquinoctialLimits as JLimits
from outfit_tpu.elements.types import KeplerianElements as JKep
from outfit_tpu.elements.types import equinoctial_to_keplerian as j_eq2kep
from outfit_tpu.elements.types import is_bizarre as j_is_bizarre
from outfit_tpu.elements.types import keplerian_to_equinoctial as j_kep2eq
from outfit_tpu.elements.uncertainty import uncertainties_from_covariance as j_sigmas
from outfit_tpu_torch.elements.twobody import propagate_twobody, solve_generalized_kepler
from outfit_tpu_torch.elements.types import (
    EquinoctialElements,
    EquinoctialLimits,
    KeplerianElements,
    equinoctial_to_keplerian,
    is_bizarre,
    keplerian_to_equinoctial,
)
from outfit_tpu_torch.elements.uncertainty import uncertainties_from_covariance

torch.set_num_threads(2)


def _kep_arrays(seed, n):
    rng = np.random.default_rng(seed)
    return [
        np.full(n, 57000.0),
        rng.uniform(0.8, 6.0, n),
        rng.uniform(0.0, 0.7, n),
        rng.uniform(0.0, 1.2, n),
        rng.uniform(0, 2 * np.pi, n),
        rng.uniform(0, 2 * np.pi, n),
        rng.uniform(0, 2 * np.pi, n),
    ]


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def test_element_conversions_match_jax():
    arrs = _kep_arrays(1, 200)
    arrs[2][:3] = 0.0  # circular lanes take the regularised branch
    eq_j = j_kep2eq(JKep(*map(jnp.asarray, arrs)))
    eq_t = keplerian_to_equinoctial(KeplerianElements(*map(_t, arrs)))
    for fj, ft in zip(eq_j, eq_t):
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-14, atol=1e-15)
    kep_j = j_eq2kep(eq_j)
    kep_t = equinoctial_to_keplerian(EquinoctialElements(*(_t(np.asarray(f)) for f in eq_j)))
    for fj, ft in zip(kep_j, kep_t):
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-13, atol=1e-13)


def test_is_bizarre_matches_jax():
    rng = np.random.default_rng(2)
    vec = np.stack([
        10.0 ** rng.uniform(-7, 5, 500), rng.uniform(-1, 1, 500), rng.uniform(-1, 1, 500),
        rng.uniform(-1, 1, 500), rng.uniform(-1, 1, 500), rng.uniform(0, 6, 500),
    ], -1)
    ep = np.zeros(500)
    bj = j_is_bizarre(JEq(ep, *vec.T), JLimits())
    bt = is_bizarre(EquinoctialElements(_t(ep), *(_t(c) for c in vec.T)), EquinoctialLimits())
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    assert 0 < bt.sum() < 500


def _batch(seed, T=6, N=9):
    kep = _kep_arrays(seed, T)
    eq = [np.asarray(f) for f in j_kep2eq(JKep(*map(jnp.asarray, kep)))]
    t1 = 57000.0 + np.random.default_rng(seed + 1).uniform(-400.0, 400.0, (T, N))
    return eq, t1


@pytest.mark.parametrize("derivatives", [True, False])
def test_propagate_twobody_matches_jax(derivatives):
    eq, t1 = _batch(3)
    rj = j_propagate_twobody(
        JEq(*(jnp.asarray(f)[:, None] for f in eq)), jnp.asarray(eq[0])[:, None],
        jnp.asarray(t1), compute_derivatives=derivatives,
    )
    rt = propagate_twobody(
        EquinoctialElements(*(_t(f)[:, None] for f in eq)), _t(eq[0])[:, None],
        _t(t1), compute_derivatives=derivatives,
    )
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_allclose(rt.position.numpy(), np.asarray(rj.position), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(rt.velocity.numpy(), np.asarray(rj.velocity), rtol=1e-12, atol=1e-16)
    np.testing.assert_allclose(rt.anomaly.numpy(), np.asarray(rj.anomaly), rtol=1e-13)
    if derivatives:
        scale = np.abs(np.asarray(rj.dpos_delem)).max()
        np.testing.assert_allclose(
            rt.dpos_delem.numpy(), np.asarray(rj.dpos_delem), rtol=1e-10, atol=1e-13 * scale
        )
        vscale = np.abs(np.asarray(rj.dvel_delem)).max()
        np.testing.assert_allclose(
            rt.dvel_delem.numpy(), np.asarray(rj.dvel_delem), rtol=1e-10, atol=1e-13 * vscale
        )
    else:
        assert not rt.dpos_delem.any()


def test_kepler_warm_start_matches_jax():
    """The correction loop's warm start: a previous solution (some lanes
    NaN = cold start) remapped into the current window."""
    eq, t1 = _batch(4)
    ej = JEq(*(jnp.asarray(f)[:, None] for f in eq))
    et = EquinoctialElements(*(_t(f)[:, None] for f in eq))
    lam = np.asarray(eq[6])[:, None] + 0.01 * (t1 - 57000.0)
    fj, sj, cj, _ = j_solve(ej, jnp.asarray(lam))
    rng = np.random.default_rng(5)
    warm = [np.asarray(x) + 1e-3 * rng.normal(size=lam.shape) for x in (fj, sj, cj)]
    warm[0][0, :3] = np.nan
    warm[0][1] += 4 * np.pi  # outside the window: remapped
    rj = j_solve(ej, jnp.asarray(lam + 1e-4), warm=tuple(map(jnp.asarray, warm)))
    rt = solve_generalized_kepler(et, _t(lam + 1e-4), warm=tuple(map(_t, warm)))
    np.testing.assert_array_equal(rt[3].numpy(), np.asarray(rj[3]))
    for a, b in zip(rt[:3], rj[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13, atol=1e-15)


def test_uncertainties_from_covariance_matches_jax():
    rng = np.random.default_rng(6)
    g = rng.normal(size=(10, 6, 6))
    cov = g @ np.swapaxes(g, -1, -2)
    cov[0, 2, 2] = -1e-3  # a negative diagonal clamps to 0
    np.testing.assert_allclose(
        uncertainties_from_covariance(_t(cov)).numpy(), np.asarray(j_sigmas(jnp.asarray(cov))),
        rtol=1e-15, atol=0,
    )


def _jacobian_inputs(kind):
    """Batched inputs of the four Jacobians: 200 random elliptic orbits (a
    few circular / equatorial lanes for the regularised branches), and
    cometary sets with e spanning the elliptic and hyperbolic branches."""
    arrs = _kep_arrays(3, 200)
    arrs[2][:3] = 0.0
    arrs[3][3:6] = 0.0
    if kind in ("keplerian_to_equinoctial", "equinoctial_to_keplerian"):
        return arrs
    rng = np.random.default_rng(4)
    n = 200
    e = np.concatenate([rng.uniform(0.05, 0.95, n // 2), rng.uniform(1.05, 3.0, n // 2)])
    return [np.full(n, 57000.0), rng.uniform(0.5, 4.0, n), e, rng.uniform(0.0, 1.2, n),
            rng.uniform(0, 2 * np.pi, n), rng.uniform(0, 2 * np.pi, n), rng.uniform(-1.0, 1.0, n)]


@pytest.mark.parametrize("kind", [
    "keplerian_to_equinoctial", "equinoctial_to_keplerian", "cometary_to_keplerian", "cometary_to_equinoctial",
])
def test_jacobians_match_jax(kind):
    """The 6x6 element Jacobians against the JAX ones at rtol 1e-12."""
    import outfit_tpu.elements.types as jt
    import outfit_tpu_torch.elements.types as tt

    arrs = _jacobian_inputs(kind)
    src = kind.split("_to_")[0]
    if src == "equinoctial":
        arrs = [np.asarray(f) for f in j_kep2eq(JKep(*map(jnp.asarray, arrs)))]
    cls_j = {"keplerian": JKep, "equinoctial": JEq, "cometary": jt.CometaryElements}[src]
    cls_t = {"keplerian": KeplerianElements, "equinoctial": EquinoctialElements, "cometary": tt.CometaryElements}[src]
    jj = np.asarray(getattr(jt, f"jacobian_{kind}")(cls_j(*map(jnp.asarray, arrs))))
    jp = getattr(tt, f"jacobian_{kind}")(cls_t(*map(_t, arrs))).numpy()
    assert jp.shape == (200, 6, 6) and np.isfinite(jp).all()
    np.testing.assert_allclose(jp, jj, rtol=1e-12, atol=0)


def test_propagate_covariance_matches_jax():
    from outfit_tpu.elements.uncertainty import propagate_covariance as j_propagate
    from outfit_tpu_torch.elements.uncertainty import propagate_covariance

    rng = np.random.default_rng(5)
    a = rng.normal(size=(20, 6, 6))
    cov = a @ np.swapaxes(a, -1, -2) * 1e-10
    jac = rng.normal(size=(20, 6, 6))
    want = np.asarray(j_propagate(jnp.asarray(cov), jnp.asarray(jac)))
    got = propagate_covariance(_t(cov), _t(jac)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
