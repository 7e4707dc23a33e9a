"""DOP853 and N-body propagation of the PyTorch port against the JAX package.

The same numpy inputs go through ``outfit_tpu.propagator`` and
``outfit_tpu_torch.propagator`` on the CPU in float64; the ephemeris tables
cross with ``JPLEphem.from_jax_tables``.  Tolerances:

* ``dop853_integrate``: 1e-11 against the JAX integrator, 5e-10 against
  scipy's DOP853 (tests/test_propagator.py's bar);
* ``_acceleration_and_gradient``: rtol 1e-13;
* ``propagate_nbody``: position 2e-11 AU, velocity 2e-12 AU/day, partials
  atol 1e-9, the same ``status``; ``n_steps`` within +-2 (XLA:CPU contracts
  ``a*b+c`` into FMAs and PyTorch does not, so an accept/reject at
  ``err_norm ~ 1`` may differ);
* ``body_ephemeris``: 1e-15 AU, times the vector's length beyond 1 AU (one
  ulp of Neptune's 30 AU is 3.6e-15 AU, and the two packages sum the
  Chebyshev terms in different orders); ``gast``: 1e-13 rad; ``pvobs``:
  1e-15 AU;
* inside the port an integrator lane alone and in a batch of 8 agree
  bitwise (N-body lanes at 1e-13 relative with equal step counts), and the
  zero-dt short-circuit is exact.

Run with ``-s`` to read the measured maxima (lines starting ``measured``).
"""

import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp

import jax.numpy as jnp

from outfit_tpu.constants import GAUSS_GRAV_SQUARED
from outfit_tpu.elements.types import EquinoctialElements as JEq
from outfit_tpu.ephem import Body as JBody
from outfit_tpu.ephem import JPLEphem as JJPLEphem
from outfit_tpu.observer.geometry import gast as j_gast
from outfit_tpu.observer.geometry import pvobs as j_pvobs
from outfit_tpu.propagator import NBodyConfig as JNBodyConfig
from outfit_tpu.propagator import dop853_integrate as j_dop853
from outfit_tpu.propagator import propagate_nbody as j_propagate_nbody
from outfit_tpu.propagator.nbody import _acceleration_and_gradient as j_acc_grad
from outfit_tpu.propagator.nbody import perturber_snapshots as j_snapshots
from outfit_tpu.time.scales import Ut1Provider as JUt1Provider
import outfit_tpu_torch
from outfit_tpu_torch import JPLEphem, Ut1Provider
from outfit_tpu_torch.elements.twobody import propagate_twobody
from outfit_tpu_torch.elements.types import EquinoctialElements
from outfit_tpu_torch.ephem.bodies import Body
from outfit_tpu_torch.observer.geometry import gast, pvobs
from outfit_tpu_torch.propagator import NBodyConfig, dop853_integrate, propagate_nbody
from outfit_tpu_torch.propagator.nbody import _acceleration_and_gradient, perturber_snapshots

torch.set_num_threads(2)

MU = GAUSS_GRAV_SQUARED
SPAN = (56900.0, 57400.0)
POS_ATOL, VEL_ATOL, PARTIALS_ATOL, STEPS_MARGIN = 2e-11, 2e-12, 1e-9, 2


def port_ephem(ej):
    """The JAX ephemeris' tables (every body's) as the port's ephemeris."""
    return JPLEphem.from_jax_tables(
        {b: (t.t0, t.granule_days, np.asarray(t.coeffs)) for b, t in ej.tables.items()},
        ej.emrat, ej.kind,
    )


@pytest.fixture(scope="module")
def eph_pair():
    ej = JJPLEphem.analytic(*SPAN)
    return ej, port_ephem(ej)


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def _assert_vectors_close(got, ref, tol=1e-15):
    """Each 3-vector within ``tol`` of its reference, in units of
    max(1, |reference|): a component of a 30 AU vector carries the rounding
    of its largest component."""
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.maximum(1.0, np.linalg.norm(ref, axis=-1, keepdims=True))
    print("measured 3-vectors port-JAX, in max(1, |v|):", float((np.abs(got - ref) / scale).max()))
    assert (np.abs(got - ref) <= tol * scale).all(), float((np.abs(got - ref) / scale).max())


def _kepler_rhs(cat, norm):
    def rhs(t, y):
        r = y[..., :3]
        return cat([y[..., 3:], -MU * r / norm(r) ** 3])
    return rhs


J_KEPLER = _kepler_rhs(lambda p: jnp.concatenate(p, axis=-1), lambda r: jnp.linalg.norm(r, axis=-1, keepdims=True))
T_KEPLER = _kepler_rhs(lambda p: torch.cat(p, dim=-1), lambda r: torch.sqrt(torch.sum(r * r, dim=-1, keepdim=True)))


# ---------------------------------------------------------------------------
# dop853_integrate
# ---------------------------------------------------------------------------


def test_dop853_exponential_decay_matches_jax():
    t1 = np.array([1.0, 2.0, 5.0, -1.0])
    rj = j_dop853(lambda t, y: -y, jnp.ones((4, 1)), 0.0, jnp.asarray(t1), rtol=1e-12, atol=1e-14)
    rt = dop853_integrate(lambda t, y: -y, torch.ones((4, 1), dtype=torch.float64), 0.0, _t(t1),
                          rtol=1e-12, atol=1e-14)
    assert rt.status.dtype == torch.int32 and rt.n_steps.dtype == torch.int32
    assert (rt.status.numpy() == 0).all() and (np.asarray(rj.status) == 0).all()
    print("measured dop853 decay port-JAX:", float(np.abs(rt.y.numpy() - np.asarray(rj.y)).max()),
          "n_steps", rt.n_steps.tolist(), np.asarray(rj.n_steps).tolist())
    np.testing.assert_allclose(rt.y.numpy(), np.asarray(rj.y), atol=1e-11, rtol=0)
    np.testing.assert_allclose(rt.y[:, 0].numpy(), np.exp(-t1), atol=1e-12, rtol=0)
    assert np.abs(rt.n_steps.numpy() - np.asarray(rj.n_steps)).max() <= STEPS_MARGIN


def test_dop853_kepler_orbit_matches_jax_and_scipy():
    y0 = np.array([2.0, 0.0, 0.0, 0.0, 0.011, 0.002])
    rj = j_dop853(J_KEPLER, jnp.asarray(y0), 0.0, 500.0, rtol=1e-12, atol=1e-14)
    rt = dop853_integrate(T_KEPLER, _t(y0), 0.0, 500.0, rtol=1e-12, atol=1e-14)
    assert int(rt.status) == 0 and rt.y.shape == (6,)
    np.testing.assert_allclose(rt.y.numpy(), np.asarray(rj.y), atol=1e-11, rtol=0)

    def rhs_np(t, y):
        return np.concatenate([y[3:], -MU * y[:3] / np.linalg.norm(y[:3]) ** 3])

    ref = solve_ivp(rhs_np, (0, 500.0), y0, method="DOP853", rtol=1e-12, atol=1e-14)
    print("measured dop853 orbit port-JAX:", float(np.abs(rt.y.numpy() - np.asarray(rj.y)).max()), "port-scipy:",
          float(np.abs(rt.y.numpy() - ref.y[:, -1]).max()), "n_steps", int(rt.n_steps), int(rj.n_steps))
    np.testing.assert_allclose(rt.y.numpy(), ref.y[:, -1], atol=5e-10, rtol=0)
    assert abs(int(rt.n_steps) - int(rj.n_steps)) <= STEPS_MARGIN


def test_dop853_backward_integration():
    rj = j_dop853(lambda t, y: -y, jnp.ones((1,)), 2.0, 0.0)
    rt = dop853_integrate(lambda t, y: -y, torch.ones(1, dtype=torch.float64), 2.0, 0.0)
    assert float(rt.y[0]) == pytest.approx(np.exp(2.0), rel=1e-10)
    assert float(rt.y[0]) == pytest.approx(float(rj.y[0]), abs=1e-11)


def test_dop853_step_budget_failure():
    """A blow-up with a budget of three trips: status 1 in both packages,
    and the budget bounds the accepted steps."""
    rj = j_dop853(lambda t, y: y * y, jnp.full((1,), 1.0), 0.0, 0.999, max_steps=3)
    rt = dop853_integrate(lambda t, y: y * y, torch.ones(1, dtype=torch.float64), 0.0, 0.999, max_steps=3)
    assert int(rt.status) == 1 == int(rj.status)
    assert int(rt.n_steps) <= 3


def test_dop853_lanes_are_independent_bitwise():
    """A lane alone and the same lane in a batch of 8 (Kepler orbits with
    periods from 0.35 to 164 years, so very different step counts): bitwise
    the same state, status and accepted steps."""
    a = np.array([1.0, 30.0, 0.5, 2.3, 5.2, 0.7, 9.5, 1.6])
    y0 = np.zeros((8, 6))
    y0[:, 0] = a
    y0[:, 2] = 0.1 * np.arange(8) / 8
    y0[:, 4] = np.sqrt(MU / a) * np.linspace(1.0, 1.25, 8)
    t1 = np.linspace(40.0, 75.0, 8) * np.array([1, 1, -1, 1, 1, -1, 1, 1])
    batch = dop853_integrate(T_KEPLER, _t(y0), torch.zeros(8, dtype=torch.float64), _t(t1))
    assert (batch.status == 0).all() and len(set(batch.n_steps.tolist())) > 2
    for i in range(8):
        alone = dop853_integrate(T_KEPLER, _t(y0[i:i + 1]), torch.zeros(1, dtype=torch.float64), _t(t1[i:i + 1]))
        assert torch.equal(alone.y[0], batch.y[i]), i
        assert int(alone.status[0]) == int(batch.status[i]) and int(alone.n_steps[0]) == int(batch.n_steps[i])


# ---------------------------------------------------------------------------
# ephemeris queries and observer geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("body", list(Body), ids=lambda b: b.name)
def test_body_ephemeris_matches_jax(eph_pair, body):
    ej, et = eph_pair
    if body == Body.SSB:  # no table in either package
        for e, b, t in ((ej, JBody.SSB, jnp.asarray([57000.0])), (et, body, _t([57000.0]))):
            with pytest.raises(KeyError):
                e.body_ephemeris(b, t)
        return
    mjd = np.random.default_rng(int(body)).uniform(SPAN[0] + 20.0, SPAN[1] - 20.0, (5, 7))
    pj, vj = ej.body_ephemeris(JBody(int(body)), jnp.asarray(mjd))
    pt, vt = et.body_ephemeris(body, _t(mjd))
    assert pt.shape == (5, 7, 3) and vt.shape == (5, 7, 3) and pt.dtype == torch.float64
    _assert_vectors_close(pt.numpy(), pj)
    _assert_vectors_close(vt.numpy(), vj)
    if body == Body.SUN:
        assert not pt.any() and not vt.any()


def test_every_planet_table_crosses(eph_pair):
    ej, et = eph_pair
    for b in NBodyConfig.with_planets().perturbing_bodies[1:]:
        np.testing.assert_array_equal(et.tables[Body(b)].coeffs.numpy(), np.asarray(ej.tables[JBody(b)].coeffs))
    assert {t.coeffs.shape[-1] for t in et.tables.values()} >= {8, 10, 12, 14}


def test_gast_and_pvobs_match_jax():
    rng = np.random.default_rng(5)
    mjd = rng.uniform(SPAN[0], SPAN[1], 23)
    gj = j_gast(mjd, JUt1Provider())
    gt = gast(mjd, Ut1Provider())
    print("measured gast port-JAX:", float(np.abs(gt.numpy() - np.asarray(gj)).max()))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-13, rtol=0)
    assert torch.equal(gast(_t(mjd), Ut1Provider()), gt)
    fp = rng.normal(0, 3e-5, (23, 3))
    fv = rng.normal(0, 2e-4, (23, 3))
    pj, vj = j_pvobs(jnp.asarray(mjd), jnp.asarray(fp), jnp.asarray(fv), gj)
    pt, vt = pvobs(_t(mjd), _t(fp), _t(fv), gt)
    print("measured pvobs port-JAX:", float(np.abs(pt.numpy() - np.asarray(pj)).max()),
          float(np.abs(vt.numpy() - np.asarray(vj)).max()))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-15, rtol=0)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-15, rtol=0)


# ---------------------------------------------------------------------------
# N-body
# ---------------------------------------------------------------------------


def test_acceleration_and_gradient_matches_jax(eph_pair):
    ej, et = eph_pair
    rng = np.random.default_rng(2)
    t0 = rng.uniform(57000.0, 57100.0, 9)
    r = rng.normal(0, 1.5, (9, 3))
    ppj, gmj = j_snapshots(ej, JNBodyConfig.with_planets(), jnp.asarray(t0))
    ppt, gmt = perturber_snapshots(et, NBodyConfig.with_planets(), _t(t0))
    assert ppt.shape == (9, 10, 3) and gmt.shape == (10,)
    _assert_vectors_close(ppt.numpy(), ppj)
    np.testing.assert_array_equal(gmt.numpy(), np.asarray(gmj))
    aj, gj = j_acc_grad(jnp.asarray(r), ppj, gmj)
    at, gt = _acceleration_and_gradient(_t(r), _t(ppj), gmt)
    print("measured acceleration, gradient port-JAX (relative):",
          float(np.abs(at.numpy() / np.asarray(aj) - 1).max()), float(np.abs(gt.numpy() / np.asarray(gj) - 1).max()))
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-13, atol=0)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-13, atol=1e-22)


def _elements(seed, n):
    rng = np.random.default_rng(seed)
    e, w = rng.uniform(0.0, 0.35, n), rng.uniform(0, 2 * np.pi, n)
    return [np.full(n, 57000.0), rng.uniform(1.2, 3.5, n), e * np.sin(w), e * np.cos(w),
            rng.uniform(-0.15, 0.15, n), rng.uniform(-0.15, 0.15, n), rng.uniform(0, 2 * np.pi, n)]


#: arcs of one batch: forward, backward, a zero arc and mixed lengths
ARCS = np.array([30.0, -30.0, 0.0, 12.5, -3.0, 27.0, 0.5])


def _assert_nbody_close(rt, rj):
    print("measured propagate_nbody port-JAX:", {
        f: float(np.abs(getattr(rt, f).numpy().astype(float) - np.asarray(getattr(rj, f))).max()) for f in rt._fields})
    np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rj.status))
    np.testing.assert_allclose(rt.position.numpy(), np.asarray(rj.position), atol=POS_ATOL, rtol=0)
    np.testing.assert_allclose(rt.velocity.numpy(), np.asarray(rj.velocity), atol=VEL_ATOL, rtol=0)
    np.testing.assert_allclose(rt.dpos_delem.numpy(), np.asarray(rj.dpos_delem), atol=PARTIALS_ATOL, rtol=0)
    np.testing.assert_allclose(rt.dvel_delem.numpy(), np.asarray(rj.dvel_delem), atol=PARTIALS_ATOL, rtol=0)
    assert np.abs(rt.n_steps.numpy() - np.asarray(rj.n_steps)).max() <= STEPS_MARGIN


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen", "moving"])
def test_propagate_nbody_matches_jax(eph_pair, frozen):
    """Forward, backward, zero and mixed arcs in one batch, all planets."""
    ej, et = eph_pair
    cols = _elements(3, len(ARCS))
    bodies = NBodyConfig.with_planets().perturbing_bodies
    rj = j_propagate_nbody(JEq(*map(jnp.asarray, cols)), jnp.asarray(57000.0 + ARCS), ej,
                           JNBodyConfig(perturbing_bodies=bodies, frozen_perturbers=frozen))
    rt = propagate_nbody(EquinoctialElements(*map(_t, cols)), _t(57000.0 + ARCS), et,
                         NBodyConfig(perturbing_bodies=bodies, frozen_perturbers=frozen))
    assert rt.position.shape == (len(ARCS), 3) and rt.dpos_delem.shape == (len(ARCS), 6, 3)
    assert rt.status.dtype == torch.int32 and rt.n_steps.dtype == torch.int32
    assert (rt.status == 0).all() and int(rt.n_steps[2]) == 0 and int(rt.n_steps[0]) > 0
    _assert_nbody_close(rt, rj)


def test_propagate_nbody_scalar_and_trajectory_by_epoch_shapes(eph_pair):
    """A scalar orbit, and the correction's (T, 1) elements against (T, N)
    epochs, Sun only, against the JAX package and the port's two-body."""
    ej, et = eph_pair
    cols = _elements(4, 3)
    rj = j_propagate_nbody(JEq(*(jnp.asarray(c[0]) for c in cols)), 57030.0, ej)
    rt = propagate_nbody(EquinoctialElements(*(_t(c[0]) for c in cols)), 57030.0, et)
    assert rt.position.shape == (3,) and rt.status.shape == ()
    _assert_nbody_close(rt, rj)
    t1 = 57000.0 + np.random.default_rng(6).uniform(-25, 25, (3, 4))
    eq = EquinoctialElements(*(_t(c)[:, None] for c in cols))
    rt = propagate_nbody(eq, _t(t1), et, NBodyConfig())
    rj = j_propagate_nbody(JEq(*(jnp.asarray(c)[:, None] for c in cols)), jnp.asarray(t1), ej, JNBodyConfig())
    assert rt.position.shape == (3, 4, 3) and rt.dvel_delem.shape == (3, 4, 6, 3)
    _assert_nbody_close(rt, rj)
    tb = propagate_twobody(eq, 57000.0, _t(t1))
    np.testing.assert_allclose(rt.position.numpy(), tb.position.numpy(), atol=1e-11, rtol=0)
    np.testing.assert_allclose(rt.velocity.numpy(), tb.velocity.numpy(), atol=1e-12, rtol=0)
    np.testing.assert_allclose(rt.dpos_delem.numpy(), tb.dpos_delem.numpy(), atol=1e-9, rtol=0)


def test_zero_dt_short_circuit_is_exact(eph_pair):
    _, et = eph_pair
    eq = EquinoctialElements(*map(_t, _elements(7, 4)))
    nb = propagate_nbody(eq, 57000.0, et, NBodyConfig.with_planets())
    tb = propagate_twobody(eq, 0.0, 0.0)
    for f in ("position", "velocity", "dpos_delem", "dvel_delem"):
        assert torch.equal(getattr(nb, f), getattr(tb, f)), f
    assert not nb.status.any() and not nb.n_steps.any()


def test_propagate_nbody_lanes_are_independent(eph_pair):
    """A lane alone and in a batch of 8, moving perturbers: the same status
    and accepted steps, the state within 1e-13 relative (the integrator is
    bitwise lane-independent, see above; the two-body start-up calls
    ``atan2``, whose vector and scalar paths may differ in the last bit)."""
    _, et = eph_pair
    cols = _elements(9, 8)
    t1 = 57000.0 + np.linspace(-30.0, 30.0, 8)
    cfg = NBodyConfig(perturbing_bodies=NBodyConfig.with_planets().perturbing_bodies, frozen_perturbers=False)
    batch = propagate_nbody(EquinoctialElements(*map(_t, cols)), _t(t1), et, cfg)
    for i in (0, 3, 7):
        alone = propagate_nbody(EquinoctialElements(*(_t(c[i:i + 1]) for c in cols)), _t(t1[i:i + 1]), et, cfg)
        assert int(alone.status[0]) == int(batch.status[i]) and int(alone.n_steps[0]) == int(batch.n_steps[i])
        for f in ("position", "velocity", "dpos_delem", "dvel_delem"):
            np.testing.assert_allclose(getattr(alone, f)[0].numpy(), getattr(batch, f)[i].numpy(), rtol=1e-13, atol=1e-16,
                                       err_msg=f"{i} {f}")


def test_missing_gm_raises(eph_pair):
    _, et = eph_pair
    eq = EquinoctialElements(*(_t(c[0]) for c in _elements(1, 1)))
    with pytest.raises(ValueError, match="no GM"):
        propagate_nbody(eq, 57010.0, et, NBodyConfig(perturbing_bodies=(int(Body.SUN), int(Body.EARTH))))


def test_facade_names():
    import outfit_tpu.propagator as jp

    for name in ("NBodyConfig", "PropagatorKind", "propagate_nbody", "dop853_integrate"):
        assert hasattr(jp, name) and hasattr(outfit_tpu_torch.propagator, name) and hasattr(outfit_tpu_torch, name)


# ---------------------------------------------------------------------------
# where the entry points run
# ---------------------------------------------------------------------------


def _run_dop853(x, device=None):
    return dop853_integrate(lambda t, y: -y, x([1.0]), x(0.0), x(0.5), device=device).y


def _run_nbody(x, device=None, et=None):
    cols = _elements(11, 2)
    return propagate_nbody(EquinoctialElements(*map(x, cols)), x(57000.0 + ARCS[:2]), et, NBodyConfig.with_planets(),
                           device=device).position


def _run_gast(x, device=None):
    return gast(x([57000.25, 57010.5]), Ut1Provider(), device=device)


@pytest.mark.parametrize("run", [_run_dop853, _run_nbody, _run_gast], ids=["dop853_integrate", "propagate_nbody", "gast"])
def test_device_defaults_through_resolve_device(eph_pair, monkeypatch, run):
    """Numbers, numpy arrays and CPU tensors (a fit result's elements) go
    to the default device, the card where there is one; ``device=`` is
    handed on as given.  The same values on each way."""
    from outfit_tpu_torch.utils import tensors

    asked = []

    def resolve(device=None):
        asked.append(device)
        return torch.device("cpu")

    monkeypatch.setattr(tensors, "resolve_device", resolve)
    kw = {"et": eph_pair[1]} if run is _run_nbody else {}
    from_numpy = run(np.asarray, **kw)
    assert asked[0] is None and from_numpy.device.type == "cpu"
    del asked[:]
    from_tensor = run(_t, **kw)
    assert asked[0] is None
    del asked[:]
    named = run(np.asarray, device="cpu", **kw)
    assert asked[0] == "cpu"
    assert torch.equal(from_numpy, from_tensor) and torch.equal(from_numpy, named)


def test_moved_ephemeris_is_uploaded_once(eph_pair):
    """``JPLEphem.to`` keeps the copy it makes for a device (here the meta
    device stands for the card), and an ephemeris already there is itself."""
    _, et = eph_pair
    assert et.to("cpu") is et and et.to(torch.device("cpu")) is et
    moved = et.to("meta")
    assert moved is not et and et.to("meta") is moved and moved.to("meta") is moved
    assert all(t.coeffs.device.type == "meta" for t in moved.tables.values())


def test_package_imports_without_scipy():
    """The DOP853 tableau is read on the first integration: importing the
    package and the two-body paths needs no scipy, an integration without
    it raises the ImportError."""
    import subprocess
    import sys

    code = (
        "import sys; sys.modules['scipy'] = None\n"
        "import torch, outfit_tpu_torch\n"
        "from outfit_tpu_torch import dop853_integrate, fit_lsq, propagate_nbody\n"
        "try:\n"
        "    dop853_integrate(lambda t, y: -y, torch.ones(1, dtype=torch.float64), 0.0, 1.0)\n"
        "except ImportError:\n"
        "    print('raised')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "raised", out.stderr[-2000:]
