"""Chebyshev ephemeris of the PyTorch port against the JAX package, and the
CUDA kernel's wrapper.

``interpolate_body`` is held at the JAX package's own bar for its Pallas
kernel (tests/test_ephem.py: atol 1e-15 AU on position, 1e-16 AU/day on
velocity), on a batch that is not a multiple of any block size (37) too.
The CUDA kernel itself is tested on the card by tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from outfit_tpu.ephem import JPLEphem as JJPLEphem
from outfit_tpu.ephem.chebyshev import interpolate_body as j_interpolate_body
from outfit_tpu_torch import JPLEphem
from outfit_tpu_torch.ephem import chebyshev_cuda
from outfit_tpu_torch.ephem.bodies import Body
from outfit_tpu_torch.ephem.chebyshev import interpolate_body, interpolate_body_plain

torch.set_num_threads(2)

POS_ATOL = 1e-15
VEL_ATOL = 1e-16
SPAN = (53500.0, 61500.0)


@pytest.fixture(scope="module")
def eph_pair():
    return JJPLEphem.analytic(*SPAN), JPLEphem.analytic(*SPAN)


def _epochs(seed, n):
    return np.random.default_rng(seed).uniform(SPAN[0] + 50.0, SPAN[1] - 50.0, n)


def test_analytic_tables_bit_identical(eph_pair):
    ej, et = eph_pair
    assert set(int(b) for b in ej.tables) == set(int(b) for b in et.tables)
    for b, tj in ej.tables.items():
        tt = et.tables[Body(int(b))]
        assert (tt.t0, tt.granule_days) == (tj.t0, tj.granule_days)
        assert tt.coeffs.dtype == torch.float64
        np.testing.assert_array_equal(tt.coeffs.numpy(), np.asarray(tj.coeffs))


def test_from_jax_tables_round_trip(eph_pair):
    ej, et = eph_pair
    e2 = JPLEphem.from_jax_tables(
        {b: (t.t0, t.granule_days, np.asarray(t.coeffs)) for b, t in ej.tables.items()},
        ej.emrat, ej.kind,
    )
    for b, t in et.tables.items():
        assert torch.equal(e2.tables[b].coeffs, t.coeffs)
    assert (e2.emrat, e2.kind) == (et.emrat, et.kind)


@pytest.mark.parametrize("body", [Body.EMB, Body.MOON, Body.MARS_BARY])
@pytest.mark.parametrize("n", [300, 37])
def test_interpolate_body_matches_jax(eph_pair, body, n):
    ej, et = eph_pair
    mjd = _epochs(int(body) + n, n)
    pj, vj = j_interpolate_body(ej.tables[body], jnp.asarray(mjd))
    pt, vt = interpolate_body(et.tables[body], torch.as_tensor(mjd))
    assert pt.shape == (n, 3) and vt.shape == (n, 3)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=POS_ATOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=VEL_ATOL)


def test_interpolate_body_clamps_outside_coverage(eph_pair):
    ej, et = eph_pair
    mjd = np.array([SPAN[0] - 30.0, SPAN[1] + 30.0, SPAN[0], SPAN[1]])
    pj, vj = j_interpolate_body(ej.tables[Body.EMB], jnp.asarray(mjd))
    pt, vt = interpolate_body(et.tables[Body.EMB], torch.as_tensor(mjd))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=POS_ATOL)
    # 30 days past either edge tau is -4.75 / +4.75, where T_k grows and the
    # velocity sums carry one more ulp than inside coverage
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=2 * VEL_ATOL)


@pytest.mark.parametrize("body", [Body.EMB, Body.MOON])
@pytest.mark.parametrize("n", [300, 37])
def test_plain_version_matches_the_pallas_kernel(eph_pair, body, n):
    """``interpolate_body_plain`` against ``interpolate_body_pallas(...,
    interpret=True)`` (tests/test_ephem.py:337-355), time-sorted epochs as
    the fitting path gives them."""
    from outfit_tpu.ephem.pallas_kernel import interpolate_body_pallas

    ej, et = eph_pair
    mjd = np.linspace(56010.0, 57990.0 if n == 300 else 56100.0, n)
    pj, vj = interpolate_body_pallas(ej.tables[body], jnp.asarray(mjd), interpret=True)
    pt, vt = interpolate_body_plain(et.tables[body], torch.as_tensor(mjd))
    assert pt.shape == (n, 3) and vt.shape == (n, 3)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=POS_ATOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=VEL_ATOL)


@pytest.mark.parametrize("velocity", [True, False])
def test_earth_ephemeris_matches_jax(eph_pair, velocity):
    ej, et = eph_pair
    mjd = _epochs(9, 200).reshape(8, 25)
    pj, vj = ej.earth_ephemeris(jnp.asarray(mjd), velocity=velocity)
    pt, vt = et.earth_ephemeris(torch.as_tensor(mjd), velocity=velocity)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=POS_ATOL)
    if velocity:
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=VEL_ATOL)
    else:
        assert vt is None and vj is None


def test_cpu_tensors_take_the_plain_version(eph_pair):
    _, et = eph_pair
    before = dict(chebyshev_cuda.launches)
    mjd = torch.as_tensor(_epochs(10, 64))
    p, v = interpolate_body(et.tables[Body.EMB], mjd)
    p0, v0 = interpolate_body_plain(et.tables[Body.EMB], mjd)
    assert torch.equal(p, p0) and torch.equal(v, v0)
    assert chebyshev_cuda.launches == before


@pytest.mark.parametrize("site", ["body", "frame"])
def test_kernel_wrapper_raises_for_cpu_tensors(site):
    ch = {"body": 3, "frame": 10}[site]
    coeffs = torch.zeros((4, ch, 14), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        chebyshev_cuda.evaluate(coeffs, torch.zeros(5, dtype=torch.float64), 0.0, 1.0, site)
