"""One Newton step of differential correction, batched over trajectories.

Port of ``outfit_tpu/lsq/iteration.py``:

* observation partials: two-body propagation with analytic 6x3 element
  Jacobians, or N-body propagation (DOP853 + state transition matrix),
  chain rule through the ecliptic->equatorial rotation and the
  position-dependence of the aberration correction,
* residuals against the debiased observations, with RA wrapping,
* the weighted least-squares solve: normal matrix, free-element masking
  with unit diagonal, Cholesky inversion, normalised RMS, correction norm.

The step runs in the elements' and observations' precision (float32 in the
mixed-precision pre-warm; MJDs and epochs stay float64), and
``jacobian_dtype=torch.float32`` evaluates only the element Jacobians in
float32 beside a float64 propagation (the mixed-precision main loop).

Every contraction is written as broadcast-multiply + sum, the JAX
package's summation form (``einsum``/``@`` would sum in another order, and
the Newton loop can then stop one trip apart near its threshold).

On a CUDA device the two-body step runs as one kernel, one warp per
trajectory (``lsq/step_cuda.py``, ``csrc/lsq_step.cuh``), with no device
read; on the CPU, and as the kernel's reference, as
:func:`_single_iteration_plain`.  The N-body step keeps its own path
(``propagate_nbody``) on every device.

Shapes: trajectories T, padded observations N.  Selection codes:
0 = Active, 1 = Rejected, 2 = ForcedOut.
"""

import math
from typing import NamedTuple

import torch

from outfit_tpu_torch import trace
from outfit_tpu_torch.constants import DPI, ROT_ECLMJ2000_TO_EQUMJ2000, VLIGHT_AU
from outfit_tpu_torch.elements.twobody import propagate_twobody
from outfit_tpu_torch.elements.types import EquinoctialElements
from outfit_tpu_torch.lsq import step_cuda
from outfit_tpu_torch.utils.linalg import cholesky_inverse6
from outfit_tpu_torch.utils.tensors import device_constant, lanewise

SEL_ACTIVE = 0
SEL_REJECTED = 1
SEL_FORCED_OUT = 2


class ObsArrays(NamedTuple):
    """Padded per-trajectory observation data (T, N)."""

    mjd: torch.Tensor
    ra: torch.Tensor
    dec: torch.Tensor
    sigma_ra: torch.Tensor
    sigma_dec: torch.Tensor
    helio_pos: torch.Tensor  # (T, N, 3) observer heliocentric, equatorial J2000
    valid: torch.Tensor  # (T, N) bool: real observation (not padding)
    #: per-observation astrometric bias (radians; e.g. star-catalog
    #: debiasing), subtracted from the observed angles in the residuals;
    #: None = unbiased
    bias_ra: torch.Tensor = None
    bias_dec: torch.Tensor = None


class IterationResult(NamedTuple):
    corrected: torch.Tensor  # (T, 6) corrected element vector
    correction_norm: torch.Tensor  # (T,)
    normalised_rms: torch.Tensor  # (T,)
    normal_matrix: torch.Tensor  # (T, 6, 6)
    covariance: torch.Tensor  # (T, 6, 6)
    inversion_ok: torch.Tensor  # (T,)
    num_measurements: torch.Tensor  # (T,) int
    residual_ra: torch.Tensor  # (T, N)
    residual_dec: torch.Tensor  # (T, N)
    d_ra: torch.Tensor  # (T, N, 6)
    d_dec: torch.Tensor  # (T, N, 6)
    obs_active: torch.Tensor  # (T, N) bool — actually used this iteration
    kepler: torch.Tensor  # (T, N, 3) (F, sin F, cos F) — warm start


def observation_partials(
    elements_vec, epoch, obs: ObsArrays, propagator=None, ephem=None,
    jacobian_dtype=None, kepler_warm=None,
):
    """Predicted (RA, Dec) + d/d(elem) for every (trajectory, observation).

    ``elements_vec`` (T, 6) equinoctial in ecliptic J2000; ``epoch`` (T,).
    Returns (ra, dec, d_ra (T,N,6), d_dec (T,N,6), prop_ok (T,N), kepler).

    ``propagator`` selects two-body (default, analytic Jacobians) or N-body
    (DOP853 + STM), which needs ``ephem`` and leaves ``kepler`` NaN.
    ``jacobian_dtype=torch.float32`` (two-body only) evaluates the element
    Jacobians in float32 beside a float64 propagation.
    """
    eq = EquinoctialElements(
        epoch[:, None], *(elements_vec[:, None, i] for i in range(6))
    )
    if propagator is not None and propagator.nbody:
        from outfit_tpu_torch.propagator.nbody import propagate_nbody

        nb = propagate_nbody(eq, obs.mjd, ephem, propagator.config, device=obs.mjd.device)
        st_pos, st_vel, st_dpos, st_conv = nb.position, nb.velocity, nb.dpos_delem, nb.status == 0
        kepler = torch.full(
            obs.mjd.shape + (3,), float("nan"), dtype=st_pos.dtype, device=st_pos.device
        )
    elif jacobian_dtype is None:
        st = propagate_twobody(
            eq, epoch[:, None], obs.mjd, compute_derivatives=True,
            kepler_warm=kepler_warm,
        )
        st_pos, st_vel, st_dpos, st_conv = st.position, st.velocity, st.dpos_delem, st.converged
        kepler = torch.stack([st.anomaly, st.anomaly_sin, st.anomaly_cos], dim=-1)
    else:
        st = propagate_twobody(
            eq, epoch[:, None], obs.mjd, compute_derivatives=False, kepler_warm=kepler_warm,
        )
        # the Jacobian pass re-propagates the same elements in the lower
        # precision and reuses the float64 Kepler solution; the epoch stays
        # float64 (dt is formed against float64 MJDs)
        eq_lo = EquinoctialElements(eq[0], *(f.to(jacobian_dtype) for f in eq[1:]))
        st_j = propagate_twobody(
            eq_lo, epoch[:, None], obs.mjd, compute_derivatives=True,
            kepler_solution=tuple(
                f.to(jacobian_dtype) for f in (st.anomaly, st.anomaly_sin, st.anomaly_cos)
            ),
        )
        st_pos, st_vel = st.position, st.velocity
        st_dpos = st_j.dpos_delem.to(st_pos.dtype)
        st_conv = st.converged & st_j.converged
        kepler = torch.stack([st.anomaly, st.anomaly_sin, st.anomaly_cos], dim=-1)

    rot = device_constant(ROT_ECLMJ2000_TO_EQUMJ2000, st_pos.device, st_pos.dtype)
    pos = torch.sum(rot * st_pos[..., None, :], -1)  # (T, N, 3) equ
    vel = torch.sum(rot * st_vel[..., None, :], -1)
    dpos = torch.sum(rot * st_dpos[..., None, :], -1)  # (T, N, 6, 3)

    rel = pos - obs.helio_pos
    rel_norm = torch.sqrt(torch.sum(rel * rel, dim=-1))
    cor = rel - (rel_norm[..., None] / VLIGHT_AU) * vel
    x, y, z = cor[..., 0], cor[..., 1], cor[..., 2]
    rho_xy2 = x * x + y * y
    rho_xy = torch.sqrt(rho_xy2)
    rho2 = rho_xy2 + z * z
    ra = torch.remainder(lanewise(torch.atan2, y, x), DPI)
    dec = lanewise(torch.atan2, z, rho_xy)

    grad_ra = torch.stack([-y / rho_xy2, x / rho_xy2, torch.zeros_like(x)], dim=-1)
    grad_dec = torch.stack(
        [-z * x / (rho_xy * rho2), -z * y / (rho_xy * rho2), rho_xy / rho2], dim=-1
    )
    ab = 1.0 / (rel_norm * VLIGHT_AU)
    d_ra_d_pos = grad_ra - (torch.sum(grad_ra * vel, dim=-1) * ab)[..., None] * rel
    d_dec_d_pos = grad_dec - (torch.sum(grad_dec * vel, dim=-1) * ab)[..., None] * rel

    d_ra = torch.sum(dpos * d_ra_d_pos[..., None, :], -1)  # (T, N, 6)
    d_dec = torch.sum(dpos * d_dec_d_pos[..., None, :], -1)

    prop_ok = st_conv & torch.isfinite(ra) & torch.isfinite(dec)
    return ra, dec, d_ra, d_dec, prop_ok, kepler


def _angular_diff(obs, calc):
    """(obs - calc) wrapped to (-pi, pi]."""
    d = torch.remainder(obs - calc, DPI)
    return torch.where(d > math.pi, d - DPI, d)


def single_iteration(
    elements_vec,
    epoch,
    selection,
    obs: ObsArrays,
    free_elements,
    propagator=None,
    ephem=None,
    jacobian_dtype=None,
    kepler_warm=None,
) -> IterationResult:
    """One batched Newton step: a two-body step on a CUDA device as the
    kernel of ``lsq/step_cuda.py``, else :func:`_single_iteration_plain`.
    ``trace.lsq_step.two_body`` counts the two-body steps on any device."""
    if propagator is None or not propagator.nbody:
        trace.lsq_step.add(two_body=1)
        if obs.mjd.device.type == "cuda":
            args, kw = _step_kernel_inputs(elements_vec, epoch, selection, obs, free_elements, jacobian_dtype,
                                           kepler_warm)
            return IterationResult(*step_cuda.step(*args, **kw))
    return _single_iteration_plain(elements_vec, epoch, selection, obs, free_elements, propagator, ephem,
                                   jacobian_dtype, kepler_warm)


def _step_kernel_inputs(elements_vec, epoch, selection, obs: ObsArrays, free_elements, jacobian_dtype=None,
                        kepler_warm=None):
    """:func:`single_iteration`'s two-body arguments as the kernel takes them
    (:func:`outfit_tpu_torch.lsq.step_cuda.step`): contiguous tensors on the
    observations' device, epochs and MJDs in float64, the selection in
    int32, the free elements as a bool tensor, the warm start's three
    tensors as given (the kernel reads them at their strides), and the
    Jacobians' type, the working type unless another is asked for.
    Returns ``(args, kwargs)``."""
    dev = obs.mjd.device

    def c(x, dtype=None):
        return None if x is None else x.to(dtype or x.dtype).contiguous()

    warm = (None, None, None) if kepler_warm is None else tuple(kepler_warm)
    args = (
        c(elements_vec), c(epoch, torch.float64), c(selection, torch.int32), c(obs.mjd, torch.float64),
        *(c(x) for x in (obs.ra, obs.dec, obs.sigma_ra, obs.sigma_dec, obs.helio_pos, obs.valid, obs.bias_ra,
                         obs.bias_dec)),
        *warm, torch.as_tensor(free_elements, dtype=torch.bool, device=dev),
    )
    return args, dict(jacobian_dtype=jacobian_dtype or elements_vec.dtype)


def _single_iteration_plain(
    elements_vec,
    epoch,
    selection,
    obs: ObsArrays,
    free_elements,
    propagator=None,
    ephem=None,
    jacobian_dtype=None,
    kepler_warm=None,
) -> IterationResult:
    """:func:`single_iteration` as batched tensor operations: the CPU's path,
    the N-body path on every device, and the plain version the kernel is
    held against."""
    ra_c, dec_c, d_ra, d_dec, prop_ok, kepler = observation_partials(
        elements_vec, epoch, obs, propagator, ephem, jacobian_dtype, kepler_warm
    )

    active = (selection == SEL_ACTIVE) & obs.valid & prop_ok
    # residuals/partials kept for rejected observations too, so the outlier
    # step evaluates chi^2 against the current orbit
    usable = obs.valid & prop_ok

    # debiased residuals: the catalog bias is subtracted from the observed
    # angles before differencing
    obs_ra = obs.ra if obs.bias_ra is None else obs.ra - obs.bias_ra
    obs_dec = obs.dec if obs.bias_dec is None else obs.dec - obs.bias_dec
    res_ra = torch.where(usable, _angular_diff(obs_ra, ra_c), 0.0)
    res_dec = torch.where(usable, obs_dec - dec_c, 0.0)
    g_ra = torch.where(usable[..., None], d_ra, 0.0)
    g_dec = torch.where(usable[..., None], d_dec, 0.0)

    # only ACTIVE observations contribute to the fit (weights masked)
    w_ra = torch.where(active, 1.0 / obs.sigma_ra**2, 0.0)
    w_dec = torch.where(active, 1.0 / obs.sigma_dec**2, 0.0)

    gw_ra = g_ra * w_ra[..., None]
    gw_dec = g_dec * w_dec[..., None]
    normal = torch.sum(
        gw_ra[..., :, None] * g_ra[..., None, :]
        + gw_dec[..., :, None] * g_dec[..., None, :],
        dim=1,
    )
    rhs = torch.sum(gw_ra * res_ra[..., None] + gw_dec * res_dec[..., None], dim=1)
    q = torch.sum(w_ra * res_ra**2 + w_dec * res_dec**2, dim=-1)
    m = (2 * torch.sum(active, dim=-1)).to(torch.int32)

    # free-element mask: zero fixed rows/cols, unit diagonal
    free = torch.as_tensor(free_elements, dtype=torch.bool, device=normal.device)  # no copy for a tensor
    fmask = free[:, None] & free[None, :]
    normal = torch.where(fmask, normal, 0.0) + torch.diag(
        torch.where(free, 0.0, 1.0).to(normal.dtype)
    )
    rhs = torch.where(free, rhs, 0.0)

    # unrolled Cholesky inversion (utils.linalg): the normal matrix is SPD
    # whenever invertible; no QR fallback (see the utils.linalg note)
    finite = torch.isfinite(normal).all(dim=-1).all(dim=-1)
    eye = torch.eye(6, dtype=normal.dtype, device=normal.device)
    normal_safe = torch.where(finite[:, None, None], normal, eye)
    cov, chol_ok = cholesky_inverse6(normal_safe)
    inv_ok = finite & chol_ok & torch.isfinite(cov).all(dim=-1).all(dim=-1) & (m >= 1)

    dx = torch.sum(cov * rhs[:, None, :], -1)
    dx = torch.where(free, dx, 0.0)
    dx = torch.where(inv_ok[:, None], dx, 0.0)

    ndx = torch.sum(normal * dx[:, None, :], -1)
    corr_norm = torch.sqrt(torch.clamp(torch.sum(dx * ndx, -1), min=0.0))
    rms = torch.sqrt(q / torch.clamp(m, min=1))
    rms = torch.where(m > 0, rms, 0.0)

    corrected = elements_vec + dx
    return IterationResult(
        corrected, corr_norm, rms, normal, cov, inv_ok, m,
        res_ra, res_dec, g_ra, g_dec, active, kepler,
    )
