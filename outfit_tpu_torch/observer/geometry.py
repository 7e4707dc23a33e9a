"""Observer state geometry.

Port of ``outfit_tpu/observer/geometry.py``: body-fixed observer vectors
(host-side numpy, one per observer), the geocentric observer state in
ecliptic J2000 (``gast``, ``pvobs``) and heliocentric observer states
(Earth's ephemeris state plus the rotated geocentric vector).
"""

import numpy as np
import torch

from outfit_tpu_torch.constants import EARTH_ROTATION, ERAU, ROT_ECLMJ2000_TO_EQUMJ2000
from outfit_tpu_torch.frames import RefEpoch, RefSystem, equequ, rotmt, rotpn
from outfit_tpu_torch.time import gmst
from outfit_tpu_torch.time.scales import Ut1Provider
from outfit_tpu_torch.utils.linalg import matmul_small
from outfit_tpu_torch.utils.tensors import as_f64, input_device


def earth_fixed_position(observer):
    """Body-fixed observer position in AU (numpy, batched over arrays)."""
    lon = np.asarray(observer.longitude)
    rc = np.asarray(observer.rho_cos_phi)
    rs = np.asarray(observer.rho_sin_phi)
    return np.stack(
        [ERAU * rc * np.cos(lon), ERAU * rc * np.sin(lon), ERAU * rs], axis=-1
    )


def earth_fixed_velocity(observer):
    """Body-fixed velocity from Earth rotation, AU/day (numpy)."""
    r = earth_fixed_position(observer)
    omega = np.asarray(EARTH_ROTATION)
    return np.cross(np.broadcast_to(omega, r.shape), r)


def gast(mjd_tt, ut1: Ut1Provider, device=None):
    """Greenwich apparent sidereal time (radians) at TT epochs, a tensor on
    ``device`` (default: ``"cuda"`` when a card is present, the epochs' own
    when they lie on one, else ``"cpu"``).  The UT1 lookup is host-side
    numpy (table interpolation)."""
    device = input_device(device, mjd_tt)
    if isinstance(mjd_tt, torch.Tensor):
        mjd_tt = mjd_tt.cpu().numpy()
    mjd_np = np.asarray(mjd_tt)
    tut = ut1.tt_mjd_to_ut1(mjd_np)
    return gmst(tut, device) + equequ(mjd_np, device)


def pvobs(mjd_tt, observer_fixed_pos, observer_fixed_vel, gast_rad):
    """Geocentric observer state in ecliptic J2000.

    ``mjd_tt``: (...,) epochs; ``observer_fixed_pos/vel``: (..., 3) per-epoch
    body-fixed states; ``gast_rad``: (...,) precomputed GAST, whose device
    the result is on.  Returns (pos, vel) each (..., 3) in AU, AU/day.
    """
    gast_rad = as_f64(gast_rad)
    dev = gast_rad.device
    rot_earth = rotmt(-gast_rad, 2)  # body-fixed -> true equator
    rot_frame = rotpn(
        RefSystem.equt(RefEpoch.of_date(as_f64(mjd_tt, dev))),
        RefSystem.eclm(RefEpoch.j2000()),
    )
    m = matmul_small(rot_frame, rot_earth)
    dx = torch.sum(m * as_f64(observer_fixed_pos, dev)[..., None, :], -1)
    dv = torch.sum(m * as_f64(observer_fixed_vel, dev)[..., None, :], -1)
    return dx, dv


def _rotate_ecl_to_equ(v):
    rot = torch.as_tensor(ROT_ECLMJ2000_TO_EQUMJ2000, dtype=torch.float64, device=v.device)
    return torch.sum(rot * v[..., None, :], -1)


def helio_position(ephem, mjd_tt, geo_pos_ecl):
    """Heliocentric observer position, equatorial mean J2000 (AU)."""
    earth_pos, _ = ephem.earth_ephemeris(mjd_tt, velocity=False)
    return earth_pos + _rotate_ecl_to_equ(geo_pos_ecl)


def helio_velocity(ephem, mjd_tt, geo_vel_ecl):
    """Heliocentric observer velocity, equatorial mean J2000 (AU/day)."""
    _, earth_vel = ephem.earth_ephemeris(mjd_tt, velocity=True)
    return earth_vel + _rotate_ecl_to_equ(geo_vel_ecl)


def helio_state(ephem, mjd_tt, geo_pos_ecl, geo_vel_ecl):
    """Heliocentric observer position and velocity from one Earth-ephemeris
    evaluation: bitwise :func:`helio_position` and :func:`helio_velocity`
    (the JAX package calls both in one jitted program, where XLA merges
    their identical table lookups)."""
    earth_pos, earth_vel = ephem.earth_ephemeris(mjd_tt, velocity=True)
    return earth_pos + _rotate_ecl_to_equ(geo_pos_ecl), earth_vel + _rotate_ecl_to_equ(geo_vel_ecl)
