"""Observer state geometry.

Port of ``outfit_tpu/observer/geometry.py``: body-fixed observer vectors
(host-side numpy, one per observer) and heliocentric observer states
(Earth's ephemeris state plus the rotated geocentric vector).
"""

import numpy as np
import torch

from outfit_tpu_torch.constants import EARTH_ROTATION, ERAU, ROT_ECLMJ2000_TO_EQUMJ2000


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
