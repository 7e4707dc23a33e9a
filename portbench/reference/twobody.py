"""Two-body motion and apparent positions, in plain PyTorch.

Elements are equinoctial in the mean ecliptic of J2000 (a, h, k, p, q,
lambda) at an epoch in MJD (TT); the Sun's GM is the Gaussian constant
squared.  The working precision is the elements' dtype: every quantity,
the epoch difference included, is formed in it, so a float32 call is a
float32 computation throughout.
"""

import math

import torch

from portbench.reference.ephem import ecliptic_to_equatorial

#: Gaussian gravitational constant squared, AU^3/day^2
MU = 0.01720209895**2
#: speed of light, AU/day
C_AU_DAY = 2.99792458e5 / 149_597_870.7 * 86400.0


def kepler_to_equinoctial(a, e, inc, node, argp, mean_anomaly):
    varpi = node + argp
    t = torch.tan(inc / 2)
    return torch.stack([a, e * torch.sin(varpi), e * torch.cos(varpi), t * torch.sin(node), t * torch.cos(node),
                        torch.remainder(varpi + mean_anomaly, 2 * math.pi)], dim=-1)


def state(elements, dt):
    """Heliocentric ecliptic position and velocity (..., 3) after ``dt``
    days; ``elements`` (..., 6) broadcasts against ``dt``."""
    a, h, k, p, q, lam = elements.unbind(-1)
    n = torch.sqrt(MU / a**3)
    lam1 = lam + n * dt
    # the generalized Kepler equation F - k sin F + h cos F = lambda by
    # Newton from F = lambda, then one more step kept in the graph so
    # derivatives follow the converged root
    hd, kd, ld = h.detach(), k.detach(), lam1.detach()
    # Danby's start E = M + 0.85 e sign(sin M) in the eccentric longitude
    # F = E + varpi, and Newton steps of at most one radian: near e = 1 a
    # plain Newton from F = lambda can leave the root's basin
    varpi = torch.atan2(hd, kd)
    m = ld - varpi
    f = ld + 0.85 * torch.sqrt(hd * hd + kd * kd) * torch.sign(torch.sin(m))
    for _ in range(60):
        step = (f - kd * torch.sin(f) + hd * torch.cos(f) - ld) / (1 - kd * torch.cos(f) - hd * torch.sin(f))
        f = f - torch.clamp(step, -1.0, 1.0)
    f = f - (f - k * torch.sin(f) + h * torch.cos(f) - lam1) / (1 - k * torch.cos(f) - h * torch.sin(f))
    sf, cf = torch.sin(f), torch.cos(f)
    beta = 1 / (1 + torch.sqrt(1 - h * h - k * k))
    x1 = a * ((1 - beta * h * h) * cf + beta * h * k * sf - k)
    y1 = a * ((1 - beta * k * k) * sf + beta * h * k * cf - h)
    r = torch.sqrt(x1 * x1 + y1 * y1)
    vx1 = n * a * a / r * (beta * h * k * cf - (1 - beta * h * h) * sf)
    vy1 = n * a * a / r * ((1 - beta * k * k) * cf - beta * h * k * sf)
    u = 1 + p * p + q * q
    fx, fy, fz = (1 - p * p + q * q) / u, 2 * p * q / u, -2 * p / u
    gx, gy, gz = 2 * p * q / u, (1 + p * p - q * q) / u, 2 * q / u
    pos = torch.stack([x1 * fx + y1 * gx, x1 * fy + y1 * gy, x1 * fz + y1 * gz], dim=-1)
    vel = torch.stack([vx1 * fx + vy1 * gx, vx1 * fy + vy1 * gy, vx1 * fz + vy1 * gz], dim=-1)
    return pos, vel


def apparent_radec(pos_equ, vel_equ, observer_equ):
    """Topocentric right ascension in [0, 2 pi) and declination, with the
    first-order aberration d - (|d| / c) v."""
    d = pos_equ - observer_equ
    d = d - torch.linalg.vector_norm(d, dim=-1, keepdim=True) / C_AU_DAY * vel_equ
    x, y, z = d.unbind(-1)
    return torch.remainder(torch.atan2(y, x), 2 * math.pi), torch.atan2(z, torch.sqrt(x * x + y * y))


def radec(elements, epoch, mjd, observer_equ):
    """Apparent (RA, Dec) of ``elements`` (R, 6) at epoch ``epoch`` (R,)
    seen at ``mjd`` (R, N) from ``observer_equ`` (R, N, 3).  The
    aberration term's velocity is held fixed under differentiation: the
    deployments' partials (Outfit's, ``lsq/iteration.py``) follow the
    apparent position through the position alone."""
    dt = (mjd - epoch[:, None]).to(elements.dtype)
    pos, vel = state(elements[:, None, :], dt)
    return apparent_radec(ecliptic_to_equatorial(pos), ecliptic_to_equatorial(vel).detach(), observer_equ)


def radec_and_partials(elements, epoch, mjd, observer_equ):
    """(ra, dec, d ra / d elements, d dec / d elements): values (R, N),
    partials (R, N, 6), by forward-mode differentiation."""
    def fn(x):
        return radec(x, epoch, mjd, observer_equ)

    cols_ra, cols_dec = [], []
    for j in range(6):
        tangent = torch.zeros_like(elements)
        tangent[:, j] = 1
        (ra, dec), (dra, ddec) = torch.func.jvp(fn, (elements,), (tangent,))
        cols_ra.append(dra)
        cols_dec.append(ddec)
    return ra, dec, torch.stack(cols_ra, -1), torch.stack(cols_dec, -1)
