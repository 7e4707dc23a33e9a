"""N-body propagation with the state transition matrix, in plain PyTorch.

Heliocentric mean-ecliptic J2000 frame; the Sun and the perturbers the
configuration names act by Newtonian gravity (the Sun's term is the
Keplerian force), with the heliocentric indirect term -GM_i r_i / |r_i|^3
of each planet; the planets move along the frozen analytic ephemeris,
evaluated at every stage time.  The variational equations dPhi/dt = A Phi,
A = [[0, I], [da/dr, 0]], carry the 6x6 state transition matrix, and the
element Jacobian at the end is Phi(t1) J0, J0 from the two-body state at
the epoch.

The integrator is Dormand and Prince's embedded 5(4) pair with a per-lane
step-size controller: every lane has its own time, step and error test,
so a lane's answer does not depend on its batch.  ``dtype`` is the state's
precision; times stay float64.
"""

import torch

from portbench.reference.ephem import gm_au3_day2, planet_ecliptic
from portbench.reference.twobody import state

_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)


def _derivative(t, y, bodies, gms):
    """d/dt of [r, v, Phi (36)] for lanes (L, 42) at times t (L,)."""
    r, v = y[:, 0:3], y[:, 3:6]
    phi = y[:, 6:].reshape(-1, 6, 6)
    acc = torch.zeros_like(r)
    grad = torch.zeros(r.shape[0], 3, 3, dtype=y.dtype, device=y.device)
    eye = torch.eye(3, dtype=y.dtype, device=y.device)
    for body, gm in zip(bodies, gms):
        if body == "sun":
            rb = torch.zeros_like(r)
        else:
            rb = planet_ecliptic(body, t).to(y.dtype)
            acc = acc - gm * rb / (rb * rb).sum(-1, keepdim=True) ** 1.5
        d = r - rb
        d2 = (d * d).sum(-1, keepdim=True)
        dn3 = d2**1.5
        acc = acc - gm * d / dn3
        grad = grad + gm * (3 * d[:, :, None] * d[:, None, :] / (d2 * dn3)[..., None] - eye / dn3[..., None])
    dphi = torch.cat([phi[:, 3:6, :], grad @ phi[:, 0:3, :]], dim=1)
    return torch.cat([v, acc, dphi.reshape(-1, 36)], dim=-1)


def propagate(elements, epoch, t1, bodies, dtype=torch.float64, tol=None, max_steps=100000):
    """Propagate equinoctial ``elements`` (L, 6) from ``epoch`` (L,) to ``t1``
    (L,).  Returns (position (L, 3), velocity (L, 3), d position / d
    elements (L, 6, 3), d velocity / d elements (L, 6, 3), accepted steps
    (L,), finished (L,))."""
    el = elements.to(dtype)
    eps = torch.finfo(dtype).eps
    tol = tol if tol is not None else max(1e-13, 1e4 * eps)
    gms = [gm_au3_day2(b) for b in bodies]

    def initial(x):
        pos, vel = state(x, torch.zeros_like(x[:, 0]))
        return torch.cat([pos, vel], -1)

    y_state = initial(el)
    j0 = torch.stack([torch.func.jvp(initial, (el,), (torch.nn.functional.one_hot(
        torch.full((el.shape[0],), j, device=el.device), 6).to(dtype),))[1] for j in range(6)], dim=-1)
    y = torch.cat([y_state, torch.eye(6, dtype=dtype, device=el.device).reshape(1, 36).expand(el.shape[0], 36)], -1)
    t = epoch.to(torch.float64).clone()
    t1 = t1.to(torch.float64)
    span = t1 - t
    h = span * 1e-3
    done = span.abs() < 1e-14
    steps = torch.zeros_like(t, dtype=torch.int64)
    for _ in range(max_steps):
        if done.all():
            break
        h = torch.where((t + h - t1) * torch.sign(span) > 0, t1 - t, h)
        k = []
        for s in range(7):
            ys = y
            for j, a in enumerate(_A[s]):
                if a != 0.0:
                    ys = ys + (h * a).to(dtype)[:, None] * k[j]
            k.append(_derivative(t + _C[s] * h, ys, bodies, gms))
        y5 = y + sum((h * b).to(dtype)[:, None] * kk for b, kk in zip(_B5, k) if b != 0.0)
        y4 = y + sum((h * b).to(dtype)[:, None] * kk for b, kk in zip(_B4, k) if b != 0.0)
        scale = tol + tol * torch.maximum(y.abs(), y5.abs())
        err = torch.sqrt((((y5 - y4) / scale) ** 2).mean(-1)).to(torch.float64)
        accept = (err <= 1.0) & ~done
        t = torch.where(accept, t + h, t)
        y = torch.where(accept[:, None], y5, y)
        steps = steps + accept.to(torch.int64)
        done = done | (accept & ((t1 - t).abs() < 1e-12))
        factor = torch.clamp(0.9 * torch.where(err > 0, err, 1e-10) ** -0.2, 0.2, 5.0)
        h = torch.where(done, h, h * factor)
    phi = y[:, 6:].reshape(-1, 6, 6)
    jac = phi @ j0  # (L, 6 state, 6 elements)
    return y[:, 0:3], y[:, 3:6], jac[:, 0:3, :].transpose(1, 2), jac[:, 3:6, :].transpose(1, 2), steps, done
