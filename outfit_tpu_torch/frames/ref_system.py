"""Reference-system transformations (equatorial/ecliptic, mean/true, epochs).

Port of ``outfit_tpu/frames/ref_system.py``: ``rotmt`` elementary rotations
and ``rotpn``, which composes precession / nutation / obliquity rotations
between two (system, epoch) pairs.  Frame tags are Python values, resolved
into a fixed sequence of matrix products; epoch dates may be tensors, so one
``rotpn`` call covers a whole batch of epochs ((..., 3, 3) out).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import torch

from outfit_tpu_torch.constants import EPS, T2000
from outfit_tpu_torch.frames.earth_orientation import obleq, prec, rnut80
from outfit_tpu_torch.utils.linalg import matmul_small
from outfit_tpu_torch.utils.tensors import as_f64


def rotmt(alpha, k: int, device=None):
    """Elementary frame rotation about axis k (0=X, 1=Y, 2=Z).

    rotmt(a, 0) = [[1, 0, 0], [0, cos a, sin a], [0, -sin a, cos a]]
    (coordinates of a fixed vector in a frame rotated by +a).
    ``alpha`` of shape (...) gives (..., 3, 3).
    """
    a = as_f64(alpha, device)
    c, s = torch.cos(a), torch.sin(a)
    one = torch.ones_like(c)
    zero = torch.zeros_like(c)
    if k == 0:
        rows = [[one, zero, zero], [zero, c, s], [zero, -s, c]]
    elif k == 1:
        rows = [[c, zero, -s], [zero, one, zero], [s, zero, c]]
    elif k == 2:
        rows = [[c, s, zero], [-s, c, zero], [zero, zero, one]]
    else:
        from outfit_tpu_torch.errors import InvalidRefSystem

        raise InvalidRefSystem(f"rotmt: invalid axis index {k} (must be 0,1,2)")
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


@dataclass(frozen=True)
class RefEpoch:
    """Epoch tag: J2000 or of-date (``date`` a float or a tensor)."""

    date: object
    is_j2000: bool = False

    @classmethod
    def j2000(cls) -> "RefEpoch":
        return cls(date=T2000, is_j2000=True)

    @classmethod
    def of_date(cls, mjd_tt) -> "RefEpoch":
        return cls(date=mjd_tt, is_j2000=False)


@dataclass(frozen=True)
class RefSystem:
    """Frame tag: kind in {"Equm", "Equt", "Eclm"} plus an epoch."""

    kind: str
    epoch: RefEpoch

    @classmethod
    def equm(cls, epoch: Union[RefEpoch, None] = None) -> "RefSystem":
        return cls("Equm", epoch or RefEpoch.j2000())

    @classmethod
    def equt(cls, epoch: Union[RefEpoch, None] = None) -> "RefSystem":
        return cls("Equt", epoch or RefEpoch.j2000())

    @classmethod
    def eclm(cls, epoch: Union[RefEpoch, None] = None) -> "RefSystem":
        return cls("Eclm", epoch or RefEpoch.j2000())


def _epochs_statically_equal(e1: RefEpoch, e2: RefEpoch) -> bool:
    """Epoch equality that selects the rotation chain: two of-date epochs
    are equal only if they are the same object or both scalars within EPS.
    A batch of epochs never compares equal (the chain through J2000 is
    exact either way) — the JAX package decides the same at trace time."""
    if e1.is_j2000 and e2.is_j2000:
        return True
    if e1.date is e2.date:
        return True
    try:
        return abs(float(e1.date) - float(e2.date)) <= EPS
    except (TypeError, ValueError, RuntimeError):
        return False


def _swap(m):
    return torch.swapaxes(m, -1, -2)


def rotpn(src: RefSystem, dst: RefSystem):
    """Rotation matrix taking vectors from frame ``src`` to frame ``dst``:
    x_dst = R @ x_src, R passive (later steps accumulate on the LEFT).
    Epoch dates may be tensors; the result is (..., 3, 3) on their device.
    """
    device = next(
        (e.date.device for e in (src.epoch, dst.epoch)
         if isinstance(e.date, torch.Tensor)),
        None,
    )
    current = src
    rotation = None  # lazily-broadcast identity

    def _mul(acc, step):
        return step if acc is None else matmul_small(step, acc)

    for _ in range(20):
        if not _epochs_statically_equal(current.epoch, dst.epoch):
            # Step 1: move epoch toward destination (via Equm / J2000).
            if current.epoch.is_j2000:
                if current.kind == "Eclm":
                    # the reference removes obliquity about axis 1 here
                    step = rotmt(-obleq(T2000, device), 1)
                    current = RefSystem("Equm", current.epoch)
                elif current.kind == "Equt":
                    step = _swap(rnut80(T2000, device))
                    current = RefSystem("Equm", current.epoch)
                else:  # Equm @ J2000 -> precess to destination date
                    step = prec(dst.epoch.date, device)
                    current = RefSystem("Equm", dst.epoch)
            else:
                if current.kind == "Eclm":
                    # same axis-1 quirk as the J2000 twin above
                    step = rotmt(-obleq(current.epoch.date, device), 1)
                    current = RefSystem("Equm", current.epoch)
                elif current.kind == "Equt":
                    step = _swap(rnut80(current.epoch.date, device))
                    current = RefSystem("Equm", current.epoch)
                else:  # Equm of-date -> back to J2000
                    step = _swap(prec(current.epoch.date, device))
                    current = RefSystem("Equm", RefEpoch.j2000())
            rotation = _mul(rotation, step)
            continue

        if current.kind == dst.kind:
            if rotation is None:
                shape = as_f64(current.epoch.date, device).shape
                eye = torch.eye(3, dtype=torch.float64, device=device)
                rotation = torch.broadcast_to(eye, shape + (3, 3))
            return rotation

        # Step 2: switch system kind at fixed epoch.
        d = current.epoch.date
        if current.kind == "Equt":
            step = _swap(rnut80(d, device))
            current = RefSystem("Equm", current.epoch)
        elif current.kind == "Eclm":
            step = rotmt(-obleq(d, device), 0)
            current = RefSystem("Equm", current.epoch)
        else:  # Equm -> target kind
            if dst.kind == "Equt":
                step = rnut80(d, device)
                current = RefSystem("Equt", current.epoch)
            else:  # Eclm
                step = rotmt(obleq(d, device), 0)
                current = RefSystem("Eclm", current.epoch)
        rotation = _mul(rotation, step)

    from outfit_tpu_torch.errors import InvalidRefSystem

    raise InvalidRefSystem("rotpn: transformation did not converge in 20 iterations")
