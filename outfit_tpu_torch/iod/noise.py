"""Monte-Carlo noise draws of the Gauss IOD lanes.

The JAX package draws with ``jax.random`` (threefry, ``fold_in(PRNGKey(seed),
crc32(traj_id))``, ``outfit_tpu/iod/api.py:328-337``), which PyTorch cannot
reproduce.  This module keeps the same contract with its own counter-based
generator: each standard normal depends only on (seed, crc32(traj_id),
triplet rank, realization, observation, component); it does not depend on
the batch, its order or chunking, the realized triplet count, or the
device.  Realization 0 is the exact triplet (zero noise).

Each (seed, trajectory) key is mixed on the host in exact integer
arithmetic; on the device, the counters go through the murmur3 32-bit
finalizer (``fmix32``) in int64 tensor arithmetic, with the 32-bit
products split into 16-bit halves so that nothing overflows.  Two 32-bit
words per (rank, realization, observation) become two normals by the
Box-Muller transform, whose logarithm, square root and sine/cosine are
evaluated with fixed polynomials and Newton steps in additions,
multiplications and divisions only: IEEE rounds those identically on the
CPU and on CUDA (PyTorch's CUDA ``sqrt`` of float64 is not correctly
rounded, so it is not used), and the draws are bit-identical on both.
"""

import math
import zlib

import numpy as np
import torch

from outfit_tpu_torch.utils.tensors import device_constant

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_WORD = (0x68E31DA4, 0xB5297A4D)
_LN2 = math.log(2.0)
#: exact powers of two 2^k, k = -64..64, for the square root's scaling
_POW2 = 2.0 ** np.arange(-64, 65, dtype=np.float64)
_SQRT_HALF = math.sqrt(0.5)
#: 2 atanh(s) = 2 s (1 + s^2/3 + s^4/5 + ...), |s| <= 0.1716 after reduction
_LOG_C = [1.0 / (2 * n + 1) for n in range(12)]
#: sin / cos Taylor coefficients on [0, pi/2)
_SIN_C = [(-1) ** n / math.factorial(2 * n + 1) for n in range(12)]
_COS_C = [(-1) ** n / math.factorial(2 * n) for n in range(13)]


def stable_hash(traj_id: str) -> int:
    """Order-stable trajectory hash (determinism contract,
    obs_dataset_api.rs:277-296)."""
    return zlib.crc32(traj_id.encode("utf-8"))


def _fmix32_int(x: int) -> int:
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & _M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def trajectory_keys(seed: int, traj_ids) -> np.ndarray:
    """Per-trajectory 32-bit keys (int64 array) of :func:`draw_noise`."""
    s = seed & ((1 << 64) - 1)
    base = _fmix32_int((s & _M32) ^ _fmix32_int(((s >> 32) ^ _GOLDEN) & _M32))
    return np.fromiter(
        (_fmix32_int(base ^ _fmix32_int(stable_hash(t))) for t in traj_ids),
        np.int64, count=len(traj_ids),
    )


def _mul32(x, c: int):
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32) and a 32-bit constant."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _horner(coeffs, x):
    acc = torch.full_like(x, coeffs[-1])
    for c in reversed(coeffs[:-1]):
        acc = acc * x + c
    return acc


def _log_unit(u):
    """ln(u) for u in (0, 1)."""
    m, e = torch.frexp(u)  # u = m 2^e, m in [0.5, 1)
    low = m < _SQRT_HALF
    m = torch.where(low, 2.0 * m, m)
    e = (e - low.to(e.dtype)).to(u.dtype)
    s = (m - 1.0) / (m + 1.0)
    return e * _LN2 + 2.0 * s * _horner(_LOG_C, s * s)


def _sqrt_pos(v):
    """sqrt(v) for v in (2^-64, 2^64): v = m 2^(2j) with m in [0.5, 2),
    six Newton steps on sqrt(m) from a linear guess, times 2^j."""
    m, e = torch.frexp(v)  # m in [0.5, 1)
    odd = (e % 2) != 0
    m = torch.where(odd, 2.0 * m, m)
    half = torch.div(e - odd.to(e.dtype), 2, rounding_mode="floor").to(torch.int64)
    y = 0.5 + 0.5 * m
    for _ in range(6):
        y = 0.5 * (y + m / y)
    return y * device_constant(_POW2, v.device)[half + 64]


def _cos_sin_turn(u):
    """(cos, sin) of 2 pi u for u in [0, 1), by quadrant."""
    q = torch.floor(4.0 * u)
    x = (4.0 * u - q) * (0.5 * math.pi)  # [0, pi/2)
    x2 = x * x
    s = x * _horner(_SIN_C, x2)
    c = _horner(_COS_C, x2)
    cos_t = torch.where(q == 0, c, torch.where(q == 1, -s, torch.where(q == 2, -c, s)))
    sin_t = torch.where(q == 0, s, torch.where(q == 1, c, torch.where(q == 2, -s, -c)))
    return cos_t, sin_t


def draw_noise(keys, max_triplets: int, n_real: int):
    """(T, max_triplets, n_real, 3, 2) standard normals for the trajectories
    of ``keys`` (int64 tensor from :func:`trajectory_keys`, on the device
    the draws are wanted on); ``[..., r, :, :]`` is realization r and the
    last axis is (RA, Dec)."""
    dev = keys.device
    x = keys.reshape(-1, 1, 1, 1)
    for n, size in enumerate((max_triplets, n_real, 3)):
        shape = [1, 1, 1, 1]
        shape[n + 1] = size
        v = torch.arange(size, dtype=torch.int64, device=dev).reshape(shape)
        x = _fmix32(x ^ ((v * _GOLDEN + 0x7F4A7C15) & _M32))
    w1, w2 = (_fmix32(x ^ c).to(torch.float64) for c in _WORD)
    u1 = (w1 + 0.5) * 2.0**-32  # (0, 1)
    u2 = w2 * 2.0**-32  # [0, 1)
    r = _sqrt_pos(-2.0 * _log_unit(u1))
    cos_t, sin_t = _cos_sin_turn(u2)
    z = torch.stack([r * cos_t, r * sin_t], dim=-1)
    z[:, :, 0] = 0.0  # realization 0 = the exact triplet
    return z
