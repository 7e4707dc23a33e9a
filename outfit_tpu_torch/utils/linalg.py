"""Small fixed-size linear algebra, unrolled.

Port of ``outfit_tpu/utils/linalg.py``.  The 6x6 Cholesky factorization,
the triangular inverse and the SPD inverse stay unrolled as plain batched
arithmetic: ``torch.linalg.cholesky`` raises on a non-SPD matrix, while the
correction loop needs a per-lane ok flag (errors as data).

The reference's QR fallback for matrices Cholesky rejects is left out on
purpose, as in the JAX package: a rescued near-singular inverse amplifies
1-ulp differences in the Jacobians by the condition number, which breaks
batch isolation (a lane's result would depend on its batchmates).  An
inversion failure falls back to the IOD orbit instead.
"""

import torch

from outfit_tpu_torch.utils.tensors import device_constant

_N = 6


def cholesky6(a):
    """Lower-triangular L with a = L L^T for batched (..., 6, 6) SPD input.

    Returns (L, ok) where ok flags positive-definiteness per batch element.
    Non-positive pivots are replaced by 1 to keep downstream math finite.
    """
    rows = [[None] * _N for _ in range(_N)]
    ok = torch.ones(a.shape[:-2], dtype=torch.bool, device=a.device)
    for i in range(_N):
        for j in range(i + 1):
            s = a[..., i, j]
            for k in range(j):
                s = s - rows[i][k] * rows[j][k]
            if i == j:
                ok = ok & (s > 0.0) & torch.isfinite(s)
                d = torch.sqrt(torch.where(s > 0.0, s, 1.0))
                rows[i][j] = d
            else:
                rows[i][j] = s / rows[j][j]
    zero = torch.zeros_like(a[..., 0, 0])
    L = torch.stack(
        [
            torch.stack([rows[i][j] if j <= i else zero for j in range(_N)], dim=-1)
            for i in range(_N)
        ],
        dim=-2,
    )
    return L, ok


def cholesky_inverse6(a):
    """Inverse of a batched (..., 6, 6) SPD matrix via Cholesky.

    Returns (inv, ok).  On failure (non-SPD) the result is garbage and ok is
    False — callers must gate on ok (errors-as-data convention).
    """
    L, ok = cholesky6(a)
    # invert L by forward substitution (unrolled): L @ Linv = I
    linv = [[None] * _N for _ in range(_N)]
    for j in range(_N):
        for i in range(j, _N):
            if i == j:
                linv[i][j] = 1.0 / L[..., i, i]
            else:
                s = 0.0
                for k in range(j, i):
                    s = s + L[..., i, k] * linv[k][j]
                linv[i][j] = -s / L[..., i, i]
    # inv(a) = Linv^T @ Linv
    zero = torch.zeros_like(a[..., 0, 0])
    out = [[zero] * _N for _ in range(_N)]
    for i in range(_N):
        for j in range(_N):
            s = zero
            for k in range(max(i, j), _N):
                s = s + linv[k][i] * linv[k][j]
            out[i][j] = s
    inv = torch.stack([torch.stack(out[i], dim=-1) for i in range(_N)], dim=-2)
    return inv, ok


def matmul_small(a, b):
    """(..., i, k) @ (..., k, j) -> (..., i, j) via multiply + reduce, the
    JAX package's summation form (``@`` would sum in another order)."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def matvec_small(m, v):
    """(..., i, j) @ (..., j) -> (..., i) via multiply + reduce."""
    return torch.sum(m * v[..., None, :], -1)


def rotate3(rot, v):
    """Apply a (3, 3) rotation (a module-level numpy constant) to (..., 3)
    vectors."""
    return torch.sum(device_constant(rot, v.device, v.dtype) * v[..., None, :], -1)


def cross3(a, b):
    """Cross product over the last axis, in ``jnp.cross``'s term order."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def norm3(v):
    """Euclidean norm over the last axis, as ``sqrt(sum(v * v))``."""
    return torch.sqrt(torch.sum(v * v, dim=-1))
