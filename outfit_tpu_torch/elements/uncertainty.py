"""Covariance propagation and 1-sigma uncertainties.  Port of
``outfit_tpu/elements/uncertainty.py`` (parity: ``src/orbit_type/uncertainty.rs``,
``OrbitalCovariance.propagate`` :412 and ``from_covariance`` :244-278)."""

import torch

from outfit_tpu_torch.utils.linalg import matmul_small


def propagate_covariance(covariance, jacobian):
    """Sigma' = J Sigma J^T for batched (..., 6, 6) inputs."""
    return matmul_small(matmul_small(jacobian, covariance), torch.swapaxes(jacobian, -1, -2))


def uncertainties_from_covariance(covariance):
    """Per-element 1-sigma values: sqrt of the covariance diagonal (..., 6)."""
    diag = torch.diagonal(covariance, dim1=-2, dim2=-1)
    return torch.sqrt(torch.clamp(diag, min=0.0))
