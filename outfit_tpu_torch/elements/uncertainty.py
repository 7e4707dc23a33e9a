"""1-sigma uncertainties from a covariance.  Port of
``outfit_tpu/elements/uncertainty.py`` (``uncertainties_from_covariance``)."""

import torch


def uncertainties_from_covariance(covariance):
    """Per-element 1-sigma values: sqrt of the covariance diagonal (..., 6)."""
    diag = torch.diagonal(covariance, dim1=-2, dim2=-1)
    return torch.sqrt(torch.clamp(diag, min=0.0))
