"""outfit_tpu_torch: the PyTorch/CUDA port of outfit_tpu.

This slice covers the seeded least-squares path,
``fit_lsq(dataset, ephem, initial_orbits=seeds, device=...)``: observation
ingestion, the observer cache (with the Chebyshev table evaluation as a
hand-written CUDA kernel for Hopper, ``csrc/chebyshev.cu``), two-body
propagation with analytic partials, the Newton / outlier-rejection loops
and covariance extraction.  Every tensor is float64.  The package imports
``torch`` and never ``jax``.
"""

from outfit_tpu_torch.ephem.api import JPLEphem
from outfit_tpu_torch.iod.api import FitResult
from outfit_tpu_torch.lsq.api import LsqResult, fit_lsq
from outfit_tpu_torch.lsq.config import DifferentialCorrectionConfig
from outfit_tpu_torch.observations.dataset import ObsDataset
from outfit_tpu_torch.observations.error_model import ErrorModel

__all__ = [
    "DifferentialCorrectionConfig",
    "ErrorModel",
    "FitResult",
    "JPLEphem",
    "LsqResult",
    "ObsDataset",
    "fit_lsq",
]
