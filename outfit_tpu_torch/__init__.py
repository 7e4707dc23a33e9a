"""outfit_tpu_torch: the PyTorch/CUDA port of outfit_tpu.

This slice covers the main path, ``fit_lsq(dataset, ephem, IODParams(),
config, seed=..., device=...)``: observation ingestion, the observer cache
(with the Chebyshev table evaluation as a hand-written CUDA kernel for
Hopper, ``csrc/chebyshev.cu``), Gauss initial orbit determination
(``fit_full_iod``, ``fit_iod``: triplet enumeration, Aberth roots, the f-g
correction over the universal Kepler solver, RMS scoring), and the
differential correction (two-body propagation with analytic partials, the
Newton / outlier-rejection loops, covariance extraction), seeded by the IOD
or by ``initial_orbits``.  Every tensor is float64.  The package imports
``torch`` and never ``jax``.
"""

from outfit_tpu_torch.ephem.api import JPLEphem
from outfit_tpu_torch.iod.api import FitResult, fit_full_iod, fit_iod
from outfit_tpu_torch.iod.params import IODParams
from outfit_tpu_torch.lsq.api import LsqResult, fit_lsq
from outfit_tpu_torch.lsq.config import DifferentialCorrectionConfig
from outfit_tpu_torch.observations.dataset import ObsDataset
from outfit_tpu_torch.observations.error_model import ErrorModel

__all__ = [
    "DifferentialCorrectionConfig",
    "ErrorModel",
    "FitResult",
    "IODParams",
    "JPLEphem",
    "LsqResult",
    "ObsDataset",
    "fit_full_iod",
    "fit_iod",
    "fit_lsq",
]
