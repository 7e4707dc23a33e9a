# Source: outfit_tpu/lsq/config.py (copied; the serialisation helpers wait).
"""Differential-correction configuration, with the reference's defaults
(``DifferentialCorrectionConfig``, ``diff_cor.rs:78-192``;
``OutlierRejectionConfig``, ``outlier_rejection.rs:49-80``)."""

from dataclasses import dataclass
from typing import Tuple

from outfit_tpu_torch.elements.types import EquinoctialLimits
from outfit_tpu_torch.propagator.config import PropagatorKind


@dataclass(frozen=True)
class OutlierRejectionConfig:
    chi_squared_rejection_threshold: float = 25.0
    chi_squared_recovery_threshold: float = 9.0


@dataclass(frozen=True)
class DifferentialCorrectionConfig:
    max_newton_iterations: int = 30
    max_outlier_rejection_passes: int = 10
    convergence_threshold: float = 1e-4
    convergence_before_rejection_threshold: float = 2.0
    rms_stagnation_ratio: float = 0.98
    rms_divergence_ratio: float = 1.5
    max_stagnation_iterations: int = 3
    enable_outlier_rejection: bool = True
    outlier_rejection: OutlierRejectionConfig = OutlierRejectionConfig()
    orbital_limits: EquinoctialLimits = EquinoctialLimits()
    free_elements: Tuple[bool, bool, bool, bool, bool, bool] = (True,) * 6
    propagator: PropagatorKind = PropagatorKind.two_body()

    #: "f64" = every Newton iteration in float64 (reference parity); the
    #: JAX package's "mixed" mode is not ported yet and raises
    precision: str = "f64"

    #: Newton iterations exempt from the divergence ratio check (default 0 =
    #: exact reference behavior)
    divergence_grace_iterations: int = 0
